"""Spec values of decoded KubeAPI states (the value helpers and the State
tuple of jaxtlc/spec/oracle.py, which imports no jax; the port keeps its
own copy).

Records are tuples of sorted (key, value) pairs, sets are frozensets,
partial functions over clients are sorted (client, value) tuples - the
reference oracle's representation, so a state decoded by the port equals
the same state decoded by the reference.
"""

from __future__ import annotations

from typing import NamedTuple


def rec(**fields):
    return tuple(sorted(fields.items()))


def fld(r, name, default=None):
    for k, v in r:
        if k == name:
            return v
    return default


def has(r, name) -> bool:
    return any(k == name for k, _ in r)


def pmap_set(m: tuple, c: str, v) -> tuple:
    d = dict(m)
    d[c] = v
    return tuple(sorted(d.items()))


class State(NamedTuple):
    """Full variable vector (vars, KubeAPI.tla:450-451)."""

    api_state: frozenset  # set of object records
    requests: tuple  # sorted ((client, request-record), ...) - partial fn
    list_requests: tuple  # sorted ((client, listreq-record), ...)
    pc: tuple  # per-process label, processes = clients + Server
    stack: tuple  # per-process tuple of frames (records)
    op: tuple  # per-process procedure param
    obj: tuple
    kind: tuple
    should_reconcile: tuple  # per-reconciler booleans
