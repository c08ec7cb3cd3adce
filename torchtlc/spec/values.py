"""Spec values of decoded KubeAPI states (the value helpers, the State
tuple and Init of jaxtlc/spec/oracle.py, which imports no jax; the port
keeps its own copy).

Records are tuples of sorted (key, value) pairs, sets are frozensets,
partial functions over clients are sorted (client, value) tuples - the
reference oracle's representation, so a state decoded by the port equals
the same state decoded by the reference.
"""

from __future__ import annotations

import itertools
from typing import Iterable, List, NamedTuple, Tuple

from ..config import RECONCILER, ModelConfig
from .labels import DEFAULT_INIT


def rec(**fields):
    return tuple(sorted(fields.items()))


def rec_from(pairs: Iterable[Tuple[str, object]], **updates):
    d = dict(pairs)
    d.update(updates)
    return tuple(sorted(d.items()))


def fld(r, name, default=None):
    for k, v in r:
        if k == name:
            return v
    return default


def has(r, name) -> bool:
    return any(k == name for k, _ in r)


def pmap_get(m: tuple, c: str):
    for k, v in m:
        if k == c:
            return v
    return None


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


def _set(t: tuple, i: int, v) -> tuple:
    return t[:i] + (v,) + t[i + 1:]


def _ckey(v):
    """Total-order sort key for spec values (frozensets lack a total order)."""
    if isinstance(v, frozenset):
        return (1, tuple(sorted((_ckey(x) for x in v))))
    if isinstance(v, tuple):
        return (2, tuple(_ckey(x) for x in v))
    return (0, v)


def initial_states(cfg: ModelConfig) -> List[State]:
    """Init (KubeAPI.tla:455-469): shouldReconcile ranges over
    [reconcilers -> BOOLEAN] => 2^R states (2 in Model_1, MC.out:32)."""
    np_ = cfg.n_clients + 1
    base = dict(
        api_state=frozenset(),
        requests=(),
        list_requests=(),
        pc=tuple("CStart" if r == RECONCILER else "PVCStart"
                 for r in cfg.roles) + ("APIStart",),
        stack=((),) * np_,
        op=(DEFAULT_INIT,) * np_,
        obj=(DEFAULT_INIT,) * np_,
        kind=(DEFAULT_INIT,) * np_,
    )
    return [State(should_reconcile=bits, **base)
            for bits in itertools.product((False, True),
                                          repeat=cfg.n_reconcilers)]
