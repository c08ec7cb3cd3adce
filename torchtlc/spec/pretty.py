"""TLA+-syntax state rendering for counterexample traces (a copy of
jaxtlc/spec/pretty.py, which imports no jax; the port keeps its own).

Formats decoded states the way TLC prints trace states: one
`/\\ var = value` conjunct per variable, in TLA record, set and function
syntax.
"""

from __future__ import annotations

from typing import Iterable

from ..config import ModelConfig
from .labels import DEFAULT_INIT
from .values import State


def value_to_tla(v) -> str:
    """Public value renderer (trace-expression output uses it)."""
    return _value(v)


def _value(v) -> str:
    if v is None:
        return "defaultInitValue"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, str):
        return "defaultInitValue" if v == DEFAULT_INIT else f'"{v}"'
    if isinstance(v, frozenset):
        return "{" + ", ".join(sorted(_value(x) for x in v)) + "}"
    if isinstance(v, tuple):
        if v and all(isinstance(x, tuple) and len(x) == 2 for x in v):
            # record
            return (
                "[" + ", ".join(f"{k} |-> {_value(val)}" for k, val in v) + "]"
            )
        return "<<" + ", ".join(_value(x) for x in v) + ">>"
    return str(v)


def _fn(domain: Iterable[str], values) -> str:
    pairs = [f"{d} |-> {_value(v)}" for d, v in zip(domain, values)]
    return "[" + ", ".join(pairs) + "]"


def _partial_fn(entries) -> str:
    if not entries:
        return "<<>>"  # TLC prints the empty function this way
    return " @@ ".join(f"{c} :> {_value(r)}" for c, r in entries)


def state_to_tla(st: State, cfg: ModelConfig) -> str:
    procs = cfg.processes
    reconcilers = [cfg.clients[i] for i in cfg.reconciler_indices]
    lines = [
        f"/\\ apiState = {_value(st.api_state)}",
        f"/\\ requests = {_partial_fn(st.requests)}",
        f"/\\ listRequests = {_partial_fn(st.list_requests)}",
        f"/\\ pc = {_fn(procs, st.pc)}",
        "/\\ stack = "
        + _fn(procs, [tuple(fr for fr in s) for s in st.stack]),
        f"/\\ op = {_fn(procs, st.op)}",
        f"/\\ obj = {_fn(procs, st.obj)}",
        f"/\\ kind = {_fn(procs, st.kind)}",
        f"/\\ shouldReconcile = {_fn(reconcilers, st.should_reconcile)}",
    ]
    return "\n".join(lines)
