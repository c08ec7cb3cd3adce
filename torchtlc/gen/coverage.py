"""Per-expression coverage for generic-frontend specs (the port's copy of
jaxtlc/gen/coverage.py, which imports no jax).

TLC's -coverage prints, per action, how often each expression was
evaluated.  For generic specs the dump keeps what the subset IR retains:
per action - the module source line of its definition, TLC's
distinct:generated header, the guard's evaluation/true counts (one
evaluation per state x binding, TLC's action-attempt cost), and each
variable update's evaluation count (one per firing).  It is a host
walker, as in the reference: no device plane exists for generic specs.
The code is the reference's; one docstring drops its history note.
"""

from __future__ import annotations

import re
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

from ..spec import texpr
from .ir import GenSpec
from .oracle import initial_state, state_env


class ActionCoverage(NamedTuple):
    line: Optional[int]  # 1-based def line in the module source
    generated: int  # successors produced (TLC's right-hand count)
    distinct: int  # new states credited (TLC's left-hand count)
    guard_evals: int  # state x binding guard evaluations
    guard_true: int
    update_evals: Dict[str, int]  # var -> evaluations (one per firing)


def action_def_lines(module_text: str) -> Dict[str, int]:
    """Module line of each top-level `Name ==` / `Name(p) ==` def."""
    out: Dict[str, int] = {}
    for i, ln in enumerate(module_text.splitlines(), start=1):
        m = re.match(r"^([A-Za-z_]\w*)\s*(?:\([^)]*\))?\s*==", ln)
        if m and m.group(1) not in out:
            out[m.group(1)] = i
    return out


def coverage_walk(spec: GenSpec, module_text: str = "",
                  max_states: int = 5_000_000
                  ) -> Tuple[int, Dict[str, ActionCoverage]]:
    """Instrumented host BFS: exact visit counts per action expression.

    Mirrors spec/coverage.py's role for the KubeAPI path: a host re-walk
    whose per-expression counters define the dump (the device engines
    track only the per-action aggregates)."""
    lines = action_def_lines(module_text) if module_text else {}
    guard_evals: Dict[str, int] = {}
    guard_true: Dict[str, int] = {}
    upd_evals: Dict[str, Dict[str, int]] = {}
    generated: Dict[str, int] = {}
    distinct: Dict[str, int] = {}

    init = initial_state(spec)
    seen = {init}
    frontier = deque([init])
    while frontier:
        st = frontier.popleft()
        base = state_env(spec, st)
        for act in spec.actions:
            for b in act.bindings():
                env = dict(base)
                env.update(b)
                guard_evals[act.name] = guard_evals.get(act.name, 0) + 1
                try:
                    enabled = texpr.evaluate(act.guard, env)
                except texpr.TexprError:
                    continue
                if not enabled:
                    continue
                guard_true[act.name] = guard_true.get(act.name, 0) + 1
                vals = []
                for decl in spec.variables:
                    upd = act.updates.get(decl.name)
                    if upd is None:
                        vals.append(env[decl.name])
                        continue
                    u = upd_evals.setdefault(act.name, {})
                    u[decl.name] = u.get(decl.name, 0) + 1
                    v = texpr.evaluate(upd, env)
                    vals.append(
                        texpr.canon(v)
                        if isinstance(v, (tuple, frozenset)) else v
                    )
                nxt = tuple(vals)
                generated[act.name] = generated.get(act.name, 0) + 1
                if nxt not in seen:
                    if len(seen) >= max_states:
                        raise RuntimeError("state-space bound exceeded")
                    seen.add(nxt)
                    frontier.append(nxt)
                    distinct[act.name] = distinct.get(act.name, 0) + 1
    out: Dict[str, ActionCoverage] = {}
    for act in spec.actions:
        out[act.name] = ActionCoverage(
            line=lines.get(act.name),
            generated=generated.get(act.name, 0),
            distinct=distinct.get(act.name, 0),
            guard_evals=guard_evals.get(act.name, 0),
            guard_true=guard_true.get(act.name, 0),
            update_evals=upd_evals.get(act.name, {}),
        )
    return 1, out


def render_coverage(module: str, init_count: int,
                    cov: Dict[str, ActionCoverage],
                    stamp: str) -> List[str]:
    """TLC-shaped coverage block (message framing added by the caller).

    Unified on the shared site-table vocabulary (obs.coverage): the
    per-action lines render from the action-site PREFIX
    of the table - the same ordering contract the device coverage
    plane's site tables open with - so the per-action renderer and the
    per-site renderer are two views of one accounting, not two
    accountings."""
    from ..obs.coverage import action_site_table

    locs = {
        name: (f"line {c.line} of module {module}"
               if c.line else f"of module {module}")
        for name, c in cov.items()
    }
    sites = action_site_table(module, list(cov), locs=locs)
    out = [f"The coverage statistics at {stamp}"]
    out.append(f"<Init of module {module}>: {init_count}:{init_count}")
    for s in sites:
        c = cov[s.action]
        out.append(f"<{s.action} {s.loc}>: {c.distinct}:{c.generated}")
        out.append(f"  |guard: {c.guard_evals} evaluations, "
                   f"{c.guard_true} enabled")
        for var, n in c.update_evals.items():
            out.append(f"  |{var}' := ...: {n}")
    return out
