"""BFS model checker over the structurally-interpreted relation (E1).

Same accounting as TLC and the hand oracle (spec.oracle.bfs): initial
states count toward generated and distinct (MC.out:29-32); every
enumerated successor counts as generated; depth = BFS levels with Init
at level 1 (MC.out:1101); deadlock = a state with no successor at all
(self-loops count as successors); invariants are checked on every
distinct state.  Action attribution uses the PlusCal label names
(MC.out:44-1092), so per-action generated counts diff directly against
the hand oracle and the TLC log.

The port's copy of jaxtlc/struct/oracle.py, which imports no jax: the port imports
nothing of the reference package and keeps its own.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

from .actions import ActionSystem
from .eval import StructEvalError, TlaAssertionError


class StructBFSResult(NamedTuple):
    generated: int
    distinct: int
    depth: int
    max_outdegree: int
    min_outdegree: int
    violations: List[Tuple[str, tuple]]
    action_generated: Dict[str, int]
    action_distinct: Dict[str, int]
    levels: List[int]
    parents: Optional[Dict[tuple, Tuple[Optional[tuple], Optional[str]]]]
    states: Optional[Dict[tuple, int]]  # state -> level (collect_states)


def bfs(
    system: ActionSystem,
    invariants: Dict[str, tuple],
    check_deadlock: bool = True,
    max_states: int = 10_000_000,
    keep_parents: bool = False,
    stop_on_violation: bool = True,
    collect_states: bool = False,
) -> StructBFSResult:
    ev = system.ev
    inits = system.initial_states()
    seen: Dict[tuple, int] = {}
    parents: Optional[Dict] = {} if keep_parents else None
    generated = 0
    violations: List[Tuple[str, tuple]] = []
    frontier: List[tuple] = []
    act_gen: Dict[str, int] = {}
    act_dist: Dict[str, int] = {}

    def check_invs(st: tuple):
        env = dict(ev.constants)
        env.update(zip(system.variables, st))
        for name, ast in invariants.items():
            try:
                ok = ev.eval(ast, env) is True
            except StructEvalError as e:
                # TLC reports an invariant that cannot be evaluated on a
                # reachable state (e.g. an out-of-range index) as an
                # error with a trace; same here, as a violation kind
                violations.append((f"{name} (evaluation error: {e})",
                                   st))
                continue
            if not ok:
                violations.append((name, st))

    for s in inits:
        generated += 1
        if s not in seen:
            seen[s] = 1
            frontier.append(s)
            if keep_parents:
                parents[s] = (None, None)
            check_invs(s)
    depth = 1
    levels = [len(frontier)]
    max_out, min_out = 0, 1 << 30
    while frontier and not (violations and stop_on_violation):
        nxt: List[tuple] = []
        for s in frontier:
            try:
                succs = system.successors(s)
            except TlaAssertionError as e:
                violations.append((f"assert:{e.tla_msg}", s))
                if stop_on_violation:
                    break
                continue
            generated += len(succs)
            distinct_succs = {t for _, t in succs}
            outdeg = len(distinct_succs)
            max_out = max(max_out, outdeg)
            min_out = min(min_out, outdeg)
            if outdeg == 0 and check_deadlock:
                violations.append(("deadlock", s))
            for label, t in succs:
                act_gen[label] = act_gen.get(label, 0) + 1
                if t not in seen:
                    if len(seen) >= max_states:
                        raise RuntimeError("state-space bound exceeded")
                    seen[t] = depth + 1
                    nxt.append(t)
                    act_dist[label] = act_dist.get(label, 0) + 1
                    if keep_parents:
                        parents[t] = (s, label)
                    check_invs(t)
        frontier = nxt
        if frontier:
            depth += 1
            levels.append(len(frontier))
    return StructBFSResult(
        generated=generated,
        distinct=len(seen),
        depth=depth,
        max_outdegree=max_out,
        min_outdegree=min_out if min_out != 1 << 30 else 0,
        violations=violations,
        action_generated=act_gen,
        action_distinct=act_dist,
        levels=levels,
        parents=parents,
        states=seen if collect_states else None,
    )


def state_env(system: ActionSystem, st: tuple) -> dict:
    env = dict(system.ev.constants)
    env.update(zip(system.variables, st))
    return env


def state_to_tla(system: ActionSystem, st: tuple) -> str:
    """TLA-conjunct rendering of a structural state (TLC trace style)."""
    from ..spec.pretty import value_to_tla

    return "\n".join(
        f"/\\ {v} = {value_to_tla(val)}"
        for v, val in zip(system.variables, st)
    )


class LivenessResult(NamedTuple):
    name: str
    holds: bool
    lasso_prefix: Optional[List[tuple]]
    lasso_cycle: Optional[List[tuple]]


def check_leads_to(system: ActionSystem, p_ast, q_ast, name: str = "",
                   max_states: int = 1_000_000) -> LivenessResult:
    """P ~> Q under WF_vars(Next) over the structural relation - the
    same greatest-fixpoint peeling as the generic path (gen.oracle):
    survive(s) iff ~Q(s) and (no state-changing successor, or some
    state-changing successor survives); a violation is a reachable
    surviving P-state."""
    ev = system.ev

    def holds(ast, st) -> bool:
        env = dict(ev.constants)
        env.update(zip(system.variables, st))
        return ev.eval(ast, env) is True

    init_states = system.initial_states()
    states: Dict[tuple, int] = {}
    order: List[tuple] = []
    edges: Dict[int, List[int]] = {}
    frontier = deque()
    init_ids = []
    for st in init_states:
        if st not in states:
            init_ids.append(len(order))
            states[st] = len(order)
            order.append(st)
            frontier.append(st)
    while frontier:
        st = frontier.popleft()
        sid = states[st]
        outs = []
        for _, nxt in system.successors(st):
            if nxt == st:
                continue
            if nxt not in states:
                if len(states) >= max_states:
                    raise RuntimeError("liveness graph bound exceeded")
                states[nxt] = len(order)
                order.append(nxt)
                frontier.append(nxt)
            outs.append(states[nxt])
        edges[sid] = outs
    n = len(order)
    alive = [not holds(q_ast, s) for s in order]
    changed = True
    while changed:
        changed = False
        for i in range(n):
            if not alive[i]:
                continue
            outs = edges[i]
            if outs and not any(alive[j] for j in outs):
                alive[i] = False
                changed = True
    for i in range(n):
        if alive[i] and holds(p_ast, order[i]):
            prefix = _path_to(edges, init_ids, i)
            cycle = _alive_tail(edges, i, alive)
            return LivenessResult(
                name, False,
                [order[j] for j in prefix],
                [order[j] for j in cycle],
            )
    return LivenessResult(name, True, None, None)


def _path_to(edges, srcs, dst):
    """BFS path from ANY of `srcs` to dst (multi-initial-state specs)."""
    if isinstance(srcs, int):
        srcs = [srcs]
    prev = {s: None for s in srcs}
    q = deque(srcs)
    while q:
        u = q.popleft()
        if u == dst:
            break
        for v in edges[u]:
            if v not in prev:
                prev[v] = u
                q.append(v)
    path, cur = [], dst
    while cur is not None:
        path.append(cur)
        cur = prev[cur]
    return list(reversed(path))


def _alive_tail(edges, start, alive):
    seen = {start: 0}
    seq = [start]
    cur = start
    while True:
        outs = [j for j in edges[cur] if alive[j]]
        if not outs:
            return seq
        cur = outs[0]
        if cur in seen:
            return seq[seen[cur]:]
        seen[cur] = len(seq)
        seq.append(cur)


def violation_trace(system: ActionSystem, invariants: Dict[str, tuple],
                    check_deadlock: bool = True,
                    max_states: int = 10_000_000):
    """(kind, [(state, label|None), ...]) for the first violation, or
    None - the trace-explorer re-run over the structural relation."""
    r = bfs(system, invariants, check_deadlock=check_deadlock,
            max_states=max_states, keep_parents=True)
    if not r.violations:
        return None
    kind, bad = r.violations[0]
    chain = []
    cur: Optional[tuple] = bad
    while cur is not None:
        parent, label = r.parents[cur]
        chain.append((cur, label))
        cur = parent
    chain.reverse()
    return kind, chain
