"""Host interpreter for GenSpec (the port's copy of jaxtlc/gen/oracle.py,
which imports no jax: the port imports nothing of the reference package
and keeps its own).

Independent execution path for the generic frontend: BFS over the action
system with texpr-evaluated guards/updates, invariant checking, deadlock
detection, and P ~> Q liveness under WF_vars(Next) (same admissible-
behavior semantics as engine.liveness: infinite state-changing paths, or
eternal stutter where no state-changing step is enabled).  The device
engine (gen.engine) reproduces its counts; the command prints its
violation traces and lassos.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

from ..spec import texpr
from .ir import Action, GenSpec

State = Tuple  # one component per VarDecl, in declaration order


class GenOracleResult(NamedTuple):
    generated: int
    distinct: int
    depth: int
    violations: List[Tuple[str, State]]
    action_generated: Dict[str, int]
    deadlocks: List[State]
    parents: Optional[Dict[State, Tuple[Optional[State], Optional[str]]]] = (
        None
    )
    # new-state credit per action; in-batch attribution order differs
    # between engines, so cross-engine tests compare SUMS (= distinct-1)
    action_distinct: Optional[Dict[str, int]] = None


def state_env(spec: GenSpec, st: State) -> dict:
    env = dict(spec.constants)
    for decl, val in zip(spec.variables, st):
        env[decl.name] = val
    return env


def _value_of(spec: GenSpec, decl, env):
    v = env[decl.name]
    return texpr.canon(v) if isinstance(v, (tuple, frozenset)) else v


def initial_state(spec: GenSpec) -> State:
    env = dict(spec.constants)
    vals = []
    for decl in spec.variables:
        v = texpr.evaluate(spec.init[decl.name], env)
        vals.append(texpr.canon(v) if isinstance(v, (tuple, frozenset))
                    else v)
    return tuple(vals)


def binding_label(act: Action, b: dict) -> str:
    if not b:
        return act.name
    return f"{act.name}({','.join(str(b[p]) for p in act.params)})"


def successors(spec: GenSpec, st: State):
    """[(action_label, next_state, changed)] - includes stutter successors
    (changed=False) so deadlock semantics match TLC's (a self-loop is a
    successor)."""
    out = []
    base = state_env(spec, st)
    for act in spec.actions:
        for b in act.bindings():
            env = dict(base)
            env.update(b)
            try:
                if not texpr.evaluate(act.guard, env):
                    continue
            except texpr.TexprError:
                continue  # guard over absent structure = not enabled
            vals = []
            for decl in spec.variables:
                upd = act.updates.get(decl.name)
                if upd is None:
                    vals.append(env[decl.name])
                else:
                    v = texpr.evaluate(upd, env)
                    vals.append(
                        texpr.canon(v) if isinstance(v, (tuple, frozenset))
                        else v
                    )
            nxt = tuple(vals)
            out.append((binding_label(act, b), nxt, nxt != st))
    return out


def bfs(spec: GenSpec, max_states: int = 5_000_000,
        check_deadlock: bool = True,
        keep_parents: bool = False) -> GenOracleResult:
    init = initial_state(spec)
    seen = {init: 0}
    parents: Optional[Dict] = {init: (None, None)} if keep_parents else None
    frontier = deque([init])
    generated = 1
    depth = 1
    violations: List[Tuple[str, State]] = []
    act_gen: Dict[str, int] = {}
    act_dist: Dict[str, int] = {}
    deadlocks: List[State] = []
    for name, ast in spec.invariants.items():
        if not texpr.evaluate(ast, state_env(spec, init)):
            violations.append((name, init))
    while frontier and not violations:
        st = frontier.popleft()
        succs = successors(spec, st)
        if check_deadlock and not succs:
            deadlocks.append(st)
            violations.append(("Deadlock", st))
            break
        for label, nxt, _changed in succs:
            generated += 1
            base = label.split("(")[0]
            act_gen[base] = act_gen.get(base, 0) + 1
            if nxt in seen:
                continue
            if len(seen) >= max_states:
                raise RuntimeError("state-space bound exceeded")
            seen[nxt] = seen[st] + 1
            depth = max(depth, seen[nxt] + 1)
            act_dist[base] = act_dist.get(base, 0) + 1
            if keep_parents:
                parents[nxt] = (st, label)
            for name, ast in spec.invariants.items():
                if not texpr.evaluate(ast, state_env(spec, nxt)):
                    violations.append((name, nxt))
            if violations:
                break
            frontier.append(nxt)
    return GenOracleResult(
        generated=generated,
        distinct=len(seen),
        depth=depth,
        violations=violations,
        action_generated=act_gen,
        deadlocks=deadlocks,
        parents=parents,
        action_distinct=act_dist,
    )


def violation_trace(spec: GenSpec, max_states: int = 5_000_000,
                    check_deadlock: bool = True):
    """Host re-run -> (kind, [(state, action_label or None), ...]) for the
    first violation, or None if clean (the generic trace-explorer path).

    check_deadlock must match the device run's setting: with it forced on,
    an invariant violation found on device could be "reproduced" here as a
    Deadlock at an earlier successor-less state - a wrong-kind trace."""
    r = bfs(spec, max_states=max_states, keep_parents=True,
            check_deadlock=check_deadlock)
    if not r.violations:
        return None
    kind, bad = r.violations[0]
    chain = []
    cur = bad
    while cur is not None:
        parent, label = r.parents[cur]
        chain.append((cur, label))
        cur = parent
    chain.reverse()
    return kind, chain


def state_to_tla(spec: GenSpec, st: State) -> str:
    """TLA-conjunct rendering of a generic state (TLC trace style)."""
    from ..spec.pretty import value_to_tla

    return "\n".join(
        f"/\\ {decl.name} = {value_to_tla(val)}"
        for decl, val in zip(spec.variables, st)
    )


class LivenessResult(NamedTuple):
    name: str
    holds: bool
    lasso_prefix: Optional[List[State]]
    lasso_cycle: Optional[List[State]]


def _action_process(label: str) -> str:
    """The fairness unit of an edge: the first bound parameter value of
    the firing action ("RequestVote(n1,n2)" -> "n1"), or the action name
    for parameterless actions - mirroring the KubeAPI path where WF is
    per PlusCal process (engine/liveness.py fair_surviving_set)."""
    if "(" in label:
        return label[label.index("(") + 1:-1].split(",")[0]
    return label


def check_leads_to(spec: GenSpec, p_ast, q_ast, name: str = "",
                   max_states: int = 1_000_000,
                   fairness: str = "wf_next") -> LivenessResult:
    """P ~> Q on the reachable graph under the selected fairness.

    wf_next (the spec's literal WF_vars(Next)): survive(s) iff ~Q(s) and
    (no state-changing successor at all, or some state-changing
    successor survives) - greatest fixpoint by peeling.

    wf_process (per-process weak fairness, the KubeAPI path's second
    mode): a violation suffix eventually stays inside one SCC S of the
    ~Q subgraph; S hosts a fair behavior iff for every process p, p has
    an internal step in S or p is disabled at some state of S; terminal
    ~Q states host a fair stutter.  A violation is a reachable P-state
    that can reach such a fair core within ~Q.

    The lasso is prefix + a cycle/terminal tail inside ~Q either way."""
    init = initial_state(spec)
    states = {init: 0}
    order = [init]
    edges: Dict[int, List[int]] = {}
    edge_proc: Dict[int, List[str]] = {}
    frontier = deque([init])
    while frontier:
        st = frontier.popleft()
        sid = states[st]
        outs = []
        procs = []
        for label, nxt, changed in successors(spec, st):
            if not changed:
                continue
            if nxt not in states:
                if len(states) >= max_states:
                    raise RuntimeError("liveness graph bound exceeded")
                states[nxt] = len(order)
                order.append(nxt)
                frontier.append(nxt)
            outs.append(states[nxt])
            procs.append(_action_process(label))
        edges[sid] = outs
        edge_proc[sid] = procs
    n = len(order)
    if fairness == "wf_process":
        return _check_leads_to_wf_process(
            spec, name, p_ast, q_ast, order, edges, edge_proc)
    if fairness != "wf_next":
        raise ValueError(f"unknown fairness mode {fairness!r}")
    in_h = [not texpr.evaluate(q_ast, state_env(spec, s)) for s in order]
    # peel: alive = in_h; repeatedly drop states whose every state-changing
    # successor is dead, unless they have no state-changing successor
    alive = list(in_h)
    changed_flag = True
    while changed_flag:
        changed_flag = False
        for i in range(n):
            if not alive[i]:
                continue
            outs = edges[i]
            if outs and not any(alive[j] for j in outs):
                alive[i] = False
                changed_flag = True
    for i in range(n):
        if alive[i] and texpr.evaluate(p_ast, state_env(spec, order[i])):
            # build prefix init -> i (BFS parent walk), cycle inside alive
            prefix = _path_to(edges, 0, i, n)
            cycle = _alive_tail(edges, i, alive)
            return LivenessResult(
                name, False,
                [order[j] for j in prefix],
                [order[j] for j in cycle],
            )
    return LivenessResult(name, True, None, None)


def _check_leads_to_wf_process(spec, name, p_ast, q_ast, order, edges,
                               edge_proc) -> LivenessResult:
    """SCC-based per-process weak fairness (see check_leads_to doc)."""
    import numpy as np

    from ..engine.liveness import _sccs

    n = len(order)
    in_h = [not texpr.evaluate(q_ast, state_env(spec, s)) for s in order]
    all_procs = sorted({p for ps in edge_proc.values() for p in ps})
    pid = {p: i for i, p in enumerate(all_procs)}
    n_procs = len(all_procs)
    enabled = np.zeros((n, max(n_procs, 1)), dtype=bool)
    hs, hd, hp = [], [], []
    for s in range(n):
        for d, p in zip(edges[s], edge_proc[s]):
            enabled[s, pid[p]] = True
            if in_h[s] and in_h[d]:
                hs.append(s)
                hd.append(d)
                hp.append(pid[p])
    hs = np.asarray(hs, np.int64)
    hd = np.asarray(hd, np.int64)
    hp = np.asarray(hp, np.int64)
    comp = _sccs(n, hs, hd)
    ncomp = int(comp.max()) + 1 if n else 0
    internal = comp[hs] == comp[hd] if len(hs) else np.zeros(0, bool)
    cyclic = np.zeros(ncomp, bool)
    if len(hs):
        np.add.at(cyclic, comp[hs[internal]], True)
    has_pedge = np.zeros((ncomp, max(n_procs, 1)), bool)
    if len(hs):
        has_pedge[comp[hs[internal]], hp[internal]] = True
    some_disabled = np.zeros((ncomp, max(n_procs, 1)), bool)
    hidx = np.asarray([i for i in range(n) if in_h[i]], np.int64)
    for p in range(n_procs):
        np.logical_or.at(some_disabled[:, p], comp[hidx],
                         ~enabled[hidx, p])
    fair_scc = cyclic & (has_pedge | some_disabled).all(axis=1)
    terminal = np.asarray(
        [in_h[i] and not edges[i] for i in range(n)], bool
    )
    fair_core = terminal.copy()
    if len(hidx):
        fair_core[hidx] |= fair_scc[comp[hidx]]
    # reverse reachability within H to the fair core
    can_stay = fair_core.copy()
    rev: Dict[int, List[int]] = {}
    for s, d in zip(hs, hd):
        rev.setdefault(int(d), []).append(int(s))
    stack = [int(i) for i in np.flatnonzero(fair_core)]
    while stack:
        d = stack.pop()
        for s in rev.get(d, ()):
            if not can_stay[s]:
                can_stay[s] = True
                stack.append(s)
    h_edges = {
        j: ([d for d, p in zip(edges[j], edge_proc[j]) if in_h[d]]
            if in_h[j] else [])
        for j in range(n)
    }
    for i in range(n):
        if can_stay[i] and texpr.evaluate(
            p_ast, state_env(spec, order[i])
        ):
            # evidence must loop inside the FAIR CORE, not merely in a
            # transit SCC of can_stay (which would be a cycle the very
            # fairness assumption forbids): extend the prefix through H
            # to a core state, then walk within the core
            prefix = _path_to(edges, 0, i, n)
            mid = _bfs_to_set(h_edges, i, fair_core)
            entry = mid[-1]
            cycle = _alive_tail(h_edges, entry, fair_core)
            return LivenessResult(
                name, False,
                [order[j] for j in prefix + mid[1:]],
                [order[j] for j in cycle],
            )
    return LivenessResult(name, True, None, None)


def _bfs_to_set(edges, src, targets):
    """Shortest path (node ids) from src to any node with targets[id]."""
    prev = {src: None}
    q = deque([src])
    goal = src if targets[src] else None
    while q and goal is None:
        u = q.popleft()
        for v in edges.get(u, ()):
            if v not in prev:
                prev[v] = u
                if targets[v]:
                    goal = v
                    break
                q.append(v)
    assert goal is not None, "can_stay state cannot reach the fair core"
    path, cur = [], goal
    while cur is not None:
        path.append(cur)
        cur = prev[cur]
    return list(reversed(path))


def _path_to(edges, src, dst, n):
    prev = {src: None}
    q = deque([src])
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
    """A cycle (or terminal tail) within the surviving set from start."""
    seen = {start: 0}
    seq = [start]
    cur = start
    while True:
        outs = [j for j in edges[cur] if alive[j]]
        if not outs:
            return seq  # terminal stutter tail
        cur = outs[0]
        if cur in seen:
            return seq[seen[cur]:]
        seen[cur] = len(seq)
        seq.append(cur)
