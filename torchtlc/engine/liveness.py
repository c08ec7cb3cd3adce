"""Liveness / temporal-property checking (E8) under WF_vars(Next).

The reference declares two temporal properties (KubeAPI.tla:798-808) but
ships them disabled in the launch config (KubeAPI___Model_1.launch:22-23 -
`0ReconcileCompletes`, `0CleansUpProperly`).  This module checks them for
real, exploiting the structure TLC's general tableau/SCC machinery would
discover anyway for these formula shapes:

* `P ~> Q`       (ReconcileCompletes: sr[c] ~> ~sr[c], KubeAPI.tla:798-799)
* `[]P ~> Q`     (CleansUpProperly: []~sr[c] ~> own secret absent,
                  KubeAPI.tla:806-808)

Semantics.  Spec == Init /\\ [][Next]_vars /\\ WF_vars(Next)
(KubeAPI.tla:765-766).  In the finite reachable graph G, admissible infinite
behaviors are exactly: (a) paths taking infinitely many *state-changing*
edges (self-loop Next steps are stuttering steps under [][Next]_vars), or
(b) behaviors that eventually stutter forever at a state with NO
state-changing successor - weak fairness of Next forbids parking forever at
a state where a state-changing step stays enabled.

Both property shapes reduce to a *surviving set* computation on a restricted
subgraph H (the ~> violation zone):

    survive(s)  iff  s in H  and  ( no state-changing successor at all
                                    or some state-changing successor in
                                    survive )

computed as the greatest fixpoint by Kahn-style peeling.  A violation is a
reachable state in the surviving set satisfying the trigger; the reported
counterexample is TLC-style: a finite prefix from an initial state plus a
lasso cycle along surviving states.

- `P ~> Q`:   H = states with ~Q; trigger = P (a P-state that can stay in
              ~Q forever).
- `[]P ~> Q`: H = states with P /\\ ~Q; trigger = anything in H (the suffix
              where P holds forever and Q never does).

Host path (port of jaxtlc/engine/liveness.py): the explicit graph is
built on the host, one Python dict entry a state, with the expansion on
kernel K1 (engine.backend.expand_block); everything else is host numpy.
The device path for multi-million-state graphs is jaxtlc's live/ plane,
ported as torchtlc.live.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..spec.codec import get_codec
from ..spec.kernel import initial_vectors, lane_layout
from ..spec.labels import LABELS
from .backend import FLAG_OVF, FLAG_VALID, expand_block
from .bfs import resolve_device


class Graph(NamedTuple):
    states: np.ndarray  # [V, F] encoded states, id = row
    src: np.ndarray  # [E] state-changing edges (self-loops dropped)
    dst: np.ndarray  # [E]
    eproc: np.ndarray  # [E] acting process index (nc = the server)
    eaction: np.ndarray  # [E] action label id
    has_nonself: np.ndarray  # [V] bool: any state-changing successor
    init_ids: np.ndarray  # [I]
    parent: np.ndarray  # [V] BFS parent id (-1 for initial states)
    parent_action: np.ndarray  # [V] action label id producing the state


class LivenessResult(NamedTuple):
    name: str
    holds: bool
    # on violation: encoded lasso (prefix ends just before the cycle entry)
    prefix: Optional[List[np.ndarray]]
    cycle: Optional[List[np.ndarray]]
    # action label producing each lasso state (None for initial states)
    prefix_actions: Optional[List[Optional[str]]] = None
    cycle_actions: Optional[List[Optional[str]]] = None


def build_graph(cfg: ModelConfig, chunk: int = 512, device=None) -> Graph:
    """Exhaustive BFS collecting the full state graph; the frontier's
    successors come from kernel K1 (on the card unless `device` says
    otherwise), unpacked on the host."""
    cdc = get_codec(cfg)
    dev = resolve_device(device)
    F = cdc.n_fields

    inits = initial_vectors(cfg)
    ids: Dict[tuple, int] = {}
    rows: List[np.ndarray] = []
    parent: List[int] = []
    parent_action: List[int] = []
    frontier: List[int] = []
    for s in inits:
        t = tuple(map(int, s))
        if t not in ids:
            ids[t] = len(rows)
            rows.append(np.asarray(s, np.int32))
            parent.append(-1)
            parent_action.append(-1)
            frontier.append(ids[t])
    init_ids = np.array(frontier, dtype=np.int64)

    src_l: List[int] = []
    dst_l: List[int] = []
    proc_l: List[int] = []
    act_l: List[int] = []
    pad = np.zeros((chunk, F), dtype=np.int32)
    CL, L = lane_layout(cfg)  # lane -> acting process mapping
    nc = cdc.nc

    while frontier:
        nxt: List[int] = []
        for base in range(0, len(frontier), chunk):
            batch_ids = frontier[base : base + chunk]
            n = len(batch_ids)
            buf = pad.copy()
            buf[:n] = np.stack([rows[i] for i in batch_ids])
            block = cdc.pack(torch.from_numpy(buf)).to(dev)
            packed, flags, action, _ = expand_block(cfg, block, n,
                                                    deferred=True)
            succs = cdc.unpack(packed.cpu()).numpy().reshape(chunk, L, F)
            flags = flags.cpu().numpy()
            valid = flags[FLAG_VALID].reshape(chunk, L).astype(bool)
            action = action.cpu().numpy().reshape(chunk, L)
            if flags[FLAG_OVF].any():
                raise RuntimeError("codec slot overflow during graph build")
            for b in range(n):
                sid = batch_ids[b]
                for l in range(succs.shape[1]):
                    if not valid[b, l]:
                        continue
                    t = tuple(map(int, succs[b, l]))
                    did = ids.get(t)
                    if did is None:
                        did = len(rows)
                        ids[t] = did
                        rows.append(succs[b, l])
                        parent.append(sid)
                        parent_action.append(int(action[b, l]))
                        nxt.append(did)
                    if did != sid:  # drop stuttering self-loops
                        src_l.append(sid)
                        dst_l.append(did)
                        proc_l.append(l // CL if l < nc * CL else nc)
                        act_l.append(int(action[b, l]))
        frontier = nxt

    V = len(rows)
    src = np.array(src_l, dtype=np.int64)
    dst = np.array(dst_l, dtype=np.int64)
    eproc = np.array(proc_l, dtype=np.int64)
    eaction = np.array(act_l, dtype=np.int64)
    # dedupe parallel edges (same src, dst, acting process; a process is at
    # one pc per state, so (src, proc) determines the action label)
    if len(src):
        key = (src * V + dst) * (nc + 1) + eproc
        _, uniq = np.unique(key, return_index=True)
        src, dst, eproc, eaction = (
            src[uniq], dst[uniq], eproc[uniq], eaction[uniq],
        )
    has_nonself = np.zeros(V, dtype=bool)
    has_nonself[src] = True
    return Graph(
        states=np.stack(rows),
        src=src,
        dst=dst,
        eproc=eproc,
        eaction=eaction,
        has_nonself=has_nonself,
        init_ids=init_ids,
        parent=np.array(parent, dtype=np.int64),
        parent_action=np.array(parent_action, dtype=np.int64),
    )


def surviving_set(g: Graph, in_h: np.ndarray) -> np.ndarray:
    """Greatest fixpoint: states in H with an admissible infinite behavior
    that never leaves H (see module docstring)."""
    V = in_h.shape[0]
    # edges internal to H
    keep = in_h[g.src] & in_h[g.dst]
    src, dst = g.src[keep], g.dst[keep]
    live_deg = np.zeros(V, dtype=np.int64)
    np.add.at(live_deg, src, 1)
    # terminal = allowed to stutter forever (no state-changing successor
    # anywhere in G)
    terminal = in_h & ~g.has_nonself
    alive = in_h.copy()
    # reverse adjacency (CSR) for decrement propagation
    order = np.argsort(dst, kind="stable")
    rsrc = src[order]
    rdst = dst[order]
    starts = np.searchsorted(rdst, np.arange(V))
    ends = np.searchsorted(rdst, np.arange(V) + 1)

    stack = list(np.flatnonzero(alive & ~terminal & (live_deg == 0)))
    dead_mark = np.zeros(V, dtype=bool)
    for s in stack:
        dead_mark[s] = True
    while stack:
        s = stack.pop()
        alive[s] = False
        for e in range(starts[s], ends[s]):
            p = rsrc[e]
            if not alive[p] or terminal[p]:
                continue
            live_deg[p] -= 1
            if live_deg[p] == 0 and not dead_mark[p]:
                dead_mark[p] = True
                stack.append(p)
    return alive


def _lasso(
    g: Graph, survive: np.ndarray, start: int, in_h: np.ndarray
) -> Tuple[List[int], List[int]]:
    """Prefix (init -> start) + cycle through surviving H-states (ids)."""
    prefix_ids = []
    cur = start
    while cur != -1:
        prefix_ids.append(cur)
        cur = int(g.parent[cur])
    prefix_ids.reverse()

    # adjacency among surviving states
    keep = survive[g.src] & survive[g.dst] & in_h[g.src] & in_h[g.dst]
    src, dst = g.src[keep], g.dst[keep]
    order = np.argsort(src, kind="stable")
    ssrc, sdst = src[order], dst[order]
    V = survive.shape[0]
    starts = np.searchsorted(ssrc, np.arange(V))
    ends = np.searchsorted(ssrc, np.arange(V) + 1)

    seen_at = {start: 0}
    walk = [start]
    cur = start
    while True:
        if starts[cur] == ends[cur]:
            # terminal stutter state: the "cycle" is stuttering in place
            entry = len(walk) - 1
            cyc = [cur]
            break
        nxt = int(sdst[starts[cur]])
        if nxt in seen_at:
            entry = seen_at[nxt]
            cyc = walk[entry:]
            break
        seen_at[nxt] = len(walk)
        walk.append(nxt)
        cur = nxt
    # prefix: init -> start -> ... -> just before the cycle entry
    return prefix_ids + walk[1:entry], cyc


def _sccs(V: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Strongly connected components (iterative Tarjan).  Returns comp[V]."""
    order = np.argsort(src, kind="stable")
    ssrc, sdst = src[order], dst[order]
    starts = np.searchsorted(ssrc, np.arange(V))
    ends = np.searchsorted(ssrc, np.arange(V) + 1)

    comp = np.full(V, -1, dtype=np.int64)
    index = np.full(V, -1, dtype=np.int64)
    low = np.zeros(V, dtype=np.int64)
    on_stack = np.zeros(V, dtype=bool)
    stack: List[int] = []
    counter = 0
    ncomp = 0
    for root in range(V):
        if index[root] != -1:
            continue
        work = [(root, starts[root])]
        index[root] = low[root] = counter
        counter += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, ei = work[-1]
            if ei < ends[v]:
                work[-1] = (v, ei + 1)
                w = int(sdst[ei])
                if index[w] == -1:
                    index[w] = low[w] = counter
                    counter += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, starts[w]))
                elif on_stack[w]:
                    if index[w] < low[v]:
                        low[v] = index[w]
            else:
                work.pop()
                if work:
                    pv = work[-1][0]
                    if low[v] < low[pv]:
                        low[pv] = low[v]
                if low[v] == index[v]:
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        comp[w] = ncomp
                        if w == v:
                            break
                    ncomp += 1
    return comp


def fair_surviving_set(
    g: Graph, in_h: np.ndarray, n_procs: int
) -> Tuple[np.ndarray, np.ndarray]:
    """States in H from which an infinite behavior can stay in H forever
    under PER-PROCESS weak fairness (WF on each process's state-changing
    action - stronger than the spec's WF_vars(Next)).

    A violation suffix eventually stays inside one SCC S of H's subgraph.
    S can host a fair behavior iff for every process p: p is disabled (no
    state-changing p-step in the full graph) at some state of S, or some
    p-step stays within S.  Terminal H-states (no state-changing successor
    at all) host a fair stutter-forever behavior.

    Returns (can_stay, fair_core): can_stay = reachable-into-fair-core
    within H; fair_core = states of fair SCCs / terminal states.
    """
    V = in_h.shape[0]
    # per-state, per-process enabledness in the FULL graph
    enabled = np.zeros((V, n_procs), dtype=bool)
    enabled[g.src, g.eproc] = True

    keep = in_h[g.src] & in_h[g.dst]
    hs, hd, hp = g.src[keep], g.dst[keep], g.eproc[keep]
    comp = _sccs(V, hs, hd)

    internal = comp[hs] == comp[hd]
    ncomp = int(comp.max()) + 1 if V else 0
    # SCC is cyclic iff it contains an internal edge
    cyclic = np.zeros(ncomp, dtype=bool)
    np.add.at(cyclic, comp[hs[internal]], True)
    # per-SCC: does process p have an internal edge?
    has_pedge = np.zeros((ncomp, n_procs), dtype=bool)
    has_pedge[comp[hs[internal]], hp[internal]] = True
    # per-SCC: is process p disabled at some member state?
    some_disabled = np.zeros((ncomp, n_procs), dtype=bool)
    hidx = np.flatnonzero(in_h)
    for p in range(n_procs):
        np.logical_or.at(some_disabled[:, p], comp[hidx], ~enabled[hidx, p])
    fair_scc = cyclic & (has_pedge | some_disabled).all(axis=1)

    terminal = in_h & ~g.has_nonself
    fair_core = terminal.copy()
    fair_core[hidx] |= fair_scc[comp[hidx]]

    # reverse reachability within H to the fair core
    can_stay = fair_core.copy()
    order = np.argsort(hd, kind="stable")
    rs, rd = hs[order], hd[order]
    dstarts = np.searchsorted(rd, np.arange(V))
    dends = np.searchsorted(rd, np.arange(V) + 1)
    stack = list(np.flatnonzero(fair_core))
    while stack:
        s = stack.pop()
        for e in range(dstarts[s], dends[s]):
            p = int(rs[e])
            if not can_stay[p]:
                can_stay[p] = True
                stack.append(p)
    return can_stay, fair_core


def _check_leads_to(
    g: Graph,
    name: str,
    trigger: np.ndarray,
    in_h: np.ndarray,
    fairness: str,
    n_procs: int,
) -> LivenessResult:
    if fairness == "wf_next":
        survive = surviving_set(g, in_h)
        bad = trigger & survive
        if not bad.any():
            return LivenessResult(name, True, None, None)
        start = int(np.flatnonzero(bad)[0])
        prefix_ids, cycle_ids = _lasso(g, survive, start, in_h)
    elif fairness == "wf_process":
        survive, fair_core = fair_surviving_set(g, in_h, n_procs)
        bad = trigger & survive
        if not bad.any():
            return LivenessResult(name, True, None, None)
        start = int(np.flatnonzero(bad)[0])
        prefix_ids, cycle_ids = _fair_lasso(g, in_h, fair_core, start, n_procs)
    else:
        raise ValueError(f"unknown fairness mode {fairness!r}")

    # materialize states + the action label that produced each transition.
    # Edges are deduped per (src, dst, proc), so one (src, dst) pair can be
    # reachable via several processes with different labels; prefer the BFS
    # parent_action (exact for prefix steps), fall back to any real edge's
    # label for walk steps (every candidate is a genuine transition of G).
    edge_action = {}
    for s, d, a in zip(g.src, g.dst, g.eaction):
        edge_action.setdefault((int(s), int(d)), LABELS[int(a)])

    def step_label(p: int, i: int) -> Optional[str]:
        if int(g.parent[i]) == p and int(g.parent_action[i]) >= 0:
            return LABELS[int(g.parent_action[i])]
        return edge_action.get((p, i))

    def acts(ids: List[int], pred0: Optional[int]) -> List[Optional[str]]:
        preds = [pred0] + ids[:-1]
        return [
            None if p is None or p == i else step_label(p, i)
            for p, i in zip(preds, ids)
        ]

    prefix = [g.states[i] for i in prefix_ids]
    cycle = [g.states[i] for i in cycle_ids]
    prefix_actions = acts(prefix_ids, None)
    cycle_actions = acts(
        cycle_ids, prefix_ids[-1] if prefix_ids else cycle_ids[-1]
    )
    return LivenessResult(name, False, prefix, cycle, prefix_actions,
                          cycle_actions)


def _bfs_path(starts, ends, adj_dst, frm: int, to_set) -> List[int]:
    """Shortest path frm -> (any node in to_set) over CSR adjacency;
    returns node list including both endpoints ([frm] if frm in to_set)."""
    if frm in to_set:
        return [frm]
    prev = {frm: -1}
    queue = [frm]
    qi = 0
    while qi < len(queue):
        v = queue[qi]
        qi += 1
        for e in range(starts[v], ends[v]):
            w = int(adj_dst[e])
            if w in prev:
                continue
            prev[w] = v
            if w in to_set:
                path = [w]
                while path[-1] != frm:
                    path.append(prev[path[-1]])
                path.reverse()
                return path
            queue.append(w)
    raise AssertionError("no path found (graph invariant broken)")


def _fair_lasso(
    g: Graph, in_h: np.ndarray, fair_core: np.ndarray, start: int,
    n_procs: int,
) -> Tuple[List[int], List[int]]:
    """Certificate lasso for wf_process: prefix init->start->fair core, then
    a cycle inside one fair SCC that, for every process p, either contains a
    p-edge or visits a state where p is disabled."""
    V = in_h.shape[0]
    enabled = np.zeros((V, n_procs), dtype=bool)
    enabled[g.src, g.eproc] = True

    keep = in_h[g.src] & in_h[g.dst]
    hs, hd, hp = g.src[keep], g.dst[keep], g.eproc[keep]
    order = np.argsort(hs, kind="stable")
    hs, hd, hp = hs[order], hd[order], hp[order]
    starts = np.searchsorted(hs, np.arange(V))
    ends = np.searchsorted(hs, np.arange(V) + 1)

    prefix_ids = []
    cur = start
    while cur != -1:
        prefix_ids.append(cur)
        cur = int(g.parent[cur])
    prefix_ids.reverse()

    core_set = set(np.flatnonzero(fair_core).tolist())
    to_core = _bfs_path(starts, ends, hd, start, core_set)
    f = to_core[-1]
    prefix_ids += to_core[1:]

    if not g.has_nonself[f]:
        return prefix_ids, [f]  # stutter-forever "cycle"

    comp = _sccs(V, hs, hd)
    members = np.flatnonzero((comp == comp[f]) & in_h)
    mset = set(members.tolist())
    internal = np.flatnonzero(
        (comp[hs] == comp[f]) & (comp[hd] == comp[f])
    )

    # per-process obligation: a p-edge to traverse, or a p-disabled state
    # to visit (only for processes enabled somewhere; a process enabled at
    # all cycle states with no p-step would make the cycle unfair)
    waypoints: List[Tuple[int, int]] = []  # (entry, exit) node pairs
    for p in range(n_procs):
        disabled_at = [m for m in members if not enabled[m, p]]
        if disabled_at:
            waypoints.append((disabled_at[0], disabled_at[0]))
            continue
        pedges = [e for e in internal if hp[e] == p]
        assert pedges, "fair SCC invariant broken: no obligation for process"
        e = pedges[0]
        waypoints.append((int(hs[e]), int(hd[e])))

    # stitch: f -> w0.entry ~ w0.exit -> w1.entry ~ ... -> back to f
    cycle_ids = [f]
    cur = f
    for entry, exit_ in waypoints:
        seg = _bfs_path(starts, ends, hd, cur, {entry})
        cycle_ids += seg[1:]
        if exit_ != entry:
            cycle_ids.append(exit_)
        cur = exit_
    back = _bfs_path(starts, ends, hd, cur, {f})
    cycle_ids += back[1:]
    if len(cycle_ids) > 1 and cycle_ids[-1] == f:
        cycle_ids.pop()  # cycle is implicit f -> ... -> f
    return prefix_ids, cycle_ids


def check_properties(
    cfg: ModelConfig,
    properties: List[str],
    chunk: int = 512,
    graph: Optional[Graph] = None,
    fairness: str = "wf_next",
    device=None,
) -> List[LivenessResult]:
    """Check named temporal properties (the reference's two, generalized
    over every reconciler).  Returns one result per property (the first
    violating reconciler wins).

    fairness="wf_next" is the spec's literal WF_vars(Next)
    (KubeAPI.tla:766); "wf_process" additionally assumes WF of each
    process's own action - the scheduler-fairness variant under which
    starvation lassos are excluded."""
    cdc = get_codec(cfg)
    if graph is None:
        graph = build_graph(cfg, chunk=chunk, device=device)
    st = graph.states.astype(np.int64)
    n_procs = cfg.n_clients + 1

    def sr_bit(ri: int) -> np.ndarray:
        return st[:, cdc.offsets["sr"] + ri] == 1

    def secret_present(ci: int) -> np.ndarray:
        si, _ = cfg.targets[ci]
        api = st[:, cdc.sl("api")]
        pres = (api >> cdc.o_present) & 1
        ident = (api >> cdc.o_ident) & ((1 << cdc.ib) - 1)
        return ((pres == 1) & (ident == si)).any(axis=1)

    out: List[LivenessResult] = []
    for name in properties:
        if cfg.n_reconcilers == 0:
            # both reference properties quantify over reconcilers:
            # vacuously true for an all-binder config
            out.append(LivenessResult(name, True, None, None))
            continue
        if name == "ReconcileCompletes":
            # sr[c] ~> ~sr[c] (KubeAPI.tla:798-799): H = {sr[c]}
            res = None
            for ri in range(cfg.n_reconcilers):
                p = sr_bit(ri)
                res = _check_leads_to(
                    graph, name, trigger=p, in_h=p, fairness=fairness,
                    n_procs=n_procs,
                )
                if not res.holds:
                    break
            out.append(res)
        elif name == "CleansUpProperly":
            # []~sr[c] ~> own secret absent (KubeAPI.tla:806-808):
            # H = {~sr[c] /\ secret present}
            res = None
            for k, ci in enumerate(cfg.reconciler_indices):
                h = ~sr_bit(k) & secret_present(ci)
                res = _check_leads_to(
                    graph, name, trigger=h, in_h=h, fairness=fairness,
                    n_procs=n_procs,
                )
                if not res.holds:
                    break
            out.append(res)
        else:
            raise ValueError(f"unknown temporal property {name!r}")
    return out
