"""Lasso reconstruction + host-oracle replay over captured edge tensors.

The violation certificate is TLC-style: a finite prefix from an initial
state to a surviving trigger state, then a cycle (or terminal stutter)
along surviving H-states.  Reconstruction is host-side - the lasso is a
few hundred states even on multi-million-state graphs - over numpy CSR
views of the captured (src, dst) tensors; no per-state Python objects
are ever built for the full graph.

Every reported lasso is REPLAYED through the frontend's host oracle
before it leaves this module: each consecutive pair must be a genuine
transition and the prefix must start at an initial state.  A lasso the
oracle cannot replay is a checker bug and raises, never prints.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from .capture import CapturedGraph


class LassoError(RuntimeError):
    """A reconstructed counterexample failed oracle replay."""


class _CSR:
    """Forward adjacency over a (src, dst) edge subset."""

    def __init__(self, n: int, src: np.ndarray, dst: np.ndarray,
                 action: Optional[np.ndarray] = None):
        order = np.argsort(src, kind="stable")
        self.src = src[order]
        self.dst = dst[order]
        self.action = action[order] if action is not None else None
        self.starts = np.searchsorted(self.src, np.arange(n))
        self.ends = np.searchsorted(self.src, np.arange(n) + 1)

    def out(self, v: int) -> np.ndarray:
        return self.dst[self.starts[v]:self.ends[v]]

    def edge_action(self, u: int, v: int) -> Optional[int]:
        for e in range(self.starts[u], self.ends[u]):
            if self.dst[e] == v and self.action is not None:
                return int(self.action[e])
        return None


def _bfs_path(csr: _CSR, sources, target_mask) -> List[int]:
    """Shortest path from any source to any target (ids, inclusive)."""
    prev = {int(s): -1 for s in sources}
    queue = list(prev.keys())
    for s in queue:
        if target_mask[s]:
            return [s]
    qi = 0
    while qi < len(queue):
        v = queue[qi]
        qi += 1
        for w in csr.out(v):
            w = int(w)
            if w in prev:
                continue
            prev[w] = v
            if target_mask[w]:
                path = [w]
                while prev[path[-1]] != -1:
                    path.append(prev[path[-1]])
                path.reverse()
                return path
            queue.append(w)
    raise LassoError("no path found (graph invariant broken)")


def build_lasso(
    graph: CapturedGraph,
    survive: np.ndarray,
    in_h: np.ndarray,
    trigger: np.ndarray,
) -> Tuple[List[int], List[int], List[Optional[int]], List[Optional[int]]]:
    """(prefix_ids, cycle_ids, prefix_action_ids, cycle_action_ids).

    Prefix runs from an initial state to the first surviving trigger
    state; the cycle stays within survive (a single id when the state is
    a terminal stutter).  Action ids label the edge INTO each position
    (None for initial states / stutter)."""
    changed = graph.changed
    full = _CSR(graph.n_states, graph.src[changed], graph.dst[changed],
                graph.action[changed])
    bad = trigger & survive
    # prefix: initial state -> nearest surviving trigger state
    prefix_ids = _bfs_path(full, range(graph.init_count), bad)
    start = prefix_ids[-1]

    keep = changed & survive[graph.src] & survive[graph.dst] \
        & in_h[graph.src] & in_h[graph.dst]
    alive_csr = _CSR(graph.n_states, graph.src[keep], graph.dst[keep],
                     graph.action[keep])
    seen_at = {start: 0}
    walk = [start]
    cur = start
    while True:
        outs = alive_csr.out(cur)
        if not len(outs):
            # terminal stutter: the "cycle" is stuttering in place
            entry = len(walk) - 1
            cyc = walk[entry:]
            break
        nxt = int(outs[0])
        if nxt in seen_at:
            entry = seen_at[nxt]
            cyc = walk[entry:]
            break
        seen_at[nxt] = len(walk)
        walk.append(nxt)
        cur = nxt
    prefix = prefix_ids + walk[1:entry]

    def acts(ids: List[int], pred0: Optional[int]) -> List[Optional[int]]:
        preds = [pred0] + ids[:-1]
        return [
            None if p is None or p == i else full.edge_action(p, i)
            for p, i in zip(preds, ids)
        ]

    return (
        prefix,
        cyc,
        acts(prefix, None),
        acts(cyc, prefix[-1] if prefix else cyc[-1]),
    )


def replay_lasso(
    prefix_states: List,
    cycle_states: List,
    is_initial: Callable[[object], bool],
    is_transition: Callable[[object, object], bool],
    equal: Optional[Callable[[object, object], bool]] = None,
) -> None:
    """Oracle replay validation: raise LassoError unless every
    consecutive (decoded) pair is a genuine transition, the cycle closes,
    and the prefix starts at an initial state.  Stuttering pairs
    (equal states) are admissible steps under [][Next]_vars."""
    if equal is None:
        equal = lambda a, b: a == b  # noqa: E731
    chain = list(prefix_states) + list(cycle_states) + [cycle_states[0]]
    if not is_initial(chain[0]):
        raise LassoError("lasso prefix does not start at an initial state")
    for sa, sb in zip(chain, chain[1:]):
        if equal(sa, sb):
            continue
        if not is_transition(sa, sb):
            raise LassoError("lasso edge is not a real transition")
