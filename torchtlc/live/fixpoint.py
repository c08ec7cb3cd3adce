"""The survive-set greatest fixpoint over captured edges (port of
jaxtlc/live/fixpoint.py).

engine.liveness peels the surviving set Kahn-style over a host graph; here
the same greatest fixpoint

    survive(s) iff s in H and (terminal(s)
                               or some state-changing successor survives)

runs as Jacobi sweeps over the (src, dst) edges on the card (kernel K16):
each sweep marks the states with a surviving successor into a support
plane and writes the new alive set into a second buffer; the host reads
one `changed` flag a sweep.  The sweep count is the reference's
``lax.while_loop`` count.  With a ShardMesh of D > 1 shards the edges are
split into D slices whose support partials are summed over the shard axis
(engine.sharded.sharded_survive_fixpoint).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..engine.bfs import resolve_device
from .capture import CapturedGraph


def has_nonself(graph: CapturedGraph) -> np.ndarray:
    """[V] bool: state has at least one state-changing successor."""
    out = np.zeros(graph.n_states, bool)
    out[graph.src[graph.changed]] = True
    return out


def survive_sweep_plain(src: torch.Tensor, dst: torch.Tensor, D: int,
                        alive: torch.Tensor, term: torch.Tensor):
    """Torch version of kernel K16: one sweep over E edges in D equal
    slices (src outside [0, V) is padding) -> (alive2 [V] uint8, changed
    0-dim bool)."""
    V = alive.shape[0]
    E = src.shape[0]
    slice_of = torch.arange(E, device=src.device) // max(E // D, 1)
    s = src.to(torch.int64)
    hit = (s >= 0) & (s < V) & alive[dst.to(torch.int64)].bool()
    support = torch.zeros(D, V, dtype=torch.uint8, device=alive.device)
    support[slice_of[hit], s[hit]] = 1
    sup = support.to(torch.int32).sum(0) > 0
    alive2 = (alive.bool() & (term.bool() | sup)).to(torch.uint8)
    return alive2, (alive2 != alive).any()


def survive_sweep(src, dst, D: int, alive, term):
    """Kernel K16 on CUDA tensors, the plain version on CPU tensors."""
    if not alive.is_cuda:
        return survive_sweep_plain(src, dst, D, alive, term)
    from ..kernels import ops

    return ops.survive_sweep(src, dst, D, alive, term)


def survive_fixpoint(src: np.ndarray, dst: np.ndarray, in_h: np.ndarray,
                     terminal: np.ndarray, D: int = 1,
                     device=None) -> Tuple[np.ndarray, int]:
    """The fixpoint loop over (src, dst) edges already restricted to
    state-changing edges internal to H, cut into D slices: (alive bool
    [V], sweeps)."""
    dev = resolve_device(device)
    src_t = torch.from_numpy(np.ascontiguousarray(src, np.int32)).to(dev)
    dst_t = torch.from_numpy(np.ascontiguousarray(dst, np.int32)).to(dev)
    alive = torch.from_numpy(in_h.astype(np.uint8)).to(dev)
    term = torch.from_numpy(terminal.astype(np.uint8)).to(dev)
    sweeps = 0
    while True:
        alive, changed = survive_sweep(src_t, dst_t, D, alive, term)
        sweeps += 1
        if not bool(changed):
            break
    return alive.cpu().numpy().astype(bool), sweeps


def surviving_set(graph: CapturedGraph, in_h: np.ndarray, mesh=None,
                  nonself: Optional[np.ndarray] = None,
                  device=None) -> Tuple[np.ndarray, int]:
    """Greatest fixpoint over the restricted subgraph H: terminal H-states
    (no state-changing successor anywhere in G) may stutter forever under
    WF_vars(Next); every other survivor needs a surviving state-changing
    successor inside H.  Returns (alive bool [V], sweeps)."""
    if nonself is None:
        nonself = has_nonself(graph)
    terminal = in_h & ~nonself
    # edges that can support survival: state-changing, internal to H
    keep = graph.changed & in_h[graph.src] & in_h[graph.dst]
    src = graph.src[keep]
    dst = graph.dst[keep]
    if mesh is not None and mesh.n_shards > 1:
        from ..engine.sharded import sharded_survive_fixpoint

        return sharded_survive_fixpoint(mesh, graph.n_states, src, dst, in_h,
                                        terminal)
    return survive_fixpoint(src, dst, in_h, terminal, device=device)
