"""K exhaustive BFS runs in one dispatch: the batched engine of the serving
plane's constants-class sweeps (serve.sweep).

The reference gets it from ``jax.jit(jax.vmap(run_fn))`` over
make_backend_engine's run (jaxtlc/serve/sweep.py:260): the K carries are
stacked on a leading lane axis, and jax's batched while_loop runs every
body for all lanes, freezing a lane once its own condition is false, so
each lane's final carry equals a sequential run's, table words included.

Here the K lane carries share stacked storage - the level buffers
``[K, 2, qcap + 2*chunk, W]`` and the fingerprint tables ``[K, cap/8, 16]``
- and one body advances every live lane:

1. K32 ``emitted_expand_batched`` pops every live lane's level buffer at
   its own (parity, qhead, n, width) in one launch; a lane's slab of the
   ``[K, chunk*L]`` successor block is K17's output on the same rows;
2. K2 fingerprints the whole block in one launch;
3. the inserts: per body width, the sorted insert of every lane through
   one sort over (lane, key) and one launch of each stage of K33
   ``fpset_insert_batched``; in the sort-free mode each live lane's slab
   path (K5, K6, K3) and, for the lanes whose claimants exceed R, the
   sorted fallback through K33;
4. each live lane's commit - K4, and in the deferred mode K18 on its
   fresh claimants - as make_stage_pair's commit (their batched forms are
   later work);
5. one host read of the K lanes' bundles.

The per-lane rules that make every lane its sequential run:

* **Freeze.** A lane whose queue has drained or whose violation latched
  is not live: no kernel reads or writes its queue, table, counters or
  ring row, and its carry stays the sequential run's last carry.
* **Two-tier width per lane.** At chunk >= 2^14 a lane whose level
  remainder is below chunk // 2 pops chunk // 16 rows; lanes of one body
  may differ in width (K32 takes each lane's width; the inserts run once
  per width present).
* **Sort-free fallback per lane.** Each lane's slab path decides its own
  fallback, as the reference's lax.cond decides under vmap.

``make_batched_engine(backend, K, ...)`` returns ``(stack, run_fn,
unstack)``: ``stack(carries)`` moves K carries of make_backend_engine's
init_fn (same geometry) into one BatchedCarry, ``run_fn`` runs it to
every lane's end (``run_fn.bodies`` counts its bodies,
``run_fn.lane_bodies`` the lane bodies; ``run_fn.body`` is one body), and
``unstack`` returns the K lane carries (views of the stacked storage).
The backend is an emitted struct backend without coverage, certificate
or reduction: the sweep class's.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from .bfs import (
    Bundle,
    EngineCarry,
    _running,
    make_stage_pair,
    read_bundle,
    resolve_deferred,
    resolve_sort_free,
)
from .fingerprint import DEFAULT_FP_INDEX, fp64_words
from .fpset import (
    FPSet,
    _slab_dedup_core,
    fpset_insert_sorted_batched,
    fpset_key,
    slab_probe,
)


class BatchedCarry(NamedTuple):
    """K lane carries over stacked storage: ``queue`` [K, 2, rows, W] and
    ``table`` [K, cap/8, 16] hold every lane's level buffers and
    fingerprint table; ``lanes[k]`` is lane k's EngineCarry, whose queue
    and table are views of them (its scalars its own tensors)."""

    queue: torch.Tensor
    table: torch.Tensor
    lanes: tuple


def lane_view(packed, flags, action, gen, flat, k: int, ck: int, L: int,
              n_inv: int):
    """Lane k's K17-shaped outputs at width ck from K32's [K, C*L] slabs."""
    m = ck * L
    return (packed[k, :m], flags[k, :(3 + n_inv) * m].view(3 + n_inv, m),
            action[k, :m], gen[k], None if flat is None else flat[k, :m])


def make_batched_engine(backend, K: int, chunk: int = 1024,
                        queue_capacity: int = 1 << 15,
                        fp_capacity: int = 1 << 20, sort_free: bool = None,
                        deferred: bool = None, obs_slots: int = 0,
                        fp_index: int = DEFAULT_FP_INDEX):
    """(stack, run_fn, unstack) over K lanes of one backend and geometry;
    the module docstring.  Modes resolve as make_backend_engine's; the
    device is the carries' (make_backend_engine's init_fn's)."""
    kern = backend.kernels
    if getattr(kern, "expand_batched", None) is None:
        raise NotImplementedError(
            "the batched engine runs over struct backends (kernel K32)")
    if (backend.coverage is not None or backend.cert_check is not None
            or backend.reduce is not None):
        raise ValueError("a batched class carries no coverage plane, "
                         "certificate or reduction")
    sort_free = resolve_sort_free(sort_free, chunk)
    deferred = resolve_deferred(deferred, chunk)
    cdc = backend.cdc
    L = backend.n_lanes
    n_inv = len(backend.inv_codes)
    small = chunk // 16 if chunk >= 1 << 14 else 0
    kw = dict(queue_capacity=queue_capacity, fp_capacity=fp_capacity,
              sort_free=sort_free, deferred=deferred, obs_slots=obs_slots,
              fp_index=fp_index)
    widths = {chunk: make_stage_pair(backend, chunk, **kw)}
    if small:
        widths[small] = make_stage_pair(backend, small, **kw)

    def pick(h: Bundle) -> int:
        if small and h.level_n - h.qhead < chunk // 2:
            return small
        return chunk

    def stack(carries: List[EngineCarry]) -> BatchedCarry:
        if len(carries) != K:
            raise ValueError(f"{len(carries)} carries for {K} lanes")
        queue = torch.stack([c.queue for c in carries])
        table = torch.stack([c.fps.table for c in carries])
        lanes = tuple(
            c._replace(queue=queue[k], fps=FPSet(table[k]),
                       bundle=read_bundle(c))
            for k, c in enumerate(carries))
        return BatchedCarry(queue, table, lanes)

    def unstack(b: BatchedCarry) -> List[EngineCarry]:
        return list(b.lanes)

    def insert(b: BatchedCarry, members, exs, masks, width: int):
        """Every member lane's insert at one body width: {k: (fps,
        is_new_c, c_idx, nreps, fell_back)}."""
        R, CW = widths[width][1].widths
        out = {}
        to_sort = list(members)
        if sort_free:
            cores = {}
            for k in members:
                key = fpset_key(exs[k].lo, exs[k].hi, masks[k])
                cores[k] = (key,) + _slab_dedup_core(key, R, 4, 1, 0)
            counts = torch.stack([cores[k][2] for k in members]).tolist()
            to_sort = [k for k, nc in zip(members, counts) if nc > R]
            for k, nc in zip(members, counts):
                if nc <= R:
                    key, c_lane, n_cand = cores[k]
                    out[k] = (b.lanes[k].fps,) + slab_probe(
                        b.table[k], key, c_lane, n_cand, R, CW) + (False,)
        if to_sort:
            is_new, c_idx, nreps = fpset_insert_sorted_batched(
                b.table, to_sort,
                torch.stack([exs[k].lo for k in to_sort]),
                torch.stack([exs[k].hi for k in to_sort]),
                torch.stack([masks[k] for k in to_sort]),
                probe_width=R, claim_width=CW)
            for i, k in enumerate(to_sort):
                out[k] = (b.lanes[k].fps, is_new[i], c_idx[i], nreps[i],
                          sort_free)
        return out

    def body(b: BatchedCarry) -> BatchedCarry:
        hs = [c.bundle for c in b.lanes]
        live = [k for k, h in enumerate(hs) if _running(h)]
        pops = [[0, 0, 0, 0] for _ in range(K)]
        width, npop = {}, {}
        for k in live:
            h = hs[k]
            width[k] = w = pick(h)
            npop[k] = min(max(h.level_n - h.qhead, 0), w)
            pops[k] = [h.parity, h.qhead, npop[k], w]
        packed, flags, action, gen, flat = kern.expand_batched(
            b.queue, torch.tensor(pops, dtype=torch.int64), chunk, deferred)
        lo, hi = fp64_words(packed.view(-1, cdc.n_words), cdc.nbits,
                            fp_index)
        lo, hi = lo.view(K, -1), hi.view(K, -1)
        exs, masks = {}, {}
        for k in live:
            h, w = hs[k], width[k]
            pop_expand, commit = widths[w]
            m = w * L
            block = b.queue[k, h.parity, h.qhead:h.qhead + w]
            exs[k] = pop_expand.expand.finish(
                block, npop[k], *lane_view(packed, flags, action, gen, flat,
                                           k, w, L, n_inv),
                lo=lo[k, :m], hi=hi[k, :m])
            masks[k] = commit.insert_mask(exs[k], h)[1]
        ins = {}
        for w in widths:
            members = [k for k in live if width[k] == w]
            if members:
                ins.update(insert(b, members, exs, masks, w))
        pending = []
        for k in live:
            h, n = hs[k], npop[k]
            commit = widths[width[k]][1]
            pending.append((k, commit) + commit(
                b.lanes[k], exs[k], n, h.qhead + n, h.qhead + n, h,
                ins=ins[k], read=False))
        vals = torch.stack([p[3] for p in pending]).tolist()
        lanes = list(b.lanes)
        for (k, commit, c, _, ex), v in zip(pending, vals):
            lanes[k] = commit.settle(c, v, ex)
        run_fn.lane_bodies += len(live)
        return b._replace(lanes=tuple(lanes))

    def run_fn(b: BatchedCarry) -> BatchedCarry:
        bodies = 0
        while any(_running(c.bundle) for c in b.lanes):
            b = body(b)
            bodies += 1
        run_fn.bodies = bodies
        return b

    run_fn.body = body
    run_fn.bodies = 0
    run_fn.lane_bodies = 0
    return stack, run_fn, unstack
