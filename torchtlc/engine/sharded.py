"""The sharded BFS engine (port of jaxtlc/engine/sharded.py:119-959,
1324-1487, 1560-1688): D fingerprint-space shards in one process.

Each shard owns the states whose fingerprint's ``hi & (D - 1)`` is its
index: its own table, circular frontier queue of unpacked ``[F]`` rows and
partial counters.  Every carry leaf keeps the reference's leading ``[D]``
axis (``ShardCarry``).  One body, all shards in step:

1. **expand** (every source shard): the pending verdicts of the last body
   are folded first in the pipelined mode (kernel K12); then each shard
   pops up to ``chunk`` rows at ``(qhead + r) % qcap``, and one launch of
   kernel K1's sharded variant expands the pops of all shards (successors
   packed and as raw fields), kernel K2 fingerprints them, and kernel K11
   routes them: a stable counting sort by owner and the payload scatter
   into the ``[D owner, D source, B]`` exchange planes;
2. **exchange** (``ShardMesh.exchange``): with the shards in one process
   the all_to_all is a layout - source s wrote its bucket for owner o at
   ``[o, s]``, so owner o's received batch ``[o].reshape(D*B)`` is the
   reference's ``recv.reshape(D*B, F+3)`` row for row;
3. **commit** (every owner): the fp-full test, the insert of the received
   fingerprints (``fpset_insert_dedup``: kernel K3, or the slab path's
   K5/K6/K3, at width ``SRW = min(4*chunk, D*B)``), the deferred
   invariants of the fresh claimants (kernel K7's received-rows variant),
   the circular enqueue (kernel K13), the verdict return and fold into the
   source shards' outdegree and per-action distinct counters (kernel K12;
   one body later in the pipelined mode), the violation order (invariants,
   assert, deadlock, slot overflow, then fp-full, queue-full and route
   overflow; a global max), level fencing by sums over the shard axis, the
   counter ring (kernel K8 per shard) and the coverage counters (kernel
   K10 per shard).

Shards read each other's state only through the exchange planes and the
axis-0 reductions, and every shard's expansion finishes before any commit,
so the order the shards run in does not matter.  A host loop drives the
bodies and reads one small bundle of scalars per body (plus, in the
sort-free mode, each owner's claimant count for the slab fallback).  Every
carry word - tables, queues (the dump row included), counters, ring,
coverage and the pipelined ``pv_*`` leaves - equals the reference's at the
same geometry (tests/test_torch_sharded.py).

The capacities are PER SHARD, as in the reference.  A segment engine
(``segment > 0``) runs exactly ``segment`` bodies, finished or not: a body
on a finished carry still adds its dump-column counts, as the reference's
``fori_loop`` does.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelConfig
from ..obs.counters import ring_cols, ring_row, shard_rows_from_ring
from ..obs.coverage import site_totals_dict
from ..spec.invariants import make_invariant_kernel
from ..spec.kernel import make_kernel
from ..spec.labels import LABELS
from .backend import (
    FLAG_AFAIL,
    FLAG_BAD_ONLYONE,
    FLAG_BAD_TYPEOK,
    FLAG_OVF,
    FLAG_VALID,
    OK,
    VIOL_ASSERT,
    VIOL_DEADLOCK,
    VIOL_FPSET_FULL,
    VIOL_QUEUE_FULL,
    VIOL_ROUTE_OVERFLOW,
    VIOL_SLOT_OVERFLOW,
    gen_counts,
    kubeapi_backend,
)
from .bfs import (
    FP_HIGHWATER,
    VIOLATION_NAMES,
    CheckResult,
    cov_totals,
    outdegree_from_hist,
    resolve_deferred,
    resolve_device,
    resolve_sort_free,
)
from .fingerprint import DEFAULT_FP_INDEX, fp64_words
from .fpset import FPSet, fpset_insert_dedup, host_insert

MASK32 = 0xFFFFFFFF


class ShardBundle(NamedTuple):
    """Host copy of the carry scalars a body needs before it launches."""

    qhead: list
    qtail: list
    level_end: list
    viol: int  # the global verdict (replicated)
    distinct: list
    cont: bool
    pl_flag: bool = False  # a pipelined flip row is staged


class ShardCarry(NamedTuple):
    """Per-shard state; every leaf's leading axis is the shard axis, as in
    the reference's ShardCarry (jaxtlc/engine/sharded.py:119-179).
    Counters are int64 holding the reference's uint32 words in their low
    32 bits; tables and queues are int32 words."""

    table: torch.Tensor  # [D, cap/8, 16] int32 bucket rows
    queue: torch.Tensor  # [D, qcap + 1, F] int32, row qcap = dump
    qhead: torch.Tensor  # [D] int64
    qtail: torch.Tensor  # [D]
    level_end: torch.Tensor  # [D]
    level: torch.Tensor  # [D] (replicated)
    depth: torch.Tensor  # [D]
    generated: torch.Tensor  # [D] partial counts
    distinct: torch.Tensor  # [D]
    act_gen: torch.Tensor  # [D, n_labels + 1]
    act_dist: torch.Tensor  # [D, n_labels + 1]
    outdeg_hist: torch.Tensor  # [D, L + 2]
    viol: torch.Tensor  # [D] global max, replicated
    viol_state: torch.Tensor  # [D, F] int32
    viol_local: torch.Tensor  # [D] bool: this shard captured viol_state
    cont: torch.Tensor  # [D] bool (replicated)
    # the pipelined verdict return (None on unpipelined engines): the last
    # body's owner verdicts and the source-side sorted-order words, folded
    # at the top of the next body
    pv_send: torch.Tensor = None  # [D owner, D source, B] uint8
    pv_sown: torch.Tensor = None  # [D, ncand] int32
    pv_pos: torch.Tensor = None  # [D, ncand] int32
    pv_svalid: torch.Tensor = None  # [D, ncand] bool
    pv_order: torch.Tensor = None  # [D, ncand] int32
    pv_faction: torch.Tensor = None  # [D, ncand] int32
    pv_n: torch.Tensor = None  # [D] int64 rows popped by that body
    # the counter ring (None when obs is off): one partial row per global
    # level flip on every shard
    obs_ring: torch.Tensor = None  # [D, obs_slots + 1, cols] int32 words
    obs_head: torch.Tensor = None  # [D]
    obs_bodies: torch.Tensor = None  # [D]
    obs_expanded: torch.Tensor = None  # [D]
    # the pipelined ring's staged flip row (pipeline x obs only)
    obs_pl_level: torch.Tensor = None  # [D]
    obs_pl_flag: torch.Tensor = None  # [D] bool
    cov_counts: torch.Tensor = None  # [D, n_sites] int64 partials
    # scalars above as of the body that made this carry (None: read them)
    bundle: ShardBundle = None


class ShardMesh(NamedTuple):
    """D logical shards on one device (None: the card)."""

    n_shards: int
    device: object = None

    def exchange(self, *planes):
        """The candidate and verdict all_to_all.  In one process it is the
        identity: K11 writes source s's bucket for owner o at [o, s] of
        each plane, which is where owner o receives it."""
        return planes


class RouteOut(NamedTuple):
    """K11's outputs: the sorted-order words of each source shard and the
    exchange planes ([D owner, D source, B, ...])."""

    order: torch.Tensor  # [D, ncand] int32 owner-sort permutation
    s_own: torch.Tensor  # [D, ncand] int32 owner per sorted lane (D: none)
    s_pos: torch.Tensor  # [D, ncand] int32 position in the owner's bucket
    s_valid: torch.Tensor  # [D, ncand] bool
    xrows: torch.Tensor  # [D, D, B, F] int32 candidate fields
    xlo: torch.Tensor  # [D, D, B] int32 fingerprint words
    xhi: torch.Tensor  # [D, D, B] int32
    xvalid: torch.Tensor  # [D, D, B] bool
    route_ovf: torch.Tensor  # [D] bool: a valid lane past its bucket


def route_bucket_width(chunk: int, n_lanes: int, D: int,
                       route_factor: float) -> int:
    """Per-destination bucket slots (jaxtlc/engine/sharded.py:221)."""
    ncand = chunk * n_lanes
    return ncand if D == 1 else min(ncand, int(route_factor * ncand / D) + 8)


def route_out_new(D: int, ncand: int, B: int, F: int, device) -> RouteOut:
    def z(*shape, dtype=torch.int32):
        return torch.zeros(*shape, dtype=dtype, device=device)

    return RouteOut(order=z(D, ncand), s_own=z(D, ncand), s_pos=z(D, ncand),
                    s_valid=z(D, ncand, dtype=torch.bool),
                    xrows=z(D, D, B, F), xlo=z(D, D, B), xhi=z(D, D, B),
                    xvalid=z(D, D, B, dtype=torch.bool),
                    route_ovf=z(D, dtype=torch.bool))


# ---------------------------------------------------------------------------
# plain versions of the sharded kernels (the CPU path and the readable
# specification each kernel is held against)
# ---------------------------------------------------------------------------


def popped_rows(queue: torch.Tensor, qhead: torch.Tensor, ck: int):
    """[D, ck, F]: shard d's rows queue[d, (qhead[d] + r) % qcap]."""
    D, qrows, _ = queue.shape
    r = (qhead[:, None] + torch.arange(ck, device=queue.device)) % (qrows - 1)
    return queue[torch.arange(D, device=queue.device)[:, None], r]


def expand_sharded_plain(cfg, queue, qhead, npop, ck: int,
                         deferred: bool = False, with_block: bool = False):
    """Torch version of K1's sharded variant: every lane of the D pops ->
    (packed [D*ck*L, W], flags [5, D*ck*L] uint8, action [D*ck*L] int32,
    gen [D, n_labels] int64, fields [D*ck*L, F] int32, block [D*ck, W] or
    None); shard d's rows past npop[d] are outside the pop mask.  The
    next-state function runs on the raw queue rows, as the reference's
    does (jaxtlc/engine/sharded.py:517-556)."""
    from ..spec.codec import get_codec

    cdc = get_codec(cfg)
    D = queue.shape[0]
    F = cdc.n_fields
    rows = popped_rows(queue, qhead, ck)
    batch = rows.reshape(D * ck, F)
    succ, valid, action, afail, ovf = make_kernel(cfg)(batch)
    mask = (torch.arange(ck, device=queue.device)[None]
            < npop[:, None]).reshape(-1)
    valid = valid & mask[:, None]
    afail = afail & valid
    ovf = ovf & valid
    flat = succ.reshape(-1, F).to(torch.int32)
    fvalid = valid.reshape(-1)
    if deferred:  # every invariant holds until the owner's check
        bits = torch.full_like(fvalid, 3, dtype=torch.int32)
    else:
        bits = make_invariant_kernel(cfg)(flat)
    flags = torch.stack([
        fvalid, afail.reshape(-1), ovf.reshape(-1),
        fvalid & ((bits & 1) == 0), fvalid & ((bits & 2) == 0),
    ]).to(torch.uint8)
    L = valid.shape[1]
    gen = torch.stack([gen_counts(cfg, rows[d], valid.view(D, ck, L)[d])
                       for d in range(D)])
    return (cdc.pack(flat), flags, action.reshape(-1).to(torch.int32), gen,
            flat, cdc.pack(batch) if with_block else None)


def expand_sharded(cfg, queue, qhead, npop, ck: int, deferred: bool = False,
                   with_block: bool = False):
    """K1's sharded variant on CUDA tensors, the plain version on CPU
    tensors."""
    if not queue.is_cuda:
        return expand_sharded_plain(cfg, queue, qhead, npop, ck, deferred,
                                    with_block)
    from ..kernels import ops

    return ops.expand_sharded(cfg, queue, qhead, npop, ck, deferred,
                              with_block)


def route_plain(hi, lo, valid, fields, D: int, B: int, out: RouteOut) -> None:
    """Torch version of K11, the reference's formulas
    (jaxtlc/engine/sharded.py:553-586): key = owner or D, a stable argsort,
    the bucket position by searchsorted, the payload of each valid lane
    that fits into the planes at [owner, source, position].  `out` in
    place (xvalid and route_ovf zeroed first; other plane slots keep their
    words)."""
    N = hi.shape[0]
    ncand = N // D
    F = fields.shape[1]
    out.xvalid.zero_()
    out.route_ovf.zero_()
    dev = hi.device
    ar = torch.arange(ncand, device=dev)
    for s in range(D):
        sl = slice(s * ncand, (s + 1) * ncand)
        v = valid[sl].bool()
        key = torch.where(v, hi[sl].to(torch.int64) & (D - 1), D)
        order = torch.sort(key, stable=True).indices
        s_own = key[order]
        start = torch.searchsorted(s_own, torch.arange(D + 1, device=dev))
        pos = ar - start[s_own]
        s_valid = v[order]
        out.order[s] = order.to(torch.int32)
        out.s_own[s] = s_own.to(torch.int32)
        out.s_pos[s] = pos.to(torch.int32)
        out.s_valid[s] = s_valid
        out.route_ovf[s] = (s_valid & (pos >= B)).any()
        fit = s_valid & (pos < B)
        lanes = order[fit]
        o, p = s_own[fit], pos[fit]
        out.xrows[o, s, p] = fields[sl][lanes].view(-1, F)
        out.xlo[o, s, p] = lo[sl][lanes]
        out.xhi[o, s, p] = hi[sl][lanes]
        out.xvalid[o, s, p] = True


def route(hi, lo, valid, fields, D: int, B: int, out: RouteOut) -> None:
    """K11 on CUDA tensors, the plain version on CPU tensors."""
    if not hi.is_cuda:
        return route_plain(hi, lo, valid, fields, D, B, out)
    from ..kernels import ops

    ops.route_scatter(hi, lo, valid, fields, D, B, out)


def verdict_fold_plain(verd, s_own, s_pos, s_valid, order, faction, npop,
                       chunk: int, L: int, n_labels: int, outdeg,
                       act_dist) -> None:
    """Torch version of K12, the reference's formulas
    (jaxtlc/engine/sharded.py:485-505, 701-719): source s reads the verdict
    of its sorted lane at [owner, s, position], scatters it to the lane's
    original index, and adds the per-row new-degree histogram (unpopped
    rows in bin L + 1) and the per-action distinct counts (non-new lanes in
    column n_labels).  outdeg, act_dist in place."""
    D, _, B = verd.shape
    ncand = s_own.shape[1]
    dev = verd.device
    for s in range(D):
        own = s_own[s].to(torch.int64)
        pos = s_pos[s].to(torch.int64)
        got = ((verd[own.clamp(0, D - 1), s, pos.clamp(0, B - 1)] == 1)
               & s_valid[s] & (pos < B))
        is_new = torch.zeros(ncand, dtype=torch.bool, device=dev)
        is_new[order[s].to(torch.int64)] = got
        newdeg = is_new.view(chunk, L).sum(1)
        mask = torch.arange(chunk, device=dev) < npop[s]
        outdeg[s] += torch.bincount(torch.where(mask, newdeg, L + 1),
                                    minlength=L + 2)
        act_dist[s] += torch.bincount(
            torch.where(is_new, faction[s].to(torch.int64), n_labels),
            minlength=n_labels + 1)


def verdict_fold(verd, s_own, s_pos, s_valid, order, faction, npop,
                 chunk: int, L: int, n_labels: int, outdeg, act_dist) -> None:
    """K12 on CUDA tensors, the plain version on CPU tensors."""
    args = (verd, s_own, s_pos, s_valid, order, faction, npop, chunk, L,
            n_labels, outdeg, act_dist)
    if not verd.is_cuda:
        return verdict_fold_plain(*args)
    from ..kernels import ops

    ops.verdict_fold(*args)


def shard_enqueue_plain(queue, is_new, cum, qtail, q_full, xrows,
                        xvalid) -> None:
    """Torch version of K13 (jaxtlc/engine/sharded.py:685-689): each
    owner's fresh rows to (qtail + rank) % qcap unless its queue is full;
    the dump row qcap gets the last row that is not enqueued (the
    reference scatters every such row there and its last one stays), an
    empty slot's row being zeros.  queue in place."""
    D, qrows, _ = queue.shape
    qcap = qrows - 1
    n = is_new.shape[1]
    for o in range(D):
        eff = is_new[o] & ~q_full[o]
        tgt = (qtail[o] + cum[o] - 1) % qcap
        queue[o, tgt[eff]] = xrows[o][eff]
        rest = torch.nonzero(~eff).flatten()
        if rest.numel():
            i = int(rest[-1])
            queue[o, qcap] = xrows[o, i] if bool(xvalid[o, i]) else 0
    assert n == xrows.shape[1]


def shard_enqueue(queue, is_new, cum, qtail, q_full, xrows, xvalid) -> None:
    """K13 on CUDA tensors, the plain version on CPU tensors."""
    args = (queue, is_new, cum, qtail, q_full, xrows, xvalid)
    if not queue.is_cuda:
        return shard_enqueue_plain(*args)
    from ..kernels import ops

    ops.shard_enqueue(*args)


def deferred_check_rows_plain(cfg, rows_in, fresh, c_idx, rows: int):
    """Torch version of K7's received-rows variant (the reference's
    make_deferred_checker over the owner's r_flat, with no action): first
    wins across TypeOK, OnlyOneVersion; within a code the highest
    violating lane.  -> (viol 0-dim int64, state [F] int32)."""
    dev = rows_in.device
    lanes = c_idx[:rows][fresh[:rows]]
    viol = OK
    state = torch.zeros(rows_in.shape[1], dtype=torch.int32, device=dev)
    if lanes.numel():
        bits = make_invariant_kernel(cfg)(rows_in[lanes])
        for k, code in enumerate((1, 2)):
            bad = (bits & (1 << k)) == 0
            if bad.any():
                j = int(torch.argmax(torch.where(bad, lanes, -1)))
                viol, state = code, rows_in[lanes[j]].to(torch.int32)
                break
    return torch.tensor(viol, dtype=torch.int64, device=dev), state


def deferred_check_rows(cfg, rows_in, fresh, c_idx, rows: int):
    """K7's received-rows variant on CUDA tensors, the plain version on CPU
    tensors."""
    if not rows_in.is_cuda:
        return deferred_check_rows_plain(cfg, rows_in, fresh, c_idx, rows)
    from ..kernels import ops

    return ops.deferred_check_rows(cfg, rows_in, fresh, c_idx, rows)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def read_bundle(c: ShardCarry) -> ShardBundle:
    if c.bundle is not None:
        return c.bundle
    D = c.qhead.shape[0]
    flag = (c.obs_pl_flag.to(torch.int64) if c.obs_pl_flag is not None
            else c.qhead * 0)
    vals = torch.stack([c.qhead, c.qtail, c.level_end, c.viol, c.distinct,
                        c.cont.to(torch.int64), flag]).tolist()
    return ShardBundle(qhead=vals[0], qtail=vals[1], level_end=vals[2],
                       viol=max(vals[3]), distinct=vals[4],
                       cont=any(vals[5]), pl_flag=bool(vals[6][0]))


def carry_done(c: ShardCarry) -> bool:
    return not read_bundle(c).cont


def make_sharded_engine(
    cfg: ModelConfig,
    mesh: ShardMesh,
    chunk: int = 512,
    queue_capacity: int = 1 << 14,
    fp_capacity: int = 1 << 18,
    fp_index: int = DEFAULT_FP_INDEX,
    route_factor: float = 2.0,
    segment: int = 0,
    backend=None,
    fp_highwater: float = None,
    pipeline: bool = False,
    obs_slots: int = 0,
    sort_free: bool = None,
    deferred: bool = None,
):
    """Build (init_fn, run_fn) over `mesh` (jaxtlc/engine/sharded.py:232).

    chunk, queue_capacity and fp_capacity are PER SHARD.  run_fn(carry)
    runs bodies until no shard continues, or exactly `segment` bodies when
    segment > 0; run_fn.steps counts the bodies of its last call.  The
    modes resolve against the per-shard chunk as the reference's do;
    pipeline=True folds each body's verdicts one body later (and runs one
    drain body); obs_slots > 0 carries the per-shard counter ring; a
    backend with a coverage plane carries ``cov_counts``."""
    D = mesh.n_shards
    assert D & (D - 1) == 0, "device count must be a power of two"
    assert D <= 8, "the route kernels take at most 8 shards"
    dev = resolve_device(mesh.device)
    if fp_highwater is None:
        fp_highwater = FP_HIGHWATER
    assert 0.0 < fp_highwater <= 1.0, "fp_highwater must be in (0, 1]"
    if backend is None:
        backend = kubeapi_backend(cfg)
    cdc = backend.cdc
    F = cdc.n_fields
    L = backend.n_lanes
    n_labels = len(backend.labels)
    qcap = queue_capacity
    ncand = chunk * L
    B = route_bucket_width(chunk, L, D, route_factor)
    DB = D * B
    sort_free = resolve_sort_free(sort_free, chunk)
    deferred = resolve_deferred(deferred, chunk)
    SRW = min(4 * chunk, DB)
    fp_limit = int(fp_capacity * fp_highwater)
    checking = deferred and bool(backend.inv_codes)
    imm_codes = () if deferred else backend.inv_codes
    imm_flags = (FLAG_BAD_TYPEOK, FLAG_BAD_ONLYONE)
    rt = route_out_new(D, ncand, B, F, dev)
    shards = torch.arange(D, device=dev)

    def owner_of(hi: torch.Tensor) -> torch.Tensor:
        return hi.to(torch.int64) & (D - 1)

    def i64(v):
        return torch.as_tensor(v, dtype=torch.int64, device=dev)

    def init_fn() -> ShardCarry:
        inits = np.asarray(backend.initial_vectors(), np.int32)
        packed = cdc.pack(torch.from_numpy(inits))
        lo, hi = fp64_words(packed, cdc.nbits, fp_index)
        own = owner_of(hi).numpy()
        lo_np = lo.numpy().view(np.uint32)
        hi_np = hi.numpy().view(np.uint32)
        queue = np.zeros((D, qcap + 1, F), np.int32)
        qtail = np.zeros(D, np.int64)
        table = np.zeros((D, fp_capacity // 8, 16), np.uint32)
        distinct = np.zeros(D, np.int64)
        for i in range(inits.shape[0]):
            d = int(own[i])
            if host_insert(table[d], int(lo_np[i]), int(hi_np[i])):
                queue[d, qtail[d]] = inits[i]
                qtail[d] += 1
                distinct[d] += 1
        gen = np.zeros(D, np.int64)
        gen[0] = inits.shape[0]  # Init counted once, on shard 0

        def z(*shape, dtype=torch.int64):
            return torch.zeros(*shape, dtype=dtype, device=dev)

        extra = {}
        if backend.coverage is not None:
            cov0 = np.zeros((D, backend.coverage.n_sites), np.int64)
            cov0[0] = backend.coverage.seed(inits)
            extra["cov_counts"] = torch.from_numpy(cov0).to(dev)
        if pipeline:
            extra.update(
                pv_send=z(D, D, B, dtype=torch.uint8),
                pv_sown=z(D, ncand, dtype=torch.int32),
                pv_pos=z(D, ncand, dtype=torch.int32),
                pv_svalid=z(D, ncand, dtype=torch.bool),
                pv_order=z(D, ncand, dtype=torch.int32),
                pv_faction=z(D, ncand, dtype=torch.int32), pv_n=z(D))
        if obs_slots:
            extra.update(
                obs_ring=z(D, obs_slots + 1, ring_cols(n_labels),
                           dtype=torch.int32),
                obs_head=z(D), obs_bodies=z(D), obs_expanded=z(D))
            if pipeline:
                extra.update(obs_pl_level=z(D),
                             obs_pl_flag=z(D, dtype=torch.bool))
        return ShardCarry(
            table=torch.from_numpy(table.view(np.int32)).to(dev),
            queue=torch.from_numpy(queue).to(dev), qhead=z(D),
            qtail=torch.from_numpy(qtail).to(dev),
            level_end=torch.from_numpy(qtail.copy()).to(dev),
            level=torch.ones(D, dtype=torch.int64, device=dev),
            depth=torch.ones(D, dtype=torch.int64, device=dev),
            generated=torch.from_numpy(gen).to(dev),
            distinct=torch.from_numpy(distinct).to(dev),
            act_gen=z(D, n_labels + 1), act_dist=z(D, n_labels + 1),
            outdeg_hist=z(D, L + 2), viol=z(D),
            viol_state=z(D, F, dtype=torch.int32),
            viol_local=z(D, dtype=torch.bool),
            cont=torch.ones(D, dtype=torch.bool, device=dev), **extra)

    def pick(vmask: torch.Tensor, states_of):
        """Per shard: any hit, and the state at the first hit
        (states[argmax(vmask)])."""
        first = vmask.to(torch.uint8).argmax(1)
        return vmask.any(1), states_of(first)

    def body(c: ShardCarry, h: ShardBundle) -> ShardCarry:
        # ---- expand (every source shard) ----
        if pipeline:
            verdict_fold(c.pv_send, c.pv_sown, c.pv_pos, c.pv_svalid,
                         c.pv_order, c.pv_faction, c.pv_n, chunk, L,
                         n_labels, c.outdeg_hist, c.act_dist)
        n = [min(chunk, min(e, t) - q) if h.viol == OK else 0
             for q, t, e in zip(h.qhead, h.qtail, h.level_end)]
        npop = i64(n)
        packed, flags, action, gen, fields, block = expand_sharded(
            cfg, c.queue, c.qhead, npop, chunk, deferred,
            with_block=backend.coverage is not None)
        lo, hi = fp64_words(packed, cdc.nbits, fp_index)
        route(hi, lo, flags[FLAG_VALID], fields, D, B, rt)
        xrows, xlo, xhi, xvalid = mesh.exchange(rt.xrows, rt.xlo, rt.xhi,
                                                rt.xvalid)

        # ---- commit (every owner) ----
        is_new = torch.zeros(D, DB + 1, dtype=torch.bool, device=dev)
        d_viol = [None] * D
        d_state = [None] * D
        fp_full = [h.distinct[o] + DB > fp_limit for o in range(D)]
        for o in range(D):
            r_valid = xvalid[o].view(DB)
            mask = torch.zeros_like(r_valid) if fp_full[o] else r_valid
            _, is_new_c, c_idx, _, fell = fpset_insert_dedup(
                FPSet(c.table[o]), xlo[o].view(DB), xhi[o].view(DB), mask,
                probe_width=SRW if sort_free else 0, sort_free=sort_free)
            is_new[o, c_idx] = is_new_c  # the slab sentinel lane DB drops
            if checking:
                d_viol[o], d_state[o] = deferred_check_rows(
                    cfg, xrows[o].view(DB, F), is_new_c, c_idx,
                    SRW if sort_free and not fell else DB)
        is_new = is_new[:, :DB].contiguous()
        cum = torch.cumsum(is_new, 1)
        n_new = cum[:, -1]
        q_full = (c.qtail - c.qhead) + n_new > qcap
        shard_enqueue(c.queue, is_new, cum, c.qtail, q_full,
                      xrows.view(D, DB, F), xvalid.view(D, DB))
        (verd,) = mesh.exchange(is_new.view(D, D, B).to(torch.uint8))
        if not pipeline:
            verdict_fold(verd, rt.s_own, rt.s_pos, rt.s_valid, rt.order,
                         action.view(D, ncand), npop, chunk, L, n_labels,
                         c.outdeg_hist, c.act_dist)
        nvalid = gen.sum(1)
        generated = c.generated + nvalid
        distinct = c.distinct + n_new
        act_gen = c.act_gen.clone()
        act_gen[:, :n_labels] += gen
        act_gen[:, n_labels] += ncand - nvalid
        cov_counts = c.cov_counts
        if backend.coverage is not None:
            cov = torch.stack([
                backend.coverage.count(block[d * chunk:(d + 1) * chunk], n[d],
                                       flags[FLAG_VALID, d * ncand:
                                             (d + 1) * ncand])
                for d in range(D)])
            cov_counts = cov_counts + (cov.to(torch.int64) & MASK32)

        # ---- violations (local detect, global max) ----
        new_viol = torch.zeros(D, dtype=torch.int64, device=dev)
        new_vstate = c.viol_state
        if checking:
            dv = torch.stack(d_viol)
            hit = dv != OK
            new_viol = torch.where(hit, dv, new_viol)
            new_vstate = torch.where(hit[:, None], torch.stack(d_state),
                                     new_vstate)
        fl = flags.view(5, D, ncand)
        qh = c.qhead

        def lane_rows(first):  # the popped row of a lane
            return c.queue[shards, (qh + first // L) % qcap]

        def row_rows(first):
            return c.queue[shards, (qh + first) % qcap]

        dead = (~fl[FLAG_VALID].view(D, chunk, L).bool().any(2)
                & (torch.arange(chunk, device=dev)[None] < npop[:, None]))
        fv = fields.view(D, ncand, F)
        cands = [(code, fl[f].bool(), lambda i: fv[shards, i])
                 for code, f in zip(imm_codes, imm_flags)]
        cands += [(VIOL_ASSERT, fl[FLAG_AFAIL].bool(), lane_rows),
                  (VIOL_DEADLOCK, dead, row_rows),
                  (VIOL_SLOT_OVERFLOW, fl[FLAG_OVF].bool(), lane_rows)]
        for code, vmask, states_of in cands:
            anyv, st = pick(vmask, states_of)
            hit = anyv & (new_viol == OK)
            new_viol = torch.where(hit, code, new_viol)
            new_vstate = torch.where(hit[:, None], st, new_vstate)
        new_viol = torch.where((new_viol == OK)
                               & torch.tensor(fp_full, device=dev)
                               & xvalid.view(D, DB).any(1), VIOL_FPSET_FULL,
                               new_viol)
        new_viol = torch.where((new_viol == OK) & q_full, VIOL_QUEUE_FULL,
                               new_viol)
        new_viol = torch.where((new_viol == OK) & rt.route_ovf,
                               VIOL_ROUTE_OVERFLOW, new_viol)
        viol = c.viol
        global_viol = torch.where(viol == OK, new_viol, viol).max().expand(D)
        became = (viol == OK) & (new_viol != OK)
        viol_local = c.viol_local | became
        viol_state = torch.where(became[:, None], new_vstate, c.viol_state)

        # ---- advance + level fencing (global) ----
        adv = viol == OK
        qhead = c.qhead + npop
        qtail = torch.where(q_full, c.qtail, c.qtail + n_new)
        rem = torch.minimum(c.level_end, qtail) - qhead
        level_done = rem.sum() == 0
        more = (qtail - qhead).sum() > 0
        level2 = torch.where(adv & level_done & more, c.level + 1, c.level)
        depth2 = torch.where(
            adv, torch.maximum(c.depth, torch.where(more, level2, c.level)),
            c.depth)
        level_end2 = torch.where(adv & level_done, qtail, c.level_end)
        cont = more & (global_viol == OK)
        # host twins of adv & level_done: the entry verdict and, since a
        # level's end never passes the tail, the popped rows
        adv_h = h.viol == OK
        done_h = sum(e - q for q, e in zip(h.qhead, h.level_end)) == sum(n)
        obs = {}
        if obs_slots:
            # acts_old pairs act_dist with itself: the reference's wrap
            # test (jaxtlc/engine/sharded.py:793-799) leaves it out
            if pipeline:
                # the last body's staged flip row, its act_dist completed
                # by the fold at the top of this body
                queue_n = c.qtail - c.qhead
                for d in range(D):
                    ring_row(c.obs_ring[d], c.obs_head[d], c.obs_bodies[d],
                             c.obs_expanded[d], n[d], h.pl_flag,
                             c.obs_pl_level[d], generated[d], c.generated[d],
                             distinct[d], c.distinct[d], queue_n[d],
                             act_gen[d], c.act_dist[d],
                             torch.cat([c.act_gen[d], c.act_dist[d]]),
                             n_labels, entry=True)
                stage = adv_h and done_h and sum(n) > 0
                obs = dict(
                    obs_pl_level=(c.level.clone() if stage
                                  else c.obs_pl_level),
                    obs_pl_flag=torch.full((D,), stage, dtype=torch.bool,
                                           device=dev))
            else:
                queue_n = qtail - qhead
                for d in range(D):
                    ring_row(c.obs_ring[d], c.obs_head[d], c.obs_bodies[d],
                             c.obs_expanded[d], n[d], adv_h and done_h,
                             c.level[d], generated[d], c.generated[d],
                             distinct[d], c.distinct[d], queue_n[d],
                             act_gen[d], c.act_dist[d],
                             torch.cat([c.act_gen[d], c.act_dist[d]]),
                             n_labels)
        pv = {}
        if pipeline:
            cont = cont | (sum(n) > 0)
            pv = dict(pv_send=verd, pv_sown=rt.s_own.clone(),
                      pv_pos=rt.s_pos.clone(), pv_svalid=rt.s_valid.clone(),
                      pv_order=rt.order.clone(),
                      pv_faction=action.view(D, ncand), pv_n=npop)
        out = c._replace(
            qhead=qhead, qtail=qtail, level_end=level_end2, level=level2,
            depth=depth2, generated=generated, distinct=distinct,
            act_gen=act_gen, viol=global_viol.clone(),
            viol_state=viol_state, viol_local=viol_local, cont=cont,
            cov_counts=cov_counts, bundle=None, **pv, **obs)
        return out._replace(bundle=read_bundle(out))

    def run_fn(c: ShardCarry) -> ShardCarry:
        steps = 0
        h = read_bundle(c)
        if segment > 0:
            for _ in range(segment):
                c = body(c, h)
                h = c.bundle
                steps += 1
        else:
            while h.cont:
                c = body(c, h)
                h = c.bundle
                steps += 1
        run_fn.steps = steps
        return c

    run_fn.steps = 0
    run_fn.geometry = dict(D=D, B=B, ncand=ncand, F=F, L=L, chunk=chunk,
                           SRW=SRW, sort_free=sort_free, deferred=deferred)
    return init_fn, run_fn


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def result_from_shard_carry(out: ShardCarry, wall: float,
                            iterations: int = -1, labels: tuple = LABELS,
                            viol_names: dict = None,
                            fp_capacity_total: int = 0,
                            sites: tuple = None) -> CheckResult:
    """Globally reduced statistics of a finished or paused carry
    (jaxtlc/engine/sharded.py:1324)."""
    def u32(t):
        return _np(t).astype(np.int64) & MASK32

    act_gen = u32(out.act_gen).sum(axis=0)[:len(labels)]
    act_dist = u32(out.act_dist).sum(axis=0)[:len(labels)]
    hist = u32(out.outdeg_hist).sum(axis=0)[:-1]
    viol = int(_np(out.viol).max())
    vl = _np(out.viol_local)
    vstate = np.zeros(out.viol_state.shape[-1], np.int32)
    if vl.any():
        vstate = _np(out.viol_state)[int(np.argmax(vl))]
    vname = (viol_names or {}).get(viol) or VIOLATION_NAMES.get(
        viol, f"violation {viol}")
    distinct = int(u32(out.distinct).sum())
    totals = cov_totals(out)
    return CheckResult(
        generated=int(u32(out.generated).sum()), distinct=distinct,
        depth=int(_np(out.depth).max()),
        queue_left=int((_np(out.qtail) - _np(out.qhead)).sum()),
        violation=viol, violation_name=vname, violation_state=vstate,
        violation_action=-1,
        action_generated={labels[i]: int(v) for i, v in enumerate(act_gen)
                          if v},
        action_distinct={labels[i]: int(v) for i, v in enumerate(act_dist)
                         if v},
        wall_s=wall, iterations=iterations,
        outdegree=outdegree_from_hist(hist),
        fp_occupancy=(distinct / fp_capacity_total if fp_capacity_total
                      else None),
        site_coverage=(None if sites is None or totals is None
                       else site_totals_dict(sites, totals)))


def obs_rows_sharded(carry: ShardCarry, labels: tuple = None, since: int = 0,
                     fp_capacity_total: int = 0):
    """The shards' rings (partials summed per level) as journal `level`
    event dicts, and the new head cursor; ([], since) when obs is off."""
    if getattr(carry, "obs_ring", None) is None:
        return [], int(since)
    heads = _np(carry.obs_head)
    return (shard_rows_from_ring(_np(carry.obs_ring), heads, labels=labels,
                                 since=since,
                                 fp_capacity_total=fp_capacity_total),
            int(heads.min()))


def obs_rows_sharded_local(carry: ShardCarry, labels: tuple = None,
                           since: int = 0, fp_capacity_total: int = 0):
    """This process's shards' rows (jaxtlc/engine/sharded.py:1395): with
    every shard in one process, obs_rows_sharded's."""
    return obs_rows_sharded(carry, labels, since, fp_capacity_total)


def cov_totals_local(carry: ShardCarry):
    """This process's partial site totals (jaxtlc/engine/sharded.py:1425):
    with every shard in one process, the totals."""
    return cov_totals(carry)


def drain_pending_host(carry: ShardCarry) -> ShardCarry:
    """Apply a pipelined carry's pending verdict statistics
    (jaxtlc/engine/sharded.py:1439, there a numpy replay on the host): K12
    over the pv_* leaves on the carry's own device, into copies of
    outdeg_hist and act_dist, then the pending buffers emptied.
    Unpipelined carries pass through."""
    if carry.pv_n is None:
        return carry
    outdeg = carry.outdeg_hist.clone()
    act_dist = carry.act_dist.clone()
    L = outdeg.shape[1] - 2
    verdict_fold(carry.pv_send, carry.pv_sown, carry.pv_pos, carry.pv_svalid,
                 carry.pv_order, carry.pv_faction, carry.pv_n,
                 carry.pv_sown.shape[1] // L, L, act_dist.shape[1] - 1,
                 outdeg, act_dist)
    return carry._replace(
        outdeg_hist=outdeg, act_dist=act_dist,
        pv_send=torch.zeros_like(carry.pv_send),
        pv_svalid=torch.zeros_like(carry.pv_svalid),
        pv_n=torch.zeros_like(carry.pv_n), bundle=None)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _sync(carry: ShardCarry) -> None:
    if carry.queue.is_cuda:
        torch.cuda.synchronize(carry.queue.device)


def check_sharded(cfg: ModelConfig, mesh: ShardMesh, chunk: int = 512,
                  queue_capacity: int = 1 << 14, fp_capacity: int = 1 << 18,
                  route_factor: float = 2.0, backend=None,
                  pipeline: bool = False, obs_slots: int = 0,
                  sort_free: bool = None, deferred: bool = None,
                  fp_index: int = DEFAULT_FP_INDEX) -> CheckResult:
    """Exhaustive sharded check (jaxtlc/engine/sharded.py:1560); wall_s
    times the run only (the kernels are built before it)."""
    if backend is None:
        backend = kubeapi_backend(cfg)
    init_fn, run_fn = make_sharded_engine(
        cfg, mesh, chunk, queue_capacity, fp_capacity, fp_index=fp_index,
        route_factor=route_factor, backend=backend, pipeline=pipeline,
        obs_slots=obs_slots, sort_free=sort_free, deferred=deferred)
    carry = init_fn()
    _sync(carry)
    t0 = time.time()
    out = run_fn(carry)
    _sync(out)
    return result_from_shard_carry(
        out, time.time() - t0, iterations=run_fn.steps,
        labels=backend.labels,
        fp_capacity_total=fp_capacity * mesh.n_shards,
        sites=backend.coverage.sites if backend.coverage else None)


def check_sharded_with_checkpoints(
        cfg: ModelConfig, mesh: ShardMesh, chunk: int = 512,
        queue_capacity: int = 1 << 14, fp_capacity: int = 1 << 18,
        route_factor: float = 2.0, ckpt_path: str = None,
        ckpt_every: int = 256, resume: bool = False,
        max_segments: int = None, backend=None, meta_config: dict = None,
        pipeline: bool = False, obs_slots: int = 0, sort_free: bool = None,
        deferred: bool = None) -> CheckResult:
    """Sharded check with a whole-carry checkpoint after every segment of
    `ckpt_every` bodies (jaxtlc/engine/sharded.py:1596); resume=True loads
    `ckpt_path`, whose meta must match this engine."""
    import os

    from .checkpoint import _meta, load_checkpoint, save_checkpoint

    if backend is None:
        backend = kubeapi_backend(cfg)
    sort_free = resolve_sort_free(sort_free, chunk)
    deferred = resolve_deferred(deferred, chunk)
    init_fn, seg_fn = make_sharded_engine(
        cfg, mesh, chunk, queue_capacity, fp_capacity,
        route_factor=route_factor, segment=ckpt_every, backend=backend,
        pipeline=pipeline, obs_slots=obs_slots, sort_free=sort_free,
        deferred=deferred)
    meta = _meta(cfg, meta_config=meta_config, queue_capacity=queue_capacity,
                 fp_capacity=fp_capacity, devices=mesh.n_shards,
                 pipeline=pipeline, obs_slots=obs_slots, sort_free=sort_free,
                 deferred=deferred, symmetry=False, por=False)
    template = init_fn()
    t0 = time.time()
    if resume:
        if ckpt_path is None or not os.path.exists(ckpt_path):
            raise FileNotFoundError(f"no checkpoint at {ckpt_path!r}")
        saved_meta, carry = load_checkpoint(ckpt_path, template)
        for key in ("format", "config", "queue_capacity", "fp_capacity",
                    "devices", "pipeline", "obs_slots", "sort_free",
                    "deferred", "symmetry", "por"):
            saved = saved_meta.get(
                key, False if key in ("pipeline", "sort_free", "deferred",
                                      "symmetry", "por")
                else 0 if key == "obs_slots" else None)
            if saved != meta[key]:
                raise ValueError(f"checkpoint {key} mismatch: "
                                 f"{saved!r} != {meta[key]!r}")
    else:
        carry = template
    segments = 0
    while not carry_done(carry):
        if max_segments is not None and segments >= max_segments:
            break
        carry = seg_fn(carry)
        segments += 1
        if ckpt_path is not None:
            save_checkpoint(ckpt_path, carry, meta)
    return result_from_shard_carry(
        carry, time.time() - t0, iterations=segments, labels=backend.labels,
        fp_capacity_total=fp_capacity * mesh.n_shards)
