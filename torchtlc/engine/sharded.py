"""The sharded BFS engine (port of jaxtlc/engine/sharded.py:119-959,
1035-1321, 1324-1557, 1560-1688): D fingerprint-space shards in one
process.

Each shard owns the states whose fingerprint's ``hi & (D - 1)`` is its
index: its own table, circular frontier queue of unpacked ``[F]`` rows and
partial counters.  Every carry leaf keeps the reference's leading ``[D]``
axis (``ShardCarry``).  One body, all shards in step:

1. **expand** (every source shard): the pending verdicts of the last body
   are folded first in the pipelined mode (kernel K12); then each shard
   pops up to ``chunk`` rows at ``(qhead + r) % qcap``, and one launch of
   the backend's sharded expand - kernel K1's sharded variant for
   KubeAPI, kernel K21 for a struct or generic spec's emitted step -
   expands the pops of all shards (successors packed and as raw fields,
   with ``3 + n_inv`` flag rows), kernel K2 fingerprints them, and kernel K11
   routes them: a stable counting sort by owner and the payload scatter
   into the ``[D owner, D source, B]`` exchange planes;
2. **exchange** (``ShardMesh.exchange``): with the shards in one process
   the all_to_all is a layout - source s wrote its bucket for owner o at
   ``[o, s]``, so owner o's received batch ``[o].reshape(D*B)`` is the
   reference's ``recv.reshape(D*B, F+3)`` row for row;
3. **commit** (every owner): the fp-full test, the insert of the received
   fingerprints (``fpset_insert_dedup``: kernel K3, or the slab path's
   K5/K6/K3, at width ``SRW = min(4*chunk, D*B)``), the deferred
   invariants of the fresh claimants (the backend's received-rows check:
   kernel K7's variant, or K18 on an emitted backend),
   the circular enqueue (kernel K13), the verdict return and fold into the
   source shards' outdegree and per-action distinct counters (kernel K12;
   one body later in the pipelined mode), the violation order (invariants,
   assert, deadlock, slot overflow, then fp-full, queue-full and route
   overflow; a global max), level fencing by sums over the shard axis, the
   counter ring (kernel K8 per shard) and the coverage counters (kernel
   K10 per shard).

Shards read each other's state only through the exchange planes and the
axis-0 reductions, and every shard's expansion finishes before any commit,
so the order the shards run in does not matter.

**Pods.**  ``ShardMesh`` may also span H processes of a
``torch.distributed`` group (torchtlc.dist): process p holds only the S =
D / H shard rows ``[p*S, (p+1)*S)`` of every carry leaf (the reference's
process-major mesh).  K11 routes this process's S sources into [D, S, B]
planes; ``exchange`` is then one ``all_to_all`` of the candidates (kernel
K36 packs the planes into the reference's ``[F+3]``-word lanes, already
grouped by destination process; kernel K37 unpacks the received buffer
into the owner planes [S, D, B], global source order) and one of the
verdicts; and every cross-shard reduction of the body - the global
verdict, the level fence and the bundle - reads all D shards' values
from one ``all_gather`` of each shard's fence columns (packed by kernel
K38).  So each process computes what the in-process engine computes for
its rows, and its tables hold the same words.  A host loop drives the
bodies and reads one small bundle of scalars per body (plus, in the
sort-free mode, each owner's claimant count for the slab fallback).  Every
carry word - tables, queues (the dump row included), counters, ring,
coverage and the pipelined ``pv_*`` leaves - equals the reference's at the
same geometry (tests/test_torch_sharded.py).

The body is its two halves composed (``run_fn.halves``: the expand half,
steps 1-2, and the commit half, step 3); ``ShardedSpillRuntime`` runs
them apart with a host spill-store probe between them (each owner's
received lanes filtered by kernel K9 first) when a table cannot grow.
``sharded_survive_fixpoint`` is the liveness fixpoint of live.fixpoint
over D edge slices (kernel K16).

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
from .fpset import FPSet, fpset_insert_dedup, fpset_member, host_insert

MASK32 = 0xFFFFFFFF
# the spill mode's owner-side membership walk cap (K9), the reference's
# SPILL_MEMBER_ROUNDS: an unresolved lane safely asks the host store
SPILL_MEMBER_ROUNDS = 4


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
    # spill mode (ShardedSpillRuntime): candidates each owner's host veto
    # deduplicated
    spill_hits: torch.Tensor = None  # [D] int64
    # scalars above as of the body that made this carry (None: read them);
    # in a pod, every shard's, not only this process's
    bundle: ShardBundle = None


class ShardMesh(NamedTuple):
    """D logical shards on one device (None: the card) - in one process, or
    split over the `hosts` processes of the torch.distributed `group` (a
    pod, torchtlc.dist.pod_mesh), this one being `rank` and holding the
    shard rows [row0, row0 + rows).  `collectives` names the group's
    backend ("gloo": buffers staged through pinned host memory; "nccl":
    on the card).  `timing` (a dict, or None) accumulates the seconds the
    collectives take under "exchange_s" and "gather_s"."""

    n_shards: int
    device: object = None
    group: object = None
    rank: int = 0
    hosts: int = 1
    collectives: str = None
    timing: dict = None

    @property
    def rows(self) -> int:
        """Shard rows in this process (S)."""
        return self.n_shards // self.hosts

    @property
    def row0(self) -> int:
        return self.rank * self.rows

    def local(self, full):
        """This process's rows of a [D, ...] leaf."""
        return full[self.row0:self.row0 + self.rows]

    def exchange(self, *planes):
        """The candidate all_to_all (rows [D, S, B, F], lo, hi [D, S, B],
        valid [D, S, B] -> the owner planes [S, D, B, .]) and the verdict
        all_to_all (one [S owner, D, B] uint8 plane -> [D, S source, B]).
        In one process it is the identity: K11 writes source s's bucket for
        owner o at [o, s] of each plane, which is where owner o receives
        it."""
        if self.hosts == 1:
            return planes
        t0 = time.time()
        H, S = self.hosts, self.rows
        if len(planes) == 4:
            xrows = planes[0]
            B, F = xrows.shape[2], xrows.shape[3]
            recv = self._all_to_all(pod_pack(*planes).view(H, -1))
            out = pod_unpack(recv.view(H, S, S, B, F + 3))
        else:
            (verd,) = planes
            B = verd.shape[2]
            send = verd.view(S, H, S, B).transpose(0, 1)
            out = (self._all_to_all(send).view(H * S, S, B),)
        self._timed("exchange_s", t0)
        return out

    def gather(self, words: torch.Tensor) -> torch.Tensor:
        """Every process's [S, W] int64 rows -> the [D, W] rows of all
        shards, on the host (one all_gather; the rows themselves in one
        process)."""
        if self.hosts == 1:
            return words.cpu()
        t0 = time.time()
        if self.collectives == "nccl":
            out = torch.empty((self.n_shards,) + tuple(words.shape[1:]),
                              dtype=words.dtype, device=words.device)
            _all_gather(out, words.contiguous(), group=self.group)
            out = out.cpu()
        else:
            src = words.cpu()
            out = torch.empty((self.n_shards,) + tuple(src.shape[1:]),
                              dtype=src.dtype)
            _all_gather(out, src, group=self.group)
        self._timed("gather_s", t0)
        return out

    def any(self, flag: bool) -> bool:
        """True on every process when any process's flag is (one
        all_reduce MAX of one int32 word)."""
        if self.hosts == 1:
            return bool(flag)
        import torch.distributed as dist

        dev = (self.device if self.collectives == "nccl" else "cpu")
        w = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
        dist.all_reduce(w, op=dist.ReduceOp.MAX, group=self.group)
        return bool(int(w.item()))

    def _all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """One all_to_all_single of a [H, ...] buffer (chunk q to process
        q); under gloo a card tensor goes through pinned host buffers."""
        import torch.distributed as dist

        if self.collectives == "nccl" or not send.is_cuda:
            send = send.contiguous()
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=self.group)
            return recv
        hs = _pinned("send", send.shape, send.dtype)
        hs.copy_(send)
        hr = _pinned("recv", send.shape, send.dtype)
        dist.all_to_all_single(hr, hs, group=self.group)
        return hr.to(send.device)

    def _timed(self, key: str, t0: float) -> None:
        if self.timing is not None:
            self.timing[key] = self.timing.get(key, 0.0) + time.time() - t0


_PINNED = {}


def _all_gather(out, src, group):
    """all_gather of equal-sized tensors into one (torch's name for it
    changed across releases)."""
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None)
    (fn or dist.all_gather_into_tensor)(out, src, group=group)


def _pinned(role: str, shape, dtype) -> torch.Tensor:
    """A pinned host buffer of this shape, reused across bodies."""
    key = (role, tuple(shape), dtype)
    if key not in _PINNED:
        _PINNED[key] = torch.empty(tuple(shape), dtype=dtype,
                                   pin_memory=True)
    return _PINNED[key]


class ShardEx(NamedTuple):
    """The expand half's output, what the commit half reads besides K11's
    sorted-order words (the reference's ShardEx,
    jaxtlc/engine/sharded.py:468).  S is the shard rows of this process (D
    in one process)."""

    n: list  # rows popped by each of this process's shards
    npop: torch.Tensor  # [S] int64
    flags: torch.Tensor  # [5, S*ncand] uint8
    action: torch.Tensor  # [S*ncand] int32
    gen: torch.Tensor  # [S, n_labels] int64
    fields: torch.Tensor  # [S*ncand, F] int32
    block: torch.Tensor  # [S*chunk, W] int32 (coverage only) or None
    xrows: torch.Tensor  # [S owner, D source, B, F] received rows
    xlo: torch.Tensor  # [S, D, B] int32
    xhi: torch.Tensor  # [S, D, B] int32
    xvalid: torch.Tensor  # [S, D, B] bool
    # spill mode: each owner's K9 membership of its received lanes
    member: torch.Tensor = None  # [S, D*B] bool
    n_all: list = None  # rows popped by every shard (n in one process)


class RouteOut(NamedTuple):
    """K11's outputs: the sorted-order words of each of the S source shards
    of this process and the exchange planes ([D owner, S source, B, ...];
    S = D in one process)."""

    order: torch.Tensor  # [S, ncand] int32 owner-sort permutation
    s_own: torch.Tensor  # [S, ncand] int32 owner per sorted lane (D: none)
    s_pos: torch.Tensor  # [S, ncand] int32 position in the owner's bucket
    s_valid: torch.Tensor  # [S, ncand] bool
    xrows: torch.Tensor  # [D, S, B, F] int32 candidate fields
    xlo: torch.Tensor  # [D, S, B] int32 fingerprint words
    xhi: torch.Tensor  # [D, S, B] int32
    xvalid: torch.Tensor  # [D, S, B] bool
    route_ovf: torch.Tensor  # [S] bool: a valid lane past its bucket


def route_bucket_width(chunk: int, n_lanes: int, D: int,
                       route_factor: float) -> int:
    """Per-destination bucket slots (jaxtlc/engine/sharded.py:221)."""
    ncand = chunk * n_lanes
    return ncand if D == 1 else min(ncand, int(route_factor * ncand / D) + 8)


def route_out_new(D: int, ncand: int, B: int, F: int, device,
                  S: int = None) -> RouteOut:
    S = D if S is None else S

    def z(*shape, dtype=torch.int32):
        return torch.zeros(*shape, dtype=dtype, device=device)

    return RouteOut(order=z(S, ncand), s_own=z(S, ncand), s_pos=z(S, ncand),
                    s_valid=z(S, ncand, dtype=torch.bool),
                    xrows=z(D, S, B, F), xlo=z(D, S, B), xhi=z(D, S, B),
                    xvalid=z(D, S, B, dtype=torch.bool),
                    route_ovf=z(S, dtype=torch.bool))


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
    that fits into the planes at [owner, source, position] - for the S =
    out.order.shape[0] source shards of this process.  `out` in place
    (xvalid and route_ovf zeroed first; other plane slots keep their
    words)."""
    N = hi.shape[0]
    S = out.order.shape[0]
    ncand = N // S
    F = fields.shape[1]
    out.xvalid.zero_()
    out.route_ovf.zero_()
    dev = hi.device
    ar = torch.arange(ncand, device=dev)
    for s in range(S):
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
    (jaxtlc/engine/sharded.py:485-505, 701-719): source s (of the S =
    verd.shape[1] of this process) reads the verdict of its sorted lane at
    [owner, s, position], scatters it to the lane's original index, and
    adds the per-row new-degree histogram (unpopped rows in bin L + 1) and
    the per-action distinct counts (non-new lanes in column n_labels).
    outdeg, act_dist in place."""
    D, S, B = verd.shape
    ncand = s_own.shape[1]
    dev = verd.device
    for s in range(S):
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


def pod_pack_plain(xrows, xlo, xhi, xvalid) -> torch.Tensor:
    """Torch version of K36: the [D, S, B, F+3] int32 send buffer - each
    lane's F fields, lo, hi and valid (the reference's lane,
    jaxtlc/engine/sharded.py:572-587)."""
    return torch.cat([xrows, xlo[..., None], xhi[..., None],
                      xvalid[..., None].to(torch.int32)], dim=-1)


def pod_pack(xrows, xlo, xhi, xvalid) -> torch.Tensor:
    """K36 on CUDA tensors, the plain version on CPU tensors."""
    if not xrows.is_cuda:
        return pod_pack_plain(xrows, xlo, xhi, xvalid)
    from ..kernels import ops

    return ops.pod_exchange_pack(xrows, xlo, xhi, xvalid)


def pod_unpack_plain(recv: torch.Tensor):
    """Torch version of K37: the received [H, S owner, S source, B, F+3]
    buffer -> the owner planes [S, H*S, B, .] (xrows, xlo, xhi, xvalid),
    global source p*S + s."""
    H, S, _, B, W = recv.shape
    planes = recv.transpose(0, 1).reshape(S, H * S, B, W)
    return (planes[..., :W - 3].contiguous(), planes[..., W - 3].contiguous(),
            planes[..., W - 2].contiguous(), planes[..., W - 1] != 0)


def pod_unpack(recv: torch.Tensor):
    """K37 on CUDA tensors, the plain version on CPU tensors."""
    if not recv.is_cuda:
        return pod_unpack_plain(recv)
    from ..kernels import ops

    return ops.pod_exchange_unpack(recv)


def pod_stats_plain(leaves) -> torch.Tensor:
    """Torch version of K38: leaves of S rows -> [S, W] int64, each leaf's
    row words in order (int32 sign-extended, flags as 0 / 1)."""
    S = leaves[0].shape[0]
    return torch.cat([t.reshape(S, -1).to(torch.int64) for t in leaves], 1)


def pod_stats(leaves) -> torch.Tensor:
    """K38 on CUDA tensors, the plain version on CPU tensors."""
    if not leaves[0].is_cuda:
        return pod_stats_plain(leaves)
    from ..kernels import ops

    return ops.pod_stats_pack([t.contiguous() for t in leaves])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def read_bundle(c: ShardCarry, mesh: ShardMesh = None) -> ShardBundle:
    """The carry's bundle; on a pod `mesh`, every shard's values (one
    gather of the columns K38 packs)."""
    if c.bundle is not None:
        return c.bundle
    flag = (c.obs_pl_flag.to(torch.int64) if c.obs_pl_flag is not None
            else c.qhead * 0)
    cols = [c.qhead, c.qtail, c.level_end, c.viol, c.distinct, c.cont, flag]
    if mesh is not None and mesh.hosts > 1:
        vals = mesh.gather(pod_stats(cols)).t().tolist()
    else:
        vals = torch.stack([t.to(torch.int64) for t in cols]).tolist()
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
    backend with a coverage plane carries ``cov_counts``.  `backend` is any
    SpecBackend whose kernels have the sharded routes (KubeAPI's, a struct
    or a generic spec's); `cfg` is only read when it is None.  On a pod
    `mesh` the carries hold this process's S rows (unpipelined only)."""
    D = mesh.n_shards
    S, r0 = mesh.rows, mesh.row0
    pod = mesh.hosts > 1
    assert D & (D - 1) == 0, "device count must be a power of two"
    assert D <= 8, "the route kernels take at most 8 shards"
    assert S * mesh.hosts == D, "the processes must split the shards evenly"
    assert not (pod and pipeline), "pods run the unpipelined body"
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
    kernels = backend.kernels
    n_inv = len(backend.inv_codes)
    checking = deferred and bool(backend.inv_codes)
    imm_codes = () if deferred else backend.inv_codes
    # flag row 3 + k: invariant k fails (K1's TypeOK, OnlyOneVersion rows)
    imm_flags = tuple(range(3, 3 + n_inv))
    rt = route_out_new(D, ncand, B, F, dev, S=S)
    shards = torch.arange(S, device=dev)

    def owner_of(hi: torch.Tensor) -> torch.Tensor:
        return hi.to(torch.int64) & (D - 1)

    def i64(v):
        return torch.as_tensor(v, dtype=torch.int64, device=dev)

    def init_fn() -> ShardCarry:
        inits = np.asarray(backend.initial_vectors(), np.int32)
        red = backend.reduce
        if red is not None and red.plan is not None:
            # orbit-canonical seeds, the host twin of K24 (jaxtlc/engine/
            # sharded.py:381-386): Init is closed under the permutations
            inits = red.plan.canon_host(inits)
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
        c = ShardCarry(
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
        if pod:  # this process's rows of the whole carry
            c = c._replace(**{f: mesh.local(v).contiguous()
                              for f, v in c._asdict().items()
                              if isinstance(v, torch.Tensor)})
        return c

    def pick(vmask: torch.Tensor, states_of):
        """Per shard: any hit, and the state at the first hit
        (states[argmax(vmask)])."""
        first = vmask.to(torch.uint8).argmax(1)
        return vmask.any(1), states_of(first)

    def expand_half(c: ShardCarry, h: ShardBundle,
                    with_member: bool = False) -> ShardEx:
        """Pop, expand, fingerprint and route every source shard
        (jaxtlc/engine/sharded.py:468); with_member, each owner's K9
        membership walk over its received lanes (the spill mode's filter,
        at most SPILL_MEMBER_ROUNDS rows)."""
        if pipeline:
            verdict_fold(c.pv_send, c.pv_sown, c.pv_pos, c.pv_svalid,
                         c.pv_order, c.pv_faction, c.pv_n, chunk, L,
                         n_labels, c.outdeg_hist, c.act_dist)
        n_all = [min(chunk, min(e, t) - q) if h.viol == OK else 0
                 for q, t, e in zip(h.qhead, h.qtail, h.level_end)]
        n = n_all[r0:r0 + S]
        npop = i64(n)
        packed, flags, action, gen, fields, block = kernels.expand_sharded(
            c.queue, c.qhead, npop, chunk, deferred,
            with_block=backend.coverage is not None)
        lo, hi = fp64_words(packed, cdc.nbits, fp_index)
        route(hi, lo, flags[FLAG_VALID], fields, D, B, rt)
        xrows, xlo, xhi, xvalid = mesh.exchange(rt.xrows, rt.xlo, rt.xhi,
                                                rt.xvalid)
        member = None
        if with_member:
            member = torch.stack([
                fpset_member(FPSet(c.table[o]), xlo[o].view(DB),
                             xhi[o].view(DB), xvalid[o].view(DB),
                             max_rounds=SPILL_MEMBER_ROUNDS)
                for o in range(S)])
        return ShardEx(n=n, npop=npop, flags=flags, action=action, gen=gen,
                       fields=fields, block=block, xrows=xrows,
                       xlo=xlo, xhi=xhi, xvalid=xvalid, member=member,
                       n_all=n_all)

    def commit_half(c: ShardCarry, h: ShardBundle, ex: ShardEx,
                    veto: torch.Tensor = None) -> ShardCarry:
        """Insert, enqueue, fold the verdicts, fence the level
        (jaxtlc/engine/sharded.py:631).  `veto` ([D, D*B] bool, the
        received candidates the host spill store holds) turns on the spill
        mode: a vetoed candidate dedups like a table hit, the fp-full halt
        is off, and spill_hits counts the vetoed valid lanes."""
        n, npop, flags, action = ex.n, ex.npop, ex.flags, ex.action
        gen, fields, block = ex.gen, ex.fields, ex.block
        xrows, xlo, xhi, xvalid = ex.xrows, ex.xlo, ex.xhi, ex.xvalid
        spill = veto is not None

        # ---- commit (every owner) ----
        is_new = torch.zeros(S, DB + 1, dtype=torch.bool, device=dev)
        d_viol = [None] * S
        d_state = [None] * S
        # the spill runtime flushes a table before it could fill
        fp_full = [not spill and h.distinct[r0 + o] + DB > fp_limit
                   for o in range(S)]
        for o in range(S):
            r_valid = xvalid[o].view(DB)
            if spill:
                mask = r_valid & ~veto[o]
            else:
                mask = torch.zeros_like(r_valid) if fp_full[o] else r_valid
            _, is_new_c, c_idx, _, fell = fpset_insert_dedup(
                FPSet(c.table[o]), xlo[o].view(DB), xhi[o].view(DB), mask,
                probe_width=SRW if sort_free else 0, sort_free=sort_free)
            is_new[o, c_idx] = is_new_c  # the slab sentinel lane DB drops
            if checking:
                d_viol[o], d_state[o] = kernels.deferred_rows(
                    xrows[o].view(DB, F), is_new_c, c_idx,
                    SRW if sort_free and not fell else DB)
        is_new = is_new[:, :DB].contiguous()
        cum = torch.cumsum(is_new, 1)
        n_new = cum[:, -1]
        q_full = (c.qtail - c.qhead) + n_new > qcap
        shard_enqueue(c.queue, is_new, cum, c.qtail, q_full,
                      xrows.view(S, DB, F), xvalid.view(S, DB))
        (verd,) = mesh.exchange(is_new.view(S, D, B).to(torch.uint8))
        if not pipeline:
            verdict_fold(verd, rt.s_own, rt.s_pos, rt.s_valid, rt.order,
                         action.view(S, ncand), npop, chunk, L, n_labels,
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
                for d in range(S)])
            cov_counts = cov_counts + (cov.to(torch.int64) & MASK32)

        # ---- violations (local detect, global max) ----
        new_viol = torch.zeros(S, dtype=torch.int64, device=dev)
        new_vstate = c.viol_state
        if checking:
            dv = torch.stack(d_viol)
            hit = dv != OK
            new_viol = torch.where(hit, dv, new_viol)
            new_vstate = torch.where(hit[:, None], torch.stack(d_state),
                                     new_vstate)
        fl = flags.view(3 + n_inv, S, ncand)
        qh = c.qhead

        def lane_rows(first):  # the popped row of a lane
            return c.queue[shards, (qh + first // L) % qcap]

        def row_rows(first):
            return c.queue[shards, (qh + first) % qcap]

        # deadlock: a popped state with no valid successor, when the
        # backend checks it (TLC's -deadlock switch)
        dead = (~fl[FLAG_VALID].view(S, chunk, L).bool().any(2)
                & (torch.arange(chunk, device=dev)[None] < npop[:, None]))
        if not backend.check_deadlock:
            dead = torch.zeros_like(dead)
        fv = fields.view(S, ncand, F)
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
                               & xvalid.view(S, DB).any(1), VIOL_FPSET_FULL,
                               new_viol)
        new_viol = torch.where((new_viol == OK) & q_full, VIOL_QUEUE_FULL,
                               new_viol)
        new_viol = torch.where((new_viol == OK) & rt.route_ovf,
                               VIOL_ROUTE_OVERFLOW, new_viol)
        viol = c.viol
        became = (viol == OK) & (new_viol != OK)
        viol_local = c.viol_local | became
        viol_state = torch.where(became[:, None], new_vstate, c.viol_state)

        # ---- advance + level fencing (global) ----
        adv = viol == OK
        qhead = c.qhead + npop
        qtail = torch.where(q_full, c.qtail, c.qtail + n_new)
        fence = None
        if pod:
            # every shard's fence columns, from one gather (K38 packs them)
            fence = mesh.gather(pod_stats([
                qhead, qtail, c.level_end,
                torch.where(viol == OK, new_viol, viol), distinct])).tolist()
            g_viol = max(r[3] for r in fence)
            g_done = sum(min(r[2], r[1]) - r[0] for r in fence) == 0
            g_more = sum(r[1] - r[0] for r in fence) > 0
            global_viol = torch.full((S,), g_viol, dtype=torch.int64,
                                     device=dev)
            level_done = torch.tensor(g_done, device=dev)
            more = torch.tensor(g_more, device=dev)
        else:
            global_viol = torch.where(viol == OK, new_viol,
                                      viol).max().expand(D)
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
        done_h = (sum(e - q for q, e in zip(h.qhead, h.level_end))
                  == sum(ex.n_all))
        obs = {}
        if obs_slots:
            # acts_old pairs act_dist with itself: the reference's wrap
            # test (jaxtlc/engine/sharded.py:793-799) leaves it out
            if pipeline:
                # the last body's staged flip row, its act_dist completed
                # by the fold at the top of this body
                queue_n = c.qtail - c.qhead
                for d in range(S):
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
                for d in range(S):
                    ring_row(c.obs_ring[d], c.obs_head[d], c.obs_bodies[d],
                             c.obs_expanded[d], n[d], adv_h and done_h,
                             c.level[d], generated[d], c.generated[d],
                             distinct[d], c.distinct[d], queue_n[d],
                             act_gen[d], c.act_dist[d],
                             torch.cat([c.act_gen[d], c.act_dist[d]]),
                             n_labels)
        spill_hits = c.spill_hits
        if spill:
            spill_hits = spill_hits + (veto & xvalid.view(S, DB)).sum(1)
        pv = {}
        if pipeline:
            cont = cont | (sum(n) > 0)
            pv = dict(pv_send=verd, pv_sown=rt.s_own.clone(),
                      pv_pos=rt.s_pos.clone(), pv_svalid=rt.s_valid.clone(),
                      pv_order=rt.order.clone(),
                      pv_faction=action.view(S, ncand), pv_n=npop)
        out = c._replace(
            qhead=qhead, qtail=qtail, level_end=level_end2, level=level2,
            depth=depth2, generated=generated, distinct=distinct,
            act_gen=act_gen, viol=global_viol.clone(),
            viol_state=viol_state, viol_local=viol_local, cont=cont,
            cov_counts=cov_counts, spill_hits=spill_hits, bundle=None, **pv,
            **obs)
        if fence is None:
            return out._replace(bundle=read_bundle(out))
        flip = adv_h and g_done
        return out._replace(bundle=ShardBundle(
            qhead=[r[0] for r in fence], qtail=[r[1] for r in fence],
            level_end=[r[1] if flip else r[2] for r in fence], viol=g_viol,
            distinct=[r[4] for r in fence],
            cont=g_more and g_viol == OK))

    def body(c: ShardCarry, h: ShardBundle) -> ShardCarry:
        return commit_half(c, h, expand_half(c, h))

    def run_fn(c: ShardCarry) -> ShardCarry:
        steps = 0
        h = read_bundle(c, mesh)
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
    run_fn.geometry = dict(D=D, S=S, B=B, ncand=ncand, F=F, L=L, chunk=chunk,
                           SRW=SRW, sort_free=sort_free, deferred=deferred)
    run_fn.halves = (expand_half, commit_half)
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


class ShardedSpillRuntime:
    """Spill-mode execution of the sharded engine (port of
    jaxtlc/engine/sharded.py:1035-1321, the D shards in one process); the
    supervisor swaps its segment function for ``segment_fn`` when the
    ladder turns the host tier on for a sharded run.  Each chunk step runs
    the engine's own halves with a host probe between them::

        expand + route + each owner's K9 filter of its received lanes
          -> one device-to-host read of the probable-new lanes
          -> SpillStore.probe (host) -> commit with the host veto

    One SpillStore holds every shard's spilled fingerprints: the owners'
    fingerprint spaces are disjoint (owner = hi & (D - 1)), so one store is
    exact for all of them - on a pod mesh, one store a process, for its own
    rows (the reference's per-host lifeboat).  Before a step that could
    take some table past the high-water load (each table's occupancy,
    measured; the reference's pmax over the shard axis, on a pod one
    all_reduce so that every process enters the flush on the same step),
    the tables over the mark - and only those - are unmixed into the store
    and start empty; a fingerprint lives in its owner's table or in the
    store, never in both.  A vetoed candidate dedups like an owner-table
    hit, so counters and verdict equal a correctly sized clean sharded
    run's.  ``on_event(kind, info)`` receives the `spill` journal events;
    ``spill_write_hook`` is the fault seam called before every flush;
    ``flushes``, ``probes`` and ``store_s`` describe the host tier's
    work."""

    def __init__(self, cfg, mesh: ShardMesh, chunk: int, queue_capacity: int,
                 fp_capacity: int, fp_index: int = DEFAULT_FP_INDEX,
                 route_factor: float = 2.0, backend=None,
                 fp_highwater: float = None, obs_slots: int = 0,
                 sort_free: bool = None, deferred: bool = None, store=None,
                 on_event=None, spill_write_hook=None):
        from .spill import SpillStore

        if fp_highwater is None:
            fp_highwater = FP_HIGHWATER
        init_fn, run_fn = make_sharded_engine(
            cfg, mesh, chunk, queue_capacity, fp_capacity,
            fp_index=fp_index, route_factor=route_factor, backend=backend,
            fp_highwater=fp_highwater, pipeline=False, obs_slots=obs_slots,
            sort_free=sort_free, deferred=deferred)
        self._base_init = init_fn
        self._expand, self._commit = run_fn.halves
        self.mesh = mesh
        self.D = mesh.n_shards
        self.S = mesh.rows
        self.DB = self.D * run_fn.geometry["B"]
        self.fp_capacity = fp_capacity
        self.fp_highwater = fp_highwater
        self.store = store if store is not None else SpillStore()
        self.on_event = on_event
        self.spill_write_hook = spill_write_hook
        self.flushes = 0
        self.probes = 0  # candidates that paid the host round trip
        self.store_s = 0.0  # seconds in the host store

    def init_fn(self) -> ShardCarry:
        """A fresh spill-mode carry (also the checkpoint template)."""
        return self.adopt(self._base_init())

    def adopt(self, carry: ShardCarry) -> ShardCarry:
        """Enter spill mode: add the spill_hits leaf (idempotent).  The
        saturated tables stay; the first step's residency test flushes
        them."""
        assert carry.pv_n is None, \
            "spill mode runs unpipelined sharded carries only"
        if carry.spill_hits is None:
            carry = carry._replace(spill_hits=torch.zeros(
                self.S, dtype=torch.int64, device=carry.queue.device))
        return carry

    def _emit(self, kind: str, **info) -> None:
        if self.on_event is not None:
            self.on_event(kind, info)

    @staticmethod
    def _occupancy(carry: ShardCarry) -> list:
        """Occupied slots of each shard's table (a slot is a (lo, hi) word
        pair, empty when both are 0)."""
        D = carry.table.shape[0]
        return (carry.table.view(D, -1, 2) != 0).any(2).sum(1).tolist()

    def _flush(self, carry: ShardCarry, needy) -> ShardCarry:
        """Move the tables of this process's shards in `needy` (local row
        indices) into the store and start them empty; SpillWriteError when
        the write seam fails."""
        from .fpset import unmix_host
        from .spill import SpillWriteError

        try:
            if self.spill_write_hook is not None:
                self.spill_write_hook()
        except OSError as e:
            raise SpillWriteError(str(e)) from e
        t0 = time.time()
        table = carry.table.clone()
        resident = 0
        for d in range(self.S):
            t = table[d].cpu().numpy().view(np.uint32)
            lo = t[:, 0::2].reshape(-1)
            hi = t[:, 1::2].reshape(-1)
            occ = (lo != 0) | (hi != 0)
            if d not in needy:
                # an under-water table keeps its fingerprints resident
                resident += int(occ.sum())
                continue
            self.store.insert_batch(*unmix_host(lo[occ], hi[occ]))
            table[d].zero_()
        self.flushes += 1
        wall = time.time() - t0
        self.store_s += wall
        carry = carry._replace(table=table)
        self._emit("spill", phase="flush", resident=resident,
                   spilled=self.store.count, capacity=self.store.capacity,
                   hits=int(carry.spill_hits.sum()), probes=self.probes,
                   flushed_tables=len(needy), wall_s=round(wall, 6))
        return carry

    def step(self, carry: ShardCarry, h: ShardBundle) -> ShardCarry:
        """One chunk step (the caller has flushed where needed)."""
        ex = self._expand(carry, h, with_member=True)
        probable = ex.xvalid.view(self.S, self.DB) & ~ex.member
        veto = torch.zeros_like(probable)
        lanes = torch.nonzero(probable.view(-1)).flatten()
        if lanes.numel():
            # the one device-to-host read of the probable-new lanes
            words = torch.stack([ex.xlo.view(-1)[lanes],
                                 ex.xhi.view(-1)[lanes]]).cpu().numpy()
            words = words.view(np.uint32)
            self.probes += lanes.numel()
            t0 = time.time()
            held = self.store.probe(words[0], words[1])
            self.store_s += time.time() - t0
            if held.any():
                veto.view(-1)[lanes[torch.from_numpy(held).to(
                    lanes.device)]] = True
        return self._commit(carry, h, ex, veto)

    def segment_fn(self, ckpt_every: int):
        """seg(carry) -> the carry after up to `ckpt_every` chunk steps,
        stopping early at the end of the run or at a violation.  The pop
        sequence is the fused sharded body's, step for step."""
        highwater_slots = int(self.fp_capacity * self.fp_highwater)

        def seg(carry: ShardCarry) -> ShardCarry:
            for _ in range(ckpt_every):
                h = read_bundle(carry, self.mesh)
                if not h.cont:
                    break
                # measured, not derived from the distinct counters: a
                # rolled-back carry whose failed attempt flushed stays exact
                needy = {d for d, occ in enumerate(self._occupancy(carry))
                         if occ + self.DB > highwater_slots}
                if self.mesh.any(bool(needy)):
                    carry = self._flush(carry, needy)
                carry = self.step(carry, h)
                if carry.bundle.viol != OK:
                    break
            return carry

        return seg


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
        labels=backend.labels, viol_names=backend.viol_names,
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
    from .reduce import reduce_flags

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
                 deferred=deferred, **dict(zip(("symmetry", "por"),
                                               reduce_flags(backend))))
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
        viol_names=backend.viol_names,
        fp_capacity_total=fp_capacity * mesh.n_shards)


# ---------------------------------------------------------------------------
# the liveness fixpoint over the shard axis
# ---------------------------------------------------------------------------


def sharded_survive_fixpoint(mesh: ShardMesh, n_states: int, src: np.ndarray,
                             dst: np.ndarray, in_h: np.ndarray,
                             terminal: np.ndarray):
    """The survive-set fixpoint of live.fixpoint with the edge relation
    cut into D equal slices, one a shard (jaxtlc/engine/sharded.py:1490):
    each sweep of kernel K16 marks every slice's support partial and sums
    the partials over the shard axis where the reference uses a psum; the
    alive plane is replicated.  Padding edges carry src = V and are
    dropped.  Caller contract: (src, dst) are the state-changing edges
    internal to H.  Returns (alive bool [V], sweeps)."""
    from ..live.fixpoint import survive_fixpoint

    D = mesh.n_shards
    V = int(n_states)
    E = len(src)
    Ep = max(-(-max(E, 1) // D) * D, D)
    src_p = np.full(Ep, V, np.int32)
    dst_p = np.zeros(Ep, np.int32)
    src_p[:E] = src
    dst_p[:E] = dst
    return survive_fixpoint(src_p, dst_p, in_h, terminal, D=D,
                            device=mesh.device)
