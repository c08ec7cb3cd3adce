"""Device-resident fingerprint set, sorted and sort-free paths (port of
jaxtlc/engine/fpset.py:87-870).

The table is ``[cap/8, 16]`` int32 (32-bit words as bit patterns): one
64-byte row per 8-slot bucket, slots interleaved ``lo0,hi0,...,lo7,hi7``,
(0, 0) = empty.  Stored words are the avalanche-MIXED fingerprint
(``_mix``), remapped so no real entry is (0, 0); the home bucket is the top
bits of the mixed ``hi``; a bucket's occupied slots are a prefix, and a
fingerprint lives in bucket ``b + j`` only if buckets ``b .. b+j-1`` are
full.  Insert sequences leave the table words equal to the reference's.

An insert (``fpset_insert_sorted``):

1. ``fpset_key``: mix + remap + mask, into one int64 sort key per lane,
   ``((hi ^ 0x80000000) << 32) | lo`` read as signed - so the signed
   ``torch.sort`` orders by unsigned (hi, lo), and the reserved invalid
   pair (0, 0) sorts first.
2. One stable sort of the keys groups duplicates; the representative of a
   class is its LAST (highest-lane) member.  A stable partition moves the
   representatives, still fingerprint-sorted, to the front.
3. Probe segments of width R (``probe_segment``): round 0 gathers each
   candidate's home bucket row, tests for a hit, and claims slot
   ``occupancy + rank-in-run`` for the first C fitting claimants;
   stragglers walk buckets linearly in slices of ``S = min(R, 2048)``
   taken in position order, each walk round ranking same-bucket wanters
   by ascending (lo, hi).  Every write targets a distinct slot.

The sort-free insert (``fpset_insert_slab``, the reference's mode at
chunk >= 2048) replaces the two full-width sorts with a hash slab:

1. ``_slab_dedup_core``: a scatter-max of lane + 1 into a slab of
   ``slab_factor * N`` cells (power of two) keeps each fingerprint class's
   highest lane; a class whose cell another fingerprint won stays
   unresolved, and every lane of it rides along.  The claimants (winners
   and unresolved lanes) are compacted in lane order to R rows;
2. ``_order_and_dedup``: one stable R-wide sort of the claimant keys;
   the last row of each fingerprint group is the representative, the
   stable sort's own rule;
3. one probe segment over the ordered keys with that (non-prefix) active
   mask.  When the claimants exceed R the batch takes the sorted path
   wholesale, as the reference does.

The membership walk (``fpset_member``, the host spill tier's device
filter) reads the table only: per lane, mix + remap, then bucket rows
``b, b+1, ...`` until a word-exact match or a row with an empty slot.

On a CUDA tensor the key step and each probe segment run kernel K3
(torchtlc/kernels/csrc/fpset.cu: fpset_key, fpset_probe, fpset_claim,
fpset_walk), the slab steps K5 and K6 (slab.cu), the membership walk K9
(fpset.cu: fpset_member); on a CPU tensor, the plain versions below.
The host helpers (``mix_host_np``, ``unmix_host``, ``host_insert``) are
numpy copies of the reference's.  The sorts and the prefix sums are library calls
(``torch.sort``, ``torch.cumsum``) in both.  The table is updated IN
PLACE.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..spec.codec import to_i32, to_u64

BUCKET = 8
WALK_SLICE = 2048  # S: stragglers settled per walk slice
KEY00 = -(1 << 63)  # sort key of the reserved (0, 0) pair
MASK32 = 0xFFFFFFFF
_MIX_CONSTS = (0x9E3779B9, 0x517CC1B7, 0x27220A95)


class CapacityError(RuntimeError):
    """A fingerprint table (or another bounded resource) ran out of room,
    with its occupancy and capacity."""

    def __init__(self, occupancy: int, capacity: int,
                 resource: str = "fpset"):
        self.occupancy = int(occupancy)
        self.capacity = int(capacity)
        self.resource = resource
        super().__init__(
            f"{resource} full: {self.occupancy}/{self.capacity} slots "
            f"occupied (raise the {resource} capacity or enable auto-grow)")


class FPSet(NamedTuple):
    # [cap / BUCKET, 2 * BUCKET] int32 bucket rows, slots interleaved
    table: torch.Tensor


def fpset_new(cap: int, device=None) -> FPSet:
    """An empty table of `cap` slots on `device` (None: the card)."""
    from .bfs import resolve_device

    assert cap & (cap - 1) == 0, "capacity must be a power of two"
    assert cap >= BUCKET, f"capacity must be at least {BUCKET}"
    return FPSet(torch.zeros(cap // BUCKET, 2 * BUCKET, dtype=torch.int32,
                             device=resolve_device(device)))


def fpset_count(s: FPSet) -> torch.Tensor:
    """Occupied-slot count."""
    t = s.table.view(-1, 2)
    return ((t[:, 0] != 0) | (t[:, 1] != 0)).sum()


# ---------------------------------------------------------------------------
# mixing (int64 holding uint32 words)
# ---------------------------------------------------------------------------


def _fmix32(h):
    """murmur3 finalizer: a bijection on uint32."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def _mix(lo, hi):
    """3-round Feistel avalanche of the 64-bit fingerprint (bijective)."""
    for c in _MIX_CONSTS:
        lo, hi = hi, lo ^ _fmix32((hi + c) & MASK32)
    return lo, hi


def _unmix(lo, hi):
    """Inverse of _mix: recovers the raw fingerprint of a stored entry."""
    for c in reversed(_MIX_CONSTS):
        lo, hi = hi ^ _fmix32((lo + c) & MASK32), lo
    return lo, hi


def _remap(lo, hi):
    """Reserve (0, 0) as the empty marker: a real (0, 0) becomes (1, 0)."""
    return torch.where((lo == 0) & (hi == 0), 1, lo), hi


def _bucket_of(hi, nbuckets: int):
    """Home bucket = top log2(nbuckets) bits of the mixed hi."""
    lognb = nbuckets.bit_length() - 1
    if lognb == 0:
        return torch.zeros_like(hi)
    return hi >> (32 - lognb)


# ---------------------------------------------------------------------------
# host helpers (numpy and Python ints; jaxtlc/engine/fpset.py:191-290)
# ---------------------------------------------------------------------------


def _fmix32_host(h: int) -> int:
    m = 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    h ^= h >> 16
    return h


def mix_host(lo: int, hi: int) -> Tuple[int, int]:
    """Host replica of _mix on Python ints."""
    for c in _MIX_CONSTS:
        lo, hi = hi, lo ^ _fmix32_host((hi + c) & 0xFFFFFFFF)
    return lo, hi


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h ^= h >> np.uint32(13)
    h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h ^= h >> np.uint32(16)
    return h


def unmix_host(lo: np.ndarray, hi: np.ndarray):
    """Vectorized inverse of _mix over uint32 arrays: the raw fingerprints
    of stored table words (regrow's migration and the spill flush)."""
    lo = np.asarray(lo, np.uint32).copy()
    hi = np.asarray(hi, np.uint32).copy()
    with np.errstate(over="ignore"):
        for c in reversed(_MIX_CONSTS):
            lo, hi = (
                hi ^ _fmix32_np((lo + np.uint32(c)).astype(np.uint32)),
                lo,
            )
    return lo, hi


def mix_host_np(lo: np.ndarray, hi: np.ndarray):
    """Vectorized _mix over uint32 arrays (inverse of unmix_host); the
    host spill store keys on these MIXED words."""
    lo = np.asarray(lo, np.uint32).copy()
    hi = np.asarray(hi, np.uint32).copy()
    with np.errstate(over="ignore"):
        for c in _MIX_CONSTS:
            lo, hi = (
                hi.copy(),
                lo ^ _fmix32_np((hi + np.uint32(c)).astype(np.uint32)),
            )
    return lo, hi


def bucket_of_host(hi: int, nbuckets: int) -> int:
    lognb = nbuckets.bit_length() - 1
    return (hi >> (32 - lognb)) if lognb else 0


def host_insert(table: np.ndarray, lo: int, hi: int) -> bool:
    """Insert-or-find one raw fingerprint in a host numpy table whose
    memory order is slot-major (lo, hi) pairs (the device's [cap/8, 16]
    rows or a flat [cap, 2]), walking the device's slot sequence linearly
    from the home bucket's first slot.  Returns is_new."""
    table = table.reshape(-1, 2)  # a view: writes reach the caller
    cap = table.shape[0]
    lo, hi = mix_host(lo, hi)
    if lo == 0 and hi == 0:
        lo = 1
    base = bucket_of_host(hi, cap // BUCKET) * BUCKET
    for k in range(cap):
        slot = (base + k) % cap
        r0, r1 = int(table[slot, 0]), int(table[slot, 1])
        if r0 == lo and r1 == hi:
            return False
        if r0 == 0 and r1 == 0:
            table[slot, 0] = lo
            table[slot, 1] = hi
            return True
    raise CapacityError(cap, cap)


def key_of(lo, hi):
    """Unsigned word pair (int64) -> signed int64 sort key."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def key_words(key):
    """Inverse of key_of: (lo, hi) as int64 unsigned words."""
    return key & MASK32, (key >> 32) + (1 << 31)


def fpset_key_plain(lo: torch.Tensor, hi: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """(lo, hi) int32 fingerprints + bool mask -> int64 sort keys of the
    mixed, remapped words; masked-off lanes get KEY00."""
    mlo, mhi = _remap(*_mix(to_u64(lo), to_u64(hi)))
    return torch.where(mask, key_of(mlo, mhi), KEY00)


def fpset_key(lo, hi, mask):
    if not lo.is_cuda:
        return fpset_key_plain(lo, hi, mask)
    from ..kernels import ops

    return ops.fpset_key(lo, hi, mask)


# ---------------------------------------------------------------------------
# probe segment: round 0 + straggler walk (plain version of K3)
# ---------------------------------------------------------------------------


def _slot_write(table, slot, lo, hi):
    flat = table.view(-1, 2)
    flat[slot, 0] = to_i32(lo)
    flat[slot, 1] = to_i32(hi)


def _row_probe(table, b, lo, hi):
    """(found, occupancy) of (lo, hi) against bucket rows b."""
    rows = to_u64(table[b])
    rlo, rhi = rows[:, 0::2], rows[:, 1::2]
    f = ((rlo == lo[:, None]) & (rhi == hi[:, None])).any(1)
    occ = ((rlo != 0) | (rhi != 0)).sum(1)
    return f, occ


def fpset_round0_plain(table: torch.Tensor, keys: torch.Tensor,
                       active: torch.Tensor) -> torch.Tensor:
    """Round 0 of the reference's _probe_block over a block of keys sorted
    ascending and duplicate-free, against the table before any claim:
    slot codes [R] int32 - -1 nothing to claim (inactive, or stored in the
    home bucket), -2 a wanter that does not fit its home bucket, else the
    slot id claimed (home bucket * 8 + occupancy + rank among the run's
    wanters)."""
    nb = table.shape[0]
    lo, hi = key_words(keys)
    bid = _bucket_of(hi, nb)
    found, noccup = _row_probe(table, bid, lo, hi)
    want = active & ~found
    wi = want.to(torch.int64)
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device),
                       bid[1:] != bid[:-1]])
    wc = torch.cumsum(wi, 0)
    base = torch.cummax(torch.where(start, wc - wi, 0), 0).values
    slot = noccup + wc - wi - base
    code = torch.where(slot < BUCKET, bid * BUCKET + slot, -2)
    return torch.where(want, code, -1).to(torch.int32)


def fpset_claim_plain(table: torch.Tensor, keys: torch.Tensor,
                      slot: torch.Tensor, C: int):
    """Write the first C round-0 claims: (is_new, pending) [R] uint8."""
    fits = slot >= 0
    claimed = fits & (torch.cumsum(fits.to(torch.int64), 0) - 1 < C)
    lo, hi = key_words(keys)
    _slot_write(table, slot.to(torch.int64)[claimed], lo[claimed],
                hi[claimed])
    pending = (slot == -2) | (fits & ~claimed)
    return claimed.to(torch.uint8), pending.to(torch.uint8)


def fpset_walk_plain(table: torch.Tensor, keys: torch.Tensor,
                     pending: torch.Tensor, is_new: torch.Tensor) -> None:
    """The straggler walk (the reference's dense [S, S] rank form):
    settle the pending lanes in slices of S = min(R, 2048) in position
    order; each round every pending lane reads its current bucket, the
    wanters of one bucket claim occupancy + rank by ascending (lo, hi),
    the rest advance one bucket.  Updates table, pending and is_new
    ([R] uint8) in place."""
    nb = table.shape[0]
    R = keys.shape[0]
    lo, hi = key_words(keys)
    bid = _bucket_of(hi, nb)
    while bool(pending.any()):
        pos = torch.nonzero(pending).flatten()[:min(R, WALK_SLICE)]
        s_lo, s_hi, cur = lo[pos], hi[pos], bid[pos]
        pend = torch.ones(pos.shape[0], dtype=torch.bool, device=keys.device)
        new = torch.zeros_like(pend)
        less = (s_lo[None, :] < s_lo[:, None]) | (
            (s_lo[None, :] == s_lo[:, None]) & (s_hi[None, :] < s_hi[:, None]))
        while bool(pend.any()):
            f, occ = _row_probe(table, cur, s_lo, s_hi)
            f = pend & f
            wnt = pend & ~f
            same = wnt[:, None] & wnt[None, :] & (cur[:, None] == cur[None, :])
            sl = occ + (same & less).sum(1)
            ok = wnt & (sl < BUCKET)
            _slot_write(table, (cur * BUCKET + sl)[ok], s_lo[ok], s_hi[ok])
            new |= ok
            pend = pend & ~(f | ok)
            cur = torch.where(wnt & ~ok & pend, (cur + 1) % nb, cur)
        is_new[pos] = new.to(torch.uint8)
        pending[pos] = 0


def probe_segment_plain(table: torch.Tensor, keys: torch.Tensor,
                        active: torch.Tensor, C: int) -> torch.Tensor:
    """Insert-or-find the `active` entries of a sorted, duplicate-free key
    block (the reference's _probe_block).  Updates `table` in place;
    returns is_new [R] bool."""
    slot = fpset_round0_plain(table, keys, active)
    is_new, pending = fpset_claim_plain(table, keys, slot, C)
    fpset_walk_plain(table, keys, pending, is_new)
    return is_new.bool()


def probe_segment(table, keys, nreps, off: int, C: int, is_new_out,
                  npend=None, active=None):
    """Probe one R-wide segment of ascending keys; writes is_new_out [R]
    (uint8) and updates the table in place.  The active entries are
    `active` ([R] uint8, the slab layout: duplicate rows interspersed)
    when given, else the prefix ``off + i < nreps`` of the compacted keys.
    CUDA: kernel K3, reading nreps on the device (an inactive segment is a
    no-op); CPU: the plain version."""
    if not keys.is_cuda:
        R = keys.shape[0]
        act = (active.bool() if active is not None
               else torch.arange(R) + off < int(nreps))
        is_new_out.copy_(probe_segment_plain(table, keys, act, C))
        return
    from ..kernels import ops

    ops.fpset_probe_segment(table, keys, nreps, off, C, is_new_out, npend,
                            active)


# ---------------------------------------------------------------------------
# membership walk (plain version of K9)
# ---------------------------------------------------------------------------


def fpset_member_plain(table: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, mask: torch.Tensor,
                       max_rounds: int = 0, count_rows: bool = False):
    """The reference's fpset_member (jaxtlc/engine/fpset.py:292), [N] bool:
    True where the masked raw fingerprint (lo, hi int32) is stored.  Each
    round every pending lane reads its current bucket row: a word-exact
    match is found, a row with an empty slot ends the walk, a full row
    sends the lane on to the next bucket.  max_rounds > 0 caps the rounds
    (unresolved lanes report False); 0 walks until every lane resolved,
    at most nb rounds.  count_rows=True also returns the bucket rows read
    (the byte bound of K9 counts them).  The table is only read."""
    nb = table.shape[0]
    mlo, mhi = _remap(*_mix(to_u64(lo), to_u64(hi)))
    cur = _bucket_of(mhi, nb)
    pend = mask.clone()
    found = torch.zeros_like(mask)
    limit = max_rounds if max_rounds > 0 else nb
    rows_read = 0
    for _ in range(limit):
        if not bool(pend.any()):
            break
        rows_read += int(pend.sum())
        f, occ = _row_probe(table, torch.where(pend, cur, 0), mlo, mhi)
        hit = pend & f
        found |= hit
        pend = pend & ~hit & (occ == BUCKET)
        cur = torch.where(pend, (cur + 1) % nb, cur)
    return (found, rows_read) if count_rows else found


def fpset_member(s: FPSet, lo, hi, mask, max_rounds: int = 0) -> torch.Tensor:
    """Membership-only probe, [N] bool: kernel K9 on a CUDA tensor, the
    plain version on a CPU tensor.  A stored fingerprint may report False
    when max_rounds cuts its walk (the spill filter then asks the host
    store); an absent one never reports True."""
    if not lo.is_cuda:
        return fpset_member_plain(s.table, lo, hi, mask, max_rounds)
    from ..kernels import ops

    return ops.fpset_member(s.table, lo, hi, mask, max_rounds)


# ---------------------------------------------------------------------------
# sorted dedup + segmented probe
# ---------------------------------------------------------------------------


def dedup_compact(key: torch.Tensor):
    """Stable sort + representative compaction: (c_key [n], c_idx [n]
    int64, nreps 0-dim int64).  Entries j < nreps are the distinct valid
    keys, ascending, each from its highest lane; the rest keep the stable
    sort order."""
    s_key, s_idx = torch.sort(key, stable=True)
    last = torch.cat([s_key[1:] != s_key[:-1],
                      torch.ones(1, dtype=torch.bool, device=key.device)])
    rep = (s_key != KEY00) & last
    ri = rep.to(torch.int64)
    cr = torch.cumsum(ri, 0)
    nreps = cr[-1]
    pos = torch.where(rep, cr - 1, nreps + torch.cumsum(1 - ri, 0) - 1)
    c_key = torch.empty_like(s_key)
    c_idx = torch.empty_like(s_idx)
    c_key[pos] = s_key
    c_idx[pos] = s_idx
    return c_key, c_idx, nreps


def _sorted_dedup_probe(table: torch.Tensor, key: torch.Tensor, R: int,
                        C: int):
    """The sorted dedup + probe over fpset_key's keys (the reference's
    _sorted_dedup_probe, jaxtlc/engine/fpset.py:546, below its mixing
    prologue, so the slab path falls back to the same computation):
    (is_new_c [n] bool, c_idx [n] int64, nreps 0-dim int64)."""
    n = key.shape[0]
    dev = key.device
    c_key, c_idx, nreps = dedup_compact(key)
    nseg = (n + R - 1) // R
    pad = nseg * R - n
    if pad:
        c_key = torch.cat([c_key, torch.full((pad,), KEY00, dtype=torch.int64,
                                             device=dev)])
    is_new = torch.zeros(nseg * R, dtype=torch.uint8, device=dev)
    npend = (torch.zeros(nseg, dtype=torch.int32, device=dev)
             if key.is_cuda else None)
    for seg in range(nseg):
        if not key.is_cuda and seg * R >= int(nreps):
            break
        probe_segment(table, c_key[seg * R:(seg + 1) * R], nreps, seg * R,
                      C, is_new[seg * R:(seg + 1) * R],
                      None if npend is None else npend[seg:seg + 1])
    return is_new[:n].bool(), c_idx, nreps


def fpset_insert_sorted(
    s: FPSet, lo, hi, mask, probe_width: int = 0, claim_width: int = 0
) -> Tuple[FPSet, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Insert-or-find a batch; results in compacted order.

    lo/hi: [N] int32 fingerprints; mask: [N] bool.  Returns (set,
    is_new_c [N] bool, c_idx [N] int64, nreps 0-dim int64): entry j <
    nreps of the compacted order represents a distinct masked fingerprint,
    originally at lane c_idx[j]; is_new_c[j] says whether it was new.
    probe_width bounds the probe segment (0 = whole batch); claim_width
    the round-0 claims (0 = probe_width)."""
    n = lo.shape[0]
    R = min(probe_width or n, n)
    C = min(claim_width or R, R)
    is_new_c, c_idx, nreps = _sorted_dedup_probe(
        s.table, fpset_key(lo, hi, mask), R, C)
    return s, is_new_c, c_idx, nreps


# ---------------------------------------------------------------------------
# sort-free path: hash-slab dedup (K5) + ordering (K6) + masked probe (K3)
# ---------------------------------------------------------------------------

# per-pass slab hash constants (the reference's _SLAB_CONSTS)
_SLAB_CONSTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
SLAB_KEY_PAD = (1 << 63) - 1  # ordering key of padding rows: sorts last


def slab_log2_cells(n: int, slab_factor: int = 4, bits: int = 0) -> int:
    """log2 of the slab's cell count: `bits` when given, else the
    power of two at or above slab_factor * n (at least 8 cells)."""
    return bits or max((slab_factor * n - 1).bit_length(), 3)


def _slab_cell(keys, p: int, mmask: int):
    lo, hi = key_words(keys)
    c = _SLAB_CONSTS[p % len(_SLAB_CONSTS)]
    return (_fmix32((lo + c) & MASK32) ^ hi) & mmask


def slab_scatter_plain(keys, p: int, mmask: int, unres, slab) -> None:
    """Pass p's scatter-max of lane + 1 into the slab cells of the
    unresolved lanes (pass 0 first marks every valid lane unresolved).
    unres [N] uint8 and slab [m] int32 in place."""
    if p == 0:
        unres.copy_((keys != KEY00).to(torch.uint8))
    u = unres.bool()
    lane1 = torch.arange(1, keys.shape[0] + 1, device=keys.device)
    slab.scatter_reduce_(0, _slab_cell(keys, p, mmask)[u],
                         lane1[u].to(torch.int32), reduce="amax")


def slab_resolve_plain(keys, p: int, mmask: int, slab, unres, rep,
                       cand=None) -> None:
    """Pass p's resolve: an unresolved lane whose cell winner holds its
    fingerprint is resolved, and the winner is its class's representative.
    unres, rep (and, on the last pass, cand = rep | unres) [N] uint8 in
    place."""
    n = keys.shape[0]
    lane = torch.arange(n, device=keys.device)
    r = (torch.zeros(n, dtype=torch.bool, device=keys.device) if p == 0
         else rep.bool())
    u = unres.bool()
    wl = torch.clamp(slab[_slab_cell(keys, p, mmask)].to(torch.int64) - 1,
                     0, n - 1)
    same = u & (keys[wl] == keys)
    r = r | (same & (wl == lane))
    u = u & ~same
    unres.copy_(u.to(torch.uint8))
    rep.copy_(r.to(torch.uint8))
    if cand is not None:
        cand.copy_((r | u).to(torch.uint8))


def slab_compact_plain(cand, pos, R: int, c_lane) -> None:
    """Claimant lanes into their prefix positions below R (pos: the
    inclusive prefix sum of cand).  c_lane [R] int32 in place; rows at or
    past n_cand are left as they were."""
    sel = cand.bool() & (pos - 1 < R)
    lane = torch.arange(cand.shape[0], device=cand.device)
    c_lane[(pos - 1)[sel]] = lane[sel].to(torch.int32)


def slab_order_plain(keys, c_lane, R: int, n_cand) -> torch.Tensor:
    """The R-wide ordering keys: claimant row -> its key, padding rows
    (at or past n_cand) -> SLAB_KEY_PAD."""
    i = torch.arange(R, device=keys.device)
    filled = i < n_cand
    lane = torch.where(filled, c_lane.to(torch.int64), 0)
    return torch.where(filled, keys[lane], SLAB_KEY_PAD)


def slab_mark_plain(s_key, perm, c_lane, n_cand, n: int):
    """The ordered claimant slice's lanes (c_idx [R] int64, sentinel n on
    padding) and its last-of-group rows (active [R] uint8): the class
    representatives, since unresolved duplicates sort adjacent and
    lane-ascending."""
    R = s_key.shape[0]
    i = torch.arange(R, device=s_key.device)
    filled = perm < n_cand
    lane = c_lane.to(torch.int64)[torch.where(filled, perm, 0)]
    c_idx = torch.where(filled, lane, n)
    nxt = torch.cat([s_key[1:] != s_key[:-1],
                     torch.ones(1, dtype=torch.bool, device=s_key.device)])
    active = (i < n_cand) & ((i + 1 == n_cand) | nxt)
    return c_idx, active.to(torch.uint8)


def _slab_dedup_core(key: torch.Tensor, R: int, slab_factor: int,
                     slab_passes: int, bits: int):
    """The slab passes + claimant compaction (jaxtlc/engine/fpset.py:659)
    over fpset_key's keys: (c_lane [R] int32, n_cand 0-dim int64).  The
    claimants (every class winner, and every lane of a class whose cell a
    different fingerprint won) sit in lane order in the first
    min(n_cand, R) rows.  CUDA: K5 (slab_scatter, slab_resolve,
    slab_compact) around a torch.cumsum; CPU: the plain versions."""
    n = key.shape[0]
    dev = key.device
    m = 1 << slab_log2_cells(n, slab_factor, bits)
    unres = torch.empty(n, dtype=torch.uint8, device=dev)
    rep = torch.empty(n, dtype=torch.uint8, device=dev)
    cand = torch.empty(n, dtype=torch.uint8, device=dev)
    passes = max(slab_passes, 1)
    if key.is_cuda:
        from ..kernels import ops
    for p in range(passes):
        slab = torch.zeros(m, dtype=torch.int32, device=dev)
        last = cand if p == passes - 1 else None
        if key.is_cuda:
            ops.slab_scatter(key, p, m - 1, unres, slab)
            ops.slab_resolve(key, p, m - 1, slab, unres, rep, last)
        else:
            slab_scatter_plain(key, p, m - 1, unres, slab)
            slab_resolve_plain(key, p, m - 1, slab, unres, rep, last)
    pos = torch.cumsum(cand, 0)
    c_lane = torch.empty(R, dtype=torch.int32, device=dev)
    if key.is_cuda:
        ops.slab_compact(cand, pos, R, c_lane)
    else:
        slab_compact_plain(cand, pos, R, c_lane)
    return c_lane, pos[-1]


def _order_and_dedup(key: torch.Tensor, c_lane, n_cand, R: int):
    """Order the claimant slice ascending by fingerprint and finish the
    dedup (jaxtlc/engine/fpset.py:726): (s_key [R] int64 ordered keys,
    c_idx [R] int64 lanes with sentinel N on padding, active [R] uint8
    marking the representatives - not a prefix: duplicate rows of
    slab-collision classes sit interspersed).  CUDA: K6 (slab_order,
    slab_mark) around a stable torch.sort; CPU: the plain versions."""
    n = key.shape[0]
    if key.is_cuda:
        from ..kernels import ops

        s_key, perm = torch.sort(ops.slab_order(key, c_lane, n_cand),
                                 stable=True)
        c_idx, active = ops.slab_mark(s_key, perm, c_lane, n_cand, n)
    else:
        s_key, perm = torch.sort(slab_order_plain(key, c_lane, R, n_cand),
                                 stable=True)
        c_idx, active = slab_mark_plain(s_key, perm, c_lane, n_cand, n)
    return s_key, c_idx, active


def slab_dedup(lo, hi, mask, probe_width: int = 0, slab_factor: int = 4,
               slab_passes: int = 1, slab_bits: int = 0):
    """In-batch hash-slab dedup (jaxtlc/engine/fpset.py:757): (c_key [R]
    ordered claimant keys - fpset_key's keys, the reference's mixed
    (lo, hi) words as one int64 -, c_idx [R] int64 lanes (sentinel N on
    padding), active [R] bool representative rows, fallback: whether the
    claimants exceeded R, read on the host)."""
    n = lo.shape[0]
    R = min(probe_width or n, n)
    key = fpset_key(lo, hi, mask)
    c_lane, n_cand = _slab_dedup_core(key, R, slab_factor, slab_passes,
                                      slab_bits)
    s_key, c_idx, active = _order_and_dedup(key, c_lane, n_cand, R)
    return s_key, c_idx, active.bool(), int(n_cand) > R


def claimant_count(n_cand: torch.Tensor) -> int:
    """The host read of the claimant count that decides the fallback
    (torchtlc.profile times it)."""
    return int(n_cand)


def fpset_insert_slab(
    s: FPSet, lo, hi, mask, probe_width: int = 0, claim_width: int = 0,
    slab_factor: int = 4, slab_passes: int = 1, slab_bits: int = 0,
) -> Tuple[FPSet, torch.Tensor, torch.Tensor, torch.Tensor, bool]:
    """Sort-free insert-or-find (jaxtlc/engine/fpset.py:795):
    fpset_insert_sorted's contract (same per-lane verdicts, same
    representatives, the same TABLE words) in the reference's slab layout:
    representatives fp-ascending in the first R rows but not a prefix
    (slab-collision duplicate rows interspersed, is_new False, their real
    lane in c_idx), padding rows with the sentinel lane N.  Falls back to
    the sorted computation wholesale when the claimants exceed R.

    Returns the reference's (s, is_new_c, c_idx, nreps) and, last, whether
    the batch took the fallback (the engine counts them).  The fallback
    decision reads n_cand on the host: the step's second host read, where
    the reference decides in a lax.cond on the device."""
    n = lo.shape[0]
    R = min(probe_width or n, n)
    C = min(claim_width or R, R)
    key = fpset_key(lo, hi, mask)
    c_lane, n_cand = _slab_dedup_core(key, R, slab_factor, slab_passes,
                                      slab_bits)
    if claimant_count(n_cand) > R:
        is_new_c, c_idx, nreps = _sorted_dedup_probe(s.table, key, R, C)
        return s, is_new_c, c_idx, nreps, True
    s_key, c_idx_r, active = _order_and_dedup(key, c_lane, n_cand, R)
    is_new = torch.empty(R, dtype=torch.uint8, device=lo.device)
    probe_segment(s.table, s_key, None, 0, C, is_new,
                  torch.zeros(1, dtype=torch.int32, device=lo.device)
                  if lo.is_cuda else None, active)
    nreps = active.sum(dtype=torch.int64)
    is_new_c = torch.cat([is_new.bool(), torch.zeros(
        n - R, dtype=torch.bool, device=lo.device)])
    c_idx = torch.cat([c_idx_r, torch.full((n - R,), n, dtype=torch.int64,
                                           device=lo.device)])
    return s, is_new_c, c_idx, nreps, False


def fpset_insert_dedup(
    s: FPSet, lo, hi, mask, probe_width: int = 0, claim_width: int = 0,
    sort_free: bool = False,
) -> Tuple[FPSet, torch.Tensor, torch.Tensor, torch.Tensor, bool]:
    """The engine seam's one dispatch point (jaxtlc/engine/fpset.py:849):
    the sorted path or the sort-free slab path, the same contract either
    way.  Returns the reference's (s, is_new_c, c_idx, nreps) and whether
    the slab path fell back to the sorted one (always False when sorted)."""
    if not sort_free:
        return (*fpset_insert_sorted(s, lo, hi, mask, probe_width=probe_width,
                                     claim_width=claim_width), False)
    return fpset_insert_slab(s, lo, hi, mask, probe_width=probe_width,
                             claim_width=claim_width)


def fpset_insert(s: FPSet, lo, hi, mask, sort_free: bool = False,
                 probe_width: int = 0) -> Tuple[FPSet, torch.Tensor]:
    """Insert-or-find a batch (jaxtlc/engine/fpset.py:869): (set, is_new
    [N] bool in lane order).  A fingerprint repeated in the batch is new
    at most at its highest lane.  sort_free takes the slab path, where
    probe_width bounds the claimant slice."""
    n = lo.shape[0]
    s2, is_new_c, c_idx, _, _ = fpset_insert_dedup(
        s, lo, hi, mask, probe_width=probe_width if sort_free else 0,
        sort_free=sort_free)
    is_new = torch.zeros(n + 1, dtype=torch.bool, device=lo.device)
    is_new[c_idx] = is_new_c  # the slab path's sentinel lane n drops
    return s2, is_new[:n]


def fpset_actual_collision(s: FPSet) -> float:
    """TLC's "based on the actual fingerprints" estimate (MC.out:42):
    1 / min adjacent gap of the sorted stored (mixed) entries, in the
    reference's float32 arithmetic."""
    t = to_u64(s.table.view(-1, 2))
    occ = (t[:, 0] != 0) | (t[:, 1] != 0)
    keys = torch.sort(key_of(t[occ, 0], t[occ, 1])).values
    if keys.numel() < 2:
        return 0.0
    lo, hi = key_words(keys)
    dl = (lo[1:] - lo[:-1]) & MASK32
    borrow = (lo[1:] < lo[:-1]).to(torch.int64)
    dh = (hi[1:] - hi[:-1] - borrow) & MASK32
    gap = (dh.to(torch.float32) * torch.tensor(4294967296.0)
           + dl.to(torch.float32))
    min_gap = gap.min()
    if not (torch.isfinite(min_gap) and min_gap > 0):
        return 0.0
    return float(torch.tensor(1.0, dtype=torch.float32) / min_gap)
