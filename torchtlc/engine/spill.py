"""Host-RAM fingerprint spill tier (port of jaxtlc/engine/spill.py).

When the device table cannot grow (the supervisor's allocation probe is
denied), the run goes on in spill mode instead of halting:

* ``SpillStore`` - a host open-addressing store of MIXED fingerprint
  words with the device table's slot walk and equality classes (the
  (0, 0) -> (1, 0) remap included), a Python-set mirror for membership,
  snapshot/restore rollback points, and CRC'd files through the
  checkpoint format.  Host numpy, the reference's semantics unchanged.
* ``SpillRuntime`` - the spill-mode step loop: the SAME pop/expand and
  commit stages as the engine (bfs.make_stage_pair with spill=True),
  driven one chunk at a time so a host probe sits between them::

      expand (K1, K2) -> fpset_member (K9, at most MEMBER_ROUNDS rows)
        -> one device-to-host read of the probable-new lanes
        -> SpillStore.probe (host) -> commit with the host veto (K3, K4)

  The device table is the recent tier: before a chunk that could take it
  past the fp_highwater load, its entries are unmixed on the host
  (fpset.unmix_host) and bulk-inserted into the store, and the table
  starts empty again.

Exactness: a vetoed candidate dedups like a table hit, every fingerprint
seen lives in exactly one tier between flushes, and the pop sequence is
the engine's own chunk for chunk, so a spill-mode run's final counters
and verdict equal a correctly sized clean run's.  Like the reference, the
runtime is unpipelined and stays below the two-tier chunk threshold
(2^14): every step pops `chunk` states.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .bfs import OK, carry_done, make_backend_engine, make_stage_pair
from .bfs import read_bundle, resolve_deferred, resolve_sort_free
from .fingerprint import DEFAULT_FP_INDEX
from .fpset import (
    BUCKET,
    CapacityError,
    bucket_of_host,
    fpset_count,
    fpset_member,
    fpset_new,
    mix_host_np,
    unmix_host,
)

SPILL_FORMAT = 1
DEFAULT_SPILL_CAPACITY = 1 << 15
# the filter's walk cap: near the highwater load absent keys walk long
# runs of full buckets; an unresolved lane safely asks the host store
MEMBER_ROUNDS = 4


class SpillWriteError(RuntimeError):
    """A device-table flush into the host store failed (OSError from the
    write seam); the supervisor degrades it to checkpoint + exit 75."""


class SpillStoreSnapshot(NamedTuple):
    """Immutable rollback point of a SpillStore."""

    table: np.ndarray
    count: int


class SpillStore:
    """Host-RAM open-addressing fingerprint store: a flat ``[capacity, 2]``
    uint32 table of MIXED (lo, hi) pairs in fpset.host_insert's memory
    order and slot walk, plus a set of packed 64-bit words for O(1)
    membership, rebuilt from the table on load and restore.  Grows by
    doubling at the 0.85 highwater, re-placing every entry in slot
    order."""

    def __init__(self, capacity: int = DEFAULT_SPILL_CAPACITY,
                 highwater: float = 0.85):
        assert capacity & (capacity - 1) == 0, "capacity must be 2^k"
        assert capacity >= BUCKET
        self.table = np.zeros((capacity, 2), np.uint32)
        self.count = 0
        self.highwater = highwater
        self._mirror = set()

    @property
    def capacity(self) -> int:
        return self.table.shape[0]

    @staticmethod
    def _keys(raw_lo: np.ndarray, raw_hi: np.ndarray):
        """MIXED words of raw fingerprints, (0, 0) remapped to (1, 0)."""
        mlo, mhi = mix_host_np(raw_lo, raw_hi)
        z = (mlo == 0) & (mhi == 0)
        mlo[z] = 1
        return mlo, mhi

    def probe(self, raw_lo: np.ndarray, raw_hi: np.ndarray) -> np.ndarray:
        """Membership of each raw fingerprint (bool array); read-only."""
        mlo, mhi = self._keys(raw_lo, raw_hi)
        mirror = self._mirror
        return np.fromiter(
            (((int(h) << 32) | int(l)) in mirror for l, h in zip(mlo, mhi)),
            dtype=bool, count=len(mlo))

    def _place(self, lo: int, hi: int) -> None:
        """Insert one MIXED pair known absent: home bucket from the top
        bits of hi, linear to the first empty slot (deterministic, so a
        replay reproduces the table bytes)."""
        table, cap = self.table, self.capacity
        base = bucket_of_host(hi, cap // BUCKET) * BUCKET
        for k in range(cap):
            slot = (base + k) % cap
            if table[slot, 0] == 0 and table[slot, 1] == 0:
                table[slot, 0] = lo
                table[slot, 1] = hi
                return
        raise CapacityError(cap, cap, "spill")

    def _grow(self) -> None:
        old = self.table
        occ = (old[:, 0] != 0) | (old[:, 1] != 0)
        self.table = np.zeros((self.capacity * 2, 2), np.uint32)
        for lo, hi in old[occ]:  # slot-scan order: a deterministic layout
            self._place(int(lo), int(hi))

    def reserve(self, n: int) -> None:
        """Grow until `n` more entries fit under the highwater (a flush
        batch arrives sorted by home bucket; growing mid-batch would
        degrade the linear walk into one long run)."""
        while self.count + n > self.highwater * self.capacity:
            self._grow()

    def insert_batch(self, raw_lo: np.ndarray, raw_hi: np.ndarray) -> int:
        """Insert raw fingerprints (present ones are no-ops); returns how
        many were new."""
        self.reserve(len(raw_lo))
        mlo, mhi = self._keys(raw_lo, raw_hi)
        added = 0
        for l, h in zip(mlo.tolist(), mhi.tolist()):
            key = (h << 32) | l
            if key in self._mirror:
                continue
            if self.count + 1 > self.highwater * self.capacity:
                self._grow()
            self._place(l, h)
            self._mirror.add(key)
            self.count += 1
            added += 1
        return added

    def snapshot(self) -> SpillStoreSnapshot:
        return SpillStoreSnapshot(self.table.copy(), self.count)

    def restore(self, snap: SpillStoreSnapshot) -> None:
        self.table = snap.table.copy()
        self.count = int(snap.count)
        self._rebuild_mirror()

    def _rebuild_mirror(self) -> None:
        t = self.table
        occ = (t[:, 0] != 0) | (t[:, 1] != 0)
        self._mirror = {(int(h) << 32) | int(l) for l, h in t[occ]}

    def save(self, path: str) -> None:
        save_snapshot(path, self.snapshot())

    @classmethod
    def load(cls, path: str) -> "SpillStore":
        """Load + CRC-verify a saved store (CheckpointCorruptError on a
        torn file)."""
        from .checkpoint import load_checkpoint, read_checkpoint_meta

        cap = int(read_checkpoint_meta(path)["capacity"])
        meta, loaded = load_checkpoint(
            path, {"table": np.zeros((cap, 2), np.uint32)})
        store = cls(cap)
        store.table = np.asarray(loaded["table"], np.uint32).copy()
        store.count = int(meta["count"])
        store._rebuild_mirror()
        return store


def spill_sibling(ckpt_path: str) -> str:
    """The host-tier file that travels beside a checkpoint file."""
    return ckpt_path + ".spill"


def save_snapshot(path: str, snap: SpillStoreSnapshot) -> None:
    """Persist a store SNAPSHOT (the host tier of one segment boundary)."""
    from .checkpoint import save_checkpoint

    save_checkpoint(path, {"table": snap.table},
                    {"spill_format": SPILL_FORMAT, "count": int(snap.count),
                     "capacity": int(snap.table.shape[0])})


class SpillRuntime:
    """Spill-mode execution of the single-device engine; the supervisor
    swaps its segment function for ``segment_fn`` when the ladder turns
    the spill tier on.  ``on_event(kind, info)`` receives the `spill`
    journal events; ``spill_write_hook`` is the fault seam called before
    every flush.  After a run, ``flushes``, ``probes`` (candidates that
    paid the host round trip) and ``store_s`` (seconds in the host store:
    flushes and probes) describe the host tier's work."""

    def __init__(self, backend, chunk: int, queue_capacity: int,
                 fp_capacity: int, fp_highwater: float = 0.85,
                 obs_slots: int = 0, sort_free: bool = None,
                 deferred: bool = None, store: Optional[SpillStore] = None,
                 on_event: Optional[Callable] = None,
                 spill_write_hook: Optional[Callable] = None, device=None,
                 fp_index: int = DEFAULT_FP_INDEX):
        sort_free = resolve_sort_free(sort_free, chunk)
        deferred = resolve_deferred(deferred, chunk)
        self.chunk = chunk
        self.fp_capacity = fp_capacity
        self.fp_highwater = fp_highwater
        self.store = store if store is not None else SpillStore()
        self.on_event = on_event
        self.spill_write_hook = spill_write_hook
        self.flushes = 0
        self.probes = 0
        self.store_s = 0.0
        self.ncand = chunk * backend.n_lanes
        self._base_init, _, _ = make_backend_engine(
            backend, chunk, queue_capacity, fp_capacity, obs_slots=obs_slots,
            sort_free=sort_free, deferred=deferred, device=device,
            fp_index=fp_index)
        self._pop_expand, self._commit = make_stage_pair(
            backend, chunk, queue_capacity=queue_capacity,
            fp_capacity=fp_capacity, obs_slots=obs_slots, spill=True,
            sort_free=sort_free, deferred=deferred, fp_index=fp_index)

    def init_fn(self):
        """A fresh spill-mode carry (also the checkpoint template)."""
        return self.adopt(self._base_init())

    def adopt(self, carry):
        """Enter spill mode: add the spill_hits leaf (idempotent).  The
        saturated table stays; the first step's residency test flushes
        it."""
        if carry.spill_hits is None:
            carry = carry._replace(spill_hits=torch.zeros(
                (), dtype=torch.int64, device=carry.queue.device))
        return carry

    def _emit(self, kind: str, **info) -> None:
        if self.on_event is not None:
            self.on_event(kind, info)

    def _flush(self, carry):
        """Move the device table into the host store and start it empty;
        SpillWriteError when the write seam fails."""
        try:
            if self.spill_write_hook is not None:
                self.spill_write_hook()
        except OSError as e:
            raise SpillWriteError(str(e)) from e
        t0 = time.time()
        table = carry.fps.table.cpu().numpy().view(np.uint32)
        lo = table[:, 0::2].reshape(-1)
        hi = table[:, 1::2].reshape(-1)
        occ = (lo != 0) | (hi != 0)
        self.store.insert_batch(*unmix_host(lo[occ], hi[occ]))
        self.flushes += 1
        wall = time.time() - t0
        self.store_s += wall
        carry = carry._replace(fps=fpset_new(self.fp_capacity,
                                             carry.queue.device))
        self._emit("spill", phase="flush", resident=0,
                   spilled=self.store.count, capacity=self.store.capacity,
                   hits=int(carry.spill_hits), probes=self.probes,
                   wall_s=round(wall, 6))
        return carry

    def step(self, carry):
        """One spill-mode chunk step (the caller has flushed if needed)."""
        h = read_bundle(carry)
        ex, n = self._pop_expand(carry, h)
        member = fpset_member(carry.fps, ex.lo, ex.hi, ex.valid,
                              max_rounds=MEMBER_ROUNDS)
        lanes = torch.nonzero(ex.valid & ~member).flatten()
        veto = torch.zeros_like(ex.valid)
        if lanes.numel():
            # the one device-to-host read of the probable-new lanes
            words = torch.stack([ex.lo[lanes], ex.hi[lanes]]).cpu().numpy()
            words = words.view(np.uint32)
            self.probes += lanes.numel()
            t0 = time.time()
            held = self.store.probe(words[0], words[1])
            self.store_s += time.time() - t0
            if held.any():
                veto[lanes[torch.from_numpy(held).to(lanes.device)]] = True
        return self._commit(carry, ex, n, h.qhead + n, h.qhead + n, h,
                            veto=veto)

    def segment_fn(self, ckpt_every: int):
        """seg(carry) -> the carry after up to `ckpt_every` chunk steps,
        stopping early at the end of the run or at a violation."""
        highwater_slots = int(self.fp_capacity * self.fp_highwater)

        def seg(carry):
            # measured, not derived from the distinct counter: a rolled-
            # back carry whose failed attempt flushed stays exact
            resident = int(fpset_count(carry.fps))
            for _ in range(ckpt_every):
                if carry_done(carry):
                    break
                if resident + self.ncand > highwater_slots:
                    carry = self._flush(carry)
                    resident = 0
                before = read_bundle(carry).distinct
                carry = self.step(carry)
                resident += carry.bundle.distinct - before
                if carry.bundle.viol != OK:
                    break
            return carry

        return seg
