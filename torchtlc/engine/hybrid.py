"""Hybrid engine: device expansion + native host dedup/frontier tier (port
of jaxtlc/engine/hybrid.py).

The TLC architecture at full scale: workers expand states while the
fingerprint set and state queue live in off-heap/disk structures
(OffHeapDiskFPSet + DiskStateQueue, MC.out:5), bounding the exhaustive run
by disk rather than device memory.  The *device* expands each popped
block, evaluates the invariants, packs and fingerprints the successors;
the *authoritative* fingerprint set and the frontier FIFO live in the
native C++ tier (torchtlc.native: mmap-backed open addressing + a
file-backed queue of unpacked ``[F]`` int32 records), whose capacity is
the disk.

The device half is two kernels the other engines already run: kernel K1's
sharded variant at D = 1 (``engine.sharded.expand_sharded``) over a
one-shard staging queue ``[1, chunk + 1, F]`` that holds the popped rows
(head 0, ``npop = n``: the rows past n are outside the pop mask, so a
short last block needs no zero padding), which gives every lane's raw
successor fields, packed words, validity / assert / overflow /
invariant-failure flags and action; then kernel K2 (``fp64_words``) on the
packed words.  On a CPU device both run their plain versions.  Only what
the host tier needs crosses to the host: the fingerprint words, the five
flag rows and the actions of every lane (17 bytes a lane, where the
reference copies the whole ``[chunk*L, F]`` successor block), then, after
the store's verdict, the rows of the new states, gathered on the device.
The queue file's bytes are the reference's either way.

The host half is the reference's, in its order: the sequential
(partition-routed) store insert, the ``np.add.at`` statistics, the
violation priority (TypeOK, OnlyOneVersion, assert, deadlock, slot
overflow; first lane of the first code), level fencing by counts.

Two TLC capabilities compose here, as in the reference:

* **Checkpoint/recover** (``ckpt_path``/``resume``): every ``ckpt_every``
  chunks the stores and the queue are synced, the stores snapshot to
  generation-numbered copies, the queue file mirrors incrementally, and
  the meta (format ``jaxtlc-hybrid-ckpt-v1``, the model's ``repr``) is
  replaced last; either package resumes the other's checkpoint.
* **Fingerprint-space partitioning** (``fp_partitions=D``): fingerprints
  split by the low bits of the upper word across D host stores.

Outdegree min/max are this engine's own (sequential first-lane
attribution of a duplicate discovery), as in the reference.  ``timing``
(a dict) adds, per phase, the seconds of the run - the device half
synchronized before each host phase is timed: ``device`` (K1 and K2),
``h2d`` and ``d2h`` (the copies), ``insert`` (the store), ``push`` and
``pop`` (the queue), ``stats`` (the numpy statistics and violation
scan).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..native import HostFPStore, HostStateQueue
from ..spec.codec import get_codec
from ..spec.kernel import initial_vectors, lane_layout
from ..spec.labels import LABELS
from .bfs import (
    OK,
    VIOL_ASSERT,
    VIOL_DEADLOCK,
    VIOL_ONLYONEVERSION,
    VIOL_SLOT_OVERFLOW,
    VIOL_TYPEOK,
    VIOLATION_NAMES,
    CheckResult,
    outdegree_from_hist,
    resolve_device,
)
from .fingerprint import DEFAULT_FP_INDEX, DEFAULT_SEED, fp64_words
from .sharded import expand_sharded

CKPT_FORMAT = "jaxtlc-hybrid-ckpt-v1"


class _Tier(NamedTuple):
    """The host tier's working structures for one run."""

    stores: list  # [HostFPStore] x D
    queue: HostStateQueue


def _open_tier(F, fp_partitions, fp_path, queue_path,
               initial_fp_capacity, resume_meta=None) -> _Tier:
    D = fp_partitions
    fp_paths = (
        [fp_path] if (fp_path and D == 1)
        else ([f"{fp_path}.{p}" for p in range(D)] if fp_path else
              [None] * D)
    )
    stores = [
        HostFPStore(
            fp_paths[p],
            initial_capacity=max(initial_fp_capacity // D, 1 << 12),
            fresh=resume_meta is None,
        )
        for p in range(D)
    ]
    if resume_meta is None:
        queue = HostStateQueue(F, queue_path)
    else:
        queue = HostStateQueue(
            F, queue_path,
            resume_head=int(resume_meta["q_head"]),
            resume_tail=int(resume_meta["q_tail"]),
        )
    return _Tier(stores, queue)


class DeviceHalf(NamedTuple):
    """One expanded block on the device: every lane's raw successor fields
    and packed words, its fingerprint, flags and action."""

    fields: torch.Tensor  # [chunk*L, F] int32
    lo: torch.Tensor  # [chunk*L] int32
    hi: torch.Tensor  # [chunk*L] int32
    flags: torch.Tensor  # [5, chunk*L] uint8: valid, afail, ovf, !TypeOK,
    # !OnlyOneVersion (all masked by the pop and validity)
    action: torch.Tensor  # [chunk*L] int32


def make_expand(cfg: ModelConfig, chunk: int, device,
                fp_index: int = DEFAULT_FP_INDEX, seed: int = DEFAULT_SEED):
    """The device half of the hybrid step: expand(rows [n, F] int32 numpy,
    n <= chunk) -> DeviceHalf, through K1's sharded variant at D = 1 and
    K2 (their plain versions on a CPU device).  ``expand.stage(rows, n)``
    and ``expand.run(n)`` are its two parts: the copy into the staging
    queue (reused across calls) and the launches."""
    cdc = get_codec(cfg)
    dev = resolve_device(device)
    stage = torch.zeros((1, chunk + 1, cdc.n_fields), dtype=torch.int32,
                        device=dev)
    qhead = torch.zeros(1, dtype=torch.int64, device=dev)

    def stage_rows(rows: np.ndarray, n: int) -> None:
        if n:
            stage[0, :n].copy_(torch.from_numpy(np.ascontiguousarray(
                rows[:n], dtype=np.int32)))

    def run(n: int) -> DeviceHalf:
        npop = torch.full((1,), n, dtype=torch.int64, device=dev)
        packed, flags, action, _gen, fields, _ = expand_sharded(
            cfg, stage, qhead, npop, chunk)
        lo, hi = fp64_words(packed, cdc.nbits, fp_index, seed)
        return DeviceHalf(fields, lo, hi, flags, action)

    def expand(rows: np.ndarray, n: int) -> DeviceHalf:
        stage_rows(rows, n)
        return run(n)

    expand.stage, expand.run, expand.device = stage_rows, run, dev
    return expand


def host_view(h: DeviceHalf):
    """(lo, hi uint32, flags uint8 [5, N], action int32) on the host: two
    copies, the int32 planes stacked into one."""
    planes = torch.stack([h.lo, h.hi, h.action]).cpu().numpy()
    flags = h.flags.cpu().numpy()
    return (planes[0].view(np.uint32), planes[1].view(np.uint32), flags,
            planes[2])


def check_hybrid(
    cfg: ModelConfig,
    chunk: int = 1024,
    fp_index: int = DEFAULT_FP_INDEX,
    seed: int = DEFAULT_SEED,
    fp_path: Optional[str] = None,
    queue_path: Optional[str] = None,
    initial_fp_capacity: int = 1 << 20,
    fp_partitions: int = 1,
    ckpt_path: Optional[str] = None,
    ckpt_every: int = 256,
    resume: bool = False,
    max_chunks: Optional[int] = None,
    device=None,
    timing: Optional[dict] = None,
) -> CheckResult:
    """Exhaustive check with host-resident (disk-bounded) dedup + frontier
    on `device` (None = the card; "cpu" the plain versions).

    Without `resume`, stores open fresh (stale files at the given paths are
    discarded - recovering a fingerprint file while the queue restarts
    empty would yield a bogus instantly-"complete" result).  With
    `ckpt_path`, working files derive from it and every `ckpt_every`
    chunks a consistent snapshot is taken; `resume=True` restarts from the
    snapshot.  `max_chunks` stops early (tests interrupt mid-run with it).
    """
    if fp_partitions < 1 or fp_partitions & (fp_partitions - 1):
        raise ValueError(
            f"fp_partitions must be a power of two, got {fp_partitions} "
            "(the owner of a fingerprint is its low hi-word bits)"
        )
    cdc = get_codec(cfg)
    F = cdc.n_fields
    _, L = lane_layout(cfg)
    D = fp_partitions
    n_labels = len(LABELS)
    expand = make_expand(cfg, chunk, device, fp_index, seed)
    dev = expand.device
    tick = _Ticker(timing, dev)

    if ckpt_path:
        fp_path = fp_path or f"{ckpt_path}.work.fps"
        queue_path = queue_path or f"{ckpt_path}.work.sq"

    t0 = time.time()
    resume_meta = None
    if resume:
        if not ckpt_path or not os.path.exists(ckpt_path + ".meta.json"):
            raise FileNotFoundError(f"no hybrid checkpoint at {ckpt_path!r}")
        with open(ckpt_path + ".meta.json") as f:
            resume_meta = json.load(f)
        _check_meta(resume_meta, cfg, chunk, D)
        # restore working files from the generation the meta names: the
        # snapshot set is consistent because meta.json is replaced LAST -
        # a crash mid-checkpoint leaves the old meta pointing at the old
        # (complete) generation
        gen = int(resume_meta.get("generation", 0))
        for p in range(D):
            dst = fp_path if D == 1 else f"{fp_path}.{p}"
            shutil.copyfile(f"{ckpt_path}.g{gen}.fps{p}", dst)
        # the queue snapshot is a single incremental mirror (append-only
        # up to the recorded tail; see checkpoint())
        shutil.copyfile(f"{ckpt_path}.sq.snap", queue_path)

    tier = _open_tier(F, D, fp_path, queue_path, initial_fp_capacity,
                      resume_meta)
    stores, queue = tier.stores, tier.queue

    def insert(lo, hi, mask):
        """Partition-routed insert; exact (one owner per fingerprint)."""
        if D == 1:
            return stores[0].insert(lo, hi, mask)
        owner = hi & np.uint32(D - 1)
        is_new = np.zeros(len(lo), bool)
        for p in range(D):
            m = mask & (owner == p)
            if m.any():
                is_new |= stores[p].insert(lo, hi, m)
        return is_new

    try:
        if resume_meta is None:
            inits = initial_vectors(cfg)
            packed0 = cdc.pack(torch.from_numpy(
                np.ascontiguousarray(inits, np.int32)).to(dev))
            lo0, hi0 = fp64_words(packed0, cdc.nbits, fp_index, seed)
            new0 = insert(
                lo0.cpu().numpy().view(np.uint32),
                hi0.cpu().numpy().view(np.uint32),
                np.ones(len(inits), bool),
            )
            queue.push(inits[new0])
            generated = len(inits)
            level = depth = 1
            level_left = int(new0.sum())
            next_level = 0
            act_gen = np.zeros(n_labels, np.int64)
            act_dist = np.zeros(n_labels, np.int64)
            outdeg_hist = np.zeros(L + 1, dtype=np.int64)
            viol = OK
            viol_state = np.zeros(F, np.int32)
            viol_action = -1
        else:
            m = resume_meta
            generated = int(m["generated"])
            level, depth = int(m["level"]), int(m["depth"])
            level_left, next_level = int(m["level_left"]), int(
                m["next_level"])
            act_gen = np.asarray(m["act_gen"], np.int64)
            act_dist = np.asarray(m["act_dist"], np.int64)
            outdeg_hist = np.asarray(m["outdeg_hist"], np.int64)
            viol = int(m["viol"])
            viol_state = np.asarray(m["viol_state"], np.int32)
            viol_action = int(m["viol_action"])

        buf = np.zeros((chunk, F), dtype=np.int32)
        chunks_done = (
            0 if resume_meta is None
            else int(resume_meta.get("chunks_done", 0))
        )
        gen_counter = (
            0 if resume_meta is None
            else int(resume_meta.get("generation", 0))
        )
        # queue-mirror high-water mark: the mirror is valid in
        # [0, snap_tail) records; a fresh run starts a fresh mirror
        snap_tail = (
            0 if resume_meta is None else int(resume_meta["q_tail"])
        )
        if ckpt_path and resume_meta is None:
            # a fresh run must clear the WHOLE stale snapshot set, meta
            # FIRST: once no meta exists, -recover reports "no checkpoint"
            # cleanly no matter where a crash lands in this cleanup
            _rm(f"{ckpt_path}.meta.json")
            _rm(f"{ckpt_path}.sq.snap")
            for stale in glob.glob(f"{glob.escape(ckpt_path)}.g*.fps*"):
                _rm(stale)

        def checkpoint():
            # generation-numbered fp snapshots + an incremental queue
            # mirror + meta replaced LAST, all fsynced: the snapshot SET
            # is consistent under a crash at any point.  The queue file is
            # append-only in [0, tail), so the mirror copies just the
            # delta - checkpoint I/O stays O(new states)
            nonlocal gen_counter, snap_tail
            gen = gen_counter + 1
            for s in stores:
                s.sync()
            queue.sync()
            for p, s in enumerate(stores):
                _copy_fsync(s.path, f"{ckpt_path}.g{gen}.fps{p}")
            rb = F * 4
            tail = queue.total_pushed
            _append_region(queue.path, f"{ckpt_path}.sq.snap",
                           snap_tail * rb, tail * rb)
            meta = dict(
                format=CKPT_FORMAT,
                config=repr(cfg),
                chunk=chunk,
                fp_partitions=D,
                generation=gen,
                chunks_done=int(chunks_done),
                generated=int(generated),
                level=int(level), depth=int(depth),
                level_left=int(level_left), next_level=int(next_level),
                act_gen=act_gen.tolist(), act_dist=act_dist.tolist(),
                outdeg_hist=outdeg_hist.tolist(),
                viol=int(viol), viol_state=viol_state.tolist(),
                viol_action=int(viol_action),
                q_head=queue.head, q_tail=queue.total_pushed,
            )
            tmp = ckpt_path + ".meta.json.tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, ckpt_path + ".meta.json")
            _fsync_dir(os.path.dirname(os.path.abspath(ckpt_path)))
            gen_counter = gen
            snap_tail = tail
            # best-effort cleanup of superseded fp generations
            for g in range(max(gen - 2, 0), gen):
                for p in range(D):
                    _rm(f"{ckpt_path}.g{g}.fps{p}")

        while len(queue) and viol == OK:
            if max_chunks is not None and chunks_done >= max_chunks:
                break
            n = min(chunk, level_left)
            tick.start()
            n = queue.pop_into(buf[:n])
            tick("pop", sync=False)
            expand.stage(buf, n)
            tick("h2d")
            h = expand.run(n)
            tick("device")
            lo, hi, flags, faction = host_view(h)
            tick("d2h")
            valid = flags[0].astype(bool).reshape(chunk, L)
            fvalid = valid.reshape(-1)
            dead = valid[:n].sum(axis=1) == 0
            generated += int(fvalid.sum())
            tick("stats", sync=False)

            is_new = insert(lo, hi, fvalid)
            tick("insert", sync=False)
            new_idx = np.flatnonzero(is_new)
            new_flat = h.fields.index_select(
                0, torch.from_numpy(new_idx).to(dev)).cpu().numpy()
            tick("d2h")
            queue.push(new_flat)
            tick("push", sync=False)

            np.add.at(act_gen, faction[fvalid], 1)
            np.add.at(act_dist, faction[is_new], 1)
            newdeg = is_new.reshape(chunk, L).sum(axis=1)
            np.add.at(outdeg_hist, newdeg[:n], 1)

            # violations, same priority order as the device engine
            bad_type = flags[3].astype(bool)
            bad_oov = flags[4].astype(bool)
            for code, vmask, states, acts in (
                (VIOL_TYPEOK, bad_type, None, faction),
                (VIOL_ONLYONEVERSION, bad_oov, None, faction),
                (VIOL_ASSERT, flags[1].astype(bool), L, faction),
                (VIOL_DEADLOCK, dead, 1, None),
                (VIOL_SLOT_OVERFLOW, flags[2].astype(bool), L, faction),
            ):
                if viol == OK and vmask.any():
                    viol = code
                    i = int(np.argmax(vmask))
                    # the lane's successor fields, or the popped row of
                    # a lane (L) or of a row (1)
                    viol_state = (h.fields[i].cpu().numpy()
                                  if states is None
                                  else buf[i // states].copy())
                    viol_action = int(acts[i]) if acts is not None else -1
            tick("stats", sync=False)

            level_left -= n
            next_level += len(new_idx)
            if level_left == 0:
                level_left = next_level
                next_level = 0
                if level_left:
                    level += 1
                    depth = level
            chunks_done += 1
            if ckpt_path and chunks_done % ckpt_every == 0:
                checkpoint()

        if ckpt_path:
            checkpoint()
        distinct = sum(len(s) for s in stores)
        queue_left = len(queue)
        for s in stores:
            s.sync()
    finally:
        for s in tier.stores:
            s.close()
        tier.queue.close()

    return CheckResult(
        generated=generated,
        distinct=distinct,
        depth=depth,
        queue_left=queue_left,
        violation=viol,
        violation_name=VIOLATION_NAMES[viol],
        violation_state=viol_state,
        violation_action=viol_action,
        action_generated={
            LABELS[k]: int(v) for k, v in enumerate(act_gen) if v
        },
        action_distinct={
            LABELS[k]: int(v) for k, v in enumerate(act_dist) if v
        },
        wall_s=time.time() - t0,
        iterations=chunks_done,
        outdegree=outdegree_from_hist(outdeg_hist),
    )


class _Ticker:
    """Per-phase seconds into `timing` (a no-op without it): each call
    closes the phase that ran since the last one, after a device
    synchronize unless sync=False."""

    def __init__(self, timing: Optional[dict], dev: torch.device):
        self.timing = timing
        self.cuda = dev.type == "cuda"
        self.t = 0.0

    def start(self) -> None:
        if self.timing is not None:
            self.t = time.perf_counter()

    def __call__(self, phase: str, sync: bool = True) -> None:
        if self.timing is None:
            return
        if sync and self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.timing[phase] = self.timing.get(phase, 0.0) + now - self.t
        self.t = now


def _rm(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _copy_fsync(src: str, dst: str) -> None:
    """Copy + fsync: the snapshot must be ON DISK before the meta that
    names it is replaced (page-cache-only copies can reach disk after
    the rename under a crash)."""
    shutil.copyfile(src, dst)
    with open(dst, "rb+") as f:
        os.fsync(f.fileno())


def _append_region(src: str, dst: str, start: int, end: int) -> None:
    """Write src's byte range [start, end) into dst at the same offset,
    fsynced (the incremental queue-mirror append)."""
    if end <= start:
        with open(dst, "ab"):
            pass
        return
    with open(src, "rb") as fsrc, open(
        dst, "r+b" if os.path.exists(dst) else "w+b"
    ) as fdst:
        fsrc.seek(start)
        fdst.seek(start)
        remaining = end - start
        while remaining:
            buf = fsrc.read(min(remaining, 1 << 22))
            if not buf:
                raise OSError("queue file shorter than its tail cursor")
            fdst.write(buf)
            remaining -= len(buf)
        fdst.flush()
        os.fsync(fdst.fileno())


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def _check_meta(meta: dict, cfg: ModelConfig, chunk: int, D: int) -> None:
    if meta.get("format") != CKPT_FORMAT:
        raise ValueError(f"bad hybrid checkpoint format {meta.get('format')!r}")
    for key, want in (("config", repr(cfg)), ("chunk", chunk),
                      ("fp_partitions", D)):
        if meta.get(key) != want:
            raise ValueError(
                f"hybrid checkpoint {key} mismatch: "
                f"{meta.get(key)!r} != {want!r}"
            )
