"""Checkpoints and recovery (port of jaxtlc/engine/checkpoint.py).

A checkpoint is the reference's file: an ``.npz`` of the engine carry's
leaves ``leaf_i`` - in the reference carry's leaf order and dtypes
(interop.LEAF_ORDER: the EngineCarry's fields, a pipelined carry's
staged block, the observability ring, in spill mode ``spill_hits`` and
with the coverage plane ``cov_counts``; for the sharded engine's
ShardCarry, interop.SHARD_LEAF_ORDER with every leaf's leading shard axis
and the meta's ``devices``; for the random walk's SimCarry its own
protocol, sim.engine's ``checkpoint_leaves`` in the order of the
reference's pytree leaves) - plus a JSON
``__meta__`` with the engine geometry, the ModelConfig stanza and a CRC32
manifest of every leaf, written to a temporary file, fsync'd and renamed.
So a checkpoint written by either package loads in the other, and a
resumed run equals an uninterrupted one: the engine is a function of its
carry.  A pipelined carry converts with its codec (the `codec` argument
of the save and load functions, or KubeAPI's from the ModelConfig
`cfg`); the meta records ``pipeline``,
and a resume in the other mode is refused before any engine is built.

``check_with_checkpoints`` is the checkpointed driver: the host loop
runs segments of ``ckpt_every`` step bodies (bfs.make_segment) and writes
a snapshot at every segment boundary.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import time
import zlib
from typing import Optional

import numpy as np

from ..config import ModelConfig
from .bfs import (
    FP_HIGHWATER,
    CheckResult,
    EngineCarry,
    carry_done,
    make_engine,
    make_segment,
    read_bundle,
    result_from_carry,
)
from .fingerprint import DEFAULT_FP_INDEX, DEFAULT_SEED
from .interop import (
    COUNTERS,
    LEAF_ORDER,
    OBS_SCALARS,
    REDUCE_DTYPES,
    SCALARS,
    STAGED_DTYPES,
    SHARD_DTYPES,
    SHARD_LEAF_ORDER,
    carry_from_numpy,
    carry_to_numpy,
    shard_carry_from_numpy,
    shard_carry_to_numpy,
)
from .sharded import ShardCarry

# the reference's format version (v3: per-array CRC32 manifest, bucketized
# table layout, fp_highwater in meta)
FORMAT_VERSION = 3


class CheckpointCorruptError(ValueError):
    """A checkpoint file failed integrity verification (truncated npz,
    CRC mismatch, unreadable meta): the generation fallback skips it."""


def _meta(cfg: ModelConfig, meta_config: dict = None,
          **engine_params) -> dict:
    """The meta dict, round-tripped through JSON so that a fresh meta
    compares equal to one read from disk (the reference's serialization:
    the ModelConfig as dataclasses.asdict)."""
    return json.loads(json.dumps({
        "format": FORMAT_VERSION,
        "config": (meta_config if meta_config is not None
                   else dataclasses.asdict(cfg)),
        **engine_params,
    }))


def fsync_replace(tmp: str, path: str, f=None) -> None:
    """Durable atomic publish: fsync the temporary file, rename it, fsync
    the directory."""
    if f is not None:
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                    os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def _leaves(carry, cfg=None, deferred: bool = False, codec=None) -> list:
    """The carry's leaves as numpy arrays in the reference's order: an
    EngineCarry through interop, a dict in sorted key order (a pytree
    dict's order)."""
    if isinstance(carry, EngineCarry):
        d = carry_to_numpy(carry, cfg=cfg, deferred=deferred, codec=codec)
        return [d[k] for k in LEAF_ORDER if k in d]
    if isinstance(carry, ShardCarry):
        d = shard_carry_to_numpy(carry)
        return [d[k] for k in SHARD_LEAF_ORDER if k in d]
    if hasattr(carry, "checkpoint_leaves"):  # sim.engine.SimCarry
        return carry.checkpoint_leaves()
    return [np.asarray(carry[k]) for k in sorted(carry)]


def _leaf_specs(carry, cfg=None, deferred: bool = False,
                codec=None) -> list:
    """[(name, shape, dtype)] of the leaves _leaves(carry) gives, without
    copying the carry off its device."""
    if isinstance(carry, ShardCarry):
        return [(k, tuple(getattr(carry, k).shape), np.dtype(dt))
                for k, dt in SHARD_DTYPES.items()
                if getattr(carry, k) is not None]
    if hasattr(carry, "checkpoint_specs"):
        return carry.checkpoint_specs()
    if not isinstance(carry, EngineCarry):
        return [(k, np.shape(carry[k]), np.asarray(carry[k]).dtype)
                for k in sorted(carry)]
    dtypes = {"fps": np.uint32, "queue": np.uint32, "viol_state": np.int32,
              "obs_ring": np.uint32, "spill_hits": np.uint32,
              "cov_counts": np.uint32, "cert_viol": np.bool_,
              **REDUCE_DTYPES, **SCALARS, **STAGED_DTYPES,
              **OBS_SCALARS, **{k: np.uint32 for k in COUNTERS}}
    shapes = {}
    if carry.st_n is not None:
        # the leaves the port holds in another form (interop docstring)
        from .interop import staged_codec

        F = staged_codec(cfg, codec).n_fields
        shapes["st_viol_state"] = (F,)
        if deferred and carry.st_flat is None:
            shapes["st_flat"] = (carry.st_packed.shape[0], F)
    out = []
    for name in LEAF_ORDER:
        if name in shapes:
            out.append((name, shapes[name], np.dtype(dtypes[name])))
            continue
        v = getattr(carry, name, None)
        if v is None:
            continue
        t = v.table if name == "fps" else v
        out.append((name, tuple(t.shape), np.dtype(dtypes[name])))
    return out


def save_checkpoint(path: str, carry, meta: dict, cfg=None,
                    codec=None) -> None:
    """Crash-consistent snapshot: leaves as npz + JSON meta with a
    per-leaf CRC32 manifest, through an fsync'd temporary file.  A
    pipelined carry needs its `codec` or its ModelConfig `cfg`."""
    arrays = {f"leaf_{i}": a for i, a in enumerate(
        _leaves(carry, cfg, bool(meta.get("deferred")), codec))}
    manifest = {k: zlib.crc32(np.ascontiguousarray(a).tobytes())
                for k, a in arrays.items()}
    meta = {**meta, "manifest": manifest}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, __meta__=json.dumps(meta), **arrays)
        fsync_replace(tmp, path, f=f)


def read_checkpoint_meta(path: str) -> dict:
    """The meta dict alone (no leaf verification); CheckpointCorruptError
    on an unreadable file."""
    try:
        with np.load(path, allow_pickle=False) as z:
            return json.loads(str(z["__meta__"]))
    except Exception as e:  # truncated zip, missing key, bad json ...
        raise CheckpointCorruptError(f"unreadable checkpoint {path!r}: {e}")


def load_checkpoint(path: str, template, cfg=None, codec=None):
    """Load + verify a snapshot into the structure of `template` (a carry
    of the same engine geometry, or a dict; a pipelined template needs its
    `codec` or its ModelConfig `cfg`).  Returns (meta, carry); the carry lands on the
    template's device.  CheckpointCorruptError on a torn file or a CRC
    mismatch, ValueError on a geometry mismatch."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            leaves = [z[f"leaf_{i}"]
                      for i in range(sum(k.startswith("leaf_")
                                         for k in z.files))]
    except Exception as e:  # the file-parsing boundary
        raise CheckpointCorruptError(f"unreadable checkpoint {path!r}: {e}")
    manifest = meta.get("manifest")
    if manifest is not None:
        for i, a in enumerate(leaves):
            want = manifest.get(f"leaf_{i}")
            got = zlib.crc32(np.ascontiguousarray(a).tobytes())
            if want is None or got != want:
                raise CheckpointCorruptError(
                    f"checkpoint {path!r} leaf_{i} CRC mismatch "
                    f"({got} != {want}) - torn write or bit rot")
    specs = _leaf_specs(template, cfg, bool(meta.get("deferred")), codec)
    if len(leaves) != len(specs):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, engine expects "
            f"{len(specs)} - geometry mismatch")
    for got, (_, shape, dtype) in zip(leaves, specs):
        if got.shape != shape:
            raise ValueError(
                f"checkpoint leaf shape {got.shape} != engine {shape} "
                "- was the engine built with different capacities?")
        if got.dtype != dtype:
            raise ValueError(
                f"checkpoint leaf dtype {got.dtype} != engine {dtype} "
                "- corrupt or version-skewed file")
    named = dict(zip((name for name, _, _ in specs), leaves))
    if isinstance(template, EngineCarry):
        return meta, carry_from_numpy(named, device=template.queue.device,
                                      cfg=cfg, codec=codec,
                                      flat=template.st_flat is not None)
    if isinstance(template, ShardCarry):
        return meta, shard_carry_from_numpy(named,
                                            device=template.queue.device)
    if hasattr(template, "from_checkpoint"):
        return meta, template.from_checkpoint(named)
    return meta, named


_GEN_RE = re.compile(r"\.g(\d{6})\.npz$")


def generation_path(base: str, gen: int) -> str:
    """File name of generation `gen` of the checkpoint family `base`."""
    return f"{base}.g{gen:06d}.npz"


def list_generations(base: str):
    """[(gen, path)] of the on-disk generations of `base`, ascending."""
    out = []
    for p in glob.glob(f"{glob.escape(base)}.g??????.npz"):
        m = _GEN_RE.search(p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def save_generation(base: str, carry, meta: dict, keep: int = 2,
                    cfg=None, codec=None) -> str:
    """Write the next generation of `base`, then prune to the newest
    `keep` (a generation's host-tier sibling goes with it)."""
    gens = list_generations(base)
    gen = (gens[-1][0] + 1) if gens else 1
    path = generation_path(base, gen)
    save_checkpoint(path, carry, {**meta, "generation": gen}, cfg=cfg,
                    codec=codec)
    for _, old_path in gens[: max(0, len(gens) - (keep - 1))]:
        for victim in (old_path, old_path + ".spill"):
            try:
                os.remove(victim)
            except OSError:
                pass  # pruning is best-effort
    return path


def load_latest_generation(base: str, template, cfg=None, codec=None):
    """The newest generation that passes verification: (path, meta,
    carry).  A corrupt file falls back to its predecessor; a geometry
    mismatch raises; FileNotFoundError when none loads."""
    last_err = None
    for _, path in reversed(list_generations(base)):
        try:
            meta, carry = load_checkpoint(path, template, cfg, codec)
            return path, meta, carry
        except CheckpointCorruptError as e:
            last_err = e
    if last_err is not None:
        raise FileNotFoundError(
            f"no intact checkpoint generation under {base!r} "
            f"(newest failure: {last_err})")
    raise FileNotFoundError(f"no checkpoint generations under {base!r}")


def check_with_checkpoints(
    cfg: ModelConfig,
    chunk: int = 1024,
    queue_capacity: int = 1 << 15,
    fp_capacity: int = 1 << 20,
    ckpt_path: Optional[str] = None,
    ckpt_every: int = 256,
    resume: bool = False,
    max_segments: Optional[int] = None,
    on_progress=None,
    obs_slots: int = 0,
    sort_free: bool = None,
    deferred: bool = None,
    device=None,
    fp_index: int = DEFAULT_FP_INDEX,
    pipeline: bool = False,
) -> CheckResult:
    """Exhaustive check with a snapshot every `ckpt_every` chunk steps.
    resume=True loads `ckpt_path` (its meta must match this engine, the
    pipeline mode included, checked before any engine is built) and
    continues; max_segments stops early, leaving a valid checkpoint;
    on_progress(depth, generated, distinct, queue_left) fires at every
    segment boundary of an unfinished run."""
    from .bfs import resolve_deferred, resolve_sort_free

    sort_free = resolve_sort_free(sort_free, chunk)
    deferred = resolve_deferred(deferred, chunk)
    meta = _meta(cfg, chunk=chunk, queue_capacity=queue_capacity,
                 fp_capacity=fp_capacity, fp_index=fp_index,
                 seed=DEFAULT_SEED, fp_highwater=FP_HIGHWATER,
                 pipeline=bool(pipeline), obs_slots=obs_slots,
                 sort_free=sort_free, deferred=deferred)
    if resume:
        if ckpt_path is None or not os.path.exists(ckpt_path):
            raise FileNotFoundError(f"no checkpoint at {ckpt_path!r}")
        saved = read_checkpoint_meta(ckpt_path)
        for key in ("format", "config", "chunk", "queue_capacity",
                    "fp_capacity", "fp_index", "seed", "fp_highwater",
                    "pipeline", "obs_slots", "sort_free", "deferred"):
            have = saved.get(key, False if key in ("pipeline", "sort_free",
                                                   "deferred")
                             else 0 if key == "obs_slots" else None)
            if have != meta[key]:
                raise ValueError(f"checkpoint {key} mismatch: "
                                 f"{have!r} != {meta[key]!r}")
    init_fn, _, step_fn = make_engine(
        cfg, chunk, queue_capacity, fp_capacity, pipeline=pipeline,
        obs_slots=obs_slots, sort_free=sort_free, deferred=deferred,
        device=device, fp_index=fp_index)
    segment = make_segment(step_fn, ckpt_every)
    template = init_fn()
    t0 = time.time()
    carry = template
    if resume:
        _, carry = load_checkpoint(ckpt_path, template, cfg)
    segments = 0
    while not carry_done(carry):
        if max_segments is not None and segments >= max_segments:
            break
        carry = segment(carry)
        segments += 1
        if ckpt_path is not None:
            save_checkpoint(ckpt_path, carry, meta, cfg=cfg)
        if on_progress is not None and not carry_done(carry):
            h = read_bundle(carry)
            on_progress(int(carry.depth), int(carry.generated), h.distinct,
                        h.level_n - h.qhead + h.next_n + h.st_n)
    wall = time.time() - t0
    from .fpset import fpset_actual_collision

    return result_from_carry(carry, wall, iterations=segments)._replace(
        actual_fp_collision=fpset_actual_collision(carry.fps))
