"""The run supervisor: self-healing runs of the single-device and the
sharded engine (port of jaxtlc/resil/supervisor.py).

It wraps the segmented engine (segments of ``ckpt_every`` step bodies,
bfs.make_segment) in a loop that turns capacity halts, preemption and
injected transient faults into events:

* **The capacity ladder.**  A VIOL_FPSET_FULL / VIOL_QUEUE_FULL halt
  walks rungs until one holds: (1) regrow - double the resource after a
  probe allocation on the carry's device confirms it fits, migrate the
  last good carry (resil.regrow) and replay the segment; (2) the host
  spill tier (engine.spill) for a full fingerprint table; (3) halve the
  chunk; (4) checkpoint and return exhausted=True (the CLI exits 75).
* **Preemption.**  SIGTERM / SIGINT end the current segment, write a
  final checkpoint generation and return interrupted=True (exit 75).
* **Retry.**  A TransientFault restarts the segment from the last good
  carry with exponential backoff and seeded jitter.  An allocation
  failure (MemoryError, torch.cuda.OutOfMemoryError) is classified as
  exhaustion and goes to the ladder.  Nothing else is caught: a kernel
  that fails to build or launch ends the run, and no rung ever swaps a
  kernel for its plain version.
* **Checkpoints.**  CRC-manifested, generation-numbered files in the
  reference's format (engine.checkpoint); a spilling run pairs each with
  its host-store file, and ``resume`` loads the newest intact pair,
  rebuilding the engine with the geometry the checkpoint records.
* **Coverage.**  With the device coverage plane, each segment fence
  journals one ``coverage`` event of per-site deltas, and a run that goes
  ``COVERAGE_SAT_LEVELS`` BFS levels without a new site journals the
  saturation event once; a resumed run's cursor starts at the restored
  totals, so the stream continues across -recover.
* **Phases.**  Each segment fence ends with two ``phase`` events of scope
  "segment" (obs.phases): the device wall (dispatch to fence) and the
  host readback wall (progress, ring and coverage reads).  With
  ``phase_timing`` (``-phase-timing``) an unpipelined single-device run
  steps through obs.phases.PhasedRuntime instead - the same stage
  closures, fenced between the halves - and each fence also journals the
  measured per-level expand/commit walls (scope "level").
* **The pipelined engine** (``pipeline=True``) runs the same ladder
  without the spill and chunk-shrink rungs: its staged block has no spill
  composition and cannot be re-seated at another pop width.
* **The sharded engine** (``ShardedAdapter``, ``check_sharded_supervised``;
  capacities per shard) also regrows its route buckets (VIOL_ROUTE_OVERFLOW
  doubles route_factor).  Unpipelined, its spill rung is the sharded
  spill runtime (engine.sharded.ShardedSpillRuntime); it has no
  chunk-shrink rung, as in the reference.

The engine updates its carry in place, so every segment runs on a copy
of the last good carry (bfs.clone_carry): retries and regrows replay
from a carry no failed attempt has touched.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import time
from typing import Callable, NamedTuple, Optional

import torch

from ..engine import checkpoint as ckpt
from ..engine.backend import kubeapi_backend
from ..engine.reduce import reduce_flags
from ..engine.bfs import (
    FP_HIGHWATER,
    OK,
    VIOL_SLOT_OVERFLOW,
    VIOLATION_NAMES,
    CheckResult,
    carry_done,
    clone_carry,
    cov_totals,
    make_backend_engine,
    make_segment,
    read_bundle,
    resolve_deferred,
    resolve_device,
    resolve_sort_free,
    result_from_carry,
)
from ..engine.fingerprint import DEFAULT_FP_INDEX, DEFAULT_SEED
from ..engine.spill import SpillWriteError
from ..obs.coverage import coverage_delta_event
from ..obs.phases import segment_phases
from .faults import FaultInjector, FaultPlan, TransientFault
from .regrow import GROWABLE, grown, migrate_engine_carry

# what the segment loop catches; each caught error is classified first
_CAUGHT = (TransientFault, MemoryError, torch.cuda.OutOfMemoryError)

# status markers of an allocation failure in an error's text
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Resource exhausted",
                "Out of memory", "out of memory", "Allocation failure")


def is_resource_exhausted(e: BaseException) -> bool:
    """True for a deterministic allocation failure (the ladder takes
    it), False for the transient class (retried with backoff)."""
    if isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(e)
    return any(m in msg for m in _OOM_MARKERS)


# exit code of an interrupted or capacity-exhausted run with a final
# checkpoint (EX_TEMPFAIL: resume me)
EXIT_INTERRUPTED = 75

# the chunk-shrink floor of the ladder's rung 3
MIN_CHUNK = 64

# coverage saturation: after this many BFS levels with no new coverage
# site, one `coverage` event with saturated=true (the reference's default
# coverage_sat_levels)
COVERAGE_SAT_LEVELS = 8


class SlotOverflowError(RuntimeError):
    """Codec slot overflow: a field exceeded its bit width.  Regrow cannot
    widen it; the supervisor checkpoints the last good carry and raises
    this."""

    def __init__(self, ckpt_path: Optional[str]):
        self.ckpt_path = ckpt_path
        hint = (
            f"; last good carry checkpointed at {ckpt_path!r} - after "
            "raising the bounds, restart (a recompiled codec changes the "
            "state encoding, so the checkpoint is diagnostic only)"
            if ckpt_path else "; re-run with -checkpoint to keep a snapshot"
        )
        super().__init__(
            "codec slot overflow: raise the ModelConfig bounds and "
            "recompile - auto-grow cannot widen compiled bit fields" + hint)


@dataclasses.dataclass
class SupervisorOptions:
    """Knobs of one supervised run (CLI: -auto-grow/-no-auto-grow,
    -max-regrow, -retry, -checkpoint, -checkpointevery, -recover, -spill,
    -faults)."""

    auto_grow: bool = True
    max_regrow: int = 8
    retries: int = 2
    backoff_base_s: float = 0.5
    backoff_cap_s: float = 30.0
    ckpt_path: Optional[str] = None
    ckpt_every: int = 256
    keep_generations: int = 2
    resume: bool = False
    faults: Optional[FaultPlan] = None
    # host spill tier policy: "auto" turns it on when an fpset regrow is
    # denied (or max_regrow is reached); "on" prefers it at the first
    # fpset saturation; "off" removes the rung
    spill: str = "auto"
    spill_capacity: int = 1 << 15
    min_chunk: int = MIN_CHUNK
    # measured per-level expand/commit walls through the host-fenced step
    # loop (obs.phases.PhasedRuntime), where the adapter supports it
    phase_timing: bool = False
    # read the final fingerprint table back to the host on a clean,
    # unspilled single-device verdict (CheckResult.fp_table: the artifact
    # cache's reachable-set source; the adapter's CAPTURES_FPS gates it)
    capture_fps: bool = False
    # programmatic drain request (jaxtlc/resil/supervisor.py:209-216): a
    # threading.Event twin of _SignalCatcher for in-process preemption -
    # the serve scheduler sets it to preempt ONE supervised job (deadline,
    # priority, cancel) without signalling the server.  Checked at the
    # same segment boundaries as sig.hit, so a drained run rides the same
    # checkpoint and exit-75 path and its -recover resume is the
    # uninterrupted run
    drain: Optional[object] = None
    # on_event(kind, info): checkpoint / ckpt_write_failed / ckpt_fallback
    # / recovery / regrow / retry / interrupted / progress / level /
    # coverage / phase / segment / spill / degrade / exhausted / final
    on_event: Optional[Callable[[str, dict], None]] = None


class SupervisedResult(NamedTuple):
    result: CheckResult
    params: dict  # final engine geometry (auto-grown values included)
    regrows: int
    retries: int
    interrupted: bool
    segments: int
    ckpt_writes: int
    ckpt_write_s: float
    regrow_s: float
    exhausted: bool = False
    spilled: int = 0  # fingerprints in the host spill store
    spill_flushes: int = 0
    spill_hits: int = 0  # candidates the host tier vetoed
    shrinks: int = 0
    spill_store_s: float = 0.0  # seconds in the host store


class _SignalCatcher:
    """Record SIGTERM / SIGINT instead of dying, so the loop can drain
    the segment and checkpoint; restores the handlers on exit (a no-op
    off the main thread)."""

    SIGNUMS = (signal.SIGTERM, signal.SIGINT)

    def __enter__(self):
        self.hit = None
        self._saved = {}
        for s in self.SIGNUMS:
            try:
                self._saved[s] = signal.signal(
                    s, lambda signum, frame: self._record(signum))
            except ValueError:  # not the main thread
                pass
        return self

    def _record(self, signum):
        self.hit = signum

    def __exit__(self, *exc):
        for s, h in self._saved.items():
            signal.signal(s, h)
        return False


def _sync(carry) -> None:
    if carry.queue.is_cuda:
        torch.cuda.synchronize(carry.queue.device)


class SingleDeviceAdapter:
    """The supervision seam over the single-device segmented engine on
    the KubeAPI backend (built once, with the coverage plane when
    coverage=True; the pipelined body when pipeline=True).  Growable:
    queue_capacity, fp_capacity."""

    kind = "single"
    CAPTURES_FPS = True
    GEOM_KEYS = ("queue_capacity", "fp_capacity")
    FIXED_KEYS = ("format", "config", "chunk", "fp_index", "seed",
                  "fp_highwater", "pipeline", "obs_slots", "coverage",
                  "sort_free", "deferred", "symmetry", "por")

    def __init__(self, cfg, chunk: int = 1024, obs_slots: int = 0,
                 sort_free: bool = None, deferred: bool = None,
                 device=None, fp_index: int = DEFAULT_FP_INDEX,
                 coverage: bool = False, pipeline: bool = False,
                 backend=None, meta_config: dict = None):
        self.cfg = cfg
        # one backend for the engine, the spill runtime, the site table and
        # the meta's `coverage` flag: KubeAPI's for a ModelConfig, else the
        # given one (a struct spec's, with its meta_config stanza)
        self.backend = (backend if backend is not None
                        else kubeapi_backend(cfg, coverage=coverage))
        self.meta_config = meta_config
        self.coverage = self.backend.coverage is not None
        # the reduction flags the engine runs (checkpoint meta keys): a
        # resume across a -symmetry / -por change mismatches loudly
        self.symmetry, self.por = reduce_flags(self.backend)
        self.chunk = chunk
        self.pipeline = bool(pipeline)
        self.fp_index = fp_index
        # resolved once against the initial chunk: a ladder chunk shrink
        # keeps the modes (and the meta stays consistent across resumes)
        self.sort_free = resolve_sort_free(sort_free, chunk)
        self.deferred = resolve_deferred(deferred, chunk)
        self.fp_highwater = FP_HIGHWATER  # the engine's fixed halt load
        self.obs_slots = obs_slots
        self.device = resolve_device(device)

    def build(self, params: dict, ckpt_every: int):
        """(template carry, segment function) for geometry `params`."""
        init_fn, _, step_fn = make_backend_engine(
            self.backend, self.chunk, params["queue_capacity"],
            params["fp_capacity"], pipeline=self.pipeline,
            obs_slots=self.obs_slots, sort_free=self.sort_free,
            deferred=self.deferred, device=self.device,
            fp_index=self.fp_index)
        return init_fn(), make_segment(step_fn, ckpt_every)

    def meta(self, params: dict) -> dict:
        return ckpt._meta(
            self.cfg, meta_config=self.meta_config, chunk=self.chunk,
            fp_index=self.fp_index,
            seed=DEFAULT_SEED, fp_highwater=self.fp_highwater,
            pipeline=self.pipeline, obs_slots=self.obs_slots,
            coverage=self.coverage,
            sort_free=self.sort_free, deferred=self.deferred,
            symmetry=self.symmetry, por=self.por, **params)

    def viol(self, carry) -> int:
        return read_bundle(carry).viol

    def done(self, carry) -> bool:
        return carry_done(carry)

    def cov_sites(self):
        """The coverage plane's site table (None when coverage is off)."""
        plane = self.backend.coverage
        return plane.sites if plane is not None else None

    def obs_rows(self, carry, since: int, params: dict):
        from ..engine.bfs import obs_rows

        return obs_rows(carry, since=since,
                        fp_capacity=params["fp_capacity"])

    def progress(self, carry):
        # a pipelined carry's staged block counts as queued work
        h = read_bundle(carry)
        return (int(carry.depth), int(carry.generated), h.distinct,
                h.level_n - h.qhead + h.next_n + h.st_n)

    def migrate(self, carry, old_params: dict, new_params: dict):
        return migrate_engine_carry(carry, old_params, new_params)

    def supports_spill(self) -> bool:
        # the spill runtime runs the unpipelined stages of any backend; a
        # pipelined carry's staged block has no spill composition (the
        # ladder degrades those runs to the next rung instead)
        return not self.pipeline

    def build_spill(self, params: dict, store, on_event=None,
                    spill_write_hook=None):
        """A SpillRuntime over this adapter's geometry."""
        from ..engine.spill import SpillRuntime

        return SpillRuntime(
            self.backend, self.chunk, params["queue_capacity"],
            params["fp_capacity"], fp_highwater=self.fp_highwater,
            obs_slots=self.obs_slots, sort_free=self.sort_free,
            deferred=self.deferred, store=store, on_event=on_event,
            spill_write_hook=spill_write_hook, device=self.device,
            fp_index=self.fp_index)

    def supports_phase_timing(self) -> bool:
        # fencing the pipelined body would serialize the overlap it exists
        # to create; the segment-scope rows still apply there
        return not self.pipeline

    def build_phased(self, params: dict, ckpt_every: int, recorder):
        """(template, seg_fn) through obs.phases.PhasedRuntime: the
        host-fenced expand/commit step loop with measured per-level walls,
        the fused segment's carry step for step."""
        from ..obs.phases import PhasedRuntime

        rt = PhasedRuntime(
            self.backend, self.chunk, params["queue_capacity"],
            params["fp_capacity"], obs_slots=self.obs_slots,
            sort_free=self.sort_free, deferred=self.deferred,
            device=self.device, fp_index=self.fp_index, recorder=recorder)
        return rt.init_fn(), rt.segment_fn(ckpt_every)

    def can_shrink(self, floor: int = MIN_CHUNK) -> bool:
        # the staged block is chunk-shaped: a pipelined carry is never
        # re-seated at another pop width
        return not self.pipeline and self.chunk // 2 >= floor

    def reseat_chunk(self, carry, params: dict):
        """Halve the pop width (rung 3): re-seat the queue padding."""
        new_chunk = self.chunk // 2
        migrated = migrate_engine_carry(carry, params, params,
                                        new_chunk=new_chunk)
        self.chunk = new_chunk
        return migrated

    def result(self, carry, wall: float, segments: int,
               params: dict) -> CheckResult:
        from ..engine.fpset import fpset_actual_collision

        return result_from_carry(
            carry, wall, iterations=segments,
            fp_capacity=params["fp_capacity"], sites=self.cov_sites(),
            labels=self.backend.labels, viol_names=self.backend.viol_names,
        )._replace(actual_fp_collision=fpset_actual_collision(carry.fps))


class ShardedAdapter:
    """The supervision seam over the sharded engine (D shards in one
    process, on the card unless `device` says otherwise; the reference's
    ShardedAdapter, jaxtlc/resil/supervisor.py:515-650).  Capacities are
    PER SHARD; growable: queue_capacity, fp_capacity, route_factor.  The
    spill tier when unpipelined (ShardedSpillRuntime) and no chunk shrink,
    as in the reference."""

    kind = "sharded"
    GEOM_KEYS = ("queue_capacity", "fp_capacity", "route_factor")
    FIXED_KEYS = ("format", "config", "devices", "fp_highwater",
                  "pipeline", "obs_slots", "coverage", "sort_free",
                  "deferred", "symmetry", "por")

    def __init__(self, cfg, n_shards: int, chunk: int = 512,
                 meta_config: dict = None, pipeline: bool = False,
                 obs_slots: int = 0, coverage: bool = False,
                 sort_free: bool = None, deferred: bool = None, device=None,
                 fp_index: int = DEFAULT_FP_INDEX, backend=None):
        from ..engine.sharded import ShardMesh

        self.cfg = cfg
        self.chunk = chunk
        self.sort_free = resolve_sort_free(sort_free, chunk)
        self.deferred = resolve_deferred(deferred, chunk)
        # KubeAPI's backend for a ModelConfig, else the given one (a struct
        # spec's, with its meta_config stanza)
        self.backend = (backend if backend is not None
                        else kubeapi_backend(cfg, coverage=coverage))
        self.coverage = self.backend.coverage is not None
        self.symmetry, self.por = reduce_flags(self.backend)
        self.meta_config = meta_config
        self.fp_highwater = FP_HIGHWATER
        self.pipeline = bool(pipeline)
        self.obs_slots = obs_slots
        self.fp_index = fp_index
        self.device = resolve_device(device)
        self.mesh = ShardMesh(n_shards, self.device)

    def build(self, params: dict, ckpt_every: int):
        from ..engine.sharded import make_sharded_engine

        init_fn, seg_fn = make_sharded_engine(
            self.cfg, self.mesh, self.chunk, params["queue_capacity"],
            params["fp_capacity"], fp_index=self.fp_index,
            route_factor=params["route_factor"], segment=ckpt_every,
            backend=self.backend, fp_highwater=self.fp_highwater,
            pipeline=self.pipeline, obs_slots=self.obs_slots,
            sort_free=self.sort_free, deferred=self.deferred)
        return init_fn(), seg_fn

    def meta(self, params: dict) -> dict:
        return ckpt._meta(
            self.cfg, meta_config=self.meta_config, chunk=self.chunk,
            devices=self.mesh.n_shards, fp_highwater=self.fp_highwater,
            pipeline=self.pipeline, obs_slots=self.obs_slots,
            coverage=self.coverage, sort_free=self.sort_free,
            deferred=self.deferred, symmetry=self.symmetry, por=self.por,
            **params)

    def cov_sites(self):
        plane = self.backend.coverage
        return plane.sites if plane is not None else None

    def viol(self, carry) -> int:
        from ..engine.sharded import read_bundle as shard_bundle

        return shard_bundle(carry).viol

    def done(self, carry) -> bool:
        from ..engine.sharded import carry_done as shard_done

        return shard_done(carry)

    def progress(self, carry):
        from ..engine.sharded import result_from_shard_carry

        r = result_from_shard_carry(carry, 0.0, labels=self.backend.labels)
        return r.depth, r.generated, r.distinct, r.queue_left

    def obs_rows(self, carry, since: int, params: dict):
        from ..engine.sharded import obs_rows_sharded

        return obs_rows_sharded(
            carry, since=since,
            fp_capacity_total=params["fp_capacity"] * self.mesh.n_shards)

    def supports_spill(self) -> bool:
        # the spill runtime runs the unpipelined halves of any backend
        # (K1 and K7, or K21 and K18 on received rows); a pipelined
        # carry's pending verdicts have no spill composition
        return not self.pipeline

    def build_spill(self, params: dict, store, on_event=None,
                    spill_write_hook=None):
        """A ShardedSpillRuntime over this adapter's backend and geometry."""
        from ..engine.sharded import ShardedSpillRuntime

        return ShardedSpillRuntime(
            self.cfg, self.mesh, self.chunk, params["queue_capacity"],
            params["fp_capacity"], fp_index=self.fp_index,
            route_factor=params["route_factor"], backend=self.backend,
            fp_highwater=self.fp_highwater, obs_slots=self.obs_slots,
            sort_free=self.sort_free, deferred=self.deferred, store=store,
            on_event=on_event, spill_write_hook=spill_write_hook)

    def can_shrink(self, floor: int = MIN_CHUNK) -> bool:
        return False

    def migrate(self, carry, old_params: dict, new_params: dict):
        from .regrow import migrate_shard_carry

        return migrate_shard_carry(carry, old_params, new_params)

    def result(self, carry, wall: float, segments: int,
               params: dict) -> CheckResult:
        from ..engine.sharded import result_from_shard_carry

        return result_from_shard_carry(
            carry, wall, iterations=segments, labels=self.backend.labels,
            viol_names=self.backend.viol_names,
            fp_capacity_total=params["fp_capacity"] * self.mesh.n_shards,
            sites=self.cov_sites())


def _params_from_meta(adapter, meta: dict, params: dict) -> dict:
    """Resume geometry: fixed keys must match what this process would
    write; growable keys are taken from the checkpoint."""
    want = adapter.meta(params)
    for key in adapter.FIXED_KEYS:
        have = meta.get(key, False if key in ("pipeline", "coverage",
                                              "sort_free", "deferred",
                                              "symmetry", "por")
                        else 0 if key == "obs_slots" else None)
        if have != want.get(key):
            raise ValueError(
                f"checkpoint {key} mismatch: {have!r} != {want.get(key)!r}")
    out = dict(params)
    for key in adapter.GEOM_KEYS:
        if key in meta:
            out[key] = meta[key]
    return out


def _emit(opts: SupervisorOptions, kind: str, **info) -> None:
    if opts.on_event is not None:
        opts.on_event(kind, info)


def _resume(adapter, params: dict, opts: SupervisorOptions,
            make_spill_runtime, build):
    """Load the newest verifiable checkpoint of the family ckpt_path
    (generations first, then the plain file), rebuilding the engine with
    the recorded geometry; a checkpoint whose meta records an active
    spill tier restores the paired host-store file too, and a torn or
    missing sibling fails the whole generation.  Returns (params,
    template, seg_fn, carry, path, spill_rt)."""
    from ..engine.spill import SpillStore, spill_sibling

    base = opts.ckpt_path
    cands = [p for _, p in reversed(ckpt.list_generations(base))]
    if os.path.exists(base):
        cands.append(base)
    if not cands:
        raise FileNotFoundError(f"no checkpoint at {base!r}")
    last_err = None
    for path in cands:
        try:
            meta = ckpt.read_checkpoint_meta(path)
        except ckpt.CheckpointCorruptError as e:
            last_err = e
            _emit(opts, "ckpt_fallback", path=path, error=str(e))
            continue
        new_params = _params_from_meta(adapter, meta, params)
        spill_rt = None
        if (meta.get("spill") or {}).get("active"):
            try:
                store = SpillStore.load(spill_sibling(path))
            except (ckpt.CheckpointCorruptError, OSError, KeyError) as e:
                last_err = e
                _emit(opts, "ckpt_fallback", path=path,
                      error=f"spill sibling: {e}")
                continue
            spill_rt = make_spill_runtime(new_params, store)
            template = spill_rt.init_fn()
            seg_fn = spill_rt.segment_fn(opts.ckpt_every)
        else:
            template, seg_fn = build(new_params)
        try:
            _, carry = ckpt.load_checkpoint(path, template, adapter.cfg,
                                            adapter.backend.cdc)
        except ckpt.CheckpointCorruptError as e:
            last_err = e
            _emit(opts, "ckpt_fallback", path=path, error=str(e))
            continue
        return new_params, template, seg_fn, carry, path, spill_rt
    raise FileNotFoundError(
        f"no intact checkpoint under {base!r} (newest failure: {last_err})")


def _probe_grow(resource: str, new_value, faults, device) -> Optional[str]:
    """The regrow allocation probe: allocate the doubled container's
    bytes on the carry's device (torch.empty) before migrating.  None
    when it fits, else the denial; the allocator's cache is emptied after
    a denial, so the next rung does not count on memory it lacks."""
    # route_factor: the buckets are too small to probe (the reference's)
    nbytes = {"fp_capacity": 8, "queue_capacity": 64,
              "route_factor": 0}.get(resource, 8) * int(new_value)
    dev = torch.device(device)
    try:
        faults.alloc_probe()
        buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        del buf
        return None
    except Exception as e:  # noqa: BLE001 - classified right below
        if not is_resource_exhausted(e):
            raise
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return str(e)


def supervise(adapter, params: dict,
              opts: SupervisorOptions = None) -> SupervisedResult:
    """Run an exhaustive check under supervision.  `params` holds the
    growable geometry (queue_capacity, fp_capacity).  With the spill tier
    active, a host-store snapshot is paired with every last good carry,
    so replays roll both tiers back together."""
    opts = opts or SupervisorOptions()
    faults = FaultInjector(opts.faults)
    rng = random.Random(0xC0FFEE)  # deterministic backoff jitter
    params = dict(params)
    regrows = retries_used = segments = ckpt_writes = shrinks = 0
    ckpt_write_s = regrow_s = 0.0
    interrupted = exhausted = False
    exhaust_resource = ""
    spill_rt = None
    good_store = None

    def emit_info(kind, info):
        _emit(opts, kind, **info)

    def make_spill_runtime(p, store):
        return adapter.build_spill(p, store, on_event=emit_info,
                                   spill_write_hook=faults.spill_write)

    # -phase-timing: measured per-level expand/commit walls through the
    # host-fenced step loop, where the adapter supports it (unpipelined
    # single-device); every run gets the segment-scope rows regardless
    phase_rec = None
    if (opts.phase_timing
            and callable(getattr(adapter, "build_phased", None))
            and adapter.supports_phase_timing()):
        from ..obs.phases import PhaseRecorder

        phase_rec = PhaseRecorder()

    def build_engine(p):
        if phase_rec is not None:
            return adapter.build_phased(p, opts.ckpt_every, phase_rec)
        return adapter.build(p, opts.ckpt_every)

    def rebuild(p):
        """(template, seg_fn) for geometry p in the current mode."""
        nonlocal spill_rt
        if spill_rt is not None:
            old = spill_rt
            spill_rt = make_spill_runtime(p, old.store)
            spill_rt.flushes = old.flushes
            spill_rt.probes = old.probes
            spill_rt.store_s = old.store_s
            return spill_rt.init_fn(), spill_rt.segment_fn(opts.ckpt_every)
        return build_engine(p)

    if opts.resume:
        if not opts.ckpt_path:
            raise ValueError("resume requires a checkpoint path")
        params, template, seg_fn, carry, path, spill_rt = _resume(
            adapter, params, opts, make_spill_runtime, build_engine)
        prog = adapter.progress(carry)
        _emit(opts, "recovery", path=path, depth=prog[0],
              generated=prog[1], distinct=prog[2], queue=prog[3])
    else:
        template, seg_fn = build_engine(params)
        carry = template
    t0 = time.time()

    def save(carry_to_save, label: str, store_snap=None):
        nonlocal ckpt_writes, ckpt_write_s
        if not opts.ckpt_path:
            return None
        faults.before_write()
        t = time.time()
        meta = adapter.meta(params)
        if spill_rt is not None and store_snap is not None:
            meta["spill"] = {"active": True, "count": int(store_snap.count),
                             "capacity": int(store_snap.table.shape[0])}
        path = ckpt.save_generation(opts.ckpt_path, carry_to_save, meta,
                                    keep=opts.keep_generations,
                                    cfg=adapter.cfg,
                                    codec=adapter.backend.cdc)
        heads = [(path, opts.ckpt_path)]
        if spill_rt is not None and store_snap is not None:
            from ..engine.spill import save_snapshot, spill_sibling

            save_snapshot(spill_sibling(path), store_snap)
            heads.append((path + ".spill", opts.ckpt_path + ".spill"))
        # the plain family head too (a hard link): -recover finds the
        # checkpoint under the path the user gave
        for src_path, head in heads:
            tmp = head + ".head.tmp"
            try:
                os.link(src_path, tmp)
                os.replace(tmp, head)
            except OSError:
                try:
                    import shutil

                    shutil.copyfile(src_path, tmp)
                    os.replace(tmp, head)
                except OSError:
                    pass
        ckpt_write_s += time.time() - t
        ckpt_writes += 1
        faults.after_write(path)
        _emit(opts, "checkpoint", path=path,
              seconds=round(time.time() - t, 3), label=label)
        return path

    good = carry
    if spill_rt is not None:
        good_store = spill_rt.store.snapshot()
    # ring rows below this cursor are journaled already (a resumed carry
    # starts past its restored history)
    _, obs_seen = adapter.obs_rows(carry, 0, params)
    # coverage cursor: the per-site totals journaled already.  A resumed
    # carry's restored totals are in the original journal, so they seed
    # it; a fresh run's first event carries the Init visits
    cov_sites = adapter.cov_sites()
    cov_seen = None
    cov_visited = cov_level = cov_last_new_level = 0
    cov_saturated = False
    if cov_sites is not None and opts.resume:
        cov_seen = cov_totals(carry)
        cov_visited = int((cov_seen > 0).sum())
    # the periodic checkpoint of a segment is written after the next
    # segment ran (the reference writes it while that segment is in
    # flight), so the events come in the reference's order
    pending_save = None

    def flush_save():
        nonlocal pending_save
        if pending_save is None:
            return
        c, snap = pending_save
        pending_save = None
        try:
            save(c, "periodic", store_snap=snap)
        except OSError as e:
            _emit(opts, "ckpt_write_failed", error=str(e))

    def rollback_store():
        if spill_rt is not None and good_store is not None:
            spill_rt.store.restore(good_store)

    drained = (lambda: opts.drain is not None and opts.drain.is_set())
    with _SignalCatcher() as sig:
        while not adapter.done(carry):
            if sig.hit is not None or drained():
                interrupted = True
                break

            attempt = 0
            oom = None
            spill_broken = None
            while True:
                try:
                    faults.segment_start(segments)
                    if phase_rec is not None:
                        # a replayed segment re-measures; timings of the
                        # failed attempt must not double-count
                        phase_rec.reset()
                    t_dispatch = time.time()
                    carry2 = seg_fn(clone_carry(good))
                    flush_save()
                    _sync(carry2)
                    t_fence = time.time()
                    break
                except SpillWriteError as e:
                    spill_broken = e
                    break
                except _CAUGHT as e:
                    if is_resource_exhausted(e):
                        oom = e
                        break
                    if attempt >= opts.retries:
                        raise
                    delay = min(opts.backoff_cap_s,
                                opts.backoff_base_s * (2 ** attempt)) * (
                        0.5 + rng.random())
                    _emit(opts, "retry", attempt=attempt + 1,
                          delay_s=round(delay, 3), error=str(e))
                    time.sleep(delay)
                    attempt += 1
                    retries_used += 1
                    if spill_rt is not None:
                        rollback_store()
                    elif opts.ckpt_path and ckpt.list_generations(
                            opts.ckpt_path):
                        try:
                            _, _, good = ckpt.load_latest_generation(
                                opts.ckpt_path, template, adapter.cfg,
                                adapter.backend.cdc)
                        except FileNotFoundError:
                            pass

            if spill_broken is not None:
                rollback_store()
                _emit(opts, "degrade", rung="halt", resource="spill",
                      action="checkpoint+exit", reason=str(spill_broken))
                exhausted = interrupted = True
                exhaust_resource = "spill"
                carry = good
                break

            if oom is not None:
                rollback_store()
                can = adapter.can_shrink(opts.min_chunk)
                _emit(opts, "degrade", rung="oom", resource="segment",
                      action="shrink" if can else "halt", reason=str(oom))
                if can:
                    old_chunk = adapter.chunk
                    good = adapter.reseat_chunk(good, params)
                    shrinks += 1
                    template, seg_fn = rebuild(params)
                    carry = good
                    _emit(opts, "degrade", rung="shrink", resource="chunk",
                          action=f"{old_chunk}->{adapter.chunk}",
                          reason=str(oom))
                    continue
                exhausted = interrupted = True
                exhaust_resource = "segment"
                carry = good
                break

            v = adapter.viol(carry2)
            if v in GROWABLE:
                resource = GROWABLE[v]
                if not opts.auto_grow:
                    carry = carry2  # the explicit opt-out reports the halt
                    break
                rollback_store()
                denial = None
                spill_first = (resource == "fp_capacity"
                               and opts.spill == "on" and spill_rt is None
                               and adapter.supports_spill())
                # ---- rung 1: probed regrow ---------------------------
                if not spill_first:
                    if regrows >= opts.max_regrow:
                        denial = f"max-regrow ({opts.max_regrow}) reached"
                    else:
                        new_params = grown(params, resource)
                        denial = _probe_grow(resource,
                                             new_params[resource], faults,
                                             adapter.device)
                    if denial is None:
                        t = time.time()
                        migrated = adapter.migrate(good, params, new_params)
                        template, seg_fn = rebuild(new_params)
                        regrow_s += time.time() - t
                        regrows += 1
                        _emit(opts, "regrow", resource=resource,
                              old=params[resource], new=new_params[resource],
                              violation=VIOLATION_NAMES.get(v, str(v)),
                              regrows=regrows,
                              seconds=round(time.time() - t, 3))
                        params = new_params
                        good = migrated
                        carry = migrated
                        continue  # replay inside the new geometry
                    _emit(opts, "degrade", rung="regrow", resource=resource,
                          action="denied", reason=denial)
                # ---- rung 2: host spill tier (fpset only) ------------
                if (resource == "fp_capacity" and opts.spill != "off"
                        and spill_rt is None and adapter.supports_spill()):
                    from ..engine.spill import SpillStore

                    spill_rt = make_spill_runtime(
                        params, SpillStore(opts.spill_capacity))
                    template = spill_rt.init_fn()
                    seg_fn = spill_rt.segment_fn(opts.ckpt_every)
                    good = spill_rt.adopt(good)
                    carry = good
                    good_store = spill_rt.store.snapshot()
                    _emit(opts, "degrade", rung="spill", resource=resource,
                          action="activate",
                          reason=denial or "spill-first policy (-spill)")
                    prog = adapter.progress(good)
                    _emit(opts, "spill", phase="activate", resident=prog[2],
                          spilled=0, capacity=spill_rt.store.capacity,
                          hits=0, probes=0)
                    continue  # replay through the two-tier dedup
                # ---- rung 3: chunk shrink ----------------------------
                if adapter.can_shrink(opts.min_chunk):
                    old_chunk = adapter.chunk
                    good = adapter.reseat_chunk(good, params)
                    shrinks += 1
                    template, seg_fn = rebuild(params)
                    carry = good
                    _emit(opts, "degrade", rung="shrink", resource="chunk",
                          action=f"{old_chunk}->{adapter.chunk}",
                          reason=denial or "capacity ladder")
                    continue
                # ---- rung 4: checkpoint + exit 75 --------------------
                _emit(opts, "degrade", rung="halt", resource=resource,
                      action="checkpoint+exit",
                      reason=denial or "no ladder rung applicable")
                exhausted = interrupted = True
                exhaust_resource = resource
                carry = good
                break

            if v == VIOL_SLOT_OVERFLOW:
                path = None
                try:
                    path = save(good, "slot-overflow", store_snap=good_store)
                except OSError:
                    pass
                raise SlotOverflowError(path)

            carry = carry2
            good = carry2
            if spill_rt is not None:
                good_store = spill_rt.store.snapshot()
            segments += 1
            _emit(opts, "segment", index=segments - 1,
                  t_dispatch=t_dispatch, t_fence=t_fence,
                  wall_s=round(t_fence - t_dispatch, 6))
            if opts.ckpt_path:
                pending_save = (good, good_store)
            t_readback = time.time()
            if adapter.viol(carry) == OK and not adapter.done(carry):
                d, g, di, q = adapter.progress(carry)
                _emit(opts, "progress", depth=d, generated=g, distinct=di,
                      queue=q)
            rows, obs_seen = adapter.obs_rows(carry, obs_seen, params)
            for row in rows:
                _emit(opts, "level", **row)
            if rows:
                cov_level = max(cov_level, rows[-1]["level"])
            if cov_sites is not None:
                # the per-site deltas of this segment as one event, and
                # the saturation signal once a run stops visiting new sites
                totals = cov_totals(carry)
                payload = coverage_delta_event(cov_sites, totals, cov_seen)
                if payload is not None:
                    _emit(opts, "coverage", **payload)
                    cov_seen = totals
                    if payload["visited"] > cov_visited:
                        cov_visited = payload["visited"]
                        cov_last_new_level = cov_level
                if (not cov_saturated and cov_visited
                        and cov_level - cov_last_new_level
                        >= COVERAGE_SAT_LEVELS):
                    cov_saturated = True
                    _emit(opts, "coverage", visited=cov_visited,
                          sites=len(cov_sites), delta={}, saturated=True,
                          level=cov_level)
            # the fence-scope phase rows: the device wall and the host
            # readback wall just measured (host arithmetic only)
            for row in segment_phases(segments - 1, t_fence - t_dispatch,
                                      readback_s=time.time() - t_readback):
                _emit(opts, "phase", **row)
            if phase_rec is not None:
                for row in phase_rec.drain():
                    _emit(opts, "phase", **row)

        if interrupted:
            pending_save = None  # superseded by the final generation
            path = None
            try:
                path = save(good, "capacity-exhausted" if exhausted
                            else "final", store_snap=good_store)
            except OSError as e:
                _emit(opts, "ckpt_write_failed", error=str(e))
            d, g, di, q = adapter.progress(good)
            if exhausted:
                _emit(opts, "exhausted", resource=exhaust_resource,
                      path=path, generated=g, distinct=di, queue=q,
                      wall_s=round(time.time() - t0, 6))
            else:
                # drained: the programmatic drain request (the serve
                # scheduler's preemption) rather than a signal
                _emit(opts, "interrupted",
                      signum=int(sig.hit) if sig.hit else None, path=path,
                      generated=g, distinct=di, queue=q,
                      wall_s=round(time.time() - t0, 6), drained=drained())
        else:
            flush_save()

    wall = time.time() - t0
    result = adapter.result(carry, wall, segments, params)
    verdict = ("exhausted" if exhausted
               else "interrupted" if interrupted
               else "violation" if result.violation != OK else "ok")
    if (opts.capture_fps and verdict == "ok" and spill_rt is None
            and getattr(adapter, "CAPTURES_FPS", False)):
        # one host copy of the final table (a spilled run's device table
        # is partial), as jaxtlc/resil/supervisor.py:1273-1281
        result = result._replace(
            fp_table=carry.fps.table.cpu().numpy().view("uint32"))
    _emit(opts, "final", verdict=verdict, generated=result.generated,
          distinct=result.distinct, depth=result.depth,
          queue=result.queue_left, wall_s=round(wall, 6),
          interrupted=interrupted)
    spill_hits = 0
    if spill_rt is not None and carry.spill_hits is not None:
        spill_hits = int(carry.spill_hits.sum())  # over the shards
    return SupervisedResult(
        result=result, params=params, regrows=regrows, retries=retries_used,
        interrupted=interrupted, segments=segments, ckpt_writes=ckpt_writes,
        ckpt_write_s=round(ckpt_write_s, 6), regrow_s=round(regrow_s, 6),
        exhausted=exhausted,
        spilled=spill_rt.store.count if spill_rt is not None else 0,
        spill_flushes=spill_rt.flushes if spill_rt is not None else 0,
        spill_hits=spill_hits, shrinks=shrinks,
        spill_store_s=spill_rt.store_s if spill_rt is not None else 0.0,
    )


def check_supervised(
    cfg,
    chunk: int = 1024,
    queue_capacity: int = 1 << 15,
    fp_capacity: int = 1 << 20,
    obs_slots: int = 0,
    sort_free: bool = None,
    deferred: bool = None,
    opts: SupervisorOptions = None,
    device=None,
    fp_index: int = DEFAULT_FP_INDEX,
    coverage: bool = False,
    pipeline: bool = False,
    backend=None,
    meta_config: dict = None,
) -> SupervisedResult:
    """Supervised single-device exhaustive check of a KubeAPI
    configuration on `device` (None = the card); coverage=True carries the
    device coverage plane and journals its `coverage` events;
    pipeline=True runs the pipelined body.  With cfg None, `backend` (a
    struct spec's, struct.cache.get_backend) is checked instead and
    `meta_config` is the checkpoint's `config` stanza
    (struct.backend.struct_meta_config), as the reference's
    check_supervised(None, backend=..., meta_config=...)."""
    adapter = SingleDeviceAdapter(
        cfg, chunk=chunk, obs_slots=obs_slots, sort_free=sort_free,
        deferred=deferred, device=device, fp_index=fp_index,
        coverage=coverage, pipeline=pipeline, backend=backend,
        meta_config=meta_config)
    return supervise(
        adapter,
        {"queue_capacity": queue_capacity, "fp_capacity": fp_capacity},
        opts)



def check_sharded_supervised(
    cfg,
    n_shards: int,
    chunk: int = 512,
    queue_capacity: int = 1 << 14,
    fp_capacity: int = 1 << 18,
    route_factor: float = 2.0,
    meta_config: dict = None,
    pipeline: bool = False,
    obs_slots: int = 0,
    coverage: bool = False,
    sort_free: bool = None,
    deferred: bool = None,
    opts: SupervisorOptions = None,
    device=None,
    fp_index: int = DEFAULT_FP_INDEX,
    backend=None,
) -> SupervisedResult:
    """Supervised sharded exhaustive check over `n_shards` shards on
    `device` (None = the card); capacities PER SHARD
    (jaxtlc/resil/supervisor.py:1348).  `backend` (cfg None, with
    `meta_config`) runs a struct spec's backend instead of KubeAPI's."""
    adapter = ShardedAdapter(
        cfg, n_shards, chunk=chunk, meta_config=meta_config,
        pipeline=pipeline, obs_slots=obs_slots, coverage=coverage,
        sort_free=sort_free, deferred=deferred, device=device,
        fp_index=fp_index, backend=backend)
    return supervise(
        adapter,
        {"queue_capacity": queue_capacity, "fp_capacity": fp_capacity,
         "route_factor": route_factor},
        opts)
