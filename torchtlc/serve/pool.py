"""Warm engine pool: the serving tier's build amortizer (port of
jaxtlc/serve/pool.py).

The pool holds built engines - the struct backend, its emitted kernel
library loaded on the card, the engine closures - keyed by the struct-cache
memo key for plain engines (``struct.cache.engine_key``: spec digest x
canonical constants x geometry x modes x device) and by the constants-CLASS
key for sweep engines (``sweep.class_key``: the swept values drop out, so
one entry serves a whole config portfolio).  LRU eviction bounds a
long-lived process; hit / miss / eviction / build counters make the warm
path assertable.

The contract - **a warm submit builds and loads nothing** - is pinned by
``CompileMeter``.  The reference counts XLA compiles; the port has no XLA,
so its meter counts what a warm submit must not pay for
(kernels.build.METER): ``builds`` - compiler runs (nvcc, g++), lane
compiles (LaneCompiler) and emitted texts, and a pool miss's factory - and
``loads`` - shared-library loads.  A test (and ``python -m torchtlc.serve
--tiny``) asserts both deltas across a resubmit are zero.  The /pool JSON
names them ``builds`` and ``loads`` (the reference's ``xla_compiles`` is
read by no client: its tools call the function).

Every engine runs on the pool's one device (``device``: the card unless
the caller asks for the CPU).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..engine.fingerprint import DEFAULT_FP_INDEX, DEFAULT_SEED
from ..kernels import build as _build


class CompileMeter:
    """Process-wide build and load counter (kernels.build.METER, plus the
    pool's own misses); monotonic - assert on deltas."""

    _instance: Optional["CompileMeter"] = None

    def __init__(self):
        self.wall_s = 0.0

    @property
    def count(self) -> int:
        return _build.METER["builds"]

    @property
    def loads(self) -> int:
        return _build.METER["loads"]

    @classmethod
    def instance(cls) -> "CompileMeter":
        if cls._instance is None:
            cls._instance = CompileMeter()
        return cls._instance


def builds() -> int:
    """Monotonic count of builds this process performed."""
    return CompileMeter.instance().count


def loads() -> int:
    """Monotonic count of shared-library loads this process performed."""
    return CompileMeter.instance().loads


def _warm_library(backend, device) -> None:
    """Build and load a struct backend's emitted library now (on the card
    the first launch would), so the pool entry is warm when it returns."""
    if device.type == "cuda":
        from ..kernels import ops

        ops.load()
        ops.struct_lib(backend.kernels.prog)


class PoolEntry:
    """One warm engine: everything needed to run a job against it without
    building anything."""

    def __init__(self, key, kind: str, runner, meta: dict):
        self.key = key
        self.kind = kind  # "single" | "sweep" | "sim" | "infer"
        self.runner = runner
        self.meta = meta
        self.built_t = time.time()
        self.last_used = self.built_t
        self.uses = 0


class _SingleRunner:
    """One plain struct engine (one model, one config): built once, a
    fresh carry and a run per job."""

    def __init__(self, model, chunk, queue_capacity, fp_capacity,
                 fp_index, seed, check_deadlock, pipeline, obs_slots,
                 sort_free=None, deferred=None, device=None):
        from ..engine.bfs import FP_HIGHWATER
        from ..struct.cache import get_backend, get_engine

        self.model = model
        self.fp_capacity = fp_capacity
        self.device = device
        self.backend = get_backend(model, check_deadlock)
        self._init_fn, self._run_fn, _ = get_engine(
            model, chunk, queue_capacity, fp_capacity, fp_index, seed,
            FP_HIGHWATER, check_deadlock=check_deadlock,
            pipeline=pipeline, obs_slots=obs_slots, sort_free=sort_free,
            deferred=deferred, device=device,
        )
        _warm_library(self.backend, device)

    def run(self, capture_fps: bool = False):
        import torch

        from ..engine.bfs import result_from_carry
        from ..struct.backend import struct_viol_names

        carry = self._init_fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.time()
        out = self._run_fn(carry)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        result = result_from_carry(
            out, wall, iterations=self._run_fn.steps,
            fp_capacity=self.fp_capacity, labels=self.backend.labels,
            viol_names=struct_viol_names(self.model),
        )
        if capture_fps and result.violation == 0:
            # the artifact cache's reachable-set source: one host copy of
            # the final table, clean verdicts only
            result = result._replace(
                fp_table=out.fps.table.cpu().numpy().view("uint32"))
        return result


class EnginePool:
    """LRU pool of warm engines on one device (thread-safe: the HTTP
    handlers read stats while the scheduler thread builds and runs)."""

    def __init__(self, capacity: int = 8, sweep_width: int = None,
                 device=None):
        from ..engine.bfs import resolve_device
        from .sweep import DEFAULT_WIDTH

        self.capacity = max(1, int(capacity))
        self.sweep_width = sweep_width or DEFAULT_WIDTH
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            import torch

            # the worker thread binds this device by its index
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._entries: "OrderedDict[tuple, PoolEntry]" = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compiles = 0  # pool-level builds (one per miss)
        self.compile_wall_s = 0.0
        # --prewarm accounting: engines built ahead of traffic so the
        # FIRST submit rides the warm path
        self.prewarmed = 0
        self.prewarm_errors = 0
        self.prewarm_wall_s = 0.0
        CompileMeter.instance()

    # -- lookup ------------------------------------------------------------

    def _get_or_build(self, key, build, kind: str, meta: dict):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self.hits += 1
                hit.uses += 1
                hit.last_used = time.time()
                self._entries.move_to_end(key)
                return hit
            self.misses += 1
        # build OUTSIDE the lock: builds take seconds, and stats reads must
        # not block behind them
        t0 = time.time()
        _build.meter("builds")
        runner = build()
        wall = time.time() - t0
        entry = PoolEntry(key, kind, runner, meta)
        with self._lock:
            self.compiles += 1
            self.compile_wall_s += wall
            CompileMeter.instance().wall_s += wall
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
        return entry

    def get_single(
        self,
        model,
        chunk: int = 64,
        queue_capacity: int = 1 << 10,
        fp_capacity: int = 1 << 12,
        fp_index: int = DEFAULT_FP_INDEX,
        seed: int = DEFAULT_SEED,
        check_deadlock: bool = True,
        pipeline: bool = False,
        obs_slots: int = 0,
        sort_free: bool = None,
        deferred: bool = None,
    ) -> PoolEntry:
        """Warm plain engine for (model meaning, geometry) - keyed on the
        struct-cache memo key, so pool identity == memo identity."""
        from ..engine.bfs import FP_HIGHWATER
        from ..struct.cache import engine_key

        key = engine_key(
            model, chunk, queue_capacity, fp_capacity, fp_index, seed,
            FP_HIGHWATER, check_deadlock=check_deadlock,
            pipeline=pipeline, obs_slots=obs_slots, sort_free=sort_free,
            deferred=deferred, device=self.device,
        )
        return self._get_or_build(
            key,
            lambda: _SingleRunner(
                model, chunk, queue_capacity, fp_capacity, fp_index,
                seed, check_deadlock, pipeline, obs_slots,
                sort_free=sort_free, deferred=deferred, device=self.device,
            ),
            "single",
            dict(workload=model.root_name, chunk=chunk,
                 fp_capacity=fp_capacity),
        )

    def get_sweep(
        self,
        model,
        params: Dict[str, Tuple[int, int]],
        chunk: int = 64,
        queue_capacity: int = 1 << 10,
        fp_capacity: int = 1 << 12,
        fp_index: int = DEFAULT_FP_INDEX,
        seed: int = DEFAULT_SEED,
        check_deadlock: bool = True,
        sort_free: bool = None,
        deferred: bool = None,
    ) -> PoolEntry:
        """Warm constants-class sweep engine: one entry per CLASS (the
        swept values are runtime data, not key material)."""
        from ..engine.bfs import resolve_deferred, resolve_sort_free
        from .sweep import SweepEngine, class_key

        key = ("sweep", class_key(model, params), chunk, queue_capacity,
               fp_capacity, fp_index, seed, bool(check_deadlock),
               int(self.sweep_width), resolve_sort_free(sort_free, chunk),
               resolve_deferred(deferred, chunk), str(self.device))

        def build():
            eng = SweepEngine(
                model, params, chunk=chunk,
                queue_capacity=queue_capacity, fp_capacity=fp_capacity,
                fp_index=fp_index, seed=seed,
                check_deadlock=check_deadlock, width=self.sweep_width,
                sort_free=sort_free, deferred=deferred, device=self.device,
            )
            _warm_library(eng.backend, self.device)
            return eng

        return self._get_or_build(
            key, build, "sweep",
            dict(workload=model.root_name, chunk=chunk,
                 fp_capacity=fp_capacity,
                 params={c: list(d) for c, d in sorted(params.items())}),
        )

    def get_sim(
        self,
        model,
        params: Optional[Dict[str, Tuple[int, int]]] = None,
        walkers: int = 64,
        depth: int = 64,
        fp_capacity: int = 0,
        check_deadlock: bool = True,
    ) -> PoolEntry:
        """Warm random-walk engine for the smoke job class, keyed like the
        sweep classes: the SEED is run data (a batch lane), so one entry
        serves every per-commit smoke submit of a spec, and `params`
        (swept constant domains) keys a seeds-x-configs class as
        sweep.class_key does."""
        from ..sim.engine import SimEngine, sim_engine_key
        from .sweep import class_key

        if params:
            key = ("sim-sweep", class_key(model, params), int(walkers),
                   int(depth), int(fp_capacity), bool(check_deadlock),
                   int(self.sweep_width), str(self.device))
        else:
            key = sim_engine_key(
                model, walkers, depth, fp_capacity, check_deadlock,
                self.device,
            ) + (int(self.sweep_width),)

        def build():
            eng = SimEngine(
                model, params=params, walkers=walkers, depth=depth,
                fp_capacity=fp_capacity, check_deadlock=check_deadlock,
                width=self.sweep_width, device=self.device,
            )
            _warm_library(eng.backend, self.device)
            return eng

        return self._get_or_build(
            key, build, "sim",
            dict(workload=model.root_name, walkers=int(walkers),
                 depth=int(depth), fp_capacity=int(fp_capacity)),
        )

    def get_infer(
        self,
        model,
        budget: int = 64,
        walkers: int = 64,
        depth: int = 64,
        check_deadlock: bool = True,
        max_host_states: int = None,
    ) -> PoolEntry:
        """Warm inference engine for the infer job class: the candidate
        pool, the K29 / K30 library and exact evidence build once per
        (model, budget, walk geometry) class; the SEED is run data."""
        from ..infer.driver import InferEngine
        from ..infer.filter import DEFAULT_MAX_HOST_STATES
        from ..struct.cache import model_key

        if max_host_states is None:
            max_host_states = DEFAULT_MAX_HOST_STATES
        key = ("infer", model_key(model), int(budget), int(walkers),
               int(depth), bool(check_deadlock), int(max_host_states),
               str(self.device))
        return self._get_or_build(
            key,
            lambda: InferEngine(
                model, budget=budget, walkers=walkers, depth=depth,
                check_deadlock=check_deadlock,
                max_host_states=max_host_states, device=self.device,
            ),
            "infer",
            dict(workload=model.root_name, budget=int(budget),
                 walkers=int(walkers), depth=int(depth)),
        )

    # -- prewarm -----------------------------------------------------------

    def prewarm(self, specs, chunk: int = None, queue_capacity: int = None,
                fp_capacity: int = None) -> dict:
        """Build the listed models into the pool ahead of traffic.

        `specs` is a list of ``CFG`` paths (or ``SPEC:CFG`` pairs - the
        spec half is informational; the loader reads the sibling .tla
        from the cfg's directory anyway).  Geometry defaults to the
        scheduler's pooled-path defaults, so a prewarmed engine and a
        default submit land on the SAME pool key.  Errors are counted,
        never fatal - a bad prewarm entry must not stop the server."""
        from ..struct.loader import load
        from .scheduler import DEFAULT_CHUNK, DEFAULT_FPCAP, DEFAULT_QCAP

        chunk = chunk or DEFAULT_CHUNK
        queue_capacity = queue_capacity or DEFAULT_QCAP
        fp_capacity = fp_capacity or DEFAULT_FPCAP
        report = {"ok": [], "errors": []}
        for item in specs:
            cfg = item.split(":", 1)[1] if ":" in item else item
            t0 = time.time()
            try:
                model = load(cfg)
                self.get_single(model, chunk=chunk,
                                queue_capacity=queue_capacity,
                                fp_capacity=fp_capacity)
            except Exception as e:  # noqa: BLE001 - count, don't die
                with self._lock:
                    self.prewarm_errors += 1
                report["errors"].append(f"{cfg}: {e}")
                continue
            wall = time.time() - t0
            with self._lock:
                self.prewarmed += 1
                self.prewarm_wall_s += wall
            report["ok"].append(dict(cfg=cfg, workload=model.root_name,
                                     wall_s=round(wall, 3)))
        return report

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        """Pool + memo + build-meter counters (the /pool endpoint)."""
        from ..struct import cache as struct_cache

        meter = CompileMeter.instance()
        with self._lock:
            entries = [
                dict(kind=e.kind, uses=e.uses,
                     built_t=round(e.built_t, 3),
                     last_used=round(e.last_used, 3), **e.meta)
                for e in self._entries.values()
            ]
            return dict(
                capacity=self.capacity,
                size=len(self._entries),
                hits=self.hits,
                misses=self.misses,
                evictions=self.evictions,
                compiles=self.compiles,
                compile_wall_s=round(self.compile_wall_s, 6),
                prewarmed=self.prewarmed,
                prewarm_errors=self.prewarm_errors,
                prewarm_wall_s=round(self.prewarm_wall_s, 6),
                builds=meter.count,
                loads=meter.loads,
                build_wall_s=round(meter.wall_s, 6),
                build_meter="ok",
                device=str(self.device),
                sweep_width=self.sweep_width,
                memo=struct_cache.stats(),
                entries=entries,
            )

    def keys(self) -> List[tuple]:
        with self._lock:
            return list(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
