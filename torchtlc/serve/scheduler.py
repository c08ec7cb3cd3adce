"""Overload-safe job scheduler: many checks, one device, warm engines
(port of jaxtlc/serve/scheduler.py).

The queue discipline of the checking service (serve.server).  Jobs run
in submission order WITHIN a tenant; between tenants the dequeue is a
weighted round-robin at the highest ready priority, so one flooding
client cannot starve the rest.  The scheduler still looks ahead for
**compatible small jobs** - same spec text, same cfg, same geometry,
same sweep descriptor, constants differing only in the swept names -
and folds up to `pool.sweep_width` of them into ONE batched dispatch
through the constants-class sweep engine (kernels K32-K33; the smoke class
through K34-K35).  Everything else runs alone:

* small struct jobs without a sweep descriptor go through the pool's
  warm plain engine (warm submit = zero builds and zero library loads -
  the pool's assertable contract);
* large jobs (geometry above `large_fpcap`, or any resilience option:
  checkpoint/recover/sharded/liveness/faults) route through
  `api.run_check`, i.e. the resil supervisor with auto-regrow, the
  degradation ladder, and the full TLC transcript.

The overload control plane wraps that core:

* **Admission control** - the queue is bounded (`queue_bound`, plus an
  optional per-tenant `tenant_quota`); an over-limit submit raises
  AdmissionError carrying a Retry-After computed from the MEASURED
  drain rate (a deque of recent finish timestamps), which the HTTP
  layer maps to 429.
* **Deadlines** - a per-job `deadline_s` option is enforced by a
  reaper thread: queued jobs expire to the terminal `expired` state;
  a running supervised job is preempted through its programmatic
  drain Event (the in-process twin of the resil _SignalCatcher, so
  preempting ONE job never signals the whole server) and rides the
  existing checkpoint + exit-75 machinery.
* **Priorities** - a `priority` option; a high-priority arrival
  preempts a running lower-priority checkpointed heavy job, which is
  requeued as a `-recover` resume against its own journal (one
  continuous history; the resumed result is bit-for-bit the
  uninterrupted run's, the resume contract).  Pooled / sweep / smoke /
  infer dispatches run to completion - they are short by construction.
* **Retry + circuit breaker** - a dispatch that dies with a transient
  fault (resil's `_TRANSIENT` minus `is_resource_exhausted`) is
  requeued with deterministic-jitter backoff up to `job_retries`;
  specs that keep failing trip a breaker keyed on the spec digest
  (open -> cooldown -> half-open single probe -> closed), and
  submits against an open breaker land terminally `quarantined`.
* **Telemetry** - every decision (admit / reject / expire / preempt /
  requeue / retry / quarantine / cancel / dispatch) is a schema-v1
  `sched` event in the scheduler's own journal
  (`<root>/sched.journal.jsonl`), so /runs, /metrics, SSE and tlcstat
  render the control plane with the same machinery as any run.

Scheduling policy is host Python throughout - no new engine factories,
no new builds.  Only the worker thread dispatches, on the pool's one
device; the HTTP handler threads and the reaper never touch the card.

Every job writes its own journal into the server root - the /runs
registry and the job-scoped SSE stream (`/events?run=<job id>`) are the
existing obs.serve machinery reading those files.  A job that never
ran (expired while queued, canceled, quarantined) still gets a minimal
journal (run_start engine="sched" + final), so SSE followers terminate
on EVERY outcome.  Scheduler-run jobs journal in batched-fsync mode
(obs.journal fsync_every): job journals are high-rate telemetry, and a
crash loses at most a tail the scheduler re-reports in the job record
anyway.
"""

from __future__ import annotations

import hashlib
import io
import json
import math
import os
import random
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from ..resil.faults import FaultInjector, FaultPlan, TransientFault
from .pool import EnginePool

JOB_FSYNC_EVERY = 16  # batched-fsync journals for scheduler-run jobs
DEFAULT_LARGE_FPCAP = 1 << 16  # above this, a job is "large"

# the pooled path's default engine geometry - ALSO the geometry
# `--prewarm` compiles against, so a prewarmed engine and a default
# submit land on the same pool key
DEFAULT_CHUNK = 64
DEFAULT_QCAP = 1 << 10
DEFAULT_FPCAP = 1 << 12

# the smoke job class's default walk geometry (torchtlc.sim):
# cheap enough for "check something on every commit in 2 seconds",
# overridable per job via options walkers/depth
DEFAULT_SIM_WALKERS = 64
DEFAULT_SIM_DEPTH = 64

# overload-control defaults
DEFAULT_QUEUE_BOUND = 256  # admission bound on QUEUED jobs
DEFAULT_JOB_RETRIES = 2  # transient-fault redispatches per job
DEFAULT_BREAKER_THRESHOLD = 3  # digest failures before the breaker trips
DEFAULT_BREAKER_COOLDOWN_S = 30.0  # open -> half-open probe window
RETRY_BACKOFF_BASE_S = 0.05
RETRY_BACKOFF_CAP_S = 2.0
REAPER_PERIOD_S = 0.02  # deadline/preemption scan cadence

# job states a drain() no longer waits on
TERMINAL_STATES = ("done", "error", "expired", "canceled", "quarantined")

# job options forwarded to api.CheckRequest on the supervised path
_REQUEST_OPTIONS = (
    "workers", "frontend", "chunk", "qcap", "fpcap", "pipeline",
    "sortfree", "deferredinv", "symmetry", "por",
    "sharded", "checkpoint", "checkpointevery",
    "recover", "liveness",
    "fairness", "nodeadlock", "faults", "retry", "maxregrow", "spill",
    "obs", "obsslots", "coverage", "recheck", "noartifactcache",
    "simulate", "depth", "walkers", "simseed",
    "infer", "inferbudget",
)
_HEAVY_OPTIONS = ("checkpoint", "recover", "sharded", "liveness",
                  "faults", "coverage")
# scheduling-only options: they gate WHEN a job runs, never WHAT it
# computes, so they are invisible to batch folding and are never
# forwarded to the engine request
_SCHED_OPTIONS = ("priority", "deadline_s")


class JobError(ValueError):
    pass


class AdmissionError(JobError):
    """A submit refused by admission control (the HTTP layer's 429).
    `retry_after` is the drain-rate-derived client backoff hint in
    whole seconds."""

    def __init__(self, msg: str, retry_after: int):
        super().__init__(msg)
        self.retry_after = int(retry_after)


class DrainTimeout(RuntimeError):
    """drain() gave up waiting; `pending` names the unfinished jobs
    (the silent-False of the old API wedged callers invisibly)."""

    def __init__(self, msg: str, pending: List[str]):
        super().__init__(msg)
        self.pending = list(pending)


class Job:
    """One submitted check: spec + cfg text, optional constant
    overrides, optional sweep descriptor, engine options, and the
    scheduling envelope (tenant / priority / deadline).

    State machine: ``queued`` -> ``running`` -> one of the terminal
    states ``done`` | ``error`` | ``expired`` | ``canceled`` |
    ``quarantined``.  The last three are scheduler-terminal - the job
    never got, or never finished, an engine run: ``expired`` (deadline
    passed while queued, or a running checkpointed job drained at its
    deadline), ``canceled`` (DELETE /jobs/<id>), ``quarantined``
    (submitted against an open circuit breaker).  A running job can
    also return to ``queued`` (priority preemption requeues it as a
    -recover resume; transient dispatch faults requeue with backoff).
    """

    def __init__(self, spec: str, cfg: str, name: str = "",
                 constants: Optional[dict] = None,
                 sweep: Optional[dict] = None,
                 options: Optional[dict] = None,
                 tenant: Optional[str] = None):
        self.id = f"job-{uuid.uuid4().hex[:10]}"
        self.spec = spec
        self.cfg = cfg
        self.name = name or self.id
        self.constants = dict(constants or {})
        self.sweep = dict(sweep) if sweep else None
        self.options = dict(options or {})
        self.tenant = str(tenant) if tenant else "default"
        # queued | running | done | error | expired | canceled |
        # quarantined (the last three are scheduler-terminal: the job
        # never got, or never finished, an engine run)
        self.state = "queued"
        self.result: Optional[dict] = None
        self.error: Optional[str] = None
        self.engine = ""  # "sweep" | "pool" | "supervised" | "sched" ...
        self.submitted_t = time.time()
        self.started_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        # -- scheduling envelope ----------------------------------------
        try:
            self.priority = int(self.options.get("priority", 0))
        except (TypeError, ValueError):
            raise JobError("options.priority must be an integer")
        d = self.options.get("deadline_s")
        try:
            self.deadline_s = None if d is None else float(d)
        except (TypeError, ValueError):
            raise JobError("options.deadline_s must be a number")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise JobError("options.deadline_s must be positive")
        self.deadline_t = (None if self.deadline_s is None
                           else self.submitted_t + self.deadline_s)
        # breaker key: the spec IDENTITY, not the job (a quarantine is
        # about a spec that keeps failing, whoever submits it)
        self.digest = hashlib.sha256(
            (spec + "\n\x00\n" + cfg).encode()
        ).hexdigest()[:16]
        self.retries = 0  # transient-fault redispatches so far
        self.requeues = 0  # priority preemptions survived so far
        self.not_before = 0.0  # retry backoff gate (epoch seconds)
        self.preempt_reason: Optional[str] = None
        self.cancel_requested = False
        self._drain: Optional[threading.Event] = None
        self._preemptible = False

    # -- routing -----------------------------------------------------------

    def sweep_params(self) -> Dict[str, tuple]:
        """{const: (lo, hi)} from the job's sweep descriptor."""
        if not self.sweep:
            return {}
        c = self.sweep.get("const")
        if not c:
            raise JobError("sweep descriptor needs a 'const' name")
        if self.sweep.get("hi") is None:
            raise JobError("sweep descriptor needs a 'hi' domain bound")
        lo, hi = int(self.sweep.get("lo", 0)), int(self.sweep["hi"])
        return {c: (lo, hi)}

    def is_large(self, large_fpcap: int) -> bool:
        if any(self.options.get(k) for k in _HEAVY_OPTIONS):
            return True
        return int(self.options.get("fpcap", 1 << 12)) > large_fpcap

    def is_smoke(self) -> bool:
        """The simulation job class (options.simulate): random walks
        through the warm sim engine - the cheap per-commit check."""
        return bool(self.options.get("simulate"))

    def is_infer(self) -> bool:
        """The inference job class (options.infer): conjecture ->
        filter -> certify through the warm infer engine."""
        return bool(self.options.get("infer"))

    def batch_signature(self) -> str:
        """Jobs with equal signatures fold into one batched dispatch:
        identical spec/cfg/options/sweep, constants equal OUTSIDE the
        swept names (inside them is the batch axis).  Smoke jobs
        additionally drop `simseed` from the compared options - the
        seed is a batch lane, so one warm sim engine serves seeds x
        configs in one dispatch.  Infer jobs drop it too:
        the seed is run data against one warm infer engine.
        Scheduling-envelope options (priority, deadline_s) never enter
        the signature: they gate WHEN, not WHAT."""
        drop = set(_SCHED_OPTIONS)
        if self.is_smoke() or self.is_infer():
            drop.add("simseed")
        fixed = {k: v for k, v in sorted(self.constants.items())
                 if k not in self.sweep_params()}
        opts = {k: v for k, v in self.options.items() if k not in drop}
        blob = json.dumps(
            [self.spec, self.cfg, sorted(opts.items()),
             sorted((self.sweep or {}).items()), fixed],
            sort_keys=True,
        )
        return hashlib.sha256(blob.encode()).hexdigest()

    def summary(self) -> dict:
        return dict(
            id=self.id, name=self.name, state=self.state,
            engine=self.engine, sweep=self.sweep,
            constants=self.constants, options=self.options,
            tenant=self.tenant, priority=self.priority,
            deadline_s=self.deadline_s,
            retries=self.retries, requeues=self.requeues,
            submitted_t=round(self.submitted_t, 3),
            started_t=self.started_t and round(self.started_t, 3),
            finished_t=self.finished_t and round(self.finished_t, 3),
            result=self.result, error=self.error,
            journal=f"{self.id}.journal.jsonl",
        )


def _module_name(spec_text: str) -> str:
    for line in spec_text.splitlines():
        s = line.strip()
        if s.startswith("----") and "MODULE" in s:
            return s.split("MODULE", 1)[1].strip().strip("- ").split()[0]
    raise JobError("spec text has no ---- MODULE Name ---- header")


def _loader_constants(constants: dict) -> dict:
    """Job constants arrive as JSON, which has no set type: a list
    value is the JSON spelling of an MC.cfg set literal ({r1, r2}),
    which the loaders/evaluator represent as a frozenset."""
    return {k: frozenset(v) if isinstance(v, list) else v
            for k, v in constants.items()}


def _result_dict(r, engine: str, pool_hit: bool = None) -> dict:
    verdict = "ok" if r.violation == 0 else "violation"
    out = dict(
        verdict=verdict, generated=r.generated, distinct=r.distinct,
        depth=r.depth, queue=r.queue_left, violation=r.violation,
        violation_name=(None if r.violation == 0 else r.violation_name),
        action_generated=r.action_generated,
        action_distinct=r.action_distinct,
        wall_s=round(r.wall_s, 6), engine=engine,
    )
    if pool_hit is not None:
        out["pool_hit"] = pool_hit
    return out


class Scheduler:
    """The worker: owns the queue, the job registry, the pool, the
    per-job journals under `root`, and the overload control plane
    (admission, deadlines, priorities, retry/breaker, its own sched
    journal)."""

    def __init__(self, root: str, pool: Optional[EnginePool] = None,
                 large_fpcap: int = DEFAULT_LARGE_FPCAP,
                 queue_bound: int = DEFAULT_QUEUE_BOUND,
                 tenant_quota: Optional[int] = None,
                 tenant_weights: Optional[Dict[str, int]] = None,
                 job_retries: int = DEFAULT_JOB_RETRIES,
                 breaker_threshold: int = DEFAULT_BREAKER_THRESHOLD,
                 breaker_cooldown_s: float = DEFAULT_BREAKER_COOLDOWN_S,
                 faults=None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.pool = pool or EnginePool()
        self.large_fpcap = large_fpcap
        self.queue_bound = int(queue_bound)
        self.tenant_quota = (int(tenant_quota) if tenant_quota else None)
        self.tenant_weights = dict(tenant_weights or {})
        self.job_retries = int(job_retries)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        if isinstance(faults, str):
            faults = FaultPlan.parse(faults)
        self._injector = FaultInjector(faults) if faults else None
        self.jobs: "OrderedDict[str, Job]" = OrderedDict()
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._stop = False
        self._started_t = time.time()
        self.batches_run = 0
        self.batched_jobs = 0
        self.cache_hits = 0  # jobs answered from the artifact cache
        self._dispatches = 0
        # WRR state: the tenant cycle, each tenant repeated by weight
        self._rr: deque = deque()
        self._rr_tenants = set()
        # recent finish timestamps -> the measured drain rate behind
        # Retry-After (and /health)
        self._finished_ts: deque = deque(maxlen=32)
        # spec-digest circuit breakers:
        # digest -> {state, failures, opened_t, probe}
        self._breaker: Dict[str, dict] = {}
        self._counters = dict(admitted=0, rejected=0, expired=0,
                              canceled=0, quarantined=0, preempted=0,
                              requeued=0, retried=0)
        self._rng = random.Random(0xC0FFEE)  # deterministic jitter
        # the scheduler's own journal: every control-plane decision is
        # a schema-v1 `sched` event, rendered by the same /runs /
        # /metrics / SSE / tlcstat machinery as any run
        self._jlock = threading.Lock()
        from ..obs.journal import RunJournal

        self._sched = RunJournal(
            os.path.join(root, "sched.journal.jsonl"),
            fsync_every=JOB_FSYNC_EVERY,
        )
        self._sched.event(
            "run_start", version=_version(), workload="scheduler",
            engine="sched", device="host",
            params=dict(queue_bound=self.queue_bound,
                        tenant_quota=self.tenant_quota,
                        tenant_weights=self.tenant_weights,
                        job_retries=self.job_retries,
                        breaker_threshold=self.breaker_threshold,
                        breaker_cooldown_s=self.breaker_cooldown_s),
        )
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self._reaper = threading.Thread(target=self._reap, daemon=True)
        self._reaper.start()

    # -- telemetry ---------------------------------------------------------

    def _sched_event(self, action: str, job: Optional[Job],
                     **extra) -> None:
        """One control-plane decision into the sched journal.  Lock
        ordering is always _cond -> _jlock (never the reverse), so the
        call is safe under _cond.  A sick disk must not take down
        scheduling - OSErrors are swallowed; schema errors are bugs
        and stay loud."""
        with self._jlock:
            if self._sched is None:
                return
            try:
                self._sched.event("sched", action=action,
                                  job=(job.id if job else ""), **extra)
            except OSError:
                pass

    # -- submission --------------------------------------------------------

    def submit(self, spec: str, cfg: str, tenant: str = None,
               **kw) -> Job:
        job = Job(spec, cfg, tenant=tenant, **kw)
        if job.sweep:
            params = job.sweep_params()  # validates the descriptor
            missing = [c for c in params if c not in job.constants]
            if missing:
                raise JobError(
                    f"sweep job must pin its swept constants "
                    f"{missing} in 'constants'"
                )
        _module_name(job.spec)  # validates the module header
        quarantined = False
        with self._cond:
            now = time.time()
            br = self._breaker.get(job.digest)
            if br is not None:
                if (br["state"] == "open"
                        and now - br["opened_t"]
                        >= self.breaker_cooldown_s):
                    # cooldown elapsed: the next submit is the single
                    # half-open probe
                    br["state"] = "half_open"
                    br["probe"] = None
                if br["state"] == "open" or (
                        br["state"] == "half_open"
                        and br["probe"] is not None):
                    quarantined = True
                elif br["state"] == "half_open":
                    br["probe"] = job.id
            if quarantined:
                self.jobs[job.id] = job
            else:
                queued = len(self._queue)
                if queued >= self.queue_bound:
                    ra = self._retry_after_locked()
                    self._counters["rejected"] += 1
                    self._sched_event(
                        "reject", job, tenant=job.tenant,
                        reason="queue_bound", retry_after_s=ra,
                        queued=queued)
                    raise AdmissionError(
                        f"queue full ({queued}/{self.queue_bound}); "
                        f"retry after {ra}s", ra)
                if self.tenant_quota:
                    tq = sum(1 for jid in self._queue
                             if self.jobs[jid].tenant == job.tenant)
                    if tq >= self.tenant_quota:
                        ra = self._retry_after_locked()
                        self._counters["rejected"] += 1
                        self._sched_event(
                            "reject", job, tenant=job.tenant,
                            reason="tenant_quota", retry_after_s=ra,
                            queued=queued)
                        raise AdmissionError(
                            f"tenant {job.tenant!r} quota full "
                            f"({tq}/{self.tenant_quota}); retry after "
                            f"{ra}s", ra)
                self.jobs[job.id] = job
                self._queue.append(job.id)
                self._counters["admitted"] += 1
                self._sched_event(
                    "admit", job, tenant=job.tenant,
                    priority=job.priority, queued=len(self._queue))
                self._maybe_preempt_locked()
                self._cond.notify()
        if quarantined:
            self._finish_terminal(
                job, "quarantined",
                reason=f"circuit open for spec digest {job.digest}")
        return job

    def _retry_after_locked(self) -> int:
        """Retry-After from the MEASURED drain rate: how long until
        the backlog above the bound has drained, at the recent pace.
        With no completions to measure yet, a small flat hint."""
        rate = self._drain_rate_locked()
        if not rate:
            return 5
        excess = max(1, len(self._queue) - self.queue_bound + 1)
        return max(1, min(60, int(math.ceil(excess / rate))))

    def _drain_rate_locked(self) -> Optional[float]:
        ts = self._finished_ts
        if len(ts) < 2:
            return None
        window = time.time() - ts[0]
        if window <= 0:
            return None
        return len(ts) / window

    def get(self, job_id: str) -> Optional[Job]:
        with self._cond:
            return self.jobs.get(job_id)

    def list(self) -> List[dict]:
        with self._cond:
            return [j.summary() for j in self.jobs.values()]

    def cancel(self, job_id: str) -> Optional[Job]:
        """DELETE /jobs/<id>: a queued job flips straight to the
        terminal `canceled` state (minimal journal, SSE terminates);
        a running preemptible job routes through the programmatic
        drain (checkpoint + exit 75 -> canceled).  A running
        non-preemptible dispatch runs to completion - they are short
        by construction - with the request noted on the record."""
        to_finish = None
        with self._cond:
            job = self.jobs.get(job_id)
            if job is None:
                return None
            if job.state == "queued":
                try:
                    self._queue.remove(job.id)
                except ValueError:
                    pass
                job.cancel_requested = True
                to_finish = job
            elif job.state == "running":
                job.cancel_requested = True
                if (job._preemptible and job._drain is not None
                        and not job._drain.is_set()
                        and job.preempt_reason is None):
                    job.preempt_reason = "cancel"
                    job._drain.set()
        if to_finish is not None:
            self._finish_terminal(job, "canceled",
                                  reason="canceled by client")
        return job

    def stats(self) -> dict:
        with self._cond:
            states: Dict[str, int] = {}
            tenants: Dict[str, int] = {}
            for j in self.jobs.values():
                states[j.state] = states.get(j.state, 0) + 1
            for jid in self._queue:
                t = self.jobs[jid].tenant
                tenants[t] = tenants.get(t, 0) + 1
            rate = self._drain_rate_locked()
            return dict(jobs=len(self.jobs), queued=len(self._queue),
                        states=states, batches_run=self.batches_run,
                        batched_jobs=self.batched_jobs,
                        cache_hits=self.cache_hits,
                        large_fpcap=self.large_fpcap,
                        queue_bound=self.queue_bound,
                        tenant_quota=self.tenant_quota,
                        queued_by_tenant=tenants,
                        dispatches=self._dispatches,
                        drain_rate_per_s=(round(rate, 3)
                                          if rate else None),
                        sched=dict(self._counters),
                        breakers={d: dict(state=b["state"],
                                          failures=b["failures"])
                                  for d, b in self._breaker.items()})

    def health(self) -> dict:
        """GET /health: is the service keeping up?  `overloaded` once
        the queue crosses 80% of the admission bound (the operator's
        early warning; admission itself rejects at 100%)."""
        with self._cond:
            queued = len(self._queue)
            running = [j.id for j in self.jobs.values()
                       if j.state == "running"]
            rate = self._drain_rate_locked()
            open_breakers = sum(1 for b in self._breaker.values()
                                if b["state"] != "closed")
            status = ("overloaded"
                      if queued >= max(1, int(0.8 * self.queue_bound))
                      else "ok")
            return dict(status=status, queued=queued,
                        queue_bound=self.queue_bound, running=running,
                        drain_rate_per_s=(round(rate, 3)
                                          if rate else None),
                        open_breakers=open_breakers,
                        counters=dict(self._counters),
                        uptime_s=round(time.time() - self._started_t,
                                       3))

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until every submitted job reached a terminal state
        (tools/loadgen + tests).  Raises DrainTimeout naming the
        unfinished jobs on timeout - the old silent False wedged
        callers invisibly."""
        deadline = time.time() + timeout
        while True:
            with self._cond:
                pending = [j.id for j in self.jobs.values()
                           if j.state in ("queued", "running")]
            if not pending:
                return True
            if time.time() >= deadline:
                raise DrainTimeout(
                    f"drain timed out after {timeout}s; unfinished "
                    f"jobs: {pending}", pending)
            time.sleep(0.02)

    def shutdown(self) -> None:
        with self._cond:
            if self._stop:
                return
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=10)
        self._reaper.join(timeout=10)
        with self._jlock:
            if self._sched is not None:
                try:
                    self._sched.event(
                        "final", verdict="ok", generated=0, distinct=0,
                        depth=0, queue=0,
                        wall_s=round(time.time() - self._started_t, 6),
                        interrupted=False,
                        counters=dict(self._counters))
                except OSError:
                    pass
                self._sched.close()
                self._sched = None

    # -- the worker --------------------------------------------------------

    def _pick_locked(self) -> Optional[Job]:
        """Dequeue one job: weighted round-robin between tenants at
        the highest READY priority (retry backoff and deadlines gate
        readiness), FIFO within a tenant.  Returns None when nothing
        is ready (backoff gates can leave a non-empty queue idle)."""
        now = time.time()
        ready = [jid for jid in self._queue
                 if self.jobs[jid].not_before <= now
                 and (self.jobs[jid].deadline_t is None
                      or now < self.jobs[jid].deadline_t)]
        if not ready:
            return None
        top = max(self.jobs[jid].priority for jid in ready)
        by_tenant: Dict[str, str] = {}
        for jid in ready:
            j = self.jobs[jid]
            if j.priority == top and j.tenant not in by_tenant:
                by_tenant[j.tenant] = jid  # FIFO head per tenant
        for t in by_tenant:
            if t not in self._rr_tenants:
                w = max(1, int(self.tenant_weights.get(t, 1)))
                self._rr.extend([t] * w)
                self._rr_tenants.add(t)
        for _ in range(len(self._rr)):
            t = self._rr[0]
            self._rr.rotate(-1)
            if t in by_tenant:
                jid = by_tenant[t]
                self._queue.remove(jid)
                return self.jobs[jid]
        jid = ready[0]  # unreachable: every ready tenant is cycled
        self._queue.remove(jid)
        return self.jobs[jid]

    def _device_name(self) -> str:
        import torch

        dev = self.pool.device
        return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")

    def _loop(self) -> None:
        if self.pool.device.type == "cuda":
            import torch

            # the only thread that dispatches: every kernel of every job
            # goes to the pool's device, on its current stream
            torch.cuda.set_device(self.pool.device)
        while True:
            with self._cond:
                head = None
                while not self._stop:
                    head = self._pick_locked()
                    if head is not None:
                        break
                    # short wait while backoff gates tick, long idle
                    self._cond.wait(0.05 if self._queue else 0.5)
                if self._stop:
                    return
                now = time.time()
                batch = [head]
                if (head.sweep or head.is_smoke()
                        or head.is_infer()) \
                        and not head.is_large(self.large_fpcap):
                    # look ahead: fold READY queued jobs of the same
                    # class into this dispatch (FIFO among the folded;
                    # the skipped-over rest keeps its order)
                    sig = head.batch_signature()
                    width = self.pool.sweep_width
                    for jid in list(self._queue):
                        if len(batch) >= width:
                            break
                        cand = self.jobs[jid]
                        if (cand.not_before <= now
                                and cand.batch_signature() == sig):
                            self._queue.remove(jid)
                            batch.append(cand)
                for j in batch:
                    j.state = "running"
                    j.started_t = now
                    # the programmatic drain twin of _SignalCatcher:
                    # set -> this ONE job checkpoints and exits 75
                    j._drain = threading.Event()
                    j._preemptible = (
                        len(batch) == 1
                        and j.is_large(self.large_fpcap)
                        and bool(j.options.get("checkpoint"))
                    )
                self._dispatches += 1
                n = self._dispatches
            self._sched_event("dispatch", batch[0], batch=len(batch),
                              n=n)
            try:
                if self._injector is not None:
                    self._injector.dispatch(n)
                self._run_batch(batch)
            except Exception as e:  # a broken job must not kill the loop
                self._dispatch_failed(batch, e)

    def _retryable(self, e: BaseException) -> bool:
        """The resil taxonomy applied to a dead dispatch: transient
        faults (TransientFault) retry with backoff; deterministic
        RESOURCE_EXHAUSTED never does (the capacity ladder owns that
        class, and at this level the ladder already ran)."""
        from ..resil.supervisor import is_resource_exhausted

        if is_resource_exhausted(e):
            return False
        return isinstance(e, TransientFault)

    def _backoff_s(self, attempt: int) -> float:
        """Deterministic-jitter exponential backoff (seeded RNG: two
        runs of the same fault plan redispatch on the same clock)."""
        base = min(RETRY_BACKOFF_CAP_S,
                   RETRY_BACKOFF_BASE_S * (2 ** (attempt - 1)))
        return base * (0.5 + self._rng.random())

    def _dispatch_failed(self, batch: List[Job], e: Exception) -> None:
        """Classify a dead dispatch: transient faults requeue every
        affected job with backoff (their journals are rewritten by the
        retried run - RunJournal truncates, the SSE tail resets on
        shrink); anything else finalizes the jobs as errors and feeds
        the spec-digest breaker."""
        retryable = self._retryable(e)
        requeued, failed = [], []
        with self._cond:
            for j in batch:
                if j.state != "running":
                    continue
                if retryable and j.retries < self.job_retries:
                    j.retries += 1
                    delay = self._backoff_s(j.retries)
                    j.not_before = time.time() + delay
                    j.state = "queued"
                    j.started_t = None
                    j._drain = None
                    j._preemptible = False
                    self._queue.append(j.id)
                    self._counters["retried"] += 1
                    requeued.append((j, delay))
                else:
                    failed.append(j)
            if requeued:
                self._cond.notify()
        msg = f"{type(e).__name__}: {e}"
        for j, delay in requeued:
            self._sched_event("retry", j, attempt=j.retries,
                              delay_s=round(delay, 4),
                              error=msg[:300])
        for j in failed:
            self._finish_error(j, msg)

    # -- deadlines + preemption (the reaper) -------------------------------

    def _reap(self) -> None:
        """The scheduler's clock: expire queued jobs past their
        deadline, drain running preemptible jobs past theirs, and
        back-stop priority preemption for arrivals that raced the
        dispatch."""
        while True:
            expired = []
            with self._cond:
                if self._stop:
                    return
                now = time.time()
                for jid in list(self._queue):
                    j = self.jobs[jid]
                    if j.deadline_t is not None and now >= j.deadline_t:
                        self._queue.remove(jid)
                        expired.append(j)
                for j in self.jobs.values():
                    if (j.state == "running" and j._preemptible
                            and j.deadline_t is not None
                            and now >= j.deadline_t
                            and j._drain is not None
                            and not j._drain.is_set()
                            and j.preempt_reason is None):
                        j.preempt_reason = "deadline"
                        j._drain.set()
                        self._counters["preempted"] += 1
                        self._sched_event("preempt", j,
                                          reason="deadline")
                self._maybe_preempt_locked()
            for j in expired:
                self._finish_terminal(j, "expired",
                                      reason="deadline expired while "
                                             "queued")
            time.sleep(REAPER_PERIOD_S)

    def _maybe_preempt_locked(self) -> None:
        """Priority preemption AS scheduling: a queued job strictly
        above a running preemptible job's priority drains it; the
        preempted job requeues as a -recover resume (bit-for-bit the
        uninterrupted result, the resume contract)."""
        if not self._queue:
            return
        top = max(self.jobs[jid].priority for jid in self._queue)
        for j in self.jobs.values():
            if (j.state == "running" and j._preemptible
                    and j._drain is not None
                    and not j._drain.is_set()
                    and j.preempt_reason is None
                    and j.priority < top):
                j.preempt_reason = "priority"
                j._drain.set()
                self._counters["preempted"] += 1
                self._sched_event("preempt", j, reason="priority",
                                  priority=j.priority, over=top)

    def _requeue_preempted(self, job: Job) -> None:
        """A priority-preempted job goes back in the queue as a
        `-recover` resume against its own checkpoint + journal
        (api._open_journal appends and stamps run_resume: one
        continuous history)."""
        with self._cond:
            job.options["recover"] = True
            job.requeues += 1
            job.preempt_reason = None
            job._drain = None
            job._preemptible = False
            job.state = "queued"
            job.started_t = None
            self._queue.append(job.id)
            self._counters["requeued"] += 1
            self._cond.notify()
        self._sched_event("requeue", job, reason="priority",
                          requeues=job.requeues)

    # -- execution paths ---------------------------------------------------

    def _jobdir(self, job: Job) -> str:
        d = os.path.join(self.root, "jobs", job.id)
        os.makedirs(d, exist_ok=True)
        mod = _module_name(job.spec)
        with open(os.path.join(d, f"{mod}.tla"), "w") as f:
            f.write(job.spec)
        with open(os.path.join(d, f"{mod}.cfg"), "w") as f:
            f.write(job.cfg)
        return os.path.join(d, f"{mod}.cfg")

    def _journal_path(self, job: Job) -> str:
        return os.path.join(self.root, f"{job.id}.journal.jsonl")

    def _journal(self, job: Job):
        from ..obs.journal import RunJournal

        return RunJournal(self._journal_path(job),
                          fsync_every=JOB_FSYNC_EVERY)

    def _run_batch(self, batch: List[Job]) -> None:
        head = batch[0]
        if head.is_infer() and not head.is_large(self.large_fpcap):
            self._run_infer(batch)
            return
        if head.is_smoke() and not head.is_large(self.large_fpcap):
            self._run_smoke(batch)
            return
        if head.sweep and not head.is_large(self.large_fpcap):
            self._run_sweep(batch)
            return
        assert len(batch) == 1
        if head.is_large(self.large_fpcap):
            self._run_supervised(head)
        else:
            self._run_pooled(head)

    def _geometry(self, job: Job) -> dict:
        o = job.options
        return dict(
            chunk=int(o.get("chunk", DEFAULT_CHUNK)),
            queue_capacity=int(o.get("qcap", DEFAULT_QCAP)),
            fp_capacity=int(o.get("fpcap", DEFAULT_FPCAP)),
            check_deadlock=not o.get("nodeadlock", False),
            sort_free=o.get("sortfree", None),
            deferred=o.get("deferredinv", None),
        )

    def _run_sweep(self, batch: List[Job]) -> None:
        """One batched dispatch for the whole compatible batch."""
        from . import sweep as sw

        head = batch[0]
        params = head.sweep_params()
        cfg_path = self._jobdir(head)
        # the job's FIXED constants bake into the anchor (batch_signature
        # already folds only equal-fixed jobs together, so head's dict
        # speaks for the whole batch); two batches differing in a fixed
        # override land on different class keys, not one shared engine
        fixed = _loader_constants({
            k: v for k, v in head.constants.items() if k not in params
        })
        model = sw.load_anchored(cfg_path, params,
                                 const_overrides=fixed or None)
        pre = self.pool.hits
        entry = self.pool.get_sweep(model, params, **self._geometry(head))
        hit = self.pool.hits > pre
        configs = [
            {c: int(j.constants[c]) for c in params} for j in batch
        ]
        device = self._device_name()
        journals = []
        for j in batch:
            if j is not head:
                self._jobdir(j)  # each job keeps its own artifacts
            jr = self._journal(j)
            jr.event("run_start", version=_version(), workload=j.name,
                     engine="sweep", device=device,
                     params=dict(**self._geometry(j),
                                 sweep=j.sweep, constants=j.constants,
                                 batch=len(batch), pool_hit=hit))
            journals.append(jr)
        try:
            results = entry.runner.run(configs)
        except BaseException:
            self._abort_journals(journals)
            raise
        with self._cond:
            self.batches_run += 1
            self.batched_jobs += len(batch)
        for j, jr, r in zip(batch, journals, results):
            if r.violation != 0:
                jr.event("violation", code=int(r.violation),
                         name=r.violation_name)
            jr.event("final",
                     verdict="ok" if r.violation == 0 else "violation",
                     generated=r.generated, distinct=r.distinct,
                     depth=r.depth, queue=r.queue_left,
                     wall_s=round(r.wall_s, 6), interrupted=False)
            jr.close()
            self._finish_ok(j, _result_dict(r, "sweep", pool_hit=hit))

    def _run_smoke(self, batch: List[Job]) -> None:
        """The smoke job class (torchtlc.sim): one batched
        random-walk dispatch for the whole compatible batch - the
        batch axis is (seed, swept-constants config), so N per-commit
        smoke submits (different seeds) and a constants sweep both
        ride ONE warm sim engine.  The artifact cache is BYPASSED
        (journaled per job): simulation verdicts are from incomplete
        search and must never publish to the verdict tier."""
        from ..struct import artifacts as arts
        from ..struct.loader import StructLoadError, load
        from ..struct.parser import StructParseError
        from . import sweep as sw

        head = batch[0]
        params = head.sweep_params() or None
        cfg_path = self._jobdir(head)
        fixed = _loader_constants({
            k: v for k, v in head.constants.items()
            if k not in (params or {})
        })
        try:
            if params:
                model = sw.load_anchored(cfg_path, params,
                                         const_overrides=fixed or None)
            else:
                model = load(cfg_path, const_overrides=fixed or None)
        except (StructLoadError, StructParseError):
            # the sim engine is struct-only today: route through
            # api.run_check with the frontend forced struct (it runs
            # any spec) so the job still gets a real answer or a
            # real error
            for j in batch:
                self._run_supervised(j, frontend="struct")
            return
        o = head.options
        walkers = int(o.get("walkers", DEFAULT_SIM_WALKERS))
        depth = int(o.get("depth", DEFAULT_SIM_DEPTH))
        fp_capacity = int(o.get("fpcap", DEFAULT_FPCAP))
        check_deadlock = not o.get("nodeadlock", False)
        pre = self.pool.hits
        entry = self.pool.get_sim(
            model, params=params, walkers=walkers, depth=depth,
            fp_capacity=fp_capacity, check_deadlock=check_deadlock,
        )
        hit = self.pool.hits > pre
        items = [
            (int(j.options.get("simseed", 0)),
             ({c: int(j.constants[c]) for c in params}
              if params else None))
            for j in batch
        ]
        bypass = (arts.get_store() is not None
                  and not o.get("noartifactcache"))
        device = self._device_name()
        journals = []
        for j, (seed, values) in zip(batch, items):
            if j is not head:
                self._jobdir(j)
            jr = self._journal(j)
            jr.event("run_start", version=_version(), workload=j.name,
                     engine="sim", device=device,
                     params=dict(walkers=walkers, depth=depth,
                                 sim_seed=seed, fp_capacity=fp_capacity,
                                 sweep=j.sweep, constants=j.constants,
                                 batch=len(batch), pool_hit=hit))
            if bypass:
                jr.event("cache", tier="verdict", outcome="bypass",
                         key="", reason="simulation verdicts are from "
                                        "incomplete search and never "
                                        "publish")
            journals.append(jr)
        try:
            results = entry.runner.run(items)
        except BaseException:
            self._abort_journals(journals)
            raise
        with self._cond:
            self.batches_run += 1
            self.batched_jobs += len(batch)
        for j, jr, r in zip(batch, journals, results):
            jr.event("sim", phase="summary", walkers=r.walkers,
                     depth=r.depth, steps=r.steps,
                     transitions=r.transitions, seed=r.seed,
                     distinct_est=r.distinct,
                     fp_saturated=r.fp_saturated, halted=r.halted,
                     depth_hist=[list(p) for p in r.depth_hist],
                     violation=r.violation)
            if r.violation != 0:
                jr.event("violation", code=int(r.violation),
                         name=r.violation_name)
            jr.event("final",
                     verdict="ok" if r.violation == 0 else "violation",
                     generated=r.generated, distinct=r.distinct,
                     depth=r.steps, queue=0,
                     wall_s=round(r.wall_s, 6), interrupted=False)
            jr.close()
            res = _result_dict(r, "sim", pool_hit=hit)
            res["depth"] = r.steps  # depth REACHED (r.depth = budget)
            res["sim"] = dict(
                walkers=r.walkers, depth=r.depth, steps=r.steps,
                transitions=r.transitions, seed=r.seed,
                distinct_est=r.distinct, fp_saturated=r.fp_saturated,
                violation_lane=r.violation_lane,
                violation_step=r.violation_step,
            )
            self._finish_ok(j, res)

    def _run_infer(self, batch: List[Job]) -> None:
        """The inference job class (torchtlc.infer): every job
        in the folded batch runs through ONE warm infer engine - the
        candidate pool, the [P, S] filter kernel (K29) and the exact
        evidence all belong to the engine, so the per-job work is pure
        dispatch (the seed only matters under sampled evidence).  Like
        sim, the artifact-cache verdict tier is BYPASSED (journaled
        per job): an inference verdict is about CANDIDATES, not the
        spec's stated invariants."""
        from ..struct import artifacts as arts
        from ..struct.loader import StructLoadError, load
        from ..struct.parser import StructParseError

        head = batch[0]
        cfg_path = self._jobdir(head)
        fixed = _loader_constants(head.constants)
        try:
            model = load(cfg_path, const_overrides=fixed or None)
        except (StructLoadError, StructParseError):
            # inference conjectures over the struct IR: route through
            # api.run_check with the frontend forced struct (it runs
            # any spec) so the job still gets a real answer or a real
            # error
            for j in batch:
                self._run_supervised(j, frontend="struct")
            return
        o = head.options
        budget = int(o.get("inferbudget", 64))
        walkers = int(o.get("walkers", DEFAULT_SIM_WALKERS))
        depth = int(o.get("depth", DEFAULT_SIM_DEPTH))
        check_deadlock = not o.get("nodeadlock", False)
        pre = self.pool.hits
        entry = self.pool.get_infer(
            model, budget=budget, walkers=walkers, depth=depth,
            check_deadlock=check_deadlock,
        )
        hit = self.pool.hits > pre
        bypass = (arts.get_store() is not None
                  and not o.get("noartifactcache"))
        device = self._device_name()
        for j in batch:
            if j is not head:
                self._jobdir(j)
            jr = self._journal(j)
            jr.event("run_start", version=_version(), workload=j.name,
                     engine="infer", device=device,
                     params=dict(budget=budget, walkers=walkers,
                                 depth=depth,
                                 sim_seed=int(j.options.get(
                                     "simseed", 0)),
                                 constants=j.constants,
                                 batch=len(batch), pool_hit=hit))
            if bypass:
                jr.event("cache", tier="verdict", outcome="bypass",
                         key="", reason="inference verdicts are about "
                                        "candidate invariants and "
                                        "never publish")
            try:
                rep = entry.runner.run(
                    seed=int(j.options.get("simseed", 0)))
            except BaseException:
                self._abort_journals([jr])
                raise
            jr.event("infer", phase="summary",
                     candidates=rep.candidates, killed=rep.killed,
                     survivors=len(rep.survivors),
                     certified=len(rep.certified),
                     certified_names=[c.name for c in rep.certified],
                     evidence=rep.evidence, n_states=rep.n_states,
                     dropped=rep.dropped)
            violated = bool(rep.cfg_killed)
            if violated:
                jr.event("violation", code=100,
                         name=f"Invariant {rep.cfg_killed[0]} is "
                              f"violated.")
            jr.event("final",
                     verdict="violation" if violated else "ok",
                     generated=rep.n_states, distinct=rep.n_states,
                     depth=0, queue=0,
                     wall_s=round(rep.wall_s, 6), interrupted=False)
            jr.close()
            res = dict(
                verdict="violation" if violated else "ok",
                violation=(100 if violated else 0),
                violation_name=(f"Invariant {rep.cfg_killed[0]} is "
                                f"violated." if violated else None),
                generated=rep.n_states, distinct=rep.n_states,
                depth=0, queue_left=0,
                wall_s=round(rep.wall_s, 6),
                engine="infer", pool_hit=hit,
                infer=dict(
                    candidates=rep.candidates, dropped=rep.dropped,
                    killed=rep.killed, survivors=len(rep.survivors),
                    certified=[
                        dict(name=c.name, text=c.text, basis=b,
                             implies=list(c.implies))
                        for c, b in zip(rep.certified, rep.cert_basis)
                    ],
                    uncertified=[
                        dict(name=c.name, text=c.text)
                        for c in rep.survivors
                        if c not in rep.certified
                    ],
                    uncompiled=list(rep.uncompiled),
                    cfg_killed=list(rep.cfg_killed),
                    evidence=rep.evidence, exact=rep.exact,
                    n_states=rep.n_states, seed=rep.seed,
                ),
            )
            self._finish_ok(j, res)
        with self._cond:
            self.batches_run += 1
            self.batched_jobs += len(batch)

    def _run_pooled(self, job: Job) -> None:
        """Warm plain engine via the pool; falls back to the supervised
        path when the spec does not resolve structurally.

        Incremental re-checking sits BEFORE pool routing: an
        unchanged spec is answered from the verdict tier in O(HTTP) -
        no pool lookup, no engine dispatch - and a spec whose behavior
        digest has a stored reachable set routes through api.run_check,
        which skips BFS and re-evaluates only the invariants."""
        from ..struct import artifacts as arts
        from ..struct.loader import StructLoadError, load
        from ..struct.parser import StructParseError

        cfg_path = self._jobdir(job)
        try:
            model = load(
                cfg_path,
                const_overrides=_loader_constants(job.constants) or None,
            )
        except (StructLoadError, StructParseError, JobError):
            self._run_supervised(job)
            return
        geo = self._geometry(job)
        store = arts.get_store()
        use_cache = (store is not None
                     and not job.options.get("recheck")
                     and not job.options.get("noartifactcache"))
        vkey = ""
        if use_cache:
            # the pooled path checks safety only, so its verdict key
            # carries an empty property selection (api keys runs WITH
            # properties differently - the two can never cross-answer)
            vkey = arts.verdict_key(model, geo["check_deadlock"])
            payload = store.lookup_verdict(vkey)
            if payload is not None:
                self._finish_cached(job, geo, vkey, payload)
                return
            if store.has_reach(
                    arts.reach_key(model, geo["check_deadlock"])):
                # invariant-only edit: api.run_check's reach tier
                # skips BFS entirely - cheaper than a pool dispatch.
                # Forced onto the struct frontend: the stored artifact
                # was keyed by this very struct load, and "auto" could
                # route a gen-subset spec away from the cache
                self._run_supervised(job, frontend="struct")
                return
        pre = self.pool.hits
        entry = self.pool.get_single(model, **geo)
        hit = self.pool.hits > pre
        jr = self._journal(job)
        jr.event("run_start", version=_version(), workload=job.name,
                 engine="pool", device=self._device_name(),
                 params=dict(**geo, constants=job.constants,
                             pool_hit=hit))
        try:
            r = entry.runner.run(capture_fps=use_cache)
        except BaseException:
            self._abort_journals([jr])
            raise
        if r.violation != 0:
            jr.event("violation", code=int(r.violation),
                     name=r.violation_name)
        if use_cache and r.violation == 0:
            try:
                arts.ArtifactPlan(
                    store, model,
                    check_deadlock=geo["check_deadlock"],
                    fp_capacity=geo["fp_capacity"],
                ).record(r, n_init=len(model.system.initial_states()),
                         journal=jr)
            except OSError:
                pass  # a full disk must not fail the job
        jr.event("final",
                 verdict="ok" if r.violation == 0 else "violation",
                 generated=r.generated, distinct=r.distinct,
                 depth=r.depth, queue=r.queue_left,
                 wall_s=round(r.wall_s, 6), interrupted=False)
        jr.close()
        self._finish_ok(job, _result_dict(r, "pool", pool_hit=hit))

    def _finish_cached(self, job: Job, geo: dict, key: str,
                       payload: dict) -> None:
        """Answer a job from the verdict tier: journal a complete run
        (run_start -> cache hit -> final, so SSE/views/tlcstat render
        it like any other), no pool lookup, no engine dispatch."""
        from ..struct.artifacts import result_from_payload

        jr = self._journal(job)
        jr.event("run_start", version=_version(), workload=job.name,
                 engine="cache", device="artifact-cache",
                 params=dict(**geo, constants=job.constants,
                             cache_hit=True))
        jr.event("cache", tier="verdict", outcome="hit", key=key,
                 workload=payload.get("workload"))
        r = result_from_payload(payload,
                                fp_capacity=geo["fp_capacity"],
                                wall_s=time.time() - job.started_t)
        jr.event("final", verdict="ok", generated=r.generated,
                 distinct=r.distinct, depth=r.depth, queue=r.queue_left,
                 wall_s=round(r.wall_s, 6), interrupted=False)
        jr.close()
        with self._cond:
            self.cache_hits += 1
        res = _result_dict(r, "cache")
        res["cache_hit"] = True
        self._finish_ok(job, res)

    def _abort_journals(self, journals) -> None:
        """A runner that dies after the per-job journals opened must
        still terminate them: SSE followers only stop on a 'final'
        event, and an unclosed handle leaks per failed job (the loop's
        error handler knows jobs, not files).  A retried dispatch
        truncates and rewrites these journals (RunJournal opens 'w');
        the SSE tail resets on shrink."""
        for jr in journals:
            try:
                jr.event("final", verdict="error", generated=0,
                         distinct=0, depth=0, queue=0, wall_s=0.0,
                         interrupted=True)
            except Exception:
                pass  # a sick journal must not mask the run's error
            finally:
                jr.close()

    def _run_supervised(self, job: Job, frontend: str = None) -> None:
        """Large / resilience-option jobs: the full api.run_check
        pipeline (resil supervisor, degradation ladder, preflight, TLC
        transcript captured as the job's output).  `frontend` overrides
        the resolver when the caller already knows the path (the
        artifact-cache reach route struct-loaded the model itself).

        The job's drain Event rides into SupervisorOptions: the reaper
        / a priority arrival / a cancel sets it, the supervisor
        checkpoints at the next segment fence and returns exit 75, and
        the preempt_reason decides what 75 MEANS here - requeue as a
        -recover resume (priority), terminal expired (deadline), or
        terminal canceled (client cancel)."""
        from ..api import CheckRequest, run_check

        cfg_path = self._jobdir(job)
        out = io.StringIO()
        kw = {k: job.options[k] for k in _REQUEST_OPTIONS
              if k in job.options}
        kw.setdefault("workers",
                      "cpu" if self.pool.device.type == "cpu" else "gpu")
        if frontend is not None:
            kw.setdefault("frontend", frontend)
        req = CheckRequest(
            config=cfg_path,
            constants=_loader_constants(job.constants),
            journal=self._journal_path(job),
            noTool=True, out=out, err=out, drain=job._drain, **kw,
        )
        outcome = run_check(req)
        r = outcome.result
        res = dict(verdict=outcome.verdict,
                   exit_code=outcome.exit_code, engine="supervised",
                   transcript=out.getvalue())
        if kw.get("coverage"):
            # per-job coverage artifact: the cumulative
            # site table folded from the job journal's coverage
            # events - GET /jobs/<id> returns it, and the journal
            # itself stays queryable via /coverage?run=<job id>
            try:
                from ..obs.coverage import coverage_from_events
                from ..obs.journal import read as read_journal

                cov = coverage_from_events(
                    read_journal(req.journal, validate=False)
                )
                if cov is not None:
                    res["coverage"] = cov
            except (OSError, ValueError):
                pass  # a sick journal must not mask the verdict
        if r is not None:
            res.update(
                generated=r.generated, distinct=r.distinct,
                depth=r.depth, queue=r.queue_left,
                violation=r.violation,
                action_generated=r.action_generated,
                wall_s=round(r.wall_s, 6),
            )
        reason = job.preempt_reason
        if outcome.exit_code == 75 and reason == "priority":
            self._requeue_preempted(job)
        elif outcome.exit_code == 75 and reason == "deadline":
            self._finish_terminal(job, "expired",
                                  reason="deadline expired while "
                                         "running", result=res)
        elif outcome.exit_code == 75 and reason == "cancel":
            self._finish_terminal(job, "canceled",
                                  reason="canceled by client",
                                  result=res)
        elif outcome.exit_code in (0, 12, 13, 75):
            self._finish_ok(job, res)
        else:
            job.result = res
            self._finish_error(
                job, f"exit {outcome.exit_code}: {out.getvalue()[-500:]}"
            )

    # -- completion --------------------------------------------------------

    def _breaker_note_locked(self, job: Job,
                             outcome: str) -> Optional[str]:
        """Feed one job outcome to the spec-digest breaker.  Returns
        "trip" / "reopen" when this outcome opened the circuit.
        outcome: "ok" closes, "error" counts toward the threshold (and
        re-opens a failed half-open probe), anything else only
        releases a held probe slot (a canceled probe must not wedge
        the breaker half-open forever)."""
        br = self._breaker.get(job.digest)
        if outcome == "ok":
            if br is not None:
                del self._breaker[job.digest]
            return None
        if outcome != "error":
            if br is not None and br.get("probe") == job.id:
                br["probe"] = None
            return None
        if br is None:
            br = self._breaker[job.digest] = dict(
                state="closed", failures=0, opened_t=0.0, probe=None)
        br["failures"] += 1
        if br["state"] == "half_open" and br.get("probe") == job.id:
            br.update(state="open", opened_t=time.time(), probe=None)
            return "reopen"
        if br["state"] == "closed" \
                and br["failures"] >= self.breaker_threshold:
            br.update(state="open", opened_t=time.time())
            return "trip"
        return None

    def _ensure_terminal_journal(self, job: Job, verdict: str) -> None:
        """A job finishing without ever having journaled (expired /
        canceled / quarantined before running, or a dispatch that died
        before opening journals) still gets a minimal one - run_start
        with engine "sched" plus the final - so /runs lists it and SSE
        followers terminate on EVERY outcome."""
        path = self._journal_path(job)
        if os.path.exists(path):
            return
        from ..obs.journal import RunJournal

        try:
            with RunJournal(path) as jr:
                jr.event("run_start", version=_version(),
                         workload=job.name, engine="sched",
                         device="host",
                         params=dict(tenant=job.tenant,
                                     priority=job.priority,
                                     verdict=verdict))
                jr.event("final", verdict=verdict, generated=0,
                         distinct=0, depth=0, queue=0, wall_s=0.0,
                         interrupted=False)
        except OSError:
            pass  # a sick disk must not mask the job's state

    def _finish_terminal(self, job: Job, verdict: str,
                         reason: str = None,
                         result: Optional[dict] = None) -> None:
        """Scheduler-terminal completion: expired / canceled /
        quarantined."""
        self._ensure_terminal_journal(job, verdict)
        action = {"expired": "expire", "canceled": "cancel",
                  "quarantined": "quarantine"}[verdict]
        with self._cond:
            job.state = verdict
            job.engine = job.engine or "sched"
            if result is not None:
                job.result = result
            if reason and not job.error:
                job.error = reason
            job.finished_t = time.time()
            self._finished_ts.append(job.finished_t)
            self._counters[verdict] += 1
            self._breaker_note_locked(job, verdict)
            self._cond.notify_all()
        self._sched_event(action, job, tenant=job.tenant,
                          reason=(reason or verdict))

    def _finish_ok(self, job: Job, result: dict) -> None:
        with self._cond:
            job.result = result
            job.engine = result.get("engine", "")
            job.state = "done"
            job.finished_t = time.time()
            self._finished_ts.append(job.finished_t)
            self._breaker_note_locked(job, "ok")
            self._cond.notify_all()

    def _finish_error(self, job: Job, msg: str) -> None:
        self._ensure_terminal_journal(job, "error")
        with self._cond:
            job.error = msg
            job.state = "error"
            job.finished_t = time.time()
            self._finished_ts.append(job.finished_t)
            tripped = self._breaker_note_locked(job, "error")
            self._cond.notify_all()
        if tripped:
            self._sched_event("quarantine", job, digest=job.digest,
                              transition=tripped,
                              cooldown_s=self.breaker_cooldown_s)


def _version() -> str:
    from .. import __version__

    return __version__
