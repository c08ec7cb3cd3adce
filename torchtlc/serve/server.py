"""Checking-as-a-service: the HTTP job API (stdlib only; port of
jaxtlc/serve/server.py).

The front door of ROADMAP #4: a long-lived process that accepts
spec+cfg jobs, runs them through the FIFO scheduler (serve.scheduler)
against the warm engine pool (serve.pool), and serves results plus
live telemetry.  The monitoring surface IS obs.serve - this handler
subclasses it, so ``/runs``, ``/metrics``, ``/journal`` and the SSE
``/events`` tail come from the same code the single-run ``-serve``
monitor uses, reading the per-job journals the scheduler writes.  A
job-scoped event stream is just ``/events?run=<job id>``.

Endpoints (on top of the inherited monitor):

* ``POST /jobs`` - submit a check.  JSON body::

      {"name": "...", "spec": "---- MODULE M ----\\n...",
       "cfg": "CONSTANT ...", "constants": {"N": 3},
       "tenant": "ci", "sweep": {"const": "N", "lo": 1, "hi": 4},
       "options": {"chunk": 64, "qcap": 1024, "fpcap": 4096,
                   "priority": 5, "deadline_s": 30}}

  -> 202 with the job id + the URLs to poll/stream.  Compatible sweep
  jobs batch into one batched dispatch; large jobs route through the
  resil supervisor (see serve.scheduler for the discipline).  An
  over-limit submit (queue bound / tenant quota) is **429** with a
  ``Retry-After`` header computed from the measured drain rate.
* ``GET /jobs`` - the job registry (state, engine, result per job).
* ``GET /jobs/<id>`` - one job's record (the verdict lives here).
* ``DELETE /jobs/<id>`` - cancel: a queued job flips to the terminal
  ``canceled`` state; a running checkpointed heavy job drains through
  the programmatic preempt path.
* ``GET /health`` - scheduler liveness: queue depth vs bound, drain
  rate, open breakers (``status`` flips to "overloaded" at 80% of the
  admission bound).
* ``GET /pool`` - engine-pool + scheduler + build-meter stats (the
  warm/cold accounting ``python -m torchtlc.serve --tiny`` asserts on).

``python -m torchtlc.serve`` starts it; ``torchtlc.serve.client`` is the
thin submit/wait/stream client driving it.  The handler threads only
read and enqueue: every kernel runs on the scheduler's worker thread, on
the pool's device (the card unless ``device="cpu"``).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Optional

from ..obs import serve as obs_serve
from .pool import EnginePool
from .scheduler import AdmissionError, JobError, Scheduler


class _JobHandler(obs_serve._Handler):
    """The monitor handler + the job API.  `scheduler` is stamped
    class-wide by CheckServer (same pattern as `root`)."""

    scheduler: Scheduler = None

    # -- job API -----------------------------------------------------------

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        parsed_path = self.path.rstrip("/")
        if parsed_path != "/jobs":
            self._send(404, b"unknown endpoint\n", "text/plain")
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n).decode() or "{}")
            spec, cfg = body.get("spec"), body.get("cfg")
            if not spec or not cfg:
                raise JobError("body needs 'spec' and 'cfg' text")
            job = self.scheduler.submit(
                spec, cfg, name=body.get("name", ""),
                constants=body.get("constants"),
                sweep=body.get("sweep"),
                options=body.get("options"),
                tenant=body.get("tenant"),
            )
        except AdmissionError as e:
            # admission control: 429 + the drain-rate Retry-After the
            # client's backoff honors (serve.client)
            payload = json.dumps({
                "error": str(e), "retry_after": e.retry_after,
            }).encode()
            self.send_response(429)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("Retry-After", str(e.retry_after))
            self.end_headers()
            try:
                self.wfile.write(payload)
            except (BrokenPipeError, ConnectionResetError):
                pass
            return
        except (JobError, ValueError) as e:
            self._send(400, f"bad job: {e}\n".encode(), "text/plain")
            return
        self._send(202, json.dumps({
            "id": job.id,
            "job": f"/jobs/{job.id}",
            "events": f"/events?run={job.id}",
            "journal": f"/journal?run={job.id}",
        }).encode(), "application/json")

    def do_GET(self):  # noqa: N802
        route = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if route == "/jobs":
                self._send(200, json.dumps(
                    {"jobs": self.scheduler.list()}
                ).encode(), "application/json")
            elif route.startswith("/jobs/"):
                job = self.scheduler.get(route[len("/jobs/"):])
                if job is None:
                    self._send(404, b"no such job\n", "text/plain")
                    return
                self._send(200, json.dumps(job.summary()).encode(),
                           "application/json")
            elif route == "/pool":
                self._send(200, json.dumps({
                    "pool": self.scheduler.pool.stats(),
                    "scheduler": self.scheduler.stats(),
                }).encode(), "application/json")
            elif route == "/health":
                self._send(200,
                           json.dumps(self.scheduler.health()).encode(),
                           "application/json")
            else:
                super().do_GET()
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-write: their call

    def do_DELETE(self):  # noqa: N802
        route = self.path.split("?", 1)[0].rstrip("/")
        if not route.startswith("/jobs/"):
            self._send(404, b"unknown endpoint\n", "text/plain")
            return
        try:
            job = self.scheduler.cancel(route[len("/jobs/"):])
            if job is None:
                self._send(404, b"no such job\n", "text/plain")
                return
            self._send(200, json.dumps(job.summary()).encode(),
                       "application/json")
        except (BrokenPipeError, ConnectionResetError):
            pass


class CheckServer:
    """A running checking service: HTTP front + scheduler + pool over
    one runs directory.  `port=0` binds ephemeral; read `.port`."""

    def __init__(self, root: Optional[str] = None, port: int = 0,
                 host: str = "127.0.0.1", pool: EnginePool = None,
                 pool_capacity: int = 8, sweep_width: int = None,
                 large_fpcap: int = None, prewarm: list = None,
                 queue_bound: int = None, tenant_quota: int = None,
                 tenant_weights: dict = None, job_retries: int = None,
                 breaker_threshold: int = None,
                 breaker_cooldown_s: float = None, faults=None,
                 device=None):
        from http.server import ThreadingHTTPServer

        from .scheduler import DEFAULT_LARGE_FPCAP

        self.root = root or tempfile.mkdtemp(prefix="torchtlc-serve-")
        os.makedirs(self.root, exist_ok=True)
        self.pool = pool or EnginePool(capacity=pool_capacity,
                                       sweep_width=sweep_width,
                                       device=device)
        sched_kw = {k: v for k, v in dict(
            queue_bound=queue_bound, tenant_quota=tenant_quota,
            tenant_weights=tenant_weights, job_retries=job_retries,
            breaker_threshold=breaker_threshold,
            breaker_cooldown_s=breaker_cooldown_s, faults=faults,
        ).items() if v is not None}
        self.scheduler = Scheduler(
            self.root, pool=self.pool,
            large_fpcap=large_fpcap or DEFAULT_LARGE_FPCAP,
            **sched_kw,
        )
        self._prewarm = None
        if prewarm:
            # build ahead of traffic WITHOUT blocking startup; /pool's
            # prewarmed counter reports progress
            self._prewarm = threading.Thread(
                target=self.pool.prewarm, args=(list(prewarm),),
                daemon=True,
            )
            self._prewarm.start()
        handler = type("BoundJobHandler", (_JobHandler,),
                       {"root": self.root, "scheduler": self.scheduler})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd._torchtlc_shutdown = threading.Event()
        self.httpd.daemon_threads = True
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self) -> None:
        """Stop the scheduler's threads, the HTTP server and its SSE
        tails, and join every thread this server started."""
        self.scheduler.shutdown()
        self.httpd._torchtlc_shutdown.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)
        if self._prewarm is not None:
            self._prewarm.join(timeout=60)


def start_server(root: Optional[str] = None, port: int = 0,
                 host: str = "127.0.0.1", **kw) -> CheckServer:
    """Start the checking service; returns the running CheckServer."""
    return CheckServer(root, port=port, host=host, **kw)
