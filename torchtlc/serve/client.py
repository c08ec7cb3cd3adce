"""Thin client for the checking service (stdlib urllib only; a copy of
jaxtlc/serve/client.py, which imports no jax).

`submit` posts a job, `wait` polls it to completion, `stream` follows
the job-scoped SSE event feed, `check` is submit+wait in one call,
`cancel` is DELETE /jobs/<id>.  A 429 from admission control is retried
automatically, honoring the server's drain-rate
``Retry-After`` with capped deterministic-jitter backoff.
The CLI form drives a live server from a model directory::

    python -m torchtlc.serve.client http://HOST:PORT path/to/MC.cfg \
        [--name N] [--chunk 64] [--qcap 1024] [--fpcap 4096] \
        [--sweep CONST:LO:HI --set CONST=V]

``python -m torchtlc.serve --tiny`` drives its smoke through these calls.
"""

from __future__ import annotations

import json
import os
import random
import time
import urllib.error
import urllib.request
from typing import Dict, Iterator, Optional

# deterministic jitter for the 429 backoff: two identical overload
# replays back off on the same clock
_RNG = random.Random(0x5EED429)


class ClientError(RuntimeError):
    """An HTTP-level failure.  `code` is the status (0 when the error
    was not an HTTP response); `retry_after` carries a 429's
    Retry-After hint in seconds (None otherwise)."""

    def __init__(self, msg: str, code: int = 0,
                 retry_after: Optional[int] = None):
        super().__init__(msg)
        self.code = int(code)
        self.retry_after = retry_after


def _post(url: str, payload: dict, timeout: float = 30.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        ra = e.headers.get("Retry-After")
        raise ClientError(f"{url}: {e.code} {e.read().decode()}",
                          code=e.code,
                          retry_after=(int(ra) if ra else None))


def _get(url: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def submit(url: str, spec: str, cfg: str, name: str = "",
           constants: Optional[Dict] = None, sweep: Optional[Dict] = None,
           options: Optional[Dict] = None, tenant: str = None,
           retries: int = 4, backoff_cap_s: float = 30.0) -> str:
    """POST /jobs; returns the job id.

    A 429 (admission control) is retried up to `retries` times: each
    attempt sleeps the server's Retry-After hint scaled by a
    deterministic jitter in [0.5, 1.0), doubled per attempt and capped
    at `backoff_cap_s` - honoring the server's estimate without
    thundering back in lockstep.  `retries=0` surfaces the 429 raw."""
    attempt = 0
    while True:
        try:
            out = _post(url.rstrip("/") + "/jobs", {
                "spec": spec, "cfg": cfg, "name": name,
                "constants": constants or {}, "sweep": sweep,
                "options": options or {}, "tenant": tenant,
            })
            return out["id"]
        except ClientError as e:
            if e.code != 429 or attempt >= retries:
                raise
            attempt += 1
            hint = max(1, e.retry_after or 1)
            delay = min(backoff_cap_s, hint * (2 ** (attempt - 1)))
            time.sleep(delay * (0.5 + 0.5 * _RNG.random()))


def status(url: str, job_id: str) -> dict:
    return _get(f"{url.rstrip('/')}/jobs/{job_id}")


def wait(url: str, job_id: str, timeout: float = 300.0,
         poll_s: float = 0.05) -> dict:
    """Poll until the job leaves queued/running; returns its record.
    Returns immediately on EVERY terminal state - done, error, and the
    scheduler-terminal expired / canceled / quarantined."""
    deadline = time.time() + timeout
    while True:
        st = status(url, job_id)
        if st["state"] not in ("queued", "running"):
            return st
        if time.time() > deadline:
            raise ClientError(f"job {job_id} still {st['state']} "
                              f"after {timeout}s")
        time.sleep(poll_s)


def cancel(url: str, job_id: str, timeout: float = 30.0) -> dict:
    """DELETE /jobs/<id>; returns the job record (state `canceled`
    for a queued job; a running checkpointed heavy job drains through
    the preempt path and reaches `canceled` shortly after)."""
    req = urllib.request.Request(f"{url.rstrip('/')}/jobs/{job_id}",
                                 method="DELETE")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        raise ClientError(f"{url}: {e.code} {e.read().decode()}",
                          code=e.code)


def health(url: str) -> dict:
    return _get(url.rstrip("/") + "/health")


def check(url: str, spec: str, cfg: str, **kw) -> dict:
    """submit + wait: the one-call remote analog of api.run_check."""
    timeout = kw.pop("timeout", 300.0)
    return wait(url, submit(url, spec, cfg, **kw), timeout=timeout)


def stream(url: str, job_id: str, timeout: float = 300.0) -> Iterator[dict]:
    """Follow the job-scoped SSE feed (`/events?run=<id>`), yielding
    event dicts until the job's `final` event arrives."""
    u = f"{url.rstrip('/')}/events?run={job_id}"
    with urllib.request.urlopen(u, timeout=timeout) as r:
        while True:
            line = r.readline()
            if not line:
                return
            if line.startswith(b"data: "):
                ev = json.loads(line[6:].decode())
                yield ev
                if ev.get("event") == "final":
                    return


def pool_stats(url: str) -> dict:
    return _get(url.rstrip("/") + "/pool")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="torchtlc.serve.client")
    p.add_argument("url", help="server base URL (http://host:port)")
    p.add_argument("config", help="path to a model .cfg (the sibling "
                                  ".tla module is read and shipped)")
    p.add_argument("--name", default="")
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--qcap", type=int, default=1 << 10)
    p.add_argument("--fpcap", type=int, default=1 << 12)
    p.add_argument("--sweep", default="",
                   help="CONST:LO:HI - mark CONST sweepable over "
                        "[LO, HI] (compatible jobs batch)")
    p.add_argument("--set", dest="sets", action="append", default=[],
                   metavar="CONST=V", help="constant override")
    p.add_argument("--timeout", type=float, default=300.0)
    args = p.parse_args(argv)

    model_dir = os.path.dirname(os.path.abspath(args.config))
    base = os.path.splitext(os.path.basename(args.config))[0]
    tla = os.path.join(model_dir, f"{base}.tla")
    with open(args.config) as f:
        cfg = f.read()
    with open(tla) as f:
        spec = f.read()
    constants = {}
    for s in args.sets:
        k, _, v = s.partition("=")
        constants[k.strip()] = int(v)
    sweep = None
    if args.sweep:
        c, lo, hi = args.sweep.split(":")
        sweep = {"const": c, "lo": int(lo), "hi": int(hi)}
    st = check(
        args.url, spec, cfg, name=args.name or base,
        constants=constants, sweep=sweep,
        options=dict(chunk=args.chunk, qcap=args.qcap,
                     fpcap=args.fpcap),
        timeout=args.timeout,
    )
    print(json.dumps(st, indent=2, sort_keys=True))
    return 0 if st["state"] == "done" else 1


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
