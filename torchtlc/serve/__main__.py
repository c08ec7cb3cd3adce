"""``python -m torchtlc.serve`` - start the checking service (port of
jaxtlc/serve/__main__.py).

Options size the pool and the batch axis; the engines run on the card
unless ``--device cpu``.  --tiny is the self-contained smoke (start on an
ephemeral port, submit a cold / warm job pair through the real HTTP
surface, assert pool reuse and a warm submit that builds and loads
nothing).
"""

from __future__ import annotations

import sys
import time


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="torchtlc.serve")
    p.add_argument("root", nargs="?", default=None,
                   help="runs directory (journals + job artifacts; "
                        "default: a fresh temp dir)")
    p.add_argument("--port", type=int, default=8791)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--pool-cap", type=int, default=8,
                   help="warm engines held (LRU beyond)")
    p.add_argument("--sweep-width", type=int, default=None,
                   help="configs per batched sweep dispatch")
    p.add_argument("--large-fpcap", type=int, default=None,
                   help="fp_capacity above which a job routes through "
                        "the resil supervisor instead of the pool")
    p.add_argument("--prewarm", default="", metavar="SPEC:CFG[,...]",
                   help="comma-separated cfg paths (or SPEC:CFG pairs) "
                        "to build into the pool at startup, so the "
                        "FIRST submit of each rides the warm path "
                        "(built at the pooled-path default geometry "
                        "in a background thread; progress on /pool)")
    p.add_argument("--queue-bound", type=int, default=None,
                   help="admission bound on queued jobs (submits "
                        "beyond it get 429 + Retry-After)")
    p.add_argument("--tenant-quota", type=int, default=None,
                   help="per-tenant bound on queued jobs (fair-share "
                        "admission; dequeue is weighted round-robin "
                        "between tenants regardless)")
    p.add_argument("--device", default=None,
                   help="the engines' device: the card by default; cpu "
                        "runs the plain torch path")
    p.add_argument("--tiny", action="store_true",
                   help="smoke: serve + submit + assert warm reuse, "
                        "then exit")
    args = p.parse_args(argv)
    from .server import start_server

    if args.tiny:
        return _tiny(args.device)
    srv = start_server(
        args.root, port=args.port, host=args.host,
        pool_capacity=args.pool_cap, sweep_width=args.sweep_width,
        large_fpcap=args.large_fpcap,
        prewarm=[s for s in args.prewarm.split(",") if s],
        queue_bound=args.queue_bound, tenant_quota=args.tenant_quota,
        device=args.device,
    )
    print(f"torchtlc checking service at {srv.url} "
          f"(POST /jobs, DELETE /jobs/<id>; GET /jobs /pool /health "
          f"/runs /metrics /events; runs dir {srv.root}; ctrl-c exits)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.shutdown()
        return 0


_TINY_SPEC = """---- MODULE ServeTiny ----
EXTENDS Naturals
CONSTANTS MAX
VARIABLES x

Init == x = 0

Up == /\\ x < MAX
      /\\ x' = x + 1

Reset == /\\ x = MAX
         /\\ x' = 0

Next == Up \\/ Reset

Spec == Init /\\ [][Next]_x

InRange == x <= MAX
====
"""

_TINY_CFG = """CONSTANT MAX = 3
SPECIFICATION
Spec
INVARIANT
InRange
"""


def _tiny(device=None) -> int:
    """Serve + submit a cold/warm pair end-to-end over real HTTP: the
    cold submit builds, the second must be a pool hit with ZERO builds
    and ZERO library loads."""
    from . import client
    from .pool import builds, loads
    from .server import start_server

    srv = start_server(device=device)
    try:
        # the artifact cache off: a smoke that the verdict tier answers
        # would not reach the pool
        opts = dict(chunk=16, qcap=256, fpcap=1024, noartifactcache=True)
        cold = client.check(srv.url, _TINY_SPEC, _TINY_CFG,
                            name="tiny-cold", options=opts)
        assert cold["state"] == "done", cold
        assert cold["result"]["verdict"] == "ok", cold
        assert cold["result"]["engine"] == "pool", cold
        pre = builds(), loads()
        warm = client.check(srv.url, _TINY_SPEC, _TINY_CFG,
                            name="tiny-warm", options=opts)
        fresh = builds() - pre[0], loads() - pre[1]
        assert warm["result"]["pool_hit"] is True, warm
        assert fresh == (0, 0), f"warm submit paid {fresh} builds, loads"
        assert warm["result"]["generated"] == cold["result"]["generated"]
        stats = client.pool_stats(srv.url)
        assert stats["pool"]["hits"] >= 1, stats
        # two job journals + the scheduler's own control-plane journal
        runs = client._get(srv.url + "/runs")["runs"]
        assert len(runs) == 3, runs
        assert any(r["run"] == "sched" for r in runs), runs
        h = client.health(srv.url)
        assert h["status"] == "ok" and h["queued"] == 0, h
        assert h["counters"]["admitted"] >= 2, h
    finally:
        srv.shutdown()
    print("serve tiny OK: cold build -> warm resubmit with 0 builds and "
          "0 loads, verdicts ok, 2 job runs + sched journal registered, "
          "/health ok")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main(sys.argv[1:]))
