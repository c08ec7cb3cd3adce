"""Pod entry point: ``python -m torchtlc.dist`` (port of
jaxtlc/dist/__main__.py).

Two modes:

* **worker** (default): join a pod as one process and run the KubeAPI
  workload to completion.  The three group knobs are ``--coordinator
  --num-hosts --host``; ``--devices-per-host`` is the number of
  fingerprint-space shards this process holds (D = devices-per-host x
  num-hosts, a power of two); everything else mirrors the engine
  parameters (per shard, like the sharded engine).  ``--device`` is the
  engine's device (the card by default, ``cpu`` for the plain path) and
  ``--collectives`` the group's backend (``auto``: NCCL when every process
  has a card of its own, else gloo).  Prints one ``POD_RESULT {json}``
  line and exits with the run's verdict code (0 ok / 12 violation / 75
  preempted-and-checkpointed).

* **launcher** (``--spawn N``): start N localhost worker subprocesses
  around a fresh coordinator port.  SIGTERM to the launcher is forwarded
  to every worker, so pod preemption drills work through it.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys

_TRI = {"auto": None, "on": True, "off": False}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m torchtlc.dist",
        description="torch.distributed pod worker / localhost launcher",
    )
    p.add_argument("--spawn", type=int, default=0, metavar="N",
                   help="launcher mode: start N localhost pod workers")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (worker mode)")
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host", type=int, default=0,
                   help="this worker's rank in the pod")
    p.add_argument("--devices-per-host", type=int, default=1,
                   help="fingerprint-space shards a process (the pod's D "
                        "is this times --num-hosts, a power of two)")
    p.add_argument("--device", default=None,
                   help="the engine's device (default: the card; cpu runs "
                        "the plain torch path)")
    p.add_argument("--collectives", choices=("auto", "gloo", "nccl"),
                   default="auto",
                   help="the group's backend (auto: nccl when every "
                        "process has a card of its own, else gloo)")
    p.add_argument("--ff", action="store_true",
                   help="requests_can_fail=requests_can_timeout=FALSE "
                        "(the small KubeAPI config; default is Model_1)")
    p.add_argument("--chunk", type=int, default=512)
    p.add_argument("--queue-capacity", type=int, default=1 << 14)
    p.add_argument("--fp-capacity", type=int, default=1 << 18)
    p.add_argument("--route-factor", type=float, default=2.0)
    p.add_argument("--sort-free", choices=tuple(_TRI), default="auto")
    p.add_argument("--deferred", choices=tuple(_TRI), default="auto")
    p.add_argument("--obs-slots", type=int, default=0,
                   help="device counter-ring slots (per-host `level` "
                        "events with a host field; 0 = off)")
    p.add_argument("--coverage", action="store_true",
                   help="attach the workload's coverage plane (per-host "
                        "`coverage` delta events)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint/journal base path (per-host files "
                        "{base}.h{pid} / {base}.h{pid}.journal.jsonl)")
    p.add_argument("--ckpt-every", type=int, default=64,
                   help="chunk steps per segment fence")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--reshard", action="store_true",
                   help="resume a checkpoint cut at a different pod "
                        "width (re-partitions the fingerprint space)")
    p.add_argument("--spill", choices=("off", "on"), default="off",
                   help="per-host SpillStore lifeboat for over-capacity "
                        "fingerprint tables")
    p.add_argument("--spill-capacity", type=int, default=1 << 22)
    p.add_argument("--max-segments", type=int, default=None)
    p.add_argument("--progress-every", type=int, default=1)
    return p


def _worker(args) -> int:
    from ..config import ModelConfig
    from ..kernels import ops
    from .pod import DEFAULT_COORDINATOR, init_pod, resolve_collectives, \
        run_pod

    collectives = resolve_collectives(args.collectives, args.device,
                                      args.num_hosts)
    init_pod(args.coordinator or DEFAULT_COORDINATOR, args.num_hosts,
             args.host, collectives=collectives, device=args.device)
    cfg = ModelConfig(False, False) if args.ff else ModelConfig()
    try:
        pr = run_pod(
            cfg,
            chunk=args.chunk,
            queue_capacity=args.queue_capacity,
            fp_capacity=args.fp_capacity,
            route_factor=args.route_factor,
            sort_free=_TRI[args.sort_free],
            deferred=_TRI[args.deferred],
            obs_slots=args.obs_slots,
            coverage=args.coverage,
            ckpt_path=args.ckpt,
            ckpt_every=args.ckpt_every,
            resume=args.resume,
            reshard=args.reshard,
            spill=args.spill,
            spill_capacity=args.spill_capacity,
            max_segments=args.max_segments,
            progress_every=args.progress_every,
            devices_per_host=args.devices_per_host,
            device=args.device,
        )
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    r = pr.result
    print("POD_RESULT " + json.dumps(dict(
        host=pr.host, hosts=pr.hosts, rc=pr.exit_code,
        generated=r.generated, distinct=r.distinct, depth=r.depth,
        queue=r.queue_left, violation=r.violation,
        outdegree=[round(float(v), 6) for v in r.outdegree],
        fp_occupancy=round(float(r.fp_occupancy), 6),
        action_generated={k: int(v)
                          for k, v in r.action_generated.items()},
        action_distinct={k: int(v)
                         for k, v in r.action_distinct.items()},
        wall_s=round(r.wall_s, 3), segments=pr.segments,
        resumed=pr.resumed, resharded=pr.resharded,
        spilled=pr.spilled, spill_flushes=pr.spill_flushes,
        checkpoint=pr.checkpoint, collectives=pr.collectives,
        collective_s={k: round(v, 6) for k, v in pr.timing.items()},
        launches={k: v for k, v in ops.LAUNCHES.items() if v},
    )), flush=True)
    return pr.exit_code


def _spawn(args, argv) -> int:
    coord = args.coordinator or f"127.0.0.1:{_free_port()}"
    child_argv = []
    skip = False
    for a in argv:  # strip "--spawn N" / "--spawn=N" from the worker argv
        if skip:
            skip = False
        elif a == "--spawn":
            skip = True
        elif not a.startswith("--spawn="):
            child_argv.append(a)
    procs = []
    for i in range(args.spawn):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "torchtlc.dist", *child_argv,
             "--coordinator", coord, "--num-hosts", str(args.spawn),
             "--host", str(i)],
            env=dict(os.environ), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))

    def forward(signum, frame):  # pod preemption drills via the launcher
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)

    prev = signal.signal(signal.SIGTERM, forward)
    try:
        outs = [p.communicate()[0] for p in procs]
    finally:
        signal.signal(signal.SIGTERM, prev)
    rcs = [p.returncode for p in procs]
    sys.stdout.write(outs[0])
    for i, (rc, out) in enumerate(zip(rcs, outs)):
        if i and (rc not in (0, 75) or "POD_RESULT" not in out):
            tail = "\n".join(out.splitlines()[-12:])
            print(f"--- worker {i} rc={rc} tail ---\n{tail}",
                  file=sys.stderr)
    if 12 in rcs:
        return 12
    if 75 in rcs:
        return 75
    return max(rcs) if rcs else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = _parser().parse_args(argv)
    if args.spawn:
        return _spawn(args, argv)
    return _worker(args)


if __name__ == "__main__":
    sys.exit(main())
