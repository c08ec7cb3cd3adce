"""Device-time breakdown of one exhaustive run of the port on the card.

    python3 -m torchtlc.profile [scaled|model1] [sorted|auto] [cov] [pipeline]
    python3 -m torchtlc.profile [scaled|model1] ab [PAIRS] [pipeline]

``sorted`` runs the immediate sorted mode (``sort_free=False,
deferred=False``); ``auto`` the modes the reference resolves at the
workload's chunk (both on at chunk >= 2048; Model_1 then runs at chunk
2048, the scaled workload at its own 131,072) with the counter ring on the
scaled run; ``cov`` adds the device coverage plane (kernel K10 per
step); ``pipeline`` runs the pipelined body.  Runs the workload once untraced (kernels built, allocator
warm), then once under torch.profiler with CPU and CUDA activity, and
prints one JSON line: the untraced and traced wall, the device-busy time
(sum of kernel and memcpy/memset device time on the one stream) and its
share of the traced wall, the device time by kernel name, largest first,
and - in the auto mode - the steps that took the slab's sorted fallback
and the device time of the per-step claimant-count read: CUDA events on
either side of it (from the moment the work before the read is done to the
moment the host has the value back).  The traced wall includes the
profiler's own overhead; the untraced wall is the workload's figure.

``ab`` compares the two modes on one card in one process, at the chunk
the auto mode uses (Model_1: 2048): after one untimed run of each, PAIRS
(default 3) pairs of untraced runs in turns sorted, auto, auto, sorted,
...; prints one JSON line with every wall.  ``ab ... pipeline`` compares
the unpipelined and the pipelined body instead, both in the auto modes
(the scaled run with the counter ring), in turns unpipelined, pipelined,
pipelined, unpipelined, ...
"""

from __future__ import annotations

import json
import sys
import time


def main(argv) -> int:
    import subprocess

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .config import MODEL_1, scaled_config
    from .engine import fpset
    from .engine.bfs import make_engine

    if not torch.cuda.is_available():
        print("torchtlc.profile: no CUDA device", file=sys.stderr)
        return 2
    workload = argv[0] if argv else "scaled"
    mode = argv[1] if len(argv) > 1 else "sorted"
    if mode not in ("sorted", "auto", "ab"):
        raise SystemExit(f"unknown mode {mode!r}")
    if workload == "scaled":
        cfg, kw = scaled_config()
        if mode == "auto" or (mode == "ab" and "pipeline" in argv[2:]):
            kw = dict(kw, obs_slots=256)
    elif workload == "model1":
        cfg = MODEL_1
        kw = dict(chunk=1024 if mode == "sorted" else 2048,
                  queue_capacity=1 << 15, fp_capacity=1 << 18)
    else:
        raise SystemExit(f"unknown workload {workload!r}")
    sorted_modes = dict(sort_free=False, deferred=False)
    pipeline = "pipeline" in argv[2:]
    if mode == "ab":
        pairs = [int(a) for a in argv[2:] if a.isdigit()]
        return ab(workload, cfg, kw, sorted_modes, pairs[0] if pairs else 3,
                  pipeline)
    modes = sorted_modes if mode == "sorted" else {}
    coverage = "cov" in argv[2:]
    init_fn, run_fn, _ = make_engine(cfg, **modes, **kw, coverage=coverage,
                                     pipeline=pipeline)

    reads = []
    count = fpset.claimant_count

    def timed_count(n_cand):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        v = count(n_cand)
        b.record()
        reads.append((a, b))
        return v

    def timed_run():
        carry = init_fn()
        torch.cuda.synchronize()
        t0 = time.time()
        carry = run_fn(carry)
        torch.cuda.synchronize()
        return carry, time.time() - t0

    carry, wall = timed_run()
    fallbacks = dict(run_fn.slab_fallbacks)
    steps_by_width = dict(run_fn.steps_by_width)
    fpset.claimant_count = timed_count
    try:
        carry, read_wall = timed_run()
    finally:
        fpset.claimant_count = count
    torch.cuda.synchronize()
    read_ms = [a.elapsed_time(b) for a, b in reads]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        carry, traced_wall = timed_run()
    by_name = {}
    for ev in prof.key_averages():
        # device-side records only (kernels, memcpy, memset): the CPU ops
        # that launched them carry the same time again
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            by_name[ev.key] = (dev_us, ev.count)
    busy_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print(json.dumps({
        "workload": workload,
        "mode": mode,
        "coverage": coverage,
        "pipeline": pipeline,
        "chunk": kw["chunk"],
        "device": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "counts": [int(carry.generated), int(carry.distinct),
                   int(carry.depth)],
        "steps": run_fn.steps,
        "steps_by_width": steps_by_width,
        "slab_fallbacks": fallbacks,
        "wall_s": wall,
        "wall_with_read_events_s": read_wall,
        "claimant_reads": len(read_ms),
        "claimant_read_ms_total": sum(read_ms),
        "claimant_read_ms_mean": sum(read_ms) / len(read_ms) if read_ms
        else None,
        "traced_wall_s": traced_wall,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share_of_traced_wall": busy_us / 1e6 / traced_wall,
        "device_ms_by_kernel": [
            {"name": k[:90], "ms": us / 1e3, "calls": n}
            for k, (us, n) in top[:25]],
    }))
    return 0


def ab(workload, cfg, kw, sorted_modes, pairs: int,
       pipeline: bool = False) -> int:
    """Untraced walls of the sorted and the default modes - or, with
    `pipeline`, of the unpipelined and the pipelined body in the default
    modes - in turns."""
    import subprocess

    import torch

    from .engine.bfs import make_engine

    if pipeline:
        engines = {"unpipelined": make_engine(cfg, **kw),
                   "pipelined": make_engine(cfg, **kw, pipeline=True)}
    else:
        engines = {"sorted": make_engine(cfg, **sorted_modes, **kw),
                   "auto": make_engine(cfg, **kw)}
    first, second = engines

    def wall(name):
        init_fn, run_fn, _ = engines[name]
        carry = init_fn()
        torch.cuda.synchronize()
        t0 = time.time()
        carry = run_fn(carry)
        torch.cuda.synchronize()
        return time.time() - t0, int(carry.distinct)

    for name in engines:  # untimed warm-up of each
        wall(name)
    walls = {name: [] for name in engines}
    order = []
    for p in range(pairs):
        for name in ((first, second) if p % 2 == 0 else (second, first)):
            w, distinct = wall(name)
            walls[name].append(w)
            order.append(name)
    print(json.dumps({
        "workload": workload, "mode": "ab", "pipeline": pipeline,
        "chunk": kw["chunk"],
        "device": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "distinct": distinct, "order": order, "wall_s": walls,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
