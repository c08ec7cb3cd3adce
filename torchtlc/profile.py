"""Device-time breakdown of one exhaustive run of the port on the card.

    python3 -m torchtlc.profile [scaled|model1]

Runs the workload once untraced (kernels built, allocator warm), then once
under torch.profiler with CPU and CUDA activity, and prints one JSON line:
the untraced and traced wall, the device-busy time (sum of kernel and
memcpy/memset device time on the one stream) and its share of the traced
wall, and the device time by kernel name, largest first.  The traced wall
includes the profiler's own overhead; the untraced wall is the workload's
figure.
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
    from .engine.bfs import make_engine

    if not torch.cuda.is_available():
        print("torchtlc.profile: no CUDA device", file=sys.stderr)
        return 2
    workload = argv[0] if argv else "scaled"
    if workload == "scaled":
        cfg, kw = scaled_config()
    elif workload == "model1":
        cfg, kw = MODEL_1, dict(chunk=1024, queue_capacity=1 << 15,
                                fp_capacity=1 << 18)
    else:
        raise SystemExit(f"unknown workload {workload!r}")
    init_fn, run_fn, _ = make_engine(cfg, sort_free=False, deferred=False,
                                     **kw)

    def timed_run():
        carry = init_fn()
        torch.cuda.synchronize()
        t0 = time.time()
        carry = run_fn(carry)
        torch.cuda.synchronize()
        return carry, time.time() - t0

    carry, wall = timed_run()
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
        "device": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "counts": [int(carry.generated), int(carry.distinct),
                   int(carry.depth)],
        "steps": run_fn.steps,
        "wall_s": wall,
        "traced_wall_s": traced_wall,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share_of_traced_wall": busy_us / 1e6 / traced_wall,
        "device_ms_by_kernel": [
            {"name": k[:90], "ms": us / 1e3, "calls": n}
            for k, (us, n) in top[:25]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
