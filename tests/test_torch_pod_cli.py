"""``python -m torchtlc.dist`` on the CPU: a 2-process gloo pod of D = 4
shards against the reference's pod (jaxtlc.dist.run_pod at D = 4 on the
conftest mesh), and the reference's drills through the launcher -
SIGTERM, exit 75 and --resume; a resume at another width refused, then
--reshard; a table too small, exit 12, then --spill on.  Every comparison
is exact."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.dist import pod as jpod
from torchtlc.dist import pod as tpod
from torchtlc.obs import journal as tjr
from torchtlc.obs.coverage import coverage_from_events
from torchtlc.obs.views import fold_pod_levels, merge_journals
from torchtlc.testing import one_thread, subprocess_env

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FF_COUNTS = (17020, 8203, 109)
POD = ["--ff", "--chunk", "128", "--queue-capacity", "4096",
       "--fp-capacity", "16384", "--device", "cpu"]


def _pod(argv, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "torchtlc.dist", "--spawn", "2", *argv],
        cwd=ROOT, env=subprocess_env(), capture_output=True, text=True,
        timeout=timeout)


def _result(stdout):
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("POD_RESULT "))
    return json.loads(line[len("POD_RESULT "):])


def _counts(out):
    return (out["generated"], out["distinct"], out["depth"])


def _folded(base, hosts):
    events = merge_journals(*(
        tjr.read(f"{base}.h{h}.journal.jsonl", validate=False)
        for h in range(hosts)))
    levels = [e for e in fold_pod_levels(events)
              if e.get("event") == "level"]
    strip = ("t", "v", "host", "fp_load")
    return ([{k: v for k, v in e.items() if k not in strip}
             for e in levels], coverage_from_events(events))


def test_two_process_pod_equals_reference(tmp_path):
    """The port's 2-process gloo pod (2 shards a process) with the counter
    ring and coverage on gives the reference's pod at D = 4: counts,
    per-action counts, outdegree, every shard's table (and every other
    leaf of the final snapshot), and the two journals fold to the
    reference's level rows and site table."""
    base = str(tmp_path / "port.ckpt")
    proc = _pod(["--devices-per-host", "2", *POD, "--obs-slots", "128",
                 "--coverage", "--ckpt", base, "--ckpt-every", "64"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = _result(proc.stdout)
    assert out["hosts"] == 2 and out["rc"] == 0
    assert out["collectives"] == "gloo"
    ref_base = str(tmp_path / "ref.ckpt")
    pr = jpod.run_pod(JConfig(False, False), devices=4, chunk=128,
                      queue_capacity=4096, fp_capacity=16384, obs_slots=128,
                      coverage=True, ckpt_path=ref_base, ckpt_every=64)
    r = pr.result
    assert _counts(out) == (r.generated, r.distinct, r.depth) == FF_COUNTS
    assert out["action_generated"] == {k: int(v) for k, v in
                                       r.action_generated.items()}
    assert out["action_distinct"] == {k: int(v) for k, v in
                                      r.action_distinct.items()}
    assert out["outdegree"] == [float(v) for v in r.outdegree]
    jm, jfull = jpod.load_pod_full(ref_base)
    tm, tfull = tpod.load_pod_full(base)
    assert tm["num_hosts"] == 2 and jm["num_hosts"] == 1
    assert tm["pod_fields"] == jm["pod_fields"]
    for f in tm["pod_fields"]:
        a, b = np.asarray(getattr(jfull, f)), getattr(tfull, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    levels, cov = _folded(base, 2)
    ref_levels, ref_cov = _folded(ref_base, 1)
    assert len(levels) == 109 and levels == ref_levels
    assert cov["sites"] == ref_cov["sites"]
    for name, g in out["action_generated"].items():
        assert cov["sites"].get(name, 0) == g


def test_pod_drills_through_the_launcher(tmp_path):
    """SIGTERM to the launcher: exit 75 with a file a host, and --resume
    completes to the counts; a resume at --devices-per-host 1 is refused
    with the --reshard hint, and --reshard completes; a table too small
    exits 12 (VIOL_FPSET_FULL), and --spill on completes with spilled
    states."""
    base = str(tmp_path / "pod.ckpt")
    drill = ["--devices-per-host", "2", *POD, "--ckpt", base,
             "--ckpt-every", "1"]
    launcher = subprocess.Popen(
        [sys.executable, "-m", "torchtlc.dist", "--spawn", "2", *drill],
        cwd=ROOT, env=subprocess_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    deadline = time.time() + 60
    while not os.path.exists(base + ".h1") and time.time() < deadline:
        time.sleep(0.05)
    launcher.send_signal(signal.SIGTERM)
    stdout, stderr = launcher.communicate(timeout=120)
    assert launcher.returncode == 75, stdout[-2000:] + stderr[-2000:]
    out = _result(stdout)
    assert out["rc"] == 75 and _counts(out) != FF_COUNTS
    assert os.path.exists(base + ".h0") and os.path.exists(base + ".h1")

    other = str(tmp_path / "other.ckpt")
    for h in (0, 1):
        shutil.copy(f"{base}.h{h}", f"{other}.h{h}")

    resumed = _pod([*drill[:-1], "64", "--resume"])
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    out = _result(resumed.stdout)
    assert _counts(out) == FF_COUNTS and out["resumed"]

    refused = _pod(["--devices-per-host", "1", *POD, "--ckpt", other,
                    "--resume"])
    assert refused.returncode not in (0, 12, 75)
    assert "--reshard" in refused.stdout + refused.stderr
    resharded = _pod(["--devices-per-host", "1", *POD, "--ckpt", other,
                      "--resume", "--reshard", "--ckpt-every", "64"])
    assert resharded.returncode == 0, resharded.stderr[-2000:]
    out = _result(resharded.stdout)
    assert _counts(out) == FF_COUNTS and out["resharded"]

    small = ["--ff", "--chunk", "128", "--queue-capacity", "4096",
             "--fp-capacity", "2048", "--device", "cpu",
             "--devices-per-host", "1"]
    full = _pod(small)
    assert full.returncode == 12
    out = _result(full.stdout)
    assert out["violation"] == 6  # VIOL_FPSET_FULL
    spilled = _pod([*small, "--spill", "on", "--spill-capacity", "16384"])
    assert spilled.returncode == 0, spilled.stderr[-2000:]
    out = _result(spilled.stdout)
    assert _counts(out) == FF_COUNTS
    assert out["spilled"] > 0 and out["spill_flushes"] > 0


@pytest.mark.parametrize("argv,msg", [
    (["--devices-per-host", "3"], "power of two"),
    (["--collectives", "nccl"], "nccl"),
])
def test_pod_refuses_what_it_cannot_run(argv, msg):
    """D must be a power of two; NCCL on the CPU engine does not start and
    fails the run - nothing carries on differently."""
    proc = _pod([*POD, *argv], timeout=60)
    assert proc.returncode not in (0, 12, 75)
    assert msg in proc.stdout + proc.stderr
