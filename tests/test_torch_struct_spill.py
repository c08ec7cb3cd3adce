"""The host spill rung of the struct backend against the reference's, with
zero tolerance: `check` on TwoPhase whose fingerprint-table regrow is
denied (`-faults alloc_fail@1`) takes the spill rung and completes, on one
device and on `-sharded 2` (the port used to stop with exit 75 because its
adapters refused to spill a struct backend); explicit `-spill` takes the
tier at the first saturation.  Transcript (masked as the CLI tests mask),
exit code, journal and the `.spill` sibling's words equal jaxtlc's; and a
spilling struct run stopped by SIGTERM resumes across the two packages
through that sibling.  The generic backend's spill rung (K21 and K18 on
received rows under the sharded spill runtime, K19's stages on one device)
holds to the reference's through the library's supervised entry points,
which run it; the CLI's generic route is unsupervised in both packages,
so the same command there keeps the reference's unsupervised transcript
and writes no sibling."""

import contextlib
import glob
import io
import json
import os
import re

import numpy as np
import pytest

from jaxtlc.cli import main as j_main
from jaxtlc.engine.spill import SpillStore as JStore
from jaxtlc.resil import FaultPlan as JPlan
from jaxtlc.resil import SupervisorOptions as JOpts
from jaxtlc.resil import supervisor as jsup
from test_torch_gen_sharded import _cfg as gen_cfg
from test_torch_gen_sharded import _gen_backends
from test_torch_resil import norm, signature
from test_torch_struct_sharded import _mesh
from torchtlc.cli import main as t_main
from torchtlc.engine.spill import SpillStore
from torchtlc.resil import supervisor as tsup
from torchtlc.resil.faults import FaultPlan
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWO = os.path.join(ROOT, "specs", "TwoPhase.toolbox", "Model_1", "MC.cfg")
SYM = os.path.join(ROOT, "specs", "TwoPhase.toolbox", "Model_sym", "MC.cfg")
SMALL = ["-nodeadlock", "-chunk", "16", "-qcap", "256", "-fpcap", "64"]
DROP = ("t", "wall_s", "t_dispatch", "t_fence", "seconds", "path",
        "version", "device")


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


def _masked(text: str, tmp: str) -> str:
    lines = [ln for ln in text.replace(tmp, "TMP").splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search",
                                   "Resume with: "))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    text = re.sub(r"python -m (jaxtlc|torchtlc)\.cli", "python -m CLI", text)
    text = text.replace(" -workers cpu", "")
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _journal(path):
    return [{k: v for k, v in ev.items() if k not in DROP}
            for ev in map(json.loads, open(path)) if ev["event"] != "phase"]


def _siblings(prefix):
    """{generation file name: (meta, words)} of the .spill siblings."""
    out = {}
    for p in sorted(glob.glob(prefix + "*.spill")):
        z = np.load(p, allow_pickle=False)
        out[os.path.basename(p).split(".", 1)[1]] = (
            str(z["__meta__"]), z["leaf_0"])
    return out


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _both(tmp_path, cfg, extra, small=SMALL):
    """{package: (rc, masked transcript, journal, spill siblings)}."""
    out = {}
    for name, fn, own in (("ref", j_main, []),
                          ("port", t_main, ["-workers", "cpu"])):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        p = str(d / "p")
        rc, text = _run(fn, ["check", cfg, "-noTool", *small,
                             "-checkpoint", p, *extra, *own])
        out[name] = (rc, _masked(text, str(d)),
                     _journal(p + ".journal.jsonl"), _siblings(p))
    return out


CASES = {
    "denied-regrow": ["-faults", "alloc_fail@1"],
    "denied-regrow-sharded-2": ["-faults", "alloc_fail@1", "-sharded", "2"],
    "spill-first": ["-spill"],
    "spill-first-sharded-2": ["-spill", "-sharded", "2"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_struct_spill_command_equals_reference(tmp_path, case):
    """The Motivation's command (and its spill-first twin) on TwoPhase: the
    reference's rung, counts, transcript, journal and spill siblings."""
    out = _both(tmp_path, TWO, CASES[case])
    ref, port = out["ref"], out["port"]
    assert ref[0] == port[0] == 0, port[1][-2000:]
    assert "Capacity ladder [spill] fp_capacity: activate" in port[1] \
        or case.startswith("spill-first")
    assert "Host fingerprint spill tier activated" in port[1]
    assert "114 states generated, 56 distinct states found" in port[1]
    assert "The depth of the complete state graph search is 8." in port[1]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] and set(port[3]) == set(ref[3])
    for gen, (meta, words) in ref[3].items():
        assert port[3][gen][0] == meta, gen
        assert np.array_equal(port[3][gen][1], words), gen


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_struct_spill_recover_across_packages(tmp_path, first, second):
    """A spilling TwoPhase Model_sym run stopped by SIGTERM (exit 75) leaves
    a checkpoint with its host-store sibling; the other package's -recover
    restores both and finishes with the full counts and exit 0."""
    mains = {"ref": (j_main, []), "port": (t_main, ["-workers", "cpu"])}
    p = str(tmp_path / "p")
    base = ["check", SYM, "-noTool", *SMALL, "-spill", "-checkpoint", p,
            "-checkpointevery", "2"]
    fn, own = mains[first]
    rc, text = _run(fn, base + ["-faults", "sigterm@3", *own])
    assert rc == 75 and "Host fingerprint spill tier activated" in text
    assert "139 distinct states found" in text
    assert glob.glob(p + "*.spill"), "no host-store sibling was written"
    fn, own = mains[second]
    rc, text = _run(fn, base + ["-recover", *own])
    assert rc == 0, text[-2000:]
    assert "810 states generated, 288 distinct states found" in text


@pytest.mark.parametrize("shards", [0, 2], ids=["one-device", "sharded-2"])
def test_gen_spill_equals_reference(tmp_path, shards):
    """Reconciler's regrow denied at a 64-slot table under the supervisor
    (one device, and 2 shards through ShardedSpillRuntime over K21 and K18
    on received rows): the reference's spill rung, counts, events and
    host-store words, and a .spill sibling beside every generation."""
    jb, tb = _gen_backends(gen_cfg("Reconciler"))
    kw = dict(chunk=16, queue_capacity=256, fp_capacity=64,
              meta_config={"spec": "Reconciler"})
    ev_t, ev_j = [], []
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    topts = tsup.SupervisorOptions(
        ckpt_path=pt, ckpt_every=4, faults=FaultPlan.parse("alloc_fail@1"),
        on_event=lambda k, i: ev_t.append((k, i)))
    jopts = JOpts(
        ckpt_path=pj, ckpt_every=4, faults=JPlan.parse("alloc_fail@1"),
        on_event=lambda k, i: ev_j.append((k, i)))
    if shards:
        rt = tsup.check_sharded_supervised(None, shards, backend=tb,
                                           device="cpu", opts=topts, **kw)
        rj = jsup.check_sharded_supervised(None, _mesh(shards), backend=jb,
                                           opts=jopts, **kw)
    else:
        rt = tsup.check_supervised(None, backend=tb, device="cpu",
                                   opts=topts, **kw)
        rj = jsup.check_supervised(None, backend=jb, opts=jopts, **kw)
    assert rt.spilled > 0 and rt.spill_hits > 0
    assert (rt.spilled, rt.spill_hits, rt.spill_flushes) == (
        rj.spilled, rj.spill_hits, rj.spill_flushes)
    assert signature(rt.result) == signature(rj.result)
    assert signature(rt.result)[:3] == (155, 81, 13)
    assert norm(ev_t) == norm(ev_j)
    assert ("degrade", "spill") in [(k, i.get("rung")) for k, i in ev_t]
    st, sj = SpillStore.load(pt + ".spill"), JStore.load(pj + ".spill")
    assert st.count == sj.count and np.array_equal(st.table, sj.table)
    assert sorted(p.replace("t.npz", "X") for p in os.listdir(tmp_path)
                  if p.startswith("t.npz")) == sorted(
        p.replace("j.npz", "X") for p in os.listdir(tmp_path)
        if p.startswith("j.npz"))


@pytest.mark.parametrize("extra", [[], ["-sharded", "2"]],
                         ids=["one-device", "sharded-2"])
def test_gen_denied_regrow_command_equals_reference(tmp_path, extra):
    """The denied-regrow command on Reconciler: both packages run the
    generic route unsupervised (the sharded engine with checkpoints), so
    the transcript, exit code and journal are the reference's and neither
    writes a .spill sibling."""
    small = ["-chunk", "16", "-qcap", "256", "-fpcap", "64"]
    out = _both(tmp_path, gen_cfg("Reconciler"),
                ["-faults", "alloc_fail@1", *extra], small)
    ref, port = out["ref"], out["port"]
    assert port[0] == ref[0], port[1][-2000:]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3] == {}
