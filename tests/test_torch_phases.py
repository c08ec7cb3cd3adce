"""`-phase-timing` (torchtlc.obs.phases.PhasedRuntime under the supervisor)
against the reference, with zero tolerance on everything but the walls:

* a phased segment loop - the expand and commit halves of make_stage_pair
  run apart, fenced between them - leaves the fused segment's carry word
  for word after every segment, on KubeAPI's FF corner and on TwoPhase
  Model_sym (struct), at chunk 16384 too, where the two-tier small body
  is chosen as the fused body chooses it;
* a supervised `phase_timing` run's result equals the fused run's and its
  `phase` events of scope "level" cover every BFS level, with the bodies
  of the expand rows summing to the engine's bodies;
* `check -phase-timing -checkpoint P` gives the reference's transcript,
  exit code and journal (walls dropped) on TwoPhase and the KubeAPI FF
  pair, and the flag is ignored where the reference ignores it: under
  `-pipeline`, `-sharded`, on a generic spec and on an unsupervised run.
"""

import contextlib
import io
import json
import os
import re

import pytest

from jaxtlc.cli import main as j_main
from torchtlc.cli import main as t_main
from torchtlc.config import ModelConfig
from torchtlc.engine import bfs as tb
from torchtlc.engine.backend import kubeapi_backend
from torchtlc.engine.interop import carry_to_numpy
from torchtlc.obs.phases import PhaseRecorder, PhasedRuntime
from torchtlc.resil.supervisor import SupervisorOptions, check_supervised
from torchtlc.struct.cache import get_backend
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYM = os.path.join(ROOT, "specs", "TwoPhase.toolbox", "Model_sym", "MC.cfg")
TWO = os.path.join(ROOT, "specs", "TwoPhase.toolbox", "Model_1", "MC.cfg")
RECON = os.path.join(ROOT, "specs", "Reconciler.toolbox", "Model_1",
                     "MC.cfg")
FF = ModelConfig(False, False)
DROP = ("t", "wall_s", "t_dispatch", "t_fence", "seconds", "path",
        "version", "device")


def _backend(name):
    if name == "FF":
        return kubeapi_backend(FF)
    return get_backend(load(SYM), False)


GEOMS = {
    "FF-sorted": ("FF", dict(chunk=128, queue_capacity=1 << 12,
                             fp_capacity=1 << 15)),
    "FF-slab-deferred-ring": ("FF", dict(chunk=2048, queue_capacity=1 << 13,
                                         fp_capacity=1 << 15, obs_slots=16)),
    "TwoPhase_sym-sorted": ("sym", dict(chunk=16, queue_capacity=1 << 9,
                                        fp_capacity=1 << 11)),
    "TwoPhase_sym-two-tier": ("sym", dict(chunk=1 << 14,
                                          queue_capacity=1 << 9,
                                          fp_capacity=1 << 11)),
}


@pytest.mark.parametrize("geom", list(GEOMS))
def test_phased_segments_equal_fused_segments(geom):
    name, kw = GEOMS[geom]
    backend = _backend(name)
    init_fn, _, step_fn = tb.make_backend_engine(backend, device="cpu", **kw)
    fused = tb.make_segment(step_fn, 4)
    rec = PhaseRecorder()
    rt = PhasedRuntime(backend, kw["chunk"], kw["queue_capacity"],
                       kw["fp_capacity"], obs_slots=kw.get("obs_slots", 0),
                       device="cpu", recorder=rec)
    phased = rt.segment_fn(4)
    a, b = init_fn(), rt.init_fn()
    segments = 0
    while not tb.carry_done(a):
        a, b = fused(a), phased(b)
        segments += 1
        wa, wb = carry_to_numpy(a), carry_to_numpy(b)
        assert set(wa) == set(wb)
        for k in wa:
            assert (wa[k] == wb[k]).all(), (segments, k)
    assert tb.carry_done(b)
    rows = rec.drain()
    assert rows and all(r["wall_s"] >= 0 for r in rows)
    depth = int(a.depth)
    assert {r["index"] for r in rows} == set(range(1, depth + 1))


def test_supervised_phase_timing_level_rows():
    events = []
    opts = SupervisorOptions(ckpt_every=8, phase_timing=True,
                             on_event=lambda k, i: events.append((k, i)))
    kw = dict(chunk=128, queue_capacity=1 << 12, fp_capacity=1 << 15,
              obs_slots=256, device="cpu")
    sr = check_supervised(FF, opts=opts, **kw)
    plain = check_supervised(FF, opts=SupervisorOptions(ckpt_every=8), **kw)
    r, p = sr.result, plain.result
    assert (r.generated, r.distinct, r.depth, r.action_generated,
            r.action_distinct, r.outdegree) == (
        p.generated, p.distinct, p.depth, p.action_generated,
        p.action_distinct, p.outdegree) == (
        17020, 8203, 109, r.action_generated, r.action_distinct,
        r.outdegree)
    lv = [i for k, i in events if k == "phase" and i["scope"] == "level"]
    assert {i["index"] for i in lv} == set(range(1, r.depth + 1))
    for phase in ("expand", "commit"):
        walls = [i["wall_s"] for i in lv if i["phase"] == phase]
        assert len(walls) >= r.depth and sum(walls) > 0
    levels = [i for k, i in events if k == "level"]
    assert sum(i["bodies"] for i in lv if i["phase"] == "expand") == \
        levels[-1]["bodies"]


MC_TLA = """---- MODULE MC ----
EXTENDS KubeAPI, TLC

\\* CONSTANT definitions @modelParameterConstants:1REQUESTS_CAN_FAIL
const_fail ==
FALSE

\\* CONSTANT definitions @modelParameterConstants:2REQUESTS_CAN_TIMEOUT
const_to ==
FALSE
====
"""

MC_CFG = """CONSTANT defaultInitValue = defaultInitValue
CONSTANT REQUESTS_CAN_FAIL <- const_fail
CONSTANT REQUESTS_CAN_TIMEOUT <- const_to
SPECIFICATION Spec
INVARIANT TypeOK
INVARIANT OnlyOneVersion
"""


@pytest.fixture(scope="module")
def ff_cfg(tmp_path_factory):
    d = tmp_path_factory.mktemp("phases") / "Model_FF"
    d.mkdir()
    (d / "MC.tla").write_text(MC_TLA)
    (d / "MC.cfg").write_text(MC_CFG)
    return str(d / "MC.cfg")


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


def _masked(text: str, tmp: str = "") -> str:
    if tmp:
        text = text.replace(tmp, "TMP")
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search"))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _journal(path):
    return [{k: v for k, v in ev.items() if k not in DROP}
            for ev in map(json.loads, open(path))]


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


CASES = {
    "twophase": (TWO, ["-nodeadlock", "-chunk", "16"], True),
    "kubeapi-ff": (None, ["-chunk", "128", "-qcap", "4096", "-fpcap",
                          "16384"], True),
    "pipeline-ignored": (TWO, ["-nodeadlock", "-chunk", "16", "-pipeline"],
                         False),
    "sharded-ignored": (TWO, ["-nodeadlock", "-chunk", "16", "-sharded",
                              "2"], False),
    "gen-ignored": (RECON, [], False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_phase_timing_command_equals_reference(tmp_path, ff_cfg, case):
    """`-phase-timing -checkpoint P`: the reference's transcript, exit code
    and journal (walls dropped), level-scope rows exactly where the
    reference writes them."""
    cfg, extra, measured = CASES[case]
    cfg = cfg or ff_cfg
    out = {}
    for name, fn, own in (("ref", j_main, []),
                          ("port", t_main, ["-workers", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        rc, text = _run(fn, ["check", cfg, "-noTool", "-phase-timing",
                             "-checkpoint", str(d / "p"), *extra, *own])
        out[name] = (rc, _masked(text, str(d)),
                     _journal(str(d / "p") + ".journal.jsonl"))
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]
    assert out["port"][2] == out["ref"][2]
    lv = [e for e in out["port"][2]
          if e["event"] == "phase" and e["scope"] == "level"]
    assert bool(lv) == measured
    if measured:
        final = next(e for e in out["port"][2] if e["event"] == "final")
        assert {e["index"] for e in lv} == set(range(1, final["depth"] + 1))


def test_phase_timing_unsupervised_is_ignored():
    """-no-auto-grow without -checkpoint runs the engine unsupervised: the
    flag changes nothing, as in the reference."""
    argv = ["check", TWO, "-noTool", "-nodeadlock", "-no-auto-grow",
            "-phase-timing"]
    rc, out = _run(t_main, argv + ["-workers", "cpu"])
    ref_rc, ref = _run(j_main, argv)
    assert rc == ref_rc == 0
    assert _masked(out) == _masked(ref)
