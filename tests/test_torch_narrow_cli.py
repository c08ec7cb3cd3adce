"""`-narrow` and `-traceExpressions` through the port's `check` command
against `python -m jaxtlc.cli check`, at the shipped sizes: the transcript
line for line (dates, times, rates, the temporary directory and the lines
naming the program and the device masked), the exit code and the journal.

- struct `-narrow` on RaftReplication (40 -> 28 bits, 1 packed word),
  on the five guard-bounded counters of tests/test_absint.py (35 -> 10
  bits, 2 -> 1 words) - supervised and not, deferred, with `-coverage`,
  `-pipeline`, `-sharded 2` (the narrowed text through K21, every trap
  kept) - and on TwoPhase (certified, nothing to narrow), with the spill
  rung (a denied regrow);
- a narrowed checkpoint stopped by SIGTERM resumes across the two
  packages with `-recover -narrow`, and `-recover` without `-narrow` is
  refused (the meta's bound digest) as the reference refuses it;
- the cardinality lie through the command: the certificate trips, the
  banner prints once, the verdict is "error" and the exit code 1;
- `-narrow` on a generic spec (Reconciler) and on the KubeAPI pair is
  ignored, as the reference ignores it - this test failed while the port
  refused the flag (exit 2);
- `-traceExpressions` on the KubeAPI violation (FF, `-mutation
  delete_noop`, exit 12) and on a struct violation (TwoPhase's deadlock;
  a missing expression file there is a case of
  tests/test_torch_struct_cli.py)."""

import contextlib
import dataclasses
import io
import json
import os
import re

import pytest

import jaxtlc.struct.cache as j_cache
import torchtlc.struct.cache as t_cache
from jaxtlc.cli import main as j_main
from test_torch_absint import SLOTC, SLOTC_CFG, WIDE, WIDE_CFG, write_model
from test_torch_cli import MC_CFG, MC_TLA
from torchtlc.cli import main as t_main
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
TWO = os.path.join(SPECS, "TwoPhase.toolbox", "Model_1", "MC.cfg")
RAFT = os.path.join(SPECS, "RaftReplication.toolbox", "Model_1", "MC.cfg")
RECON = os.path.join(SPECS, "Reconciler.toolbox", "Model_1", "MC.cfg")
DROP = ("t", "wall_s", "t_dispatch", "t_fence", "seconds", "path",
        "version", "device")


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
    text = re.sub(r"\d+(\.\d+)?s\)", "Ns)", text)  # regrow seconds
    text = re.sub(r"python -m (jaxtlc|torchtlc)\.cli", "python -m CLI", text)
    text = text.replace(" -workers cpu", "")
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _journal(path):
    return [{k: v for k, v in ev.items() if k not in DROP}
            for ev in map(json.loads, open(path)) if ev["event"] != "phase"]


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _both(tmp_path, cfg, flags, checkpoint=False):
    """{package: (rc, masked transcript, journal or None)}."""
    out = {}
    for name, fn, own in (("ref", j_main, []),
                          ("port", t_main, ["-workers", "cpu"])):
        d = tmp_path / name
        d.mkdir(parents=True, exist_ok=True)
        p = str(d / "p")
        extra = ["-checkpoint", p] if checkpoint else []
        rc, text = _run(fn, ["check", cfg, "-noTool", *flags, *extra, *own])
        out[name] = (rc, _masked(text, str(d)),
                     _journal(p + ".journal.jsonl") if checkpoint else None)
    return out


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("wide_cli"), "Wide", WIDE,
                       WIDE_CFG)


NARROW = ["-nodeadlock", "-narrow"]
# the synthetic model is inside the generic subset: -frontend struct
W64 = NARROW + ["-chunk", "64", "-frontend", "struct"]
# (model, flags, journal, exit code); "wide" is the synthetic model
CASES = {
    "raft": (RAFT, NARROW + ["-chunk", "256"], True, 0),
    "wide-unsupervised-deferred": ("wide", W64 + [
        "-no-auto-grow", "-deferred-inv", "-sort-free"], False, 0),
    "wide-coverage": ("wide", W64 + ["-coverage"], True, 0),
    "wide-pipeline": ("wide", W64 + ["-pipeline"], False, 0),
    "wide-sharded-2": ("wide", W64 + ["-sharded", "2"], True, 0),
    "twophase-certified-not-narrowed": (TWO, NARROW, False, 0),
    "twophase-spill-rung": (TWO, NARROW + [
        "-chunk", "16", "-qcap", "256", "-fpcap", "64", "-faults",
        "alloc_fail@1"], True, 0),
    "reconciler-ignored": (RECON, ["-narrow"], False, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_narrow_command_equals_reference(tmp_path, wide, case):
    cfg, flags, journal, want = CASES[case]
    out = _both(tmp_path, wide if cfg == "wide" else cfg, flags,
                checkpoint=journal)
    assert out["port"][0] == out["ref"][0] == want
    assert "Finished computing initial states" in out["port"][1]
    assert out["port"] == out["ref"]
    if cfg == RAFT:
        assert "from 40 to 28 bits (2 -> 1 uint32 words)" in out["port"][1]
        assert "17431 states generated, 7279 distinct" in out["port"][1]
    if cfg == "wide":
        assert "from 35 to 10 bits (2 -> 1 uint32 words)" in out["port"][1]
        assert "3841 states generated, 1024 distinct" in out["port"][1]


@pytest.fixture(scope="module")
def ff_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("narrow_cli") / "Model_FF"
    d.mkdir()
    (d / "MC.tla").write_text(MC_TLA)
    (d / "MC.cfg").write_text(MC_CFG)
    return d


FF_SMALL = ["-chunk", "128", "-qcap", "4096", "-fpcap", "16384"]


def test_narrow_on_kubeapi_is_ignored(tmp_path, ff_dir):
    """The KubeAPI pair with -narrow stopped by SIGTERM: the reference's
    transcript, journal and exit code (75), and a resume command that
    repeats -narrow, as the reference's (jaxtlc/api.py:791-792); the clean
    run is test_torch_cli.py's narrow case."""
    stopped = _both(tmp_path / "stop", str(ff_dir / "MC.cfg"),
                    ["-narrow", *FF_SMALL, "-checkpointevery", "16",
                     "-faults", "sigterm@2"], checkpoint=True)
    assert stopped["port"][0] == stopped["ref"][0] == 75
    assert stopped["port"] == stopped["ref"]
    assert "-recover -chunk 128 -narrow" in stopped["port"][1]


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_narrowed_checkpoint_resumes_across_packages(tmp_path, wide, first,
                                                     second):
    """A narrowed run (2 -> 1 words) stopped by SIGTERM resumes in the
    other package with -recover -narrow; -recover without -narrow is
    refused first (the checkpoint's bound digest) in both packages."""
    mains = {"ref": (j_main, []), "port": (t_main, ["-workers", "cpu"])}
    p = str(tmp_path / "p")
    base = ["check", wide, "-noTool", "-nodeadlock", "-chunk", "16",
            "-frontend", "struct", "-checkpoint", p, "-checkpointevery", "4"]
    fn, own = mains[first]
    rc, text = _run(fn, base + ["-narrow", "-faults", "sigterm@3", *own])
    assert rc == 75, text[-2000:]
    refused = {}
    for name, (fn_, own_) in mains.items():
        with pytest.raises(ValueError, match="checkpoint config mismatch"):
            _run(fn_, base + ["-recover", *own_])
        refused[name] = True
    assert refused == {"ref": True, "port": True}
    fn, own = mains[second]
    rc, text = _run(fn, base + ["-recover", "-narrow", *own])
    assert rc == 0, text[-2000:]
    assert "3841 states generated, 1024 distinct states found" in text


def test_cardinality_lie_command_error_verdict(tmp_path, monkeypatch):
    """The cardinality lie (|msgs| <= 1 on the slot-count spec) through the
    command in both packages: the certificate trips, the banner prints
    once, the journal's verdict is "error", the exit code 1 - the same
    transcript and journal."""
    cfg = write_model(tmp_path, "SlotC", SLOTC, SLOTC_CFG)
    for mod in (t_cache, j_cache):
        real = mod.get_bounds

        def lying(m, real=real):
            rep = real(m)
            return dataclasses.replace(
                rep, card_bounds={**rep.card_bounds, "msgs": 1})

        monkeypatch.setattr(mod, "get_bounds", lying)
    out = _both(tmp_path, cfg, ["-frontend", "struct", "-narrow",
                                "-nodeadlock", "-chunk", "64"],
                checkpoint=True)
    rc, text, journal = out["port"]
    assert rc == out["ref"][0] == 1
    assert text.count("ERROR: runtime certificate violation - a reachable "
                      "state lies outside") == 1
    assert "ERROR: runtime certificate violation: a reachable" in text
    assert [e["verdict"] for e in journal if e["event"] == "final"][-1] == (
        "error")
    assert out["port"] == out["ref"]


TEXPR = ('NObjects == Cardinality(apiState)\n'
         'ClientPC == pc["Client"]\n')
TWO_TEXPR = ('Prepared == Cardinality(tmPrepared)\n'
             'TM == tmState\n')


def test_trace_expressions_kubeapi_violation(tmp_path, ff_dir):
    te = tmp_path / "te.txt"
    te.write_text(TEXPR)
    out = _both(tmp_path, str(ff_dir / "MC.cfg"), [
        "-mutation", "delete_noop", "-traceExpressions", str(te),
        *FF_SMALL])
    rc, text, _ = out["port"]
    assert rc == out["ref"][0] == 12
    n_states = len(re.findall(r"^State \d+: ", text, re.M))
    assert n_states > 0 and text.count("/\\ NObjects = ") == n_states
    assert out["port"] == out["ref"]


def test_trace_expressions_struct_violation(tmp_path):
    """TwoPhase without -nodeadlock deadlocks (exit 12): every trace state
    carries the expressions, as in the reference."""
    te = tmp_path / "te.txt"
    te.write_text(TWO_TEXPR)
    out = _both(tmp_path, TWO, ["-traceExpressions", str(te)])
    rc, text, _ = out["port"]
    assert rc == out["ref"][0] == 12
    n_states = len(re.findall(r"State \d+: <", text))
    assert n_states > 0 and text.count("/\\ Prepared = ") == n_states
    assert out["port"] == out["ref"]
