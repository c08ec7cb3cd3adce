"""`python -m torchtlc.cli check` on generic-frontend specs against `python
-m jaxtlc.cli check`: the transcript line for line (dates, times, rates
and the lines naming the program and the device masked), the journal's
events (walls, times, paths and versions dropped) and the exit code - the
three shipped specs under -frontend auto (13, 0, 13) and -frontend gen, a
seeded invariant violation and a deadlock (exit 12 with the host oracle's
trace, with and without -traceExpressions), -coverage's per-expression
dump, -fairness wf_process; -frontend gen on a spec outside the subset
(exit 1, the reference's error), the KubeAPI-only flags (exit 1) and the
flags of the sharded engine over the generic backend (-sharded,
-checkpoint, -recover) and -pipeline, which run as the reference's.  The
reference runs its default preflight as the port does."""

import contextlib
import io
import json
import os
import re

import pytest

from jaxtlc.cli import main as j_main
from torchtlc.cli import main
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
RECONCILER = os.path.join(SPECS, "Reconciler.toolbox", "Model_1")
DROP = ("t", "wall_s", "path", "version", "device")


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


def masked(text: str) -> str:
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search"))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _cfg(name):
    return os.path.join(SPECS, f"{name}.toolbox", "Model_1", "MC.cfg")


def _journal(path):
    return [{k: v for k, v in json.loads(line).items() if k not in DROP}
            for line in open(path)]


def _both(cfg, extra, tmp_path=None):
    """(rc, stdout, journal) of the port, then of the reference."""
    out = []
    for name, fn, own in (("port", main, []),
                          ("ref", j_main, [])):
        argv = ["check", cfg, "-noTool", "-workers", "cpu"] + extra + own
        jpath = None
        if tmp_path is not None:
            jpath = str(tmp_path / f"{name}.journal.jsonl")
            argv += ["-journal", jpath]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        out.append((rc, buf.getvalue(), _journal(jpath) if jpath else None))
    return out


SHIPPED = [("RaftElection", 13, "1223 states generated, 492 distinct",
            "EventuallyLeader"),
           ("Reconciler", 0, "155 states generated, 81 distinct", None),
           ("ServiceMesh", 13, "6421 states generated, 1444 distinct",
            "EventuallyDelivered")]


@pytest.mark.parametrize("name,rc,counts,violated", SHIPPED,
                         ids=[s[0] for s in SHIPPED])
def test_shipped_command_equals_reference(name, rc, counts, violated,
                                          tmp_path):
    (t_rc, out, t_j), (j_rc, ref, j_j) = _both(_cfg(name), [], tmp_path)
    assert (t_rc, j_rc) == (rc, rc)
    assert masked(out) == masked(ref)
    assert t_j == j_j
    assert t_j[0]["params"]["frontend"] == "generic"
    if violated:
        assert f"Temporal properties were violated: {violated}" in out
        assert "form a cycle" in out
    else:
        assert counts in out and "<Bump of module Reconciler>" in out


def test_frontend_gen_equals_reference():
    (t_rc, out, _), (j_rc, ref, _) = _both(_cfg("Reconciler"),
                                           ["-frontend", "gen"])
    assert (t_rc, j_rc) == (0, 0)
    assert masked(out) == masked(ref)


def _edited_model(tmp_path, old, new, invariants=()):
    d = tmp_path / "Reconciler.toolbox" / "Model_1"
    d.mkdir(parents=True)
    text = open(os.path.join(RECONCILER, "Reconciler.tla")).read()
    assert old in text
    (d / "Reconciler.tla").write_text(text.replace(old, new))
    cfg = open(os.path.join(RECONCILER, "MC.cfg")).read()
    cfg += "".join(f"INVARIANT {i}\n" for i in invariants)
    (d / "MC.cfg").write_text(cfg)
    return str(d / "MC.cfg")


NEVER = ("====", "NeverObserves == \\A self \\in Controllers : "
         "observed[self] = 0\n====")
DEADLOCK = ("Next == Bump \\/ Terminating \\/", "Next == Bump \\/")


@pytest.mark.parametrize("trace_exprs", [False, True])
def test_invariant_violation_exit12_trace_equals_reference(tmp_path,
                                                           trace_exprs):
    cfg = _edited_model(tmp_path, *NEVER, invariants=["NeverObserves"])
    extra = []
    if trace_exprs:
        te = tmp_path / "te.txt"
        te.write_text("desired + 1\nobserved\n")
        extra = ["-traceExpressions", str(te)]
    (t_rc, out, t_j), (j_rc, ref, j_j) = _both(cfg, extra, tmp_path)
    assert (t_rc, j_rc) == (12, 12)
    assert "Invariant NeverObserves is violated" in out
    assert "State 1: <Initial predicate>" in out
    if trace_exprs:
        assert "/\\ desired + 1 = " in out
    assert masked(out) == masked(ref)
    assert t_j == j_j


@pytest.mark.parametrize("extra,rc", [([], 12), (["-nodeadlock"], 0)])
def test_deadlock_equals_reference(tmp_path, extra, rc):
    cfg = _edited_model(tmp_path, *DEADLOCK)
    (t_rc, out, _), (j_rc, ref, _) = _both(cfg, extra)
    assert (t_rc, j_rc) == (rc, rc)
    if rc == 12:
        assert "Deadlock reached" in out
    assert masked(out) == masked(ref)


@pytest.mark.parametrize("name", ["Reconciler", "ServiceMesh"])
def test_coverage_dump_equals_reference(name):
    (t_rc, out, _), (j_rc, ref, _) = _both(
        _cfg(name), ["-coverage", "-liveness-host"])
    assert t_rc == j_rc
    assert masked(out) == masked(ref)
    if name == "Reconciler":
        assert "|guard:" in out


def test_fairness_wf_process_equals_reference():
    (t_rc, out, _), (j_rc, ref, _) = _both(_cfg("ServiceMesh"),
                                           ["-fairness", "wf_process"])
    assert t_rc == j_rc
    assert "fairness" in out or "violated" in out
    assert masked(out) == masked(ref)


def _errors(fn, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = fn(argv)
    return rc, err.getvalue()


def test_frontend_gen_outside_subset_exits_1_as_reference():
    argv = ["check", _cfg("TwoPhase"), "-workers", "cpu", "-frontend", "gen"]
    rc, err = _errors(main, argv)
    j_rc, j_err = _errors(j_main, argv)
    assert (rc, j_rc) == (1, 1)
    assert "outside the supported PlusCal-translation subset" in err
    assert err == j_err


def test_kubeapi_only_flag_exits_1_as_reference():
    argv = ["check", _cfg("Reconciler"), "-workers", "cpu", "-mutation",
            "delete_noop"]
    rc, err = _errors(main, argv)
    j_rc, j_err = _errors(j_main, argv)
    assert (rc, j_rc) == (1, 1)
    assert "not supported for generic-frontend specs yet" in err
    assert err == j_err


GEN_REFUSED = [["-sharded", "2"], ["-checkpoint", "ck"],
               ["-checkpoint", "ck", "-recover"], ["-pipeline"]]


@pytest.mark.parametrize("flags", GEN_REFUSED,
                         ids=["-".join(f).strip("-") for f in GEN_REFUSED])
def test_unported_gen_flags_exit_2(flags, tmp_path):
    """The flags the port once refused on a generic spec (exit 2) now run
    as the reference's: -sharded 2 and -checkpoint on the sharded engine
    over the generic backend, -checkpoint -recover with no checkpoint
    exits 1 naming the file, -pipeline alone runs the gen engine - the
    exit code, the transcript and the error output equal to the
    reference's."""
    outs = []
    for name, fn in (("port", main), ("ref", j_main)):
        d = tmp_path / name
        d.mkdir()
        argv = ["check", _cfg("ServiceMesh"), "-noTool", "-workers", "cpu"] \
            + [str(d / f) if f == "ck" else f for f in flags]
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = fn(argv)
        outs.append((rc, masked(buf.getvalue()),
                     err.getvalue().replace(str(d), "DIR")))
    (rc, out, err), (j_rc, ref, j_err) = outs
    assert rc == j_rc == (1 if "-recover" in flags else 13)
    assert out == ref
    if rc == 1:
        assert "Error: no checkpoint at" in err
        assert err.splitlines()[-1] == j_err.splitlines()[-1]
    else:
        assert "6421 states generated, 1444 distinct states found" in out
