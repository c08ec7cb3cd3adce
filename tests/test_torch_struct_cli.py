"""`python -m torchtlc.cli check` on struct specs against `python -m
jaxtlc.cli check`: the transcript line for line (dates, times, rates and
the lines naming the program and the device masked) and the exit code of
a clean run, a deadlock, an invariant violation with its trace, a
violated PROPERTY with its lasso and an auto-regrow, the default
preflight on in both; -pipeline on a generic-subset spec under -frontend
auto (the gen engine, as the reference's); every flag of a struct path
the port does not run yet exits 2 naming its ROADMAP item (-coverage,
-pipeline and -spill run now: tests/test_torch_struct_coverage_cli.py,
test_torch_struct_pipeline.py, test_torch_struct_spill.py; -narrow and
-traceExpressions too: their cases hold the run to the reference's, and
tests/test_torch_narrow_cli.py holds the rest)."""

import contextlib
import io
import os
import re

import pytest

from jaxtlc.cli import main as j_main
from torchtlc.cli import main
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
TWO = os.path.join(SPECS, "TwoPhase.toolbox", "Model_1", "MC.cfg")
RAFT = os.path.join(SPECS, "RaftReplication.toolbox", "Model_1", "MC.cfg")


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
    text = re.sub(r"\d+(\.\d+)?s\)", "Ns)", text)  # regrow seconds
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _both(cfg, extra):
    argv = ["check", cfg, "-noTool", "-workers", "cpu"] + extra
    rc, out = _run(main, argv)
    ref_rc, ref = _run(j_main, argv)
    return rc, out, ref_rc, ref


def stale_leader(tmp_path):
    src = open(os.path.join(os.path.dirname(RAFT),
                            "RaftReplication.tla")).read()
    needle = ("/\\ 2 * Cardinality({m \\in Nodes : UpToDate(n, m)}) "
              "> NodeCount\n            ")
    d = tmp_path / "stale"
    d.mkdir()
    (d / "RaftReplication.tla").write_text(src.replace(needle, "", 1))
    (d / "MC.cfg").write_text(open(RAFT).read())
    return str(d / "MC.cfg")


def test_clean_run_transcript_equals_reference():
    rc, out, ref_rc, ref = _both(TWO, ["-nodeadlock"])
    assert (rc, ref_rc) == (0, 0)
    assert "114 states generated, 56 distinct states found" in out
    assert "<Vote of module TwoPhase>: 5:20" in out
    assert masked(out) == masked(ref)


def test_deadlock_exit12_trace_equals_reference():
    rc, out, ref_rc, ref = _both(TWO, [])
    assert (rc, ref_rc) == (12, 12)
    assert "Deadlock reached" in out and "State 1: <Initial predicate>" in out
    assert masked(out) == masked(ref)


def test_invariant_violation_exit12_trace_equals_reference(tmp_path):
    rc, out, ref_rc, ref = _both(stale_leader(tmp_path),
                                 ["-nodeadlock", "-chunk", "256"])
    assert (rc, ref_rc) == (12, 12)
    assert re.search(r"Invariant (CommitWithinLog|CommittedAgree) is "
                     r"violated", out)
    assert masked(out) == masked(ref)


def test_property_violation_exit13_lasso_equals_reference():
    cfg = os.path.join(SPECS, "ServiceMesh.toolbox", "Model_1", "MC.cfg")
    rc, out, ref_rc, ref = _both(cfg, ["-frontend", "struct"])
    assert (rc, ref_rc) == (13, 13)
    assert "Temporal properties were violated: EventuallyDelivered" in out
    assert "form a cycle" in out
    assert masked(out) == masked(ref)


def test_auto_regrow_transcript_equals_reference():
    cfg = os.path.join(SPECS, "TwoPhase.toolbox", "Model_sym", "MC.cfg")
    rc, out, ref_rc, ref = _both(cfg, ["-nodeadlock", "-chunk", "64",
                                       "-fpcap", "1024"])
    assert (rc, ref_rc) == (0, 0)
    assert "810 states generated, 288 distinct states found" in out
    assert "fp_capacity" in out  # the regrow banner
    assert masked(out) == masked(ref)


@pytest.mark.parametrize("spec", ["RaftElection", "Reconciler",
                                  "ServiceMesh"])
def test_generic_subset_spec_under_auto_exits_2(spec, capsys):
    """A generic-subset spec goes to the generic frontend under auto: with
    -pipeline alone it runs the gen engine, as the reference's, which
    ignores the flag there (it once exited 2 here) - the same exit code
    and transcript."""
    cfg = os.path.join(SPECS, f"{spec}.toolbox", "Model_1", "MC.cfg")
    rc, out, ref_rc, ref = _both(cfg, ["-pipeline"])
    assert rc == ref_rc == {"RaftElection": 13, "Reconciler": 0,
                            "ServiceMesh": 13}[spec]
    assert "Finished computing initial states" in out
    assert masked(out) == masked(ref)


# item None: the flag runs since it was ported (-narrow, -traceExpressions:
# here with a missing expression file; -symmetry, -por; -simulate, whose
# walks deadlock too; -infer, which reports candidates and exits 0;
# -artifact-cache, whose store the deadlocking run neither answers from
# nor writes); its case keeps its id and holds the run to the reference's
# exit code and transcript
STRUCT_REFUSED = [
    (["-narrow"], None), (["-symmetry"], None),
    (["-por"], None), (["-simulate"], None),
    (["-infer"], None), (["-artifact-cache", "x"], None),
    (["-traceExpressions", "x.txt"], None),
]


@pytest.mark.parametrize("flags,item", STRUCT_REFUSED,
                         ids=[f[0] for f, _ in STRUCT_REFUSED])
def test_unported_struct_flags_exit_2(flags, item, capsys):
    if item is None:
        rc, out, ref_rc, ref = _both(TWO, flags)
        if flags == ["-infer"]:
            assert rc == ref_rc == 0
            assert "Inference complete" in out
        else:
            assert rc == ref_rc == 12  # TwoPhase deadlocks (no -nodeadlock)
            assert "State 1: <Initial predicate>" in out
        assert masked(out) == masked(ref)
        return
    assert main(["check", TWO, "-workers", "cpu"] + flags) == 2
    err = capsys.readouterr().err
    assert item in err and "error" in err
