"""The port's `check` command (torchtlc.cli.main, -workers cpu) against
jaxtlc.cli on the FF corner: exit 0 with the FF counts and a transcript
equal to the reference's; tool-mode framing; delete_noop exits 12 with
the reference's counterexample; -checkpoint / -recover; a failing spill
write exits 75 and resumes; every flag of a path not ported yet is
refused by name (the flags refused once - -narrow, -traceExpressions,
-fpset DiskFPSet, the artifact cache's - now run as the reference's).

Transcripts are compared after masking the dates, times and rates and
the two lines that name the program and the device (2262, 2187)."""

import os
import re
import socket

import pytest

from jaxtlc.cli import main as j_main
from torchtlc.cli import UNPORTED, main
from torchtlc.testing import one_thread

one_thread()

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

SMALL = ["-chunk", "128", "-qcap", "4096", "-fpcap", "16384", "-workers",
         "cpu"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli") / "Model_FF"
    d.mkdir()
    (d / "MC.tla").write_text(MC_TLA)
    (d / "MC.cfg").write_text(MC_CFG)
    return d


def _run(fn, argv, capsys):
    rc = fn(argv)
    return rc, capsys.readouterr().out


def masked(text: str) -> str:
    """The transcript without dates, times, rates and the program and
    device lines."""
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search"))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


@pytest.fixture(scope="module")
def reference_runs(model_dir):
    """The reference CLI's transcripts: the clean run and delete_noop."""
    import contextlib
    import io

    out = {}
    for name, extra in (("clean", []),
                        ("violation", ["-mutation", "delete_noop"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = j_main(["check", str(model_dir / "MC.cfg"), "-noTool"]
                        + SMALL + extra)
        out[name] = (rc, buf.getvalue())
    return out


def test_clean_run_exit0_transcript_equals_reference(model_dir, capsys,
                                                     reference_runs):
    rc, out = _run(main, ["check", str(model_dir / "MC.cfg"), "-noTool"]
                   + SMALL, capsys)
    assert rc == 0
    assert "17020" in out and "8203" in out
    assert "Model checking completed. No error has been found" in out
    ref_rc, ref = reference_runs["clean"]
    assert ref_rc == 0
    assert masked(out) == masked(ref)


def test_tool_mode_framing(model_dir, capsys):
    rc, out = _run(main, ["check", str(model_dir / "MC.cfg")] + SMALL,
                   capsys)
    assert rc == 0
    assert "@!@!@STARTMSG 2193" in out
    assert "@!@!@STARTMSG 2199" in out
    assert "@!@!@ENDMSG" in out


def test_violation_exit12_trace_equals_reference(model_dir, capsys,
                                                 reference_runs):
    rc, out = _run(main, ["check", str(model_dir / "MC.cfg"), "-noTool",
                          "-mutation", "delete_noop"] + SMALL, capsys)
    assert rc == 12
    assert "assert" in out.lower() and "/\\ apiState" in out
    assert "State 1" in out
    ref_rc, ref = reference_runs["violation"]
    assert ref_rc == 12
    assert masked(out) == masked(ref)


def test_checkpoint_and_recover(model_dir, tmp_path, capsys):
    ck = str(tmp_path / "run.ckpt.npz")
    rc, _ = _run(main, ["check", str(model_dir / "MC.cfg"), "-noTool",
                        "-checkpoint", ck, "-checkpointevery", "16"] + SMALL,
                 capsys)
    assert rc == 0 and os.path.exists(ck)
    assert os.path.exists(ck + ".journal.jsonl")
    rc, out = _run(main, ["check", str(model_dir / "MC.cfg"), "-noTool",
                          "-checkpoint", ck, "-recover"] + SMALL, capsys)
    assert rc == 0
    assert "17020" in out and "8203" in out
    assert "Starting recovery from checkpoint" in out


def test_sigterm_exit75_then_recover(model_dir, tmp_path, capsys):
    ck = str(tmp_path / "run.ckpt.npz")
    base = ["check", str(model_dir / "MC.cfg"), "-noTool", "-checkpoint",
            ck, "-checkpointevery", "16"] + SMALL
    rc, out = _run(main, base + ["-faults", "sigterm@2"], capsys)
    assert rc == 75 and "Run interrupted by signal" in out
    assert "-recover" in out  # the resume command
    rc, out = _run(main, base + ["-recover"], capsys)
    assert rc == 0 and "17020 states generated, 8203 distinct" in out


def test_spill_fail_exit75_then_recover(model_dir, tmp_path, capsys):
    ck = str(tmp_path / "run.ckpt.npz")
    base = ["check", str(model_dir / "MC.cfg"), "-noTool", "-checkpoint",
            ck, "-checkpointevery", "16", "-chunk", "128", "-qcap", "4096",
            "-fpcap", "4096", "-workers", "cpu"]
    rc, out = _run(main, base + ["-faults", "alloc_fail@1,spill_fail@1"],
                   capsys)
    assert rc == 75
    assert "Host fingerprint spill tier activated" in out
    assert "Capacity exhausted (spill)" in out
    rc, out = _run(main, base + ["-recover"], capsys)
    assert rc == 0 and "17020 states generated, 8203 distinct" in out


FLAG_VALUES = {
    "coverage": ["-coverage"],
    "sharded": ["-sharded", "4"], "fpset": ["-fpset", "DiskFPSet"],
    "symmetry": ["-symmetry"], "por": ["-por"], "simulate": ["-simulate"],
    "infer": ["-infer"], "serve": ["-serve", "8080"],
    "traceout": ["-trace-out", "t.json"],
    "narrow": ["-narrow"], "analyze": ["-analyze"],
    "traceExpressions": ["-traceExpressions", "te.txt"],
    "xprof": ["-xprof", "prof"], "compilecache": ["-compile-cache", "c"],
    "artifactcache": ["-artifact-cache", "a"],
    "noartifactcache": ["-no-artifact-cache"], "recheck": ["-recheck"],
}


# flags refused once and run since they were ported: their cases keep
# their ids and hold the run to the reference's exit code and transcript
# (-narrow, -symmetry and -por are ignored on KubeAPI specs, as the
# reference ignores them; the clean run prints no trace for
# -traceExpressions to annotate; -simulate and -infer run on struct specs
# only, so on the KubeAPI pair both packages exit 1 with the same error;
# -fpset DiskFPSet runs the native disk tier; the artifact cache's three
# flags act on struct specs only, so the KubeAPI run ignores them in both
# packages; -serve serves the run's journal while it runs and -trace-out
# writes its Chrome trace, each at a path or port of the test's own)
PORTED = ("narrow", "traceExpressions", "symmetry", "por", "simulate",
          "infer", "fpset", "artifactcache", "noartifactcache", "recheck",
          "serve", "traceout")
STRUCT_ONLY = {"simulate": "-simulate requires the structural frontend",
               "infer": "-infer requires the structural frontend"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("dest", sorted(set(UNPORTED) | set(PORTED)))
def test_unported_flag_refused(model_dir, capsys, dest, tmp_path):
    flags = FLAG_VALUES[dest]
    if dest == "serve":
        flags = ["-serve", str(_free_port())]
    elif dest == "traceout":
        flags = ["-trace-out", str(tmp_path / "t.json")]
    argv = ["check", str(model_dir / "MC.cfg")] + flags
    if dest in STRUCT_ONLY:
        rc = main(argv + ["-workers", "cpu"])
        err = capsys.readouterr().err
        ref_rc = j_main(argv)
        assert rc == ref_rc == 1 and err == capsys.readouterr().err
        assert STRUCT_ONLY[dest] in err
        return
    if dest in PORTED:
        assert dest not in UNPORTED
        rc, out = _run(main, argv + ["-noTool"] + SMALL, capsys)
        ref_rc, ref = _run(j_main, argv + ["-noTool"] + SMALL[:-2], capsys)
        assert rc == ref_rc == 0
        assert "17020 states generated, 8203 distinct" in out
        assert masked(out) == masked(ref)
        return
    rc = main(argv)
    err = capsys.readouterr().err
    assert rc == 2
    assert "torchtlc: error:" in err


def test_other_root_spec_refused(tmp_path, capsys):
    """A model of another root spec goes to the structural frontend, as
    the reference's -frontend auto sends it; without the module beside
    it, the command exits 1 naming the module it could not load."""
    d = tmp_path / "Other"
    d.mkdir()
    (d / "MC.tla").write_text(MC_TLA.replace("KubeAPI", "TwoPhase"))
    (d / "MC.cfg").write_text(MC_CFG)
    rc = main(["check", str(d / "MC.cfg"), "-workers", "cpu"])
    err = capsys.readouterr().err
    assert rc == 1 and "TwoPhase" in err
    assert "structural frontend cannot load the module" in err


def test_no_card_without_workers_cpu_is_an_error(model_dir, capsys):
    """Without a card the command refuses to run quietly on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = main(["check", str(model_dir / "MC.cfg"), "-noTool"])
    err = capsys.readouterr().err
    assert rc == 1 and "no CUDA device" in err


def test_pipeline_transcript_equals_reference(model_dir, capsys):
    """`check MC.cfg -pipeline`: exit 0 and the reference's transcript."""
    import contextlib
    import io

    argv = ["check", str(model_dir / "MC.cfg"), "-noTool", "-pipeline"]
    rc, out = _run(main, argv + SMALL, capsys)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_rc = j_main(argv + SMALL)
    assert rc == ref_rc == 0
    assert "17020 states generated, 8203 distinct" in out
    assert masked(out) == masked(buf.getvalue())


def test_pipeline_sigterm_resume_hint_and_recover(model_dir, tmp_path,
                                                  capsys):
    """An interrupted -pipeline run prints a resume command that repeats
    -pipeline; -recover without it is refused naming `pipeline` (the
    reference raises the same ValueError); with it the run completes."""
    ck = str(tmp_path / "run.ckpt.npz")
    base = ["check", str(model_dir / "MC.cfg"), "-noTool", "-checkpoint",
            ck, "-checkpointevery", "16"] + SMALL
    rc, out = _run(main, base + ["-pipeline", "-faults", "sigterm@2"],
                   capsys)
    assert rc == 75
    hint = [ln for ln in out.splitlines() if "-recover" in ln]
    assert hint and all("-pipeline" in ln for ln in hint)
    for fn in (main, j_main):
        with pytest.raises(ValueError, match="pipeline"):
            fn(base + ["-recover"])
    capsys.readouterr()
    rc, out = _run(main, base + ["-pipeline", "-recover"], capsys)
    assert rc == 0 and "17020 states generated, 8203 distinct" in out


def test_pipeline_without_card_or_workers_cpu_is_an_error(model_dir, capsys):
    """-pipeline runs on the card like every path: without one, and
    without -workers cpu, the command refuses instead of using the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = main(["check", str(model_dir / "MC.cfg"), "-noTool", "-pipeline"])
    err = capsys.readouterr().err
    assert rc == 1 and "no CUDA device" in err
