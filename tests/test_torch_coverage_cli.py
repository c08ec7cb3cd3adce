"""`check -coverage` through the port's command (torchtlc.cli.main,
-workers cpu) against jaxtlc.cli on the FF corner: exit 0 with a
transcript - the host walker's per-expression dump included - equal to
the reference's after masking; the journal's `coverage` events fold to
the run's totals; SIGTERM -> exit 75 prints a resume command that keeps
-coverage; -phase-timing still exits 2.  The Model_1 pins of
chip_smoke.py (the dump's digest here, the engine's site vector in the
slow suite) are re-derived from jaxtlc."""

import contextlib
import hashlib
import io
import os
import sys

import numpy as np
import pytest

from jaxtlc.cli import main as j_main
from torchtlc.cli import main
from torchtlc.obs.coverage import coverage_from_events
from torchtlc.obs.journal import read as read_journal

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the pinned digests)
from test_torch_cli import MC_CFG, MC_TLA, SMALL, masked  # noqa: E402
from torchtlc.testing import one_thread  # noqa: E402

one_thread()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_cov") / "Model_FF"
    d.mkdir()
    (d / "MC.tla").write_text(MC_TLA)
    (d / "MC.cfg").write_text(MC_CFG)
    return d


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_coverage_transcript_equals_reference(model_dir):
    argv = ["check", str(model_dir / "MC.cfg"), "-noTool", "-coverage"]
    rc, out = _run(main, argv + SMALL)
    ref_rc, ref = _run(j_main, argv + ["-no-preflight"] + SMALL)
    assert rc == ref_rc == 0
    assert "17020 states generated, 8203 distinct" in out
    dump = chip_smoke.coverage_dump(out)
    assert len(dump) > 300 and dump[0] == "The coverage statistics at DATE"
    assert masked(out) == masked(ref)


def test_coverage_journal_folds_to_the_run(model_dir, tmp_path):
    ck = str(tmp_path / "cov.ckpt")
    rc, _ = _run(main, ["check", str(model_dir / "MC.cfg"), "-noTool",
                        "-coverage", "-checkpoint", ck,
                        "-checkpointevery", "16"] + SMALL)
    assert rc == 0
    events = read_journal(ck + ".journal.jsonl")
    folded = coverage_from_events(events)
    assert folded["n_sites"] == 311 and folded["visited"] > 280
    from torchtlc.config import MATRIX
    from torchtlc.engine.bfs import check

    r = check(MATRIX[(False, False)], chunk=128, queue_capacity=4096,
              fp_capacity=16384, coverage=True, device="cpu")
    assert folded["sites"] == {k: v for k, v in r.site_coverage.items() if v}


def test_sigterm_resume_command_keeps_coverage(model_dir, tmp_path):
    ck = str(tmp_path / "kill.ckpt")
    base = ["check", str(model_dir / "MC.cfg"), "-noTool", "-coverage",
            "-checkpoint", ck, "-checkpointevery", "16"] + SMALL
    rc, out = _run(main, base + ["-faults", "sigterm@2"])
    assert rc == 75
    hint = next(ln for ln in out.splitlines() if "-recover" in ln)
    assert "-coverage" in hint
    rc, out = _run(main, base + ["-recover"])
    assert rc == 0 and "The coverage statistics at" in out
    assert "17020 states generated, 8203 distinct" in out


@pytest.mark.parametrize("flag", ["-pipeline", "-phase-timing"])
def test_pipeline_and_phase_timing_name_slice_6(model_dir, capsys, flag):
    """Named for the slice that refused both flags.  -pipeline runs now,
    so its case gives -phase-timing beside it: refused there too (the
    reference ignores it under -pipeline), the error naming the ROADMAP
    item that ports it (Queue A item 7b)."""
    argv = ["-pipeline", "-phase-timing"] if flag == "-pipeline" else [flag]
    rc = main(["check", str(model_dir / "MC.cfg")] + argv)
    err = capsys.readouterr().err
    assert rc == 2 and "item 7b" in err and "-pipeline" in err


def test_model1_dump_pin():
    """chip_smoke.py's phase-10c pin: the digest of the Model_1 dump lines
    (timestamp masked) of the reference's host walker, which the port's
    walker reproduces."""
    from jaxtlc.config import MODEL_1 as J_MODEL_1
    from jaxtlc.spec.coverage import render_coverage as j_render
    from jaxtlc.spec.coverage import run_coverage as j_run
    from torchtlc.config import MODEL_1
    from torchtlc.spec.coverage import render_coverage, run_coverage

    def digest(lines):
        return hashlib.sha256("\n".join(lines).encode()).hexdigest()

    ref = j_render(j_run(J_MODEL_1), "DATE", tool_mode=False)
    assert digest(ref) == chip_smoke.M1_COVERAGE_DUMP_SHA256
    mine = render_coverage(run_coverage(MODEL_1), "DATE", tool_mode=False)
    assert mine == ref


@pytest.mark.slow
def test_model1_site_vector_pin():
    """chip_smoke.py's phase-10 pin: the reference engine's 311-site
    vector on Model_1 at M1_KW (sorted immediate mode)."""
    from jaxtlc.config import MODEL_1
    from jaxtlc.engine.backend import kubeapi_backend
    from jaxtlc.engine.bfs import check

    r = check(MODEL_1, **chip_smoke.M1_KW, coverage=True, sort_free=False,
              deferred=False)
    sites = kubeapi_backend(MODEL_1, coverage=True).coverage.sites
    vec = np.asarray([r.site_coverage[s.key] for s in sites], "<u4")
    assert (hashlib.sha256(vec.tobytes()).hexdigest()
            == chip_smoke.M1_COVERAGE_SHA256)
    assert {s.key: int(v) for s, v in zip(sites, vec)
            if s.kind == "action"} == {
        a: chip_smoke.MC_OUT_GENERATED[a] for a in chip_smoke.MC_OUT_GENERATED}
