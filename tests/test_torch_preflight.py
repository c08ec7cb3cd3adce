"""The port's default preflight (torchtlc.analysis, the reference's lite
mode) against jaxtlc.analysis on the CPU: the findings field for field,
the text report and the journal events on the six shipped models (each
struct-frontend model through preflight_struct, each generic one through
preflight_gen and, loaded by the structural frontend, preflight_struct)
and on KubeAPI Model_1 (preflight_kubeapi), at the default table and at
one large enough for the counter-width warning; the default transcript
and journal of the three struct models, without -no-preflight, equal to
the reference's (each prints the unreduced-symmetry warning); -no-preflight
skipping it; a lint that raises not blocking the run; and an
error-severity finding aborting it with the reference's exit code and
`final` event.  Exact comparisons."""

import contextlib
import dataclasses
import io
import json
import os
import re

import pytest

from jaxtlc.analysis import preflight as jpf
from jaxtlc.analysis.report import render_report as j_render
from jaxtlc.cli import main as j_main
from jaxtlc.config import MODEL_1 as J_MODEL_1
from jaxtlc.frontend.model import resolve as j_resolve
from jaxtlc.struct.loader import load as j_load
from torchtlc.analysis import preflight as tpf
from torchtlc.analysis.report import render_report as t_render
from torchtlc.cli import main as t_main
from torchtlc.config import MODEL_1
from torchtlc.frontend.model import resolve as t_resolve
from torchtlc.struct.loader import load as t_load
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
STRUCT = {"TwoPhase": ("TwoPhase", "Model_1"),
          "TwoPhase_sym": ("TwoPhase", "Model_sym"),
          "RaftReplication": ("RaftReplication", "Model_1")}
GEN = ("RaftElection", "Reconciler", "ServiceMesh")
DROP = ("t", "wall_s", "t_dispatch", "t_fence", "seconds", "path", "version",
        "device")


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


def _cfg(spec, model="Model_1"):
    return os.path.join(SPECS, f"{spec}.toolbox", model, "MC.cfg")


def _same_report(t, j):
    assert ([dataclasses.astuple(f) for f in t.findings]
            == [dataclasses.astuple(f) for f in j.findings])
    assert t.name == j.name and t.exit_code == j.exit_code
    assert t_render(t) == j_render(j)


@pytest.mark.parametrize("fp", [1 << 20, 1 << 30], ids=["2^20", "2^30"])
@pytest.mark.parametrize("name", sorted(STRUCT) + list(GEN))
def test_struct_lints_equal_reference(name, fp):
    """preflight_struct on every shipped model loaded by the structural
    frontend: the spec section (read/write sets, slot budgets, invariant
    reads, independence pairs), the unreduced-symmetry findings and the
    counter-width warning at a 2^30 table."""
    cfg = _cfg(*STRUCT[name]) if name in STRUCT else _cfg(name)
    kw = dict(fp_capacity=fp, chunk=1024, queue_capacity=1 << 15)
    t = tpf.preflight_struct(t_load(cfg), **kw)
    j = jpf.preflight_struct(j_load(cfg), **kw, deep=False)
    _same_report(t, j)
    if name in STRUCT:
        assert any(f.check == "unreduced-symmetry" for f in t.findings)
    assert any(f.check == "counter-width" for f in t.findings) == (fp > 1e9)


@pytest.mark.parametrize("fp", [1 << 20, 1 << 30], ids=["2^20", "2^30"])
@pytest.mark.parametrize("name", GEN)
def test_gen_preflight_equals_reference(name, fp):
    kw = dict(workers="cpu", fp_index=0, check_deadlock=True,
              frontend="auto")
    t = tpf.preflight_gen(t_resolve(_cfg(name), **kw).genspec,
                          fp_capacity=fp)
    j = jpf.preflight_gen(j_resolve(_cfg(name), **kw).genspec,
                          fp_capacity=fp, deep=False)
    _same_report(t, j)


@pytest.mark.parametrize("fp", [1 << 20, 1 << 30], ids=["2^20", "2^30"])
def test_kubeapi_preflight_equals_reference(fp):
    kw = dict(fp_capacity=fp, chunk=1024, queue_capacity=1 << 15)
    t = tpf.preflight_kubeapi(MODEL_1, **kw)
    j = jpf.preflight_kubeapi(J_MODEL_1, **kw, deep=False)
    _same_report(t, j)
    assert bool(t.findings) == (fp > 1e9)


def masked(text: str) -> str:
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search"))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _both(cfg, extra, tmp_path):
    """{package: (rc, masked transcript, journal)}."""
    out = {}
    for name, fn in (("ref", j_main), ("port", t_main)):
        path = tmp_path / f"{name}.jsonl"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(["check", cfg, "-noTool", "-workers", "cpu", "-journal",
                     str(path)] + extra)
        events = [{k: v for k, v in ev.items() if k not in DROP}
                  for ev in map(json.loads, open(path))]
        out[name] = (rc, masked(buf.getvalue()), events)
    return out


@pytest.mark.parametrize("name", sorted(STRUCT))
def test_default_transcript_equals_reference(name, tmp_path):
    """The default run of each struct model, no -no-preflight on either
    side: the warning lines, the exit code and the journal's `analysis`
    and `analysis_summary` events equal the reference's."""
    out = _both(_cfg(*STRUCT[name]), ["-nodeadlock"], tmp_path)
    assert out["port"] == out["ref"]
    rc, text, events = out["port"]
    assert rc == 0
    assert "Preflight warning [spec/unreduced-symmetry]" in text
    assert "Preflight analysis: 0 error(s), 1 warning(s)" in text
    assert [ev["event"] for ev in events].count("analysis") == 1


def test_no_preflight_skips_it(tmp_path):
    out = _both(_cfg("TwoPhase"), ["-nodeadlock", "-no-preflight"], tmp_path)
    assert out["port"] == out["ref"]
    rc, text, events = out["port"]
    assert rc == 0 and "Preflight" not in text
    assert not [ev for ev in events if ev["event"].startswith("analysis")]


def test_a_lint_that_raises_does_not_block_the_run(tmp_path, monkeypatch):
    """Both packages' spec lints raise: each prints `Preflight analysis
    skipped: ...` and runs the check to the same verdict."""
    from jaxtlc.analysis import speclint as jsl
    from torchtlc.analysis import speclint as tsl

    def broken(*a, **k):
        raise RuntimeError("lint exploded")

    monkeypatch.setattr(jsl, "analyze_spec", broken)
    monkeypatch.setattr(tsl, "analyze_spec", broken)
    out = _both(_cfg("RaftReplication"), ["-nodeadlock"], tmp_path)
    assert out["port"] == out["ref"]
    assert out["port"][0] == 0
    assert "Preflight analysis skipped: lint exploded" in out["port"][1]


@pytest.mark.parametrize("spec", ["TwoPhase", "Reconciler"])
def test_an_error_finding_aborts_the_run(tmp_path, monkeypatch, spec):
    """An error-severity finding (both packages' counter-width audit
    patched to report one) aborts the run before the check: the
    reference's exit code, message and `final` event."""
    from jaxtlc import analysis as ja
    from torchtlc import analysis as ta

    for pf, pkg in ((jpf, ja), (tpf, ta)):
        monkeypatch.setattr(pf, "audit_counter_width", (
            lambda pkg: lambda subject, *a, **k: [pkg.Finding(
                layer="engine", check="counter-width",
                severity=pkg.SEV_ERROR, subject=subject,
                detail="seeded error")])(pkg))
    out = _both(_cfg(spec), [], tmp_path)
    assert out["port"] == out["ref"]
    rc, text, events = out["port"]
    assert rc == 1
    assert "run aborted (-no-preflight to override)" in text
    assert events[-1]["event"] == "final" and \
        events[-1]["verdict"] == "error"
    assert "states generated" not in text
