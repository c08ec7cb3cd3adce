"""`-symmetry` and `-por` through the port's `check` command against
`python -m jaxtlc.cli check`, at the shipped sizes: the transcript line
for line (dates, times, rates, the temporary directory and the lines
naming the program and the device masked), the exit code and the journal
(its `reduce` event included).

- TwoPhase Model_sym with -symmetry (228 / 80 / 11) and with
  -no-symmetry (810 / 288 / 11, the preflight's unreduced-symmetry
  warning), supervised, sharded on 2 shards, with -phase-timing and
  through the spill rung (a denied regrow); the two-counter spec of
  tests/test_reduce.py with -por (9 states);
- the exit-12 trace of the reference's SymV spec, identical with and
  without -symmetry from the violation banner to the Progress line;
- a -symmetry checkpoint stopped by SIGTERM resumes in the other package
  with -recover -symmetry, and -recover without the flag is refused (the
  meta's symmetry key) in both;
- the lie (each package's debug variable on a digest-perturbed copy of
  Model_sym): "orbit-certificate violation", verdict "error", exit 1;
- -symmetry -por on a generic spec (Reconciler) and on the KubeAPI pair
  is ignored, as the reference ignores it."""

import os
import shutil

import pytest

from test_torch_narrow_cli import _both, _run
from test_torch_cli import MC_CFG, MC_TLA
from test_torch_reduce import PORV, PORV_CFG
from test_torch_absint import write_model
from jaxtlc.cli import main as j_main
from torchtlc.cli import main as t_main
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
SYM = os.path.join(SPECS, "TwoPhase.toolbox", "Model_sym", "MC.cfg")
RECON = os.path.join(SPECS, "Reconciler.toolbox", "Model_1", "MC.cfg")
SYMV = """---- MODULE SymV ----
EXTENDS Naturals, FiniteSets
CONSTANTS RM
VARIABLES voted, n
Init == voted = {} /\\ n = 0
Vote == /\\ \\E r \\in RM \\ voted : voted' = voted \\cup {r}
        /\\ n' = n + 1
Next == Vote
Small == n < 2
====
"""
SYMV_CFG = "CONSTANT RM = {r1, r2, r3}\nINVARIANT\nSmall\n"


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


@pytest.fixture(scope="module")
def porv(tmp_path_factory):
    return write_model(tmp_path_factory.mktemp("porv_cli"), "PorV", PORV,
                       PORV_CFG)


SYMF = ["-symmetry", "-nodeadlock"]
# (model, flags, journal, exit code, the counts line)
CASES = {
    "sym": (SYM, SYMF, True, 0, "228 states generated, 80 distinct"),
    "no-symmetry": (SYM, ["-no-symmetry", "-nodeadlock"], False, 0,
                    "810 states generated, 288 distinct"),
    "sym-sharded-2": (SYM, SYMF + ["-sharded", "2", "-no-auto-grow"],
                      False, 0, "228 states generated, 80 distinct"),
    "sym-phase-timing": (SYM, SYMF + ["-phase-timing"], True, 0,
                         "228 states generated, 80 distinct"),
    "sym-spill-rung": (SYM, SYMF + ["-chunk", "16", "-qcap", "256", "-fpcap",
                                    "64", "-faults", "alloc_fail@1"], True,
                       0, "228 states generated, 80 distinct"),
    "porv-por": ("porv", ["-por", "-nodeadlock", "-frontend", "struct",
                          "-chunk", "4"], True, 0, " 9 distinct"),
    "reconciler-ignored": (RECON, ["-symmetry", "-por"], False, 0, ""),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reduce_command_equals_reference(tmp_path, porv, case):
    cfg, flags, journal, want, counts = CASES[case]
    out = _both(tmp_path, porv if cfg == "porv" else cfg, flags,
                checkpoint=journal)
    assert out["port"][0] == out["ref"][0] == want
    assert "Finished computing initial states" in out["port"][1]
    assert counts in out["port"][1]
    assert out["port"] == out["ref"]
    if case == "no-symmetry":
        assert "unreduced-symmetry" in out["port"][1]
    elif case != "reconciler-ignored":
        assert "unreduced-symmetry" not in out["port"][1]
    if journal:
        red = [e for e in out["port"][2] if e["event"] == "reduce"]
        assert len(red) == 1
        if case == "porv-por":
            assert red[0]["states_pruned"] == 4 and red[0]["por"]
        else:
            assert red[0]["orbit_factor"] == 6 and red[0]["symmetry"]


def test_symv_trace_identical_with_and_without_symmetry(tmp_path):
    """The reference's seeded invariant violation (exit 12): the port's
    transcript equals the reference's with and without -symmetry, and the
    two runs render the same trace from the violation banner to the
    Progress line."""
    cfg = write_model(tmp_path, "SymV", SYMV, SYMV_CFG)
    traces = {}
    for sym in ("-symmetry", "-no-symmetry"):
        out = _both(tmp_path / sym, cfg, [sym, "-frontend", "struct",
                                          "-chunk", "64"])
        assert out["port"][0] == out["ref"][0] == 12
        assert out["port"] == out["ref"]
        t = out["port"][1]
        traces[sym] = t[t.index("Invariant Small is violated"):
                        t.index("Progress(")]
    assert traces["-symmetry"] == traces["-no-symmetry"]
    assert "State 3: <Vote>" in traces["-symmetry"]


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_symmetry_checkpoint_resumes_across_packages(tmp_path, first,
                                                     second):
    """A -symmetry run stopped by SIGTERM resumes in the other package with
    -recover -symmetry; -recover without the flag is refused first (the
    checkpoint's symmetry key) in both packages."""
    mains = {"ref": (j_main, []), "port": (t_main, ["-workers", "cpu"])}
    p = str(tmp_path / "p")
    base = ["check", SYM, "-noTool", "-nodeadlock", "-chunk", "4",
            "-checkpoint", p, "-checkpointevery", "2"]
    fn, own = mains[first]
    rc, text = _run(fn, base + ["-symmetry", "-faults", "sigterm@3", *own])
    assert rc == 75, text[-2000:]
    assert "-recover -chunk 4 -symmetry" in text
    for fn_, own_ in mains.values():
        with pytest.raises(ValueError, match="checkpoint symmetry mismatch"):
            _run(fn_, base + ["-recover", *own_])
    fn, own = mains[second]
    rc, text = _run(fn, base + ["-recover", "-symmetry", *own])
    assert rc == 0, text[-2000:]
    assert "228 states generated, 80 distinct states found" in text


def test_lie_command_error_verdict(tmp_path, monkeypatch):
    """The lying plan (TORCHTLC_DEBUG_SYM_LIE / JAXTLC_DEBUG_SYM_LIE) on a
    copy of Model_sym whose digest differs, so no memoized backend serves
    it: the orbit certificate trips, the banner prints once, the journal's
    verdict is "error", exit 1 - the same transcript and journal in both
    packages."""
    src = os.path.dirname(SYM)
    model = tmp_path / "model"
    model.mkdir()
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), model)
    with open(model / "TwoPhase.tla", "a") as f:
        f.write("\n\\* orbit-lie test copy\n")
    monkeypatch.setenv("TORCHTLC_DEBUG_SYM_LIE", "1")
    monkeypatch.setenv("JAXTLC_DEBUG_SYM_LIE", "1")
    out = _both(tmp_path, str(model / "MC.cfg"), SYMF + ["-chunk", "32"],
                checkpoint=True)
    rc, text, journal = out["port"]
    assert rc == out["ref"][0] == 1
    assert text.count("ERROR: runtime orbit-certificate violation - ") == 1
    assert "ERROR: runtime orbit-certificate violation: the symmetry" in text
    assert [e["verdict"] for e in journal if e["event"] == "final"][-1] == (
        "error")
    assert any(e["event"] == "analysis" and e["check"] == "orbit-certificate"
               for e in journal)
    assert out["port"] == out["ref"]


def test_symmetry_por_on_kubeapi_is_ignored(tmp_path):
    """The KubeAPI pair (FF) with -symmetry -por stopped by SIGTERM: the
    reference's transcript, journal and exit code (75), and a resume
    command that repeats both flags, as the reference's."""
    d = tmp_path / "Model_FF"
    d.mkdir()
    (d / "MC.tla").write_text(MC_TLA)
    (d / "MC.cfg").write_text(MC_CFG)
    out = _both(tmp_path / "stop", str(d / "MC.cfg"),
                ["-symmetry", "-por", "-chunk", "128", "-qcap", "4096",
                 "-fpcap", "16384", "-checkpointevery", "16", "-faults",
                 "sigterm@2"], checkpoint=True)
    assert out["port"][0] == out["ref"][0] == 75
    assert out["port"] == out["ref"]
    assert "-recover -chunk 128 -symmetry -por" in out["port"][1]
