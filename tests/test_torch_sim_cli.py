"""`python -m torchtlc.cli check ... -simulate` against `python -m
jaxtlc.cli check ... -simulate`: the transcript line for line (dates,
times, rates, the temporary directory and the lines naming the program and
the device masked), the exit code and the journal (its `sim` summary,
replay and liveness events included).

- a clean smoke run (SimTiny, RaftReplication Model_1, -sim-seed -1, a
  generic-subset spec under -frontend struct);
- SimViol's exit-12 trace, replayed from (seed, lane);
- TwoPhase Model_1's deadlock (exit 12, "Deadlock reached" and its trace);
- lassos on the walks: a violated P ~> Q (exit 13), one that holds, a
  boxed shape skipped;
- sigterm@2 -> exit 75 -> -recover, across the two packages;
- the flags -simulate refuses, a generic-subset spec without -frontend
  struct (exit 1), -infer running as the reference's (exit 0), -depth
  accepted without -simulate."""

import os

import pytest

from test_torch_narrow_cli import _both, _masked, _run
from test_torch_sim import (
    LIVE,
    SIM_TINY,
    SIM_TINY_CFG,
    SIM_VIOL,
    SIM_VIOL_CFG,
    write_model,
)
from jaxtlc.cli import main as j_main
from torchtlc.cli import main as t_main
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
TWO = os.path.join(SPECS, "TwoPhase.toolbox", "Model_1", "MC.cfg")
RAFT = os.path.join(SPECS, "RaftReplication.toolbox", "Model_1", "MC.cfg")
RECON = os.path.join(SPECS, "Reconciler.toolbox", "Model_1", "MC.cfg")
SIM = ["-simulate", "-walkers", "8", "-depth", "16"]


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("simcli")
    out = {"two": TWO, "raft": RAFT, "recon": RECON}
    out["tiny"] = write_model(str(root / "tiny"), "SimTiny", SIM_TINY,
                              SIM_TINY_CFG)
    out["viol"] = write_model(str(root / "viol"), "SimViol", SIM_VIOL,
                              SIM_VIOL_CFG)
    for prop in ("Unreached", "Reached", "Boxed"):
        out[prop] = write_model(str(root / prop), "LiveTiny", LIVE,
                                f"SPECIFICATION\nSpec\nPROPERTY\n{prop}\n")
    return out


# (model, flags, exit code, a line of the transcript)
CASES = {
    "clean": ("tiny", SIM + ["-nodeadlock"], 0,
              "No violation found in the sampled behaviors"),
    "seed-minus-1": ("tiny", SIM + ["-nodeadlock", "-sim-seed", "-1"], 0,
                     "(seed -1)"),
    "raft": ("raft", ["-simulate", "-walkers", "16", "-depth", "10",
                      "-nodeadlock"], 0, "Simulation complete: 16 walks"),
    "recon-frontend-struct": ("recon", ["-frontend", "struct", "-simulate",
                                        "-walkers", "8", "-depth", "8"], 0,
                              "Simulation complete: 8 walks"),
    "viol": ("viol", ["-simulate", "-walkers", "4", "-depth", "8",
                      "-sim-seed", "5", "-nodeadlock"], 12,
             "Invariant NotOne is violated"),
    "deadlock": ("two", ["-simulate", "-walkers", "16", "-depth", "12"],
                 12, "Deadlock reached"),
    "lasso": ("Unreached", ["-simulate", "-walkers", "4", "-depth", "16"],
              13, "Temporal properties were violated: Unreached"),
    "lasso-holds": ("Reached", ["-simulate", "-walkers", "4", "-depth",
                                "16"], 0, "no violating lasso"),
    "boxed-skipped": ("Boxed", ["-simulate", "-walkers", "4", "-depth",
                                "16"], 0, "Temporal property Boxed skipped"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_simulate_command_equals_reference(tmp_path, models, case):
    name, flags, want, line = CASES[case]
    out = _both(tmp_path, models[name], flags, checkpoint=True)
    assert out["port"][0] == out["ref"][0] == want
    assert line in out["port"][1]
    assert out["port"] == out["ref"]
    events = out["port"][2]
    assert events[0]["engine"] == "sim"
    phases = [e["phase"] for e in events if e["event"] == "sim"]
    assert "summary" in phases
    assert ("replay" in phases) == (want == 12)
    assert events[-1]["event"] == "final"
    if want == 12:
        assert "State 1: <Initial predicate>" in out["port"][1]


def test_sigterm_then_recover_across_packages(tmp_path, models):
    """sigterm@2 stops the port's run with exit 75 and the resume line;
    the reference resumes its checkpoint with -recover to the
    uninterrupted transcript's counts, and the other way round."""
    flags = SIM + ["-nodeadlock", "-checkpointevery", "4"]
    cfg = models["tiny"]
    clean = _both(tmp_path / "clean", cfg, flags)
    for first, second in ((t_main, j_main), (j_main, t_main)):
        d = tmp_path / ("p" if first is t_main else "r")
        d.mkdir()
        p = str(d / "ck")
        own = (["-workers", "cpu"] if first is t_main else [])
        rc, text = _run(first, ["check", cfg, "-noTool", *flags,
                                "-checkpoint", p, "-faults", "sigterm@2",
                                *own])
        assert rc == 75, text
        assert "-recover" in text and "-simulate -depth 16" in text
        own = (["-workers", "cpu"] if second is t_main else [])
        rc, text = _run(second, ["check", cfg, "-noTool", *flags,
                                 "-checkpoint", p, "-recover", *own])
        assert rc == 0, text
        counts = [ln for ln in _masked(text).splitlines()
                  if "states generated" in ln or "Simulation complete" in ln]
        want = [ln for ln in clean["ref"][1].splitlines()
                if "states generated" in ln or "Simulation complete" in ln]
        assert counts == want and counts


@pytest.mark.parametrize("flag", [["-sharded", "2"], ["-pipeline"],
                                  ["-coverage"], ["-narrow"],
                                  ["-symmetry"], ["-por"], ["-liveness"],
                                  ["-phase-timing"]])
def test_unsupported_flags_exit_1(models, flag, capsys):
    argv = ["check", models["tiny"], "-noTool", *SIM, *flag]
    rc = t_main(argv + ["-workers", "cpu"])
    err = capsys.readouterr().err
    ref_rc = j_main(argv)
    ref_err = capsys.readouterr().err
    assert rc == ref_rc == 1
    assert "not supported with -simulate" in err and err == ref_err


def test_non_struct_spec_exits_1_and_infer_stays_unported(models, capsys):
    argv = ["check", models["recon"], "-noTool", *SIM]
    assert t_main(argv + ["-workers", "cpu"]) == j_main(argv) == 1
    err = capsys.readouterr().err
    assert "-simulate requires the structural frontend" in err
    # -infer runs since it was ported: the same exit code as the reference
    argv = ["check", models["tiny"], "-noTool", "-infer"]
    assert t_main(argv + ["-workers", "cpu"]) == j_main(argv) == 0
    assert "Inference complete" in capsys.readouterr().out


def test_depth_without_simulate_is_accepted(tmp_path):
    """-depth / -walkers / -sim-seed without -simulate are walk geometry
    the exhaustive check ignores, as the reference does."""
    out = _both(tmp_path, TWO, ["-nodeadlock", "-depth", "5", "-walkers",
                                "4", "-sim-seed", "3"])
    assert out["port"][0] == out["ref"][0] == 0
    assert out["port"] == out["ref"]
