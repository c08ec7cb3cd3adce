"""`python -m torchtlc.cli check ... -infer` against `python -m jaxtlc.cli
check ... -infer`: the transcript line for line (dates, times, rates, the
temporary directory and the lines naming the program and the device
masked), the exit code and the journal (`-journal PATH`: its `infer`
round and summary events, the violation and the final event).

- TwoPhase Model_1 (exit 0, the certified lines and a preflight warning);
- Reconciler under `-frontend struct` (a generic-subset spec) at
  `-infer-budget 32`;
- a tiny module whose named invariant is reachable-false: exit 12 and the
  2110 line;
- the refusals, exit 1 with the reference's error: `-simulate`, the
  KubeAPI pair (no structural frontend), `-sharded 2`, `-checkpoint`."""

import json
import os

import pytest

from test_torch_cli import MC_CFG, MC_TLA
from test_torch_narrow_cli import DROP, _masked, _run
from test_torch_sim import write_model
from jaxtlc.cli import main as j_main
from torchtlc.cli import main as t_main
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
TWO = os.path.join(SPECS, "TwoPhase.toolbox", "Model_1", "MC.cfg")
RECON = os.path.join(SPECS, "Reconciler.toolbox", "Model_1", "MC.cfg")

# x climbs to 3; Small says it never passes 1: exact evidence refutes it
INFER_VIOL = """---- MODULE InferViol ----
EXTENDS Naturals
VARIABLES x

Init == x = 0

Next == /\\ x < 3
        /\\ x' = x + 1

Spec == Init /\\ [][Next]_x

Small == x <= 1
====
"""
INFER_VIOL_CFG = "SPECIFICATION\nSpec\nINVARIANT\nSmall\n"


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("infercli")
    kube = root / "Model_FF"
    kube.mkdir()
    (kube / "MC.tla").write_text(MC_TLA)
    (kube / "MC.cfg").write_text(MC_CFG)
    return {"two": TWO, "recon": RECON, "kube": str(kube / "MC.cfg"),
            "viol": write_model(str(root / "viol"), "InferViol", INFER_VIOL,
                                INFER_VIOL_CFG)}


def _journal(path):
    return [{k: v for k, v in ev.items() if k not in DROP}
            for ev in map(json.loads, open(path))]


def _both(tmp_path, cfg, flags):
    """{package: (rc, masked transcript, journal)}."""
    out = {}
    for name, fn, own in (("ref", j_main, []),
                          ("port", t_main, ["-workers", "cpu"])):
        d = tmp_path / name
        d.mkdir(parents=True, exist_ok=True)
        jp = str(d / "run.journal.jsonl")
        rc, text = _run(fn, ["check", cfg, "-noTool", *flags, "-journal",
                             jp, *own])
        out[name] = (rc, _masked(text, str(d)), _journal(jp))
    return out


# (model, flags, exit code, a line of the transcript)
CASES = {
    "twophase": ("two", ["-infer"], 0,
                 "Certified inductive invariant [reachable-inductive]: "
                 "Agreement"),
    "reconciler-frontend-struct": (
        "recon", ["-frontend", "struct", "-infer", "-infer-budget", "32"],
        0, "Inference complete: 32 candidates (160 beyond budget)"),
    "cfg-invariant-refuted": (
        "viol", ["-infer"], 12,
        "Invariant Small is violated (refuted by a reachable state in the "
        "exact evidence set)."),
}


@pytest.mark.parametrize("case", list(CASES))
def test_infer_command_equals_reference(tmp_path, models, case):
    name, flags, want, line = CASES[case]
    out = _both(tmp_path, models[name], flags)
    assert out["port"][0] == out["ref"][0] == want
    assert line in out["port"][1]
    assert "Inference complete" in out["port"][1]
    assert out["port"] == out["ref"]
    events = out["port"][2]
    assert events[0]["event"] == "run_start"
    assert events[0]["engine"] == "infer"
    phases = [e["phase"] for e in events if e["event"] == "infer"]
    assert phases[0] == "round" and phases[-1] == "summary"
    assert events[-1]["event"] == "final"
    assert any(e["event"] == "violation" for e in events) == (want == 12)


# (model, flags, a part of the error)
REFUSALS = {
    "simulate": ("two", ["-infer", "-simulate"],
                 "-infer and -simulate are distinct job classes"),
    "kubeapi": ("kube", ["-infer"],
                "-infer requires the structural frontend"),
    "sharded": ("two", ["-infer", "-sharded", "2"],
                "-sharded not supported with -infer"),
    "checkpoint": ("two", ["-infer", "-checkpoint", "CKPT"],
                   "-checkpoint not supported with -infer"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_infer_refusals_exit_1(tmp_path, models, case, capsys):
    name, flags, part = REFUSALS[case]
    flags = [str(tmp_path / "ck") if f == "CKPT" else f for f in flags]
    argv = ["check", models[name], "-noTool", *flags]
    rc = t_main(argv + ["-workers", "cpu"])
    err = capsys.readouterr().err
    ref_rc = j_main(argv)
    ref_err = capsys.readouterr().err
    assert rc == ref_rc == 1
    assert part in err and err == ref_err
