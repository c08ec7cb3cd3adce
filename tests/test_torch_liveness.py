"""The port's host liveness path (torchtlc.engine.liveness) and the
command's liveness stage against jaxtlc's on the CPU, FF corner, zero
tolerance: build_graph's Graph field for field (its expansion on kernel
K1's plain version), check_properties' verdicts and lassos under wf_next
and wf_process, and the `check` transcripts and journals of -liveness,
-liveness-host, -fairness wf_process, a PROPERTY list in MC.cfg, the
device path (the size threshold lowered in both packages) and -sharded 2,
each exiting 13 as jaxtlc's does after the usual masking."""

import contextlib
import io
import json
import re

import numpy as np
import pytest

from jaxtlc.cli import main as j_main
from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.engine import liveness as jl
from jaxtlc.live import check as jchk
from torchtlc.cli import main as t_main
from torchtlc.config import ModelConfig
from torchtlc.engine import liveness as tl
from torchtlc.live import check as tchk
from torchtlc.testing import one_thread

one_thread()

FF, J_FF = ModelConfig(False, False), JConfig(False, False)
PROPS = ["ReconcileCompletes", "CleansUpProperly"]


@pytest.fixture(scope="module")
def graphs():
    """(reference, port) host graphs of FF."""
    return jl.build_graph(J_FF), tl.build_graph(FF, device="cpu")


def test_build_graph_equals_reference(graphs):
    ref, port = graphs
    assert ref.states.shape[0] == 8203
    for name in ref._fields:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("fairness", ["wf_next", "wf_process"])
def test_check_properties_equals_reference(graphs, fairness):
    """Both properties are violated on FF under either fairness; the
    verdicts, lasso states and their action labels equal the
    reference's."""
    ref, port = graphs
    want = jl.check_properties(J_FF, PROPS, graph=ref, fairness=fairness)
    got = tl.check_properties(FF, PROPS, graph=port, fairness=fairness)
    for a, b in zip(got, want):
        assert (a.name, a.holds) == (b.name, b.holds) and not a.holds
        assert len(a.prefix) == len(b.prefix) and len(a.cycle) == len(b.cycle)
        assert all(np.array_equal(x, y) for x, y in zip(a.prefix, b.prefix))
        assert all(np.array_equal(x, y) for x, y in zip(a.cycle, b.cycle))
        assert (a.prefix_actions, a.cycle_actions) == (b.prefix_actions,
                                                       b.cycle_actions)


def test_host_fixpoints_equal_reference_on_small_graphs():
    """surviving_set and fair_surviving_set (copies of the reference's
    host code) on random graphs."""
    rng = np.random.default_rng(5)
    for _ in range(5):
        V, E = 60, 150
        src = rng.integers(0, V, E)
        dst = rng.integers(0, V, E)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        proc = rng.integers(0, 3, len(src))
        nonself = np.zeros(V, bool)
        nonself[src] = True
        kw = dict(states=np.zeros((V, 1), np.int32), src=src, dst=dst,
                  eproc=proc, eaction=proc, has_nonself=nonself,
                  init_ids=np.array([0]), parent=np.full(V, -1),
                  parent_action=np.full(V, -1))
        in_h = rng.random(V) < 0.6
        assert np.array_equal(tl.surviving_set(tl.Graph(**kw), in_h),
                              jl.surviving_set(jl.Graph(**kw), in_h))
        for a, b in zip(tl.fair_surviving_set(tl.Graph(**kw), in_h, 3),
                        jl.fair_surviving_set(jl.Graph(**kw), in_h, 3)):
            assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

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
SMALL = ["-chunk", "128", "-qcap", "4096", "-fpcap", "16384"]
DROP = ("t", "wall_s", "t_dispatch", "t_fence", "seconds", "path",
        "version", "device")


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """Model_FF without and with a PROPERTY list in its MC.cfg."""
    out = {}
    for name, extra in (("plain", ""),
                        ("prop", "PROPERTY ReconcileCompletes\n"
                                 "PROPERTY CleansUpProperly\n"),
                        ("unknown", "PROPERTY Eventually\n")):
        d = tmp_path_factory.mktemp(f"live_{name}") / "Model_FF"
        d.mkdir()
        (d / "MC.tla").write_text(MC_TLA)
        (d / "MC.cfg").write_text(MC_CFG + extra)
        out[name] = d
    return out


def _masked(text: str, tmp: str) -> str:
    lines = [ln for ln in text.replace(tmp, "TMP").splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search",
                                   "Resume with: "))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _journal(path):
    return [{k: v for k, v in ev.items() if k not in DROP}
            for ev in map(json.loads, open(path)) if ev["event"] != "phase"]


def _both(model_dir, tmp_path, extra):
    """(rc, masked transcript, journal) of the reference and the port."""
    out = {}
    for name, fn, own in (("ref", j_main, []),
                          ("port", t_main, ["-workers", "cpu"])):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(["check", str(model_dir / "MC.cfg"), "-noTool", *SMALL,
                     "-checkpoint", str(d / "p"), *extra, *own])
        out[name] = (rc, _masked(buf.getvalue(), str(d)),
                     _journal(str(d / "p") + ".journal.jsonl"))
    return out


@pytest.mark.parametrize("case", ["liveness", "liveness-host",
                                  "wf-process", "property-in-cfg",
                                  "device-path", "device-path-sharded"])
def test_liveness_command_equals_reference(model_dirs, tmp_path,
                                           monkeypatch, case):
    """Exit 13, the 2192 banner naming the liveness engine, the violated
    property's lasso with its action labels, and the journal's violation
    and final events, equal to jaxtlc's after masking."""
    model, extra, engine = {
        "liveness": ("plain", ["-liveness"], "host"),
        "liveness-host": ("plain", ["-liveness", "-liveness-host"], "host"),
        "wf-process": ("plain", ["-liveness", "-fairness", "wf_process"],
                       "host"),
        "property-in-cfg": ("prop", [], "host"),
        "device-path": ("prop", [], "device"),
        "device-path-sharded": ("plain", ["-liveness", "-sharded", "2"],
                                "device"),
    }[case]
    if engine == "device":
        monkeypatch.setattr(jchk, "HOST_PATH_MAX", 0)
        monkeypatch.setattr(tchk, "HOST_PATH_MAX", 0)
    out = _both(model_dirs[model], tmp_path, extra)
    assert out["ref"][0] == out["port"][0] == 13
    text = out["port"][1]
    assert f"({engine} liveness engine)" in text
    assert "Temporal properties were violated: ReconcileCompletes" in text
    assert "-- The following states form a cycle" in text
    assert "Model checking completed. No error has been found" not in text
    assert text == out["ref"][1]
    assert out["port"][2] == out["ref"][2]
    assert any(e["event"] == "violation" and e["code"] == 13
               for e in out["port"][2])


def test_unknown_property_still_refused(model_dirs, capsys):
    """A PROPERTY the port does not know exits 1, as the reference's."""
    argv = ["check", str(model_dirs["unknown"] / "MC.cfg"), "-workers", "cpu"]
    for fn, own in ((t_main, []), (j_main, [])):
        assert fn(argv + own) == 1
        assert "unknown PROPERTY Eventually" in capsys.readouterr().err
