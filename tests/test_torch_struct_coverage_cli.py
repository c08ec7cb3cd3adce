"""`check -coverage` on struct specs against `python -m jaxtlc.cli check`:
the transcript with the device coverage plane's MC.out-format dump (dates,
times, rates and the lines naming the program and the device masked),
the exit code and the journal - its `coverage` events, which fold back to
the dump's counts - on the supervised single-device route, unsupervised
(`-no-auto-grow`) and on `-sharded 2`."""

import contextlib
import io
import json
import os
import re

import pytest

from jaxtlc.cli import main as j_main
from torchtlc.cli import main as t_main
from torchtlc.obs.coverage import coverage_from_events
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWO = os.path.join(ROOT, "specs", "TwoPhase.toolbox", "Model_1", "MC.cfg")
RAFT = os.path.join(ROOT, "specs", "RaftReplication.toolbox", "Model_1",
                    "MC.cfg")
DROP = ("t", "wall_s", "t_dispatch", "t_fence", "seconds", "path",
        "version", "device")


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


def _masked(text: str) -> str:
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search"))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _journal(path):
    return [{k: v for k, v in ev.items() if k not in DROP}
            for ev in map(json.loads, open(path)) if ev["event"] != "phase"]


CASES = {
    "supervised": (TWO, []),
    "unsupervised": (TWO, ["-no-auto-grow"]),
    "sharded-2": (TWO, ["-sharded", "2"]),
    "raft-supervised": (RAFT, ["-chunk", "256"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_coverage_command_equals_reference(tmp_path, case):
    cfg, extra = CASES[case]
    out = {}
    for name, fn, own in (("ref", j_main, []),
                          ("port", t_main, ["-workers", "cpu"])):
        journal = str(tmp_path / f"{name}.jsonl")
        rc, text = _run(fn, ["check", cfg, "-noTool", "-nodeadlock",
                             "-coverage", "-journal", journal, *extra, *own])
        out[name] = (rc, _masked(text), _journal(journal))
    assert out["ref"][0] == out["port"][0] == 0
    text = out["port"][1]
    assert "The coverage statistics at" in text
    assert re.search(r"\|\S+ of module (TwoPhase|RaftReplication): \d+",
                     text)
    assert text == out["ref"][1]
    assert out["port"][2] == out["ref"][2]
    folded = coverage_from_events(out["port"][2])
    assert folded is not None and folded["visited"] > 0
    dump = dict(re.findall(r"\|(\S+) of module \w+: (\d+)", text))
    for key, v in folded["sites"].items():
        if "." in key and key in dump:
            assert int(dump[key]) == v, key
