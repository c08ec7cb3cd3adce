"""The port's monitoring plane (torchtlc.obs.serve, .trace, .views,
.tlcstat) and the `-serve` / `-trace-out` flags against the reference's,
on the same journals, tolerance zero.

- metrics_from_events and prometheus_text equal to jaxtlc's on the
  reference's synthetic journal and on the journals of real runs of
  either package (TwoPhase, supervised, with `-trace-out`);
- the SSE tail holds a torn trailing line back and delivers it once, in
  order; the /runs registry multiplexes journals with ?run= selection;
  `python -m torchtlc.obs.serve --tiny`;
- the Chrome-trace export event for event (chrome_trace_events) on those
  journals, and the export's `trace_export` journal event;
- `python -m torchtlc.obs.tlcstat --tiny` and `--connect` against a
  monitor, the frame equal to tools/tlcstat.py's (its program line
  aside);
- `check ... -trace-out P` and `check ... -serve PORT` on the TwoPhase
  Model_1 spec and on the KubeAPI FF pair: transcripts equal the
  reference's after the usual masking, the journals' event kinds equal,
  the trace files' events equal but for their times.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from jaxtlc.cli import main as j_main
from jaxtlc.obs import journal as jjr
from jaxtlc.obs import serve as j_serve
from jaxtlc.obs import trace as j_trace
from jaxtlc.obs import views as j_views
from test_torch_cli import MC_CFG, MC_TLA, masked
from torchtlc.cli import main as t_main
from torchtlc.obs import journal as jr
from torchtlc.obs import serve as obs_serve
from torchtlc.obs import tlcstat
from torchtlc.obs import trace as t_trace
from torchtlc.obs import views as t_views
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWO = os.path.join(ROOT, "specs", "TwoPhase.toolbox", "Model_1", "MC.cfg")
WAIT = 60


@pytest.fixture(autouse=True)
def _artifact_cache_off(monkeypatch):
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")


def _get(url, timeout=WAIT):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _progress(j, depth):
    return j.event("progress", depth=depth, generated=10 * depth,
                   distinct=5 * depth, queue=depth)


@pytest.fixture(scope="module")
def ff_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs") / "Model_FF"
    d.mkdir()
    (d / "MC.tla").write_text(MC_TLA)
    (d / "MC.cfg").write_text(MC_CFG)
    return d


def _trace_shape(events):
    """A trace's events without their times - timestamps, durations and
    the measured walls among their arguments - and with the runs'
    temporary directories masked."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur")}
        if isinstance(e.get("args"), dict):
            e["args"] = {k: v for k, v in e["args"].items()
                         if not k.endswith(("_s", "_us", "_ms"))}
        out.append(json.loads(re.sub(r"-(torchtlc|jaxtlc)\d+", "-PKG",
                                     json.dumps(e))))
    return out


RUNS = {
    "twophase": (TWO, ["-nodeadlock", "-checkpoint", "CKPT",
                       "-checkpointevery", "4", "-chunk", "16"]),
    "kubeapi-ff": (None, ["-noTool", "-chunk", "128", "-qcap", "4096",
                          "-fpcap", "16384"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, ff_dir):
    """Both packages' `check ... -trace-out P -journal J` on each model:
    {name: {pkg: (rc, stdout, journal events, trace dict)}}."""
    out = {}
    for name, (cfg, flags) in RUNS.items():
        cfg = cfg or str(ff_dir / "MC.cfg")
        out[name] = {}
        for pkg, main in (("torchtlc", t_main), ("jaxtlc", j_main)):
            d = tmp_path_factory.mktemp(f"{name}-{pkg}")
            journal = str(d / "run.journal.jsonl")
            trace = str(d / "run.trace.json")
            argv = ["check", cfg, "-journal", journal, "-trace-out", trace,
                    "-no-artifact-cache"]
            argv += [f.replace("CKPT", str(d / "ck.npz")) for f in flags]
            if pkg == "torchtlc":
                argv += ["-workers", "cpu"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(argv)
            with open(trace) as f:
                out[name][pkg] = (rc, buf.getvalue(),
                                  jr.read(journal, validate=False),
                                  json.load(f))
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_trace_out_transcripts_journals_and_traces_equal_reference(
        runs, name):
    (rc, text, evs, tr), (j_rc, j_text, j_evs, j_tr) = (
        runs[name]["torchtlc"], runs[name]["jaxtlc"])
    assert rc == j_rc == 0

    def mask(t):  # the runs' temporary directories differ
        return re.sub(r"-(torchtlc|jaxtlc)\d+", "-PKG", masked(t))

    assert mask(text) == mask(j_text)
    assert "Timeline trace written to" in text
    assert [e["event"] for e in evs] == [e["event"] for e in j_evs]
    exp = [e for e in evs if e["event"] == "trace_export"]
    assert len(exp) == 1 and exp[0]["events"] == len(tr["traceEvents"])
    assert _trace_shape(tr["traceEvents"]) == _trace_shape(
        j_tr["traceEvents"])
    # the export is a pure function of the journal: either package's
    # exporter renders either package's journal to the same events
    for events in (evs, j_evs):
        assert (t_trace.chrome_trace_events(events)
                == j_trace.chrome_trace_events(events))


@pytest.mark.parametrize("name", list(RUNS))
def test_metrics_and_prometheus_text_equal_reference(runs, name, tmp_path):
    for pkg in ("torchtlc", "jaxtlc"):
        events = runs[name][pkg][2]
        mine = t_views.metrics_from_events(events)
        assert mine == j_views.metrics_from_events(events)
        assert (obs_serve.prometheus_text(mine)
                == j_serve.prometheus_text(mine))
    t_trace._tiny_journal(str(tmp_path / "t.journal.jsonl"))
    j_trace._tiny_journal(str(tmp_path / "j.journal.jsonl"))
    a = jr.read(str(tmp_path / "t.journal.jsonl"))
    b = jjr.read(str(tmp_path / "j.journal.jsonl"))
    def untimed(events):  # the synthetic journals stamp the clock
        return [{k: v for k, v in e.items()
                 if k not in ("t", "t_dispatch", "t_fence")} for e in events]

    assert untimed(a) == untimed(b)
    for events in (a, b):
        assert (t_views.metrics_from_events(events)
                == j_views.metrics_from_events(events))
        assert t_views.phase_totals(events) == j_views.phase_totals(events)
        assert (t_views.fold_pod_levels(events)
                == j_views.fold_pod_levels(events))
        assert (t_views.pod_host_gauges(events)
                == j_views.pod_host_gauges(events))
    prev = {"t": 1.0, "distinct": 10, "queue": 4}
    for cur in ({"t": 3.0, "distinct": 30, "queue": 8},
                {"t": 1.0, "distinct": 10, "queue": 0}):
        assert t_views.eta_s(prev, cur) == j_views.eta_s(prev, cur)
    assert (t_views.merge_journals(a, b) == j_views.merge_journals(a, b))


def test_serve_flag_serves_the_live_run(ff_dir, tmp_path, capsys):
    """`check ... -serve PORT`: the monitor is up for the run's lifetime
    (its URL on stderr), serves the run's journal, and is shut down with
    the run; the transcript equals the reference's -serve run."""
    texts = {}
    for pkg, main in (("torchtlc", t_main), ("jaxtlc", j_main)):
        port = _free_port()
        argv = ["check", str(ff_dir / "MC.cfg"), "-noTool", "-chunk", "128",
                "-qcap", "4096", "-fpcap", "16384", "-serve", str(port),
                "-journal", str(tmp_path / f"{pkg}.journal.jsonl")]
        if pkg == "torchtlc":
            argv += ["-workers", "cpu"]
        assert main(argv) == 0
        cap = capsys.readouterr()
        texts[pkg] = cap.out
        assert f"monitor at http://127.0.0.1:{port}" in cap.err
        assert cap.err.startswith(pkg)
        with pytest.raises(OSError):
            _get(f"http://127.0.0.1:{port}/runs", timeout=2)
    assert masked(texts["torchtlc"]) == masked(texts["jaxtlc"])


def test_sse_tail_survives_torn_trailing_line(tmp_path):
    path = str(tmp_path / "run.journal.jsonl")
    with jr.RunJournal(path) as j:
        _progress(j, 1)
        _progress(j, 2)
    srv = obs_serve.start_server(str(tmp_path))
    got = []

    def subscribe():
        try:
            with urllib.request.urlopen(srv.url + "/events",
                                        timeout=WAIT) as r:
                while True:
                    line = r.readline()
                    if not line:
                        return
                    if line.startswith(b"data: "):
                        got.append(json.loads(line[6:].decode()))
        except OSError:
            pass

    sub = threading.Thread(target=subscribe, daemon=True)
    sub.start()
    try:
        deadline = time.time() + WAIT
        while time.time() < deadline and len(got) < 2:
            time.sleep(0.05)
        assert [e["depth"] for e in got] == [1, 2]

        def line(depth):
            return json.dumps(
                {"v": 1, "t": float(depth), "event": "progress",
                 "depth": depth, "generated": 10 * depth,
                 "distinct": 5 * depth, "queue": depth}, sort_keys=True)

        whole = line(3)
        with open(path, "a") as f:
            f.write(whole[:25])
            f.flush()
        time.sleep(4 * obs_serve.POLL_S)
        assert len(got) == 2
        with open(path, "a") as f:
            f.write(whole[25:] + "\n")
            f.write(line(4) + "\n")
        deadline = time.time() + WAIT
        while time.time() < deadline and len(got) < 4:
            time.sleep(0.05)
    finally:
        srv.shutdown()
    sub.join(timeout=WAIT)
    assert not sub.is_alive()
    assert [e["depth"] for e in got] == [1, 2, 3, 4]


def test_runs_registry_multiplexes(tmp_path):
    for name, depth, done in (("alpha", 3, True), ("beta", 7, False)):
        with jr.RunJournal(str(tmp_path / f"{name}.journal.jsonl")) as j:
            j.event("run_start", version="t", workload=name.upper(),
                    engine="single", device="cpu", params={})
            _progress(j, depth)
            if done:
                j.event("final", verdict="ok", generated=30, distinct=15,
                        depth=depth, queue=0, wall_s=0.1,
                        interrupted=False)
    srv = obs_serve.start_server(str(tmp_path))
    ref = j_serve.start_server(str(tmp_path))
    try:
        runs = json.loads(_get(srv.url + "/runs"))["runs"]
        assert runs == json.loads(_get(ref.url + "/runs"))["runs"]
        by_name = {r["run"]: r for r in runs}
        assert by_name["alpha"]["verdict"] == "ok"
        assert by_name["beta"]["verdict"] == "running"
        for run in ("alpha", "beta"):
            assert (_get(srv.url + f"/metrics?run={run}")
                    == _get(ref.url + f"/metrics?run={run}"))
            assert (_get(srv.url + f"/journal?run={run}")
                    == _get(ref.url + f"/journal?run={run}"))
        assert "jaxtlc_depth 7" in _get(srv.url + "/metrics?run=beta")
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/metrics?run=nope")
        assert e.value.code == 404
    finally:
        srv.shutdown()
        ref.shutdown()


def test_serve_tiny_smoke(capsys):
    assert obs_serve.main(["--tiny"]) == 0
    assert "serve tiny OK" in capsys.readouterr().out


def _tools_tlcstat():
    spec = importlib.util.spec_from_file_location(
        "tools_tlcstat", os.path.join(ROOT, "tools", "tlcstat.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frame(text):
    """A dashboard frame without its program line and its clock-derived
    rates (the synthetic journals stamp the clock)."""
    return [re.sub(r"[\d,.]+ (s|ds)/min", r"N \1/min", ln)
            for ln in text.splitlines()
            if not ln.startswith(("jaxtlc ", "torchtlc "))]


def test_tlcstat_tiny_and_connect_equal_reference(tmp_path, capsys):
    ref = _tools_tlcstat()
    assert tlcstat.main(["--tiny"]) == 0
    mine = capsys.readouterr().out
    assert ref.main(["--tiny"]) == 0
    theirs = capsys.readouterr().out
    assert "tlcstat tiny OK" in mine
    assert _frame(mine) == _frame(theirs)
    t_trace._tiny_journal(str(tmp_path / "tiny.journal.jsonl"))
    srv = obs_serve.start_server(str(tmp_path))
    try:
        assert tlcstat.main(["--connect", srv.url, "--run", "tiny"]) == 0
        mine = capsys.readouterr().out
        assert ref.main(["--connect", srv.url, "--run", "tiny"]) == 0
        theirs = capsys.readouterr().out
    finally:
        srv.shutdown()
    for needle in ("ds/min", "VERDICT: interrupted", "phase walls:",
                   "spill tier:"):
        assert needle in mine, needle
    assert _frame(mine) == _frame(theirs)
    assert tlcstat.main([str(tmp_path / "tiny.journal.jsonl")]) == 0
    assert "VERDICT: interrupted" in capsys.readouterr().out
