"""The port's checking service (torchtlc.serve) end to end on the CPU, and
against the reference's (jaxtlc.serve) on the same submits.

One module-scoped port server (the plain path on the CPU, sweep width 3)
runs every flow of the reference's tests/test_service.py:
- the sweep trio folded into batched dispatches through one constants
  class, each verdict and count equal to the reference server's;
- the job-scoped SSE stream to `final`, the /runs registry, /metrics;
- malformed jobs refused with 400;
- a cold submit that meters at least one build, then a warm resubmit
  (plain pooled engine, sweep class, smoke class) that meters 0 builds
  and 0 library loads (serve.pool.CompileMeter);
- the smoke class (seeds fold into one batched walk), the infer class and
  a large supervised job, each against the reference server's answer;
- a cached re-submit answered by the artifact cache's verdict tier;
- struct.cache's LRU memo and the EnginePool's eviction counters, the
  journal's batched fsync;
- on the supervised path: priority preemption resumed bit for bit through
  -recover, a running deadline drained to `expired`, a running cancel.
A second server over a stub pool runs the overload flows of
tests/test_overload.py at policy speed: 429 with Retry-After, a queued
deadline, a queued cancel, priority order.

Every wait has its own timeout of at most 120 s.
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

from jaxtlc.serve import client as jclient
from jaxtlc.serve.server import start_server as j_start_server
from test_service import (
    _CHAIN_CFG,
    _CHAIN_SPEC,
    _EXPECT,
    _HEAVY,
    _OPTS,
    _SIM_OPTS,
    _SWEEP,
    _TPB,
    _cfg,
)
from torchtlc.obs import journal as obs_journal
from torchtlc.resil.faults import TransientFault
from torchtlc.serve import client
from torchtlc.serve.pool import EnginePool, builds, loads
from torchtlc.serve.scheduler import DrainTimeout
from torchtlc.serve.server import CheckServer, start_server
from torchtlc.testing import one_thread

one_thread()

WAIT = 120  # every wait's own timeout (seconds)
_INFER_OPTS = dict(infer=True, inferbudget=16, nodeadlock=True)
_LARGE_OPTS = dict(chunk=64, qcap=1 << 10, fpcap=1 << 17, nodeadlock=True,
                   noartifactcache=True)


@pytest.fixture(scope="module", autouse=True)
def _artifact_cache_off():
    """The artifact cache stays off (a shared store would answer the
    warm-pool submits); one test points it at a temporary store."""
    saved = {k: os.environ.get(k) for k in ("TORCHTLC_ARTIFACT_CACHE",
                                            "JAXTLC_ARTIFACT_CACHE")}
    os.environ["TORCHTLC_ARTIFACT_CACHE"] = "off"
    os.environ["JAXTLC_ARTIFACT_CACHE"] = "off"
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def server():
    srv = start_server(sweep_width=3, device="cpu")
    yield srv
    srv.shutdown()
    assert not srv._thread.is_alive()
    assert not srv.scheduler._thread.is_alive()


def _submit_reference_set(url, c):
    ids = {f"sweep{v}": c.submit(url, _TPB, _cfg(2), name=f"tpb-max{v}",
                                 constants={"MAXR": v}, sweep=_SWEEP,
                                 options=_OPTS) for v in (0, 1, 2)}
    ids["plain"] = c.submit(url, _TPB, _cfg(2), name="plain",
                            options=_OPTS)
    for s in (1, 2):
        ids[f"smoke{s}"] = c.submit(url, _TPB, _cfg(2), name=f"smoke-{s}",
                                    options=dict(_SIM_OPTS, simseed=s))
    ids["infer"] = c.submit(url, _TPB, _cfg(2), name="infer",
                            options=_INFER_OPTS)
    ids["large"] = c.submit(url, _TPB, _cfg(1), name="large",
                            options=_LARGE_OPTS)
    return ids


@pytest.fixture(scope="module")
def port_jobs(server):
    ids = _submit_reference_set(server.url, client)
    return {k: client.wait(server.url, i, timeout=WAIT)
            for k, i in ids.items()}


@pytest.fixture(scope="module")
def ref_jobs(_artifact_cache_off):
    srv = j_start_server(sweep_width=3)
    try:
        ids = _submit_reference_set(srv.url, jclient)
        return {k: jclient.wait(srv.url, i, timeout=WAIT)
                for k, i in ids.items()}
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# the flows against the reference server
# ---------------------------------------------------------------------------

_COMPARED = ("verdict", "generated", "distinct", "depth", "violation",
             "action_generated")


def test_verdicts_and_counts_equal_reference_server(port_jobs, ref_jobs):
    for k, ref in ref_jobs.items():
        mine = port_jobs[k]
        assert mine["state"] == ref["state"] == "done", (k, mine, ref)
        assert mine["result"]["engine"] == ref["result"]["engine"], k
        for f in _COMPARED:
            assert mine["result"].get(f) == ref["result"].get(f), (k, f)
    for s in (1, 2):
        mine = port_jobs[f"smoke{s}"]["result"]["sim"]
        ref = ref_jobs[f"smoke{s}"]["result"]["sim"]
        assert mine == ref, s
    mine, ref = port_jobs["infer"]["result"], ref_jobs["infer"]["result"]
    for f in ("candidates", "killed", "survivors", "certified",
              "uncertified", "cfg_killed", "exact", "n_states"):
        assert mine["infer"][f] == ref["infer"][f], f
    mine, ref = port_jobs["large"]["result"], ref_jobs["large"]["result"]
    assert mine["engine"] == ref["engine"] == "supervised"
    assert mine["exit_code"] == ref["exit_code"] == 0


def test_server_sweep_e2e(server, port_jobs):
    for v in (0, 1, 2):
        st = port_jobs[f"sweep{v}"]
        r = st["result"]
        gen, dist, depth, renege = _EXPECT[v]
        assert r["engine"] == "sweep" and r["verdict"] == "ok"
        assert (r["generated"], r["distinct"], r["depth"]) == (gen, dist,
                                                              depth)
        assert r["action_generated"].get("Renege", 0) == renege
    stats = client.pool_stats(server.url)
    assert stats["pool"]["misses"] >= 1 and stats["pool"]["device"] == "cpu"
    assert stats["scheduler"]["batched_jobs"] >= 3


def test_job_scoped_sse_stream_registry_and_metrics(server, port_jobs):
    job_id = port_jobs["sweep1"]["id"]
    events = list(client.stream(server.url, job_id, timeout=WAIT))
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "final"
    assert events[0]["engine"] == "sweep" and events[0]["device"] == "cpu"
    assert events[-1]["verdict"] == "ok"
    assert events[-1]["distinct"] == _EXPECT[1][1]
    runs = client._get(server.url + "/runs")["runs"]
    by = {r["run"]: r for r in runs}
    assert {st["id"] for st in port_jobs.values()} <= set(by)
    assert by[job_id]["verdict"] == "ok"
    with urllib.request.urlopen(f"{server.url}/metrics?run={job_id}",
                                timeout=WAIT) as r:
        text = r.read().decode()
    assert "jaxtlc_run_info" in text and "jaxtlc_distinct_total 66" in text


def test_server_rejects_malformed_jobs(server):
    def post(payload):
        req = urllib.request.Request(
            server.url + "/jobs", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        return urllib.request.urlopen(req, timeout=WAIT)

    for bad in (
        {},
        {"spec": "not a module", "cfg": _cfg(1)},
        {"spec": _TPB, "cfg": _cfg(1), "sweep": _SWEEP},
        {"spec": _TPB, "cfg": _cfg(1), "constants": {"MAXR": 1},
         "sweep": {"const": "MAXR", "lo": 0}},
    ):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(bad)
        assert e.value.code == 400


def test_warm_resubmit_builds_and_loads_nothing(server, port_jobs):
    """A cold submit meters at least one build (the lane compile and the
    emitted text - the plain CPU path builds no library); the warm
    resubmit of the plain engine, the sweep class and the smoke class
    meters 0 builds and 0 library loads."""
    opts = dict(_OPTS, qcap=1 << 11)  # a geometry no fixture job used
    pre = builds(), loads()
    cold = client.check(server.url, _TPB, _cfg(2), name="plain-cold",
                        options=opts, timeout=WAIT)
    assert cold["result"]["engine"] == "pool"
    assert cold["result"]["pool_hit"] is False
    assert builds() - pre[0] >= 1
    for name, kw in (
            ("plain-warm", dict(options=opts)),
            ("sweep-warm", dict(constants={"MAXR": 1}, sweep=_SWEEP,
                                options=_OPTS)),
            ("smoke-warm", dict(options=dict(_SIM_OPTS, simseed=3)))):
        pre = builds(), loads()
        st = client.check(server.url, _TPB, _cfg(2), name=name,
                          timeout=WAIT, **kw)
        assert st["result"]["pool_hit"] is True, name
        assert (builds() - pre[0], loads() - pre[1]) == (0, 0), name
    assert st["result"]["engine"] == "sim"
    stats = client.pool_stats(server.url)["pool"]
    assert stats["builds"] == builds() and stats["loads"] == loads()


def test_smoke_job_class_e2e(server, port_jobs):
    sts = {s: port_jobs[f"smoke{s}"] for s in (1, 2)}
    for s, st in sts.items():
        r = st["result"]
        assert r["engine"] == "sim" and r["verdict"] == "ok", r
        assert r["sim"]["seed"] == s and r["sim"]["walkers"] == 8
        assert r["sim"]["transitions"] > 0
    events = list(client.stream(server.url, sts[1]["id"], timeout=WAIT))
    assert events[0]["engine"] == "sim" and events[-1]["event"] == "final"
    assert [e for e in events if e["event"] == "sim"][-1]["phase"] == \
        "summary"


def test_cached_resubmit_answers_from_the_verdict_tier(server, tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", str(tmp_path / "arts"))
    first = client.check(server.url, _TPB, _cfg(1), name="cache-fresh",
                         options=_OPTS, timeout=WAIT)
    assert first["result"]["engine"] == "pool"
    again = client.check(server.url, _TPB, _cfg(1), name="cache-hit",
                         options=_OPTS, timeout=WAIT)
    assert again["result"]["engine"] == "cache"
    assert again["result"]["cache_hit"] is True
    for f in ("generated", "distinct", "depth", "verdict"):
        assert again["result"][f] == first["result"][f], f
    events = list(client.stream(server.url, again["id"], timeout=WAIT))
    assert ("cache", "hit") in [(e["event"], e.get("outcome"))
                                for e in events]


def test_struct_cache_lru_cap_and_stats():
    from torchtlc.struct.cache import _LRUMemo, set_caps, stats

    m = _LRUMemo(2)
    assert m.get("a") is None
    m.put("a", 1)
    m.put("b", 2)
    assert m.get("a") == 1
    m.put("c", 3)
    assert m.get("b") is None
    assert m.get("a") == 1 and m.get("c") == 3
    s = m.stats()
    assert (s["hits"], s["misses"], s["size"], s["evictions"]) == (3, 2, 2,
                                                                   1)
    top = stats()
    for memo in ("backend", "engine", "bounds"):
        for k in ("hits", "misses", "size", "cap", "evictions"):
            assert k in top[memo]
    cap = top["engine"]["cap"]
    set_caps(engine=1)
    assert stats()["engine"]["size"] <= 1
    set_caps(engine=cap)


def test_engine_pool_lru_eviction_and_stats():
    pool = EnginePool(capacity=2, device="cpu")
    built = []

    def make(tag):
        def build():
            built.append(tag)
            return tag
        return build

    for tag in ("a", "b"):
        pool._get_or_build((tag,), make(tag), "single", {})
    assert pool._get_or_build(("a",), make("a2"), "single", {}).runner == "a"
    pool._get_or_build(("c",), make("c"), "single", {})
    assert built == ["a", "b", "c"]
    pool._get_or_build(("b",), make("b2"), "single", {})
    s = pool.stats()
    assert (s["hits"], s["misses"], s["evictions"], s["size"]) == (1, 4, 2,
                                                                   2)
    assert s["compiles"] == 4 and s["build_meter"] == "ok"
    assert "builds" in s and "loads" in s and "memo" in s


def test_journal_batched_fsync(tmp_path, monkeypatch):
    syncs = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync",
                        lambda fd: (syncs.append(fd), real_fsync(fd)))
    path = str(tmp_path / "batched.journal.jsonl")
    j = obs_journal.RunJournal(path, fsync_every=3)
    for d in (1, 2):
        j.event("progress", depth=d, generated=d, distinct=d, queue=0)
    assert syncs == []
    assert len(obs_journal.read(path, validate=False)) == 2
    j.event("progress", depth=3, generated=3, distinct=3, queue=0)
    assert len(syncs) == 1
    j.event("progress", depth=4, generated=4, distinct=4, queue=0)
    j.sync()
    assert len(syncs) == 2
    j.close()
    assert [e["depth"] for e in obs_journal.read(path)] == [1, 2, 3, 4]


# ---------------------------------------------------------------------------
# the overload plane on the supervised path
# ---------------------------------------------------------------------------


def _wait_running(url, jid, timeout=WAIT):
    deadline = time.time() + timeout
    while True:
        st = client.status(url, jid)
        if st["state"] == "running":
            return st
        assert st["state"] == "queued", st
        assert time.time() < deadline, f"{jid} never started running"
        time.sleep(0.005)


def test_priority_preemption_resume_bit_for_bit(server, tmp_path):
    url = server.url
    ref = client.check(url, _CHAIN_SPEC, _CHAIN_CFG, name="preempt-ref",
                       options=dict(_HEAVY,
                                    checkpoint=str(tmp_path / "ref.npz")),
                       timeout=WAIT)
    assert ref["state"] == "done" and ref["result"]["verdict"] == "ok"
    low = {}
    for attempt in range(3):
        lo_id = client.submit(
            url, _CHAIN_SPEC, _CHAIN_CFG, name=f"preempt-lo{attempt}",
            options=dict(_HEAVY, priority=0,
                         checkpoint=str(tmp_path / f"lo{attempt}.npz")))
        _wait_running(url, lo_id)
        hi_id = client.submit(
            url, _CHAIN_SPEC, _CHAIN_CFG, name=f"preempt-hi{attempt}",
            options=dict(_HEAVY, priority=10,
                         checkpoint=str(tmp_path / f"hi{attempt}.npz")))
        low = client.wait(url, lo_id, timeout=WAIT)
        assert client.wait(url, hi_id, timeout=WAIT)["state"] == "done"
        if low.get("requeues", 0) >= 1:
            break
    assert low["state"] == "done" and low["requeues"] >= 1
    assert low["options"]["recover"] is True
    for k in ("generated", "distinct", "depth", "violation",
              "action_generated"):
        assert low["result"][k] == ref["result"][k], k
    sched = [e for e in obs_journal.read(
        os.path.join(server.root, "sched.journal.jsonl"))
        if e["event"] == "sched" and e.get("job") == low["id"]]
    assert any(e["action"] == "preempt" and e["reason"] == "priority"
               for e in sched)
    assert any(e["action"] == "requeue" for e in sched)
    # the drained run journaled its interruption as a drain
    evs = obs_journal.read(os.path.join(server.root,
                                        f"{low['id']}.journal.jsonl"))
    assert any(e["event"] == "interrupted" and e.get("drained")
               for e in evs)


def test_running_deadline_drains_to_expired(server, tmp_path):
    st = client.check(server.url, _CHAIN_SPEC, _CHAIN_CFG,
                      name="deadline-run",
                      options=dict(_HEAVY, deadline_s=0.3,
                                   checkpoint=str(tmp_path / "dl.npz")),
                      timeout=WAIT)
    assert st["state"] == "expired", st
    assert "deadline expired while running" in st["error"]
    assert st["result"]["exit_code"] == 75
    assert 0 < st["result"]["depth"] < 600


def test_cancel_running_job_drains_to_canceled(server, tmp_path):
    jid = client.submit(server.url, _CHAIN_SPEC, _CHAIN_CFG,
                        name="cancel-run",
                        options=dict(_HEAVY,
                                     checkpoint=str(tmp_path / "cx.npz")))
    _wait_running(server.url, jid)
    client.cancel(server.url, jid)
    st = client.wait(server.url, jid, timeout=WAIT)
    assert st["state"] == "canceled", st
    assert st["result"]["exit_code"] == 75


# ---------------------------------------------------------------------------
# the overload plane at policy speed (a stub pool, tests/test_overload.py)
# ---------------------------------------------------------------------------

OK_SPEC = ("---- MODULE OverloadOK ----\nVARIABLE x\nInit == x = 0\n"
           "Next == x' = x\n====\n")
CFG = "SPECIFICATION\nSpec\n"


class _StubPool:
    sweep_width = 4
    device = torch.device("cpu")

    def stats(self):
        return dict(hits=0, misses=0, size=0, compiles=0, entries=[])


@pytest.fixture(scope="module")
def stub_server():
    srv = CheckServer(pool=_StubPool(), queue_bound=3, tenant_quota=2)
    sch = srv.scheduler

    def stub_run(batch):
        for j in batch:
            if j.name.startswith("die-once") and j.retries == 0:
                raise TransientFault("injected runner death")
            if j.name.startswith("slow:"):
                time.sleep(float(j.name.split(":")[1].split("-")[0]))
            with sch._journal(j) as jr:
                jr.event("run_start", version="test", workload=j.name,
                         engine="stub", device="host", params={})
                jr.event("final", verdict="ok", generated=1, distinct=1,
                         depth=1, queue=0, wall_s=0.0, interrupted=False)
            sch._finish_ok(j, dict(verdict="ok", engine="stub",
                                   generated=1, distinct=1, depth=1,
                                   wall_s=0.0))

    sch._run_batch = stub_run
    yield srv
    srv.shutdown()


def _stall(srv, secs, name):
    jid = client.submit(srv.url, OK_SPEC, CFG, name=f"slow:{secs}-{name}")
    deadline = time.time() + WAIT
    while client.status(srv.url, jid)["state"] != "running":
        assert time.time() < deadline
        time.sleep(0.005)
    return jid


def _raw_submit(url, payload):
    req = urllib.request.Request(
        url.rstrip("/") + "/jobs", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def test_admission_429_deadline_cancel_and_priority(stub_server):
    srv = stub_server
    _stall(srv, 0.6, "admission")
    queued = [client.submit(srv.url, OK_SPEC, CFG, name=f"q{i}",
                            tenant=f"t{i}") for i in range(3)]
    code, headers, body = _raw_submit(srv.url, dict(spec=OK_SPEC, cfg=CFG,
                                                    name="over"))
    assert code == 429 and int(headers["Retry-After"]) >= 1
    assert json.loads(body)["retry_after"] >= 1
    srv.scheduler.drain(timeout=WAIT)
    assert all(client.status(srv.url, j)["state"] == "done" for j in queued)
    # a queued deadline expires; a queued cancel lands `canceled`
    _stall(srv, 0.5, "deadline")
    dl = client.submit(srv.url, OK_SPEC, CFG, name="dl",
                       options=dict(deadline_s=0.05))
    cx = client.submit(srv.url, OK_SPEC, CFG, name="cx")
    client.cancel(srv.url, cx)
    assert client.wait(srv.url, dl, timeout=WAIT)["state"] == "expired"
    assert client.wait(srv.url, cx, timeout=WAIT)["state"] == "canceled"
    events = list(client.stream(srv.url, dl, timeout=WAIT))
    assert events[-1]["event"] == "final"
    # priority order: the higher priority dispatches first
    _stall(srv, 0.4, "prio")
    lo = client.submit(srv.url, OK_SPEC, CFG, name="lo",
                       options=dict(priority=0))
    hi = client.submit(srv.url, OK_SPEC, CFG, name="hi",
                       options=dict(priority=5))
    a = client.wait(srv.url, lo, timeout=WAIT)
    b = client.wait(srv.url, hi, timeout=WAIT)
    assert b["started_t"] <= a["started_t"]
    # a transient dispatch fault retries to done
    st = client.check(srv.url, OK_SPEC, CFG, name="die-once", timeout=WAIT)
    assert st["state"] == "done" and st["retries"] == 1
    with pytest.raises(DrainTimeout):
        _stall(srv, 0.5, "drain")
        srv.scheduler.drain(timeout=0.05)
    srv.scheduler.drain(timeout=WAIT)
