"""The port's artifact cache (torchtlc.struct.artifacts; kernel K31
struct_recheck) against jaxtlc's on the CPU.

Pinned here, each against the reference on the same inputs: the keys and
codec digests of the shipped struct models (narrowed too); the
fingerprint inversion and the states recovered from a final table; K31's
plain version and its g++ build bit-equal to the reference's
``_recheck_fn`` over reachable sets, with seeded rows whose first failure
in artifact order is not the lowest invariant's first row; and the
command across the two packages - the reference writes a store through
``-artifact-cache DIR`` and the port answers from it (a verdict hit that
builds no engine and runs no re-check, an invariant-only edit through the
re-check, a seeded violation caught as a full run catches it) and the
reverse.  Then the reference's store tests on the port: corrupt artifacts
are loud misses that heal, an ENGINE_SEMVER bump misses, ``-recheck``
bypasses, ``-no-artifact-cache``, violating and reduced runs write
nothing, a codec wider than 64 bits skips the reach tier; and ``-infer``
reading exact evidence from a stored artifact.

Every store is a temporary directory: the port's process store is off
(TORCHTLC_ARTIFACT_CACHE=off) unless a test points it at one."""

import contextlib
import ctypes
import io
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from jaxtlc.cli import main as j_main
from jaxtlc.struct import artifacts as ja
from jaxtlc.struct.cache import get_backend as j_get_backend
from jaxtlc.struct.cache import get_bounds as j_get_bounds
from jaxtlc.struct.loader import load as j_load
from torchtlc.cli import main as t_main
from torchtlc.engine.fingerprint import (DEFAULT_FP_INDEX, DEFAULT_SEED,
                                         affine_basis)
from torchtlc.kernels import build
from torchtlc.struct import artifacts as ta
from torchtlc.struct.backend import StructProgram
from torchtlc.struct.cache import get_backend, get_bounds
from torchtlc.struct.engine import check_struct
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWOPHASE = os.path.join(ROOT, "specs", "TwoPhase.toolbox", "Model_1",
                        "MC.cfg")
RAFT = os.path.join(ROOT, "specs", "RaftReplication.toolbox", "Model_1",
                    "MC.cfg")

SPEC = """---- MODULE ArtTiny ----
EXTENDS Naturals
CONSTANTS MAX
VARIABLES x, y

Init == /\\ x = 0
        /\\ y = 0

Up == /\\ x < MAX
      /\\ x' = x + 1
      /\\ y' = y

Flip == /\\ x > 0
        /\\ y' = 1 - y
        /\\ x' = x

Reset == /\\ x = MAX
         /\\ x' = 0
         /\\ y' = y

Next == Up \\/ Flip \\/ Reset

Spec == Init /\\ [][Next]_<<x, y>>

InRange == x <= MAX
YBit == y <= 1
YNonNeg == y >= 0
NoTop == x < MAX
====
"""


def _cfg(*invariants):
    return ("CONSTANT MAX = 4\nSPECIFICATION\nSpec\nINVARIANT\n"
            + "\n".join(invariants) + "\n")


CFG = _cfg("InRange", "YBit")
CFG_CLEAN_EDIT = _cfg("InRange", "YBit", "YNonNeg")  # invariant-only
CFG_SEEDED = _cfg("InRange", "YBit", "NoTop")  # NoTop is violated
GEOM = ["-chunk", "64", "-qcap", "1024", "-fpcap", "4096"]


@pytest.fixture(autouse=True)
def _stores_off(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


def _write_model(root, cfg_text, name):
    d = root / name
    d.mkdir()
    (d / "ArtTiny.tla").write_text(SPEC)
    (d / "ArtTiny.cfg").write_text(cfg_text)
    return str(d / "ArtTiny.cfg")


def _masked(text: str) -> str:
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search"))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def _cli(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue()


def _port(cfg, *extra, store=None, journal=None):
    argv = ["check", cfg, "-frontend", "struct", "-noTool", "-workers",
            "cpu"] + GEOM + list(extra)
    if store is not None:
        argv += ["-artifact-cache", str(store)]
    if journal is not None:
        argv += ["-journal", str(journal)]
    return _cli(t_main, argv)


def _ref(cfg, *extra, store=None, journal=None):
    argv = ["check", cfg, "-frontend", "struct", "-noTool"] + GEOM + list(
        extra)
    if store is not None:
        argv += ["-artifact-cache", str(store)]
    if journal is not None:
        argv += ["-journal", str(journal)]
    return _cli(j_main, argv)


def _events(journal):
    with open(journal) as f:
        return [(e["tier"], e["outcome"]) for e in map(json.loads, f)
                if e["event"] == "cache"]


def _violation_section(text):
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if "is violated" in ln)
    end = next(i for i, ln in enumerate(lines) if ln.startswith("Progress("))
    return lines[start:end]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("arttiny")
    return {name: _write_model(root, text, name) for name, text in (
        ("base", CFG), ("edit", CFG_CLEAN_EDIT), ("seeded", CFG_SEEDED),
        ("seeded_full", CFG_SEEDED))}


@pytest.fixture(scope="module")
def ref_store(models, tmp_path_factory):
    """A store the reference's command wrote on a clean fresh run, and that
    run's transcript."""
    d = tmp_path_factory.mktemp("ref_store") / "s"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAXTLC_ARTIFACT_CACHE", "off")
        rc, out = _ref(models["base"], store=d)
    assert rc == 0 and sorted(os.listdir(d)) == ["reach", "verdict"]
    return d, out


def _copy_store(src, tmp_path, name="copy"):
    dst = tmp_path / name
    shutil.copytree(src, dst)
    return dst


# ---------------------------------------------------------------------------
# keys, inversion, recovered states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,cfg,narrow", [
    ("TwoPhase", TWOPHASE, False), ("RaftReplication", RAFT, False),
    ("RaftReplication/narrow", RAFT, True)],
    ids=["TwoPhase", "RaftReplication", "RaftReplication-narrow"])
def test_keys_and_codec_digest_equal_reference(name, cfg, narrow):
    m, jm = load(cfg), j_load(cfg)
    for ckd in (True, False):
        assert ta.verdict_key(m, ckd) == ja.verdict_key(jm, ckd)
        assert ta.reach_key(m, ckd) == ja.reach_key(jm, ckd)
        assert ta.behavior_digest(m) == ja.behavior_digest(jm)
    assert ta.verdict_key(m, True, ("P",)) == ja.verdict_key(jm, True,
                                                             ("P",))
    bounds = jbounds = None
    if narrow:
        bounds, jbounds = get_bounds(m), j_get_bounds(jm)
        assert bounds.certified and jbounds.certified
    cdc = get_backend(m, False, bounds=bounds).cdc
    jcdc = j_get_backend(jm, False, bounds=jbounds).cdc
    assert ta.codec_digest(cdc, bounds) == ja.codec_digest(jcdc, jbounds)
    assert (ta.ENGINE_SEMVER, ta.FORMAT_VERSION) == (ja.ENGINE_SEMVER,
                                                     ja.FORMAT_VERSION)


def test_fp_inversion_roundtrips_exactly():
    rng = np.random.default_rng(7)
    for nbits in (13, 40, 64):
        W = (nbits + 31) // 32
        words = rng.integers(0, 2 ** 32, size=(257, W), dtype=np.uint32)
        if nbits % 32:
            words[:, -1] &= np.uint32((1 << (nbits % 32)) - 1)
        const, basis = affine_basis(nbits, DEFAULT_FP_INDEX, DEFAULT_SEED)
        b64 = np.array([int(basis[i, 0]) | (int(basis[i, 1]) << 32)
                        for i in range(nbits)], dtype=np.uint64)
        bits = np.zeros((words.shape[0], nbits), dtype=np.uint64)
        for i in range(nbits):
            bits[:, i] = (words[:, i // 32] >> np.uint32(i % 32)) & 1
        fp = (np.bitwise_xor.reduce(bits * b64[None, :], axis=1)
              ^ np.uint64(int(const[0]) | (int(const[1]) << 32)))
        lo = (fp & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (fp >> np.uint64(32)).astype(np.uint32)
        got = ta.invert_fps(lo, hi, nbits, DEFAULT_FP_INDEX, DEFAULT_SEED)
        assert got is not None and np.array_equal(got, words), nbits
        assert np.array_equal(got, ja.invert_fps(
            lo, hi, nbits, DEFAULT_FP_INDEX, DEFAULT_SEED))
    assert ta._solve_basis(65, DEFAULT_FP_INDEX, DEFAULT_SEED) is None


def test_store_roundtrip_ls_gc_stats(tmp_path, monkeypatch):
    """The reference's store test on the port's store, with its listing,
    collection and counters; the reference's store reads the files."""
    st = ta.ArtifactStore(str(tmp_path / "s"))
    key = "ab" * 32
    payload = dict(workload="W", verdict="ok", generated=1, distinct=1,
                   depth=1, queue=0, n_init=1, action_generated={},
                   action_distinct={}, action_order=[], outdegree=None,
                   properties=[], wall_s=0.0, created_t=0.0)
    st.put_verdict(key, payload)
    assert st.lookup_verdict(key) == payload
    states = np.arange(8, dtype=np.uint32).reshape(4, 2)
    st.put_reach(key, states, dict(workload="W", codec_digest="cd",
                                   nbits=33, generated=4, distinct=4,
                                   depth=2, n_init=1, action_generated={},
                                   action_distinct={}, outdegree=None))
    got = st.lookup_reach(key)
    assert got is not None and np.array_equal(got[0], states)
    jst = ja.ArtifactStore(str(tmp_path / "s"))
    assert jst.lookup_verdict(key) == payload
    assert np.array_equal(jst.lookup_reach(key)[0], states)
    rows = st.ls()
    assert {(r["tier"], r["workload"]) for r in rows} == {
        ("verdict", "W"), ("reach", "W")}
    assert st.stats()["writes"] == 2 and st.stats()["reach_hits"] == 1
    # bit-flip the payload: a loud miss, and the file goes
    vpath = st._path("verdict", key)
    raw = open(vpath).read().replace('"generated": 1', '"generated": 2')
    open(vpath, "w").write(raw)
    warned = []
    assert st.lookup_verdict(key, warn=warned.append) is None
    assert warned and not os.path.exists(vpath)
    assert st.stats()["corrupt"] == 1
    # a future engine semver is a plain miss, never corruption
    monkeypatch.setattr(ta, "ENGINE_SEMVER", ta.ENGINE_SEMVER + 1)
    assert st.lookup_reach(key) is None and st.stats()["corrupt"] == 1
    # gc keeps what fits, newest first
    assert st.gc(0) == dict(kept=0, deleted=1, bytes=0)
    assert st.ls() == []


@pytest.fixture(scope="module")
def reach_sets():
    """{name: (model, backend, recovered states)} for TwoPhase and
    RaftReplication Model_1, from the port's captured final tables."""
    out = {}
    for name, cfg in (("TwoPhase", TWOPHASE), ("RaftReplication", RAFT)):
        m = load(cfg)
        r = check_struct(m, check_deadlock=False, device="cpu",
                         capture_fps=True, chunk=256,
                         fp_capacity=1 << 15)
        be = get_backend(m, False)
        st = ta.states_from_table(r.fp_table, be.cdc.nbits,
                                  DEFAULT_FP_INDEX, DEFAULT_SEED)
        assert st is not None and st.shape[0] == r.distinct
        if name == "TwoPhase":
            assert np.array_equal(st, ja.states_from_table(
                r.fp_table, be.cdc.nbits, DEFAULT_FP_INDEX, DEFAULT_SEED))
        out[name] = (m, be, st)
    return out


def test_states_from_table_equal_reference(reach_sets):
    m, be, st = reach_sets["TwoPhase"]
    assert st.shape == (56, be.cdc.n_words)
    # every recovered row is a reachable state: the packed Init rows
    # are among them
    inits = be.cdc.pack(torch.from_numpy(np.asarray(
        be.initial_vectors(), np.int32))).numpy().view(np.uint32)
    rows = {tuple(r) for r in st}
    assert all(tuple(r) in rows for r in inits)


@pytest.fixture(scope="module")
def host_libs(reach_sets):
    """The g++ build of each model's emitted text (K31's host loop)."""
    out = {}
    for name, (_, be, _) in reach_sets.items():
        lib = ctypes.CDLL(build.build_struct(be.kernels.prog.text,
                                             host=True))
        lib.host_struct_recheck.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_longlong] + [ctypes.c_void_p] * 2
        out[name] = lib
    return out


def _host_recheck(lib, prog, words):
    bits = np.zeros(words.shape[0], np.int32)
    first = np.zeros(1, np.int64)
    lib.host_struct_recheck(prog.K.ctypes.data, words.ctypes.data,
                            words.shape[0], bits.ctypes.data,
                            first.ctypes.data)
    return bits, int(first[0])


def _seeded(prog, st, rng):
    """Random packed rows (masked to the codec's bits) that break
    invariants: one that breaks only a higher invariant, and one, later,
    that breaks two including a lower one."""
    n_inv = prog.n_inv
    W, nbits = prog.W, prog.cdc.nbits
    cand = rng.integers(0, 2 ** 32, size=(4096, W), dtype=np.uint32)
    if nbits % 32:
        cand[:, -1] &= np.uint32((1 << (nbits % 32)) - 1)
    bits, _ = prog.recheck_plain(torch.from_numpy(cand.view(np.int32)))
    bits = bits.numpy()
    full = (1 << n_inv) - 1
    unset = [[k for k in range(n_inv) if not (b >> k) & 1] for b in bits]
    two = next(i for i, u in enumerate(unset) if len(u) >= 2)
    low = unset[two][0]
    one = next(i for i, u in enumerate(unset) if u and u[0] > low)
    assert (bits[two] & full) != full
    return cand[one], cand[two], unset[one][0]


@pytest.mark.parametrize("name", ["TwoPhase", "RaftReplication"])
def test_recheck_bits_equal_reference(reach_sets, host_libs, name):
    """K31's plain version and g++ build against the reference's
    _recheck_fn on the reachable set, then with seeded rows: the first
    failing row in artifact order is reported with its lowest unset bit
    (a row breaking only a higher invariant comes before one breaking a
    lower one - K18's rule would pick the later row)."""
    m, be, st = reach_sets[name]
    prog = be.kernels.prog
    jm = j_load(TWOPHASE if name == "TwoPhase" else RAFT)
    jbe = j_get_backend(jm, False)
    rng = np.random.default_rng(5)
    one, two, code_k = _seeded(prog, st, rng)
    k = st.shape[0] // 2
    seeded = np.concatenate([st[:k], one[None], st[k:], two[None]])
    for words, first_want in ((st, st.shape[0]), (seeded, k)):
        want = np.asarray(ja._recheck_fn(jbe, ("t", name))(words))
        bits, first = prog.recheck_plain(torch.from_numpy(
            words.view(np.int32)))
        assert np.array_equal(bits.numpy(), want)
        assert int(first) == first_want
        hbits, hfirst = _host_recheck(host_libs[name], prog, words)
        assert np.array_equal(hbits, want) and hfirst == first_want
        code, fields = ta.run_recheck(m, be, words, "cpu")
        jcode, jfields = ja.run_recheck(jm, jbe, words, ("t", name))
        assert code == jcode
        if code:
            assert code == be.inv_codes[code_k]
            assert np.array_equal(fields, jfields)
        else:
            assert fields is None and jfields is None


# ---------------------------------------------------------------------------
# the command across the two packages
# ---------------------------------------------------------------------------


def test_verdict_hit_from_reference_store(models, ref_store, tmp_path,
                                          monkeypatch):
    """The reference wrote the store; the port answers an unchanged spec
    from its verdict tier - no engine, no re-check - with the transcript
    of the reference's own hit."""
    src, _ = ref_store
    mine, theirs = (_copy_store(src, tmp_path, "t"),
                    _copy_store(src, tmp_path, "j"))
    from torchtlc.resil import supervisor
    from torchtlc.struct import engine

    def no_engine(*a, **k):
        raise AssertionError("a verdict hit built an engine")

    monkeypatch.setattr(supervisor, "check_supervised", no_engine)
    monkeypatch.setattr(engine, "check_struct", no_engine)
    monkeypatch.setattr(StructProgram, "recheck_plain", no_engine)
    journal = tmp_path / "hit.jsonl"
    rc, out = _port(models["base"], store=mine, journal=journal)
    ref_rc, ref = _ref(models["base"], store=theirs)
    assert rc == ref_rc == 0
    assert "Incremental re-check: verdict replayed" in out
    assert _masked(out) == _masked(ref)
    assert _events(journal) == [("verdict", "hit")]


def test_reach_hit_and_seeded_violation_from_reference_store(
        models, ref_store, tmp_path, monkeypatch):
    """An invariant-only edit is a reach hit through the re-check (one
    call, the plain version of K31 here) with the reference's transcript,
    then a verdict hit for the new key; a seeded violation exits 12 with
    the violation section of a full run."""
    src, _ = ref_store
    calls = []
    plain = StructProgram.recheck_plain

    def counted(self, words):
        calls.append(words.shape[0])
        return plain(self, words)

    monkeypatch.setattr(StructProgram, "recheck_plain", counted)
    mine, theirs = (_copy_store(src, tmp_path, "t"),
                    _copy_store(src, tmp_path, "j"))
    journal = tmp_path / "reach.jsonl"
    rc, out = _port(models["edit"], store=mine, journal=journal)
    ref_rc, ref = _ref(models["edit"], store=theirs)
    assert rc == ref_rc == 0 and calls == [10]
    assert "re-evaluating invariants only (BFS skipped)" in out
    assert _masked(out) == _masked(ref)
    evs = _events(journal)
    assert ("reach", "hit") in evs and ("verdict", "write") in evs
    # the run's cache counters, as the reference's metrics summarize them
    from jaxtlc.obs.views import metrics_from_events
    from torchtlc.obs.views import cache_gauges

    with open(journal) as f:
        events = [json.loads(ln) for ln in f]
    want = metrics_from_events(events)
    assert cache_gauges(events) == {
        k: want[k] for k in ("artifact_cache_hit_total",
                             "artifact_cache_miss_total")} == {
        "artifact_cache_hit_total": 1, "artifact_cache_miss_total": 1}
    journal2 = tmp_path / "reach2.jsonl"
    _port(models["edit"], store=mine, journal=journal2)
    assert _events(journal2) == [("verdict", "hit")]
    assert calls == [10]

    rc, out = _port(models["seeded"], store=mine)
    ref_rc, ref = _ref(models["seeded"], store=theirs)
    full_rc, full = _port(models["seeded_full"], "-no-artifact-cache")
    assert rc == ref_rc == full_rc == 12 and len(calls) == 2
    assert "Invariant NoTop is violated" in out
    assert _violation_section(out) == _violation_section(full)
    assert _masked(out) == _masked(ref)
    # the violating runs published no verdict
    assert not os.path.exists(ta.ArtifactStore(str(mine))._path(
        "verdict", ta.verdict_key(load(models["seeded"]))))


def test_port_store_read_by_reference(models, tmp_path):
    """The reverse: the port writes; jaxtlc's store verifies every file and
    its command answers from both tiers with the port's transcripts."""
    d = tmp_path / "s"
    rc, fresh = _port(models["base"], store=d)
    assert rc == 0 and sorted(os.listdir(d)) == ["reach", "verdict"]
    rows = ja.ArtifactStore(str(d)).verify()
    assert len(rows) == 2 and all(r["ok"] for r in rows)
    theirs = _copy_store(d, tmp_path, "j")
    for name in ("base", "edit"):
        rc, out = _port(models[name], store=d)
        ref_rc, ref = _ref(models[name], store=theirs)
        assert rc == ref_rc == 0 and "Incremental re-check" in ref
        assert _masked(out) == _masked(ref)


# ---------------------------------------------------------------------------
# the store's discipline on the port
# ---------------------------------------------------------------------------


def test_corrupt_artifacts_are_loud_misses_and_self_heal(models, ref_store,
                                                         tmp_path):
    src, fresh = ref_store
    d = _copy_store(src, tmp_path)
    st = ta.ArtifactStore(str(d))
    m = load(models["base"])
    for p in (st._path("verdict", ta.verdict_key(m)),
              st._path("reach", ta.reach_key(m))):
        raw = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(raw[:-5] + bytes(5))
    journal = tmp_path / "corrupt.jsonl"
    rc, out = _port(models["base"], store=d, journal=journal)
    assert rc == 0 and out.count("corrupt") >= 2
    evs = _events(journal)
    assert ("verdict", "corrupt") in evs and ("reach", "corrupt") in evs
    assert ("verdict", "write") in evs and ("reach", "write") in evs
    assert all(r["ok"] for r in st.verify())
    assert all(r["ok"] for r in ja.ArtifactStore(str(d)).verify())
    # the full run's counts are the cached ones
    assert re.findall(r"\d+ states generated.*", out) == re.findall(
        r"\d+ states generated.*", fresh)


def test_engine_semver_bump_misses(models, ref_store, tmp_path,
                                   monkeypatch):
    src, _ = ref_store
    d = _copy_store(src, tmp_path)
    monkeypatch.setattr(ta, "ENGINE_SEMVER", ta.ENGINE_SEMVER + 1)
    journal = tmp_path / "semver.jsonl"
    rc, out = _port(models["base"], store=d, journal=journal)
    assert rc == 0 and "Incremental re-check" not in out
    evs = _events(journal)
    assert ("verdict", "miss") in evs and ("reach", "miss") in evs
    assert ("verdict", "write") in evs and ("reach", "write") in evs


def test_recheck_bypasses_and_no_artifact_cache(models, ref_store, tmp_path):
    src, _ = ref_store
    d = _copy_store(src, tmp_path)
    journal = tmp_path / "bypass.jsonl"
    rc, out = _port(models["base"], "-recheck", store=d, journal=journal)
    assert rc == 0 and "Incremental re-check" not in out
    assert _events(journal) == [("verdict", "bypass"), ("verdict", "write")]
    before = sorted(os.listdir(d / "verdict"))
    journal = tmp_path / "off.jsonl"
    rc, out = _port(models["edit"], "-no-artifact-cache", store=d,
                    journal=journal)
    assert rc == 0 and _events(journal) == []
    assert sorted(os.listdir(d / "verdict")) == before


def test_violating_and_reduced_runs_write_nothing(models, tmp_path):
    d = tmp_path / "s"
    rc, _ = _port(models["seeded"], store=d)
    assert rc == 12
    rc, _ = _port(models["base"], "-symmetry", store=d)
    assert rc == 0
    assert not os.path.exists(d) or not any(
        os.listdir(d / t) for t in os.listdir(d))


def test_wide_codec_skips_the_reach_tier(tmp_path):
    """RaftReplication with five nodes packs 67 bits un-narrowed (53
    narrowed): no affine inverse exists, so a clean record writes the
    verdict tier and journals the reach tier's skip."""
    d = tmp_path / "rr5"
    d.mkdir()
    shutil.copy(os.path.join(os.path.dirname(RAFT), "RaftReplication.tla"),
                d)
    (d / "MC.cfg").write_text(open(RAFT).read().replace(
        "{n1, n2, n3}", "{n1, n2, n3, n4, n5}"))
    m = load(str(d / "MC.cfg"))
    assert get_backend(m, False).cdc.nbits == 67
    assert get_backend(m, False, bounds=get_bounds(m)).cdc.nbits == 53
    from torchtlc.engine.bfs import CheckResult
    from torchtlc.obs.journal import RunJournal

    r = CheckResult(generated=1, distinct=1, depth=1, queue_left=0,
                    violation=0, violation_name="none",
                    violation_state=np.zeros(0, np.int32),
                    violation_action=-1, action_generated={},
                    action_distinct={}, wall_s=0.0, iterations=1,
                    fp_table=np.zeros((4, 16), np.uint32))
    store = ta.ArtifactStore(str(tmp_path / "s"))
    plan = ta.ArtifactPlan(store, m, check_deadlock=False, device="cpu")
    j = RunJournal(None)
    plan.record(r, n_init=1, journal=j)
    assert [(e["tier"], e["outcome"]) for e in j.events] == [
        ("verdict", "write"), ("reach", "skip")]
    assert not store.has_reach(plan.rkey)


def test_infer_reads_artifact_evidence_as_reference(models, ref_store,
                                                    tmp_path, monkeypatch):
    """-infer with the process store pointed at a store holding the spec's
    reach artifact: exact artifact evidence, the reference's report."""
    src, _ = ref_store
    mine, theirs = (_copy_store(src, tmp_path, "t"),
                    _copy_store(src, tmp_path, "j"))
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", str(mine))
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", str(theirs))
    tj, jj = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    rc, out = _port(models["base"], "-infer", journal=tj)
    ref_rc, ref = _ref(models["base"], "-infer", journal=jj)
    assert rc == ref_rc == 0
    assert "exact artifact evidence" in out
    assert _masked(out) == _masked(ref)
    assert _events(tj) == _events(jj) == [("verdict", "bypass")]
