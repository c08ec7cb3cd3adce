"""The port's native disk tier (torchtlc.native, torchtlc.engine.hybrid:
-fpset DiskFPSet) against jaxtlc's on the CPU.

The native store and queue: the reference's unit tests on the port's copy,
the files byte-equal to the reference's after the same inserts and pushes,
and each package reopening the other's files.  The device half: the
port's expand (kernel K1's sharded variant at D = 1 - its plain version
and the g++ build of its header - then K2's plain version) against the
reference's jitted expand on an FF block, exactly.  check_hybrid: the
CheckResult equal field for field to jaxtlc's (walls left out) on FF, FF
over 4 partitions, the delete_noop mutation and Model_1, whose store and
queue files are byte-equal too; checkpoints interrupted by one package and
resumed by the other; the checkpoint errors; and the command's transcript
beside the reference's."""

import contextlib
import ctypes
import hashlib
import io
import os
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxtlc.cli import main as j_main
from jaxtlc.config import MODEL_1 as J_MODEL_1
from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.engine import hybrid as jh
from jaxtlc.engine.fingerprint import fp64_words as j_fp64
from jaxtlc.native import HostFPStore as JStore
from jaxtlc.native import HostStateQueue as JQueue
from jaxtlc.spec.codec import get_codec as j_codec
from jaxtlc.spec.invariants import make_invariant_kernel as j_inv
from jaxtlc.spec.kernel import make_kernel as j_kernel
from torchtlc.cli import main as t_main
from torchtlc.config import MODEL_1, ModelConfig
from torchtlc.engine import hybrid as th
from torchtlc.engine.backend import kernel_layout
from torchtlc.engine.fingerprint import fp64_words_plain
from torchtlc.native import HostFPStore, HostStateQueue
from torchtlc.testing import one_thread

one_thread()

FF, J_FF = ModelConfig(False, False), JConfig(False, False)
FF_COUNTS = (17020, 8203, 109)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torchtlc", "kernels", "csrc")
PTR, INT, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _sig(r):
    """Every CheckResult field but the wall."""
    return (r.generated, r.distinct, r.depth, r.queue_left, r.violation,
            r.violation_name, np.asarray(r.violation_state).tolist(),
            r.violation_action, r.action_generated, r.action_distinct,
            r.iterations, r.outdegree)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---------------------------------------------------------------------------
# the native tier: the reference's unit tests on the port's copy
# ---------------------------------------------------------------------------


def test_fpstore_dedup_and_growth(tmp_path):
    rng = np.random.default_rng(3)
    with HostFPStore(str(tmp_path / "t.fps"), initial_capacity=64) as s:
        seen = set()
        for _ in range(30):
            vals = rng.integers(1, 5000, size=512, dtype=np.uint64)
            lo = (vals & 0xFFFFFFFF).astype(np.uint32)
            hi = (vals >> 32).astype(np.uint32)
            mask = rng.random(512) < 0.8
            is_new = s.insert(lo, hi, mask)
            for v, m, n in zip(vals, mask, is_new):
                if m:
                    assert n == (int(v) not in seen)
                    seen.add(int(v))
                else:
                    assert not n
        assert len(s) == len(seen)
        assert s.capacity >= len(seen)  # grew past the initial 64


def test_fpstore_persistence(tmp_path):
    p = str(tmp_path / "persist.fps")
    s = HostFPStore(p, initial_capacity=64)
    lo = np.arange(1, 101, dtype=np.uint32)
    hi = np.zeros(100, dtype=np.uint32)
    s.insert(lo, hi, np.ones(100, bool))
    s.sync()
    s.close()
    s2 = HostFPStore(p, fresh=False)  # the TLC -recover analog
    assert len(s2) == 100
    again = s2.insert(lo, hi, np.ones(100, bool))
    assert not again.any()  # everything already known after reopen
    s2.close()
    # the default (fresh=True) must start empty even when the file exists
    with HostFPStore(p) as s3:
        assert len(s3) == 0


def test_fpstore_zero_and_one_are_distinct(tmp_path):
    with HostFPStore(str(tmp_path / "z.fps"), initial_capacity=64) as s:
        lo = np.array([0, 1, 0, 1], dtype=np.uint32)
        hi = np.zeros(4, dtype=np.uint32)
        new = s.insert(lo, hi, np.ones(4, bool))
        assert list(new) == [True, True, False, False]
        assert len(s) == 2


def test_state_queue_fifo(tmp_path):
    with HostStateQueue(4, str(tmp_path / "q.sq")) as q:
        a = np.arange(40, dtype=np.int32).reshape(10, 4)
        q.push(a[:6])
        got = q.pop(3)
        assert (got == a[:3]).all()
        q.push(a[6:])
        got = q.pop(100)
        assert (got == a[3:]).all()
        assert len(q) == 0
        assert q.total_pushed == 10


def test_queue_resume_reopen(tmp_path):
    p = str(tmp_path / "resume.sq")
    q = HostStateQueue(4, p)
    a = np.arange(40, dtype=np.int32).reshape(10, 4)
    q.push(a)
    got = q.pop(4)
    assert (got == a[:4]).all()
    head, tail = q.head, q.total_pushed
    q.sync()
    q.close()
    q2 = HostStateQueue(4, p, resume_head=head, resume_tail=tail)
    assert len(q2) == 6
    got = q2.pop(100)
    assert (got == a[4:]).all()
    q2.close()


def test_native_built_from_the_port_sources():
    """The library is g++'s build of torchtlc/native's sources, in the
    port's build directory."""
    from torchtlc import native

    path = native._build()
    assert path.startswith(native.BUILD_DIR) and os.path.exists(path)
    assert "jaxtlc" not in os.path.basename(path)


def _fill(store_cls, queue_cls, d, tag):
    """The same inserts (growth past the initial capacity, fp 0, repeats)
    and pushes through one package's classes."""
    rng = np.random.default_rng(11)
    fps, sq = str(d / f"{tag}.fps"), str(d / f"{tag}.sq")
    news = []
    with store_cls(fps, initial_capacity=64) as s:
        for _ in range(6):
            vals = rng.integers(0, 1 << 40, size=300, dtype=np.uint64)
            vals[:3] = 0
            news.append(s.insert((vals & 0xFFFFFFFF).astype(np.uint32),
                                 (vals >> 32).astype(np.uint32),
                                 rng.random(300) < 0.9))
        s.sync()
    q = queue_cls(5, sq)
    q.push(rng.integers(-9, 9, size=(77, 5), dtype=np.int32))
    q.pop(20)
    head, tail = q.head, q.total_pushed
    q.sync()
    q.close()
    return fps, sq, np.concatenate(news), (head, tail)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_byte_equal_and_reopened_across_packages(tmp_path, writer):
    """The same operations write the same store and queue bytes in both
    packages; each package reopens the files the other wrote."""
    t_fps, t_sq, t_new, t_cur = _fill(HostFPStore, HostStateQueue, tmp_path,
                                      "t")
    j_fps, j_sq, j_new, j_cur = _fill(JStore, JQueue, tmp_path, "j")
    assert np.array_equal(t_new, j_new) and t_cur == j_cur
    assert _sha(t_fps) == _sha(j_fps) and _sha(t_sq) == _sha(j_sq)
    fps, sq = (t_fps, t_sq) if writer == "port" else (j_fps, j_sq)
    store_cls, queue_cls = ((JStore, JQueue) if writer == "port"
                            else (HostFPStore, HostStateQueue))
    with store_cls(fps, fresh=False) as s:
        assert len(s) == int(t_new.sum())
        again = s.insert(np.zeros(1, np.uint32), np.zeros(1, np.uint32),
                         np.ones(1, bool))
        assert not again.any()  # fp 0 was inserted before
    q = queue_cls(5, sq, resume_head=t_cur[0], resume_tail=t_cur[1])
    assert len(q) == t_cur[1] - t_cur[0]
    rows = q.pop(100)
    q.close()
    raw = np.fromfile(sq, dtype=np.int32).reshape(-1, 5)
    assert np.array_equal(rows, raw[t_cur[0]:t_cur[1]])


# ---------------------------------------------------------------------------
# the device half against the reference's jitted expand
# ---------------------------------------------------------------------------


def _ref_expand(cfg, chunk):
    """jaxtlc/engine/hybrid.py:145-153, as check_hybrid builds it."""
    cdc = j_codec(cfg)
    F = cdc.n_fields
    step = j_kernel(cfg)
    L = step.n_lanes
    inv_check = j_inv(cfg)

    @jax.jit
    def expand(batch):
        succs, valid, action, afail, ovf = jax.vmap(step)(batch)
        flat = succs.reshape(chunk * L, F)
        inv = jax.vmap(inv_check)(flat)
        packed = cdc.pack(flat)
        lo, hi = j_fp64(packed, cdc.nbits)
        return flat, lo, hi, valid, action, afail, ovf, inv

    return expand, L


@pytest.fixture(scope="module")
def ff_ref(tmp_path_factory):
    """The reference's FF run at chunk 256, with its queue file (every
    distinct state once, in BFS order)."""
    d = tmp_path_factory.mktemp("ff_ref")
    r = jh.check_hybrid(J_FF, chunk=256, queue_path=str(d / "q.sq"))
    rows = np.fromfile(str(d / "q.sq"), dtype=np.int32)
    return r, rows.reshape(-1, j_codec(J_FF).n_fields)


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("host_k1") / "libhost.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-D__host__=",
         "-D__device__=", "-I", CSRC, "-o", so,
         os.path.join(CSRC, "host_launch.cpp")],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.host_expand_sharded.argtypes = [PTR, PTR, LL, INT, PTR, PTR, INT, INT,
                                        INT, PTR, PTR, PTR, PTR, PTR, PTR]
    return lib


def _host_half(lib, cfg, rows, n, chunk):
    """K1's g++ build at D = 1 over the staged block, K2's plain version."""
    lay = kernel_layout(cfg)
    L, F, W = int(lay[28]), int(lay[24]), int(lay[25])
    stage = np.zeros((1, chunk + 1, F), np.int32)
    stage[0, :n] = rows[:n]
    ncand = chunk * L
    packed = np.zeros((ncand, W), np.int32)
    flags = np.zeros((5, ncand), np.uint8)
    action = np.zeros(ncand, np.int32)
    fields = np.zeros((ncand, F), np.int32)
    gen = np.zeros((1, 22), np.uint64)
    qh, npop = np.zeros(1, np.int64), np.array([n], np.int64)
    p = (lambda a: a.ctypes.data)
    lib.host_expand_sharded(p(lay), p(stage), chunk + 1, chunk, p(qh),
                            p(npop), 1, chunk, 0, p(packed), p(flags),
                            p(action), p(fields), None, p(gen))
    lo, hi = fp64_words_plain(torch.from_numpy(packed), get_nbits(cfg))
    return th.DeviceHalf(torch.from_numpy(fields), lo, hi,
                         torch.from_numpy(flags), torch.from_numpy(action))


def get_nbits(cfg):
    from torchtlc.spec.codec import get_codec

    return get_codec(cfg).nbits


@pytest.mark.parametrize("route", ["plain", "host_build"])
@pytest.mark.parametrize("n", [256, 173])
def test_expand_equals_reference(ff_ref, host_k1, route, n):
    """flat, lo, hi, valid, action, afail, ovf and inv of every lane the
    hybrid step reads (valid masked by the pop, afail and ovf by valid;
    inv as the two invariant-failure flag rows), exactly."""
    chunk = 256
    _, states = ff_ref
    rows = np.ascontiguousarray(states[1000:1000 + chunk])
    expand, L = _ref_expand(J_FF, chunk)
    buf = np.zeros((chunk, rows.shape[1]), np.int32)
    buf[:n] = rows[:n]
    flat, lo, hi, valid, action, afail, ovf, inv = map(
        np.asarray, expand(jnp.asarray(buf)))
    valid = valid.copy()
    valid[n:] = False
    fvalid = valid.reshape(-1)
    if route == "plain":
        h = th.make_expand(FF, chunk, "cpu")(rows, n)
    else:
        h = _host_half(host_k1, FF, rows, n, chunk)
    t_lo, t_hi, t_flags, t_action = th.host_view(h)
    want_flags = np.stack([
        fvalid, (afail & valid).reshape(-1), (ovf & valid).reshape(-1),
        fvalid & ((inv & 1) == 0), fvalid & ((inv & 2) == 0)])
    assert np.array_equal(t_flags.astype(bool), want_flags)
    assert fvalid.any() and t_lo.dtype == np.uint32
    assert np.array_equal(h.fields.numpy()[fvalid], flat[fvalid])
    assert np.array_equal(t_lo[fvalid], lo[fvalid].astype(np.uint32))
    assert np.array_equal(t_hi[fvalid], hi[fvalid].astype(np.uint32))
    assert np.array_equal(t_action[fvalid], action.reshape(-1)[fvalid])


# ---------------------------------------------------------------------------
# check_hybrid against the reference's
# ---------------------------------------------------------------------------


def test_ff_equals_reference(ff_ref):
    ref, _ = ff_ref
    timing = {}
    r = th.check_hybrid(FF, chunk=256, device="cpu", timing=timing)
    assert (r.generated, r.distinct, r.depth) == FF_COUNTS
    assert r.outdegree == (1, 0, 3, 2)
    assert _sig(r) == _sig(ref)
    # the per-phase split of the wall: every phase ran, none is negative
    assert set(timing) == {"pop", "h2d", "device", "d2h", "stats",
                           "insert", "push"}
    assert min(timing.values()) >= 0


def test_ff_partitions_equal_reference(ff_ref):
    """4 fingerprint partitions change no field of the result: the port's
    equals the reference's unpartitioned run (which the reference's own
    tests hold equal to its partitioned one)."""
    ref, _ = ff_ref
    r4 = th.check_hybrid(FF, chunk=256, fp_partitions=4, device="cpu")
    assert _sig(r4) == _sig(ref)


def test_chunk_not_a_power_of_two_equals_reference():
    """The staging queue holds chunk + 1 rows and pops with head 0, so any
    chunk works: 200 here."""
    j = jh.check_hybrid(J_FF, chunk=200)
    r = th.check_hybrid(FF, chunk=200, device="cpu")
    assert (r.generated, r.distinct, r.depth) == FF_COUNTS
    assert _sig(r) == _sig(j)


def test_delete_noop_violation_equals_reference():
    j = jh.check_hybrid(JConfig(False, False, mutation="delete_noop"),
                        chunk=256)
    r = th.check_hybrid(ModelConfig(False, False, mutation="delete_noop"),
                        chunk=256, device="cpu")
    assert r.violation != 0 and "assert" in r.violation_name.lower()
    assert _sig(r) == _sig(j)


def test_model1_equals_reference_files_byte_equal(tmp_path):
    """Model_1 at chunk 1024: 577,736 / 163,408 / 124, the per-action
    counts of MC.out, the hybrid's own outdegree, and the store (a 32-byte
    header and 2^20 slots) and queue files byte-equal to the
    reference's."""
    tp, jp = tmp_path / "t", tmp_path / "j"
    tp.mkdir()
    jp.mkdir()
    j = jh.check_hybrid(J_MODEL_1, chunk=1024, fp_path=str(jp / "s.fps"),
                        queue_path=str(jp / "q.sq"))
    r = th.check_hybrid(MODEL_1, chunk=1024, fp_path=str(tp / "s.fps"),
                        queue_path=str(tp / "q.sq"), device="cpu")
    assert (r.generated, r.distinct, r.depth) == (577736, 163408, 124)
    assert r.action_generated["DoRequest"] == 149766
    assert r.action_generated["APIStart"] == 27059
    assert r.outdegree == (1, 0, 3, 2) and r.iterations == 237
    assert _sig(r) == _sig(j)
    for name, size in (("s.fps", 8388640), ("q.sq", 13072640)):
        assert os.path.getsize(tp / name) == size
        assert _sha(tp / name) == _sha(jp / name)


@pytest.mark.parametrize("first", ["reference", "port"])
def test_checkpoint_resumed_by_the_other_package(ff_ref, tmp_path, first):
    """Interrupted at max_chunks=8 by one package and resumed by the other
    to the uninterrupted counts."""
    ref, _ = ff_ref
    kw = dict(chunk=128, ckpt_every=4)
    ck = str(tmp_path / "hyb.ckpt")
    if first == "reference":
        partial = jh.check_hybrid(J_FF, max_chunks=8, ckpt_path=ck, **kw)
        resumed = th.check_hybrid(FF, resume=True, ckpt_path=ck,
                                  device="cpu", **kw)
    else:
        partial = th.check_hybrid(FF, max_chunks=8, ckpt_path=ck,
                                  device="cpu", **kw)
        resumed = jh.check_hybrid(J_FF, resume=True, ckpt_path=ck, **kw)
    assert partial.queue_left > 0 and partial.iterations == 8
    assert (resumed.generated, resumed.distinct, resumed.depth) == FF_COUNTS
    assert resumed.action_generated == ref.action_generated
    assert resumed.action_distinct == ref.action_distinct
    assert resumed.queue_left == 0 and resumed.violation == 0
    assert resumed.outdegree == ref.outdegree


def test_checkpoint_errors_equal_reference(tmp_path):
    for mod, cfg in ((th, FF), (jh, J_FF)):
        with pytest.raises(ValueError, match="power of two") as e:
            mod.check_hybrid(cfg, chunk=128, fp_partitions=3,
                             **({"device": "cpu"} if mod is th else {}))
        assert "got 3" in str(e.value)
    ck = str(tmp_path / "m.ckpt")
    th.check_hybrid(FF, chunk=128, ckpt_path=ck, ckpt_every=64,
                    max_chunks=2, device="cpu")
    errs = []
    for mod, cfg, bad in ((th, FF, ModelConfig(True, False)),
                          (jh, J_FF, JConfig(True, False))):
        extra = {"device": "cpu"} if mod is th else {}
        for kw in (dict(cfg=cfg, chunk=256), dict(cfg=bad, chunk=128),
                   dict(cfg=cfg, chunk=128, fp_partitions=2)):
            with pytest.raises(ValueError, match="mismatch") as e:
                mod.check_hybrid(kw.pop("cfg"), ckpt_path=ck, resume=True,
                                 **kw, **extra)
            errs.append(str(e.value))
    assert errs[:3] == errs[3:]
    with pytest.raises(FileNotFoundError):
        th.check_hybrid(FF, ckpt_path=str(tmp_path / "none"), resume=True,
                        device="cpu")


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


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hyb_cli") / "Model_FF"
    d.mkdir()
    (d / "MC.tla").write_text(MC_TLA)
    (d / "MC.cfg").write_text(MC_CFG)
    return d


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
    return rc, out.getvalue(), err.getvalue()


def _journal(path):
    import json

    with open(path) as f:
        evs = [json.loads(ln) for ln in f]
    return [{k: v for k, v in e.items() if k not in ("t", "wall_s")}
            for e in evs]


def test_command_partitions_checkpoint_recover_equal_reference(model_dir,
                                                               tmp_path):
    """-fpset DiskFPSet -sharded 4 -checkpoint then -recover: the
    transcripts and journals (engine "hybrid") equal the reference's."""
    cfg = str(model_dir / "MC.cfg")
    outs = {}
    for name, fn, extra in (("t", t_main, ["-workers", "cpu"]),
                            ("j", j_main, [])):
        ck = str(tmp_path / f"{name}.ckpt")
        base = ["check", cfg, "-noTool", "-fpset", "DiskFPSet", "-sharded",
                "4", "-checkpoint", ck, "-chunk", "256"] + extra
        first = _cli(fn, base + ["-checkpointevery", "16"])
        again = _cli(fn, base + ["-recover"])
        outs[name] = (first, again, _journal(ck + ".journal.jsonl"))
        assert os.path.exists(ck + ".meta.json")
    for k in (0, 1):
        rc, out, _ = outs["t"][k]
        ref_rc, ref, _ = outs["j"][k]
        assert rc == ref_rc == 0
        assert "17020 states generated, 8203 distinct" in out
        assert _masked(out) == _masked(ref)
    tj, jj = outs["t"][2], outs["j"][2]
    assert tj[0]["engine"] == jj[0]["engine"] == "hybrid"
    for ev in (tj[0], jj[0]):
        ev.pop("device")
        ev.pop("version")
    for ev in tj + jj:
        ev.pop("path", None)
    assert tj == jj


@pytest.mark.parametrize("n,rc_want", [(16, 0), (3, 1)])
def test_command_partition_counts_equal_reference(model_dir, n, rc_want):
    """-sharded N counts partitions under DiskFPSet: 16 runs (past the
    sharded engine's limit of 8), 3 exits 1 with the reference's error."""
    argv = ["check", str(model_dir / "MC.cfg"), "-noTool", "-fpset",
            "DiskFPSet", "-sharded", str(n), "-chunk", "256"]
    rc, out, err = _cli(t_main, argv + ["-workers", "cpu"])
    ref_rc, ref, ref_err = _cli(j_main, argv)
    assert rc == ref_rc == rc_want
    assert _masked(out) == _masked(ref)
    if rc_want:
        assert err == ref_err == (
            "Error: -sharded with -fpset DiskFPSet needs a power-of-two "
            "partition count, got 3\n")
