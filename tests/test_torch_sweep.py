"""The constants-class sweep of the port against jaxtlc.serve.sweep,
tolerance zero.

- SweepEngine.run's final carries, lane by lane and leaf for leaf (fp
  table words, queue words, counters, violation leaves), against the
  reference's vmapped SweepEngine on TwoPhaseB (MAXR swept over [0, 2]):
  sorted at chunk 8 (lanes that end at different bodies, with and without
  the deadlock check) and at chunk 64 with a padded width of 4, sort-free
  + deferred at chunk 2048, two-tier at chunk 2^14;
- lanes of different body widths in one dispatch (TwoPhaseB with six
  resource managers at chunk 2^14: the MAXR 2 lane pops full-width bodies
  while the MAXR 0 lane pops the narrow ones), against the port's own
  sequential runs - the reference's CPU run of that class takes minutes;
- the counts of each lane against the baked-constant check of its MAXR;
- class_key and config_inits field for field; sweep_backend's CompileError
  on a shape-determining constant and its SweepError on a bad name;
- kernels K32 (emitted_expand_batched) and K33 (fpset_insert_batched)
  through the g++ build of their headers against their plain versions.
"""

import ctypes
import os
import subprocess

import jax
import numpy as np
import pytest
import torch

from jaxtlc.serve import sweep as jsw
from jaxtlc.struct.compile import CompileError as JCompileError
from test_service import _TPB, _cfg
from torchtlc.engine import fpset as tfs
from torchtlc.engine.interop import LEAF_ORDER, carry_to_numpy
from torchtlc.kernels.build import build_struct
from torchtlc.serve import sweep as tsw
from torchtlc.struct.compile import CompileError
from torchtlc.struct.engine import check_struct
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

PARAMS = {"MAXR": (0, 2)}
CONFIGS = [{"MAXR": v} for v in (0, 1, 2)]
# (generated, distinct, depth, Renege fires) per MAXR (tests/test_service.py)
EXPECT = {0: (81, 49, 8, 0), 1: (119, 66, 8, 18), 2: (124, 68, 8, 22)}
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torchtlc", "kernels", "csrc")


@pytest.fixture(scope="module")
def tpb(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep")
    (d / "TwoPhaseB.tla").write_text(_TPB)
    (d / "TwoPhaseB.cfg").write_text(_cfg(2))
    rm6 = _TPB.replace("MODULE TwoPhaseB ", "MODULE TwoPhaseB6 ")
    (d / "TwoPhaseB6.tla").write_text(rm6)
    (d / "TwoPhaseB6.cfg").write_text(_cfg(2).replace(
        "{r1, r2}", "{r1, r2, r3, r4, r5, r6}"))
    return d


def _ref_lanes(out, width):
    lanes = []
    for k in range(width):
        jc = jax.tree.map(lambda x: x[k], out)
        lanes.append({f: np.asarray(jc.fps.table if f == "fps"
                                    else getattr(jc, f))
                      for f in LEAF_ORDER
                      if getattr(jc, f, None) is not None})
    return lanes


def _assert_words_equal(a: dict, b: dict, where):
    assert set(a) == set(b), (where, set(a) ^ set(b))
    for f in a:
        assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, (
            where, f)
        assert (a[f] == b[f]).all(), (where, f)


# (chunk, queue capacity, fp capacity, width, check_deadlock)
GEOMS = {
    "sorted-chunk8": (8, 256, 1 << 10, 3, False),
    "sorted-chunk8-deadlock": (8, 256, 1 << 10, 3, True),
    "sorted-chunk64-pad4": (64, 1 << 10, 1 << 12, 4, False),
    "sortfree-deferred-chunk2048": (2048, 1 << 12, 1 << 16, 3, False),
    "twotier-chunk16384": (1 << 14, 1 << 15, 1 << 20, 3, False),
}


@pytest.mark.parametrize("geom", list(GEOMS))
def test_sweep_run_equals_reference_lane_for_lane(tpb, geom):
    chunk, q, fp, width, dl = GEOMS[geom]
    kw = dict(chunk=chunk, queue_capacity=q, fp_capacity=fp,
              check_deadlock=dl, width=width)
    cfg = str(tpb / "TwoPhaseB.cfg")
    je = jsw.SweepEngine(jsw.load_anchored(cfg, PARAMS), PARAMS, **kw)
    stacked = je._stack(CONFIGS)
    ref = _ref_lanes(je._vrun(stacked), width)
    te = tsw.SweepEngine(tsw.load_anchored(cfg, PARAMS), PARAMS,
                         device="cpu", **kw)
    carries, _ = te.run_carries(CONFIGS)
    assert len(carries) == width
    for k in range(width):  # pad lanes repeat the last config
        _assert_words_equal(carry_to_numpy(carries[k]), ref[k], (geom, k))
    seq = te.sequential_carries(CONFIGS)
    for k, (c, _, _) in enumerate(seq):
        _assert_words_equal(carry_to_numpy(carries[k]), carry_to_numpy(c),
                            (geom, "sequential", k))
    results = te.run(CONFIGS)
    if not dl:
        for v, r in zip((0, 1, 2), results):
            assert (r.generated, r.distinct, r.depth,
                    r.action_generated.get("Renege", 0)) == EXPECT[v]
    if chunk == 8:
        # the lanes end at different bodies: the batched run outlives
        # the shortest lane, which froze at its own end
        steps = [s for _, _, s in seq]
        assert len(set(steps)) > 1 and te._brun.bodies == max(steps)


def test_mixed_body_widths_equal_sequential_runs(tpb):
    """At chunk 2^14 a lane pops chunk // 16 rows when its level remainder
    is below chunk // 2: the MAXR 2 lane of TwoPhaseB-6 pops full-width
    bodies in bodies where the MAXR 0 lane pops narrow ones.  Each lane
    equals its sequential run, table words included."""
    params = {"MAXR": (0, 2)}
    m = tsw.load_anchored(str(tpb / "TwoPhaseB6.cfg"), params)
    te = tsw.SweepEngine(m, params, chunk=1 << 14, queue_capacity=1 << 15,
                         fp_capacity=1 << 20, check_deadlock=False, width=2,
                         device="cpu")
    cfgs = [{"MAXR": 0}, {"MAXR": 2}]
    carries, _ = te.run_carries(cfgs)
    seq = te.sequential_carries(cfgs)
    widths = te._run_fn.steps_by_width
    assert widths[1 << 14] > 0 and widths[1 << 10] > 0
    for k, (c, _, _) in enumerate(seq):
        _assert_words_equal(carry_to_numpy(carries[k]), carry_to_numpy(c),
                            ("TwoPhaseB-6", k))
    r = [te._result(c, 0.0) for c in carries]
    assert [(x.generated, x.distinct, x.depth) for x in r] == [
        (191921, 47449, 20), (433442, 93434, 20)]


def test_sweep_counts_equal_baked_constant_checks(tpb, tmp_path):
    """Each lane's counts equal the baked-constant check of its MAXR (the
    swept field changes the fingerprints, not the counts)."""
    m = tsw.load_anchored(str(tpb / "TwoPhaseB.cfg"), PARAMS)
    te = tsw.SweepEngine(m, PARAMS, check_deadlock=False, width=3,
                         device="cpu")
    for v, r in zip((0, 1, 2), te.run(CONFIGS)):
        base = load(str(tpb / "TwoPhaseB.cfg"), const_overrides={"MAXR": v})
        b = check_struct(base, check_deadlock=False, chunk=64,
                         queue_capacity=1 << 10, fp_capacity=1 << 12,
                         device="cpu")
        assert (r.generated, r.distinct, r.depth, r.action_generated,
                r.action_distinct) == (b.generated, b.distinct, b.depth,
                                       b.action_generated,
                                       b.action_distinct)


def test_class_key_and_config_inits_equal_reference(tpb):
    cfg = str(tpb / "TwoPhaseB.cfg")
    tm, jm = tsw.load_anchored(cfg, PARAMS), jsw.load_anchored(cfg, PARAMS)
    assert tsw.class_key(tm, PARAMS) == jsw.class_key(jm, PARAMS)
    assert tm.constants["MAXR"] == 2
    fixed = tsw.load_anchored(cfg, PARAMS, const_overrides={"MAXR": 0})
    assert fixed.constants["MAXR"] == 2
    tb = tsw.sweep_backend(tm, PARAMS, False)
    jb = jsw.sweep_backend(jm, PARAMS, False)
    assert tb.cdc.n_fields == jb.cdc.n_fields
    assert tb.labels == jb.labels and tb.inv_codes == jb.inv_codes
    assert tb.viol_names == jb.viol_names
    for values in CONFIGS:
        assert np.array_equal(
            tsw.config_inits(tm, PARAMS, values, tb.cdc),
            jsw.config_inits(jm, PARAMS, values, jb.cdc))
    assert np.array_equal(tb.initial_vectors(), jb.initial_vectors())
    with pytest.raises(tsw.SweepError):
        tsw.config_inits(tm, PARAMS, {}, tb.cdc)


def test_sweep_backend_refusals_equal_reference(tpb, tmp_path):
    cfg = str(tpb / "TwoPhaseB.cfg")
    tm, jm = load(cfg), jsw.load(cfg)
    for bad in ({"RM": (0, 2)}, {"NOPE": (0, 1)}, {"MAXR": (3, 4)}):
        with pytest.raises(tsw.SweepError) as te:
            tsw.sweep_backend(tm, bad)
        with pytest.raises(jsw.SweepError) as je:
            jsw.sweep_backend(jm, bad)
        assert str(te.value) == str(je.value)
    # a constant that sizes a range cannot ride a state field: the
    # compiler needs its value (a loud CompileError at class build)
    d = tmp_path / "shape"
    d.mkdir()
    (d / "Shape.tla").write_text(
        "---- MODULE Shape ----\nEXTENDS Naturals\nCONSTANT N\n"
        "VARIABLE x\nInit == x = 0\nNext == x' \\in 0..N\n"
        "Spec == Init /\\ [][Next]_x\nInv == x \\in 0..N\n====\n")
    (d / "Shape.cfg").write_text("CONSTANT N = 3\nSPECIFICATION\nSpec\n"
                                 "INVARIANT\nInv\n")
    with pytest.raises(CompileError):
        tsw.sweep_backend(tsw.load_anchored(str(d / "Shape.cfg"),
                                            {"N": (1, 3)}), {"N": (1, 3)})
    with pytest.raises(JCompileError):
        je = jsw.SweepEngine(jsw.load_anchored(str(d / "Shape.cfg"),
                                               {"N": (1, 3)}), {"N": (1, 3)},
                             width=1)
        je.carry_for({"N": 2})


# ---------------------------------------------------------------------------
# K32 and K33 through the g++ build
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("k33") / "libhost.so")
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-D__host__=",
         "-D__device__=", "-I", CSRC, "-o", so,
         os.path.join(CSRC, "host_launch.cpp")],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.host_fpset_insert_batched.argtypes = [P, I, P, I, I, P, P, LL, P, I,
                                              P]
    return lib


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("deferred", [False, True])
def test_k32_gxx_equals_plain(tpb, deferred):
    """K32 over a stacked queue with lanes of different pops - a frozen
    lane, a narrow lane, a partial and a full pop - against its plain
    version, slab for slab."""
    m = tsw.load_anchored(str(tpb / "TwoPhaseB.cfg"), PARAMS)
    be = tsw.sweep_backend(m, PARAMS, False)
    prog = be.kernels.prog
    lib = ctypes.CDLL(build_struct(prog.text, host=True))
    lib.host_emitted_expand_batched.argtypes = [P, P, LL, P, I, I, I, P, P,
                                                P, P, P]
    rng = np.random.default_rng(18)
    Kl, C, rows = 4, 16, 40
    # each lane's class config's Init rows, then bit-flipped words
    fields = [np.resize(tsw.config_inits(m, PARAMS, {"MAXR": v}, be.cdc),
                        (rows * 2, be.cdc.n_fields)) for v in (0, 1, 2, 2)]
    queue = torch.zeros(Kl, 2, rows, prog.W, dtype=torch.int32)
    for k in range(Kl):
        packed = be.cdc.pack(torch.from_numpy(fields[k].astype(np.int32)))
        queue[k, 0] = packed[:rows]
        queue[k, 1] = packed[rows:2 * rows]
    queue[:, :, :, 0] ^= torch.from_numpy(
        rng.integers(0, 2, (Kl, 2, rows), dtype=np.int32))
    pop = torch.tensor([[0, 0, 0, 0], [1, 3, 5, 8], [0, 7, 16, 16],
                        [1, 2, 9, 16]], dtype=torch.int64)
    want = prog.expand_batched_plain(queue, pop, C, deferred)
    n = C * prog.L
    got = (torch.zeros(Kl, n, prog.W, dtype=torch.int32),
           torch.zeros(Kl, (3 + prog.n_inv) * n, dtype=torch.uint8),
           torch.zeros(Kl, n, dtype=torch.int32),
           torch.zeros(Kl, prog.n_labels, dtype=torch.int64),
           torch.zeros(Kl, n, prog.F, dtype=torch.int32) if deferred
           else None)
    K = torch.from_numpy(np.ascontiguousarray(prog.K))
    assert lib.host_emitted_expand_batched(
        _p(K), _p(queue), rows, _p(pop), Kl, C, int(deferred),
        _p(got[0]), _p(got[1]), _p(got[2]), _p(got[4]), _p(got[3])) == 0
    for k, (_, _, _, ck) in enumerate(pop.tolist()):
        m_ = ck * prog.L
        nf = (3 + prog.n_inv) * m_
        assert torch.equal(got[0][k, :m_], want[0][k, :m_])
        assert torch.equal(got[1][k, :nf], want[1][k, :nf])
        assert torch.equal(got[2][k, :m_], want[2][k, :m_])
        assert torch.equal(got[3][k], want[3][k])
        if deferred:
            assert torch.equal(got[4][k, :m_], want[4][k, :m_])
    assert int(want[3][0].sum()) == 0 and int(want[3][3].sum()) > 0


@pytest.mark.parametrize("R,C", [(64, 64), (64, 16), (256, 256)])
def test_k33_gxx_equals_plain(host_kernels, R, C):
    """K33's probe segments over stacked tables (a subset of them mapped
    through `lanes`) against the plain batched insert and against K3's
    single-table insert, table words included; one lane masked off
    entirely writes nothing."""
    rng = np.random.default_rng(33 + R + C)
    T, nb, n = 4, 128, 256  # 1,024 slots a table: it never fills
    base = torch.zeros(T, nb, 16, dtype=torch.int32)
    # prefill: two inserts per table, so later probes walk
    for t in range(T):
        for _ in range(2):
            lo = torch.from_numpy(rng.integers(-2**31, 2**31, 48,
                                               dtype=np.int64).astype(np.int32))
            hi = torch.from_numpy(rng.integers(-2**31, 2**31, 48,
                                               dtype=np.int64).astype(np.int32))
            tfs.fpset_insert_sorted(tfs.FPSet(base[t]), lo, hi,
                                    torch.ones(48, dtype=torch.bool))
    lanes = [2, 0, 3]
    lo = torch.from_numpy(rng.integers(-2**31, 2**31, (3, n),
                                       dtype=np.int64).astype(np.int32))
    hi = torch.from_numpy(rng.integers(-2**31, 2**31, (3, n),
                                       dtype=np.int64).astype(np.int32))
    lo[:, ::7] = lo[:, 1::7][:, :lo[:, ::7].shape[1]]  # duplicates
    hi[:, ::7] = hi[:, 1::7][:, :hi[:, ::7].shape[1]]
    mask = torch.from_numpy(rng.random((3, n)) < 0.8)
    mask[1] = False
    plain = base.clone()
    is_new, c_idx, nreps = tfs.fpset_insert_sorted_batched(
        plain, lanes, lo, hi, mask, probe_width=R, claim_width=C)
    single = base.clone()
    for i, t in enumerate(lanes):
        _, s_new, s_idx, s_n = tfs.fpset_insert_sorted(
            tfs.FPSet(single[t]), lo[i], hi[i], mask[i], probe_width=R,
            claim_width=C)
        assert torch.equal(s_new, is_new[i]) and torch.equal(s_idx, c_idx[i])
        assert int(s_n) == int(nreps[i])
    assert torch.equal(plain, single)
    assert torch.equal(plain[1], base[1]) and torch.equal(plain[0], base[0])
    # the g++ build of K33's stages, segment by segment
    gxx = base.clone()
    c_key, _, nr = tfs.dedup_compact_batched(tfs.fpset_key_plain(lo, hi,
                                                                 mask))
    nseg = -(-n // R)
    keys = torch.full((3, nseg * R), tfs.KEY00, dtype=torch.int64)
    keys[:, :n] = c_key
    out = torch.zeros(3, nseg * R, dtype=torch.uint8)
    lane_t = torch.tensor(lanes, dtype=torch.int32)
    for s in range(nseg):
        seg = keys[:, s * R:(s + 1) * R].contiguous()
        o = torch.zeros(3, R, dtype=torch.uint8)
        host_kernels.host_fpset_insert_batched(
            _p(gxx), nb.bit_length() - 1, _p(seg), 3, R, _p(lane_t),
            _p(nr.contiguous()), s * R, None, C, _p(o))
        out[:, s * R:(s + 1) * R] = o
    assert torch.equal(gxx, plain)
    assert torch.equal(out[:, :n].bool(), is_new)
