"""The port's device liveness plane (torchtlc.live, the enumerator of
torchtlc.engine.bfs, the sharded fixpoint of torchtlc.engine.sharded)
against jaxtlc's on the CPU, FF corner, zero tolerance: the enumerator's
states[:V], tail and table words; the captured graph array for array;
kernels K14, K15 and K16 through their plain versions and through a g++
build of their __host__ __device__ header (csrc/liveness.cuh) against
_pair_searchsorted with the capture sweep, eval_state_masks and
surviving_set (each fixpoint's sweep count included); the sharded
fixpoint at D = 2, 4 and 8; and check_properties_device's verdicts and
lassos, on one device and on 4 shards."""

import ctypes
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh

from jaxtlc.config import MODEL_1 as J_M1
from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.config import make_scaled as j_make_scaled
from jaxtlc.engine import bfs as jbfs
from jaxtlc.engine import sharded as jsh
from jaxtlc.engine.fingerprint import fp64_words_mxu
from jaxtlc.live import capture as jcap
from jaxtlc.live import check as jchk
from jaxtlc.live import fixpoint as jfix
from jaxtlc.spec.codec import get_codec as j_codec
from torchtlc.config import MODEL_1, ModelConfig, make_scaled
from torchtlc.engine import bfs as tbfs
from torchtlc.engine import sharded as tsh
from torchtlc.engine.backend import FLAG_VALID, expand_plain, kubeapi_backend
from torchtlc.engine.fingerprint import fp64_words
from torchtlc.live import capture as tcap
from torchtlc.live import check as tchk
from torchtlc.live import fixpoint as tfix
from torchtlc.testing import one_thread

one_thread()

FF, J_FF = ModelConfig(False, False), JConfig(False, False)
SIZING = dict(chunk=256, state_capacity=1 << 14, fp_capacity=1 << 14)
PROPS = ["ReconcileCompletes", "CleansUpProperly"]
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torchtlc", "kernels", "csrc")
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@pytest.fixture(scope="module")
def graphs():
    """(reference, port) captured FF graphs."""
    return (jchk.capture_kube_graph(J_FF, **SIZING),
            tchk.capture_kube_graph(FF, **SIZING, device="cpu"))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("live_kernels") / "liblive.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-D__host__=",
         "-D__device__=", "-I", CSRC, "-o", so,
         os.path.join(CSRC, "host_launch.cpp")],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.host_edge_capture.argtypes = [P, P, P, I, I, P, P, P, P, LL, I, I, P]
    lib.host_edge_capture.restype = LL
    lib.host_state_masks.argtypes = [P, P, LL, P]
    lib.host_survive_sweep.argtypes = [P, P, LL, LL, I, P, P, LL, P]
    lib.host_survive_sweep.restype = I
    lib.tt_mask_words.restype = I
    return lib


def _p(a: np.ndarray):
    return a.ctypes.data


# ---------------------------------------------------------------------------
# pass 1: the enumerator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,viol", [
    (dict(chunk=128, state_capacity=1 << 14, fp_capacity=1 << 15),
     tbfs.OK),
    (dict(chunk=64, state_capacity=1 << 12, fp_capacity=1 << 15),
     tbfs.VIOL_QUEUE_FULL),
    (dict(chunk=128, state_capacity=1 << 14, fp_capacity=1 << 12),
     tbfs.VIOL_FPSET_FULL),
], ids=["complete", "queue-full", "fpset-full"])
def test_enumerator_equals_reference(kw, viol):
    """states[:V], tail, head, the verdict and the table words equal the
    reference enumerator's, also when it halts on a full state array or
    a full table."""
    ji, jr = jbfs.make_enumerator(jsh.kubeapi_backend(J_FF), **kw)
    jc = jax.block_until_ready(jr(ji()))
    ti, tr = tbfs.make_enumerator(kubeapi_backend(FF), device="cpu", **kw)
    tc = tr(ti())
    V = int(jc.tail)
    assert (tc.tail, tc.head, tc.viol) == (V, int(jc.head), int(jc.viol))
    assert np.array_equal(tc.states[:V].numpy().view(np.uint32),
                          np.asarray(jc.states)[:V])
    assert np.array_equal(tc.fps.table.numpy().view(np.uint32).ravel(),
                          np.asarray(jc.fps.table).ravel())
    assert tc.viol == viol
    if viol == tbfs.OK:
        assert V == 8203


# ---------------------------------------------------------------------------
# pass 2: the captured graph
# ---------------------------------------------------------------------------


def test_captured_graph_equals_reference(graphs):
    ref, port = graphs
    assert port.n_states == ref.n_states == 8203
    assert port.init_count == ref.init_count
    for name in ("states", "src", "dst", "action", "changed"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_edge_spill_tier_gives_the_same_graph(graphs, tmp_path):
    """With a spill path and a RAM budget of a few thousand edges the
    capture writes part files and reads them back: the same graph."""
    spilled = tcap.capture_edges(kubeapi_backend(FF), **SIZING,
                                 device="cpu", ram_edges=5000,
                                 spill_path=str(tmp_path / "cap"))
    for name in graphs[1]._fields:
        assert np.array_equal(np.asarray(getattr(spilled, name)),
                              np.asarray(getattr(graphs[1], name))), name
    assert not list(tmp_path.glob("cap.edges*"))  # read back and removed
    small = tcap._EdgeSpill(str(tmp_path / "e"), ram_edges=1000)
    rng = np.random.default_rng(3)
    blocks = [rng.integers(0, 99, (700, 4), dtype=np.int32)
              for _ in range(5)]
    for b in blocks:
        small.append(b)
    assert len(small.parts) == 2
    assert np.array_equal(small.finalize(), np.concatenate(blocks))
    assert not list(tmp_path.glob("e.edges*"))


def _ref_sorted(states_u32, nbits):
    lo, hi = fp64_words_mxu(jnp.asarray(states_u32), nbits, 51,
                            0x9E3779B97F4A7C15)
    V = states_u32.shape[0]
    return lax.sort((hi, lo, jnp.arange(V, dtype=jnp.int32)), num_keys=2)


def _ref_sweep(s_hi, s_lo, perm, q_hi, q_lo, valid, action, offset, L):
    """The reference capture sweep's id resolution and compaction
    (jaxtlc/live/capture.py:199-219) on given candidate words."""
    V = s_hi.shape[0]
    idx = jcap._pair_searchsorted(s_hi, s_lo, q_hi, q_lo, V)
    idx_c = jnp.minimum(idx, V - 1)
    found = (s_hi[idx_c] == q_hi) & (s_lo[idx_c] == q_lo) & (idx < V)
    dst = perm[idx_c]
    srcf = offset + jnp.arange(q_hi.shape[0], dtype=jnp.int32) // L
    edges = jnp.stack([srcf, dst, action, (dst != srcf).astype(jnp.int32)],
                      axis=1)
    v = np.asarray(valid)
    return np.asarray(edges)[v], bool((v & ~np.asarray(found)).any())


@pytest.mark.parametrize("offset,n_junk", [(0, 0), (4096, 0), (8192, 37)])
def test_edge_capture_kernel_equals_reference(graphs, host_lib, offset,
                                              n_junk):
    """K14's plain version and its g++ build against the reference's
    _pair_searchsorted and sweep on one capture chunk of FF successors
    (with n_junk valid lanes holding fingerprints outside the set: the
    `missing` flag), and sorted_ids against the reference's lax.sort."""
    _, port = graphs
    cdc = j_codec(J_FF)
    s_hi, s_lo, perm = _ref_sorted(port.states, cdc.nbits)
    states = torch.from_numpy(port.states.view(np.int32))
    lo, hi = fp64_words(states, cdc.nbits)
    t_hi, t_lo, t_perm = tcap.sorted_ids(lo, hi)
    assert np.array_equal(t_hi.numpy().view(np.uint32), np.asarray(s_hi))
    assert np.array_equal(t_lo.numpy().view(np.uint32), np.asarray(s_lo))
    assert np.array_equal(t_perm.numpy(), np.asarray(perm))
    ck = 256
    V = port.n_states
    block = torch.zeros(ck, cdc.n_words, dtype=torch.int32)
    n = min(ck, V - offset)
    block[:n] = states[offset:offset + n]
    packed, flags, action, _ = expand_plain(FF, block, n, deferred=True)
    q_lo, q_hi = fp64_words(packed, cdc.nbits)
    valid = flags[FLAG_VALID].clone()
    if n_junk:
        rng = np.random.default_rng(n_junk)
        lanes = torch.from_numpy(rng.choice(valid.shape[0], n_junk,
                                            replace=False))
        q_lo[lanes] = torch.from_numpy(rng.integers(
            -2**31, 2**31, n_junk).astype(np.int32))
        valid[lanes] = 1
    L = packed.shape[0] // ck
    want, want_missing = _ref_sweep(
        s_hi, s_lo, perm, jnp.asarray(q_hi.numpy().view(np.uint32)),
        jnp.asarray(q_lo.numpy().view(np.uint32)), valid.numpy().astype(bool),
        jnp.asarray(action.numpy()), offset, L)
    assert want_missing == bool(n_junk)
    edges, missing = tcap.edge_capture_plain(t_hi, t_lo, t_perm, q_hi, q_lo,
                                             valid, action, offset, L)
    assert bool(missing) == want_missing
    assert np.array_equal(edges.numpy(), want)
    out = np.zeros((int(valid.sum()), 4), np.int32)
    arrs = [np.ascontiguousarray(x) for x in (
        t_hi.numpy(), t_lo.numpy(), t_perm.numpy(), q_hi.numpy(),
        q_lo.numpy(), valid.numpy(), action.numpy())]
    nv = host_lib.host_edge_capture(
        *map(_p, arrs[:3]), V, max(1, (V - 1).bit_length()),
        *map(_p, arrs[3:]), valid.shape[0], L, offset, _p(out))
    assert nv == (-1 if n_junk else len(want))
    assert np.array_equal(out, want)


# ---------------------------------------------------------------------------
# K15: the property operands
# ---------------------------------------------------------------------------


def _ref_mask_fns(cfg):
    """The reference's sr and secret predicates (jaxtlc/live/check.py:
    99-117), sr rows then one secret row per reconciler."""
    cdc = j_codec(cfg)
    sr_off = cdc.offsets["sr"]
    api_sl = cdc.sl("api")

    def sr_fn(ri):
        return lambda f: f[:, sr_off + ri] == 1

    def secret_fn(ci):
        si, _ = cfg.targets[ci]

        def fn(f):
            api = f[:, api_sl]
            pres = (api >> cdc.o_present) & 1
            ident = (api >> cdc.o_ident) & ((1 << cdc.ib) - 1)
            return ((pres == 1) & (ident == si)).any(axis=1)

        return fn

    return ([sr_fn(r) for r in range(cfg.n_reconcilers)]
            + [secret_fn(ci) for ci in cfg.reconciler_indices])


@pytest.mark.parametrize("which", ["ff-graph", "scaled-2x1-random",
                                   "scaled-3x2-random"])
def test_state_masks_kernel_equals_reference(graphs, host_lib, which):
    """K15's plain version and g++ build against eval_state_masks with the
    reference's predicates: on the captured FF states, and on random
    packed words of larger configurations (two and three reconcilers)."""
    if which == "ff-graph":
        cfg, jcfg, states = FF, J_FF, graphs[1].states
    else:
        args = (2, 1) if which == "scaled-2x1-random" else (3, 2)
        cfg, jcfg = make_scaled(*args), j_make_scaled(*args)
        cdc = j_codec(jcfg)
        rng = np.random.default_rng(11)
        states = rng.integers(0, 2**32, (3000, cdc.n_words),
                              dtype=np.uint64).astype(np.uint32)
        top = cdc.nbits - 32 * (cdc.n_words - 1)
        states[:, -1] &= np.uint32((1 << top) - 1)
    V = states.shape[0]
    g = jcap.CapturedGraph(V, 0, states, *(np.zeros(0, t) for t in (
        np.int32, np.int32, np.int32, bool)))
    want = np.stack(jcap.eval_state_masks(g, j_codec(jcfg),
                                          _ref_mask_fns(jcfg), chunk=1024))
    got = tcap.state_masks_plain(cfg, torch.from_numpy(states.view(np.int32)))
    assert np.array_equal(got.numpy().astype(bool), want)
    params = tcap.mask_params(cfg)
    assert params.shape == (host_lib.tt_mask_words(),)
    out = np.zeros(want.shape, np.uint8)
    host_lib.host_state_masks(_p(params), _p(np.ascontiguousarray(states)),
                              V, _p(out))
    assert np.array_equal(out.astype(bool), want)
    assert want.any(axis=1).all()  # every predicate holds somewhere


# ---------------------------------------------------------------------------
# K16: the survive-set fixpoint
# ---------------------------------------------------------------------------


def _zones(graph, cfg):
    m = tcap.state_masks_plain(cfg, torch.from_numpy(
        graph.states.view(np.int32))).numpy().astype(bool)
    nr = cfg.n_reconcilers
    return [m[k] for k in range(nr)] + [~m[k] & m[nr + k] for k in range(nr)]


def _host_fixpoint(lib, src, dst, in_h, term, D=1):
    alive = in_h.astype(np.uint8)
    sweeps = 0
    while True:
        out = np.zeros_like(alive)
        changed = lib.host_survive_sweep(
            _p(src), _p(dst), len(src), max(len(src) // D, 1), D, _p(alive),
            _p(term.astype(np.uint8)), len(alive), _p(out))
        alive = out
        sweeps += 1
        if not changed:
            return alive.astype(bool), sweeps


def _random_graph(seed, V=300, E=900):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    return jcap.CapturedGraph(V, 1, np.zeros((V, 1), np.uint32), src, dst,
                              np.zeros(E, np.int32), src != dst), \
        rng.random(V) < 0.7


def test_survive_sweep_kernel_equals_reference_fixpoint(graphs, host_lib):
    """K16's plain version and g++ build, swept to the fixpoint, against
    the reference's surviving_set: the alive set and the sweep count, on
    every zone of both properties on FF and on random graphs."""
    ref, port = graphs
    cases = [(ref, port, h) for h in _zones(port, FF)]
    for seed in range(4):
        g, in_h = _random_graph(seed)
        cases.append((g, g, in_h))
    for g_ref, g_port, in_h in cases:
        want, want_sweeps = jfix.surviving_set(g_ref, in_h)
        got, sweeps = tfix.surviving_set(g_port, in_h, device="cpu")
        assert np.array_equal(got, want) and sweeps == want_sweeps
        keep = g_port.changed & in_h[g_port.src] & in_h[g_port.dst]
        term = in_h & ~tfix.has_nonself(g_port)
        h_alive, h_sweeps = _host_fixpoint(
            host_lib, np.ascontiguousarray(g_port.src[keep]),
            np.ascontiguousarray(g_port.dst[keep]), in_h, term)
        assert np.array_equal(h_alive, want) and h_sweeps == want_sweeps
    assert max(jfix.surviving_set(c[0], c[2])[1] for c in cases) > 2


@pytest.mark.parametrize("D", [2, 4, 8])
def test_sharded_fixpoint_equals_reference(graphs, host_lib, D):
    """The fixpoint over D edge slices (partials summed over the shard
    axis) against the reference's psum fixpoint on a D-device mesh, and
    the g++ build of K16 over the same slices."""
    _, port = graphs
    mesh = Mesh(np.array(jax.devices()[:D]), ("fp",))
    for in_h in _zones(port, FF):
        keep = port.changed & in_h[port.src] & in_h[port.dst]
        src, dst = port.src[keep], port.dst[keep]
        term = in_h & ~tfix.has_nonself(port)
        want = jsh.sharded_survive_fixpoint(mesh, port.n_states, src, dst,
                                            in_h, term)
        got = tsh.sharded_survive_fixpoint(tsh.ShardMesh(D, "cpu"),
                                           port.n_states, src, dst, in_h,
                                           term)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        E = len(src)
        Ep = max(-(-max(E, 1) // D) * D, D)
        src_p = np.full(Ep, port.n_states, np.int32)
        dst_p = np.zeros(Ep, np.int32)
        src_p[:E], dst_p[:E] = src, dst
        h = _host_fixpoint(host_lib, src_p, dst_p, in_h, term, D)
        assert np.array_equal(h[0], want[0]) and h[1] == want[1]


# ---------------------------------------------------------------------------
# whole verdicts
# ---------------------------------------------------------------------------


def _assert_results_equal(got, want):
    assert [r.name for r in got] == [r.name for r in want]
    for a, b in zip(got, want):
        assert a.holds == b.holds
        if b.holds:
            continue
        for x, y in ((a.prefix, b.prefix), (a.cycle, b.cycle)):
            assert len(x) == len(y)
            assert all(np.array_equal(u, np.asarray(v)) for u, v in zip(x, y))
        assert a.prefix_actions == b.prefix_actions
        assert a.cycle_actions == b.cycle_actions


@pytest.mark.parametrize("shards", [1, 4])
def test_check_properties_device_equals_reference(graphs, shards):
    """Verdicts and oracle-replayed lassos under wf_next equal the
    reference's device path's, on one device and on 4 shards (both
    properties are violated on FF)."""
    ref, port = graphs
    want = jchk.check_properties_device(J_FF, PROPS, graph=ref)
    mesh = tsh.ShardMesh(shards, "cpu") if shards > 1 else None
    got = tchk.check_properties_device(FF, PROPS, graph=port, mesh=mesh,
                                       device="cpu")
    _assert_results_equal(got, want)
    assert not any(r.holds for r in got)


def test_model1_device_path_equals_reference():
    """Model_1 (163,408 states) on the device path, the plain versions on
    the CPU: verdicts and lassos, states and actions, equal the
    reference's device path's (chip_smoke.py pins their digest on the
    card)."""
    want = jchk.check_properties_device(J_M1, PROPS)
    got = tchk.check_properties_device(MODEL_1, PROPS, device="cpu")
    _assert_results_equal(got, want)
    assert [len(r.prefix) for r in got] == [10, 42]


def test_device_dispatch_rule_equals_reference():
    for args in ((10, "wf_next", False), (2_000_000, "wf_next", False),
                 (2_000_000, "wf_process", False),
                 (2_000_000, "wf_next", True)):
        assert tchk.use_device_path(*args) == jchk.use_device_path(*args)
    assert tchk.HOST_PATH_MAX == jchk.HOST_PATH_MAX
