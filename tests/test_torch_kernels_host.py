"""The kernels' own logic on the CPU: g++ compiles the __host__ __device__
headers of K1 (kubeapi.cuh), K3 (fpset.cuh), K5/K6 (slab.cuh), K7
(deferred.cuh) and K8 (ring.cuh) - with __host__/__device__ defined away -
through host_launch.cpp into a ctypes library, which is held against the
plain torch versions the engine runs on the CPU."""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.spec import oracle
from jaxtlc.spec.codec import get_codec as j_get_codec
from torchtlc.config import MODEL_1, ModelConfig, make_scaled
from torchtlc.engine import fpset as tfs
from torchtlc.engine.backend import expand_plain, kernel_layout
from torchtlc.spec.codec import get_codec

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torchtlc", "kernels", "csrc")
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("host_kernels") / "libhost.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-D__host__=",
         "-D__device__=", "-I", CSRC, "-o", so,
         os.path.join(CSRC, "host_launch.cpp")],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.host_expand.argtypes = [P, P, I, I, I, P, P, P, P]
    lib.host_fpset_key.argtypes = [P, P, P, LL, P]
    lib.host_fpset_probe_segment.argtypes = [P, I, P, I, LL, LL, P, I, P]
    lib.host_slab_dedup.argtypes = [P, LL, I, I, I, P, P]
    lib.host_slab_dedup.restype = LL
    lib.host_deferred_check.argtypes = [P, P, LL, P, P, P, P, P, P]
    lib.host_ring_row.argtypes = [P, I, I, P, P, P, LL, I, LL, LL, LL, LL, LL,
                                  LL, P, P, P, P, P, I, I, P, P, I]
    return lib


@pytest.fixture(scope="module")
def ff_blocks():
    """Every FF-reachable state, packed by the reference codec."""
    jcfg = JConfig(False, False)
    cdc = j_get_codec(jcfg)
    states = []
    oracle.bfs(jcfg, on_level=lambda d, f: states.extend(
        cdc.encode(s) for s in f))
    return get_codec(ModelConfig(False, False)).pack(
        torch.from_numpy(np.stack(states)))


def _host_expand(lib, cfg, block, n, deferred=False):
    lay = kernel_layout(cfg)
    ck, W = block.shape
    ncand = ck * int(lay[28])
    packed = np.zeros((ncand, W), np.int32)
    flags = np.zeros((5, ncand), np.uint8)
    action = np.zeros(ncand, np.int32)
    gen = np.zeros(22, np.uint64)
    b = np.ascontiguousarray(block.numpy())
    lib.host_expand(lay.ctypes.data, b.ctypes.data, ck, n, int(deferred),
                    packed.ctypes.data, flags.ctypes.data, action.ctypes.data,
                    gen.ctypes.data)
    return packed, flags, action, gen.astype(np.int64)


def _assert_expand_equal(lib, cfg, block, n, deferred=False):
    got = _host_expand(lib, cfg, block, n, deferred)
    ref = expand_plain(cfg, block, n, deferred)
    for name, a, b in zip(("packed", "flags", "action", "gen"), got, ref):
        assert (a == b.numpy()).all(), name
    return got


def test_layout_struct_size(host_lib):
    assert host_lib.tt_layout_words() == kernel_layout(MODEL_1).shape[0]


@pytest.mark.parametrize("mutation", ["", "delete_noop", "sticky_reconcile"])
def test_expand_header_on_ff_states(host_lib, ff_blocks, mutation):
    """All FF-reachable states as one block, the last rows outside the pop
    mask; the mutation configs flag the same lanes."""
    cfg = ModelConfig(False, False, mutation=mutation)
    n = ff_blocks.shape[0]
    _assert_expand_equal(host_lib, cfg, ff_blocks, n - 5)
    if not mutation:  # every transition of the FF state graph, Init excluded
        _, flags, _, gen = _assert_expand_equal(host_lib, cfg, ff_blocks, n)
        assert flags[0].sum() == gen.sum() == 17020 - 2


def test_expand_header_on_model1_and_scaled_words(host_lib):
    """Seeded random packed words: every handler, fault lane, garbage
    word and (scaled 2x1) two-slot list group."""
    rng = np.random.default_rng(21)
    for cfg in (MODEL_1, make_scaled(2, 1, False, False), make_scaled(2, 1)):
        cdc = get_codec(cfg)
        fields = np.stack([rng.integers(0, 1 << w, 3000)
                           for w in cdc.lane_widths], 1).astype(np.int32)
        block = cdc.pack(torch.from_numpy(fields))
        _assert_expand_equal(host_lib, cfg, block, 2990)


def _host_insert(lib, table, lo, hi, mask, R=0, C=0):
    n = len(lo)
    R = min(R or n, n)
    C = min(C or R, R)
    key = np.zeros(n, np.int64)
    m = mask.astype(np.uint8)
    lib.host_fpset_key(lo.ctypes.data, hi.ctypes.data, m.ctypes.data, n,
                       key.ctypes.data)
    ref_key = tfs.fpset_key_plain(torch.from_numpy(lo.view(np.int32)),
                                  torch.from_numpy(hi.view(np.int32)),
                                  torch.from_numpy(mask))
    assert (key == ref_key.numpy()).all()
    c_key, c_idx, nreps = tfs.dedup_compact(torch.from_numpy(key))
    nseg = -(-n // R)
    keys = np.full(nseg * R, tfs.KEY00, np.int64)
    keys[:n] = c_key.numpy()
    is_new = np.zeros(nseg * R, np.uint8)
    lognb = table.shape[0].bit_length() - 1
    for s in range(nseg):
        seg = np.ascontiguousarray(keys[s * R:(s + 1) * R])
        out = np.zeros(R, np.uint8)
        lib.host_fpset_probe_segment(table.ctypes.data, lognb, seg.ctypes.data,
                                     R, int(nreps), s * R, None, C,
                                     out.ctypes.data)
        is_new[s * R:(s + 1) * R] = out
    return is_new[:n].astype(bool), c_idx.numpy(), int(nreps)


@pytest.mark.parametrize("cap,rounds,n,n_values,R,C", [
    (1 << 10, 3, 300, 200, 0, 0),  # duplicates in a small table
    (1 << 12, 2, 1400, None, 0, 0),  # 0.68 load
    (1 << 12, 3, 1000, 800, 256, 128),  # segment loop, narrow claims
    (1 << 14, 2, 6000, 4000, 0, 64),  # > 2048 stragglers: 3 walk slices
    (1 << 16, 2, 27000, None, 0, 0),  # wide batch past 0.8 load
], ids=["dups", "load068", "segments", "stragglers", "wide"])
def test_fpset_header_equals_plain(host_lib, cap, rounds, n, n_values, R, C):
    rng = np.random.default_rng(cap + n)
    host = np.zeros((cap // 8, 16), np.uint32)
    plain = tfs.fpset_new(cap, "cpu")
    for _ in range(rounds):
        lo = rng.integers(0, 2**32, n_values or n, dtype=np.uint64)
        hi = rng.integers(0, 2**32, n_values or n, dtype=np.uint64)
        lo, hi = lo.astype(np.uint32), hi.astype(np.uint32)
        if n_values:
            pick = rng.integers(0, n_values, n)
            lo, hi = lo[pick], hi[pick]
        mask = rng.random(n) >= 0.05
        got = _host_insert(host_lib, host, lo, hi, mask, R, C)
        _, is_new, c_idx, nreps = tfs.fpset_insert_sorted(
            plain, torch.from_numpy(lo.view(np.int32)),
            torch.from_numpy(hi.view(np.int32)), torch.from_numpy(mask),
            probe_width=R, claim_width=C)
        assert got[2] == int(nreps)
        assert (got[0] == is_new.numpy()).all()
        assert (got[1] == c_idx.numpy()).all()
        assert (host == plain.table.numpy().view(np.uint32)).all()


def test_expand_header_deferred_variant(host_lib, ff_blocks):
    """The kDeferred instantiation: no invariant flags, the rest equal."""
    n = ff_blocks.shape[0]
    got = _assert_expand_equal(host_lib, FF_CFG, ff_blocks, n - 3, True)
    assert got[1][3:].sum() == 0
    imm = _host_expand(host_lib, FF_CFG, ff_blocks, n - 3)
    for a, b in zip(got[:1] + got[2:], imm[:1] + imm[2:]):
        assert (a == b).all()
    assert (got[1][:3] == imm[1][:3]).all()


FF_CFG = ModelConfig(False, False)


@pytest.mark.parametrize("bits,passes,n,R,dup", [
    (3, 1, 400, 400, 150), (0, 1, 3000, 1200, 900), (0, 2, 3000, 1200, 900),
    (5, 2, 700, 700, 300), (0, 1, 2000, 256, 2000),
], ids=["bits3", "default", "two_passes", "bits5_two_passes", "fallback"])
def test_slab_header_equals_plain(host_lib, bits, passes, n, R, dup):
    """K5 + K6 per-lane logic (slab cell, winner resolve, ordering key,
    last-of-group mark) against _slab_dedup_core + _order_and_dedup; then
    the masked round 0 of K3 against the plain probe, table words too."""
    rng = np.random.default_rng(bits * 10 + passes + n)
    vals = rng.integers(0, 2**32, (dup, 2), dtype=np.uint64).astype(np.uint32)
    pick = rng.integers(0, dup, n)
    lo, hi = vals[pick, 0], vals[pick, 1]
    mask = rng.random(n) >= 0.1
    key = tfs.fpset_key_plain(torch.from_numpy(lo.view(np.int32)),
                              torch.from_numpy(hi.view(np.int32)),
                              torch.from_numpy(mask))
    c_idx = np.zeros(R, np.int64)
    active = np.zeros(R, np.uint8)
    k = np.ascontiguousarray(key.numpy())
    n_cand = host_lib.host_slab_dedup(k.ctypes.data, n,
                                      tfs.slab_log2_cells(n, 4, bits), passes,
                                      R, c_idx.ctypes.data, active.ctypes.data)
    c_lane, p_cand = tfs._slab_dedup_core(key, R, 4, passes, bits)
    assert n_cand == int(p_cand)
    assert (n_cand > R) == (dup == n)  # only the fallback case overflows R
    s_key, p_idx, p_active = tfs._order_and_dedup(key, c_lane, p_cand, R)
    assert (c_idx == p_idx.numpy()).all()
    assert (active == p_active.numpy()).all()
    cap = 1 << 12
    host = np.zeros((cap // 8, 16), np.uint32)
    plain = tfs.fpset_new(cap, "cpu")
    is_new = np.zeros(R, np.uint8)
    sk = np.ascontiguousarray(s_key.numpy())
    host_lib.host_fpset_probe_segment(host.ctypes.data, (cap // 8).bit_length()
                                      - 1, sk.ctypes.data, R, 0, 0,
                                      active.ctypes.data, R, is_new.ctypes.data)
    ref_new = tfs.probe_segment_plain(plain.table, s_key, p_active.bool(), R)
    assert (is_new == ref_new.numpy()).all()
    assert (host == plain.table.numpy().view(np.uint32)).all()


def _doctored_block(seed, ck=40):
    """FF states, every third with Secret foo twice in its apiState."""
    from torchtlc.engine.backend import expand_plain as ep

    jcfg = JConfig(False, False)
    jcdc = j_get_codec(jcfg)
    states = []
    oracle.bfs(jcfg, on_level=lambda d, f: states.extend(f))
    rng = np.random.default_rng(seed)
    rows = []
    for k, i in enumerate(rng.choice(len(states), ck, replace=False)):
        s = states[i]
        if k % 3 == 0:
            s = s._replace(api_state=frozenset([
                oracle.rec(k="Secret", n="foo", vv=frozenset()),
                oracle.rec(k="Secret", n="foo", vv=frozenset(["Client"]))]))
        rows.append(jcdc.encode(s))
    block = get_codec(FF_CFG).pack(torch.from_numpy(np.stack(rows)))
    _, flags, action, _ = ep(FF_CFG, block, ck, deferred=True)
    return block, action, flags[0].bool()


@pytest.mark.parametrize("seed,fresh_frac", [(1, 0.5), (2, 1.0), (3, 0.0)])
def test_deferred_header_equals_plain(host_lib, seed, fresh_frac):
    from torchtlc.engine.backend import deferred_check_plain

    block, action, valid = _doctored_block(seed)
    n = valid.shape[0]
    rng = np.random.default_rng(seed)
    lanes = np.flatnonzero(valid.numpy())
    c_idx = np.full(n, n, np.int64)
    c_idx[:len(lanes)] = lanes
    fresh = np.zeros(n, np.uint8)
    fresh[:len(lanes)] = rng.random(len(lanes)) < fresh_frac
    viol = np.zeros(1, np.int64)
    vaction = np.zeros(1, np.int64)
    state = np.zeros(get_codec(FF_CFG).n_fields, np.int32)
    b = np.ascontiguousarray(block.numpy())
    act = np.ascontiguousarray(action.numpy())
    host_lib.host_deferred_check(
        kernel_layout(FF_CFG).ctypes.data, b.ctypes.data, n,
        fresh.ctypes.data, c_idx.ctypes.data, act.ctypes.data,
        viol.ctypes.data, state.ctypes.data, vaction.ctypes.data)
    p_viol, p_state, p_action = deferred_check_plain(
        FF_CFG, block, torch.from_numpy(fresh.astype(bool)),
        torch.from_numpy(c_idx), action, n)
    assert int(viol[0]) == int(p_viol)
    assert (state == p_state.numpy()).all()
    assert int(vaction[0]) == int(p_action)
    assert (int(viol[0]) != 0) == (fresh_frac > 0)


@pytest.mark.parametrize("near_wrap,flip", [(False, True), (True, False),
                                            (True, True)])
def test_ring_header_equals_plain(host_lib, near_wrap, flip):
    from torchtlc.obs import counters as tcnt

    rng = np.random.default_rng(int(near_wrap) * 2 + int(flip))
    n_labels, slots = 22, 6
    cols = tcnt.ring_cols(n_labels)
    ring0 = rng.integers(-2**31, 2**31, (slots + 1, cols)).astype(np.int32)
    ring0[:, tcnt.COL_OVERFLOW] = 0
    base = (1 << 32) - 30 if near_wrap else 500
    old = rng.integers(base, base + 20, 2 * (n_labels + 1))
    new = old + rng.integers(0, 40, old.shape)
    g_old, d_old = int(old[0]), int(old[1])
    g_new, d_new = g_old + 17, d_old + 35
    host = ring0.copy()
    hb = np.array([11, 3, 7000], np.int64)  # head, bodies, expanded
    a_gen = np.ascontiguousarray(new[:n_labels + 1])
    a_dist = np.ascontiguousarray(new[n_labels + 1:])
    host_lib.host_ring_row(host.ctypes.data, slots, cols, hb.ctypes.data,
                           hb[1:].ctypes.data, hb[2:].ctypes.data, 64,
                           int(flip), 12, g_new, g_old, d_new, d_old, 321,
                           a_gen.ctypes.data, a_dist.ctypes.data,
                           old.ctypes.data, None, None, n_labels + 1,
                           n_labels, None, None, 0)
    ring = torch.from_numpy(ring0.copy())
    head, bodies, expanded = (torch.tensor(v) for v in (11, 3, 7000))
    t = torch.tensor
    tcnt.ring_row_plain(ring, head, bodies, expanded, 64, flip, t(12),
                        t(g_new), t(g_old), t(d_new), t(d_old), t(321),
                        torch.from_numpy(a_gen), torch.from_numpy(a_dist),
                        torch.from_numpy(old), n_labels)
    assert (host == ring.numpy()).all()
    assert hb.tolist() == [int(head), int(bodies), int(expanded)]
