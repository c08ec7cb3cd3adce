"""The kernels' own logic on the CPU: g++ compiles the __host__ __device__
headers of K1 (kubeapi.cuh) and K3 (fpset.cuh) - with __host__/__device__
defined away - through host_launch.cpp into a ctypes library, which is
held against the plain torch versions the engine runs on the CPU."""

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
    lib.host_expand.argtypes = [P, P, I, I, P, P, P, P]
    lib.host_fpset_key.argtypes = [P, P, P, LL, P]
    lib.host_fpset_probe_segment.argtypes = [P, I, P, I, LL, LL, I, P]
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


def _host_expand(lib, cfg, block, n):
    lay = kernel_layout(cfg)
    ck, W = block.shape
    ncand = ck * int(lay[28])
    packed = np.zeros((ncand, W), np.int32)
    flags = np.zeros((5, ncand), np.uint8)
    action = np.zeros(ncand, np.int32)
    gen = np.zeros(22, np.uint64)
    b = np.ascontiguousarray(block.numpy())
    lib.host_expand(lay.ctypes.data, b.ctypes.data, ck, n, packed.ctypes.data,
                    flags.ctypes.data, action.ctypes.data, gen.ctypes.data)
    return packed, flags, action, gen.astype(np.int64)


def _assert_expand_equal(lib, cfg, block, n):
    got = _host_expand(lib, cfg, block, n)
    ref = expand_plain(cfg, block, n)
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
                                     R, int(nreps), s * R, C, out.ctypes.data)
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
    plain = tfs.fpset_new(cap)
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
