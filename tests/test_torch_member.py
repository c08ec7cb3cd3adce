"""K9 fpset_member, fpset_insert and the host helpers of the port against
jaxtlc.engine.fpset: the plain twin and the g++ build of fpset.cuh's
fp_member_lane on tables at loads 0.5 and 0.85, with max_rounds 0 and 4,
masked-off lanes, absent keys and the raw words of the (0, 0) remap class;
the numpy host helpers and fpset_insert word for word."""

import ctypes
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxtlc.engine import fpset as J
from torchtlc.engine import fpset as T
from torchtlc.testing import one_thread

one_thread()

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torchtlc", "kernels", "csrc")
CAP = 1 << 12
N = 1536


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("member") / "libmember.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-D__host__=",
         "-D__device__=", "-I", CSRC, "-o", so,
         os.path.join(CSRC, "host_launch.cpp")],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_fpset_member.argtypes = [P, I, P, P, P, LL, LL, P]
    lib.host_fpset_member.restype = LL
    return lib


@pytest.fixture(scope="module", params=[0.5, 0.85], ids=["load50",
                                                         "load85"])
def case(request):
    """A reference table filled to `load` by seeded inserts, and N queries:
    stored fingerprints, absent random keys, the raw words whose mix is
    (0, 0) or (1, 0), about 10% masked off."""
    rng = np.random.default_rng(int(request.param * 100))
    n = int(request.param * CAP)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    fps, _ = J.fpset_insert(J.fpset_new(CAP), jnp.asarray(lo),
                            jnp.asarray(hi), jnp.ones(n, bool))
    q_lo = np.concatenate([lo[:N // 2], rng.integers(
        0, 2**32, N - N // 2, dtype=np.uint64).astype(np.uint32)])
    q_hi = np.concatenate([hi[:N // 2], rng.integers(
        0, 2**32, N - N // 2, dtype=np.uint64).astype(np.uint32)])
    r_lo, r_hi = J.unmix_host(np.array([0, 1], np.uint32),
                              np.array([0, 0], np.uint32))
    q_lo[:2], q_hi[:2] = r_lo, r_hi
    perm = rng.permutation(N)
    q_lo, q_hi = q_lo[perm], q_hi[perm]
    mask = rng.random(N) < 0.9
    return fps, q_lo, q_hi, mask


@pytest.mark.parametrize("max_rounds", [0, 4])
def test_member_plain_equals_reference(case, max_rounds):
    fps, lo, hi, mask = case
    want = np.asarray(J.fpset_member(fps, jnp.asarray(lo), jnp.asarray(hi),
                                     jnp.asarray(mask),
                                     max_rounds=max_rounds))
    table = _t(np.asarray(fps.table).view(np.int32))
    got = T.fpset_member(T.FPSet(table), _t(lo.view(np.int32)),
                         _t(hi.view(np.int32)), _t(mask), max_rounds)
    assert (got.numpy() == want).all()
    assert want.sum() > 0 and not want[~mask].any()


@pytest.mark.parametrize("max_rounds", [0, 4])
def test_member_host_build_equals_reference(host_lib, case, max_rounds):
    """The g++ build of fp_member_lane, the CUDA kernel's per-lane code;
    the rows it reads equal the plain twin's count (K9's byte bound)."""
    fps, lo, hi, mask = case
    want = np.asarray(J.fpset_member(fps, jnp.asarray(lo), jnp.asarray(hi),
                                     jnp.asarray(mask),
                                     max_rounds=max_rounds))
    table = np.ascontiguousarray(np.asarray(fps.table))
    found = np.zeros(N, np.uint8)
    m8 = mask.astype(np.uint8)
    rows = host_lib.host_fpset_member(
        table.ctypes.data, (CAP // 8).bit_length() - 1, lo.ctypes.data,
        hi.ctypes.data, m8.ctypes.data, N, max_rounds, found.ctypes.data)
    assert (found.astype(bool) == want).all()
    _, plain_rows = T.fpset_member_plain(
        _t(table.view(np.int32)), _t(lo.view(np.int32)),
        _t(hi.view(np.int32)), _t(mask), max_rounds, count_rows=True)
    assert rows == plain_rows


def test_host_helpers_equal_reference():
    rng = np.random.default_rng(3)
    lo = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for a, b in zip(T.mix_host_np(lo, hi), J.mix_host_np(lo, hi)):
        assert (a == b).all()
    for a, b in zip(T.unmix_host(lo, hi), J.unmix_host(lo, hi)):
        assert (a == b).all()
    assert (T._fmix32_np(lo) == J._fmix32_np(lo)).all()
    for x, y in zip(lo[:64].tolist(), hi[:64].tolist()):
        assert T._fmix32_host(x) == J._fmix32_host(x)
        assert T.mix_host(x, y) == J.mix_host(x, y)
        for nb in (1, 2, 512):
            assert T.bucket_of_host(y, nb) == J.bucket_of_host(y, nb)
    ml, mh = T.mix_host_np(lo, hi)
    bl, bh = T.unmix_host(ml, mh)
    assert (bl == lo).all() and (bh == hi).all()


def test_host_insert_equals_reference():
    """host_insert walks the device's slot sequence: the same table words
    and verdicts as the reference after the same seeded sequence (with
    repeats), on a table pushed to 0.9 load."""
    rng = np.random.default_rng(4)
    cap = 256
    lo = rng.integers(0, 2**32, 240, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, 240, dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, 240, 300)
    t_tab = np.zeros((cap // 8, 16), np.uint32)
    j_tab = np.zeros((cap // 8, 16), np.uint32)
    for i in idx[:int(0.9 * cap)]:
        a = T.host_insert(t_tab, int(lo[i]), int(hi[i]))
        b = J.host_insert(j_tab, int(lo[i]), int(hi[i]))
        assert a == b
    assert (t_tab == j_tab).all()


@pytest.mark.parametrize("sort_free", [False, True],
                         ids=["sorted", "sort_free"])
def test_fpset_insert_equals_reference(sort_free):
    """fpset_insert: per-lane is_new (the highest lane of a repeated
    fingerprint) and the table words, over three batches with in-batch
    and cross-batch repeats and masked-off lanes."""
    rng = np.random.default_rng(5)
    pool_lo = rng.integers(0, 2**32, 700, dtype=np.uint64).astype(np.uint32)
    pool_hi = rng.integers(0, 2**32, 700, dtype=np.uint64).astype(np.uint32)
    j_fps = J.fpset_new(1 << 11)
    t_fps = T.fpset_new(1 << 11, "cpu")
    for _ in range(3):
        pick = rng.integers(0, 700, 512)
        lo, hi = pool_lo[pick], pool_hi[pick]
        mask = rng.random(512) < 0.85
        j_fps, j_new = J.fpset_insert(j_fps, jnp.asarray(lo),
                                      jnp.asarray(hi), jnp.asarray(mask),
                                      sort_free=sort_free, probe_width=384)
        t_fps, t_new = T.fpset_insert(t_fps, _t(lo.view(np.int32)),
                                      _t(hi.view(np.int32)), _t(mask),
                                      sort_free=sort_free, probe_width=384)
        assert (t_new.numpy() == np.asarray(j_new)).all()
        assert (t_fps.table.numpy().view(np.uint32)
                == np.asarray(j_fps.table)).all()
