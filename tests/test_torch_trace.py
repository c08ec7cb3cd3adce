"""The violation path and the spill column of the port against jaxtlc:
the codec's decode (and its TLA rendering) over every FF-reachable state,
the host driver over the FF corner and a delete_noop trace, and kernel
K8's COL_SPILL - the plain ring row and the g++ build of ring.cuh - held
against the reference's pack_row / ring_update with spill_hits."""

import ctypes
import dataclasses
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxtlc.config import MATRIX as J_MATRIX
from jaxtlc.engine import hostdriver as jhd
from jaxtlc.engine import trace as jtrace
from jaxtlc.obs import counters as jc
from jaxtlc.spec import oracle
from jaxtlc.spec import pretty as jpretty
from jaxtlc.spec.codec import get_codec as j_codec
from torchtlc.config import MATRIX
from torchtlc.engine import hostdriver, trace
from torchtlc.obs import counters as tc
from torchtlc.spec import pretty
from torchtlc.spec.codec import get_codec
from torchtlc.testing import one_thread

one_thread()

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torchtlc", "kernels", "csrc")
FF = MATRIX[(False, False)]
J_FF = J_MATRIX[(False, False)]


def test_decode_every_ff_state_equals_reference():
    """decode(encode(s)) through the port's codec equals the reference's
    decode, and renders to the same TLA text, for all 8,203 states."""
    jcdc, tcdc = j_codec(J_FF), get_codec(FF)
    n = 0

    def visit(_, frontier):
        nonlocal n
        for s in frontier:
            vec = jcdc.encode(s)
            a, b = jcdc.decode(vec), tcdc.decode(vec)
            assert tuple(a) == tuple(b)
            assert (jpretty.state_to_tla(a, J_FF)
                    == pretty.state_to_tla(b, FF))
            n += 1

    oracle.bfs(J_FF, on_level=visit)
    assert n == 8203


def test_host_bfs_equals_reference():
    a = hostdriver.host_bfs(FF, chunk=256, device="cpu")
    b = jhd.host_bfs(J_FF, chunk=256)
    assert a[:7] == b[:7]
    assert a.action_generated == b.action_generated
    assert (a.generated, a.distinct, a.depth) == (17020, 8203, 109)


def test_violation_trace_equals_reference():
    cfg = dataclasses.replace(FF, mutation="delete_noop")
    jcfg = dataclasses.replace(J_FF, mutation="delete_noop")
    kind, states = trace.find_violation_trace(cfg, chunk=128, device="cpu")
    jkind, jstates = jtrace.find_violation_trace(jcfg, chunk=128)
    assert kind == jkind and kind.startswith("assert")
    assert [(tuple(s), a) for s, a in states] == [
        (tuple(s), a) for s, a in jstates]
    assert states[0][1] is None and len(states) > 1


def _ring_inputs(seed, wrap):
    rng = np.random.default_rng(seed)
    n_labels, slots = 5, 6
    ring = rng.integers(0, 2**31, (slots + 1, tc.ring_cols(n_labels)),
                        dtype=np.int64).astype(np.uint32)
    ring[:, tc.COL_OVERFLOW] = 0
    top = (1 << 32) - 3 if wrap else 1000
    acts_old = np.full(2 * (n_labels + 1), top, np.int64)
    return dict(ring=ring, head=9, bodies=40, expanded=900, n_pop=17,
                level=7, gen_old=top, gen_new=top + 9, dist_old=top,
                dist_new=top + 4, queue=33, acts_old=acts_old,
                act_gen=acts_old[:n_labels + 1] + 2,
                act_dist=acts_old[n_labels + 1:] + 1, n_labels=n_labels,
                spill_old=top, spill_new=top + 5)


def _reference_row(d, flip):
    """The reference's commit-side ring update with spill (jaxtlc/engine/
    bfs.py:625-656)."""
    u = jnp.uint32
    n = d["n_labels"]
    m = lambda v: u(v & 0xFFFFFFFF)  # noqa: E731
    a = lambda v: jnp.asarray(np.asarray(v) & 0xFFFFFFFF, u)  # noqa: E731
    b_old, e_old = m(d["bodies"]), m(d["expanded"])
    b_new, e_new = b_old + u(1), e_old + u(d["n_pop"])
    old = d["acts_old"]
    pairs = [(m(d["gen_new"]), m(d["gen_old"])),
             (m(d["dist_new"]), m(d["dist_old"])),
             (a(d["act_gen"]), a(old[:n + 1])),
             (a(d["act_dist"]), a(old[n + 1:])), (b_new, b_old),
             (e_new, e_old), (m(d["spill_new"]), m(d["spill_old"]))]
    row = jc.pack_row(
        jnp.int32(d["level"]), m(d["gen_new"]), m(d["dist_new"]),
        jnp.int32(d["queue"]), b_new, e_new, a(d["act_gen"])[:n],
        a(d["act_dist"])[:n],
        overflow=jc.sticky_overflow(jnp.asarray(d["ring"]),
                                    jc.wrapped_any(pairs)),
        spill=m(d["spill_new"]))
    ring, head = jc.ring_update(jnp.asarray(d["ring"]), jnp.int32(d["head"]),
                                row, jnp.bool_(flip))
    return np.asarray(ring), int(head)


@pytest.mark.parametrize("wrap", [False, True], ids=["plain", "wrap"])
@pytest.mark.parametrize("flip", [True, False], ids=["flip", "dump"])
def test_ring_spill_column_equals_reference(wrap, flip):
    d = _ring_inputs(11, wrap)
    want_ring, want_head = _reference_row(d, flip)
    i64 = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    ring = torch.from_numpy(d["ring"].view(np.int32).copy())
    head, bodies, expanded = i64(d["head"]), i64(d["bodies"]), i64(
        d["expanded"])
    tc.ring_row_plain(
        ring, head, bodies, expanded, d["n_pop"], flip, i64(d["level"]),
        i64(d["gen_new"]), i64(d["gen_old"]), i64(d["dist_new"]),
        i64(d["dist_old"]), i64(d["queue"]), torch.from_numpy(d["act_gen"]),
        torch.from_numpy(d["act_dist"]), torch.from_numpy(d["acts_old"]),
        d["n_labels"], i64(d["spill_new"]), i64(d["spill_old"]))
    assert np.array_equal(ring.numpy().view(np.uint32), want_ring)
    assert int(head) == want_head
    row = want_ring[d["head"] % 6 if flip else 6]
    assert row[tc.COL_SPILL] == d["spill_new"] & 0xFFFFFFFF
    assert row[tc.COL_OVERFLOW] == int(wrap)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("ring") / "libring.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-D__host__=",
         "-D__device__=", "-I", CSRC, "-o", so,
         os.path.join(CSRC, "host_launch.cpp")],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.host_ring_row.argtypes = [P, I, I, P, P, P, LL, I, LL, LL, LL, LL, LL,
                                  LL, P, P, P, P, P, I, I, P, P, I]
    return lib


@pytest.mark.parametrize("wrap", [False, True], ids=["plain", "wrap"])
def test_ring_spill_host_build_equals_reference(host_lib, wrap):
    """ring.cuh's row with COL_SPILL, built by g++ (the code nvcc builds
    kernel K8 from)."""
    d = _ring_inputs(12, wrap)
    want_ring, want_head = _reference_row(d, True)
    ring = d["ring"].copy()
    head = ctypes.c_longlong(d["head"])
    bodies = ctypes.c_longlong(d["bodies"])
    expanded = ctypes.c_longlong(d["expanded"])
    ag, ad, ao = (np.ascontiguousarray(d[k], np.int64)
                  for k in ("act_gen", "act_dist", "acts_old"))
    spill_new = ctypes.c_longlong(d["spill_new"])
    spill_old = ctypes.c_longlong(d["spill_old"])
    host_lib.host_ring_row(
        ring.ctypes.data, 6, ring.shape[1], ctypes.byref(head),
        ctypes.byref(bodies), ctypes.byref(expanded), d["n_pop"], 1,
        d["level"], d["gen_new"], d["gen_old"], d["dist_new"],
        d["dist_old"], d["queue"], ag.ctypes.data, ad.ctypes.data,
        ao.ctypes.data, ctypes.byref(spill_new), ctypes.byref(spill_old),
        d["n_labels"] + 1, d["n_labels"], None, None, 0)
    assert np.array_equal(ring, want_ring) and head.value == want_head
