"""The port's sharded engine (torchtlc.engine.sharded, D shards in one
process) against jaxtlc.engine.sharded on the CPU (8 virtual devices).

Inputs are the FF corner's reachable states, reached by both engines from
the same Init, plus seeded numpy draws.  Every comparison is exact (the
tolerance is zero): the route (K11), verdict-fold (K12) and enqueue (K13)
kernels - their plain versions and the g++ build of their
__host__ __device__ header - against the words the reference's
expand_half and commit_half compute at D in {1, 2, 4, 8} and with a bucket
width small enough to overflow; K1's sharded variant and K7's
received-rows variant likewise; whole carries (tables, queues with their
dump rows, counters, rings, coverage, the pipelined pv_* leaves) after
full runs in each mode; checkpoints across the two packages;
migrate_shard_carry; and the `-sharded` command's transcript and
journal."""

import contextlib
import ctypes
import dataclasses
import hashlib
import io
import json
import os
import re
import subprocess

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from jaxtlc.cli import main as j_main
from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.engine import checkpoint as jck
from jaxtlc.engine import sharded as js
from jaxtlc.engine.backend import kubeapi_backend as j_backend
from jaxtlc.engine.backend import make_deferred_checker as j_checker
from jaxtlc.resil import regrow as jr
from torchtlc.cli import main as t_main
from torchtlc.config import ModelConfig
from torchtlc.engine import checkpoint as tck
from torchtlc.engine import sharded as ts
from torchtlc.engine.backend import kernel_layout
from torchtlc.engine.backend import kubeapi_backend as t_backend
from torchtlc.engine.fingerprint import fp64_words
from torchtlc.engine.fpset import FPSet, fpset_insert_dedup
from torchtlc.engine.interop import (
    SHARD_LEAF_ORDER,
    shard_carry_from_numpy,
    shard_carry_to_numpy,
)
from torchtlc.resil import regrow as tr
from torchtlc.testing import one_thread

one_thread()

FF, J_FF = ModelConfig(False, False), JConfig(False, False)
KW = dict(chunk=64, queue_capacity=1 << 11, fp_capacity=1 << 14)
FF_COUNTS = (17020, 8203, 109)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torchtlc", "kernels", "csrc")
PTR, INT, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("fp",))


def _ref_leaves(jc) -> dict:
    return {f: np.asarray(getattr(jc, f)) for f in SHARD_LEAF_ORDER
            if getattr(jc, f, None) is not None}


def _assert_carries_equal(port_carry, jc, where=""):
    """Every leaf of the reference carry, word for word (exact)."""
    mine, ref = shard_carry_to_numpy(port_carry), _ref_leaves(jc)
    assert set(mine) == set(ref), (where, set(mine) ^ set(ref))
    for name, want in ref.items():
        assert mine[name].dtype == want.dtype, (where, name)
        assert mine[name].shape == want.shape, (where, name)
        assert np.array_equal(mine[name], want), (where, name)


def _engines(D, segment=0, cfgs=(FF, J_FF), coverage=False, **kw):
    kw = dict(KW, **kw)
    tcfg, jcfg = cfgs
    j = js.make_sharded_engine(jcfg, _mesh(D), segment=segment,
                               backend=j_backend(jcfg, coverage=coverage),
                               **kw)
    t = ts.make_sharded_engine(tcfg, ts.ShardMesh(D, "cpu"), segment=segment,
                               backend=t_backend(tcfg, coverage=coverage),
                               **kw)
    return j, t


# ---------------------------------------------------------------------------
# the kernels against the reference's expand_half / commit_half words
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("host_route") / "libhost.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-D__host__=",
         "-D__device__=", "-I", CSRC, "-o", so,
         os.path.join(CSRC, "host_launch.cpp")],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.host_expand_sharded.argtypes = [PTR, PTR, LL, INT, PTR, PTR, INT, INT,
                                        INT, PTR, PTR, PTR, PTR, PTR, PTR]
    lib.host_route_scatter.argtypes = [PTR, PTR, PTR, PTR, LL, INT, INT, INT,
                                       PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                                       PTR]
    lib.host_verdict_fold.argtypes = [PTR, PTR, PTR, PTR, PTR, PTR, PTR, LL,
                                      INT, INT, INT, INT, INT, PTR, PTR]
    lib.host_shard_enqueue.argtypes = [PTR, LL, INT, PTR, PTR, PTR, PTR, PTR,
                                       PTR, LL, INT, INT]
    lib.host_deferred_check_rows.argtypes = [PTR, PTR, LL, PTR, PTR, PTR,
                                             PTR]
    return lib


def _p(a: np.ndarray):
    return a.ctypes.data


def _n(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy())


def _host_expand(lib, cfg, queue, qhead, npop, ck, deferred):
    lay = kernel_layout(cfg)
    L, F, W = int(lay[28]), int(lay[24]), int(lay[25])
    D, qrows, _ = queue.shape
    ncand = D * ck * L
    out = dict(packed=np.zeros((ncand, W), np.int32),
               flags=np.zeros((5, ncand), np.uint8),
               action=np.zeros(ncand, np.int32),
               fields=np.zeros((ncand, F), np.int32),
               block=np.zeros((D * ck, W), np.int32),
               gen=np.zeros((D, 22), np.uint64))
    q, qh, nn = _n(queue), _n(qhead), _n(npop)
    lib.host_expand_sharded(_p(lay), _p(q), qrows, qrows - 1, _p(qh), _p(nn),
                            D, ck, int(deferred), _p(out["packed"]),
                            _p(out["flags"]), _p(out["action"]),
                            _p(out["fields"]), _p(out["block"]),
                            _p(out["gen"]))
    out["gen"] = out["gen"].astype(np.int64)
    return out


def _host_route(lib, hi, lo, valid, fields, D, B):
    N, F = fields.shape
    ncand = N // D
    o = dict(order=np.zeros((D, ncand), np.int32),
             s_own=np.zeros((D, ncand), np.int32),
             s_pos=np.zeros((D, ncand), np.int32),
             s_valid=np.zeros((D, ncand), np.uint8),
             xrows=np.zeros((D, D, B, F), np.int32),
             xlo=np.zeros((D, D, B), np.int32),
             xhi=np.zeros((D, D, B), np.int32),
             xvalid=np.zeros((D, D, B), np.uint8),
             route_ovf=np.zeros(D, np.uint8))
    lib.host_route_scatter(_p(hi), _p(lo), _p(valid), _p(fields), ncand, D,
                           B, F, *(_p(o[k]) for k in (
                               "order", "s_own", "s_pos", "s_valid", "xrows",
                               "xlo", "xhi", "xvalid", "route_ovf")))
    return o


def _ref_halves(D, steps, route_factor=2.0, deferred=False):
    """The reference's carry after `steps` bodies, its expand_half words and
    its carry after one more commit_half (jitted shard_map halves, as the
    reference's ShardedSpillRuntime runs them)."""
    kw = dict(KW, route_factor=route_factor, sort_free=deferred,
              deferred=deferred)
    mesh = _mesh(D)
    parts = {}
    init_fn, _ = js.make_sharded_engine(J_FF, mesh, backend=j_backend(J_FF),
                                        _parts=parts, **kw)
    _, seg = js.make_sharded_engine(J_FF, mesh, backend=j_backend(J_FF),
                                    segment=steps, **kw)
    c = jax.block_until_ready(seg(init_fn())) if steps else init_fn()
    specs, axis = parts["specs"], parts["axis"]
    ex_specs = js.ShardEx(*(P(axis) for _ in js.ShardEx._fields))
    expand = jax.jit(js.shard_map(
        lambda cc: jax.tree.map(lambda x: x[None], parts["expand_half"](cc)),
        mesh=mesh, in_specs=(specs,), out_specs=ex_specs, check_vma=False))
    commit = jax.jit(js.shard_map(
        lambda cc, ex: parts["commit_half"](
            cc, jax.tree.map(lambda x: x[0], ex)),
        mesh=mesh, in_specs=(specs, ex_specs), out_specs=specs,
        check_vma=False))
    ex = jax.block_until_ready(expand(c))
    return c, ex, jax.block_until_ready(commit(c, ex)), parts["B"]


@pytest.mark.parametrize("D,steps,rf", [(1, 30, 2.0), (2, 30, 2.0),
                                        (4, 30, 2.0), (8, 30, 2.0),
                                        (4, 35, 0.3)],
                         ids=["D1", "D2", "D4", "D8", "D4-overflow"])
def test_route_fold_enqueue_equal_reference_words(host_lib, D, steps, rf):
    """K1's sharded variant, K11, K12 and K13 - plain and g++ - on the
    reference's carry after `steps` bodies reproduce its expand_half words
    (lane fields, flags, actions, owner order, bucket positions, received
    rows; empty slots are zeros in the reference and invalid here) and its
    commit_half queue (dump row included), outdegree and act_dist.
    route_factor 0.3 makes B small enough to overflow."""
    jc, ex, jnext, B = _ref_halves(D, steps, rf)
    c = shard_carry_from_numpy(jc, "cpu")
    chunk, L = KW["chunk"], t_backend(FF).n_lanes
    ncand = chunk * L
    h = ts.read_bundle(c)
    n = [min(chunk, min(e, t) - q) if h.viol == 0 else 0
         for q, t, e in zip(h.qhead, h.qtail, h.level_end)]
    assert n == np.asarray(ex.n).tolist() and sum(n) > 0
    npop = torch.tensor(n, dtype=torch.int64)
    packed, flags, action, gen, fields, block = ts.expand_sharded_plain(
        FF, c.queue, c.qhead, npop, chunk, False, True)
    host = _host_expand(host_lib, FF, c.queue, c.qhead, npop, chunk, False)
    for k, v in dict(packed=packed, flags=flags, action=action, gen=gen,
                     fields=fields, block=block).items():
        assert np.array_equal(host[k], v.numpy()), k
    fvalid = np.asarray(ex.fvalid).reshape(-1)
    assert np.array_equal(fields.numpy(),
                          np.asarray(ex.flat).reshape(fields.shape))
    assert np.array_equal(flags[0].numpy().astype(bool), fvalid)
    assert np.array_equal(flags[1].numpy().astype(bool),
                          np.asarray(ex.afail).reshape(-1))
    assert np.array_equal(action.numpy(), np.asarray(ex.faction).reshape(-1))

    lo, hi = fp64_words(packed, t_backend(FF).cdc.nbits)
    rt = ts.route_out_new(D, ncand, B, fields.shape[1], "cpu")
    ts.route_plain(hi, lo, flags[0], fields, D, B, rt)
    hr = _host_route(host_lib, _n(hi), _n(lo), _n(flags[0]), _n(fields), D,
                     B)
    for k in ("order", "s_own", "s_pos", "s_valid", "xvalid", "route_ovf"):
        assert np.array_equal(hr[k].astype(getattr(rt, k).numpy().dtype),
                              getattr(rt, k).numpy()), k
    xv = rt.xvalid.numpy()
    for k in ("xrows", "xlo", "xhi"):
        assert np.array_equal(hr[k][xv], getattr(rt, k).numpy()[xv]), k
    for k in ("order", "s_own", "s_pos", "s_valid"):
        assert np.array_equal(getattr(rt, k).numpy(),
                              np.asarray(getattr(ex, k)).reshape(D, ncand)), k
    assert np.array_equal(rt.route_ovf.numpy(), np.asarray(ex.route_ovf))
    assert rt.route_ovf.any().item() == (rf < 1)
    r_valid = np.asarray(ex.r_valid).reshape(D, D, B)
    assert np.array_equal(xv, r_valid)
    r_flat = np.asarray(ex.r_flat).reshape(D, D, B, -1)
    assert np.array_equal(rt.xrows.numpy()[xv], r_flat[xv])
    assert not r_flat[~xv].any()  # the reference's empty slots are zeros
    assert np.array_equal(rt.xlo.numpy()[xv].view(np.uint32),
                          np.asarray(ex.r_lo).reshape(D, D, B)[xv])
    assert np.array_equal(rt.xhi.numpy()[xv].view(np.uint32),
                          np.asarray(ex.r_hi).reshape(D, D, B)[xv])

    # the owner insert, then K13 and K12 against commit_half's carry
    DB = D * B
    is_new = torch.zeros(D, DB + 1, dtype=torch.bool)
    for o in range(D):
        _, is_new_c, c_idx, _, _ = fpset_insert_dedup(
            FPSet(c.table[o]), rt.xlo[o].reshape(DB), rt.xhi[o].reshape(DB),
            rt.xvalid[o].reshape(DB))
        is_new[o, c_idx] = is_new_c
    is_new = is_new[:, :DB].contiguous()
    cum = torch.cumsum(is_new, 1)
    q_full = (c.qtail - c.qhead) + cum[:, -1] > KW["queue_capacity"]
    hq = _n(c.queue).copy()
    ts.shard_enqueue_plain(c.queue, is_new, cum, c.qtail, q_full,
                           rt.xrows.view(D, DB, -1), rt.xvalid.view(D, DB))
    host_lib.host_shard_enqueue(
        _p(hq), hq.shape[1], hq.shape[1] - 1, _p(_n(is_new)), _p(_n(cum)),
        _p(_n(c.qtail)), _p(_n(q_full)), _p(_n(rt.xrows)),
        _p(_n(rt.xvalid)), DB, D, hq.shape[2])
    assert np.array_equal(hq, c.queue.numpy())
    assert np.array_equal(c.queue.numpy(), np.asarray(jnext.queue))
    verd = is_new.view(D, D, B).to(torch.uint8)
    od, ad = c.outdeg_hist.clone(), c.act_dist.clone()
    ts.verdict_fold_plain(verd, rt.s_own, rt.s_pos, rt.s_valid, rt.order,
                          action.view(D, ncand), npop, chunk, L, 22, od, ad)
    hod, had = _n(c.outdeg_hist).copy(), _n(c.act_dist).copy()
    host_lib.host_verdict_fold(
        _p(_n(verd)), _p(_n(rt.s_own)), _p(_n(rt.s_pos)),
        _p(_n(rt.s_valid)), _p(_n(rt.order)), _p(_n(action)), _p(_n(npop)),
        ncand, D, B, chunk, L, 22, _p(hod), _p(had))
    assert np.array_equal(hod, od.numpy()) and np.array_equal(had, ad.numpy())
    assert np.array_equal(od.numpy(), np.asarray(jnext.outdeg_hist))
    assert np.array_equal(ad.numpy(), np.asarray(jnext.act_dist))


def test_deferred_rows_kernel_equals_reference_checker(host_lib):
    """K7's received-rows variant (plain and g++) against the reference's
    make_deferred_checker over received rows, on seeded rows of reachable
    FF states, a fifth of them doctored to hold two versions of identity 0
    (OnlyOneVersion fails) and a few with a bad verb (TypeOK fails)."""
    from jaxtlc.spec import oracle
    from jaxtlc.spec.codec import get_codec

    cdc = get_codec(J_FF)
    states = []
    oracle.bfs(J_FF, on_level=lambda d, f: states.extend(
        cdc.encode(s) for s in f))
    rng = np.random.default_rng(20261017)
    n = 512
    rows = np.stack(states)[rng.integers(0, len(states), n)].astype(np.int32)
    api = cdc.offsets["api"]
    word = (1 << cdc.o_present) | (0 << cdc.o_ident)
    doct = rng.random(n) < 0.2
    rows[doct, api] = word | (1 << cdc.o_vv)
    rows[doct, api + 1] = word
    fresh = rng.random(n) < 0.6
    c_idx = rng.permutation(n).astype(np.int64)
    jcheck = j_checker(j_backend(J_FF), n, probe_width=0, with_cert=False)
    jv, jst, _, _ = jcheck(jax.numpy.asarray(rows), None,
                           jax.numpy.asarray(fresh),
                           jax.numpy.asarray(c_idx.astype(np.int32)), n)
    tv, tst = ts.deferred_check_rows_plain(
        FF, torch.from_numpy(rows), torch.from_numpy(fresh),
        torch.from_numpy(c_idx), n)
    hv = np.zeros(1, np.int64)
    hst = np.zeros(rows.shape[1], np.int32)
    host_lib.host_deferred_check_rows(
        _p(kernel_layout(FF)), _p(rows), n, _p(fresh.astype(np.uint8)),
        _p(c_idx), _p(hv), _p(hst))
    assert int(jv) == int(tv) == int(hv[0]) == 2
    assert np.array_equal(np.asarray(jst), tst.numpy())
    assert np.array_equal(hst, tst.numpy())


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 8])
def test_ff_run_equals_reference_carry(n):
    """The FF corner at n shards (sorted, immediate invariants): every
    carry leaf equal to the reference's check_sharded carry; the counts are
    the oracle's."""
    (j_init, j_run), (t_init, t_run) = _engines(n, chunk=128,
                                                queue_capacity=1 << 12)
    jc = jax.block_until_ready(j_run(j_init()))
    tc = t_run(t_init())
    _assert_carries_equal(tc, jc)
    r = ts.result_from_shard_carry(tc, 0.0)
    assert (r.generated, r.distinct, r.depth) == FF_COUNTS
    assert r.violation == 0 and r.queue_left == 0


def test_slab_deferred_ring_coverage_run_equals_reference():
    """4 shards in the production modes at a small chunk (slab dedup and
    owner-side deferred invariants forced on), with the counter ring and
    the coverage plane: every leaf, cov_counts and ring words included."""
    (j_init, j_run), (t_init, t_run) = _engines(
        4, coverage=True, sort_free=True, deferred=True, obs_slots=64)
    jc = jax.block_until_ready(j_run(j_init()))
    tc = t_run(t_init())
    _assert_carries_equal(tc, jc)
    assert np.array_equal(ts.cov_totals(tc), np.asarray(
        jc.cov_counts).astype(np.int64).sum(0))


def test_pipelined_2_shards_bit_identical():
    """The pipelined 2-shard run equals the unpipelined one (counts,
    statistics, table, per-level ring rows) and the reference's pipelined
    carry word for word, pv_* leaves and the staged ring row included."""
    (j_init, j_run), (t_init, t_run) = _engines(2, pipeline=True,
                                                obs_slots=64)
    jc = jax.block_until_ready(j_run(j_init()))
    tc = t_run(t_init())
    _assert_carries_equal(tc, jc)
    _, (u_init, u_run) = _engines(2, obs_slots=64)
    uc = u_run(u_init())
    labels = t_backend(FF).labels
    a = ts.result_from_shard_carry(uc, 0.0, labels=labels)
    b = ts.result_from_shard_carry(tc, 0.0, labels=labels)
    assert a[:3] == b[:3] == FF_COUNTS
    for f in ("violation", "action_generated", "action_distinct",
              "outdegree"):
        assert getattr(a, f) == getattr(b, f), f
    assert torch.equal(uc.table, tc.table)
    assert (ts.obs_rows_sharded(uc, labels)[0]
            == ts.obs_rows_sharded(tc, labels)[0])


@pytest.mark.parametrize("mode", ["violation", "segments"])
def test_halting_and_segment_runs_equal_reference(mode):
    """A deliberately broken rule (delete_noop: an assertion fails) halts
    both engines at the same body with the same leaves; a segment engine
    runs a fixed number of bodies past the end, adding the same dump-column
    counts and ring rows as the reference's fori_loop."""
    if mode == "violation":
        cfgs = (dataclasses.replace(FF, mutation="delete_noop"),
                dataclasses.replace(J_FF, mutation="delete_noop"))
        (j_init, j_run), (t_init, t_run) = _engines(4, cfgs=cfgs,
                                                    pipeline=True)
        jc = jax.block_until_ready(j_run(j_init()))
        tc = t_run(t_init())
        assert ts.result_from_shard_carry(tc, 0.0).violation == 3
    else:
        (j_init, j_seg), (t_init, t_seg) = _engines(2, segment=64,
                                                    obs_slots=16)
        jc, tc = j_init(), t_init()
        for _ in range(4):
            jc, tc = jax.block_until_ready(j_seg(jc)), t_seg(tc)
            _assert_carries_equal(tc, jc)
        assert ts.carry_done(tc)
    _assert_carries_equal(tc, jc)


# ---------------------------------------------------------------------------
# checkpoints, regrow
# ---------------------------------------------------------------------------


def _meta(D):
    return tck._meta(FF, queue_capacity=KW["queue_capacity"],
                     fp_capacity=KW["fp_capacity"], devices=D,
                     pipeline=True, obs_slots=16, sort_free=False,
                     deferred=False, symmetry=False, por=False)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A pipelined 2-shard carry checkpointed mid-run by either package
    loads in the other word for word (the meta's `devices` included) and
    both finish to equal carries."""
    (j_init, j_seg), (t_init, t_seg) = _engines(2, segment=40, pipeline=True,
                                                obs_slots=16)
    path = str(tmp_path / "c.npz")
    if writer == "port":
        tc = t_seg(t_init())
        tck.save_checkpoint(path, tc, _meta(2))
        meta, jc = jck.load_checkpoint(path, j_init())
    else:
        jc = jax.block_until_ready(j_seg(j_init()))
        jck.save_checkpoint(path, jc, _meta(2))
        meta, tc = tck.load_checkpoint(path, t_init())
    assert meta["devices"] == 2
    _assert_carries_equal(tc, jc)
    while not ts.carry_done(tc):
        jc, tc = jax.block_until_ready(j_seg(jc)), t_seg(tc)
    _assert_carries_equal(tc, jc)
    assert ts.result_from_shard_carry(tc, 0.0)[:3] == FF_COUNTS


def test_check_with_checkpoints_resumes_the_reference_file(tmp_path):
    """check_sharded_with_checkpoints: the reference stops after two
    segments of 32 bodies; the port resumes its file (meta checked) to the
    uninterrupted reference run's statistics."""
    path = str(tmp_path / "c.npz")
    kw = dict(KW, ckpt_every=32, ckpt_path=path)
    js.check_sharded_with_checkpoints(J_FF, _mesh(2), max_segments=2,
                                      backend=j_backend(J_FF), **kw)
    r = ts.check_sharded_with_checkpoints(FF, ts.ShardMesh(2, "cpu"),
                                          resume=True, **kw)
    want = js.check_sharded(J_FF, _mesh(2), backend=j_backend(J_FF), **KW)
    for f in ("generated", "distinct", "depth", "violation", "queue_left",
              "action_generated", "action_distinct", "outdegree"):
        assert getattr(r, f) == getattr(want, f), f
    with pytest.raises(ValueError, match="shape"):  # 2 shards, not 4
        ts.check_sharded_with_checkpoints(FF, ts.ShardMesh(4, "cpu"),
                                          resume=True, **kw)


def test_migrate_shard_carry_equals_reference():
    """A pipelined 4-shard carry migrated to twice the table, twice the
    queue and twice the route factor (B changes: the pending verdicts are
    folded by K12 on the carry's device and the buffer re-seated) equals
    the reference's
    migration, and one more segment at the new geometry too."""
    (j_init, j_seg), (t_init, t_seg) = _engines(4, segment=20, pipeline=True)
    jc, tc = jax.block_until_ready(j_seg(j_init())), t_seg(t_init())
    old = dict(queue_capacity=KW["queue_capacity"],
               fp_capacity=KW["fp_capacity"], route_factor=2.0)
    new = dict(queue_capacity=2 * KW["queue_capacity"],
               fp_capacity=2 * KW["fp_capacity"], route_factor=4.0)
    assert int(np.asarray(jc.pv_n).sum()) > 0
    jm = jr.migrate_shard_carry(jc, old, new)
    tm = tr.migrate_shard_carry(tc, old, new)
    _assert_carries_equal(tm, jm)
    assert tm.pv_send.shape[2] != tc.pv_send.shape[2]
    (_, j_seg2), (_, t_seg2) = _engines(4, segment=20, pipeline=True, **new)
    _assert_carries_equal(t_seg2(tm), jax.block_until_ready(j_seg2(jm)))


def test_denied_regrow_ends_with_a_checkpoint(tmp_path):
    """A sharded run whose table regrow is denied (alloc_fail@1 fails the
    allocation probe) takes the spill rung (engine.sharded.
    ShardedSpillRuntime), as the reference's does, and completes with the
    FF counts; its final checkpoint carries the host store's sibling and
    resumes to the same counts."""
    from torchtlc.resil.faults import FaultPlan
    from torchtlc.resil.supervisor import (
        SupervisorOptions,
        check_sharded_supervised,
    )

    path = str(tmp_path / "c")
    kw = dict(KW, fp_capacity=2048, device="cpu")
    sup = check_sharded_supervised(FF, 2, **kw, opts=SupervisorOptions(
        ckpt_path=path, ckpt_every=16,
        faults=FaultPlan.parse("alloc_fail@1")))
    assert not sup.exhausted and not sup.interrupted and sup.regrows == 0
    assert sup.spilled > 0 and sup.spill_flushes > 0 and sup.spill_hits > 0
    assert (sup.result.generated, sup.result.distinct,
            sup.result.depth) == FF_COUNTS
    assert os.path.exists(path + ".spill")
    done = check_sharded_supervised(FF, 2, **kw, opts=SupervisorOptions(
        ckpt_path=path, ckpt_every=16, resume=True))
    assert not done.interrupted
    assert (done.result.generated, done.result.distinct,
            done.result.depth) == FF_COUNTS


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
SMALL = ["-chunk", "128", "-qcap", "4096", "-fpcap", "16384"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_cli") / "Model_FF"
    d.mkdir()
    (d / "MC.tla").write_text(MC_TLA)
    (d / "MC.cfg").write_text(MC_CFG)
    return d


def _masked(text: str, tmp: str) -> str:
    """The transcript without dates, times, rates, the checkpoint
    directory, and the lines that name the program and the device."""
    lines = [ln for ln in text.replace(tmp, "TMP").splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search",
                                   "Resume with: "))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


# journal fields that hold walls, clock times, paths and versions
DROP = ("t", "wall_s", "t_dispatch", "t_fence", "seconds", "path",
        "version", "device")


def _journal(path):
    out = []
    for line in open(path):
        ev = json.loads(line)
        if ev["event"] == "phase":
            continue  # walls only
        out.append({k: v for k, v in ev.items() if k not in DROP})
    return out


def _both(model_dir, tmp_path, extra):
    """(rc, masked transcript, journal) of the reference and the port."""
    out = {}
    for name, fn, own in (("ref", j_main, []),
                          ("port", t_main, ["-workers", "cpu"])):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        argv = ["check", str(model_dir / "MC.cfg"), "-noTool", *SMALL,
                "-sharded", "2", "-checkpoint", str(d / "p"),
                "-checkpointevery", "16", *extra, *own]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        out[name] = (rc, _masked(buf.getvalue(), str(d)),
                     _journal(str(d / "p") + ".journal.jsonl"))
    return out


@pytest.mark.parametrize("case", ["plain", "fp-regrow", "route-overflow",
                                  "pipelined-route-overflow", "coverage"])
def test_sharded_command_equals_reference(model_dir, tmp_path, case):
    """`check MC.cfg -sharded 2 -checkpoint P` (supervised): exit 0, the
    transcript equal to jaxtlc's after masking, and the journal's events
    equal without walls - the regrow journal of an under-sized table and
    of route buckets small enough to overflow included, pipelined too (the
    pending verdicts folded before the bucket width changes), and the
    coverage dump and coverage events of a -coverage run."""
    extra = {"plain": [], "fp-regrow": ["-fpcap", "2048"],
             "route-overflow": ["-routefactor", "0.3"],
             "pipelined-route-overflow": ["-pipeline", "-routefactor", "0.3"],
             "coverage": ["-coverage"]}[case]
    out = _both(model_dir, tmp_path, extra)
    assert out["ref"][0] == out["port"][0] == 0
    assert "17020" in out["port"][1] and "8203" in out["port"][1]
    assert out["port"][1] == out["ref"][1]
    assert out["port"][2] == out["ref"][2]
    grows = [e["resource"] for e in out["port"][2] if e["event"] == "regrow"]
    assert grows == {"plain": [], "fp-regrow": ["fp_capacity"] * 3,
                     "route-overflow": ["route_factor"],
                     "pipelined-route-overflow": ["route_factor"],
                     "coverage": []}[case]
    if case == "coverage":
        assert any(e["event"] == "coverage" for e in out["port"][2])


def test_sharded_pipeline_sigterm_then_recover(model_dir, tmp_path):
    """-pipeline -faults sigterm@3: exit 75 and a final checkpoint in both
    packages; -recover -pipeline finishes with exit 0 and the reference's
    transcript and journal."""
    first = _both(model_dir, tmp_path, ["-pipeline", "-faults", "sigterm@3"])
    assert first["ref"][0] == first["port"][0] == 75
    assert first["port"][1] == first["ref"][1]
    second = _both(model_dir, tmp_path, ["-pipeline", "-recover"])
    assert second["ref"][0] == second["port"][0] == 0
    assert second["port"][1] == second["ref"][1]
    assert second["port"][2] == second["ref"][2]


@pytest.mark.parametrize("argv,rc,needle", [
    (["-sharded", "3"], 1, "power of two"),
    (["-sharded", "2", "-fairness", "wf_all"], 2, "invalid choice"),
])
def test_sharded_flag_errors(model_dir, capsys, argv, rc, needle):
    """A shard count that is not a power of two exits 1, as the reference's
    assertion does; an unknown -fairness exits 2 as argparse's refusal
    does in the reference.  (-phase-timing, once refused here, runs:
    tests/test_torch_phases.py holds it to the reference, ignored under
    -sharded as there.)"""
    try:
        got = t_main(["check", str(model_dir / "MC.cfg"), "-workers", "cpu",
                      *argv])
    except SystemExit as e:  # argparse's refusal
        got = e.code
    err = capsys.readouterr().err
    assert got == rc and needle in err
    assert "slice 7" not in err


def test_entry_dryrun_multichip_needs_the_card_or_cpu():
    """dryrun_multichip runs on the card by default: without one it raises
    before any work unless device="cpu" is asked for."""
    from torchtlc.entry import dryrun_multichip

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)


@pytest.mark.slow
def test_model1_8_shards_equals_reference_digest():
    """dryrun_multichip's workload on the CPU (Model_1, 8 shards, chunk
    2048: slab dedup and deferred invariants on): MC.out's counts and
    per-action generated counts, and the 8 shard tables' SHA-256, the
    per-action distinct counts and the outdegree of the reference's
    sharded run (pinned in chip_smoke.py, which holds the card's run to
    them).  55 s alone on one CPU thread, 75 s beside three other
    workers: marked slow, as the reference marks its Model_1 sharded run
    (tests/test_sharded.py:148)."""
    import chip_smoke as cs

    init_fn, run_fn = ts.make_sharded_engine(
        ModelConfig(True, True), ts.ShardMesh(8, "cpu"), **cs.M1_SHARDED_KW)
    c = run_fn(init_fn())
    r = ts.result_from_shard_carry(c, 0.0)
    assert (r.generated, r.distinct, r.depth) == cs.M1_COUNTS
    assert r.violation == 0 and r.queue_left == 0
    assert r.action_generated == cs.MC_OUT_GENERATED
    assert r.action_distinct == cs.M1_SHARDED_DISTINCT
    assert r.outdegree == cs.M1_SHARDED_OUTDEGREE
    assert hashlib.sha256(c.table.numpy().astype("<i4").tobytes(
    )).hexdigest() == cs.M1_SHARDED_TABLE_SHA256
