"""The straggler walk's run-local claim rank (fpset.cuh fp_slice_order;
the walk of K3 and K33, fpset_walk.cuh) and K1's row and lane steps
(kubeapi.cuh kube_field_get, kube_pack_word, kube_lane_step; expand.cu),
through their g++ build (host_launch.cpp), against the port's plain
versions and jaxtlc: the walk's table words and is_new equal to
fpset_walk_plain and to the reference's _probe_block in both walk forms
(dense and sorted), with the general order never taken on the callers'
key orders; K1's outputs equal to expand_plain / expand_sharded_plain and
to the reference's expand stage.  Tolerance zero throughout."""

import ctypes
import dataclasses
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.engine import backend as jbackend
from jaxtlc.engine import fpset as jfs
from jaxtlc.spec import oracle
from jaxtlc.spec.codec import get_codec as j_get_codec
from torchtlc.config import MODEL_1, ModelConfig, make_scaled
from torchtlc.engine import fpset as tfs
from torchtlc.engine import sharded as ts
from torchtlc.engine.backend import expand_plain, kernel_layout
from torchtlc.spec.codec import get_codec
from torchtlc.testing import one_thread

one_thread()

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torchtlc", "kernels", "csrc")
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("walk_rank") / "libhost.so")
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-D__host__=",
         "-D__device__=", "-I", CSRC, "-o", so,
         os.path.join(CSRC, "host_launch.cpp")],
        check=True, capture_output=True, timeout=300)
    h = ctypes.CDLL(so)
    h.host_fpset_walk.argtypes = [P, I, P, I, P, P, P]
    h.host_fpset_probe_segment.argtypes = [P, I, P, I, LL, LL, P, I, P, P]
    h.host_expand.argtypes = [P, P, I, I, I, P, P, P, P]
    h.host_expand_sharded.argtypes = [P, P, LL, I, P, P, I, I, I, P, P, P, P,
                                      P, P]
    return h


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


def _keys_at(rng, homes, nb):
    """One distinct fingerprint key for each entry of `homes` (a home
    bucket of a table of nb rows), drawn by rejection from random
    fingerprints: (raw lo, raw hi) uint32 and their keys, ascending."""
    want = {}
    for h in homes:
        want[h] = want.get(h, 0) + 1
    lo_out, hi_out = [], []
    lognb = nb.bit_length() - 1
    while want:
        lo = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
        hi = rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32)
        key = tfs.fpset_key_plain(torch.from_numpy(lo.view(np.int32)),
                                  torch.from_numpy(hi.view(np.int32)),
                                  torch.ones(lo.shape[0], dtype=torch.bool))
        home = (tfs.key_words(key)[1] >> (32 - lognb)).numpy()
        for i in range(lo.shape[0]):
            h = int(home[i])
            if want.get(h):
                want[h] -= 1
                if not want[h]:
                    del want[h]
                lo_out.append(lo[i])
                hi_out.append(hi[i])
    return np.array(lo_out, np.uint32), np.array(hi_out, np.uint32)


def _segment(lo, hi, R):
    """The sorted, compacted key block of raw fingerprints (lo, hi),
    padded to R: (keys [R] int64, nreps)."""
    key = tfs.fpset_key_plain(torch.from_numpy(lo.view(np.int32)),
                              torch.from_numpy(hi.view(np.int32)),
                              torch.ones(lo.shape[0], dtype=torch.bool))
    c_key, _, nreps = tfs.dedup_compact(key)
    keys = torch.full((R,), tfs.KEY00, dtype=torch.int64)
    keys[:c_key.shape[0]] = c_key
    return keys, int(nreps)


def _probe_all(lib, table, keys, active, C, dense_forms=(True, False)):
    """One probe segment three ways from the same table: the g++ walk
    (with its counters), the port's plain version, the reference's
    _probe_block in the walk forms dense_forms (dense, sorted).  Asserts
    equal table words and is_new; returns (the walk's counters,
    stragglers)."""
    R = keys.shape[0]
    lognb = table.shape[0].bit_length() - 1
    host = table.copy()
    is_new = np.zeros(R, np.uint8)
    stats = np.zeros(3, np.int32)
    k = np.ascontiguousarray(keys.numpy())
    act = np.ascontiguousarray(active.numpy().astype(np.uint8))
    lib.host_fpset_probe_segment(host.ctypes.data, lognb, k.ctypes.data, R,
                                 0, 0, act.ctypes.data, C, is_new.ctypes.data,
                                 stats.ctypes.data)
    plain = torch.from_numpy(table.view(np.int32).copy())
    slot = tfs.fpset_round0_plain(plain, keys, active)
    p_new, pend = tfs.fpset_claim_plain(plain, keys, slot, C)
    n_strag = int(pend.sum())
    tfs.fpset_walk_plain(plain, keys, pend, p_new)
    assert (host == plain.numpy().view(np.uint32)).all()
    assert (is_new == p_new.numpy()).all()
    lo, hi = tfs.key_words(keys)
    for dense in dense_forms:
        jt, jnew = jfs._probe_block(
            jnp.asarray(table), jnp.asarray(lo.numpy().astype(np.uint32)),
            jnp.asarray(hi.numpy().astype(np.uint32)),
            jnp.asarray(active.numpy()), C, dense_walk=dense)
        assert (np.asarray(jt) == host).all(), f"dense={dense}"
        assert (np.asarray(jnew) == is_new.astype(bool)).all()
    return stats, n_strag


# every walk case probes one segment of R keys into a table of NB rows
# with the first C fitting claims in round 0, so the reference compiles
# each walk form once; the dense form runs in the wrap case, the sorted
# form in every case
NB, R, C = 1 << 10, 1 << 12, 64


def _active(n):
    return torch.arange(R) < n


def test_walk_runs_wrap_and_wide_runs(lib):
    """A table loaded around its end, then one segment whose home runs
    hold 1 wanter (isolated homes), 10 (rows NB-12 .. NB-2, 0-5) and 40
    at the last row, NB-1: its wanters walk past it to row 0 on."""
    rng = np.random.default_rng(2101)
    table = np.zeros((NB, 16), np.uint32)
    pre = [h % NB for h in range(NB - 16, NB + 12) for _ in range(5)]
    keys, n = _segment(*_keys_at(rng, pre, NB), R)
    table = np.asarray(jfs._probe_block(
        jnp.asarray(table), *(jnp.asarray(w.numpy().astype(np.uint32))
                              for w in tfs.key_words(keys)),
        jnp.asarray(_active(n).numpy()), C, dense_walk=False)[0])
    homes = ([NB - 1] * 40 + [h for h in range(NB - 12, NB - 1)
                              for _ in range(10)]
             + [h for h in range(0, 6) for _ in range(10)]
             + list(range(40, NB - 40, 40)))
    keys, n = _segment(*_keys_at(rng, homes, NB), R)
    stats, n_strag = _probe_all(lib, table, keys, _active(n), C)
    assert n_strag > 40 and stats[0] == 1 and stats[1] > 10
    assert stats[2] == 0  # the sorted block's homes ascend


def test_walk_more_than_one_slice(lib):
    """> 2048 stragglers (claims beyond the first C wait for the walk):
    two slices, each ordered once, runs of 1 and more."""
    rng = np.random.default_rng(2102)
    table = np.zeros((NB, 16), np.uint32)
    lo = rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)
    keys, n = _segment(lo, hi, R)
    stats, n_strag = _probe_all(lib, table, keys, _active(n), C, (False,))
    assert n_strag > 2048 and stats[0] == 2 and stats[2] == 0


def test_walk_on_the_slab_layout(lib):
    """The slab path's ordered claimants: representatives interspersed
    with the duplicate rows of slab-collision classes (active not a
    prefix), at 3 slab bits; the walk skips the inactive rows."""
    rng = np.random.default_rng(2103)
    vals = rng.integers(0, 2**32, (3000, 2), dtype=np.uint64).astype(
        np.uint32)
    pick = rng.integers(0, 3000, R)
    key = tfs.fpset_key_plain(torch.from_numpy(vals[pick, 0].view(np.int32)),
                              torch.from_numpy(vals[pick, 1].view(np.int32)),
                              torch.ones(R, dtype=torch.bool))
    c_lane, n_cand = tfs._slab_dedup_core(key, R, 4, 1, 3)
    s_key, _, active = tfs._order_and_dedup(key, c_lane, n_cand, R)
    act = active.bool()
    assert not bool((act[:int(act.sum())]).all())  # interspersed
    table = np.zeros((NB, 16), np.uint32)
    stats, n_strag = _probe_all(lib, table, s_key, act, C, (False,))
    assert n_strag > 0 and stats[2] == 0


def test_walk_general_order_is_exact(lib):
    """A pending block whose homes do not ascend takes the general order
    (counted), and still equals the plain dense walk word for word."""
    rng = np.random.default_rng(2104)
    nb = 64
    homes = [h for h in (60, 3, 61, 3, 62, 5) for _ in range(12)]
    lo, hi = _keys_at(rng, homes, nb)
    key = tfs.fpset_key_plain(torch.from_numpy(lo.view(np.int32)),
                              torch.from_numpy(hi.view(np.int32)),
                              torch.ones(lo.shape[0], dtype=torch.bool))
    keys = key[torch.from_numpy(rng.permutation(key.shape[0]))]
    n = keys.shape[0]
    table = np.zeros((nb, 16), np.uint32)
    pend = torch.ones(n, dtype=torch.uint8)
    host, h_pend = table.copy(), pend.numpy().copy()
    h_new = np.zeros(n, np.uint8)
    stats = np.zeros(3, np.int32)
    k = np.ascontiguousarray(keys.numpy())
    lib.host_fpset_walk(host.ctypes.data, 6, k.ctypes.data, n,
                        h_pend.ctypes.data, h_new.ctypes.data,
                        stats.ctypes.data)
    plain = torch.from_numpy(table.view(np.int32).copy())
    p_new = torch.zeros(n, dtype=torch.uint8)
    tfs.fpset_walk_plain(plain, keys, pend.clone(), p_new)
    assert stats[2] == 1 and not h_pend.any()
    assert (host == plain.numpy().view(np.uint32)).all()
    assert (h_new == p_new.numpy()).all() and h_new.all()


# ---------------------------------------------------------------------------
# K1's row and lane steps
# ---------------------------------------------------------------------------

CK = 48  # rows a block: every reference call below has one shape a config
TAGS = ("ff", "model1", "scaled", "scaled3x0")
# held against the reference's expand stage too (one compile a config);
# scaled 3x0's wider rows against the plain versions alone
REF_TAGS = TAGS[:3]


@pytest.fixture(scope="module")
def blocks():
    """{tag: (cfg, packed block [CK, W], popped)}: FF-reachable states,
    and seeded random words (every handler, fault lane and garbage word)
    of Model_1, scaled 2x1 and scaled 3x0 with both faults (W = 9 words,
    past the 8 of the smaller configs)."""
    jcfg = JConfig(False, False)
    cdc = j_get_codec(jcfg)
    frontier = oracle.initial_states(jcfg)
    seen = set(frontier)
    while len(seen) < 8 * CK:  # the first BFS levels
        frontier = [sc.state for st in frontier
                    for sc in oracle.successors(st, jcfg)
                    if sc.state not in seen and not seen.add(sc.state)]
    states = [cdc.encode(s) for s in sorted(seen, key=oracle._ckey)]
    rng = np.random.default_rng(2105)
    ff = np.stack(states)[rng.choice(len(states), CK, replace=False)]
    ff_cfg = ModelConfig(False, False)
    out = {"ff": (ff_cfg, get_codec(ff_cfg).pack(torch.from_numpy(ff)),
                  CK - 4)}
    for tag, cfg in (("model1", MODEL_1),
                     ("scaled", make_scaled(2, 1, False, False)),
                     ("scaled3x0", make_scaled(3, 0, True, True))):
        c = get_codec(cfg)
        fields = np.stack([rng.integers(0, 1 << w, CK)
                           for w in c.lane_widths], 1).astype(np.int32)
        out[tag] = (cfg, c.pack(torch.from_numpy(fields)), CK - 3)
    assert out["scaled3x0"][1].shape[1] == 9
    return out


_REFERENCE = {}


def _reference_expand(cfg, fields, n):
    """jaxtlc's deferred expand stage over unpacked rows [CK, F], the
    first n popped, with the reference's invariant kernel on its raw
    successors (the immediate stage's inv_bad masks), jitted once a
    config: (packed, valid, action, gen, flat, bad TypeOK, bad
    OnlyOneVersion)."""
    import jax

    key = dataclasses.astuple(cfg)
    if key not in _REFERENCE:
        be = jbackend.kubeapi_backend(JConfig(**dataclasses.asdict(cfg)))
        ex_fn = jbackend.make_expand_stage(be, CK, False, 0, 0, True)

        def run(batch, mask):
            ex = ex_fn(batch, mask)
            inv = jax.vmap(be.inv_check)(ex.flat)
            return (ex.packed, ex.valid, ex.action, ex.gen, ex.flat,
                    ex.valid & ((inv & 1) == 0), ex.valid & ((inv & 2) == 0))

        _REFERENCE[key] = jax.jit(run)
    out = _REFERENCE[key](jnp.asarray(fields), jnp.asarray(np.arange(CK) < n))
    out = [np.asarray(x) for x in out]
    out[0] = out[0].view(np.int32)
    out[3] = out[3].astype(np.int64)
    return out


@pytest.mark.parametrize("deferred", [False, True], ids=["immediate",
                                                          "deferred"])
@pytest.mark.parametrize("tag", TAGS)
def test_k1_row_lane_steps_equal_plain_and_reference(lib, blocks, tag,
                                                     deferred):
    cfg, block, n = blocks[tag]
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
    got = (packed, flags, action, gen.astype(np.int64))
    for name, a, r in zip(("packed", "flags", "action", "gen"), got,
                          expand_plain(cfg, block, n, deferred)):
        assert (a == r.numpy()).all(), name
    if tag not in REF_TAGS:
        return
    rp, rv, ra, rg, _, bad_t, bad_o = _reference_expand(
        cfg, get_codec(cfg).unpack(block).numpy(), n)
    assert (packed == rp).all()
    assert (flags[0].astype(bool) == rv).all()
    assert (action == ra).all() and (got[3] == rg).all()
    if deferred:
        assert not flags[3:].any()
    else:
        assert (flags[3].astype(bool) == bad_t).all()
        assert (flags[4].astype(bool) == bad_o).all()


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("tag", ["scaled", "scaled3x0"])
def test_k1_sharded_steps_equal_plain_and_reference(lib, blocks, tag, D):
    """The sharded variant over unpacked queue rows in D circular queues
    (heads that wrap), deferred: every output against
    expand_sharded_plain, and (scaled 2x1) each shard's lanes against the
    reference's expand stage on its popped rows (packed words, validity,
    actions, flat fields)."""
    cfg, block, _ = blocks[tag]
    lay = kernel_layout(cfg)
    L, F, W = int(lay[28]), int(lay[24]), int(lay[25])
    rows = get_codec(cfg).unpack(block)
    qrows = CK + 5
    queue = rows[torch.arange(D * qrows) % CK].reshape(D, qrows, F)
    qhead = torch.tensor([(11 * d + 7) % (qrows - 1) for d in range(D)],
                         dtype=torch.int64)
    npop = torch.tensor([CK - 2 * d for d in range(D)], dtype=torch.int64)
    ncand = D * CK * L
    out = dict(packed=np.zeros((ncand, W), np.int32),
               flags=np.zeros((5, ncand), np.uint8),
               action=np.zeros(ncand, np.int32),
               fields=np.zeros((ncand, F), np.int32),
               block=np.zeros((D * CK, W), np.int32),
               gen=np.zeros((D, 22), np.uint64))
    q, qh, nn = (np.ascontiguousarray(t.numpy()) for t in (queue, qhead,
                                                           npop))
    lib.host_expand_sharded(lay.ctypes.data, q.ctypes.data, qrows, qrows - 1,
                            qh.ctypes.data, nn.ctypes.data, D, CK, 1,
                            out["packed"].ctypes.data,
                            out["flags"].ctypes.data,
                            out["action"].ctypes.data,
                            out["fields"].ctypes.data,
                            out["block"].ctypes.data, out["gen"].ctypes.data)
    ref = ts.expand_sharded_plain(cfg, queue, qhead, npop, CK, True, True)
    for k, r in zip(("packed", "flags", "action", "gen", "fields", "block"),
                    ref):
        assert (out[k].astype(np.int64) == r.numpy()).all(), k
    if tag not in REF_TAGS:
        return
    popped = ts.popped_rows(queue, qhead, CK).numpy()
    per = CK * L
    for d in range(D):
        rp, rv, ra, _, rf, _, _ = _reference_expand(cfg, popped[d],
                                                    int(npop[d]))
        s = slice(d * per, (d + 1) * per)
        assert (out["packed"][s] == rp).all()
        assert (out["flags"][0, s].astype(bool) == rv).all()
        assert (out["action"][s] == ra).all()
        assert (out["fields"][s] == rf).all()
