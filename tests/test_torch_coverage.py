"""The port's device coverage plane against jaxtlc's, on the CPU.

* the plane: site table (keys, kinds, actions, locations, order) and the
  plain count (spec.coverage_device.count_plain) equal to jaxtlc's
  plane.count on reachable blocks, and kernel K10's own per-row logic
  (coverage.cuh, built with g++ through host_launch.cpp) equal too -
  FF and both-flags-true geometry (F 20, 108 bits) and the scaled 2x1
  geometry (F 34, 222 bits), random pop counts and lane masks, exact
  uint32 words;
* the engine: FF's 311-site vector equal to the reference engine's, its
  span sites equal to the host walker's, every other leaf equal to a
  coverage-off run, the same vector in the default modes at chunk 2048;
* checkpoints (both ways across the packages), regrow, the spill tier;
* the supervisor: the `coverage` journal events equal the reference's,
  the saturation event, continuity across SIGTERM -> resume;
* kernel K8's overflow test over the coverage pair (ring.cuh via g++).
"""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxtlc.config import MATRIX as J_MATRIX
from jaxtlc.config import make_scaled as j_make_scaled
from jaxtlc.engine import bfs as jbfs
from jaxtlc.engine import checkpoint as jck
from jaxtlc.resil import SupervisorOptions as JOpts
from jaxtlc.resil import check_supervised as j_supervised
from jaxtlc.spec import oracle
from jaxtlc.spec.codec import get_codec as j_get_codec
from jaxtlc.spec.coverage_device import kubeapi_coverage_plane as j_plane
from torchtlc.config import MATRIX, make_scaled
from torchtlc.engine import bfs, checkpoint as ck
from torchtlc.engine.backend import expand_plain
from torchtlc.engine.interop import carry_to_numpy
from torchtlc.obs import counters as tcnt
from torchtlc.obs.coverage import coverage_from_events
from torchtlc.obs.journal import RunJournal, read as read_journal
from torchtlc.resil.faults import FaultPlan
from torchtlc.resil.regrow import migrate_engine_carry
from torchtlc.resil.supervisor import (
    SingleDeviceAdapter,
    SupervisorOptions,
    _params_from_meta,
    check_supervised,
)
from torchtlc.spec.codec import get_codec
from torchtlc.spec.coverage import run_coverage
from torchtlc.spec.coverage_device import (
    count_plain,
    kernel_params,
    kubeapi_coverage_plane,
)
from test_torch_kernels_host import host_lib as host_lib_base  # noqa: F401
from torchtlc.testing import one_thread

one_thread()

P, I = ctypes.c_void_p, ctypes.c_int

FF = MATRIX[(False, False)]
J_FF = J_MATRIX[(False, False)]
FF_COUNTS = (17020, 8203, 109)
KW = dict(chunk=128, queue_capacity=1 << 12, fp_capacity=1 << 14)
OBS = 16
STEPS = 40  # the segment a checkpoint is cut after

# (port config, reference config, BFS depth of the reachable sample)
CONFIGS = {
    "ff": (FF, J_FF, None),
    "tt": (MATRIX[(True, True)], J_MATRIX[(True, True)], 30),
    "scaled": (make_scaled(2, 1), j_make_scaled(2, 1), 14),
    "scaled_tt": (make_scaled(2, 1, True, True),
                  j_make_scaled(2, 1, True, True), 10),
}
CASES = [(name, seed) for name in CONFIGS for seed in (0, 1)]


@pytest.fixture(scope="module")
def host_lib(host_lib_base):
    """The g++ build of the kernels' headers (test_torch_kernels_host)."""
    host_lib_base.host_coverage_count.argtypes = [P, P, I, I, P, P]
    return host_lib_base


def _reachable(jcfg, depth):
    """Encoded field vectors of the states of the first `depth` BFS levels
    (every reachable state when depth is None)."""
    cdc = j_get_codec(jcfg)
    frontier = oracle.initial_states(jcfg)
    seen = set(frontier)
    level = 1
    while frontier and (depth is None or level < depth):
        nxt = []
        for st in frontier:
            for sc in oracle.successors(st, jcfg):
                if sc.state not in seen:
                    seen.add(sc.state)
                    nxt.append(sc.state)
        frontier = nxt
        level += 1
    return np.stack([cdc.encode(s) for s in sorted(seen, key=oracle._ckey)])


@pytest.fixture(scope="module")
def samples():
    return {name: _reachable(jc, depth)
            for name, (_, jc, depth) in CONFIGS.items()}


def _case(samples, name, seed):
    """A popped block of reachable rows with a random pop count n and the
    K1 valid flags under a random lane mask."""
    cfg, jcfg, _ = CONFIGS[name]
    rng = np.random.default_rng(seed)
    states = samples[name]
    ck = 192
    batch = states[rng.integers(0, len(states), ck)].astype(np.int32)
    block = get_codec(cfg).pack(torch.from_numpy(batch))
    n = int(rng.integers(ck // 2, ck + 1)) if seed else ck
    _, flags, _, _ = expand_plain(cfg, block, n)
    keep = torch.from_numpy(rng.random(flags.shape[1]) < 0.8)
    valid = (flags[0].bool() & keep).to(torch.uint8)
    return cfg, jcfg, batch, block, n, valid


def _reference_count(jcfg, batch, n, valid):
    ck = batch.shape[0]
    mask = np.arange(ck) < n
    return np.asarray(j_plane(jcfg).count(
        jnp.asarray(batch), jnp.asarray(mask),
        jnp.asarray(valid.numpy().reshape(ck, -1).astype(bool))))


@pytest.mark.parametrize("name,seed", CASES)
def test_count_plain_equals_reference(samples, name, seed):
    cfg, jcfg, batch, block, n, valid = _case(samples, name, seed)
    want = _reference_count(jcfg, batch, n, valid)
    got = count_plain(cfg, block, n, valid).numpy().view(np.uint32)
    assert got.shape == (311,)
    assert np.array_equal(got, want)
    assert want[22:].any() and want[:22].any()  # not vacuous


@pytest.mark.parametrize("name,seed", CASES)
def test_kernel_header_equals_reference(host_lib, samples, name, seed):
    """K10's per-row logic (coverage.cuh:cov_row, g++) over the block."""
    cfg, jcfg, batch, block, n, valid = _case(samples, name, seed)
    want = _reference_count(jcfg, batch, n, valid)
    out = np.zeros(311, np.uint32)
    prm = kernel_params(cfg)
    b = np.ascontiguousarray(block.numpy())
    v = np.ascontiguousarray(valid.numpy())
    host_lib.host_coverage_count(prm.ctypes.data, b.ctypes.data,
                                 b.shape[0], n, v.ctypes.data,
                                 out.ctypes.data)
    assert np.array_equal(out, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_site_table_equals_reference(host_lib, name):
    cfg, jcfg, _ = CONFIGS[name]
    mine = kubeapi_coverage_plane(cfg)
    ref = j_plane(jcfg)
    assert [tuple(s) for s in mine.sites] == [tuple(s) for s in ref.sites]
    kinds = [s.kind for s in mine.sites]
    assert (kinds.count("action"), kinds.count("init"),
            kinds.count("span")) == (22, 9, 280)
    assert mine.module == ref.module == "KubeAPI"
    inits = get_codec(cfg).initial_vectors()
    assert np.array_equal(mine.seed(inits), ref.seed(inits))
    assert host_lib.tt_coverage_words() == kernel_params(cfg).shape[0]


def test_plane_count_on_cpu_is_the_plain_version(samples):
    cfg, _, _, block, n, valid = _case(samples, "tt", 1)
    got = kubeapi_coverage_plane(cfg).count(block, n, valid)
    assert torch.equal(got, count_plain(cfg, block, n, valid))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_engine():
    return jbfs.make_engine(J_FF, **KW, obs_slots=OBS, coverage=True,
                            donate=False)


@pytest.fixture(scope="module")
def ref_final(ref_engine):
    j_init, j_run, _ = ref_engine
    return j_run(j_init())


def _port_engine(coverage=True, **kw):
    return bfs.make_engine(FF, **dict(KW, **kw), obs_slots=OBS,
                           coverage=coverage, device="cpu")


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for cov in (True, False):
        init_fn, run_fn, _ = _port_engine(cov)
        carry = run_fn(init_fn())
        out[cov] = (carry_to_numpy(carry), bfs.result_from_carry(
            carry, 0.0, fp_capacity=KW["fp_capacity"],
            sites=kubeapi_coverage_plane(FF).sites if cov else None))
    return out


def test_ff_site_vector_equals_reference(port_runs, ref_final):
    leaves, r = port_runs[True]
    assert (r.generated, r.distinct, r.depth) == FF_COUNTS
    want = np.asarray(ref_final.cov_counts)
    assert leaves["cov_counts"].dtype == want.dtype == np.uint32
    assert np.array_equal(leaves["cov_counts"], want)
    sites = kubeapi_coverage_plane(FF).sites
    assert r.site_coverage == {s.key: int(v) for s, v in zip(sites, want)}
    # the action prefix is the per-action generated counters
    assert all(r.site_coverage[a] == r.action_generated.get(a, 0)
               for a in r.action_generated)


def test_ff_span_sites_equal_host_walker(port_runs):
    walk = run_coverage(FF)
    assert (walk.generated, walk.distinct, walk.depth) == FF_COUNTS
    r = port_runs[True][1]
    sites = kubeapi_coverage_plane(FF).sites
    bad = [(s.key, r.site_coverage[s.key])
           for s in sites if r.site_coverage[s.key] != (
               walk.act_gen.get(s.key, 0) if s.kind == "action"
               else walk.cov.n.get(s.key, 0))]
    assert not bad, bad[:10]
    assert sum(1 for v in r.site_coverage.values() if v) >= 0.9 * 311


def test_coverage_on_equals_coverage_off(port_runs):
    (on, r_on), (off, r_off) = port_runs[True], port_runs[False]
    assert set(on) - set(off) == {"cov_counts"}
    for name, want in off.items():
        assert np.array_equal(on[name], want), name
    assert r_off.site_coverage is None
    for f in r_off._fields:
        if f not in ("site_coverage", "violation_state"):
            assert getattr(r_on, f) == getattr(r_off, f), f


def test_default_modes_count_before_dedup(port_runs):
    """At chunk 2048 the slab dedup and the deferred invariants are on;
    the count is taken on the expand stage's flags, so the vector is the
    sorted immediate run's."""
    r = bfs.check(FF, chunk=2048, queue_capacity=1 << 13,
                  fp_capacity=1 << 15, coverage=True, device="cpu")
    assert (r.generated, r.distinct, r.depth) == FF_COUNTS
    assert r.site_coverage == port_runs[True][1].site_coverage


# ---------------------------------------------------------------------------
# checkpoints, regrow, the spill tier
# ---------------------------------------------------------------------------


def _meta(coverage=True):
    return SingleDeviceAdapter(FF, chunk=KW["chunk"], obs_slots=OBS,
                               device="cpu", coverage=coverage).meta(
        {k: KW[k] for k in ("queue_capacity", "fp_capacity")})


def _ref_leaves(jc) -> dict:
    return {f: np.asarray(jc.fps.table if f == "fps" else getattr(jc, f))
            for f in ck.LEAF_ORDER if getattr(jc, f, None) is not None}


def assert_carries_equal(port_carry, jc):
    mine, ref = carry_to_numpy(port_carry), _ref_leaves(jc)
    assert set(mine) == set(ref)
    for name, want in ref.items():
        assert mine[name].dtype == want.dtype, name
        assert np.array_equal(mine[name], want), name


def test_checkpoint_meta_records_coverage():
    want = jck._meta(J_FF, chunk=KW["chunk"], fp_index=51,
                     seed=jbfs.DEFAULT_SEED, fp_highwater=0.85,
                     pipeline=False, obs_slots=OBS, coverage=True,
                     sort_free=False, deferred=False, symmetry=False,
                     por=False, queue_capacity=KW["queue_capacity"],
                     fp_capacity=KW["fp_capacity"])
    assert _meta() == want
    plain = SingleDeviceAdapter(FF, chunk=KW["chunk"], obs_slots=OBS,
                                device="cpu")
    with pytest.raises(ValueError, match="coverage"):
        _params_from_meta(plain, _meta(), {
            k: KW[k] for k in ("queue_capacity", "fp_capacity")})


def test_port_checkpoint_resumes_in_reference(tmp_path, ref_engine):
    init_fn, run_fn, step_fn = _port_engine()
    carry = bfs.make_segment(step_fn, STEPS)(init_fn())
    path = str(tmp_path / "port.npz")
    ck.save_checkpoint(path, carry, _meta())
    j_init, j_run, _ = ref_engine
    meta, jc = jck.load_checkpoint(path, j_init())
    assert meta["coverage"] is True
    assert_carries_equal(carry, jc)
    assert_carries_equal(run_fn(carry), j_run(jc))


def test_reference_checkpoint_resumes_in_port(tmp_path, ref_engine):
    j_init, j_run, j_step = ref_engine
    jc = j_init()
    for _ in range(STEPS):
        jc = j_step(jc)
    path = str(tmp_path / "ref.npz")
    jck.save_checkpoint(path, jc, _meta())
    init_fn, run_fn, _ = _port_engine()
    _, carry = ck.load_checkpoint(path, init_fn())
    assert_carries_equal(carry, jc)
    assert_carries_equal(run_fn(carry), j_run(jc))


def test_regrow_migrates_coverage_verbatim():
    init_fn, _, step_fn = bfs.make_engine(
        FF, chunk=64, queue_capacity=1 << 10, fp_capacity=1 << 12,
        coverage=True, device="cpu")
    carry = step_fn(step_fn(init_fn()))
    old = {"queue_capacity": 1 << 10, "fp_capacity": 1 << 12}
    new = {"queue_capacity": 1 << 11, "fp_capacity": 1 << 13}
    migrated = migrate_engine_carry(carry, old, new)
    assert torch.equal(migrated.cov_counts, carry.cov_counts)
    assert migrated.cov_counts.data_ptr() != carry.cov_counts.data_ptr()
    _, _, step2 = bfs.make_engine(FF, chunk=64, **new, coverage=True,
                                  device="cpu")
    after = step2(migrated)
    assert int(after.cov_counts.sum()) > int(carry.cov_counts.sum())


def test_spill_tier_keeps_the_site_vector(port_runs):
    """The host spill tier's commit folds the increments too: a run whose
    table spills ends with the clean vector."""
    sup = check_supervised(
        FF, chunk=128, queue_capacity=1 << 12, fp_capacity=1 << 12,
        coverage=True, device="cpu",
        opts=SupervisorOptions(faults=FaultPlan.parse("alloc_fail@1")))
    r = sup.result
    assert sup.spilled > 0
    assert (r.generated, r.distinct, r.depth) == FF_COUNTS
    assert r.site_coverage == port_runs[True][1].site_coverage


# ---------------------------------------------------------------------------
# the supervisor's coverage events
# ---------------------------------------------------------------------------

SUP_KW = dict(chunk=256, queue_capacity=1 << 12, fp_capacity=1 << 14,
              obs_slots=32)


def _sup(tmp, name, package="port", **opts):
    """A supervised FF coverage run journaling into tmp; returns
    (SupervisedResult, journal path)."""
    jpath = os.path.join(str(tmp), f"{name}.journal.jsonl")
    resume = opts.pop("resume", False)
    j = RunJournal(jpath, resume=resume)
    if resume:
        j.event("run_resume", version="t", path=jpath)
    else:
        j.event("run_start", version="t", workload="FF", engine="single",
                device="cpu", params={})
    common = dict(ckpt_path=os.path.join(str(tmp), f"{name}.npz"),
                  ckpt_every=16, resume=resume,
                  on_event=lambda kind, info: j.event(kind, **info), **opts)
    if package == "port":
        sup = check_supervised(FF, **SUP_KW, coverage=True, device="cpu",
                               opts=SupervisorOptions(**common))
    else:
        sup = j_supervised(J_FF, **SUP_KW, coverage=True,
                           opts=JOpts(**common))
    j.close()
    return sup, jpath


@pytest.fixture(scope="module")
def sup_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cov_sup")
    return {p: _sup(tmp, p, package=p) for p in ("port", "ref")}


def _cov_events(path):
    return [{k: v for k, v in e.items() if k != "t"}
            for e in read_journal(path) if e["event"] == "coverage"]


def test_supervised_coverage_events_equal_reference(sup_runs, port_runs):
    (sup, jpath), (_, ref_path) = sup_runs["port"], sup_runs["ref"]
    assert not sup.interrupted
    assert sup.result.site_coverage == port_runs[True][1].site_coverage
    events = _cov_events(jpath)
    assert len(events) > 2
    assert events == _cov_events(ref_path)
    folded = coverage_from_events(read_journal(jpath))
    assert folded["sites"] == {k: v for k, v in
                               sup.result.site_coverage.items() if v}
    for e in events:  # cumulative counters: deltas only add
        assert all(d > 0 for d in e["delta"].values())


def test_supervised_saturation_signal(sup_runs):
    sat = [e for e in _cov_events(sup_runs["port"][1]) if e.get("saturated")]
    assert len(sat) == 1 and sat[0]["level"] > 0 and sat[0]["visited"] > 250
    ref = [e for e in _cov_events(sup_runs["ref"][1]) if e.get("saturated")]
    assert sat == ref


def test_sigterm_resume_coverage_continuity(tmp_path, port_runs):
    """checkpoint -> SIGTERM -> resume: one journal whose folded coverage
    equals the uninterrupted run's, no delta journaled twice."""
    sup1, jpath = _sup(tmp_path, "kill", faults=FaultPlan.parse("sigterm@2"))
    assert sup1.interrupted and not sup1.exhausted
    sup2, _ = _sup(tmp_path, "kill", resume=True)
    r = sup2.result
    assert (r.generated, r.distinct, r.depth) == FF_COUNTS
    assert r.site_coverage == port_runs[True][1].site_coverage
    events = read_journal(jpath)
    assert sum(1 for e in events if e["event"] == "run_resume") == 1
    folded = coverage_from_events(events)
    assert folded["sites"] == {k: v for k, v in r.site_coverage.items() if v}


# ---------------------------------------------------------------------------
# K8: the sticky overflow covers the coverage pair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("near_wrap", [False, True])
def test_ring_overflow_covers_the_coverage_pair(host_lib, near_wrap):
    """ring.cuh (g++) and ring_row_plain agree with a coverage pair, and a
    site counter whose uint32 view wraps sets the overflow word."""
    rng = np.random.default_rng(7 + int(near_wrap))
    n_labels, slots = 22, 4
    cols = tcnt.ring_cols(n_labels)
    ring0 = np.zeros((slots + 1, cols), np.int32)
    acts = rng.integers(100, 200, 2 * (n_labels + 1))
    cov_old = rng.integers(0, 50, 311)
    cov_old[40] = (1 << 32) - 5 if near_wrap else 1000
    cov_new = cov_old + rng.integers(0, 20, 311)
    cov_new[40] = cov_old[40] + 9  # wraps near 2^32
    a_gen = np.ascontiguousarray(acts[:n_labels + 1])
    a_dist = np.ascontiguousarray(acts[n_labels + 1:])
    host = ring0.copy()
    hb = np.array([2, 3, 700], np.int64)
    host_lib.host_ring_row(host.ctypes.data, slots, cols, hb.ctypes.data,
                           hb[1:].ctypes.data, hb[2:].ctypes.data, 64, 1, 5,
                           900, 800, 600, 500, 30, a_gen.ctypes.data,
                           a_dist.ctypes.data, acts.ctypes.data, None, None,
                           n_labels + 1, n_labels, cov_new.ctypes.data,
                           cov_old.ctypes.data, 311)
    ring = torch.from_numpy(ring0.copy())
    head, bodies, expanded = (torch.tensor(v) for v in (2, 3, 700))
    t = torch.tensor
    tcnt.ring_row_plain(ring, head, bodies, expanded, 64, True, t(5),
                        t(900), t(800), t(600), t(500), t(30),
                        torch.from_numpy(a_gen), torch.from_numpy(a_dist),
                        torch.from_numpy(acts), n_labels,
                        cov_new=torch.from_numpy(cov_new),
                        cov_old=torch.from_numpy(cov_old))
    assert (host == ring.numpy()).all()
    assert int(ring[2 % slots, tcnt.COL_OVERFLOW]) == int(near_wrap)
