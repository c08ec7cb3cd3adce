"""The port's pipelined engine (torchtlc.engine.bfs, pipeline=True, on the
CPU) against jaxtlc's pipelined engine on the FF corner at chunk 256:
every carry word - the staged block included - equal after every body in
the four mode pairs (sorted or slab dedup x immediate or deferred
invariants, the coverage plane and the counter ring on in one of them);
the port's pipelined run equal to its unpipelined run (full signature and
table words).  At chunk 256 every FF level is one pop, so the expansion
from the pre-commit carry (a body inside a level) runs at chunk 64: a
reference carry taken at a mid-level body and at a level flip, one body
further in the port, word-equal, and the whole run's final carry too.
Then a seeded assert, and Model_1 against its pins (20 s on one thread,
so not slow-marked).
"""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jaxtlc.config import MODEL_1 as J_MODEL_1, ModelConfig as JConfig
from jaxtlc.engine import bfs as jb
from jaxtlc.spec import oracle
from jaxtlc.spec.codec import get_codec as j_get_codec
from torchtlc.config import MODEL_1, ModelConfig
from torchtlc.engine import bfs as tb
from torchtlc.engine.fpset import fpset_actual_collision
from torchtlc.engine.interop import LEAF_ORDER, carry_from_numpy, carry_to_numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the pinned digests)
from mc_expect import MC_OUT_ACTIONS, MC_OUT_COUNTS  # noqa: E402
from torchtlc.testing import one_thread  # noqa: E402

one_thread()

FF, J_FF = ModelConfig(False, False), JConfig(False, False)
KW = dict(chunk=256, queue_capacity=1 << 13, fp_capacity=1 << 15)
OBS = 16
# (sort_free, deferred, coverage + ring)
MODE_PAIRS = [(False, False, False), (True, False, False),
              (False, True, False), (True, True, True)]
MODE_IDS = ["sorted-immediate", "slab-immediate", "sorted-deferred",
            "slab-deferred-coverage-ring"]


def _kw(sort_free, deferred, extras):
    kw = dict(KW, sort_free=sort_free, deferred=deferred)
    if extras:
        kw.update(coverage=True, obs_slots=OBS)
    return kw


def _ref_np(jc) -> dict:
    """A reference carry's leaves (LEAF_ORDER names present) as numpy."""
    out = {}
    for f in LEAF_ORDER:
        v = jc.fps.table if f == "fps" else getattr(jc, f, None)
        if v is not None:
            out[f] = np.asarray(v)
    return out


def _port_np(tc, deferred) -> dict:
    return carry_to_numpy(tc, cfg=FF, deferred=deferred)


def _assert_words_equal(a: dict, b: dict, where=""):
    assert set(a) == set(b), (where, set(a) ^ set(b))
    for f in a:
        assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, (
            where, f)
        assert (a[f] == b[f]).all(), (where, f)


def _sha(table_u32: np.ndarray) -> str:
    return hashlib.sha256(table_u32.astype("<u4").tobytes()).hexdigest()


def _full_signature(r):
    return (r.generated, r.distinct, r.depth, r.violation, r.queue_left,
            tuple(sorted(r.action_generated.items())),
            tuple(sorted(r.action_distinct.items())),
            r.outdegree, r.fp_occupancy, r.actual_fp_collision)


@pytest.fixture(scope="module")
def engines():
    """Both packages' pipelined FF engines per mode pair, built once."""
    out = {}
    for (sf, de, ex), name in zip(MODE_PAIRS, MODE_IDS):
        kw = _kw(sf, de, ex)
        out[name] = dict(
            ref=jb.make_engine(J_FF, pipeline=True, donate=False, **kw),
            port=tb.make_engine(FF, pipeline=True, device="cpu", **kw),
            deferred=de)
    return out


@pytest.fixture(scope="module")
def stepped(engines):
    """Step both engines body by body to the end, comparing every carry
    word after every body; keep the reference's carries and the port's
    final carry."""
    runs = {}
    for name, e in engines.items():
        j_init, _, j_step = e["ref"]
        t_init, _, t_step = e["port"]
        jc, tc = j_init(), t_init()
        ref_carries = [jc]
        mismatch = None
        _assert_words_equal(_port_np(tc, e["deferred"]), _ref_np(jc), 0)
        while not tb.carry_done(tc):
            jc, tc = j_step(jc), t_step(tc)
            ref_carries.append(jc)
            try:
                _assert_words_equal(_port_np(tc, e["deferred"]), _ref_np(jc),
                                    len(ref_carries) - 1)
            except AssertionError as err:
                mismatch = err
                break
        runs[name] = dict(ref=ref_carries, tc=tc, mismatch=mismatch,
                          done=jb.carry_done(jc))
    return runs


@pytest.mark.parametrize("mode", MODE_IDS)
def test_every_body_word_equal_to_reference(stepped, mode):
    r = stepped[mode]
    assert r["mismatch"] is None, r["mismatch"]
    assert r["done"]
    tc = r["tc"]
    assert (int(tc.generated), int(tc.distinct), int(tc.depth)) == (
        17020, 8203, 109)
    # the final body staged the empty pop of the exhausted level
    assert int(tc.st_n) == 0 and int(tc.viol) == tb.OK


def test_staged_block_is_carried(stepped):
    """Mid-run carries hold a non-empty staged block (the leaves the
    comparison covers are not all zero)."""
    ref = stepped["slab-deferred-coverage-ring"]["ref"]
    assert max(int(c.st_n) for c in ref) > 0
    assert any(int(np.asarray(c.st_valid).sum()) for c in ref)
    assert any(np.asarray(c.st_cov).any() for c in ref)


@pytest.mark.parametrize("sort_free", [False, True], ids=["sorted", "slab"])
def test_pipelined_equals_unpipelined(sort_free):
    """Below the two-tier threshold the pipelined run pops the same
    blocks: full signature and table words equal the unpipelined run's."""
    results, tables = [], []
    for pipeline in (False, True):
        init_fn, run_fn, _ = tb.make_engine(
            FF, pipeline=pipeline, device="cpu", sort_free=sort_free,
            deferred=sort_free, **KW)
        c = run_fn(init_fn())
        results.append(tb.result_from_carry(
            c, 0.0, fp_capacity=KW["fp_capacity"])._replace(
                actual_fp_collision=fpset_actual_collision(c.fps)))
        tables.append(c.fps.table.numpy())
        if pipeline:  # single-tier: every body at the full width
            assert run_fn.steps_by_width == {KW["chunk"]: run_fn.steps}
    assert _full_signature(results[0]) == _full_signature(results[1])
    assert (tables[0] == tables[1]).all()
    if not sort_free:
        assert (_sha(tables[1].view(np.uint32))
                == chip_smoke.FF_TABLE_SHA256)


SEAM_MODES = {"sorted-immediate": MODE_PAIRS[0],
              "slab-deferred-coverage-ring": MODE_PAIRS[3]}


@pytest.fixture(scope="module")
def seam_runs():
    """Per seam mode at chunk 64: the reference's carries body by body,
    the port's engine, and both packages' final carries of a whole run."""
    out = {}
    for name, (sf, de, ex) in SEAM_MODES.items():
        kw = dict(_kw(sf, de, ex), chunk=64)
        _, _, j_step = ref = jb.make_engine(J_FF, pipeline=True,
                                            donate=False, **kw)
        port = tb.make_engine(FF, pipeline=True, device="cpu", **kw)
        carries = [ref[0]()]
        while not jb.carry_done(carries[-1]):
            carries.append(j_step(carries[-1]))
        out[name] = dict(ref=carries, port=port, deferred=de,
                         final=port[1](port[0]()))
    return out


def _seam_bodies(carries):
    """(mid-level body, flip body): indices k of reference carries whose
    next body commits a staged block inside a level, and at a level flip
    (the staged block was the level's last pop)."""
    mid = next(k for k, c in enumerate(carries)
               if int(c.st_n) > 0 and int(c.qhead) < int(c.level_n)
               and int(c.qhead) > int(c.st_n))
    flip = next(k for k, c in enumerate(carries)
                if k > mid and int(c.st_n) > 0
                and int(c.qhead) >= int(c.level_n))
    return mid, flip


@pytest.mark.parametrize("at", ["mid-level", "flip"])
@pytest.mark.parametrize("mode", list(SEAM_MODES))
def test_reference_carry_one_more_body(seam_runs, mode, at):
    """A reference pipelined carry converted into the port, then one body
    of each engine: word-equal carries (the deferred checker reads the
    staged rows from the converted queue, across a flip too)."""
    r = seam_runs[mode]
    carries = r["ref"]
    k = _seam_bodies(carries)[at == "flip"]
    d = _ref_np(carries[k])
    tc = carry_from_numpy(d, device="cpu", cfg=FF)
    _assert_words_equal(_port_np(tc, r["deferred"]), d)
    _, _, t_step = r["port"]
    _assert_words_equal(_port_np(t_step(tc), r["deferred"]),
                        _ref_np(carries[k + 1]))


@pytest.mark.parametrize("mode", list(SEAM_MODES))
def test_multi_pop_levels_final_carry_equals_reference(seam_runs, mode):
    """The whole run at chunk 64, where levels take several pops: the
    final carries are word-equal."""
    r = seam_runs[mode]
    assert int(r["final"].distinct) == 8203
    _assert_words_equal(_port_np(r["final"], r["deferred"]),
                        _ref_np(r["ref"][-1]))


def test_seeded_assert_pipelined_equals_reference():
    """A frontier poised to fail the C2 assert (KubeAPI.tla:196): both
    pipelined engines halt with VIOL_ASSERT on the same state and action,
    with word-equal carries (the staged violation state included)."""
    kw = dict(chunk=64, queue_capacity=1 << 10, fp_capacity=1 << 12,
              sort_free=False, deferred=False)
    s0 = oracle.initial_states(J_MODEL_1)[1]
    bad = s0._replace(pc=("C2", "PVCStart", "APIStart"))
    cdc = j_get_codec(J_MODEL_1)
    packed = np.asarray(jax.jit(cdc.pack)(jnp.asarray(cdc.encode(bad))))
    j_init, j_run, _ = jb.make_engine(J_MODEL_1, pipeline=True,
                                      donate=False, **kw)
    jc = j_init()
    queue = np.array(jc.queue)
    queue[0, :2] = packed
    jc = j_run(jc._replace(queue=jnp.asarray(queue)))
    t_init, t_run, _ = tb.make_engine(MODEL_1, pipeline=True, device="cpu",
                                      **kw)
    tc = t_init()
    tc.queue[0, :2] = torch.from_numpy(packed.view(np.int32).copy())
    tc = t_run(tc)
    assert int(tc.viol) == tb.VIOL_ASSERT == int(jc.viol)
    assert (tc.viol_state.numpy() == np.asarray(jc.viol_state)).all()
    assert int(tc.viol_action) == int(jc.viol_action)
    d = carry_to_numpy(tc, cfg=MODEL_1)
    _assert_words_equal(d, _ref_np(jc))
    r = tb.result_from_carry(tc, 0.0)
    assert r.queue_left == (int(tc.level_n) - int(tc.qhead) + int(tc.next_n)
                            + int(tc.st_n))


def test_device_none_is_the_card():
    """pipeline=True, like every entry point, runs on the card unless the
    CPU is named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.make_engine(FF, pipeline=True, **KW)


def test_model1_pipelined_matches_the_pins():
    """Model_1 pipelined at chip_smoke's chunk-1024 sorted geometry: MC.out
    counts, outdegree and per-action counts, and the unpipelined run's
    table words (chip_smoke.py's pin); the reference's pipelined carry
    word for word."""
    kw = dict(chip_smoke.M1_KW, sort_free=False, deferred=False)
    t_init, t_run, _ = tb.make_engine(MODEL_1, pipeline=True, device="cpu",
                                      **kw)
    tc = t_run(t_init())
    r = tb.result_from_carry(tc, 0.0, fp_capacity=kw["fp_capacity"])
    assert (r.generated, r.distinct, r.depth) == MC_OUT_COUNTS
    assert r.outdegree == (1, 0, 4, 2) and r.violation == 0
    assert r.action_generated == {a: g for a, (_, g) in MC_OUT_ACTIONS.items()}
    assert r.action_distinct == chip_smoke.M1_DISTINCT
    assert (_sha(tc.fps.table.numpy().view(np.uint32))
            == chip_smoke.M1_TABLE_SHA256)
    j_init, j_run, _ = jb.make_engine(J_MODEL_1, pipeline=True, donate=False,
                                      **kw)
    jc = jax.block_until_ready(j_run(j_init()))
    _assert_words_equal(carry_to_numpy(tc, cfg=MODEL_1), _ref_np(jc))


def test_migrated_carry_leaves_equal_but_st_flat_past_the_pop():
    """A regrow migrates the staged block verbatim in both packages; the
    migrated queues keep only the level's rows.  Every leaf of the two
    migrated carries is equal except st_flat, which the reference carries
    over from the old queue and the port derives from the new one: it
    differs only on lanes of the pop window's rows st_n and later,
    disabled lanes no checker reads (ROADMAP Queue C item 4)."""
    from jaxtlc.resil import regrow as jr
    from torchtlc.resil import regrow as tr

    kw = dict(chunk=64, queue_capacity=1 << 12, fp_capacity=1 << 14,
              sort_free=True, deferred=True)
    j_init, _, j_step = jb.make_engine(J_FF, pipeline=True, donate=False,
                                       **kw)
    t_init, _, t_step = tb.make_engine(FF, pipeline=True, device="cpu", **kw)
    jc, tc = j_init(), t_init()
    for _ in range(150):
        jc, tc = j_step(jc), t_step(tc)
    old = dict(queue_capacity=1 << 12, fp_capacity=1 << 14)
    new = dict(queue_capacity=1 << 13, fp_capacity=1 << 15)
    mine = _port_np(tr.migrate_engine_carry(tc, old, new), True)
    ref = _ref_np(jr.migrate_engine_carry(jc, old, new))
    flat_m, flat_r = mine.pop("st_flat"), ref.pop("st_flat")
    _assert_words_equal(mine, ref)
    L = flat_m.shape[0] // kw["chunk"]
    st_n = int(tc.st_n)
    assert 0 < st_n < kw["chunk"]
    assert (flat_m[:st_n * L] == flat_r[:st_n * L]).all()
    rows = np.flatnonzero((flat_m != flat_r).any(1))
    assert rows.size and rows.min() >= st_n * L
    assert not mine["st_valid"][rows].any()
