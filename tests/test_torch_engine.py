"""Port engine (torchtlc.engine.bfs, on the CPU) against jaxtlc.engine.bfs:
the FF full signature and every carry word, the interop round trip, the
seeded assert, the mode guards and the entry point.  Model_1 and two-tier
stepping are slow-marked.

One module fixture owns the FF engine builds of both packages."""

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
from jaxtlc.engine.fpset import fpset_actual_collision as j_fpset_actual_collision
from jaxtlc.spec import oracle
from jaxtlc.spec.codec import get_codec as j_get_codec
from torchtlc.config import MODEL_1, ModelConfig
from torchtlc.engine import bfs as tb
from torchtlc.engine.fpset import fpset_actual_collision
from torchtlc.engine.interop import FIELDS, carry_from_numpy, carry_to_numpy

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the pinned digests)
from mc_expect import MC_OUT_ACTIONS, MC_OUT_COUNTS  # noqa: E402
from torchtlc.testing import one_thread  # noqa: E402

one_thread()

FF, J_FF = ModelConfig(False, False), JConfig(False, False)
KW = dict(chunk=256, queue_capacity=1 << 13, fp_capacity=1 << 15)
MODES = dict(sort_free=False, deferred=False)


def _full_signature(r):
    return (r.generated, r.distinct, r.depth, r.violation, r.queue_left,
            tuple(sorted(r.action_generated.items())),
            tuple(sorted(r.action_distinct.items())),
            r.outdegree, r.fp_occupancy, r.actual_fp_collision)


def _jax_np(c) -> dict:
    return {f: np.asarray(c.fps.table if f == "fps" else getattr(c, f))
            for f in FIELDS}


def _assert_words_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for f in a:
        assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
        assert (a[f] == b[f]).all(), f


def _sha(table_u32: np.ndarray) -> str:
    return hashlib.sha256(table_u32.astype("<u4").tobytes()).hexdigest()


@pytest.fixture(scope="module")
def ff_runs():
    j_init, j_run, j_step = jb.make_engine(J_FF, donate=False, **MODES, **KW)
    jc = jax.block_until_ready(j_run(j_init()))
    t_init, t_run, t_step = tb.make_engine(FF, device="cpu", **MODES, **KW)
    tc = t_run(t_init())
    return dict(jc=jc, tc=tc, j_init=j_init, j_step=j_step, t_step=t_step)


def test_ff_full_signature_equals_reference(ff_runs):
    jc, tc = ff_runs["jc"], ff_runs["tc"]
    jr = jb.result_from_carry(jc, 0.0, fp_capacity=KW["fp_capacity"])._replace(
        actual_fp_collision=float(j_fpset_actual_collision(jc.fps)))
    tr = tb.result_from_carry(tc, 0.0, fp_capacity=KW["fp_capacity"])._replace(
        actual_fp_collision=fpset_actual_collision(tc.fps))
    assert (tr.generated, tr.distinct, tr.depth) == (17020, 8203, 109)
    assert tr.outdegree == (1, 0, 2, 2)
    assert _full_signature(tr) == _full_signature(jr)
    assert (tc.fps.table.numpy().view(np.uint32)
            == np.asarray(jc.fps.table)).all()


def test_ff_every_carry_word_equals_reference(ff_runs):
    _assert_words_equal(carry_to_numpy(ff_runs["tc"]), _jax_np(ff_runs["jc"]))


def test_ff_table_digest_is_the_chip_smoke_pin(ff_runs):
    assert _sha(np.asarray(ff_runs["jc"].fps.table)) == chip_smoke.FF_TABLE_SHA256
    assert (_sha(ff_runs["tc"].fps.table.numpy().view(np.uint32))
            == chip_smoke.FF_TABLE_SHA256)


@pytest.mark.parametrize("k", [0, 37, 150])
def test_interop_one_more_step_is_word_equal(ff_runs, k):
    """A reference carry after k steps, converted, then one step of each
    engine: word-equal carries."""
    jc = ff_runs["j_init"]()
    for _ in range(k):
        jc = ff_runs["j_step"](jc)
    d = _jax_np(jc)
    tc = carry_from_numpy(d, device="cpu")
    _assert_words_equal(carry_to_numpy(tc), d)
    _assert_words_equal(carry_to_numpy(ff_runs["t_step"](tc)),
                        _jax_np(ff_runs["j_step"](jc)))


def test_seeded_assert_gives_same_violation_state_and_action():
    """Start from a state poised to fail the C2 assert (KubeAPI.tla:196):
    both engines halt with VIOL_ASSERT on the same state and action, with
    word-equal carries."""
    kw = dict(chunk=64, queue_capacity=1 << 10, fp_capacity=1 << 12)
    s0 = oracle.initial_states(J_MODEL_1)[1]
    bad = s0._replace(pc=("C2", "PVCStart", "APIStart"))
    cdc = j_get_codec(J_MODEL_1)
    packed = np.asarray(jax.jit(cdc.pack)(jnp.asarray(cdc.encode(bad))))
    j_init, j_run, _ = jb.make_engine(J_MODEL_1, donate=False, **MODES, **kw)
    jc = j_init()
    queue = np.array(jc.queue)
    queue[0, 0] = packed
    queue[0, 1] = packed
    jc = j_run(jc._replace(queue=jnp.asarray(queue)))
    t_init, t_run, _ = tb.make_engine(MODEL_1, device="cpu", **MODES, **kw)
    tc = t_init()
    tc.queue[0, :2] = torch.from_numpy(packed.view(np.int32))
    tc = t_run(tc)
    assert int(tc.viol) == tb.VIOL_ASSERT == int(jc.viol)
    assert (tc.viol_state.numpy() == np.asarray(jc.viol_state)).all()
    assert int(tc.viol_action) == int(jc.viol_action)
    _assert_words_equal(carry_to_numpy(tc), _jax_np(jc))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.make_engine(FF, **MODES, **KW)


def test_entry_steps_like_the_reference_entry():
    """torchtlc.entry.entry() has the shape of __graft_entry__.entry():
    (step_fn, (carry,)); three steps give word-equal carries."""
    import __graft_entry__
    from torchtlc.entry import dryrun_multichip, entry

    step, (carry,) = entry(device="cpu")
    j_step, (jc,) = __graft_entry__.entry()
    for _ in range(3):
        carry, jc = step(carry), j_step(jc)
    _assert_words_equal(carry_to_numpy(carry), _jax_np(jc))
    with pytest.raises(NotImplementedError):
        dryrun_multichip(2)


@pytest.mark.slow
def test_two_tier_stepping_ff_chunk_16384():
    kw = dict(chunk=1 << 14, queue_capacity=1 << 14, fp_capacity=1 << 16)
    j_init, j_run, _ = jb.make_engine(J_FF, donate=False, **MODES, **kw)
    jc = jax.block_until_ready(j_run(j_init()))
    t_init, t_run, _ = tb.make_engine(FF, device="cpu", **MODES, **kw)
    tc = t_run(t_init())
    assert (int(tc.generated), int(tc.distinct), int(tc.depth)) == (
        17020, 8203, 109)
    _assert_words_equal(carry_to_numpy(tc), _jax_np(jc))


@pytest.mark.slow
def test_model1_default_modes_at_2048_match_the_chip_smoke_pin():
    """Model_1 at chip_smoke's chunk-2048 geometry with default modes
    (sort-free slab + deferred invariants): MC.out counts, outdegree and
    per-action generated counts; the per-action distinct counts and table
    words equal the reference engine's in the same modes, whose digest
    chip_smoke.py pins."""
    kw = chip_smoke.M1_2048_KW
    t_init, t_run, _ = tb.make_engine(MODEL_1, device="cpu", **kw)
    tc = t_run(t_init())
    r = tb.result_from_carry(tc, 0.0, fp_capacity=kw["fp_capacity"])
    assert (r.generated, r.distinct, r.depth) == MC_OUT_COUNTS
    assert r.outdegree == (1, 0, 4, 2) and r.violation == 0
    assert r.action_generated == {a: g for a, (_, g) in MC_OUT_ACTIONS.items()}
    assert r.action_distinct == chip_smoke.M1_2048_DISTINCT
    assert t_run.steps_by_width == {2048: t_run.steps}
    j_init, j_run, _ = jb.make_engine(J_MODEL_1, donate=False, **kw)
    jc = jax.block_until_ready(j_run(j_init()))
    assert _sha(np.asarray(jc.fps.table)) == chip_smoke.M1_2048_TABLE_SHA256
    jr = jb.result_from_carry(jc, 0.0)
    assert jr.action_distinct == chip_smoke.M1_2048_DISTINCT
    _assert_words_equal(carry_to_numpy(tc), _jax_np(jc))


@pytest.mark.slow
def test_model1_matches_mc_out_and_the_chip_smoke_pin():
    """Model_1 at chip_smoke's geometry: MC.out counts, outdegree and
    per-action generated counts; table words equal to the reference
    engine's, whose digest chip_smoke.py pins."""
    kw = chip_smoke.M1_KW
    t_init, t_run, _ = tb.make_engine(MODEL_1, device="cpu", **MODES, **kw)
    tc = t_run(t_init())
    r = tb.result_from_carry(tc, 0.0, fp_capacity=kw["fp_capacity"])
    assert (r.generated, r.distinct, r.depth) == MC_OUT_COUNTS
    assert r.outdegree == (1, 0, 4, 2) and r.violation == 0
    assert r.action_generated == {a: g for a, (_, g) in MC_OUT_ACTIONS.items()}
    assert r.action_distinct == chip_smoke.M1_DISTINCT
    j_init, j_run, _ = jb.make_engine(J_MODEL_1, donate=False, **MODES, **kw)
    jc = jax.block_until_ready(j_run(j_init()))
    assert _sha(np.asarray(jc.fps.table)) == chip_smoke.M1_TABLE_SHA256
    _assert_words_equal(carry_to_numpy(tc), _jax_np(jc))
