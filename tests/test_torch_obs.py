"""Whole-engine parity in the production modes: the port (on the CPU)
against jaxtlc.engine.bfs with the sort-free slab dedup, deferred
invariants and the counter ring on - every carry leaf word-equal, queue
tail and ring included, and the same decoded ring rows - plus the auto
mode resolution at chunk 2048 and the ring functions on counters that
wrap their uint32 view.

One module fixture owns the engine builds of both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.engine import bfs as jb
from jaxtlc.obs import counters as jcnt
from torchtlc.config import ModelConfig
from torchtlc.engine import bfs as tb
from torchtlc.engine.interop import (
    FIELDS, OBS_FIELDS, carry_from_numpy, carry_to_numpy,
)
from torchtlc.obs import counters as tcnt
from torchtlc.spec.labels import LABELS

FF, J_FF = ModelConfig(False, False), JConfig(False, False)
GEO = dict(queue_capacity=1 << 13, fp_capacity=1 << 15)
RUNS = {
    "slab_deferred_obs256": dict(chunk=256, sort_free=True, deferred=True,
                                 obs_slots=256),
    "slab_deferred_obs4_wraps": dict(chunk=256, sort_free=True,
                                     deferred=True, obs_slots=4),
    "auto_at_2048": dict(chunk=2048),
}


def _jax_np(c, fields) -> dict:
    return {f: np.asarray(c.fps.table if f == "fps" else getattr(c, f))
            for f in fields}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, kw in RUNS.items():
        j_init, j_run, j_step = jb.make_engine(J_FF, donate=False, **kw,
                                               **GEO)
        jc = jax.block_until_ready(j_run(j_init()))
        t_init, t_run, t_step = tb.make_engine(FF, device="cpu", **kw, **GEO)
        tc = t_run(t_init())
        out[name] = dict(jc=jc, tc=tc, j_init=j_init, j_step=j_step,
                         t_step=t_step, t_run=t_run)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_every_carry_leaf_equals_reference(runs, name):
    r = runs[name]
    fields = FIELDS + (OBS_FIELDS if RUNS[name].get("obs_slots") else ())
    got = carry_to_numpy(r["tc"])
    ref = _jax_np(r["jc"], fields)
    assert set(got) == set(ref)
    for f in ref:
        assert got[f].dtype == ref[f].dtype and got[f].shape == ref[f].shape
        assert (got[f] == ref[f]).all(), f
    assert (int(r["tc"].generated), int(r["tc"].distinct),
            int(r["tc"].depth)) == (17020, 8203, 109)


@pytest.mark.parametrize("name", ["slab_deferred_obs256",
                                  "slab_deferred_obs4_wraps"])
def test_obs_rows_equal_reference(runs, name):
    r = runs[name]
    for since in (0, 50, 108):
        got = tb.obs_rows(r["tc"], labels=LABELS, since=since,
                          fp_capacity=GEO["fp_capacity"])
        ref = jb.obs_rows(r["jc"], labels=jb.LABELS, since=since,
                          fp_capacity=GEO["fp_capacity"])
        assert got == ref
    rows, head = got
    assert head == 109  # one row per level flip: every level, the last too
    last = rows[-1]
    assert (last["generated"], last["distinct"]) == (17020, 8203)
    if RUNS[name]["obs_slots"] == 4:
        assert len(tb.obs_rows(r["tc"])[0]) == 4  # the ring wrapped


def test_obs_off_has_no_rows(runs):
    assert tb.obs_rows(runs["auto_at_2048"]["tc"], since=3) == ([], 3)


@pytest.mark.parametrize("k", [0, 41])
def test_interop_step_with_ring_is_word_equal(runs, k):
    """A reference carry with a ring, converted, then one step of each
    engine: word-equal carries, ring words included."""
    r = runs["slab_deferred_obs4_wraps"]
    fields = FIELDS + OBS_FIELDS
    jc = r["j_init"]()
    for _ in range(k):
        jc = r["j_step"](jc)
    d = _jax_np(jc, fields)
    tc = carry_from_numpy(d, device="cpu")
    assert set(carry_to_numpy(tc)) == set(d)
    got = carry_to_numpy(r["t_step"](tc))
    ref = _jax_np(r["j_step"](jc), fields)
    for f in fields:
        assert (got[f] == ref[f]).all(), f


@pytest.mark.parametrize("chunk", [1, 256, 2047, 2048, 4096, 131072])
@pytest.mark.parametrize("flag", [None, True, False])
def test_mode_resolution_equals_reference(chunk, flag):
    assert tb.resolve_sort_free(flag, chunk) == jb.resolve_sort_free(flag,
                                                                     chunk)
    assert tb.resolve_deferred(flag, chunk) == jb.resolve_deferred(flag,
                                                                   chunk)


def test_auto_at_2048_ran_both_modes(runs):
    """The default-mode engine at chunk 2048 ran the slab path (it counts
    its sorted fallbacks per body width) and the deferred check."""
    assert tb._resolve_modes(2048, None, None, False) == (True, True)
    assert tb._resolve_modes(1024, None, None, False) == (False, False)
    assert runs["auto_at_2048"]["t_run"].slab_fallbacks == {2048: 0}
    assert runs["auto_at_2048"]["t_run"].steps_by_width == {2048: 109}


def _counters(rng, n_acts, near_wrap):
    base = (1 << 32) - 40 if near_wrap else 1000
    old = torch.from_numpy(rng.integers(base, base + 30, n_acts))
    new = old + torch.from_numpy(rng.integers(0, 25, n_acts))
    return old, new


@pytest.mark.parametrize("near_wrap,flip,prior_flag", [
    (False, True, False), (True, True, False), (False, False, True),
    (True, False, False),
])
def test_ring_row_equals_reference_functions(near_wrap, flip, prior_flag):
    """ring_row_plain against the reference's pack_row, sticky_overflow,
    wrapped_any and ring_update on counters whose uint32 view wraps (or
    not), on a flip and a dump-row body, with and without an earlier
    overflow row."""
    rng = np.random.default_rng(int(near_wrap) * 4 + int(flip) * 2
                                + int(prior_flag))
    n_labels, slots = len(LABELS), 5
    cols = tcnt.ring_cols(n_labels)
    ring0 = rng.integers(0, 2**32, (slots + 1, cols),
                         dtype=np.uint64).astype(np.uint32)
    ring0[:, tcnt.COL_OVERFLOW] = 0
    if prior_flag:
        ring0[2, tcnt.COL_OVERFLOW] = 1
    gen_old, gen_new = _counters(rng, 1, near_wrap)
    act_old, act_new = _counters(rng, 2 * (n_labels + 1), near_wrap)
    level, queue_n, bodies, expanded, n_pop, head = 7, 99, 41, 5000, 64, 9

    ring = torch.from_numpy(ring0.view(np.int32).copy())
    t_head = torch.tensor(head)
    t_b, t_e = torch.tensor(bodies), torch.tensor(expanded)
    act_gen, act_dist = act_new[:n_labels + 1], act_new[n_labels + 1:]
    tcnt.ring_row_plain(
        ring, t_head, t_b, t_e, n_pop, flip, torch.tensor(level),
        gen_new[0], gen_old[0], gen_new[0] + 3, gen_old[0] + 3,
        torch.tensor(queue_n), act_gen, act_dist, act_old, n_labels)

    u32 = jnp.uint32

    def j(v):
        return jnp.asarray(np.asarray(v, np.int64) & 0xFFFFFFFF, u32)

    jn = {k: j(v) for k, v in dict(
        gen_new=gen_new[0], gen_old=gen_old[0], act_gen=act_gen,
        act_dist=act_dist, act_old=act_old).items()}
    pairs = [(jn["gen_new"], jn["gen_old"]),
             (j(gen_new[0] + 3), j(gen_old[0] + 3)),
             (jn["act_gen"], jn["act_old"][:n_labels + 1]),
             (jn["act_dist"], jn["act_old"][n_labels + 1:]),
             (j(bodies + 1), j(bodies)), (j(expanded + n_pop), j(expanded))]
    row = jcnt.pack_row(
        jnp.int32(level), jn["gen_new"], j(gen_new[0] + 3), jnp.int32(queue_n),
        j(bodies + 1), j(expanded + n_pop), jn["act_gen"][:n_labels],
        jn["act_dist"][:n_labels],
        overflow=jcnt.sticky_overflow(jnp.asarray(ring0),
                                      jcnt.wrapped_any(pairs)))
    j_ring, j_head = jcnt.ring_update(jnp.asarray(ring0), jnp.int32(head),
                                      row, jnp.bool_(flip))
    assert (ring.numpy().view(np.uint32) == np.asarray(j_ring)).all()
    assert int(t_head) == int(j_head)
    assert (int(t_b), int(t_e)) == (bodies + 1, expanded + n_pop)
    over = ring.numpy().view(np.uint32)[head % slots if flip else slots,
                                        tcnt.COL_OVERFLOW]
    assert over == int(near_wrap or prior_flag)
