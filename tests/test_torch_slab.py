"""Port sort-free insert (torchtlc.engine.fpset, slab path, on the CPU)
against jaxtlc.engine.fpset: the same batches give the same is_new_c,
c_idx and nreps position by position - the reference's slab layout, with
interspersed duplicate rows and sentinel padding - and the same TABLE
words; forced slab collisions, the sorted fallback and two slab passes
included.  The enqueue order of the slab layout is held against the
reference's (not new, lane) sort."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jaxtlc.engine import fpset as jfs
from torchtlc.engine import bfs as tb
from torchtlc.engine import fpset as tfs
from torchtlc.testing import one_thread

one_thread()


def _batch(rng, n, dup_values, invalid):
    base = rng.integers(0, 2**32, size=(dup_values, 2),
                        dtype=np.uint64).astype(np.uint32)
    pick = rng.integers(0, dup_values, size=n)
    return base[pick, 0], base[pick, 1], rng.random(n) >= invalid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# (n, R, table capacity, dup values, invalid fraction, slab_bits, passes):
# every case stays below the table's capacity over its 3 steps
CASES = {
    "bits3_collisions": (384, 384, 1 << 12, 192, 0.2, 3, 1),
    "default_slab": (384, 384, 1 << 12, 192, 0.2, 0, 1),
    "fallback_512_64": (512, 64, 1 << 12, 512, 0.0, 0, 1),
    "probe_width_below_n": (2048, 512, 1 << 13, 300, 0.1, 0, 1),
    "two_passes": (2048, 512, 1 << 13, 300, 0.1, 0, 2),
    "two_passes_bits6": (1024, 512, 1 << 13, 200, 0.1, 6, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_slab_insert_equals_reference_position_by_position(case):
    n, R, cap, dup, invalid, bits, passes = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    j_set, t_set = jfs.fpset_new(cap), tfs.fpset_new(cap, "cpu")
    fallbacks = 0
    for _ in range(3):
        lo, hi, m = _batch(rng, n, dup, invalid)
        j_set, a, b, c = jfs.fpset_insert_slab(
            j_set, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(m),
            probe_width=R, claim_width=R, slab_bits=bits, slab_passes=passes)
        t_set, x, y, z, fb = tfs.fpset_insert_slab(
            t_set, _t(lo), _t(hi), torch.from_numpy(m), probe_width=R,
            claim_width=R, slab_bits=bits, slab_passes=passes)
        fallbacks += fb
        assert int(c) == int(z)
        assert (np.asarray(a) == x.numpy()).all()
        assert (np.asarray(b) == y.numpy()).all()
        assert (np.asarray(j_set.table)
                == t_set.table.numpy().view(np.uint32)).all()
    assert (fallbacks == 3) == (case == "fallback_512_64")


@pytest.mark.parametrize("bits", [3, 0])
def test_slab_dedup_equals_reference(bits):
    """The ordered claimant slice itself: lanes, representative mask,
    fallback flag, and the ordered keys' words on the filled rows."""
    rng = np.random.default_rng(bits + 7)
    n, R = 600, 600
    lo, hi, m = _batch(rng, n, 250, 0.15)
    c_lo, c_hi, c_idx, active, fb = jfs.slab_dedup(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(m), probe_width=R,
        slab_bits=bits)
    s_key, t_idx, t_active, t_fb = tfs.slab_dedup(
        _t(lo), _t(hi), torch.from_numpy(m), probe_width=R, slab_bits=bits)
    assert bool(fb) == t_fb is False
    assert (np.asarray(c_idx) == t_idx.numpy()).all()
    assert (np.asarray(active) == t_active.numpy()).all()
    filled = t_idx.numpy() < n
    k_lo, k_hi = tfs.key_words(s_key)
    assert (np.asarray(c_lo)[filled] == k_lo.numpy()[filled]).all()
    assert (np.asarray(c_hi)[filled] == k_hi.numpy()[filled]).all()
    if bits == 3:  # the residue: duplicate rows interspersed
        assert not t_active.numpy()[filled].all()


def test_slab_dedup_fallback_equals_reference():
    """Claimants beyond R (an all-distinct batch): every one of the R rows
    is filled, the last row closes its group, and the fallback flag is
    set."""
    rng = np.random.default_rng(11)
    n, R = 600, 64
    lo, hi, m = _batch(rng, n, 1 << 20, 0.0)
    c_lo, c_hi, c_idx, active, fb = jfs.slab_dedup(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(m), probe_width=R)
    s_key, t_idx, t_active, t_fb = tfs.slab_dedup(
        _t(lo), _t(hi), torch.from_numpy(m), probe_width=R)
    assert bool(fb) and t_fb
    assert (np.asarray(c_idx) == t_idx.numpy()).all()
    assert (np.asarray(active) == t_active.numpy()).all()
    assert t_active.numpy()[-1]
    k_lo, k_hi = tfs.key_words(s_key)
    assert (np.asarray(c_lo) == k_lo.numpy()).all()
    assert (np.asarray(c_hi) == k_hi.numpy()).all()


def _reference_enqueue(is_new_c, c_idx, nreps, R):
    """jaxtlc/engine/bfs.py:472-490 in numpy: stable (not new, lane) sort
    over the first R rows (all rows when nreps > R), zero padding, and the
    gather's clamp of the sentinel lane."""
    ncand = len(is_new_c)
    k = ncand if (R >= ncand or nreps > R) else R
    order = np.lexsort((c_idx[:k], ~is_new_c[:k]))
    e = np.concatenate([c_idx[:k][order], np.zeros(ncand - k, np.int64)])
    return np.minimum(e, ncand - 1), int(is_new_c.sum())


@pytest.mark.parametrize("bits,R", [(3, 96), (0, 96), (0, 512)])
def test_enqueue_order_of_the_slab_layout(bits, R):
    rng = np.random.default_rng(R + bits)
    n = 512
    lo, hi, m = _batch(rng, n, 60, 0.3)
    _, is_new_c, c_idx, nreps, _ = tfs.fpset_insert_slab(
        tfs.fpset_new(1 << 12, "cpu"), _t(lo), _t(hi), torch.from_numpy(m),
        probe_width=R, claim_width=R, slab_bits=bits)
    e_idx, n_new = tb.enqueue_order(is_new_c, c_idx, nreps, R, slab=True)
    ref_e, ref_n = _reference_enqueue(is_new_c.numpy(), c_idx.numpy(),
                                      int(nreps), R)
    assert int(n_new) == ref_n
    assert (e_idx.numpy() == ref_e).all()


@pytest.mark.parametrize("sort_free", [False, True])
def test_insert_dedup_seam_equals_reference(sort_free):
    """The engine seam's one dispatch point, both modes."""
    rng = np.random.default_rng(31 + sort_free)
    j_set, t_set = jfs.fpset_new(1 << 12), tfs.fpset_new(1 << 12, "cpu")
    for _ in range(2):
        lo, hi, m = _batch(rng, 700, 300, 0.1)
        j_set, a, b, c = jfs.fpset_insert_dedup(
            j_set, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(m),
            probe_width=256, claim_width=256, sort_free=sort_free)
        t_set, x, y, z, fb = tfs.fpset_insert_dedup(
            t_set, _t(lo), _t(hi), torch.from_numpy(m), probe_width=256,
            claim_width=256, sort_free=sort_free)
        assert sort_free or not fb
        assert int(c) == int(z)
        assert (np.asarray(a) == x.numpy()).all()
        assert (np.asarray(b) == y.numpy()).all()
        assert (np.asarray(j_set.table)
                == t_set.table.numpy().view(np.uint32)).all()
