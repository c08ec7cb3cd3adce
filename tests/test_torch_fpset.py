"""Port fingerprint set (torchtlc.engine.fpset, sorted path) against
jaxtlc.engine.fpset.fpset_insert_sorted: the same insert sequences give the
same is_new_c, c_idx, nreps and TABLE words, at the same probe and claim
widths."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jaxtlc.engine import fpset as jfs
from torchtlc.engine import fpset as tfs
from torchtlc.testing import one_thread

one_thread()


def _batch(rng, n, n_values=None, invalid=0.0):
    """n fingerprints: n random values, or n draws from n_values random
    values (in-batch duplicates); a fraction masked off."""
    lo = rng.integers(0, 2**32, n_values or n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, n_values or n, dtype=np.uint64).astype(np.uint32)
    if n_values:
        pick = rng.integers(0, n_values, n)
        lo, hi = lo[pick], hi[pick]
    return lo, hi, rng.random(n) >= invalid


def _insert_both(j_set, t_set, batch, R=0, C=0):
    lo, hi, m = batch
    j_set, a, b, c = jfs.fpset_insert_sorted(
        j_set, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(m),
        probe_width=R, claim_width=C)
    t_set, x, y, z = tfs.fpset_insert_sorted(
        t_set, torch.from_numpy(lo.view(np.int32)),
        torch.from_numpy(hi.view(np.int32)), torch.from_numpy(m),
        probe_width=R, claim_width=C)
    assert int(c) == int(z)
    assert (np.asarray(a) == x.numpy()).all()
    assert (np.asarray(b) == y.numpy()).all()
    assert (np.asarray(j_set.table) == t_set.table.numpy().view(np.uint32)).all()
    return j_set, t_set, int(z)


def _stragglers(table, batch, R, C):
    """Stragglers round 0 leaves in the first probe segment of `batch`."""
    lo, hi, m = batch
    key = tfs.fpset_key_plain(torch.from_numpy(lo.view(np.int32)),
                              torch.from_numpy(hi.view(np.int32)),
                              torch.from_numpy(m))
    c_key, _, nreps = tfs.dedup_compact(key)
    n = min(R or len(lo), len(lo))
    active = torch.arange(n) < int(nreps)
    slot = tfs.fpset_round0_plain(table.clone(), c_key[:n], active)
    _, pending = tfs.fpset_claim_plain(table.clone(), c_key[:n], slot,
                                       min(C or n, n))
    return int(pending.sum())


@pytest.mark.parametrize("cap,rounds,n,n_values,invalid,R,C", [
    (1 << 10, 3, 300, 200, 0.1, 0, 0),  # small table, duplicates, masking
    (1 << 12, 2, 1400, None, 0.0, 0, 0),  # 0.68 load: straggler walks
    (1 << 12, 3, 1000, 800, 0.2, 256, 128),  # segment loop, narrow claims
], ids=["dups", "load068", "segments"])
def test_insert_sequences_equal_reference(cap, rounds, n, n_values, invalid,
                                          R, C):
    rng = np.random.default_rng(cap + n)
    j_set, t_set = jfs.fpset_new(cap), tfs.fpset_new(cap, "cpu")
    for _ in range(rounds):
        j_set, t_set, nreps = _insert_both(
            j_set, t_set, _batch(rng, n, n_values, invalid), R, C)
    load = int(tfs.fpset_count(t_set)) / cap
    assert load == float(jfs.fpset_count(j_set)) / cap
    if R:
        assert nreps > R  # the segment loop ran
    if cap == 1 << 12 and not R:
        assert load >= 0.68


def test_in_batch_duplicates_resolve_to_highest_lane():
    rng = np.random.default_rng(5)
    lo, hi, m = _batch(rng, 64, 16)
    j_set, t_set, nreps = _insert_both(jfs.fpset_new(1 << 10),
                                       tfs.fpset_new(1 << 10, "cpu"),
                                       (lo, hi, m))
    _, is_new, c_idx, _ = tfs.fpset_insert_sorted(
        tfs.fpset_new(1 << 10, "cpu"), torch.from_numpy(lo.view(np.int32)),
        torch.from_numpy(hi.view(np.int32)), torch.from_numpy(m))
    pairs = list(zip(lo.tolist(), hi.tolist()))
    for j in range(nreps):
        lane = int(c_idx[j])
        assert bool(is_new[j])
        assert max(i for i, p in enumerate(pairs) if p == pairs[lane]) == lane


def test_more_than_2048_stragglers():
    """A claim width of 64 leaves the other ~5000 fitting claimants of one
    6000-wide segment to the walk: three walk slices of S = 2048."""
    rng = np.random.default_rng(9)
    batch = _batch(rng, 6000, 4000)
    assert _stragglers(tfs.fpset_new(1 << 14, "cpu").table, batch, 0,
                       64) > 2048
    j_set, t_set, _ = _insert_both(jfs.fpset_new(1 << 14),
                                   tfs.fpset_new(1 << 14, "cpu"), batch, 0, 64)
    j_set, t_set, _ = _insert_both(j_set, t_set, _batch(rng, 6000, 4000), 0, 64)


def test_high_load_walk_more_than_2048_stragglers():
    """Full claim width: one wide batch of distinct fingerprints pushes a
    table from 0.55 past 0.68 load, and round 0 leaves over 2048
    stragglers in the segment that walk full buckets."""
    rng = np.random.default_rng(13)
    cap = 1 << 16
    j_set, t_set = jfs.fpset_new(cap), tfs.fpset_new(cap, "cpu")
    j_set, t_set, _ = _insert_both(j_set, t_set, _batch(rng, 36000))
    batch = _batch(rng, 18000)
    assert _stragglers(t_set.table, batch, 0, 0) > 2048
    j_set, t_set, _ = _insert_both(j_set, t_set, batch)
    assert int(tfs.fpset_count(t_set)) / cap >= 0.68


def test_mix_and_unmix_equal_reference():
    rng = np.random.default_rng(2)
    lo = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    mlo, mhi = tfs._mix(torch.from_numpy(lo.astype(np.int64)),
                        torch.from_numpy(hi.astype(np.int64)))
    rlo, rhi = jfs.mix_host_np(lo, hi)
    assert (mlo.numpy() == rlo).all() and (mhi.numpy() == rhi).all()
    ulo, uhi = tfs._unmix(mlo, mhi)
    assert (ulo.numpy() == lo).all() and (uhi.numpy() == hi).all()


def test_actual_collision_equals_reference():
    rng = np.random.default_rng(4)
    j_set, t_set, _ = _insert_both(jfs.fpset_new(1 << 12),
                                   tfs.fpset_new(1 << 12, "cpu"),
                                   _batch(rng, 2000))
    assert (tfs.fpset_actual_collision(t_set)
            == float(jfs.fpset_actual_collision(j_set)))
