"""Port fingerprint (torchtlc.engine.fingerprint) against
jaxtlc.engine.fingerprint: fp64_host, fp64_words, fp64_words_mxu."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jaxtlc.engine import fingerprint as jf
from torchtlc.engine import fingerprint as tf
from torchtlc.testing import one_thread

one_thread()


@pytest.mark.parametrize("nbits", [108, 222, 64, 33])
def test_fp64_equals_reference_forms(nbits):
    """The wrapper (plain on CPU) equals fp64_words, fp64_words_mxu and the
    bitwise host definition on numpy-seeded words."""
    W = (nbits + 31) // 32
    rng = np.random.default_rng(nbits)
    words = rng.integers(0, 2**32, (600, W), dtype=np.uint64).astype(np.uint32)
    lo, hi = tf.fp64_words(torch.from_numpy(words.view(np.int32)), nbits)
    lo, hi = lo.numpy().view(np.uint32), hi.numpy().view(np.uint32)
    for ref in (jf.fp64_words, jf.fp64_words_mxu):
        rlo, rhi = ref(jnp.asarray(words), nbits)
        assert (lo == np.asarray(rlo)).all() and (hi == np.asarray(rhi)).all()
    for r in range(0, 600, 61):
        bits = sum(int(w) << (32 * i) for i, w in enumerate(words[r]))
        bits &= (1 << nbits) - 1
        f = jf.fp64_host(bits, nbits)
        assert f == tf.fp64_host(bits, nbits)
        assert (int(hi[r]) << 32) | int(lo[r]) == f


def test_affine_basis_equals_reference():
    for nbits in (108, 222):
        tc, tb = tf.affine_basis(nbits)
        jc, jb = jf.affine_basis(nbits)
        assert (tc == jc).all() and (tb == jb).all()


def test_polys_table_equals_find_polys():
    assert tf.POLYS == jf.POLYS
    assert tf.find_polys() == tf.POLYS
    assert (tf.DEFAULT_FP_INDEX, tf.DEFAULT_SEED) == (jf.DEFAULT_FP_INDEX,
                                                      jf.DEFAULT_SEED)


def test_collision_probability_reproduces_mc_out():
    p = tf.collision_probability(577736, 163408)
    assert p == jf.collision_probability(577736, 163408)
    assert f"{p:.1E}" == "3.7E-09"  # MC.out:41
