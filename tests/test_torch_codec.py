"""Port codec (torchtlc.spec.codec) against jaxtlc.spec.codec, word for
word, on every FF-reachable state."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jaxtlc.config import MODEL_1 as J_MODEL_1, ModelConfig as JConfig
from jaxtlc.config import make_scaled as j_make_scaled
from jaxtlc.spec import oracle
from jaxtlc.spec.codec import get_codec as j_get_codec
from jaxtlc.spec.kernel import initial_vectors as j_initial_vectors
from torchtlc.config import MODEL_1, ModelConfig, make_scaled
from torchtlc.spec.codec import get_codec, to_i32, to_u64
from torchtlc.spec.kernel import initial_vectors
from torchtlc.testing import one_thread

one_thread()

FF, J_FF = ModelConfig(False, False), JConfig(False, False)


@pytest.fixture(scope="module")
def ff_states():
    """[8203, F] int32: every FF-reachable state, encoded by the reference."""
    cdc = j_get_codec(J_FF)
    states = []
    oracle.bfs(J_FF, on_level=lambda d, f: states.extend(
        cdc.encode(s) for s in f))
    return np.stack(states)


def test_ff_state_count(ff_states):
    assert ff_states.shape == (8203, get_codec(FF).n_fields)


def test_layout_equals_reference():
    for tc, jc in ((FF, J_FF), (MODEL_1, J_MODEL_1),
                   (make_scaled(2, 1, False, False),
                    j_make_scaled(2, 1, False, False))):
        t, j = get_codec(tc), j_get_codec(jc)
        assert t.offsets == j.offsets
        assert (t.n_fields, t.nbits, t.n_words) == (j.n_fields, j.nbits,
                                                    j.n_words)
        assert [(f.name, f.count, f.width) for f in t.fields] == [
            (f.name, f.count, f.width) for f in j.fields]
        for attr in ("o_spec", "o_vv", "o_hasvv", "o_ident", "o_present",
                     "r_obj", "r_status", "r_op", "r_present", "lm_status",
                     "lm_kind", "lm_present", "s_retpc", "s_proc",
                     "s_present"):
            assert getattr(t, attr) == getattr(j, attr), attr


def test_pack_equals_reference(ff_states):
    ref = np.asarray(j_get_codec(J_FF).pack(jnp.asarray(ff_states)))
    got = get_codec(FF).pack(torch.from_numpy(ff_states)).numpy()
    assert (got.view(np.uint32) == ref).all()


def test_unpack_equals_reference(ff_states):
    words = np.asarray(j_get_codec(J_FF).pack(jnp.asarray(ff_states)))
    ref = np.asarray(j_get_codec(J_FF).unpack(jnp.asarray(words)))
    got = get_codec(FF).unpack(torch.from_numpy(words.view(np.int32)))
    assert (got.numpy() == ref).all()
    assert (ref == ff_states).all()


def test_sdict_roundtrip(ff_states):
    cdc = get_codec(FF)
    x = torch.from_numpy(ff_states)
    sd = cdc.to_sdict(x)
    assert sd["lreq_obj"].shape == (len(ff_states), cdc.nc, cdc.ls)
    assert (cdc.from_sdict(sd) == x).all()


def test_pack_host_equals_reference(ff_states):
    t, j = get_codec(FF), j_get_codec(J_FF)
    for vec in ff_states[::97]:
        assert t.pack_host(vec) == j.pack_host(vec)


def test_canonicalize_equals_reference(ff_states):
    """Scrambled set slots (api, list results) canonicalize as in the
    reference, under the scaled config's 2-slot list groups too."""
    rng = np.random.default_rng(11)
    for tc, jc, x in ((FF, J_FF, ff_states),
                      (make_scaled(2, 1), j_make_scaled(2, 1), None)):
        cdc = get_codec(tc)
        if x is None:
            x = rng.integers(0, 1 << 20, (4000, cdc.n_fields)).astype(np.int32)
        x = x.copy()
        perm = rng.permuted(np.tile(np.arange(cdc.ni), (x.shape[0], 1)), axis=1)
        api = x[:, cdc.sl("api")]
        x[:, cdc.sl("api")] = np.take_along_axis(api, perm, axis=1)
        ref = np.asarray(j_get_codec(jc).canonicalize(jnp.asarray(x)))
        got = cdc.canonicalize(torch.from_numpy(x)).numpy()
        assert (got == ref).all()


@pytest.mark.parametrize("cfg_pair", [
    (FF, J_FF), (MODEL_1, J_MODEL_1),
    (make_scaled(2, 1, False, False), j_make_scaled(2, 1, False, False)),
    (make_scaled(3, 2), j_make_scaled(3, 2)),
], ids=["FF", "Model_1", "scaled_2x1", "scaled_3x2"])
def test_initial_vectors_equal_reference(cfg_pair):
    tc, jc = cfg_pair
    assert (initial_vectors(tc) == np.asarray(j_initial_vectors(jc))).all()


def test_word_conversions_roundtrip():
    rng = np.random.default_rng(3)
    u = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    t = torch.from_numpy(u.view(np.int32))
    assert (to_u64(t).numpy() == u.astype(np.int64)).all()
    assert (to_i32(to_u64(t)).numpy() == u.view(np.int32)).all()
