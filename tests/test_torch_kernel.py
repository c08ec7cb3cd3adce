"""Port next-state function and invariants (torchtlc.spec.kernel,
torchtlc.spec.invariants) against the reference's batched_kernel and
batched_invariants: every lane of every FF-reachable state, the mutation
configs, the seeded assert and the doctored two-version state."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jaxtlc.config import MODEL_1 as J_MODEL_1, ModelConfig as JConfig
from jaxtlc.config import make_scaled as j_make_scaled
from jaxtlc.spec import oracle
from jaxtlc.spec.codec import get_codec as j_get_codec
from jaxtlc.spec.invariants import batched_invariants
from jaxtlc.spec.kernel import batched_kernel, lane_layout as j_lane_layout
from torchtlc.config import MODEL_1, ModelConfig, make_scaled
from torchtlc.spec.codec import get_codec
from torchtlc.spec.invariants import make_invariant_kernel
from torchtlc.spec.kernel import lane_layout, make_kernel
from torchtlc.testing import one_thread

one_thread()

J_FF = JConfig(False, False)
NAMES = ("succ", "valid", "action", "assert_fail", "overflow")


@pytest.fixture(scope="module")
def ff_states():
    cdc = j_get_codec(J_FF)
    states = []
    oracle.bfs(J_FF, on_level=lambda d, f: states.extend(
        cdc.encode(s) for s in f))
    return np.stack(states)


def _compare_step(tcfg, jcfg, x):
    ref = batched_kernel(jcfg)(jnp.asarray(x))
    got = make_kernel(tcfg)(torch.from_numpy(x))
    for name, a, b in zip(NAMES, ref, got):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, name
        assert (a == b).all(), (name, np.argwhere(a != b)[:3])
    return ref, got


@pytest.mark.parametrize("mutation", ["", "delete_noop", "sticky_reconcile"])
def test_lanes_equal_reference_on_ff_states(ff_states, mutation):
    """Every lane of every FF-reachable state; the mutated configs flag the
    same lanes (same codec layout, so the FF states are valid inputs)."""
    _compare_step(ModelConfig(False, False, mutation=mutation),
                  JConfig(False, False, mutation=mutation), ff_states)


def test_lane_layout_equals_reference():
    for tc, jc in ((ModelConfig(False, False), J_FF), (MODEL_1, J_MODEL_1),
                   (make_scaled(2, 1, False, False),
                    j_make_scaled(2, 1, False, False))):
        assert lane_layout(tc) == j_lane_layout(jc)


def test_invariant_bits_equal_reference_on_successors(ff_states):
    out = batched_kernel(J_FF)(jnp.asarray(ff_states))
    ref_succ, valid = np.asarray(out[0]), np.asarray(out[1]).reshape(-1)
    flat = ref_succ.reshape(-1, ref_succ.shape[-1])
    ref = np.asarray(batched_invariants(J_FF)(jnp.asarray(flat)))
    got = make_invariant_kernel(ModelConfig(False, False))(
        torch.from_numpy(flat)).numpy()
    assert (got == ref).all()
    # the spec is correct: every valid successor satisfies both
    assert (ref[valid] == 3).all()


def test_model1_and_scaled_lanes_on_perturbed_states(ff_states):
    """Model_1 (both fault lanes) and the 2x1 scaled layout (ls = 2, list
    fan-out and slot sorting) on seeded perturbations of reachable-shaped
    field vectors, including out-of-range words."""
    rng = np.random.default_rng(7)
    x = ff_states[rng.integers(0, len(ff_states), 3000)].copy()
    flip = rng.random(x.shape) < 0.05
    x = np.where(flip, rng.integers(0, 64, x.shape), x).astype(np.int32)
    _compare_step(MODEL_1, J_MODEL_1, x)
    tcfg, jcfg = make_scaled(2, 1, False, False), j_make_scaled(2, 1, False,
                                                                False)
    F = get_codec(tcfg).n_fields
    widths = get_codec(tcfg).lane_widths
    y = np.stack([rng.integers(0, 1 << w, 4000) for w in widths], 1)
    y = y.astype(np.int32)
    assert y.shape[1] == F
    _compare_step(tcfg, jcfg, y)
    bits_ref = np.asarray(batched_invariants(jcfg)(jnp.asarray(y)))
    bits = make_invariant_kernel(tcfg)(torch.from_numpy(y)).numpy()
    assert (bits == bits_ref).all()


def test_seeded_c2_assert_fires_like_reference():
    """A state with pc[Client] = C2 and an empty apiState fails the
    ObjectExists assert (KubeAPI.tla:196) on the same lanes."""
    cdc = j_get_codec(J_MODEL_1)
    s0 = oracle.initial_states(J_MODEL_1)[1]
    bad = s0._replace(pc=("C2", "PVCStart", "APIStart"))
    x = np.stack([cdc.encode(bad)] * 4)
    ref, got = _compare_step(MODEL_1, J_MODEL_1, x)
    hit = (got[1] & got[3]).numpy()
    assert hit.any()
    assert (hit == np.asarray(ref[1] & ref[3])).all()


def test_doctored_two_version_state_fails_only_one_version():
    cdc = j_get_codec(J_MODEL_1)
    s0 = oracle.initial_states(J_MODEL_1)[0]
    two = s0._replace(api_state=frozenset([
        oracle.rec(k="Secret", n="foo", vv=frozenset()),
        oracle.rec(k="Secret", n="foo", vv=frozenset(["Client"])),
    ]))
    x = np.stack([cdc.encode(s0), cdc.encode(two)])
    ref = np.asarray(batched_invariants(J_MODEL_1)(jnp.asarray(x)))
    got = make_invariant_kernel(MODEL_1)(torch.from_numpy(x)).numpy()
    assert (got == ref).all()
    assert got[0] == 3 and got[1] & 2 == 0 and got[1] & 1 == 1
