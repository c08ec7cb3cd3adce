"""Deferred invariants: the port's checker (torchtlc.engine.backend,
kernel K7's plain version, on the CPU) against
jaxtlc.engine.backend.make_deferred_checker on KubeAPI rows that include
doctored two-version apiStates - several violating lanes, slab padding
sentinels, both insert layouts - and a whole deferred engine run from a
doctored frontier against the reference's, word for word.

The reference checker reads the raw successor fields of the expand stage;
the port derives them again from the popped packed rows, so both are given
the same popped block."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.engine import bfs as jb
from jaxtlc.engine.backend import kubeapi_backend, make_deferred_checker
from jaxtlc.spec import oracle
from jaxtlc.spec.codec import get_codec as j_get_codec
from jaxtlc.spec.kernel import batched_kernel
from torchtlc.config import ModelConfig
from torchtlc.engine import bfs as tb
from torchtlc.engine.backend import (
    OK, VIOL_ONLYONEVERSION, deferred_check_plain, expand_plain,
)
from torchtlc.engine.interop import carry_to_numpy
from torchtlc.testing import one_thread

one_thread()

FF, J_FF = ModelConfig(False, False), JConfig(False, False)
CK = 48


def _two_version(s):
    """A state whose apiState holds Secret foo twice: OnlyOneVersion fails
    in it and in every successor that keeps both objects."""
    return s._replace(api_state=frozenset([
        oracle.rec(k="Secret", n="foo", vv=frozenset()),
        oracle.rec(k="Secret", n="foo", vv=frozenset(["Client"])),
    ]))


@pytest.fixture(scope="module")
def popped():
    """A popped block of CK packed FF rows: reachable states with every
    fourth one doctored, its expansion by the reference kernel (raw
    successor fields) and by the port (actions, validity)."""
    cdc = j_get_codec(J_FF)
    states = []
    oracle.bfs(J_FF, on_level=lambda d, f: states.extend(f))
    rng = np.random.default_rng(3)
    pick = [states[i] for i in rng.choice(len(states), CK, replace=False)]
    rows = [cdc.encode(_two_version(s) if k % 4 == 1 else s)
            for k, s in enumerate(pick)]
    packed = np.asarray(jax.jit(cdc.pack)(jnp.asarray(np.stack(rows))))
    batch = cdc.unpack(jnp.asarray(packed))
    succ = np.asarray(batched_kernel(J_FF)(batch)[0])
    block = torch.from_numpy(np.array(packed).view(np.int32))
    _, flags, action, _ = expand_plain(FF, block, CK, deferred=True)
    return dict(flat=succ.reshape(-1, succ.shape[-1]), block=block,
                action=action, valid=flags[0].bool().numpy())


def _claimants(rng, valid, R, n, layout, fresh_frac):
    """(is_new_c, c_idx, nreps, rows) of an insert over n candidate lanes.
    slab: R rows of distinct valid lanes, interspersed non-fresh rows and
    sentinel padding; sorted: a permutation of all lanes with the fresh
    representatives in a prefix."""
    lanes = rng.permutation(np.flatnonzero(valid))
    if layout == "slab":
        k = min(len(lanes), R - 7)
        c_idx = np.full(n, n, np.int64)
        c_idx[:k] = np.sort(lanes[:k])
        is_new = np.zeros(n, bool)
        is_new[:k] = rng.random(k) < fresh_frac
        return is_new, c_idx, int(is_new.sum()), R
    nreps = len(lanes) // 2
    rest = np.setdiff1d(np.arange(n), lanes[:nreps])
    c_idx = np.concatenate([lanes[:nreps], rng.permutation(rest)])
    is_new = np.zeros(n, bool)
    is_new[:nreps] = rng.random(nreps) < fresh_frac
    return is_new, c_idx.astype(np.int64), nreps, n


@pytest.mark.parametrize("layout,seed,fresh_frac", [
    ("slab", 0, 0.5), ("slab", 1, 0.9), ("sorted", 2, 0.6),
    ("slab", 3, 0.0),
])
def test_checker_equals_reference_highest_lane(popped, layout, seed,
                                               fresh_frac):
    L = popped["flat"].shape[0] // CK
    n = CK * L
    R = 2 * CK
    rng = np.random.default_rng(seed)
    is_new, c_idx, nreps, rows = _claimants(rng, popped["valid"], R, n,
                                            layout, fresh_frac)
    check = make_deferred_checker(kubeapi_backend(J_FF), n, probe_width=R)
    j_viol, j_state, j_action, _ = check(
        jnp.asarray(popped["flat"]), jnp.asarray(popped["action"].numpy()),
        jnp.asarray(is_new), jnp.asarray(c_idx.astype(np.int32)),
        jnp.int32(nreps))
    t_viol, t_state, t_action = deferred_check_plain(
        FF, popped["block"], torch.from_numpy(is_new),
        torch.from_numpy(c_idx), popped["action"], rows)
    assert int(t_viol) == int(j_viol)
    assert (t_state.numpy() == np.asarray(j_state)).all()
    assert int(t_action) == int(j_action)
    if fresh_frac == 0.0:
        assert int(t_viol) == OK
    else:  # doctored successors among the fresh claimants
        assert int(t_viol) == VIOL_ONLYONEVERSION


def test_several_violating_lanes_report_the_highest(popped):
    """Every valid lane fresh: the reported state is the successor of the
    highest violating lane, and other lanes violate too."""
    from torchtlc.spec.invariants import make_invariant_kernel

    L = popped["flat"].shape[0] // CK
    n = CK * L
    lanes = np.flatnonzero(popped["valid"])
    bits = make_invariant_kernel(FF)(torch.from_numpy(
        popped["flat"][lanes]))
    bad = lanes[(bits.numpy() & 2) == 0]
    assert len(bad) >= 3
    c_idx = np.full(n, n, np.int64)
    c_idx[:len(lanes)] = lanes
    is_new = np.zeros(n, bool)
    is_new[:len(lanes)] = True
    viol, state, action = deferred_check_plain(
        FF, popped["block"], torch.from_numpy(is_new),
        torch.from_numpy(c_idx), popped["action"], n)
    assert int(viol) == VIOL_ONLYONEVERSION
    assert (state.numpy() == popped["flat"][bad.max()]).all()
    assert int(action) == int(popped["action"][bad.max()])


@pytest.mark.parametrize("deferred", [True, False])
def test_engine_from_a_doctored_frontier_equals_reference(deferred):
    """Both engines start from a frontier of two-version states, in the
    deferred or the immediate mode: the same OnlyOneVersion verdict,
    state and action, and word-equal carries."""
    kw = dict(chunk=32, queue_capacity=1 << 10, fp_capacity=1 << 12,
              sort_free=True, deferred=deferred)
    cdc = j_get_codec(J_FF)
    rows = np.stack([cdc.encode(_two_version(s))
                     for s in oracle.initial_states(J_FF)])
    packed = np.asarray(jax.jit(cdc.pack)(jnp.asarray(rows)))
    j_init, j_run, _ = jb.make_engine(J_FF, donate=False, **kw)
    jc = j_init()
    queue = np.array(jc.queue)
    queue[0, :2] = packed
    jc = jax.block_until_ready(j_run(jc._replace(queue=jnp.asarray(queue))))
    t_init, t_run, _ = tb.make_engine(FF, device="cpu", **kw)
    tc = t_init()
    tc.queue[0, :2] = torch.from_numpy(np.array(packed).view(np.int32))
    tc = t_run(tc)
    assert int(tc.viol) == int(jc.viol) == VIOL_ONLYONEVERSION
    d = carry_to_numpy(tc)
    for f in d:
        ref = np.asarray(jc.fps.table if f == "fps" else getattr(jc, f))
        assert (d[f] == ref).all(), f
