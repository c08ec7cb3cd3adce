"""The random walk over the KubeAPI spec in the port against
jaxtlc.sim.engine.make_sim_engine over jaxtlc's kubeapi_backend, tolerance
zero: the walk carry leaf for leaf (states, key, step_i, alive,
steps_taken, the uint32 generated / transitions / act_taken, the violation
leaves and the sampling filter's table words) after round 0 and after
every round, on FF and Model_1 at 64 walkers to depth 24, seeds 0 and 7,
the filter on and off - through the plain versions of kernels K39 and K40
(sim.plain.WalkPlain over make_kernel) and through their g++ build
(kube_sim.cuh through host_launch.cpp).  Also: FF under the delete_noop
mutation, whose walk trips the PlusCal assertion (the lane, step, state
and action pinned, and replay_lane landing there as the reference's
replay does); replay_lane on clean lanes; chip_smoke.py's pin of that
walk at its own geometry; a carry of either package
resumed in the other; the result's violation names; and the wrappers'
refusal of CPU tensors.  No shipped KubeAPI model deadlocks (Model_1's
MC.out), so the deadlock class is the generic spec's test
(tests/test_torch_sim_gen.py)."""

import ctypes
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from jaxtlc.config import MODEL_1 as J_MODEL_1
from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.engine.backend import kubeapi_backend as j_kubeapi_backend
from jaxtlc.sim.engine import make_sim_engine as j_make_sim_engine
from jaxtlc.sim.replay import replay_lane as j_replay
from torchtlc.config import MODEL_1, ModelConfig
from torchtlc.engine.backend import kernel_layout, kubeapi_backend
from torchtlc.sim.engine import (
    carry_from_reference,
    carry_to_reference,
    make_sim_engine,
    result_from_sim_carry,
    u32_get,
    u32_set,
)
from torchtlc.sim.replay import replay_lane, walk_trace
from torchtlc.testing import one_thread

one_thread()

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torchtlc", "kernels", "csrc")
P, I = ctypes.c_void_p, ctypes.c_int
W, D = 64, 24
SEEDS = (0, 7)
CAPS = (0, 1 << 12)
MODELS = {"ff": (JConfig(False, False), ModelConfig(False, False)),
          "model1": (J_MODEL_1, MODEL_1)}
# FF under phase 9b's mutation: a Delete that leaves the object in place,
# so the reconciler's assert ~ObjectExists fails.  At 64 walkers, seed 3,
# lane 53 trips it at transition 45 by C4 (label 15)
VIOL = dict(W=64, D=48, seed=3, lane=53, step=45, action=15)


def _viol_cfgs():
    return tuple(dataclasses.replace(c, mutation="delete_noop")
                 for c in MODELS["ff"])


def _leaves(c):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(c)]


def _same(got, want, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (
            what, i, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), (what, i, a, b)


def _trajectory(jcfg, walkers, depth, cap, seeds):
    """seed -> the reference's leaves after round 0 and each step_fn."""
    init_fn, _, step_fn = j_make_sim_engine(
        j_kubeapi_backend(jcfg), walkers, depth, fp_capacity=cap)
    init = jax.jit(init_fn)
    out = {}
    for seed in seeds:
        c = init(seed)
        steps = [_leaves(c)]
        for _ in range(depth):
            c = step_fn(c)
            steps.append(_leaves(c))
        out[seed] = steps
    return out


@pytest.fixture(scope="module")
def refs():
    """(model, cap) -> seed -> the reference's trajectory; one reference
    engine per geometry, memoized for the module."""
    return {(name, cap): _trajectory(jcfg, W, D, cap, SEEDS)
            for name, (jcfg, _) in MODELS.items() for cap in CAPS}


@pytest.fixture(scope="module")
def viol_ref():
    return _trajectory(_viol_cfgs()[0], VIOL["W"], VIOL["D"], 0,
                       (VIOL["seed"],))[VIOL["seed"]]


# ---------------------------------------------------------------------------
# K39 and K40 through the g++ build
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("host_kube_sim") / "libhost.so")
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-D__host__=",
         "-D__device__=", "-I", CSRC, "-o", so,
         os.path.join(CSRC, "host_launch.cpp")],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.host_kube_sim_step.argtypes = ([P] * 5 + [I] + [P] * 3 + [I] * 3
                                       + [P] * 5)
    lib.host_kube_sim_fold.argtypes = [I, I, P, P, I] + [P] * 12
    return lib


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


class HostKubeSim:
    """The walk routes of KubeKernels over host_kube_sim_step and
    host_kube_sim_fold of the g++ build."""

    def __init__(self, lib, kernels):
        self.lib = lib
        self.prog = kernels.prog
        self.lay = kernel_layout(kernels.cfg)

    @staticmethod
    def _u32(t):
        return torch.from_numpy(u32_get(t).numpy().astype(np.uint32))

    def sim_init(self, buf, key, inits, states):
        assert self.lib.host_kube_sim_step(
            self.lay.ctypes.data, _p(buf.go), _p(self._u32(key)), None,
            _p(inits), inits.shape[0], _p(states), None, None,
            states.shape[0], 1, 0, _p(buf.packed), _p(buf.take),
            _p(buf.vold), _p(buf.vact), _p(buf.scratch)) == 0

    def sim_step(self, buf, key, step_i, states, alive, steps_taken,
                 check_deadlock):
        assert self.lib.host_kube_sim_step(
            self.lay.ctypes.data, _p(buf.go), _p(self._u32(key)),
            _p(step_i), None, 0, _p(states), _p(alive), _p(steps_taken),
            states.shape[0], 0, int(check_deadlock), _p(buf.packed),
            _p(buf.take), _p(buf.vold), _p(buf.vact), _p(buf.scratch)) == 0

    def sim_fold(self, buf, c, depth, init=False):
        u = {n: self._u32(getattr(c, n))
             for n in ("generated", "transitions", "act_taken")}
        assert self.lib.host_kube_sim_fold(
            int(init), self.prog.F, _p(buf.go), _p(buf.scratch), depth,
            _p(c.step_i), _p(c.viol), _p(c.viol_lane), _p(c.viol_step),
            _p(c.viol_state), _p(c.viol_action), _p(u["generated"]),
            _p(u["transitions"]), _p(u["act_taken"]), _p(c.states),
            _p(buf.vold), _p(buf.vact)) == 0
        for n, v in u.items():
            u32_set(getattr(c, n), torch.from_numpy(v.numpy().astype(
                np.int64)))


def _backend(cfg, route, host_lib):
    b = kubeapi_backend(cfg)
    if route == "gxx":
        b = b._replace(kernels=HostKubeSim(host_lib, b.kernels))
    return b


# ---------------------------------------------------------------------------
# the walk, leaf for leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["plain", "gxx"])
@pytest.mark.parametrize("cap", CAPS, ids=["nofilter", "filter"])
@pytest.mark.parametrize("name", list(MODELS))
def test_walk_equals_reference(refs, host_lib, name, cap, route):
    """Round 0 and every round equal the reference's leaf for leaf
    (dtypes and shapes included); run_fn's final carry its last round."""
    backend = _backend(MODELS[name][1], route, host_lib)
    init_fn, run_fn, step_fn = make_sim_engine(backend, W, D,
                                               fp_capacity=cap,
                                               device="cpu")
    for seed in SEEDS:
        want = refs[name, cap][seed]
        c = init_fn(seed)
        _same(carry_to_reference(c), want[0], (name, seed, 0))
        for d in range(1, D + 1):
            c = step_fn(c)
            _same(carry_to_reference(c), want[d], (name, seed, d))
        _same(carry_to_reference(run_fn(init_fn(seed))), want[-1],
              (name, seed, "run_fn"))
        assert int(want[-1][8]) == 0 and int(want[-1][2]) == D


@pytest.mark.parametrize("route", ["plain", "gxx"])
def test_assertion_violation_and_replay(viol_ref, host_lib, route):
    """FF under delete_noop: every round equals the reference's; the walk
    stops at the pinned lane, step and action with the state the lane
    stood in (the assertion reports the old state); replay_lane lands on
    the same violation, step, state and labels as the reference's
    replay."""
    jcfg, cfg = _viol_cfgs()
    backend = _backend(cfg, route, host_lib)
    init_fn, run_fn, step_fn = make_sim_engine(backend, VIOL["W"],
                                               VIOL["D"], device="cpu")
    c = init_fn(VIOL["seed"])
    for d in range(1, VIOL["step"] + 1):
        c = step_fn(c)
        _same(carry_to_reference(c), viol_ref[d], ("viol", d))
    assert (int(c.viol), int(c.viol_lane), int(c.viol_step),
            int(c.viol_action)) == (3, VIOL["lane"], VIOL["step"],
                                    VIOL["action"])
    end = run_fn(init_fn(VIOL["seed"]))
    _same(carry_to_reference(end), viol_ref[VIOL["step"]], "run_fn")
    r = result_from_sim_carry(end, 0.0, backend, VIOL["W"], VIOL["D"],
                              VIOL["seed"])
    assert r.violation_name == "Assertion failure (PlusCal assert)"
    assert r.violation_step == VIOL["step"] and r.violation_lane == \
        VIOL["lane"]
    if route == "gxx":  # the replay runs no walk kernel: once is enough
        return
    walk = replay_lane(kubeapi_backend(cfg), VIOL["seed"], VIOL["lane"],
                       VIOL["step"], device="cpu")
    ref = j_replay(j_kubeapi_backend(jcfg), VIOL["seed"], VIOL["lane"],
                   VIOL["step"])
    assert walk.violation == ref.violation == 3
    assert walk.violation_step == ref.violation_step == VIOL["step"]
    assert walk.labels == ref.labels and walk.labels[-1] == "C4"
    for a, b in zip(walk.fields, ref.fields):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the assertion fires on the transition out of the lane's state: the
    # reported state is the replay's last state but one
    np.testing.assert_array_equal(walk.fields[-2], r.violation_state)


def test_replay_equals_device_lanes_and_reference(refs):
    """replay_lane (K1's sharded variant and K7's plain versions on a
    one-row queue) re-walks Model_1's lanes to their final state, equal to
    the reference's replay; walk_trace decodes through the KubeAPI
    codec."""
    final = refs["model1", 0][7][-1]
    backend = kubeapi_backend(MODEL_1)
    jbackend = j_kubeapi_backend(J_MODEL_1)
    for lane in (17, W - 1):
        n = int(final[4][lane])
        walk = replay_lane(backend, 7, lane, n, device="cpu")
        ref = j_replay(jbackend, 7, lane, n)
        assert walk.violation == ref.violation == 0
        assert walk.labels == ref.labels and not walk.halted
        for a, b in zip(walk.fields, ref.fields):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(walk.fields[-1], final[1][lane])
    trace = walk_trace(walk, backend.cdc)
    assert len(trace) == n + 1 and trace[0][1] is None
    assert trace[-1][0] == backend.cdc.decode(walk.fields[-1])


@pytest.mark.parametrize("cap", CAPS, ids=["nofilter", "filter"])
def test_carry_resumes_across_packages(refs, cap):
    """The reference's carry after round 9 continued by the port (and the
    port's carry handed back) equals the reference's later rounds:
    carry_from_reference / carry_to_reference over a KubeAPI walk."""
    want = refs["model1", cap][0]
    _, _, step_fn = make_sim_engine(kubeapi_backend(MODEL_1), W, D,
                                    fp_capacity=cap, device="cpu")
    c = carry_from_reference(want[9], "cpu")
    _same(carry_to_reference(c), want[9], "from_reference")
    for d in range(10, 14):
        c = step_fn(c)
        _same(carry_to_reference(c), want[d], ("resumed", d))


def test_kube_sim_kernels_refuse_cpu_tensors():
    """The K39 / K40 wrappers launch or raise: a CPU tensor never reaches
    them (the routes take the plain versions for those)."""
    from torchtlc.kernels import ops
    from torchtlc.sim.engine import sim_buffers

    walk = kubeapi_backend(MODEL_1).kernels.prog
    buf = sim_buffers(walk, 4, "cpu", False)
    states = torch.zeros(4, walk.F, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.kube_sim_step(walk, buf, torch.zeros(2, dtype=torch.uint32),
                          torch.zeros((), dtype=torch.int32), states,
                          torch.ones(4, dtype=torch.bool),
                          torch.zeros(4, dtype=torch.int32), True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.kube_sim_init(walk, buf, torch.zeros(2, dtype=torch.uint32),
                          states, states)


def test_chip_smoke_pin_is_the_reference_walk():
    """chip_smoke.py's phase-26 pin of FF under delete_noop: the
    reference's final carry at its geometry."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke

    geo = chip_smoke.SIM26
    init_fn, run_fn, _ = j_make_sim_engine(
        j_kubeapi_backend(_viol_cfgs()[0]), geo["walkers"], geo["depth"],
        fp_capacity=geo["fp_capacity"])
    assert chip_smoke.sim_sha(_leaves(run_fn(jax.jit(init_fn)(0)))) == \
        chip_smoke.SIM26_VIOL_PINS["FF/delete_noop"]["sha"]
