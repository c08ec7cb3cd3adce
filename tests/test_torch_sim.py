"""The simulation plane in the port against jaxtlc.sim, tolerance zero.

- threefry: the key, fold_in and a scalar's bits rule by rule, and
  lane_bits over 256 lanes at several steps, against jax.random for seeds
  that are negative or above 2^32;
- the walk carry leaf for leaf (states, key, counters, act_taken, the
  violation leaves, the sampling filter's table words, distinct, fp_sat)
  after round 0, after every step_fn and at the end of run_fn, on SimTiny,
  SimViol and SimDead (the reference's tests/test_sim.py models), TwoPhase
  Model_1 with deadlock on and off and RaftReplication Model_1 - on the
  plain versions and on the g++ build of kernels K27 and K28 from each
  spec's emitted text (struct_expand.cuh includes emitted_sim.cuh);
- the host replay against the device lanes and the reference's replay;
- the uint32 wrap of generated, transitions and act_taken from a carry
  near 2^32 (started from the reference's carry mid-walk);
- sigterm@K, -recover and a wrong seed refused, a checkpoint of either
  package resumed in the other;
- walk_trajectories and the lasso verdicts against the reference's.

The commands are tests/test_torch_sim_cli.py."""

import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxtlc.resil.faults import FaultPlan as JFaultPlan
from jaxtlc.sim import driver as jd
from jaxtlc.sim import liveness as jlive
from jaxtlc.sim.engine import get_sim_engine as j_get_sim_engine
from jaxtlc.sim.replay import replay_lane as j_replay
from jaxtlc.struct.cache import get_backend as j_get_backend
from jaxtlc.struct.loader import load as j_load
from torchtlc.kernels.build import build_struct
from torchtlc.resil.faults import FaultPlan
from torchtlc.sim import driver as td
from torchtlc.sim import liveness as tlive
from torchtlc.sim import threefry as tf
from torchtlc.sim.engine import (
    carry_from_reference,
    carry_to_reference,
    make_sim_engine,
    u32_get,
    u32_set,
)
from torchtlc.sim.replay import replay_lane
from torchtlc.struct.cache import get_backend
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
TWO = os.path.join(SPECS, "TwoPhase.toolbox", "Model_1", "MC.cfg")
RAFT = os.path.join(SPECS, "RaftReplication.toolbox", "Model_1", "MC.cfg")
P, I = ctypes.c_void_p, ctypes.c_int

# the reference's models (tests/test_sim.py:33-101)
SIM_TINY = """---- MODULE SimTiny ----
EXTENDS Naturals
CONSTANTS MAX
VARIABLES x, y

Init == /\\ x = 0
        /\\ y = 0

Up == /\\ x < MAX
      /\\ x' = x + 1
      /\\ y' = y

Down == /\\ x > 0
        /\\ x' = x - 1
        /\\ y' = y

Flip == /\\ x > 0
        /\\ y' = 1 - y
        /\\ x' = x

Next == Up \\/ Down \\/ Flip

Spec == Init /\\ [][Next]_<<x, y>>

InRange == x <= MAX
====
"""
SIM_TINY_CFG = ("CONSTANT MAX = 4\nSPECIFICATION\nSpec\n"
                "INVARIANT\nInRange\n")
SIM_VIOL = """---- MODULE SimViol ----
EXTENDS Naturals
VARIABLES x

Init == x = 0

Step == /\\ x < 3
        /\\ x' = x + 1

Next == Step

Spec == Init /\\ [][Next]_x

NotOne == x # 1
====
"""
SIM_VIOL_CFG = "SPECIFICATION\nSpec\nINVARIANT\nNotOne\n"
SIM_DEAD = """---- MODULE SimDead ----
EXTENDS Naturals
VARIABLES x

Init == x = 0

Step == /\\ x < 3
        /\\ x' = x + 1

Next == Step

Spec == Init /\\ [][Next]_x
====
"""
SIM_DEAD_CFG = "SPECIFICATION\nSpec\n"
# the reference's lasso model (tests/test_infer.py:74-94)
LIVE = """---- MODULE LiveTiny ----
EXTENDS Naturals
VARIABLES x

Init == x = 0

Inc == /\\ x < 3
       /\\ x' = x + 1

Stay == /\\ x = 3
        /\\ x' = x

Next == Inc \\/ Stay

Spec == Init /\\ [][Next]_x

Unreached == (x = 1) ~> (x = 5)
Reached == (x = 1) ~> (x = 3)
Boxed == [](x >= 0) ~> (x = 3)
====
"""


def write_model(d, name, spec, cfg) -> str:
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{name}.tla"), "w") as f:
        f.write(spec)
    path = os.path.join(d, f"{name}.cfg")
    with open(path, "w") as f:
        f.write(cfg)
    return path


# name -> (model text or shipped cfg, deadlock, walkers, depth, fp
# capacity, seeds)
GEOM = {
    "tiny": ((SIM_TINY, SIM_TINY_CFG), False, 8, 16, 1 << 10, (0, 5, -1)),
    "viol": ((SIM_VIOL, SIM_VIOL_CFG), True, 8, 8, 1 << 10, (5,)),
    "dead": ((SIM_DEAD, SIM_DEAD_CFG), True, 8, 8, 1 << 10, (1,)),
    "two": (TWO, True, 16, 12, 1 << 10, (3,)),
    "two_nodl": (TWO, False, 16, 12, 1 << 10, (3,)),
    "raft": (RAFT, False, 16, 10, 1 << 12, (7,)),
}


def _cfg_path(root, name):
    src = GEOM[name][0]
    if isinstance(src, str):
        return src
    module = src[0].split("MODULE ")[1].split()[0]
    return write_model(str(root / module), module, *src)


def _leaves(c):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(c)]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """name -> dict(cfg, port model, reference model, seeds -> the
    reference's leaves after round 0 and after each of `depth` step_fn
    calls).  One reference compile per geometry."""
    root = tmp_path_factory.mktemp("sim")
    out = {}
    for name, (_, dl, W, D, cap, seeds) in GEOM.items():
        cfg = _cfg_path(root, name)
        jm = j_load(cfg)
        _, init_fn, run_fn, step_fn = j_get_sim_engine(
            jm, W, D, fp_capacity=cap, check_deadlock=dl)
        init = jax.jit(init_fn)
        traj = {}
        for seed in seeds:
            c = init(seed)
            steps = [_leaves(c)]
            for _ in range(D):
                c = step_fn(c)
                steps.append(_leaves(c))
            traj[seed] = steps
        out[name] = dict(cfg=cfg, model=load(cfg), jmodel=jm, traj=traj,
                         run_fn=run_fn, init=init, step_fn=step_fn)
    return out


def _same(got, want, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (
            what, i, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), (what, i, a, b)


# ---------------------------------------------------------------------------
# K27 and K28 through the g++ build (the backend's sim routes on CPU
# tensors, over the spec's own emitted library)
# ---------------------------------------------------------------------------


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


class HostSim:
    """The sim routes of StructKernels, over host_struct_sim_step and
    host_sim_fold of the g++ build of the program's emitted text."""

    def __init__(self, prog):
        self.prog = prog
        self.lib = ctypes.CDLL(build_struct(prog.text, host=True))
        self.lib.host_struct_sim_step.argtypes = (
            [P] * 5 + [I] + [P] * 3 + [I] * 3 + [P] * 5)
        self.lib.host_sim_fold.argtypes = [I, P, P, I, I] + [P] * 12
        self.K = torch.from_numpy(np.ascontiguousarray(prog.K))

    @staticmethod
    def _u32(t):
        return torch.from_numpy(u32_get(t).numpy().astype(np.uint32))

    def sim_init(self, buf, key, inits, states):
        k = self._u32(key)
        assert self.lib.host_struct_sim_step(
            _p(self.K), _p(buf.go), _p(k), None, _p(inits), inits.shape[0],
            _p(states), None, None, states.shape[0], 1, 0, _p(buf.packed),
            _p(buf.take), _p(buf.vold), _p(buf.vact), _p(buf.scratch)) == 0

    def sim_step(self, buf, key, step_i, states, alive, steps_taken,
                 check_deadlock):
        k = self._u32(key)
        assert self.lib.host_struct_sim_step(
            _p(self.K), _p(buf.go), _p(k), _p(step_i), None, 0, _p(states),
            _p(alive), _p(steps_taken), states.shape[0], 0,
            int(check_deadlock), _p(buf.packed), _p(buf.take), _p(buf.vold),
            _p(buf.vact), _p(buf.scratch)) == 0

    def sim_fold(self, buf, c, depth, init=False):
        u = {n: self._u32(getattr(c, n))
             for n in ("generated", "transitions", "act_taken")}
        assert self.lib.host_sim_fold(
            int(init), _p(buf.go), _p(buf.scratch), depth, 100,
            _p(c.step_i), _p(c.viol), _p(c.viol_lane), _p(c.viol_step),
            _p(c.viol_state), _p(c.viol_action), _p(u["generated"]),
            _p(u["transitions"]), _p(u["act_taken"]), _p(c.states),
            _p(buf.vold), _p(buf.vact)) == 0
        for n, v in u.items():
            u32_set(getattr(c, n), torch.from_numpy(v.numpy().astype(
                np.int64)))


def _engine(kit, name, route):
    _, dl, W, D, cap, _ = GEOM[name]
    backend = get_backend(kit["model"], dl)
    if route == "gxx":
        backend = backend._replace(kernels=HostSim(backend.kernels.prog))
    return backend, make_sim_engine(backend, W, D, fp_capacity=cap,
                                    check_deadlock=dl, device="cpu")


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------

SEEDS = (0, 1, 7, 123456, -1, -(1 << 31) - 1, (1 << 32) + 5, (1 << 40) + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_equals_jax_random(seed):
    """The key rule, fold_in and a scalar's bits (x0 ^ x1), each against
    jax.random; lane_bits over 256 lanes at steps 0, 1, 2 and 99 against
    the reference's vmapped draw."""
    jk = jax.random.PRNGKey(seed)
    key = tf.prng_key(seed)
    assert tuple(int(v) for v in np.asarray(jk)) == key
    for d in (0, 1, 3, 255, 99):
        fk = jax.random.fold_in(jk, d)
        assert tuple(int(v) for v in np.asarray(fk)) == tf.fold_in(key, d)
        assert int(jax.random.bits(fk, dtype=jnp.uint32)) == tf.bits(
            tf.fold_in(key, d))
    lanes = jnp.arange(256, dtype=jnp.uint32)
    for step in (0, 1, 2, 99):
        want = np.asarray(jax.vmap(lambda lane: jax.random.bits(
            jax.random.fold_in(jax.random.fold_in(jk, lane), step),
            dtype=jnp.uint32))(lanes)).astype(np.int64)
        np.testing.assert_array_equal(tf.lane_bits(key, 256, step).numpy(),
                                      want)
        kt = torch.tensor(np.asarray(jk).view(np.int32)).view(torch.uint32)
        np.testing.assert_array_equal(tf.lane_bits(
            kt, 256, torch.tensor(step, dtype=torch.int32)).numpy(), want)
        assert tf.draw(key, 17, step) == int(want[17])


# ---------------------------------------------------------------------------
# the walk, leaf for leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["plain", "gxx"])
@pytest.mark.parametrize("name", list(GEOM))
def test_walk_equals_reference(refs, name, route):
    """Round 0, every step_fn and run_fn's final carry equal the
    reference's leaf for leaf (dtypes and shapes included), on the plain
    versions and on K27 + K28's g++ build."""
    kit = refs[name]
    _, _, _, D, _, seeds = GEOM[name]
    _, (init_fn, run_fn, step_fn) = _engine(kit, name, route)
    for seed in seeds:
        want = kit["traj"][seed]
        c = init_fn(seed)
        _same(carry_to_reference(c), want[0], (name, seed, 0))
        for d in range(1, D + 1):
            c = step_fn(c)
            _same(carry_to_reference(c), want[d], (name, seed, d))
        _same(carry_to_reference(run_fn(init_fn(seed))), want[-1],
              (name, seed, "run_fn"))
    if name == "tiny":
        seed = seeds[0]
        _same(carry_to_reference(run_fn(init_fn(seed))),
              _leaves(kit["run_fn"](kit["init"](seed))), "reference run_fn")
    viol = int(kit["traj"][seeds[0]][-1][8])
    assert viol == {"viol": 100, "dead": 4, "two": 4}.get(name, 0)


@pytest.mark.parametrize("route", ["plain", "gxx"])
def test_uint32_wrap_from_reference_carry(refs, route):
    """generated, transitions and act_taken wrap as uint32: the
    reference's carry after 3 rounds, its counters set near 2^32, stepped
    by both packages (the port started from the reference's leaves)."""
    kit = refs["tiny"]
    jc = kit["init"](5)
    for _ in range(3):
        jc = kit["step_fn"](jc)
    leaves, tree = jax.tree_util.tree_flatten(jc)
    leaves = [np.asarray(x) for x in leaves]
    leaves[5] = np.uint32(2**32 - 3)
    leaves[6] = np.uint32(2**32 - 2)
    leaves[7] = np.full_like(leaves[7], 2**32 - 1)
    jc = jax.tree_util.tree_unflatten(tree, [jnp.asarray(x)
                                             for x in leaves])
    _, (_, _, step_fn) = _engine(kit, "tiny", route)
    c = carry_from_reference(leaves, "cpu")
    _same(carry_to_reference(c), leaves, "from_reference")
    for d in range(4):
        jc = kit["step_fn"](jc)
        c = step_fn(c)
        _same(carry_to_reference(c), _leaves(jc), ("wrap", d))
    assert int(u32_get(c.generated)) < 2**32 - 3


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "raft", "viol", "dead"])
def test_replay_equals_device_lane_and_reference(refs, name):
    """replay_lane (K17 / K18's plain versions on a one-row block) re-walks
    each lane to the walk's final state and step count, equal to the
    reference's replay; a violating lane replays to the reported code and
    state."""
    kit = refs[name]
    _, dl, W, D, _, seeds = GEOM[name]
    seed = seeds[0]
    final = kit["traj"][seed][-1]
    states, steps_taken = final[1], final[4]
    backend = get_backend(kit["model"], dl)
    jbackend = j_get_backend(kit["jmodel"], dl)
    viol, vlane, vstep = int(final[8]), int(final[9]), int(final[10])
    lanes = [0, 5, W - 1] if name == "raft" else range(W)
    for lane in lanes if not viol else [vlane]:
        n = int(steps_taken[lane]) if not viol else vstep
        walk = replay_lane(backend, seed, lane, n, device="cpu")
        ref = j_replay(jbackend, seed, lane, n)
        assert walk.violation == ref.violation == viol
        assert walk.labels == ref.labels and walk.halted == ref.halted
        for a, b in zip(walk.fields, ref.fields):
            np.testing.assert_array_equal(a, np.asarray(b))
        # an invariant's state is the new one, a deadlock's the state
        # the lane stopped in: the replay's last state either way
        np.testing.assert_array_equal(
            walk.fields[-1], final[11] if viol else states[lane])


# ---------------------------------------------------------------------------
# supervised runs and checkpoints across the packages
# ---------------------------------------------------------------------------

SUP = dict(walkers=8, depth=16, fp_capacity=1 << 10, check_deadlock=False,
           ckpt_every=4)


def _res(r):
    return (r.steps, r.generated, r.transitions, r.distinct,
            r.fp_saturated, r.violation, r.violation_lane,
            r.violation_step, r.action_generated, r.depth_hist, r.halted)


@pytest.mark.parametrize("first", ["port", "reference"])
def test_sigterm_checkpoint_resumes_in_the_other_package(refs, tmp_path,
                                                         first):
    """sigterm@2 stops one package's supervised run with a checkpoint; the
    other package resumes it with -recover to the uninterrupted result
    (both packages' clean runs equal)."""
    kit = refs["tiny"]
    ck = str(tmp_path / "CK")
    port = dict(model=kit["model"], fn=td.run_sim_supervised,
                plan=FaultPlan, kw=dict(device="cpu"))
    ref = dict(model=kit["jmodel"], fn=jd.run_sim_supervised,
               plan=JFaultPlan, kw={})
    a, b = (port, ref) if first == "port" else (ref, port)
    events = []
    sup = a["fn"](a["model"], seed=7, ckpt_path=ck,
                  faults=a["plan"].parse("sigterm@2"),
                  on_event=lambda k, i: events.append(k), **SUP, **a["kw"])
    assert sup.interrupted and sup.ckpt_writes >= 1
    assert "interrupted" in events and sup.result.steps < 16
    resumed = b["fn"](b["model"], seed=7, ckpt_path=ck, resume=True, **SUP,
                      **b["kw"])
    assert not resumed.interrupted
    clean_t = td.run_sim_supervised(kit["model"], seed=7, device="cpu",
                                    **SUP)
    clean_j = jd.run_sim_supervised(kit["jmodel"], seed=7, **SUP)
    assert _res(resumed.result) == _res(clean_t.result) == _res(
        clean_j.result)


def test_wrong_seed_resume_refused_in_both(refs, tmp_path):
    kit = refs["tiny"]
    ck = str(tmp_path / "CK")
    sup = td.run_sim_supervised(kit["model"], seed=7, ckpt_path=ck,
                                faults=FaultPlan.parse("sigterm@1"),
                                device="cpu", **SUP)
    assert sup.interrupted
    with pytest.raises(ValueError, match="seed mismatch"):
        td.run_sim_supervised(kit["model"], seed=8, ckpt_path=ck,
                              resume=True, device="cpu", **SUP)
    with pytest.raises(ValueError, match="seed mismatch"):
        jd.run_sim_supervised(kit["jmodel"], seed=8, ckpt_path=ck,
                              resume=True, **SUP)


# ---------------------------------------------------------------------------
# lassos on sampled walks
# ---------------------------------------------------------------------------


def test_walk_trajectories_and_lassos_equal_reference(tmp_path):
    cfg = write_model(str(tmp_path), "LiveTiny", LIVE, "SPECIFICATION\n"
                      "Spec\n")
    m, jm = load(cfg), j_load(cfg)
    trajs = tlive.walk_trajectories(m, 4, 16, seed=0, device="cpu")
    jtrajs = jlive.walk_trajectories(jm, 4, 16, seed=0)
    np.testing.assert_array_equal(trajs, jtrajs)
    p = ("cmp", "=", ("name", "x"), ("num", 1))
    for q, holds in (((("cmp", "=", ("name", "x"), ("num", 5))), False),
                     ((("cmp", "=", ("name", "x"), ("num", 3))), True)):
        got = tlive.check_walk_leads_to(m, p, q, "P", trajs)
        want = jlive.check_walk_leads_to(jm, p, q, "P", jtrajs)
        assert got == want and got.holds == holds
    boxed = ("leadsto", ("box", ("name", "P")), ("name", "Q"))
    assert tlive.expressible(boxed) == jlive.expressible(boxed) is not None


# ---------------------------------------------------------------------------
# the seams
# ---------------------------------------------------------------------------


def test_walk_needs_a_struct_backend():
    """The seam that remains: every backend of the port carries the walk's
    routes (struct, generic, KubeAPI), and a SpecBackend whose kernels
    have none - here KubeAPI's expand routes alone - raises."""
    from torchtlc.config import ModelConfig
    from torchtlc.engine.backend import kubeapi_backend

    class ExpandOnly:  # the kernel routes of an engine with no walk
        def __init__(self, kernels):
            self.expand = kernels.expand
            self.deferred = kernels.deferred

    backend = kubeapi_backend(ModelConfig(False, False))
    make_sim_engine(backend, 4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="sim_step"):
        make_sim_engine(backend._replace(kernels=ExpandOnly(
            backend.kernels)), 4, 4, device="cpu")


def test_sim_kernels_refuse_cpu_tensors(refs):
    """The kernel wrappers launch or raise: a CPU tensor never reaches
    K27 / K28 (the routes take the plain versions for those)."""
    from torchtlc.kernels import ops
    from torchtlc.sim.engine import sim_buffers

    prog = get_backend(refs["tiny"]["model"], False).kernels.prog
    buf = sim_buffers(prog, 4, "cpu", False)
    states = torch.zeros(4, prog.F, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ops.struct_sim_step(prog, buf, torch.zeros(2, dtype=torch.uint32),
                            torch.zeros((), dtype=torch.int32), states,
                            torch.ones(4, dtype=torch.bool),
                            torch.zeros(4, dtype=torch.int32), True)
