"""The random walk over generic specs in the port against
jaxtlc.sim.engine.make_sim_engine over jaxtlc's gen_backend, tolerance
zero: the walk carry leaf for leaf after round 0 and after every round on
RaftElection, Reconciler and ServiceMesh Model_1 at 64 walkers to depth
24, seeds 0 and 7, the sampling filter on and off - through the plain
versions of kernels K27 and K28 (sim.plain.WalkPlain over the spec's lane
IR) and through the g++ build of the spec's walk text (gen_sim.cuh around
the emitted step, GenProgram.sim_text).  Also the verdicts, each with its
lane, step, state and action and replay_lane landing there as the
reference's replay does: the NeverObserves edit of Reconciler (the
reference's tests/test_gen.py:116, invariant code 103) and Reconciler
without its Terminating stutter, which deadlocks (no shipped generic model
does: each has the stutter) - with check_deadlock, and halting without
it."""

import ctypes
import os

import jax
import numpy as np
import pytest
import torch

from jaxtlc.engine.backend import gen_backend as j_gen_backend
from jaxtlc.frontend.model import resolve as j_resolve
from jaxtlc.gen.tla_parse import load_genspec as j_load
from jaxtlc.sim.engine import make_sim_engine as j_make_sim_engine
from jaxtlc.sim.replay import replay_lane as j_replay
from torchtlc.engine.backend import gen_backend
from torchtlc.frontend.model import resolve
from torchtlc.gen.tla_parse import load_genspec
from torchtlc.kernels.build import build_struct
from torchtlc.sim.engine import (
    carry_to_reference,
    make_sim_engine,
    result_from_sim_carry,
    u32_get,
    u32_set,
)
from torchtlc.sim.replay import replay_lane, walk_trace
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECONCILER = os.path.join(ROOT, "specs", "Reconciler.toolbox", "Model_1",
                          "Reconciler.tla")
INVS = ["TypeOK", "AppliedBounded", "ObservedBounded"]
P, I = ctypes.c_void_p, ctypes.c_int
W, D = 64, 24
SEEDS = (0, 7)
CAPS = (0, 1 << 12)
NAMES = ("RaftElection", "Reconciler", "ServiceMesh")
# the verdicts: (edit of Reconciler.tla, extra invariants, check_deadlock,
# walkers, depth, seed) -> (code, lane, step, action) of the first-wins
# violation (the reference's CPU run)
EDITS = {
    "never": (("====", "NeverObserves == \\A self \\in Controllers : "
               "observed[self] = 0\n===="), ("NeverObserves",), True),
    "deadlock": (("Next == Bump \\/ Terminating \\/", "Next == Bump \\/"),
                 (), True),
    "halt": (("Next == Bump \\/ Terminating \\/", "Next == Bump \\/"),
             (), False),
}
VERDICTS = {"never": (103, 0, 3, 3), "deadlock": (4, 4, 9, -1),
            "halt": (0, -1, 0, -1)}
VW, VD, VSEED = 64, 24, 7


def _cfg(name):
    return os.path.join(ROOT, "specs", f"{name}.toolbox", "Model_1", "MC.cfg")


def _leaves(c):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(c)]


def _same(got, want, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (
            what, i, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), (what, i, a, b)


def _trajectory(jbackend, walkers, depth, cap, seeds, dl=True):
    init_fn, _, step_fn = j_make_sim_engine(
        jbackend, walkers, depth, fp_capacity=cap, check_deadlock=dl)
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
def specs():
    """name -> (reference spec, port spec): the shipped Model_1s."""
    return {n: (j_resolve(_cfg(n), workers="cpu").genspec,
                resolve(_cfg(n), workers="cpu").genspec) for n in NAMES}


@pytest.fixture(scope="module")
def refs(specs):
    """(name, cap) -> seed -> the reference's trajectory; one reference
    engine per geometry, memoized for the module."""
    return {(n, cap): _trajectory(j_gen_backend(specs[n][0]), W, D, cap,
                                  SEEDS)
            for n in NAMES for cap in CAPS}


@pytest.fixture(scope="module")
def edited(tmp_path_factory):
    """case -> (reference spec, port spec) of the edited Reconciler."""
    out = {}
    for case, ((old, new), extra, _) in EDITS.items():
        text = open(RECONCILER).read()
        assert old in text
        path = tmp_path_factory.mktemp(case) / "Reconciler.tla"
        path.write_text(text.replace(old, new))
        consts = {"Controllers": "{c1, c2}", "MaxGen": "2"}
        invs = INVS + list(extra)
        out[case] = (j_load(str(path), consts, invs, []),
                     load_genspec(str(path), consts, invs, []))
    return out


# ---------------------------------------------------------------------------
# K27 and K28 of the walk text through the g++ build
# ---------------------------------------------------------------------------


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


class HostGenSim:
    """The walk routes of GenKernels over host_struct_sim_step and
    host_sim_fold of the g++ build of the spec's walk text."""

    def __init__(self, prog):
        self.prog = prog
        self.lib = ctypes.CDLL(build_struct(prog.sim_text, host=True))
        self.lib.host_struct_sim_step.argtypes = (
            [P] * 5 + [I] + [P] * 3 + [I] * 3 + [P] * 5)
        self.lib.host_sim_fold.argtypes = [I, P, P, I, I] + [P] * 12
        self.K = prog.constants("cpu")

    @staticmethod
    def _u32(t):
        return torch.from_numpy(u32_get(t).numpy().astype(np.uint32))

    def sim_init(self, buf, key, inits, states):
        assert self.lib.host_struct_sim_step(
            _p(self.K), _p(buf.go), _p(self._u32(key)), None, _p(inits),
            inits.shape[0], _p(states), None, None, states.shape[0], 1, 0,
            _p(buf.packed), _p(buf.take), _p(buf.vold), _p(buf.vact),
            _p(buf.scratch)) == 0

    def sim_step(self, buf, key, step_i, states, alive, steps_taken,
                 check_deadlock):
        assert self.lib.host_struct_sim_step(
            _p(self.K), _p(buf.go), _p(self._u32(key)), _p(step_i), None, 0,
            _p(states), _p(alive), _p(steps_taken), states.shape[0], 0,
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


def _backend(spec, route):
    b = gen_backend(spec)
    if route == "gxx":
        b = b._replace(kernels=HostGenSim(b.kernels.prog))
    return b


# ---------------------------------------------------------------------------
# the walk, leaf for leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["plain", "gxx"])
@pytest.mark.parametrize("cap", CAPS, ids=["nofilter", "filter"])
@pytest.mark.parametrize("name", NAMES)
def test_walk_equals_reference(specs, refs, name, cap, route):
    """Round 0 and every round equal the reference's leaf for leaf
    (dtypes and shapes included); run_fn's final carry its last round."""
    backend = _backend(specs[name][1], route)
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


@pytest.mark.parametrize("route", ["plain", "gxx"])
@pytest.mark.parametrize("case", sorted(EDITS))
def test_verdict_and_replay(edited, case, route):
    """The edited Reconciler's walk equals the reference's every round and
    stops at the pinned violation (the invariant's state the new one, the
    deadlock's the state the lane stands in); without check_deadlock the
    lanes halt.  replay_lane (K21 and K18's plain versions on a one-row
    queue) lands on the same violation, step, state and labels as the
    reference's replay; walk_trace decodes through the generic codec."""
    jspec, tspec = edited[case]
    dl = EDITS[case][2]
    want = _trajectory(j_gen_backend(jspec), VW, VD, 0, (VSEED,),
                       dl)[VSEED]
    backend = _backend(tspec, route)
    init_fn, _, step_fn = make_sim_engine(backend, VW, VD,
                                          check_deadlock=dl, device="cpu")
    c = init_fn(VSEED)
    _same(carry_to_reference(c), want[0], (case, 0))
    for d in range(1, VD + 1):
        c = step_fn(c)
        _same(carry_to_reference(c), want[d], (case, d))
    code, lane, step, action = VERDICTS[case]
    assert (int(c.viol), int(c.viol_lane), int(c.viol_step),
            int(c.viol_action)) == (code, lane, step, action)
    r = result_from_sim_carry(c, 0.0, backend, VW, VD, VSEED)
    # the replay's index of the violating state: the invariant's is its
    # round, a deadlock's the state before the round that found no
    # successor; a halted lane stops at its last state
    if case == "halt":
        assert r.halted == VW and r.violation_name == "none"
        lane = int(np.argmin(want[-1][4]))
        at = int(want[-1][4][lane])
        steps = at + 1
    else:
        assert r.violation_name == {
            103: "Invariant NeverObserves is violated",
            4: "Deadlock reached"}[code]
        at, steps = (step - 1 if code == 4 else step), step
    walk = replay_lane(gen_backend(tspec), VSEED, lane, steps,
                       check_deadlock=dl, device="cpu")
    ref = j_replay(j_gen_backend(jspec), VSEED, lane, steps,
                   check_deadlock=dl)
    assert walk.violation == ref.violation == code
    assert walk.violation_step == ref.violation_step == at
    assert walk.labels == ref.labels and walk.halted == ref.halted
    for a, b in zip(walk.fields, ref.fields):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(
        walk.fields[-1], r.violation_state if code else want[-1][1][lane])
    trace = walk_trace(walk, backend.cdc)
    assert trace[-1][0] == backend.cdc.decode(walk.fields[-1])


def test_walk_library_is_a_text_of_its_own(specs):
    """The walk's kernels live in a second text of the spec (gen_sim.cuh),
    printed at the first walk: K19's text includes no walk kernel, and the
    two texts print the same macros and step (and so K19's constant
    table, which sim_text checks)."""
    prog = gen_backend(specs["Reconciler"][1]).kernels.prog
    assert prog._sim_text is None
    assert "emitted_sim.cuh" not in prog.text
    assert prog.sim_text.endswith('#include "gen_sim.cuh"\n')

    def body(text):  # the macros and the emitted functions
        return text.split('#include "struct_prelude.cuh"', 1)[1].rsplit(
            "#include", 1)[0]

    assert body(prog.text) == body(prog.sim_text)


def test_chip_smoke_pin_is_the_reference_walk(specs):
    """chip_smoke.py's phase-26 pin of Reconciler (seed 0): the
    reference's final carry at its geometry."""
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke

    geo = chip_smoke.SIM26
    init_fn, run_fn, _ = j_make_sim_engine(
        j_gen_backend(specs["Reconciler"][0]), geo["walkers"], geo["depth"],
        fp_capacity=geo["fp_capacity"])
    leaves = _leaves(run_fn(jax.jit(init_fn)(0)))
    assert chip_smoke.sim_sha(leaves) == chip_smoke.SIM26_PINS[
        "Reconciler/0"][5]
