"""The smoke class's batched walk (sim.engine.SimEngine) against
jaxtlc.sim.engine.SimEngine, tolerance zero.

- SimEngine.run's final walk carries, lane by lane and leaf for leaf (the
  states, keys, cursors, counters, violation leaves and the sampling
  filter's table words), against the reference's vmapped SimEngine on
  TwoPhaseB with 256 walkers: seeds only (deadlock on and off, a padded
  width) and seeds x configs over the MAXR class;
- each lane against the single-lane engine of the same seed (run and
  run_sequential);
- kernels K34 (struct_sim_step_batched) and K35 (sim_fold_batched)
  through the g++ build of the class's emitted text against their plain
  versions, round for round, from round 0.
"""

import ctypes

import jax
import numpy as np
import pytest
import torch

from jaxtlc.serve import sweep as jsw
from jaxtlc.sim.engine import SimEngine as JSimEngine
from jaxtlc.struct.loader import load as j_load
from test_service import _TPB, _cfg
from torchtlc.kernels.build import build_struct
from torchtlc.serve import sweep as tsw
from torchtlc.sim import engine as se
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

PARAMS = {"MAXR": (0, 2)}
P, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def tpb(tmp_path_factory):
    d = tmp_path_factory.mktemp("simbatch")
    (d / "TwoPhaseB.tla").write_text(_TPB)
    (d / "TwoPhaseB.cfg").write_text(_cfg(2))
    return str(d / "TwoPhaseB.cfg")


def _ref_lanes(out, width):
    return [[np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.tree.map(lambda a: a[k], out))] for k in range(width)]


def _assert_lane(mine, ref, where):
    assert len(mine) == len(ref), where
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, i)


# (params, items, walkers, depth, fp capacity, check_deadlock, width)
CASES = {
    "seeds-deadlock": (None, [(7, None), (8, None), (9, None)], 256, 12,
                       1 << 12, True, 3),
    "seeds-nodeadlock-pad4": (None, [(3, None), (11, None), (5, None)], 256,
                              24, 1 << 12, False, 4),
    "seeds-x-configs": (PARAMS, [(7, {"MAXR": 0}), (8, {"MAXR": 2}),
                                 (7, {"MAXR": 1}), (9, {"MAXR": 2})], 256,
                        24, 1 << 12, False, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sim_engine_run_equals_reference_lane_for_lane(tpb, case):
    params, items, W, D, fp, dl, width = CASES[case]
    kw = dict(walkers=W, depth=D, fp_capacity=fp, check_deadlock=dl,
              width=width)
    if params:
        jm, tm = jsw.load_anchored(tpb, params), tsw.load_anchored(tpb,
                                                                   params)
    else:
        jm, tm = j_load(tpb), load(tpb)
    je = JSimEngine(jm, params=params, **kw)
    ref = _ref_lanes(je._vrun(je._stack(items)), width)
    te = se.SimEngine(tm, params=params, device="cpu", **kw)
    carries, _ = te.run_carries(items)
    assert len(carries) == width
    for k in range(width):  # pad lanes repeat the last item
        _assert_lane(se.carry_to_reference(carries[k]), ref[k], (case, k))
    fields = ("steps", "generated", "transitions", "distinct",
              "fp_saturated", "violation", "violation_lane",
              "violation_step", "violation_action", "action_generated",
              "depth_hist", "halted")
    batched = te.run(items)
    for a, b in zip(batched, te.run_sequential(items)):
        assert [getattr(a, f) for f in fields] == [getattr(b, f)
                                                   for f in fields]
        assert np.array_equal(a.violation_state, b.violation_state)
    assert te._brun.rounds >= max(r.steps for r in batched)


class _HostBatched:
    """StructKernels' batched walk routes over the g++ build of the
    program's emitted text (host_struct_sim_step_batched,
    host_sim_fold_batched)."""

    def __init__(self, prog):
        self.prog = prog
        self.lib = ctypes.CDLL(build_struct(prog.text, host=True))
        self.lib.host_struct_sim_step_batched.argtypes = (
            [P] * 5 + [I] + [P] * 4 + [I] * 4 + [P] * 5)
        self.lib.host_sim_fold_batched.argtypes = (
            [I, P, P, I, I] + [P] * 12 + [I, I])
        self.K = torch.from_numpy(np.ascontiguousarray(prog.K))

    @staticmethod
    def _u32(t):
        return torch.from_numpy(se.u32_get(t).numpy().astype(np.uint32))

    def sim_step_batched(self, buf, c, check_deadlock, init=False,
                         inits=None, n0=None):
        key = self._u32(c.key)
        Kl, W = c.states.shape[:2]

        def p(t):
            return None if t is None else ctypes.c_void_p(t.data_ptr())

        assert self.lib.host_struct_sim_step_batched(
            p(self.K), p(buf.go), p(key), p(c.step_i), p(inits),
            0 if inits is None else inits.shape[1], p(n0), p(c.states),
            p(c.alive), p(c.steps_taken), W, Kl, int(init),
            int(check_deadlock), p(buf.packed), p(buf.take), p(buf.vold),
            p(buf.vact), p(buf.scratch)) == 0

    def sim_fold_batched(self, buf, c, depth, init=False):
        u = {n: self._u32(getattr(c, n))
             for n in ("generated", "transitions", "act_taken")}
        Kl, W = c.states.shape[:2]

        def p(t):
            return ctypes.c_void_p(t.data_ptr())

        assert self.lib.host_sim_fold_batched(
            int(init), p(buf.go), p(buf.scratch), depth, 100, p(c.step_i),
            p(c.viol), p(c.viol_lane), p(c.viol_step), p(c.viol_state),
            p(c.viol_action), p(u["generated"]), p(u["transitions"]),
            p(u["act_taken"]), p(c.states), p(buf.vold), p(buf.vact), W,
            Kl) == 0
        for n, v in u.items():
            se.u32_set(getattr(c, n), torch.from_numpy(v.numpy().astype(
                np.int64)))


@pytest.mark.parametrize("deadlock", [True, False])
def test_k34_k35_gxx_equal_plain_every_round(tpb, deadlock):
    """The batched walk over the g++ kernels and over the plain versions,
    from the same seeds and Init sets: every stacked leaf equal after
    round 0 and after every later round (the sampling filter's words
    included)."""
    m = tsw.load_anchored(tpb, PARAMS)
    be = tsw.sweep_backend(m, PARAMS, deadlock)
    host = be._replace(kernels=_HostBatched(be.kernels.prog))
    seeds = [1, 2, 3]
    inits = [tsw.config_inits(m, PARAMS, {"MAXR": v}, be.cdc)
             for v in (0, 2, 1)]
    engines = [se.make_batched_sim(b, 3, walkers=64, depth=16,
                                   fp_capacity=1 << 10, device="cpu",
                                   check_deadlock=deadlock)
               for b in (be, host)]
    carries = [init(seeds, inits) for init, _ in engines]

    def leaves(c):
        return [x.numpy() if isinstance(x, torch.Tensor) else
                x.table.numpy() for x in c if x is not None]

    for r in range(17):
        for a, b in zip(leaves(carries[0]), leaves(carries[1])):
            assert np.array_equal(a, b), r
        carries = [run(c, 1) for (_, run), c in zip(engines, carries)]
    assert int(carries[0].step_i.max()) > 0
