"""The port's gen engine (torchtlc.gen.engine.make_gen_engine: kernel K19
through its plain version, K2, the sorted insert around K3, K4) against
jaxtlc.gen.engine.make_gen_engine on the CPU, zero tolerance: every
GenCarry leaf after the run - the fingerprint-table and queue words, the
level counters, generated, distinct, act_gen, act_dist, viol and
viol_state - on the three shipped generic specs, on Reconciler with 3
controllers and MaxGen 3, and on the verdicts: a seeded invariant
violation, slot overflow, deadlock, a full fingerprint table and a full
queue."""

import os

import jax
import numpy as np
import pytest

from jaxtlc.frontend.model import resolve as j_resolve
from jaxtlc.gen.engine import make_gen_engine as j_make
from jaxtlc.gen.tla_parse import load_genspec as j_load
from torchtlc.engine.bfs import (
    VIOL_DEADLOCK,
    VIOL_FPSET_FULL,
    VIOL_QUEUE_FULL,
    VIOL_SLOT_OVERFLOW,
)
from torchtlc.frontend.model import resolve
from torchtlc.gen.engine import check_gen, make_gen_engine
from torchtlc.gen.tla_parse import load_genspec
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECONCILER = os.path.join(ROOT, "specs", "Reconciler.toolbox", "Model_1",
                          "Reconciler.tla")
INVS = ["TypeOK", "AppliedBounded", "ObservedBounded"]
SCALARS = ("parity", "qhead", "level_n", "next_n", "level", "depth",
           "generated", "distinct", "viol")


def _cfg(name):
    return os.path.join(ROOT, "specs", f"{name}.toolbox", "Model_1", "MC.cfg")


def _run_both(jspec, tspec, **geom):
    ji, jr, _, _ = j_make(jspec, **geom)
    jc = jax.block_until_ready(jr(ji()))
    ti, tr, _, _ = make_gen_engine(tspec, **geom, device="cpu")
    return jc, tr(ti())


def _assert_leaves_equal(jc, tc):
    assert np.array_equal(tc.fps.table.numpy().ravel(),
                          np.asarray(jc.fps.table).view(np.int32).ravel())
    assert np.array_equal(tc.queue.numpy(),
                          np.asarray(jc.queue).view(np.int32))
    for name in SCALARS:
        assert getattr(tc, name) == int(getattr(jc, name)), name
    for name in ("act_gen", "act_dist", "viol_state"):
        assert np.array_equal(getattr(tc, name).numpy(),
                              np.asarray(getattr(jc, name))), name


SHIPPED = [("RaftElection", 1024, (1223, 492, 8)),
           ("Reconciler", 1024, (155, 81, 13)),
           ("ServiceMesh", 1024, (6421, 1444, 17)),
           ("ServiceMesh", 64, (6421, 1444, 17))]


@pytest.mark.parametrize("name,chunk,counts", SHIPPED,
                         ids=[f"{n}-{c}" for n, c, _ in SHIPPED])
def test_carry_equals_reference(name, chunk, counts):
    jspec = j_resolve(_cfg(name), workers="cpu").genspec
    tspec = resolve(_cfg(name), workers="cpu").genspec
    jc, tc = _run_both(jspec, tspec, chunk=chunk,
                       queue_capacity=1 << 15, fp_capacity=1 << 20)
    _assert_leaves_equal(jc, tc)
    assert (tc.generated, tc.distinct, tc.depth, tc.viol) == counts + (0,)


def test_scaled_reconciler_carry_equals_reference():
    """3 controllers, MaxGen 3 (the reference's scaled parity size)."""
    consts = {"Controllers": "{c1, c2, c3}", "MaxGen": "3"}
    jc, tc = _run_both(j_load(RECONCILER, consts, INVS, []),
                       load_genspec(RECONCILER, consts, INVS, []),
                       chunk=256, queue_capacity=1 << 12,
                       fp_capacity=1 << 15)
    _assert_leaves_equal(jc, tc)
    assert tc.viol == 0 and tc.distinct > 81


def _edited(tmp_path, old, new, extra_inv=()):
    text = open(RECONCILER).read()
    assert old in text
    path = tmp_path / "Reconciler.tla"
    path.write_text(text.replace(old, new))
    consts = {"Controllers": "{c1, c2}", "MaxGen": "2"}
    invs = INVS + list(extra_inv)
    return (j_load(str(path), consts, invs, []),
            load_genspec(str(path), consts, invs, []))


VERDICTS = {
    # the reference's tests/test_gen.py:116 edit: an invariant that fails
    "invariant": ("====", "NeverObserves == \\A self \\in Controllers : "
                  "observed[self] = 0\n====", ("NeverObserves",), 103),
    # TypeOK's domain of desired below what Bump writes: slot overflow
    "overflow": ("/\\ desired \\in 0..MaxGen", "/\\ desired \\in 0..1", (),
                 VIOL_SLOT_OVERFLOW),
    # no Terminating stutter: the converged state deadlocks
    "deadlock": ("Next == Bump \\/ Terminating \\/", "Next == Bump \\/", (),
                 VIOL_DEADLOCK),
}


@pytest.mark.parametrize("case", sorted(VERDICTS))
def test_violation_carry_equals_reference(case, tmp_path):
    old, new, extra, code = VERDICTS[case]
    jspec, tspec = _edited(tmp_path, old, new, extra)
    jc, tc = _run_both(jspec, tspec, chunk=64, queue_capacity=1 << 10,
                       fp_capacity=1 << 12)
    _assert_leaves_equal(jc, tc)
    assert tc.viol == code
    r = check_gen(tspec, chunk=64, queue_capacity=1 << 10,
                  fp_capacity=1 << 12, device="cpu")
    assert r.violation == code
    if case == "invariant":
        assert r.violation_name == "Invariant NeverObserves is violated"


CAPACITY = {"fp_full": (dict(chunk=64, queue_capacity=1 << 15,
                             fp_capacity=1 << 11), VIOL_FPSET_FULL),
            "queue_full": (dict(chunk=64, queue_capacity=1 << 6,
                                fp_capacity=1 << 20), VIOL_QUEUE_FULL)}


@pytest.mark.parametrize("case", sorted(CAPACITY))
def test_undersized_capacity_carry_equals_reference(case):
    geom, code = CAPACITY[case]
    jspec = j_resolve(_cfg("ServiceMesh"), workers="cpu").genspec
    tspec = resolve(_cfg("ServiceMesh"), workers="cpu").genspec
    jc, tc = _run_both(jspec, tspec, **geom)
    _assert_leaves_equal(jc, tc)
    assert tc.viol == code
