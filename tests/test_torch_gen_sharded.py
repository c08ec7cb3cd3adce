"""The sharded engine over generic backends (torchtlc.engine.sharded with
gen_backend's routes: kernel K21 over the gen step, K18 on each owner's
received rows, both in the spec's emitted text beside K19) against
jaxtlc.engine.sharded over the reference's gen_backend, on the CPU (8
virtual devices).  Exact comparisons throughout: K21 and K18 (plain and
g++) against the reference's expand_half rows and make_deferred_checker at
1, 2 and 4 shards, immediate and deferred, with a seeded violation (the
reference's NeverLeads edit of RaftElection); every ShardCarry leaf after
full runs, pipelined ones included.  Checkpoints and the commands are in
tests/test_torch_gen_sharded_cli.py."""

import os

import pytest

from jaxtlc.engine.backend import gen_backend as j_gen_backend
from jaxtlc.frontend.model import resolve as j_resolve
from test_torch_struct_sharded import (
    _assert_carries_equal,
    _run_both,
    check_halves,
)
from torchtlc.engine import sharded as ts
from torchtlc.engine.backend import gen_backend as t_gen_backend
from torchtlc.frontend.model import resolve as t_resolve
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
KW = dict(chunk=32, queue_capacity=1 << 11, fp_capacity=1 << 13)
COUNTS = {"RaftElection": (1223, 492, 8), "Reconciler": (155, 81, 13),
          "ServiceMesh": (6421, 1444, 17)}
NEVER_LEADS = ("NeverLeads == \\A self \\in Nodes : state[self] # "
               "\"Leader\"\n====")


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


def _cfg(name):
    return os.path.join(SPECS, f"{name}.toolbox", "Model_1", "MC.cfg")


def _gen_backends(cfg):
    """(reference backend, port backend) of a generic spec's MC.cfg."""
    kw = dict(workers="cpu", fp_index=0, check_deadlock=True,
              frontend="auto")
    return (j_gen_backend(j_resolve(cfg, **kw).genspec),
            t_gen_backend(t_resolve(cfg, **kw).genspec))


def _never_leads(tmp_path):
    """RaftElection with the NeverLeads invariant, which the first leader
    breaks (the reference's tests/test_gen_parity.py:79-97)."""
    d = tmp_path / "never"
    d.mkdir()
    src = open(os.path.join(os.path.dirname(_cfg("RaftElection")),
                            "RaftElection.tla")).read()
    (d / "RaftElection.tla").write_text(src.replace("====", NEVER_LEADS, 1))
    (d / "MC.cfg").write_text(open(_cfg("RaftElection")).read()
                              + "INVARIANT NeverLeads\n")
    return str(d / "MC.cfg")


@pytest.mark.parametrize("name,D,deferred,steps", [
    ("Reconciler", 1, False, 5), ("Reconciler", 2, True, 6),
    ("ServiceMesh", 4, False, 7), ("ServiceMesh", 4, True, 9),
], ids=["Reconciler-D1-immediate", "Reconciler-D2-deferred",
        "ServiceMesh-D4-immediate", "ServiceMesh-D4-deferred"])
def test_k21_and_k18_equal_reference_halves(name, D, deferred, steps):
    jb, tb = _gen_backends(_cfg(name))
    check_halves(jb, tb, D, KW, steps, deferred)


@pytest.mark.parametrize("deferred", [False, True],
                         ids=["immediate", "deferred"])
def test_seeded_violation_equals_reference(tmp_path, deferred):
    """The NeverLeads edit: at the body where the first leader appears,
    K21's invariant rows (immediate) or K18 on the received rows (deferred)
    report the violation as the reference's halves do; the whole deferred
    sharded run halts with the reference's verdict, code and state."""
    jb, tb = _gen_backends(_never_leads(tmp_path))
    modes = dict(KW, sort_free=deferred, deferred=deferred)
    init_fn, seg = ts.make_sharded_engine(None, ts.ShardMesh(2, "cpu"),
                                          backend=tb, segment=1, **modes)
    c, steps = init_fn(), 0
    while True:  # the body that finds it
        nxt = seg(c)
        if nxt.bundle.viol != 0:
            break
        assert nxt.bundle.cont, "the run ended without a violation"
        c, steps = nxt, steps + 1
    code = 100 + tb.kernels.prog.n_inv - 1
    verdicts, flagged = check_halves(jb, tb, 2, KW, steps, deferred,
                                     want_viol=True)
    assert max(verdicts) == code
    assert (flagged == 0) if deferred else (flagged > 0)
    if deferred:  # the whole run halts as the reference's
        jc, tc, r = _run_both(jb, tb, 2, modes)
        _assert_carries_equal(tc, jc)
        assert r.violation == code and "NeverLeads" in r.violation_name


@pytest.mark.parametrize("name,D,modes", [
    ("Reconciler", 1, {}),
    ("RaftElection", 2, dict(pipeline=True, obs_slots=16)),
    ("ServiceMesh", 4, {}),
    ("RaftElection", 4, dict(pipeline=True, sort_free=True, deferred=True)),
], ids=["Reconciler-D1", "RaftElection-D2-pipelined-ring", "ServiceMesh-D4",
        "RaftElection-D4-pipelined-slab-deferred"])
def test_run_carries_equal_reference(name, D, modes):
    jb, tb = _gen_backends(_cfg(name))
    jc, tc, r = _run_both(jb, tb, D, dict(KW, **modes))
    _assert_carries_equal(tc, jc, name)
    assert (r.generated, r.distinct, r.depth) == COUNTS[name]
