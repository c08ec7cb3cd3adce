"""Invariant inference in the port (torchtlc.infer) against jaxtlc.infer,
tolerance zero: the same models give the same numbers.

- conjecture: the whole candidate pool field for field (names, ASTs,
  text, source, implies, absint) and the dropped count, on TwoPhase,
  RaftElection (budgets 64 and its whole pool of 1,446), RaftReplication
  and the struct forms of Reconciler and ServiceMesh;
- the [P, S] filter matrix bit for bit: on RaftElection's exact evidence
  (492 states) at budget 64 against the reference's filter, on the plain
  version and on the g++ build of kernel K29 (its matrix and its fold
  forms, torchtlc/kernels/csrc/struct_infer.cuh); the whole pool of 1,446
  on the plain version against the reference's host_filter (its compiled
  rows: no 1,446-predicate XLA build);
- certify_closed on RaftReplication's 7,279 states at budget 64 against
  the reference's certify kernel, on the plain version and on the g++
  build of kernel K30;
- sim_fields round for round (RaftElection at 32 walkers x 32 steps,
  seed 0, as tests/test_infer.py runs it; TwoPhase's deadlocking walk);
- InferReport field for field, the walls left out, on TwoPhase (32),
  RaftElection (64), RaftReplication (64) and a sampled run (TwoPhase
  with a host-BFS budget of 10 states); every reachable-inductive
  certificate of TwoPhase and RaftElection also passes the port's
  host_inductive_check.

The commands are tests/test_torch_infer_cli.py."""

import ctypes
import os

import numpy as np
import pytest
import torch

from jaxtlc.infer.candidates import conjecture as j_conjecture
from jaxtlc.infer.certify import certify_closed as j_certify_closed
from jaxtlc.infer.driver import InferEngine as JInferEngine
from jaxtlc.infer.filter import filter_matrix as j_filter_matrix
from jaxtlc.infer.filter import host_filter as j_host_filter
from jaxtlc.infer.filter import sim_fields as j_sim_fields
from jaxtlc.struct.cache import get_bounds as j_get_bounds
from jaxtlc.struct.loader import load as j_load
from torchtlc.infer.candidates import conjecture
from torchtlc.infer.certify import certify_closed, host_inductive_check
from torchtlc.infer.driver import InferEngine
from torchtlc.infer.filter import filter_matrix, sim_fields
from torchtlc.infer.program import words_to_bits
from torchtlc.kernels.build import build_struct
from torchtlc.struct.cache import get_bounds
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
P = ctypes.c_void_p
LL = ctypes.c_longlong


def cfg(name: str) -> str:
    return os.path.join(SPECS, f"{name}.toolbox", "Model_1", "MC.cfg")


def _strip(rep):
    return rep._replace(wall_s=0.0, filter_wall_s=0.0, certify_wall_s=0.0)


@pytest.fixture(scope="module")
def kit():
    """The reference's engines and reports and the port's, built once:
    TwoPhase (32), RaftElection (64), RaftReplication (64) and a sampled
    TwoPhase run."""
    out = {}
    for key, name, budget, hosts in (("two", "TwoPhase", 32, 50_000),
                                      ("elect", "RaftElection", 64, 50_000),
                                      ("repl", "RaftReplication", 64,
                                       50_000),
                                      ("sampled", "TwoPhase", 32, 10)):
        jm, tm = j_load(cfg(name)), load(cfg(name))
        je = JInferEngine(jm, budget=budget, max_host_states=hosts)
        te = InferEngine(tm, budget=budget, max_host_states=hosts,
                         device="cpu")
        out[key] = dict(jm=jm, tm=tm, je=je, te=te, jrep=je.run(seed=0),
                        trep=te.run(seed=0))
    return out


# ---------------------------------------------------------------------------
# conjecture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,budget", [
    ("TwoPhase", 64), ("RaftElection", 64), ("RaftElection", 10 ** 9),
    ("RaftReplication", 64), ("Reconciler", 10 ** 9),
    ("ServiceMesh", 10 ** 9)])
def test_conjecture_equals_reference(name, budget):
    jm, tm = j_load(cfg(name)), load(cfg(name))
    want, jdrop = j_conjecture(jm, bounds=j_get_bounds(jm), budget=budget)
    got, drop = conjecture(tm, bounds=get_bounds(tm), budget=budget)
    assert drop == jdrop
    assert [tuple(c) for c in got] == [tuple(c) for c in want]
    if name == "RaftElection" and budget > 64:
        assert len(got) == 1446 and drop == 0


# ---------------------------------------------------------------------------
# K29: the [P, S] filter
# ---------------------------------------------------------------------------


def _host_lib(prog):
    lib = ctypes.CDLL(build_struct(prog.text, host=True))
    for fn in ("host_struct_pred_matrix", "host_struct_pred_alive",
               "host_struct_certify"):
        getattr(lib, fn).argtypes = [P, P, LL, P]
    return lib


def _gxx(lib, fn, prog, fields, init):
    K = np.ascontiguousarray(prog.K)
    f = np.ascontiguousarray(fields, np.int32)
    out = init.copy()
    getattr(lib, fn)(K.ctypes.data_as(P), f.ctypes.data_as(P), len(f),
                     out.ctypes.data_as(P))
    return out


def _bits(words: np.ndarray, n: int) -> np.ndarray:
    return words_to_bits(torch.from_numpy(words.view(np.int32)), n).numpy()


def test_filter_matrix_equals_reference_plain_and_gxx(kit):
    """RaftElection's 492 exact states at budget 64: the port's matrix
    (plain), K29's g++ matrix and fold forms and the reference's filter
    agree bit for bit."""
    k = kit["elect"]
    je, te = k["je"], k["te"]
    fields = te.exact_fields
    assert np.array_equal(fields, je.exact_fields)
    want = j_filter_matrix(je.filter_fn, je.exact_fields)
    got = filter_matrix(te.filter_fn, fields)
    assert got.shape == want.shape == (64, 492)
    assert np.array_equal(got, want)
    prog = te.program
    lib = _host_lib(prog)
    mat = _gxx(lib, "host_struct_pred_matrix", prog, fields,
               np.zeros((prog.P, len(fields)), np.uint8))
    assert np.array_equal(mat.astype(bool), want)
    alive = _gxx(lib, "host_struct_pred_alive", prog, fields,
                 np.full(prog.NPW, 0xFFFFFFFF, np.uint32))
    assert np.array_equal(_bits(alive, prog.P), want.all(1))
    assert np.array_equal(te.filter_fn.alive(fields).numpy(), want.all(1))


def test_whole_pool_matrix_equals_reference_host_filter():
    """RaftElection's whole pool of 1,446 candidates (implications that
    apply votedFor[n] and votes[n]) on the plain version, against the
    reference's host_filter over its compiled rows - every candidate
    compiles in both."""
    te = InferEngine(load(cfg("RaftElection")), budget=10 ** 9,
                     device="cpu")
    assert te.program.P == 1446 and te.uncompiled == ()
    jm = j_load(cfg("RaftElection"))
    jcands, _ = j_conjecture(jm, bounds=j_get_bounds(jm), budget=10 ** 9)
    states = [te.backend.cdc.decode(v) for v in te.exact_fields]
    want = j_host_filter(jm.system, jcands, states)
    got = filter_matrix(te.filter_fn, te.exact_fields)
    compiled = ~te._uncompiled_ix
    assert np.array_equal(got[compiled], want[compiled])


# ---------------------------------------------------------------------------
# K30: the certify pass
# ---------------------------------------------------------------------------


def test_certify_closed_equals_reference_plain_and_gxx(kit):
    """RaftReplication's 7,279 exact states at budget 64: the closure bits
    of the port (plain), of K30's g++ build and of the reference agree."""
    k = kit["repl"]
    je, te = k["je"], k["te"]
    fields = te.exact_fields
    assert len(fields) == 7279 and np.array_equal(fields, je.exact_fields)
    n = len(te.candidates)
    want = j_certify_closed(je.certify_fn, je.exact_fields, n)
    got = certify_closed(te.certify_fn, fields, n)
    assert np.array_equal(got, want)
    assert not want.all() and want.any()
    prog = te.program
    esc = _gxx(_host_lib(prog), "host_struct_certify", prog, fields,
               np.zeros(prog.NPW, np.uint32))
    assert np.array_equal(~_bits(esc, prog.P), want)


# ---------------------------------------------------------------------------
# sampled evidence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,deadlock", [("RaftElection", True),
                                           ("TwoPhase", True)])
def test_sim_fields_equal_reference(name, deadlock):
    """Each round's deduplicated rows equal np.unique's, in its order;
    TwoPhase's walk deadlocks, so its later rounds repeat frozen rows."""
    want = j_sim_fields(j_load(cfg(name)), 32, 32, 0,
                        check_deadlock=deadlock)
    got = sim_fields(load(cfg(name)), 32, 32, 0, check_deadlock=deadlock,
                     device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)
    if name == "TwoPhase":
        assert np.array_equal(want[-1], want[-2])


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["two", "elect", "repl", "sampled"])
def test_infer_report_equals_reference(kit, key):
    k = kit[key]
    jrep, trep = k["jrep"], k["trep"]
    assert _strip(trep) == _strip(jrep)
    assert trep.exact == (key != "sampled")
    if key == "sampled":
        assert trep.evidence == "sim" and len(trep.rounds) == 4
    assert trep.certified or key == "sampled"
    if key == "repl":
        return  # the host successors of 7,279 states: minutes, not seconds
    states = ([k["te"].backend.cdc.decode(v) for v in k["te"].exact_fields]
              if trep.exact else [])
    for c, basis in zip(trep.certified, trep.cert_basis):
        if basis == "reachable-inductive":
            assert host_inductive_check(k["tm"].system, c.ast, states), c


def test_engine_reruns_are_launches_only(kit):
    """A second run of a built engine gives the same report (the exact
    evidence and the program are the engine's), and the certify pass of a
    sampled run is skipped: no inductive basis."""
    k = kit["two"]
    assert _strip(k["te"].run(seed=3)) == _strip(k["trep"])._replace(seed=3)
    s = kit["sampled"]["trep"]
    assert all(b == "absint" for b in s.cert_basis)
