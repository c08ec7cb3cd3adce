"""Struct `-narrow` in the port against jaxtlc, tolerance zero: kernel K23
``struct_cert_check`` and the certificate inside K17 (kCert) and K18, and
the narrowed engine's carries.

- K23's g++ build (struct_cert.cuh from the narrowed program's emitted
  text) and its plain version against the reference's make_cert_check on
  legal rows and on doctored ones: a field past its maximum code, a
  negative field, a mask over its cardinality bound, and an invalid row
  that breaks a bound and must not count;
- K17's kCert form and K18 with the certificate, as g++ builds them,
  against their plain versions, with the certificate clean and tripped;
- the narrowed engine (a certified report on the five guard-bounded
  counters and on RaftReplication Model_1) in the sorted immediate, slab
  deferred and pipelined modes: every carry leaf - the sticky cert_viol,
  the staged st_cert and the ring's COL_CERT included - equal to the
  reference's after every body (Wide) or at the end (RaftReplication);
- the lies of tests/test_absint.py: the cardinality lie (no trap: only
  the certificate catches it) latches at the reference's body in the
  immediate and in the deferred mode, ring row for ring row; the interval
  lie halts on the kept trap with the reference's code, name and state.

K8's certificate column is held against its plain version in
tests/test_torch_kernels_host.py; the commands in
tests/test_torch_narrow_cli.py."""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaxtlc.analysis.absint import analyze_bounds as j_analyze
from jaxtlc.engine import bfs as jb
from jaxtlc.struct import shapes as jshapes
from jaxtlc.struct.backend import _card_specs as j_card_specs
from jaxtlc.struct.backend import make_cert_check
from jaxtlc.struct.cache import get_backend as j_get_backend
from jaxtlc.struct.engine import check_struct as j_check_struct
from jaxtlc.struct.loader import load as j_load
from test_torch_absint import SLOTC, SLOTC_CFG, WIDE, WIDE_CFG, write_model
from torchtlc.analysis.absint import analyze_bounds
from torchtlc.engine import bfs as tb
from torchtlc.engine.interop import LEAF_ORDER, carry_to_numpy
from torchtlc.kernels.build import build_struct
from torchtlc.struct import shapes
from torchtlc.struct.cache import get_backend
from torchtlc.struct.engine import check_struct
from torchtlc.struct.loader import load
from torchtlc.struct.oracle import bfs as oracle_bfs
from torchtlc.testing import one_thread

one_thread()

RAFT = "specs/RaftReplication.toolbox/Model_1/MC.cfg"
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@pytest.fixture(scope="module")
def cfgs(tmp_path_factory):
    root = tmp_path_factory.mktemp("narrow")
    return {"wide": write_model(root, "Wide", WIDE, WIDE_CFG),
            "slotc": write_model(root, "SlotC", SLOTC, SLOTC_CFG),
            "raft": RAFT}


def _reports(cfg):
    m, jm = load(cfg), j_load(cfg)
    return m, jm, analyze_bounds(m), j_analyze(jm)


@pytest.fixture(scope="module")
def card_lie(cfgs):
    """SlotC with the cardinality lie |msgs| <= 1 (tests/test_absint.py:
    312-355): the honest report bounds |msgs| by its universe only."""
    m, jm, rep, jrep = _reports(cfgs["slotc"])
    assert rep.card_bounds["msgs"] == rep.card_universe["msgs"]
    lie = dataclasses.replace(rep, card_bounds={**rep.card_bounds,
                                                "msgs": 1})
    jlie = dataclasses.replace(jrep, card_bounds={**jrep.card_bounds,
                                                  "msgs": 1})
    return m, jm, lie, jlie


def _host(prog):
    lib = ctypes.CDLL(build_struct(prog.text, host=True))
    lib.host_struct_cert_check.argtypes = [P, P, LL, P]
    lib.host_struct_expand_cert.argtypes = [P, P, I, I, I] + [P] * 6
    lib.host_struct_inv_rows_cert.argtypes = [P, P, LL, P, P, P, I] + [P] * 4
    return lib


def _p(a):
    return a.ctypes.data_as(P)


def _doctored(prog, rng, n=96):
    """{case: (rows [n, F] int32, valid [n] bool, breaks a bound)}."""
    max_code, specs = prog.cert
    mc = np.asarray(max_code, np.int64)
    rows = (rng.random((n, len(mc))) * (mc + 1)).astype(np.int32)
    for off, nf, bound in specs:  # a legal mask: at most `bound` bits
        rows[:, off:off + nf] = 0
        bits = int(mc[off]).bit_length()
        rows[:, off] = (1 << rng.integers(0, bits, n)) * (bound > 0)
    valid = rng.random(n) < 0.8
    valid[7] = True
    out = {"legal": (rows, valid, False)}
    j = int(np.argmax(mc))
    r = rows.copy()
    r[7, j] = mc[j] + 1
    out["past-max"] = (r, valid, True)
    r = rows.copy()
    r[7, 0] = -1
    out["negative"] = (r, valid, True)
    v = valid.copy()
    v[7] = False
    out["invalid-row"] = (out["past-max"][0], v, False)
    if specs:
        off, nf, bound = specs[0]
        r = rows.copy()
        r[7, off] = (1 << (bound + 1)) - 1  # bound + 1 bits
        out["mask-over-bound"] = (r, valid, True)
    return out


@pytest.mark.parametrize("which", ["raft", "card-lie"])
def test_k23_host_and_plain_equal_reference(cfgs, card_lie, which):
    if which == "raft":
        m, jm, rep, jrep = _reports(cfgs["raft"])
    else:
        m, jm, rep, jrep = card_lie
    prog = get_backend(m, False, bounds=rep).kernels.prog
    jback = j_get_backend(jm, False, bounds=jrep)
    specs = j_card_specs(jback.cdc, jm.system.variables, jrep.card_bounds)
    assert [list(s) for s in prog.cert[1]] == [list(s) for s in specs]
    assert bool(prog.cert[1]) == (which == "card-lie")
    ref = make_cert_check(jback.cdc, specs)
    lib = _host(prog)
    cases = _doctored(prog, np.random.default_rng(23))
    for case, (rows, valid, want) in cases.items():
        got_ref = bool(ref(jnp.asarray(rows), jnp.asarray(valid)))
        plain = bool(prog.cert_plain(torch.from_numpy(rows),
                                     torch.from_numpy(valid)))
        flag = np.zeros(1, np.int32)
        lib.host_struct_cert_check(_p(np.ascontiguousarray(rows)),
                                   _p(valid.astype(np.uint8)), len(rows),
                                   _p(flag))
        assert got_ref == plain == bool(flag[0]) == want, case


def test_k17_kcert_and_k18_cert_host_equal_plain(card_lie):
    """K17's kCert form and K18 with the certificate (g++) against their
    plain versions: a block of Init rows (successors within the lie: the
    certificate clean) and a block of every reachable state (a successor
    holds two messages: tripped)."""
    m, _, lie, _ = card_lie
    prog = get_backend(m, False, bounds=lie).kernels.prog
    lib = _host(prog)
    states = list(oracle_bfs(m.system, m.invariants, check_deadlock=False,
                             collect_states=True).states)
    init = [st for st in states if not st[0]]
    for rows_, want in ((init, False), (states, True)):
        fields = np.stack([prog.cdc.encode(st) for st in rows_])
        block = prog.cdc.pack(torch.from_numpy(fields))
        ck = block.shape[0]
        n = max(1, ck - 2)
        ref = prog.expand_plain(block, n, False, cert=True)
        ncand = ck * prog.L
        packed = np.zeros((ncand, prog.W), np.int32)
        flags = np.zeros((3 + prog.n_inv, ncand), np.uint8)
        action = np.zeros(ncand, np.int32)
        gen = np.zeros(prog.n_labels, np.uint64)
        flag = np.zeros(1, np.int32)
        lib.host_struct_expand_cert(
            _p(prog.K), _p(np.ascontiguousarray(block.numpy())), ck, n, 0,
            _p(packed), _p(flags), _p(action), None, _p(gen), _p(flag))
        for g, w in zip((packed, flags, action, gen.astype(np.int64)), ref):
            np.testing.assert_array_equal(g, w.numpy())
        assert bool(flag[0]) == bool(ref[5]) == want
        # K18 with the certificate over every valid lane as a claimant
        flat = prog.expand_plain(block, n, True)[4]
        lanes_ = torch.nonzero(ref[1][0].bool()).flatten()
        fresh = torch.from_numpy(
            np.random.default_rng(5).random(lanes_.numel()) < 0.9)
        rows = lanes_.numel()
        pv, ps, pa, pc = prog.inv_rows_plain(flat, fresh, lanes_, ref[2],
                                             rows, cert=True)
        viol, vact = np.zeros(1, np.int64), np.zeros(1, np.int64)
        state, flag = np.zeros(prog.F, np.int32), np.zeros(1, np.int32)
        lib.host_struct_inv_rows_cert(
            _p(prog.K), _p(np.ascontiguousarray(flat.numpy())), rows,
            _p(fresh.numpy().astype(np.uint8)), _p(lanes_.numpy()),
            _p(ref[2].numpy()), 100, _p(viol), _p(state), _p(vact),
            _p(flag))
        assert (int(viol[0]), int(vact[0]), bool(flag[0])) == (
            int(pv), int(pa), bool(pc))
        np.testing.assert_array_equal(state, ps.numpy())
        assert bool(pc) == want


def _ref_np(jc) -> dict:
    out = {}
    for f in LEAF_ORDER:
        v = jc.fps.table if f == "fps" else getattr(jc, f, None)
        if v is not None:
            out[f] = np.asarray(v)
    return out


def _assert_words_equal(a: dict, b: dict, where=""):
    assert set(a) == set(b), (where, set(a) ^ set(b))
    for f in a:
        assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, (
            where, f)
        assert (a[f] == b[f]).all(), (where, f)


def _step_both(tback, jback, kw, pipeline=False, every=True):
    """Step the port's and the reference's engines body for body (or run
    both to the end), comparing every carry leaf; returns the last port
    carry and the body count."""
    deferred = kw["deferred"]
    j_init, j_run, j_step = jb.make_backend_engine(
        jback, pipeline=pipeline, donate=False, **kw)
    t_init, t_run, t_step = tb.make_backend_engine(
        tback, pipeline=pipeline, device="cpu", **kw)
    jc, tc = j_init(), t_init()

    def mine(c):
        return carry_to_numpy(c, codec=tback.cdc, deferred=deferred)

    _assert_words_equal(mine(tc), _ref_np(jc), 0)
    if not every:
        jc, tc = j_run(jc), t_run(tc)
        _assert_words_equal(mine(tc), _ref_np(jc), "end")
        return tc, t_run.steps
    bodies = 0
    while not tb.carry_done(tc):
        jc, tc = j_step(jc), t_step(tc)
        bodies += 1
        _assert_words_equal(mine(tc), _ref_np(jc), bodies)
    return tc, bodies


# (sort_free, deferred, pipeline, obs_slots)
MODES = {"sorted-immediate": (False, False, False, 0),
         "slab-deferred-ring": (True, True, False, 16),
         "pipelined-immediate-ring": (False, False, True, 16),
         "pipelined-slab-deferred": (True, True, True, 0)}


@pytest.mark.parametrize("mode", list(MODES))
def test_narrowed_wide_carry_equals_reference_every_body(cfgs, mode):
    sf, de, pl, obs = MODES[mode]
    m, jm, rep, jrep = _reports(cfgs["wide"])
    tback = get_backend(m, False, bounds=rep)
    jback = j_get_backend(jm, False, bounds=jrep)
    assert tback.cdc.n_words == 1
    kw = dict(chunk=64, queue_capacity=2048, fp_capacity=4096,
              sort_free=sf, deferred=de, obs_slots=obs)
    tc, bodies = _step_both(tback, jback, kw, pipeline=pl)
    assert int(tc.distinct) == 4 ** 5 and bodies > 10
    assert tc.cert_viol is not None and not bool(tc.cert_viol)
    assert (tc.st_cert is not None) == (pl and not de)


def test_narrowed_raft_carry_equals_reference(cfgs):
    sf, de, pl, obs = MODES["sorted-immediate"]
    m, jm, rep, jrep = _reports(cfgs["raft"])
    tback = get_backend(m, False, bounds=rep)
    jback = j_get_backend(jm, False, bounds=jrep)
    assert (tback.cdc.n_words, jback.cdc.n_words) == (1, 1)
    kw = dict(chunk=256, queue_capacity=1 << 13, fp_capacity=1 << 15,
              sort_free=sf, deferred=de, obs_slots=obs)
    tc, _ = _step_both(tback, jback, kw, pipeline=pl, every=False)
    assert (int(tc.generated), int(tc.distinct), int(tc.depth)) == (
        17431, 7279, 14)
    assert not bool(tc.cert_viol)


@pytest.mark.parametrize("deferred", [False, True],
                         ids=["immediate", "deferred"])
def test_card_lie_latches_at_reference_body(card_lie, deferred):
    """The cardinality lie trips the certificate (no trap can): the sticky
    flag and the ring's COL_CERT latch at the reference's body - the
    immediate mode certifies every valid candidate, the deferred mode only
    the fresh claimants - and the run's counts are the reference's."""
    m, jm, lie, jlie = card_lie
    tback = get_backend(m, False, bounds=lie)
    jback = j_get_backend(jm, False, bounds=jlie)
    kw = dict(chunk=64, queue_capacity=1024, fp_capacity=8192,
              sort_free=deferred, deferred=deferred, obs_slots=8)
    tc, _ = _step_both(tback, jback, kw)
    assert bool(tc.cert_viol)
    r = tb.result_from_carry(tc, 0.0, labels=tback.labels)
    assert r.cert_violated is True
    rows = tb.obs_rows(tc)[0]
    assert rows and rows[-1].get("cert_violation") is True


def test_interval_lie_halts_on_kept_trap(cfgs):
    """The interval lie (a <= 1, reachable 3) keeps its trap: the run halts
    with the slot-overflow code, named a certified-bound escape, on the
    reference's state."""
    m, jm, rep, jrep = _reports(cfgs["wide"])
    lie = dataclasses.replace(rep, bounds={**rep.bounds,
                                           "a": shapes.SInt(0, 1)})
    jlie = dataclasses.replace(jrep, bounds={**jrep.bounds,
                                             "a": jshapes.SInt(0, 1)})
    kw = dict(check_deadlock=False, obs_slots=8, chunk=64,
              queue_capacity=2048, fp_capacity=4096)
    r = check_struct(m, bounds=lie, device="cpu", **kw)
    jr = j_check_struct(jm, bounds=jlie, **kw)
    assert r.violation == jr.violation == tb.VIOL_SLOT_OVERFLOW
    assert r.violation_name == jr.violation_name
    assert "certified-bound escape" in r.violation_name
    np.testing.assert_array_equal(r.violation_state,
                                  np.asarray(jr.violation_state))
    assert (r.generated, r.distinct, r.cert_violated) == (
        jr.generated, jr.distinct, jr.cert_violated)
