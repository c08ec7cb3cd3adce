"""The reduction plane in the port against jaxtlc, tolerance zero: the
symmetry plan, kernels K24 ``struct_canon``, K25 ``struct_orbit_check``
and K26 ``struct_por_keep`` (their g++ builds from the reduced program's
emitted text, struct_reduce.cuh, and their plain versions), and the
reduced engines' carries.

- build_plan's field programs, program for program, on TwoPhase Model_sym
  (RM of 3), RaftReplication Model_1 (Nodes of 3: record field-name
  gathers) and TwoPhase with RM of 4 (24 permutations: mask programs);
  the budget rejection of RaftReplication's five nodes; the POR-safe
  action of the two-counter spec of tests/test_reduce.py;
- K24 (g++ and plain) against the reference's canon_host on every
  reachable state of Model_sym and RaftReplication Model_1 and on seeded
  random rows with codes out of range; K25 against orbit_check on popped
  blocks, with the honest plan and with the lie; K26 against por_keep on
  random masks; K17 with K24 and K26 inside (g++) against its plain
  version, the pruned count included;
- the reduced engine against the reference's after every body: Model_sym
  under -symmetry in the sorted immediate, slab deferred and pipelined
  modes (sym_viol, st_sym and the ring's COL_SYM included), the two-counter
  spec under -por (por_pruned, st_pruned), RaftReplication Model_1 reduced
  and narrowed together, the lie latching at the reference's body, and
  the POR deadlock verdict; the sharded engine at D = 1, 2 and 4;
- K8's COL_SYM (g++ build of ring.cuh) against its plain version and the
  reference's pack_row.

The commands are tests/test_torch_reduce_cli.py."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from jaxtlc.analysis.absint import analyze_bounds as j_analyze
from jaxtlc.analysis.symfind import analyze_reduction as j_reduction
from jaxtlc.engine import bfs as jb
from jaxtlc.engine import reduce as jr
from jaxtlc.engine import sharded as js
from jaxtlc.struct.backend import struct_backend as j_struct_backend
from jaxtlc.struct.cache import get_backend as j_get_backend
from jaxtlc.struct.codec import StructCodec as JCodec
from jaxtlc.struct.engine import check_struct as j_check_struct
from jaxtlc.struct.loader import load as j_load
from jaxtlc.struct.shapes import infer_shapes as j_infer
from jaxtlc.struct.shapes import typeok_hints as j_hints
from test_torch_absint import RR5_CFG, write_model
from test_torch_kernels_host import host_lib  # noqa: F401 (a fixture)
from test_torch_narrow import _assert_words_equal, _ref_np
from torchtlc.analysis.absint import analyze_bounds
from torchtlc.analysis.symfind import analyze_reduction
from torchtlc.engine import bfs as tb
from torchtlc.engine import reduce as tr
from torchtlc.engine import sharded as ts
from torchtlc.engine.interop import carry_to_numpy, shard_carry_to_numpy
from torchtlc.engine.interop import SHARD_LEAF_ORDER
from torchtlc.kernels.build import build_struct
from torchtlc.struct.backend import StructProgram, model_shapes
from torchtlc.struct.backend import struct_backend
from torchtlc.struct.cache import get_backend
from torchtlc.struct.codec import StructCodec
from torchtlc.struct.engine import check_struct
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

SYM = "specs/TwoPhase.toolbox/Model_sym/MC.cfg"
RAFT = "specs/RaftReplication.toolbox/Model_1/MC.cfg"
TP4_CFG = ("CONSTANT RM = {r1, r2, r3, r4}\nSPECIFICATION\nSpec\n"
           "INVARIANT\nTypeOK\nAgreement\nCommitVoted\n")
# the reference's two-counter POR spec (tests/test_reduce.py:203-234)
PORV = """---- MODULE PorV ----
EXTENDS Naturals
VARIABLES x, y

Init == x = 0 /\\ y = 0

IncX == /\\ x < 4
        /\\ x' = x + 1
        /\\ UNCHANGED <<y>>

IncY == /\\ y < 4
        /\\ y' = y + 1
        /\\ UNCHANGED <<x>>

Next == IncX \\/ IncY

Spec == Init /\\ [][Next]_<<x, y>>

InRange == x <= 4
====
"""
PORV_CFG = "SPECIFICATION\nSpec\nINVARIANT\nInRange\n"
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@pytest.fixture(scope="module")
def cfgs(tmp_path_factory):
    root = tmp_path_factory.mktemp("reduce")
    two = open("specs/TwoPhase.toolbox/Model_1/TwoPhase.tla").read()
    raft = open("specs/RaftReplication.toolbox/Model_1/"
                "RaftReplication.tla").read()
    return {"sym": SYM, "raft": RAFT,
            "tp4": write_model(root, "tp4", two, TP4_CFG, "TwoPhase"),
            "rr5": write_model(root, "rr5", raft, RR5_CFG,
                               "RaftReplication"),
            "porv": write_model(root, "PorV", PORV, PORV_CFG)}


@pytest.fixture(scope="module")
def pairs(cfgs):
    """name -> (port model, reference model, port reduced backend,
    reference reduced backend), without the deadlock check."""
    out = {}
    for name, sym, por in (("sym", True, False), ("raft", True, False),
                           ("tp4", True, False), ("porv", False, True)):
        m, jm = load(cfgs[name]), j_load(cfgs[name])
        out[name] = (m, jm, get_backend(m, False, symmetry=sym, por=por),
                     j_get_backend(jm, False, symmetry=sym, por=por))
    return out


def _p(a):
    return a.ctypes.data_as(P)


def _host(prog):
    lib = ctypes.CDLL(build_struct(prog.text, host=True))
    lib.host_struct_canon.argtypes = [P, P, LL, P]
    lib.host_struct_orbit_check.argtypes = [P, P, P, LL, P]
    lib.host_struct_por_keep.argtypes = [P, LL, P]
    lib.host_struct_expand_red.argtypes = [P, P, I, I, I] + [P] * 7
    return lib


def _programs_equal(tp, jp):
    assert tp.n_perms == jp.n_perms and tp.sym_sets == jp.sym_sets
    assert len(tp.programs) == len(jp.programs) == tp.n_perms - 1
    for a, b in zip(tp.programs, jp.programs):
        assert (a.src is None) == (b.src is None)
        if a.src is not None:
            np.testing.assert_array_equal(a.src, b.src)
        assert len(a.tables) == len(b.tables)
        for (fa, ta, ga), (fb, tb_, gb) in zip(a.tables, b.tables):
            assert (fa, ga) == (fb, gb)
            np.testing.assert_array_equal(ta, tb_)
        assert a.masks == b.masks


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,perms,gathers,masks", [
    ("sym", 6, False, True), ("raft", 6, True, False),
    ("tp4", 24, False, True)])
def test_plan_equals_reference(pairs, name, perms, gathers, masks):
    """build_plan's programs field for field, and the backend's reduction
    facts (sets, dropped sets, orbit factor) - the same as the
    reference's."""
    _, _, t, j = pairs[name]
    _programs_equal(t.reduce.plan, j.reduce.plan)
    assert t.reduce.plan.n_perms == t.reduce.orbit_factor == perms
    assert t.reduce.sym_sets == j.reduce.sym_sets
    assert t.reduce.dropped_sets == j.reduce.dropped_sets
    assert t.reduce.safe_ids == j.reduce.safe_ids == ()
    progs = t.reduce.plan.programs
    assert any(p.src is not None for p in progs) == gathers
    assert any(p.masks for p in progs) == masks
    assert t.kernels.prog.sym_programs and t.kernels.prog.por_safe is None
    assert "#define ST_SYM 1" in t.kernels.prog.text


def test_budget_rejection_and_dropped_sets(cfgs):
    """RaftReplication with five nodes: the group (120) is past the
    budget, so symfind rejects Nodes - the same set and reason in both
    packages - and build_plan keeps nothing."""
    m, jm = load(cfgs["rr5"]), j_load(cfgs["rr5"])
    rep, jrep = analyze_reduction(m), j_reduction(jm)
    assert rep.symmetric_sets == jrep.symmetric_sets == {}
    assert rep.rejected_sets == jrep.rejected_sets
    assert "Nodes" in rep.rejected_sets
    sv = m.system
    cdc = StructCodec(sv.variables, model_shapes(m))
    jsv = jm.system
    jcdc = JCodec(jsv.variables, j_infer(
        jsv.ev, jsv.variables, jsv.init_ast, jsv.next_ast,
        hints=j_hints(jsv.ev, jm.invariants, jsv.variables)))
    assert tr.build_plan(cdc, {}) == jr.build_plan(jcdc, {}) == (None, {})


def test_por_safe_ids(pairs):
    """The two-counter spec: IncY is the one POR-safe action, in both
    packages; its text carries ST_POR 1 and no symmetry plan."""
    _, _, t, j = pairs["porv"]
    assert t.reduce.safe_ids == j.reduce.safe_ids == (1,)
    assert t.reduce.plan is None and t.reduce.por_on
    prog = t.kernels.prog
    assert prog.por_safe == (False, True) and not prog.sym_programs
    assert "#define ST_POR 1" in prog.text and "#define ST_SYM 0" in prog.text


# ---------------------------------------------------------------------------
# K24, K25, K26 and K17 with them (g++ builds and plain versions)
# ---------------------------------------------------------------------------


_REACH = {}


def _reachable(m, prog):
    """Every reachable state of m as prog's fields (once per model): the
    unreduced backend's state enumerator, unpacked."""
    key = m.source_digest
    if key not in _REACH:
        base = get_backend(m, False)
        assert base.cdc.widths == prog.cdc.widths
        init_fn, run_fn = tb.make_enumerator(
            base, chunk=256, state_capacity=1 << 14, fp_capacity=1 << 16,
            device="cpu")
        c = run_fn(init_fn())
        assert c.viol == tb.OK
        _REACH[key] = base.cdc.unpack(c.states[:c.tail]).numpy().astype(
            np.int32)
    return _REACH[key]


def _random_rows(prog, n, seed):
    mc = np.asarray(prog.cdc.max_codes(), np.int64)
    rng = np.random.default_rng(seed)
    return rng.integers(-2, mc + 3, size=(n, prog.F)).astype(np.int32)


def _lying(prog, jplan_sets, jcdc):
    """(port program, reference plan) of the same plans with the lie."""
    plan = tr.ReducePlan(prog.cdc, prog.plan.sym_sets, lie=True)
    lie = StructProgram(prog.step_outputs, prog.inv_outputs, prog.cdc,
                        prog.lane_action, prog.n_labels, title="lie",
                        plan=plan)
    return lie, jr.ReducePlan(jcdc, jplan_sets, lie=True)


@pytest.mark.parametrize("name", ["sym", "raft"])
def test_k24_host_and_plain_equal_reference(pairs, name):
    m, _, t, j = pairs[name]
    prog, jplan = t.kernels.prog, j.reduce.plan
    lib = _host(prog)
    rows = np.concatenate([_reachable(m, prog),
                           _random_rows(prog, 4096, 24)])
    want = jplan.canon_host(rows)
    out = np.zeros_like(rows)
    lib.host_struct_canon(_p(prog.K), _p(rows), len(rows), _p(out))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        prog.plan.canon(torch.from_numpy(rows)).numpy(), want)
    np.testing.assert_array_equal(prog.plan.canon_host(rows), want)
    # the lie: a corrupted table, the same in both packages
    lie, jlie = _lying(prog, jplan.sym_sets, j.cdc)
    want = jlie.canon_host(rows)
    assert not np.array_equal(want, jplan.canon_host(rows))
    out = np.zeros_like(rows)
    _host(lie).host_struct_canon(_p(lie.K), _p(rows), len(rows), _p(out))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(
        lie.plan.canon(torch.from_numpy(rows)).numpy(), want)


def _blocks(prog, states, size):
    for i in range(0, len(states), size):
        rows = states[i:i + size]
        yield prog.cdc.pack(torch.from_numpy(rows)), len(rows)


@pytest.mark.parametrize("name,size,limit", [("sym", 8, None),
                                             ("raft", 384, 1536)])
def test_k25_and_k17_host_equal_plain_and_reference(pairs, name, size,
                                                    limit):
    """K25 on popped blocks of reachable states (every one of Model_sym,
    RaftReplication's first `limit`) against its plain version
    and the reference's orbit_check on the canonical candidates; K17 with
    K24 inside (g++, immediate and deferred, the last rows past n) against
    its plain version; then the same with the lie, which trips K25 on some
    block of Model_sym in all three."""
    m, _, t, j = pairs[name]
    prog, jplan = t.kernels.prog, j.reduce.plan
    states = _reachable(m, prog)[:limit]
    lie, jlie = _lying(prog, jplan.sym_sets, j.cdc)
    tripped = []
    for p_, jp_ in ((prog, jplan), (lie, jlie)):
        lib = _host(p_)
        got = []
        for block, n in _blocks(p_, states, size):
            ck = block.shape[0]
            ref = p_.expand_red_plain(block, n, deferred=True)
            flat, fvalid = ref[4], ref[1][0].bool()
            plain = bool(p_.plan.orbit_check(flat, fvalid))
            want = bool(jp_.orbit_check(jnp.asarray(flat.numpy()),
                                        jnp.asarray(fvalid.numpy())))
            flag = np.zeros(1, np.int32)
            valid = np.ascontiguousarray(ref[1][0].numpy())
            lib.host_struct_orbit_check(
                _p(p_.K), _p(np.ascontiguousarray(block.numpy())),
                _p(valid), ck * p_.L, _p(flag))
            assert plain == want == bool(flag[0])
            got.append(want)
            # K17 (immediate and deferred) with K24 inside
            for deferred in (False, True):
                ref = p_.expand_red_plain(block, max(1, n - 3), deferred)
                ncand = ck * p_.L
                packed = np.zeros((ncand, p_.W), np.int32)
                flags = np.zeros((3 + p_.n_inv, ncand), np.uint8)
                action = np.zeros(ncand, np.int32)
                fl = np.zeros((ncand, p_.F), np.int32)
                gen = np.zeros(p_.n_labels, np.uint64)
                lib.host_struct_expand_red(
                    _p(p_.K), _p(np.ascontiguousarray(block.numpy())), ck,
                    max(1, n - 3), int(deferred), _p(packed), _p(flags),
                    _p(action), _p(fl) if deferred else None, _p(gen), None,
                    None)
                for g, w in zip((packed, flags, action, gen.astype(np.int64)),
                                ref):
                    np.testing.assert_array_equal(g, w.numpy())
                if deferred:
                    np.testing.assert_array_equal(fl, ref[4].numpy())
        tripped.append(any(got))
    assert tripped[0] is False and tripped[1] is (name == "sym" or
                                                 tripped[1])


def test_k26_and_k17_por_host_equal_plain_and_reference(pairs):
    """K26 on seeded random [B, L] masks against por_keep (both
    packages), and K17 with K26 inside against its plain version: the
    kept lanes and the pruned count."""
    m, _, t, _ = pairs["porv"]
    prog = t.kernels.prog
    lib = _host(prog)
    rng = np.random.default_rng(26)
    for B, density in ((1, 0.5), (257, 0.3), (1024, 0.9), (64, 0.0)):
        valid = rng.random((B, prog.L)) < density
        want = np.asarray(jr.por_keep(
            jnp.asarray(valid), jnp.asarray(prog.lane_action),
            jnp.asarray(np.array(prog.por_safe)), prog.n_labels))
        plain = t.kernels.por_keep(torch.from_numpy(valid)).numpy()
        keep = np.zeros((B, prog.L), np.uint8)
        lib.host_struct_por_keep(_p(valid.astype(np.uint8)), B, _p(keep))
        np.testing.assert_array_equal(plain, want)
        np.testing.assert_array_equal(keep.astype(bool), want)
    states = _reachable(m, prog)
    block = prog.cdc.pack(torch.from_numpy(states))
    ck, n = block.shape[0], len(states) - 2
    ref = prog.expand_red_plain(block, n)
    ncand = ck * prog.L
    packed = np.zeros((ncand, prog.W), np.int32)
    flags = np.zeros((3 + prog.n_inv, ncand), np.uint8)
    action = np.zeros(ncand, np.int32)
    gen = np.zeros(prog.n_labels, np.uint64)
    pruned = np.zeros(1, np.uint64)
    lib.host_struct_expand_red(
        _p(prog.K), _p(np.ascontiguousarray(block.numpy())), ck, n, 0,
        _p(packed), _p(flags), _p(action), None, _p(gen), None, _p(pruned))
    for g, w in zip((packed, flags, action, gen.astype(np.int64)), ref):
        np.testing.assert_array_equal(g, w.numpy())
    assert int(pruned[0]) == int(ref[7]) > 0


# ---------------------------------------------------------------------------
# the reduced engines
# ---------------------------------------------------------------------------


def _step_both(tback, jback, kw, pipeline=False, every=True, **jkw):
    deferred = kw["deferred"]
    j_init, j_run, j_step = jb.make_backend_engine(
        jback, pipeline=pipeline, donate=False, **kw, **jkw)
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
MODES = {"sorted-immediate-ring": (False, False, False, 8),
         "slab-deferred": (True, True, False, 0),
         "pipelined-immediate-ring": (False, False, True, 8)}


@pytest.mark.parametrize("mode", list(MODES))
def test_sym_carry_equals_reference_every_body(pairs, mode):
    sf, de, pl, obs = MODES[mode]
    _, _, t, j = pairs["sym"]
    kw = dict(chunk=32, queue_capacity=1024, fp_capacity=4096,
              sort_free=sf, deferred=de, obs_slots=obs)
    tc, bodies = _step_both(t, j, kw, pipeline=pl)
    assert (int(tc.generated), int(tc.distinct), int(tc.depth)) == (
        228, 80, 11)
    assert bodies > 10 and not bool(tc.sym_viol)
    assert (tc.st_sym is not None) == pl and tc.por_pruned is None


def test_por_carry_equals_reference_every_body(pairs):
    _, _, t, j = pairs["porv"]
    for pl in (False, True):
        kw = dict(chunk=2, queue_capacity=64, fp_capacity=256,
                  sort_free=False, deferred=False, obs_slots=4)
        tc, _ = _step_both(t, j, kw, pipeline=pl)
        assert int(tc.distinct) == 9 and int(tc.por_pruned) == 4
        assert tc.sym_viol is None and (tc.st_pruned is not None) == pl


def test_raft_reduced_and_narrowed_equal_reference(pairs):
    """RaftReplication Model_1 reduced over the narrowed codec (record
    field-name gathers, the runtime certificate beside the orbit check):
    the whole carry at the end, table words included, against the
    reference's; its counts are the un-narrowed reduced run's."""
    m, jm, t, _ = pairs["raft"]
    kw = dict(chunk=256, queue_capacity=1 << 12, fp_capacity=1 << 14,
              sort_free=False, deferred=False, obs_slots=8)
    rep, jrep = analyze_bounds(m), j_analyze(jm)
    tn = get_backend(m, False, bounds=rep, symmetry=True)
    jn = j_get_backend(jm, False, bounds=jrep, symmetry=True)
    _programs_equal(tn.reduce.plan, jn.reduce.plan)
    assert tn.cdc.n_words < t.cdc.n_words
    tc, _ = _step_both(tn, jn, kw, every=False)
    assert not bool(tc.cert_viol) and not bool(tc.sym_viol)
    r = check_struct(m, check_deadlock=False, device="cpu", symmetry=True,
                     chunk=256, queue_capacity=1 << 12, fp_capacity=1 << 14)
    assert (int(tc.generated), int(tc.distinct), int(tc.depth)) == (
        r.generated, r.distinct, r.depth)
    assert r.distinct * 4 < 7279 and r.sym_violated is False


def test_lie_latches_at_reference_body(pairs, monkeypatch):
    """A backend built with the lie (each package's debug variable): the
    sticky flag and the ring's COL_SYM latch at the reference's body."""
    m, jm, _, _ = pairs["sym"]
    monkeypatch.setenv("TORCHTLC_DEBUG_SYM_LIE", "1")
    monkeypatch.setenv("JAXTLC_DEBUG_SYM_LIE", "1")
    t = struct_backend(m, False, symmetry=True)
    j = j_struct_backend(jm, False, symmetry=True)
    kw = dict(chunk=32, queue_capacity=1024, fp_capacity=4096,
              sort_free=False, deferred=False, obs_slots=8)
    tc, _ = _step_both(t, j, kw)
    assert bool(tc.sym_viol)
    r = tb.result_from_carry(tc, 0.0, labels=t.labels)
    assert r.sym_violated is True
    assert tb.obs_rows(tc)[0][-1].get("sym_violation") is True


def test_por_keeps_the_deadlock_verdict(cfgs):
    """The two-counter spec with the deadlock check: (4, 4) has no
    successor; under -por the port halts on the reference's deadlock
    state with the reference's counts (a pruned row always keeps a lane,
    so the post-pruning valid flags give the pre-pruning deadlock)."""
    m, jm = load(cfgs["porv"]), j_load(cfgs["porv"])
    kw = dict(chunk=4, queue_capacity=64, fp_capacity=256)
    r = check_struct(m, por=True, device="cpu", **kw)
    jr_ = j_check_struct(jm, por=True, **kw)
    assert r.violation_name == jr_.violation_name == "Deadlock reached"
    np.testing.assert_array_equal(r.violation_state,
                                  np.asarray(jr_.violation_state))
    assert (r.generated, r.distinct, r.depth, r.por_pruned) == (
        jr_.generated, jr_.distinct, jr_.depth, jr_.por_pruned)


@pytest.mark.parametrize("name,D,modes", [
    ("sym", 1, {}), ("sym", 2, dict(pipeline=True, obs_slots=8)),
    ("sym", 4, dict(sort_free=True, deferred=True)),
    ("porv", 2, {})])
def test_sharded_carries_equal_reference(pairs, name, D, modes):
    """The sharded engine over a reduced backend: canonicalized seeds
    (canon_host), K21 with K24 / K26 inside - every ShardCarry leaf after
    a full run."""
    _, _, t, j = pairs[name]
    kw = dict(chunk=16, queue_capacity=512, fp_capacity=2048, **modes)
    j_init, j_run = js.make_sharded_engine(
        None, Mesh(np.array(jax.devices()[:D]), ("fp",)), backend=j, **kw)
    t_init, t_run = ts.make_sharded_engine(None, ts.ShardMesh(D, "cpu"),
                                           backend=t, **kw)
    jc = jax.block_until_ready(j_run(j_init()))
    tc = t_run(t_init())
    mine = shard_carry_to_numpy(tc)
    ref = {f: np.asarray(getattr(jc, f)) for f in SHARD_LEAF_ORDER
           if getattr(jc, f, None) is not None}
    assert set(mine) == set(ref)
    for f, want in ref.items():
        assert mine[f].dtype == want.dtype and np.array_equal(mine[f], want), f
    r = ts.result_from_shard_carry(tc, 0.0, labels=t.labels)
    assert r.distinct == (80 if name == "sym" else 9)


@pytest.mark.parametrize("sym", [False, True])
def test_ring_header_sym_column_equals_plain(host_lib, sym):
    """K8 with the carry's orbit flag: the g++ build of ring.cuh and
    ring_row_plain write the same row, COL_SYM the flag, the reference's
    pack_row the same words."""
    from jaxtlc.obs import counters as jcnt
    from torchtlc.obs import counters as tcnt

    rng = np.random.default_rng(24 + int(sym))
    n_labels, slots = 5, 4
    cols = tcnt.ring_cols(n_labels)
    ring0 = rng.integers(-2**31, 2**31, (slots + 1, cols)).astype(np.int32)
    ring0[:, tcnt.COL_OVERFLOW] = 0
    old = rng.integers(100, 120, 2 * (n_labels + 1))
    new = old + rng.integers(0, 40, old.shape)
    a_gen = np.ascontiguousarray(new[:n_labels + 1])
    a_dist = np.ascontiguousarray(new[n_labels + 1:])
    flag = np.array([sym], np.bool_)
    host_lib.host_ring_row_sym.argtypes = (host_lib.host_ring_row.argtypes
                                           + [P, P])
    host = ring0.copy()
    hb = np.array([6, 3, 700], np.int64)  # head, bodies, expanded
    host_lib.host_ring_row_sym(host.ctypes.data, slots, cols, hb.ctypes.data,
                               hb[1:].ctypes.data, hb[2:].ctypes.data, 64, 1,
                               9, 500, 480, 200, 190, 33, a_gen.ctypes.data,
                               a_dist.ctypes.data, old.ctypes.data, None,
                               None, n_labels + 1, n_labels, None, None, 0,
                               None, flag.ctypes.data)
    ring = torch.from_numpy(ring0.copy())
    head, bodies, expanded = (torch.tensor(v) for v in (6, 3, 700))
    t = torch.tensor
    tcnt.ring_row_plain(ring, head, bodies, expanded, 64, True, t(9),
                        t(500), t(480), t(200), t(190), t(33),
                        torch.from_numpy(a_gen), torch.from_numpy(a_dist),
                        torch.from_numpy(old), n_labels, sym=t(sym))
    assert (host == ring.numpy()).all()
    row = host[6 % slots].view(np.uint32)
    assert row[tcnt.COL_SYM] == int(sym) and row[tcnt.COL_CERT] == 0
    want = jcnt.pack_row(
        *map(np.int64, (9, 500, 200, 33, 4, 764)),
        a_gen[:n_labels].astype(np.uint32),
        a_dist[:n_labels].astype(np.uint32), overflow=row[tcnt.COL_OVERFLOW],
        sym=np.bool_(sym))
    assert (np.asarray(want) == row).all()
