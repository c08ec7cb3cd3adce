"""The port's LaneCompiler and its two realizations against the reference.

* The lane IR evaluated by torch (the plain version of K17 and K18)
  equals jaxtlc's jitted build_step and build_invariant bit for bit - succ,
  valid, ovf, afail, the lane labels and every invariant - on every
  reachable state of TwoPhase Model_1, TwoPhase Model_sym and
  RaftReplication Model_1, and on a seeded sample of the reachable states
  of the other three specs.
* The g++ build of the emitted C++ (the same text nvcc builds for the
  card) equals the IR's torch evaluation: K17 in both modes, and K18
  including a block where an invariant fails (the stale-leader
  RaftReplication).
* pack/unpack equal the reference's codec, and the lane IR's integer
  semantics equal jax.numpy's on the corner cases it relies on.
Every comparison is exact: these are integer state words.
"""

import ctypes
import os

import jax
import jax.numpy as jjnp
import numpy as np
import pytest
import torch

from jaxtlc.struct.codec import StructCodec as JCodec
from jaxtlc.struct.compile import LaneCompiler as JCompiler
from jaxtlc.struct.loader import load as j_load
from jaxtlc.struct.shapes import infer_shapes as j_infer
from jaxtlc.struct.shapes import typeok_hints as j_hints
from torchtlc.kernels.build import build_struct
from torchtlc.struct import lanes, oracle
from torchtlc.struct.backend import StructProgram, compile_model
from torchtlc.struct.loader import load
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVERY_STATE = ("TwoPhase.toolbox/Model_1", "TwoPhase.toolbox/Model_sym",
               "RaftReplication.toolbox/Model_1")
SAMPLED = ("RaftElection.toolbox/Model_1", "Reconciler.toolbox/Model_1",
           "ServiceMesh.toolbox/Model_1")
SAMPLE = 256


def _cfg(name):
    return os.path.join(ROOT, "specs", name, "MC.cfg")


def stale_leader(tmp_path):
    """RaftReplication without Elect's up-to-dateness restriction: a
    leader with a stale log breaks commit safety (tests/
    test_raft_replication.py:49-60)."""
    src = open(os.path.join(ROOT, "specs", "RaftReplication.toolbox",
                            "Model_1", "RaftReplication.tla")).read()
    needle = ("/\\ 2 * Cardinality({m \\in Nodes : UpToDate(n, m)}) "
              "> NodeCount\n            ")
    assert needle in src
    d = tmp_path / "stale"
    d.mkdir()
    (d / "RaftReplication.tla").write_text(src.replace(needle, "", 1))
    (d / "MC.cfg").write_text(open(_cfg("RaftReplication.toolbox/Model_1"))
                              .read())
    return str(d / "MC.cfg")


def _reference(cfg):
    jm = j_load(cfg)
    sy = jm.system
    shapes = j_infer(sy.ev, sy.variables, sy.init_ast, sy.next_ast,
                     hints=j_hints(sy.ev, jm.invariants, sy.variables))
    cdc = JCodec(sy.variables, shapes)
    comp = JCompiler(sy.ev, sy.variables, shapes, cdc)
    step = jax.jit(comp.build_step(sy.next_ast))
    invs = [jax.jit(comp.build_invariant(a)) for a in jm.invariants.values()]
    return cdc, comp, step, invs


def _program(cfg):
    m = load(cfg)
    cdc, comp, step_out, inv_out = compile_model(m)
    labels = list(comp.labels)
    names = tuple(sorted(set(labels)))
    prog = StructProgram(step_out, inv_out, cdc,
                         np.asarray([names.index(x) for x in labels],
                                    np.int32), len(names), title=cfg)
    return m, comp, prog


def _reachable(m, cdc, sample=None, seed=0):
    r = oracle.bfs(m.system, m.invariants, collect_states=True,
                   check_deadlock=False, stop_on_violation=False)
    rows = np.stack([cdc.encode(s) for s in r.states]).astype(np.int32)
    if sample is not None and len(rows) > sample:
        idx = np.random.default_rng(seed).choice(len(rows), sample,
                                                 replace=False)
        rows = rows[np.sort(idx)]
    return rows


@pytest.mark.parametrize("name", EVERY_STATE + SAMPLED)
def test_lane_ir_equals_reference_step_and_invariants(name):
    m, comp, prog = _program(_cfg(name))
    jcdc, jcomp, jstep, jinvs = _reference(_cfg(name))
    rows = _reachable(m, prog.cdc,
                      sample=SAMPLE if name in SAMPLED else None)
    want = [np.asarray(x) for x in jstep(jjnp.asarray(rows))]
    assert comp.labels == jcomp.labels
    got = prog.step_plain(torch.from_numpy(rows))
    # the reference returns (succs, valid, ovf, afail); so does step_plain
    for g, w in zip(got, want):
        assert g.numpy().shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    bits = prog.inv_bits_plain(torch.from_numpy(rows)).numpy()
    for k, f in enumerate(jinvs):
        np.testing.assert_array_equal(
            (bits >> k) & 1, np.asarray(f(jjnp.asarray(rows))).astype(int))


def _host_lib(prog):
    lib = ctypes.CDLL(build_struct(prog.text, host=True))
    lib.host_struct_expand.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
    lib.host_struct_inv_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    return lib


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _host_expand(lib, prog, block, n, deferred):
    ck = block.shape[0]
    ncand = ck * prog.L
    packed = np.zeros((ncand, prog.W), np.int32)
    flags = np.zeros((3 + prog.n_inv, ncand), np.uint8)
    action = np.zeros(ncand, np.int32)
    flat = np.zeros((ncand, prog.F), np.int32)
    gen = np.zeros(prog.n_labels, np.uint64)
    bl = np.ascontiguousarray(block)
    lib.host_struct_expand(_p(prog.K), _p(bl), ck, n, int(deferred),
                           _p(packed), _p(flags), _p(action), _p(flat),
                           _p(gen))
    return packed, flags, action, gen.astype(np.int64), flat


@pytest.mark.parametrize("name", EVERY_STATE + SAMPLED + ("stale",))
def test_emitted_cpp_equals_plain(name, tmp_path):
    """K17 (both modes) and K18 as g++ builds them from the emitted text,
    against the plain versions on the same rows; the last rows of the
    block are not popped (n < ck)."""
    cfg = stale_leader(tmp_path) if name == "stale" else _cfg(name)
    m, _, prog = _program(cfg)
    lib = _host_lib(prog)
    rows = _reachable(m, prog.cdc, sample=SAMPLE)
    block = prog.cdc.pack(torch.from_numpy(rows))
    ck = block.shape[0]
    n = ck - 3
    for deferred in (False, True):
        want = prog.expand_plain(block, n, deferred)
        got = _host_expand(lib, prog, block.numpy(), n, deferred)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w.numpy())
        if deferred:
            np.testing.assert_array_equal(got[4], want[4].numpy())
    # K18 over every valid lane as a claimant, in a seeded order
    flat = want[4]
    valid = want[1][0].bool()
    lanes_ = torch.nonzero(valid).flatten()
    perm = torch.from_numpy(np.random.default_rng(3).permutation(
        lanes_.numel()))
    c_idx = lanes_[perm].to(torch.int64)
    fresh = torch.from_numpy(np.random.default_rng(4).random(
        c_idx.numel()) < 0.8)
    action = want[2]
    for rows_ in (c_idx.numel(), max(1, c_idx.numel() // 2)):
        pv, ps, pa = prog.inv_rows_plain(flat, fresh, c_idx, action, rows_)
        viol = np.zeros(1, np.int64)
        state = np.zeros(prog.F, np.int32)
        vact = np.zeros(1, np.int64)
        fr = fresh.numpy().astype(np.uint8)
        ci = c_idx.numpy()
        fl = np.ascontiguousarray(flat.numpy())
        ac = action.numpy()
        lib.host_struct_inv_rows(_p(prog.K), _p(fl), rows_, _p(fr), _p(ci),
                                 _p(ac), 100, _p(viol), _p(state), _p(vact))
        assert (int(viol[0]), int(vact[0])) == (int(pv), int(pa))
        np.testing.assert_array_equal(state, ps.numpy())
    if name == "stale":
        assert int(pv) >= 100  # the block holds a violating claimant


@pytest.mark.parametrize("name", EVERY_STATE)
def test_pack_unpack_equal_reference(name):
    m, _, prog = _program(_cfg(name))
    jcdc = _reference(_cfg(name))[0]
    rng = np.random.default_rng(11)
    hi = (1 << np.asarray(prog.cdc.widths, np.int64))
    fields = (rng.integers(0, 1 << 62, (500, prog.F)) % hi).astype(np.int32)
    packed = prog.cdc.pack(torch.from_numpy(fields))
    want = np.asarray(jcdc.pack(jjnp.asarray(fields)))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(prog.cdc.unpack(packed).numpy(),
                                  np.asarray(jcdc.unpack(jjnp.asarray(want))))


def test_lane_ir_integer_semantics_equal_jax_numpy():
    """Floor division and modulo of negatives, gathers past either end,
    first-index argmax/argmin on ties, cumsum, wrapping products, a
    one-hot remask and bool/int promotion, through the IR and through
    jax.numpy on the same rows."""
    rng = np.random.default_rng(5)
    rows = rng.integers(-40, 40, (64, 6)).astype(np.int32)
    tab = np.arange(-3, 9, dtype=np.int32) * 7
    onehot = np.zeros((6, 4), bool)
    onehot[[0, 2, 3, 5], [1, 1, 0, 3]] = True

    def program(x, ns):
        a, b = x[:, 0], x[:, 1]
        b = ns.where(b == 0, 3, b)
        m = x[..., None] > ns.arange(3)
        return [a // b, a % b, ns.asarray(tab)[a], ns.argmax(x, axis=-1),
                ns.argmin(x % 4, axis=-1), x.cumsum(axis=-1),
                (x * 123456789) + 2147483000,
                ns.einsum("...u,uv->...v", (x > 0).astype(ns.int32),
                          ns.asarray(onehot).astype(ns.int32)) > 0,
                (x > 2) & 1, (x > 2) & True, m.any(axis=-1).sum(axis=-1),
                ns.clip(a, -5, 5), ns.maximum(a, b), (a >> 2) & 3]

    want = program(jjnp.asarray(rows), jjnp)
    got = lanes.evaluate(program(lanes.input_node(6), lanes),
                         torch.from_numpy(rows))
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.reshape((g.shape[0],) + tuple(g.shape[2:]))
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
