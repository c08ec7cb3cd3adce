"""The port's generic-frontend compiler against jaxtlc's on the CPU, zero
tolerance: GenCodec's layout, encode/decode, pack and unpack against
jaxtlc.gen.codec (the three shipped specs and Reconciler with 4
controllers and MaxGen 4, whose 43-bit states span two words); the lane-IR
step and invariants (torchtlc.gen.kernel on struct.lanes, evaluated by
torch) bitwise against jax.vmap of the reference's step and its invariant
closures on every reachable state; a g++ build of kernel K19 (the emitted
gen_expand.cuh text) against its plain version, the verdict fold included,
on popped blocks that fail an invariant, overflow a slot and deadlock; and
the reference's compile errors with the same messages."""

import ctypes
import os

import jax
import jax.numpy as jjnp
import numpy as np
import pytest
import torch

from jaxtlc.frontend.model import resolve as j_resolve
from jaxtlc.gen import oracle as jo
from jaxtlc.gen.codec import GenCodec as JCodec
from jaxtlc.gen.kernel import CompileError as JCompileError
from jaxtlc.gen.kernel import _Ctx as JCtx
from jaxtlc.gen.kernel import compile_expr as j_compile
from jaxtlc.gen.kernel import make_gen_kernel as j_kernel
from jaxtlc.gen.tla_parse import load_genspec as j_load
from torchtlc.frontend.model import resolve
from torchtlc.gen.codec import GenCodec
from torchtlc.gen.kernel import CompileError, _Ctx, compile_expr
from torchtlc.gen.program import GenProgram
from torchtlc.gen.tla_parse import load_genspec
from torchtlc.kernels.build import build_struct
from torchtlc.spec import texpr
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["RaftElection", "Reconciler", "ServiceMesh"]
RECONCILER = os.path.join(ROOT, "specs", "Reconciler.toolbox", "Model_1",
                          "Reconciler.tla")
INVS = ["TypeOK", "AppliedBounded", "ObservedBounded"]
R44 = {"Controllers": "{c1, c2, c3, c4}", "MaxGen": "4"}
P, I = ctypes.c_void_p, ctypes.c_int


def _cfg(name):
    return os.path.join(ROOT, "specs", f"{name}.toolbox", "Model_1", "MC.cfg")


def _specs(name):
    if name == "Reconciler-4x4":
        return (j_load(RECONCILER, R44, INVS, []),
                load_genspec(RECONCILER, R44, INVS, []))
    return (j_resolve(_cfg(name), workers="cpu").genspec,
            resolve(_cfg(name), workers="cpu").genspec)


@pytest.mark.parametrize("name", NAMES + ["Reconciler-4x4"])
def test_codec_equals_reference(name):
    jspec, tspec = _specs(name)
    jc, tc = JCodec(jspec), GenCodec(tspec)
    for leaf in ("strings", "sid", "components", "offsets", "widths",
                 "n_fields", "nbits", "n_words"):
        assert getattr(tc, leaf) == getattr(jc, leaf), leaf
    assert tc.value_tables.keys() == jc.value_tables.keys()
    for k, v in jc.value_tables.items():
        assert np.array_equal(tc.value_tables[k], v)
    for decl in tspec.variables:
        idx = decl.index_set[0] if decl.index_set else None
        idx2 = decl.index_set2[-1] if decl.index_set2 else None
        args = (decl.name, idx) + ((idx2,) if idx2 else ())
        assert tc.comp_index(*args) == jc.comp_index(*args)
    init = jo.initial_state(jspec)
    assert np.array_equal(tc.encode(init), jc.encode(init))
    assert tc.decode(tc.encode(init)) == jc.decode(jc.encode(init))
    # random in-domain codes, packed and unpacked by both
    rng = np.random.default_rng(7)
    sizes = [len(d.domain.values) for d in tspec.variables
             for _ in range(d.n_components)]
    fields = np.stack([rng.integers(0, s, 257) for s in sizes],
                      1).astype(np.int32)
    words = tc.pack(torch.from_numpy(fields))
    assert np.array_equal(words.numpy(),
                          np.asarray(jc.pack(jjnp.asarray(fields)))
                          .view(np.int32))
    assert np.array_equal(tc.unpack(words).numpy(), fields)
    assert np.array_equal(np.asarray(jc.unpack(jjnp.asarray(
        words.numpy().view(np.uint32)))), fields)
    if name == "Reconciler-4x4":
        assert tc.nbits > 32 and tc.n_words == 2  # fields span the words


def _reachable(jspec, jc):
    r = jo.bfs(jspec, keep_parents=True)
    return np.stack([jc.encode(s) for s in r.parents])


@pytest.mark.parametrize("name", NAMES)
def test_lane_ir_step_and_invariants_equal_reference(name):
    jspec, tspec = _specs(name)
    jc = JCodec(jspec)
    jk = j_kernel(jspec, jc)
    prog = GenProgram(tspec)
    enc = _reachable(jspec, jc)
    succ, valid, ovf, afail = prog.step_plain(torch.from_numpy(enc))
    js, jv, jov = jax.vmap(jk.step)(jjnp.asarray(enc))
    assert np.array_equal(succ.numpy(), np.asarray(js))
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    assert np.array_equal(ovf.numpy(), np.asarray(jov))
    assert not afail.any()
    assert prog.ker.lane_labels == jk.lane_labels
    assert prog.ker.lane_action == jk.lane_action
    bits = prog.inv_bits_plain(torch.from_numpy(enc)).numpy()
    flat = np.asarray(js).reshape(-1, jc.n_fields)
    fbits = prog.inv_bits_plain(torch.from_numpy(flat.copy())).numpy()
    for k, (_, fn) in enumerate(jk.invariants):
        assert np.array_equal((bits >> k) & 1,
                              np.asarray(jax.vmap(fn)(jjnp.asarray(enc))))
        assert np.array_equal((fbits >> k) & 1,
                              np.asarray(jax.vmap(fn)(jjnp.asarray(flat))))


def _host_k19(prog, block, n, inv, deadlock):
    lib = ctypes.CDLL(build_struct(prog.text, host=True))
    lib.host_gen_expand.argtypes = [P, P, I, I, I, I, P, P, P, P, P]
    ck = block.shape[0]
    ncand = ck * prog.L
    bl = np.ascontiguousarray(block.numpy())
    packed = np.zeros((ncand, prog.W), np.int32)
    flags = np.zeros((3 + prog.n_inv, ncand), np.uint8)
    action = np.zeros(ncand, np.int32)
    gen = np.zeros(prog.n_labels, np.int64)
    first = np.full(prog.n_inv + 2, 0x7FFFFFFF, np.int32)
    K = np.ascontiguousarray(prog.K)
    lib.host_gen_expand(*(a.ctypes.data_as(P) for a in (K, bl)), ck, n,
                        int(inv), int(deadlock),
                        *(a.ctypes.data_as(P) for a in (packed, flags, action,
                                                        gen, first)))
    return packed, flags, action, gen, first


def _edited(tmp_path, old, new, extra_inv=()):
    text = open(RECONCILER).read()
    path = tmp_path / "Reconciler.tla"
    path.write_text(text.replace(old, new))
    consts = {"Controllers": "{c1, c2}", "MaxGen": "2"}
    invs = INVS + list(extra_inv)
    return (j_load(str(path), consts, invs, []),
            load_genspec(str(path), consts, invs, []))


CASES = {
    "RaftElection": None, "ServiceMesh": None, "Reconciler-4x4": None,
    "invariant": ("====", "NeverObserves == \\A self \\in Controllers : "
                  "observed[self] = 0\n====", ("NeverObserves",)),
    "overflow": ("/\\ desired \\in 0..MaxGen", "/\\ desired \\in 0..1", ()),
    "deadlock": ("Next == Bump \\/ Terminating \\/", "Next == Bump \\/", ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k19_host_build_equals_plain(case, tmp_path):
    """K19 (g++ build of the emitted text) against its plain version on
    popped blocks of reachable (or random in-domain) states, padded past
    the pop, in both invariant modes; the verdict fold is checked to fire
    where the spec fails an invariant, overflows a slot or deadlocks."""
    if CASES[case] is None:
        jspec, tspec = _specs(case)
    else:
        jspec, tspec = _edited(tmp_path, *CASES[case])
    prog = GenProgram(tspec)
    if case in ("overflow", "Reconciler-4x4"):
        # random in-domain states (the overflow edit's reachable set has
        # out-of-domain values the oracle cannot encode)
        rng = np.random.default_rng(3)
        sizes = [len(d.domain.values) for d in tspec.variables
                 for _ in range(d.n_components)]
        rows = torch.from_numpy(np.stack(
            [rng.integers(0, s, 200) for s in sizes], 1).astype(np.int32))
    else:
        rows = torch.from_numpy(_reachable(jspec, JCodec(jspec))[-200:])
    block = torch.zeros(256, prog.W, dtype=torch.int32)
    block[:len(rows)] = prog.cdc.pack(rows)
    seen = np.zeros(prog.n_inv + 2, bool)
    for n, inv, dead in ((len(rows), True, True), (len(rows) - 37, False,
                                                   True),
                         (len(rows), True, False)):
        got = _host_k19(prog, block, n, inv, dead)
        want = prog.expand_plain(block, n, inv, dead)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy())
        seen |= got[4] != 0x7FFFFFFF
    expect = {"invariant": prog.n_inv - 1, "overflow": prog.n_inv,
              "deadlock": prog.n_inv + 1}
    if case in expect:
        assert seen[expect[case]]
    elif case != "Reconciler-4x4":  # reachable states of a clean spec
        assert not seen.any()


def test_compile_errors_equal_reference():
    jspec, tspec = _specs("Reconciler")
    jctx = JCtx(JCodec(jspec), dict(jspec.constants), {}, None)
    tctx = _Ctx(GenCodec(tspec), dict(tspec.constants), {}, None)
    for src in ('desired = "Idle"', "observed[desired] = 0",
                "pc = 1", 'desired < "Idle"', "Controllers = 1"):
        ast = texpr.parse(src)
        with pytest.raises(JCompileError) as je:
            j_compile(ast, jctx)
        with pytest.raises(CompileError) as te:
            compile_expr(ast, tctx)
        assert str(te.value) == str(je.value)
    assert "cannot compare int with str" in str(
        pytest.raises(CompileError, compile_expr,
                      texpr.parse('desired = "Idle"'), tctx).value)
