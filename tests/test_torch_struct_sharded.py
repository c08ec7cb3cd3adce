"""The sharded engine over struct backends (torchtlc.engine.sharded with
struct.backend's routes: kernel K21 over the struct step, K18 on each
owner's received rows) against jaxtlc.engine.sharded over the reference's
struct backend, on the CPU (8 virtual devices).

Every comparison is exact (the tolerance is zero): K21's plain version and
the g++ build of its emitted text against the rows of the reference's
expand_half on popped blocks (fields, flags, actions, packed successors and
popped rows, the per-shard generated counts through commit_half's act_gen),
at 1, 2 and 4 shards, immediate and deferred; K18 (plain and g++) on every
owner's received rows against the reference's make_deferred_checker over
r_flat; every ShardCarry leaf after full runs, pipelined ones included;
check_struct_sharded's result; migrate_shard_carry on a struct carry; and
the `-sharded 2` command's transcript and journal.  The helpers here serve
tests/test_torch_gen_sharded.py too."""

import contextlib
import ctypes
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from jaxtlc.cli import main as j_main
from jaxtlc.engine import sharded as js
from jaxtlc.engine.backend import make_deferred_checker as j_checker
from jaxtlc.resil import regrow as jr
from jaxtlc.struct.cache import get_backend as j_get_backend
from jaxtlc.struct.engine import check_struct_sharded as j_css
from jaxtlc.struct.loader import load as j_load
from torchtlc.cli import main as t_main
from torchtlc.engine import sharded as ts
from torchtlc.engine.fpset import FPSet, fpset_insert_dedup
from torchtlc.engine.interop import (
    SHARD_LEAF_ORDER,
    shard_carry_from_numpy,
    shard_carry_to_numpy,
)
from torchtlc.kernels.build import build_struct
from torchtlc.resil import regrow as tr
from torchtlc.struct.cache import get_backend as t_get_backend
from torchtlc.struct.engine import check_struct_sharded as t_css
from torchtlc.struct.loader import load as t_load
from torchtlc.testing import one_thread

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "specs")
PTR, INT, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
CFGS = {
    "TwoPhase": os.path.join(SPECS, "TwoPhase.toolbox", "Model_1", "MC.cfg"),
    "TwoPhase_sym": os.path.join(SPECS, "TwoPhase.toolbox", "Model_sym",
                                 "MC.cfg"),
    "RaftReplication": os.path.join(SPECS, "RaftReplication.toolbox",
                                    "Model_1", "MC.cfg"),
}
KW = {"TwoPhase": dict(chunk=32, queue_capacity=512, fp_capacity=4096),
      "TwoPhase_sym": dict(chunk=32, queue_capacity=1024, fp_capacity=4096),
      "RaftReplication": dict(chunk=64, queue_capacity=1 << 12,
                              fp_capacity=1 << 14)}
DROP = ("t", "wall_s", "t_dispatch", "t_fence", "seconds", "path",
        "version", "device")


@pytest.fixture(autouse=True)
def _no_reference_artifact_cache(monkeypatch):
    monkeypatch.setenv("JAXTLC_ARTIFACT_CACHE", "off")
    monkeypatch.setenv("TORCHTLC_ARTIFACT_CACHE", "off")


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("fp",))


def _struct_backends(name):
    """(reference backend, port backend) of a shipped struct model, both
    without the deadlock check (the reference's parity setting)."""
    return (j_get_backend(j_load(CFGS[name]), False),
            t_get_backend(t_load(CFGS[name]), False))


def _assert_carries_equal(port_carry, jc, where=""):
    """Every leaf of the reference carry, word for word."""
    mine = shard_carry_to_numpy(port_carry)
    ref = {f: np.asarray(getattr(jc, f)) for f in SHARD_LEAF_ORDER
           if getattr(jc, f, None) is not None}
    assert set(mine) == set(ref), (where, set(mine) ^ set(ref))
    for name, want in ref.items():
        assert mine[name].dtype == want.dtype, (where, name)
        assert np.array_equal(mine[name], want), (where, name)


def _run_both(jb, tb, D, kw):
    """Full runs of both engines at D shards: (reference carry, port
    carry, port result)."""
    j_init, j_run = js.make_sharded_engine(None, _mesh(D), backend=jb, **kw)
    t_init, t_run = ts.make_sharded_engine(None, ts.ShardMesh(D, "cpu"),
                                           backend=tb, **kw)
    jc = jax.block_until_ready(j_run(j_init()))
    tc = t_run(t_init())
    r = ts.result_from_shard_carry(tc, 0.0, labels=tb.labels,
                                   viol_names=tb.viol_names)
    return jc, tc, r


def _ref_halves(jb, D, kw, steps):
    """The reference's carry after `steps` bodies, its expand_half words and
    its carry after one more commit_half (jitted shard_map halves, as the
    reference's ShardedSpillRuntime runs them), and its bucket width."""
    mesh = _mesh(D)
    parts = {}
    init_fn, _ = js.make_sharded_engine(None, mesh, backend=jb, _parts=parts,
                                        **kw)
    _, seg = js.make_sharded_engine(None, mesh, backend=jb, segment=steps,
                                    **kw)
    c = jax.block_until_ready(seg(init_fn())) if steps else init_fn()
    specs, axis = parts["specs"], parts["axis"]
    ex_specs = js.ShardEx(*(P(axis) for _ in js.ShardEx._fields))
    expand = jax.jit(js.shard_map(
        lambda cc: jax.tree.map(lambda x: x[None], parts["expand_half"](cc)),
        mesh=mesh, in_specs=(specs,), out_specs=ex_specs, check_vma=False))
    commit = jax.jit(js.shard_map(
        lambda cc, ex: parts["commit_half"](
            cc, jax.tree.map(lambda x: x[0], ex)),
        mesh=mesh, in_specs=(specs, ex_specs), out_specs=specs,
        check_vma=False))
    ex = jax.block_until_ready(expand(c))
    return c, ex, jax.block_until_ready(commit(c, ex)), parts["B"]


def _host_lib(prog):
    """The g++ build of a program's emitted text (its K21 and K18)."""
    lib = ctypes.CDLL(build_struct(prog.text, host=True))
    lib.host_emitted_expand_sharded.argtypes = [PTR, PTR, LL, PTR, PTR, INT,
                                                INT, INT] + [PTR] * 6
    lib.host_struct_inv_rows.argtypes = [PTR, PTR, LL, PTR, PTR, PTR, INT,
                                         PTR, PTR, PTR]
    return lib


def _p(a: np.ndarray):
    return a.ctypes.data


def _n(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.numpy())


def _host_expand(lib, prog, queue, qhead, npop, ck, deferred):
    D, qrows, _ = queue.shape
    N = D * ck * prog.L
    out = dict(packed=np.zeros((N, prog.W), np.int32),
               flags=np.zeros((3 + prog.n_inv, N), np.uint8),
               action=np.zeros(N, np.int32),
               fields=np.zeros((N, prog.F), np.int32),
               block=np.zeros((D * ck, prog.W), np.int32),
               gen=np.zeros((D, prog.n_labels), np.int64))
    K = np.ascontiguousarray(prog.K)
    queue, qhead, npop = _n(queue), _n(qhead), _n(npop)
    lib.host_emitted_expand_sharded(
        _p(K), _p(queue), qrows, _p(qhead), _p(npop), D, ck,
        int(deferred), *(_p(out[k]) for k in ("packed", "flags", "action",
                                              "fields", "block", "gen")))
    return out


def _host_inv_rows(lib, prog, rows_in, fresh, c_idx, rows):
    viol, vaction = np.zeros(1, np.int64), np.zeros(1, np.int64)
    state = np.zeros(prog.F, np.int32)
    # the arrays stay referenced until the call has returned
    K = np.ascontiguousarray(prog.K)
    rows_np, fr, ci = _n(rows_in), _n(fresh).astype(np.uint8), _n(c_idx)
    lib.host_struct_inv_rows(_p(K), _p(rows_np), rows, _p(fr), _p(ci),
                             None, 100, _p(viol), _p(state), _p(vaction))
    return int(viol[0]), state, int(vaction[0])


def check_halves(jb, tb, D, kw, steps, deferred, want_viol=False):
    """K21 and K18 (plain and g++) against the reference's halves on its
    carry after `steps` bodies: the expand rows word for word and each
    owner's received-rows verdict.  Returns (the verdicts found, the
    candidates K21's invariant rows flag)."""
    kw = dict(kw, sort_free=deferred, deferred=deferred)
    jc, ex, jnext, B = _ref_halves(jb, D, kw, steps)
    prog = tb.kernels.prog
    lib = _host_lib(prog)
    c = shard_carry_from_numpy(jc, "cpu")
    chunk, L, F = kw["chunk"], prog.L, prog.F
    ncand = chunk * L
    h = ts.read_bundle(c)
    n = [min(chunk, min(e, t) - q) if h.viol == 0 else 0
         for q, t, e in zip(h.qhead, h.qtail, h.level_end)]
    assert n == np.asarray(ex.n).tolist() and sum(n) > 0
    npop = torch.tensor(n, dtype=torch.int64)
    got = tb.kernels.expand_sharded(c.queue, c.qhead, npop, chunk, deferred,
                                    True)
    host = _host_expand(lib, prog, c.queue, c.qhead, npop, chunk, deferred)
    names = ("packed", "flags", "action", "gen", "fields", "block")
    for k, v in zip(names, got):
        assert np.array_equal(host[k], v.numpy()), k
    packed, flags, action, gen, fields, block = (v.numpy() for v in got)
    assert np.array_equal(fields, np.asarray(ex.flat).reshape(-1, F))
    assert np.array_equal(flags[0].astype(bool),
                          np.asarray(ex.fvalid).reshape(-1))
    assert np.array_equal(flags[1].astype(bool),
                          np.asarray(ex.afail).reshape(-1))
    assert np.array_equal(flags[2].astype(bool),
                          np.asarray(ex.ovf).reshape(-1))
    inv_bad = np.asarray(ex.inv_bad)  # [D, n_inv or 0, ncand]
    want_inv = (np.zeros((prog.n_inv, D * ncand), bool) if deferred else
                inv_bad.transpose(1, 0, 2).reshape(prog.n_inv, -1))
    assert np.array_equal(flags[3:].astype(bool), want_inv)
    assert np.array_equal(action, np.asarray(ex.faction).reshape(-1))
    assert np.array_equal(packed, np.asarray(jb.cdc.pack(
        jax.numpy.asarray(fields))).view(np.int32))
    assert np.array_equal(block, np.asarray(jb.cdc.pack(
        jax.numpy.asarray(np.asarray(ex.batch).reshape(-1, F)))
    ).view(np.int32))
    # the per-shard generated counts: commit_half's act_gen increment
    d_gen = (np.asarray(jnext.act_gen).astype(np.int64)
             - np.asarray(jc.act_gen).astype(np.int64))
    assert np.array_equal(gen, d_gen[:, :prog.n_labels])
    # K18 on every owner's received rows against the reference's checker
    DB = D * B
    r_flat = np.asarray(ex.r_flat).reshape(D, DB, F)
    r_lo = np.asarray(ex.r_lo).reshape(D, DB).view(np.int32)
    r_hi = np.asarray(ex.r_hi).reshape(D, DB).view(np.int32)
    r_valid = np.asarray(ex.r_valid).reshape(D, DB)
    checker = j_checker(jb, DB, probe_width=0, with_cert=False)
    verdicts = []
    for o in range(D):
        _, fresh, c_idx, nreps, _ = fpset_insert_dedup(
            FPSet(c.table[o].clone()), torch.from_numpy(r_lo[o].copy()),
            torch.from_numpy(r_hi[o].copy()),
            torch.from_numpy(r_valid[o].copy()))
        rows_in = torch.from_numpy(r_flat[o].copy())
        viol, state = tb.kernels.deferred_rows(rows_in, fresh, c_idx, DB)
        jv, jst, jact, _ = checker(jax.numpy.asarray(r_flat[o]), None,
                                   jax.numpy.asarray(fresh.numpy()),
                                   jax.numpy.asarray(
                                       c_idx.numpy().astype(np.int32)),
                                   int(nreps))
        hv, hst, hact = _host_inv_rows(lib, prog, rows_in, fresh, c_idx, DB)
        assert int(viol) == int(jv) == hv, o
        assert np.array_equal(state.numpy(), np.asarray(jst)), o
        assert np.array_equal(hst, state.numpy()), o
        assert int(jact) == hact == -1
        verdicts.append(int(viol))
    if want_viol:
        assert any(v >= 100 for v in verdicts)
    else:
        assert not any(verdicts)
    return verdicts, int(flags[3:].sum())


@pytest.mark.parametrize("name,D,deferred,steps", [
    ("TwoPhase_sym", 1, False, 4), ("TwoPhase", 2, True, 3),
    ("RaftReplication", 4, False, 6), ("RaftReplication", 4, True, 8),
], ids=["sym-D1-immediate", "TwoPhase-D2-deferred", "Raft-D4-immediate",
        "Raft-D4-deferred"])
def test_k21_and_k18_equal_reference_halves(name, D, deferred, steps):
    jb, tb = _struct_backends(name)
    check_halves(jb, tb, D, KW[name], steps, deferred)


@pytest.mark.parametrize("name,D,modes", [
    ("TwoPhase_sym", 1, {}),
    ("TwoPhase_sym", 2, dict(pipeline=True, obs_slots=16)),
    ("RaftReplication", 4, {}),
    ("RaftReplication", 2, dict(pipeline=True, sort_free=True,
                                deferred=True)),
    ("TwoPhase", 4, dict(pipeline=True, deferred=True)),
], ids=["sym-D1", "sym-D2-pipelined-ring", "Raft-D4",
        "Raft-D2-pipelined-slab-deferred", "TwoPhase-D4-pipelined-deferred"])
def test_run_carries_equal_reference(name, D, modes):
    """Every ShardCarry leaf after a full run (tables, queues with their
    dump rows, counters, the ring, the pipelined pv_* leaves)."""
    jb, tb = _struct_backends(name)
    jc, tc, r = _run_both(jb, tb, D, dict(KW[name], **modes))
    _assert_carries_equal(tc, jc, name)
    assert r.violation == 0 and r.queue_left == 0


def test_check_struct_sharded_equals_reference():
    """check_struct_sharded on TwoPhase Model_1 with the deadlock check: the
    same deadlock verdict, state, counts and per-action counts as the
    reference's."""
    kw = dict(KW["TwoPhase"], chunk=16)
    r = t_css(t_load(CFGS["TwoPhase"]), ts.ShardMesh(2, "cpu"), **kw)
    jr_ = j_css(j_load(CFGS["TwoPhase"]), _mesh(2), **kw)
    assert r.violation_name == "Deadlock reached"
    for f in ("generated", "distinct", "depth", "queue_left", "violation",
              "violation_name", "violation_action", "action_generated",
              "action_distinct", "outdegree"):
        assert getattr(r, f) == getattr(jr_, f), f
    assert np.array_equal(r.violation_state, np.asarray(jr_.violation_state))


def test_migrate_shard_carry_on_a_struct_carry():
    """A pipelined 4-shard RaftReplication carry migrated to twice the
    table, twice the queue and twice the route factor equals the
    reference's migration, and one more segment at the new geometry."""
    jb, tb = _struct_backends("RaftReplication")
    kw = dict(KW["RaftReplication"], pipeline=True)
    mk = (lambda pkg, b, mesh, **k: pkg.make_sharded_engine(
        None, mesh, backend=b, segment=5, **dict(kw, **k)))
    j_init, j_seg = mk(js, jb, _mesh(4))
    t_init, t_seg = mk(ts, tb, ts.ShardMesh(4, "cpu"))
    jc, tc = jax.block_until_ready(j_seg(j_init())), t_seg(t_init())
    old = dict(queue_capacity=kw["queue_capacity"],
               fp_capacity=kw["fp_capacity"], route_factor=2.0)
    new = dict(queue_capacity=2 * kw["queue_capacity"],
               fp_capacity=2 * kw["fp_capacity"], route_factor=4.0)
    assert int(np.asarray(jc.pv_n).sum()) > 0
    jm = jr.migrate_shard_carry(jc, old, new)
    tm = tr.migrate_shard_carry(tc, old, new)
    _assert_carries_equal(tm, jm)
    assert tm.pv_send.shape[2] != tc.pv_send.shape[2]
    _, j_seg2 = mk(js, jb, _mesh(4), **new)
    _, t_seg2 = mk(ts, tb, ts.ShardMesh(4, "cpu"), **new)
    _assert_carries_equal(t_seg2(tm), jax.block_until_ready(j_seg2(jm)))


def masked(text: str) -> str:
    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search"))]
    text = "\n".join(lines)
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    text = re.sub(r"\d+(\.\d+)?s\)", "Ns)", text)  # regrow seconds
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def journal(path):
    return [{k: v for k, v in ev.items() if k not in DROP}
            for ev in map(json.loads, open(path)) if ev["event"] != "phase"]


def commands_both(cfg, extra, tmp_path):
    """{package: (rc, masked transcript, journal)} of `check cfg extra`."""
    out = {}
    for name, fn in (("ref", j_main), ("port", t_main)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        argv = ["check", cfg, "-noTool", "-workers", "cpu", "-journal",
                str(d / "j.jsonl")] + [str(d / x[1:]) if x.startswith("@")
                                       else x for x in extra]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        out[name] = (rc, masked(buf.getvalue()).replace(str(d), "DIR"),
                     journal(d / "j.jsonl"))
    return out


@pytest.mark.parametrize("name,extra,rc", [
    ("TwoPhase", ["-sharded", "2"], 12),
    ("TwoPhase_sym", ["-sharded", "2", "-nodeadlock", "-chunk", "16",
                      "-fpcap", "512"], 0),
], ids=["TwoPhase-deadlock", "sym-regrow"])
def test_sharded_command_equals_reference(tmp_path, name, extra, rc):
    """`check MC.cfg -sharded 2` (supervised: auto-grow is on) on a struct
    spec: the exit code, the transcript (the preflight warning, a
    deadlock's trace, the regrow banners) and the journal equal the
    reference's."""
    out = commands_both(CFGS[name], extra, tmp_path)
    assert out["port"][0] == out["ref"][0] == rc
    assert out["port"][1] == out["ref"][1]
    assert out["port"][2] == out["ref"][2]
    assert "Preflight warning [spec/unreduced-symmetry]" in out["port"][1]
    assert ("regrowing fp_capacity" in out["port"][1]) == ("-fpcap" in extra)
    assert any(ev["event"] == "run_start" and ev["engine"] == "sharded"
               for ev in out["port"][2])
