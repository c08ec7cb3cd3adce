"""The port's pod (torchtlc.dist) against the reference's (jaxtlc.dist) on
the CPU: the pod kernels K36-K38 (plain versions and the g++ build of
pod.cuh) and K11 / K12 with a process's S < D sources against the
in-process layout, the collectives and the exchange on two gloo ranks,
run_pod in one process against the reference's, the reference's three
drills (SIGTERM and resume, a refused width and --reshard, a table too
small and the spill lifeboat), checkpoints across the two packages and
reshard_carry.  Every comparison is exact."""

import ctypes
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from jaxtlc.config import ModelConfig as JConfig
from jaxtlc.dist import pod as jpod
from jaxtlc.engine.backend import kubeapi_backend as j_backend
from torchtlc.config import ModelConfig
from torchtlc.dist import pod as tpod
from torchtlc.engine import sharded as ts
from torchtlc.engine.backend import VIOL_FPSET_FULL
from torchtlc.engine.backend import kubeapi_backend as t_backend
from torchtlc.testing import one_thread, subprocess_env

one_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "torchtlc", "kernels", "csrc")
FF, J_FF = ModelConfig(False, False), JConfig(False, False)
FF_COUNTS = (17020, 8203, 109)
GEO = dict(chunk=128, queue_capacity=4096, fp_capacity=16384, ckpt_every=8)
PTR, LL, INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _counts(pr):
    r = pr.result
    return (r.generated, r.distinct, r.depth)


def _p(a: np.ndarray):
    return a.ctypes.data


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("host_pod") / "libhost.so")
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-D__host__=",
         "-D__device__=", "-I", CSRC, "-o", so,
         os.path.join(CSRC, "host_launch.cpp")],
        check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(so)
    lib.host_pod_exchange_pack.argtypes = [PTR, PTR, PTR, PTR, LL, INT, PTR]
    lib.host_pod_exchange_unpack.argtypes = [PTR, INT, INT, INT, INT, PTR,
                                             PTR, PTR, PTR]
    lib.host_pod_stats_pack.argtypes = [PTR, PTR, PTR, INT, INT, PTR]
    lib.host_pod_stats_pack.restype = INT
    lib.host_route_scatter_s.argtypes = [PTR, PTR, PTR, PTR, LL, INT, INT,
                                         INT, INT, PTR, PTR, PTR, PTR, PTR,
                                         PTR, PTR, PTR, PTR]
    lib.host_verdict_fold_s.argtypes = [PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                                        LL, INT, INT, INT, INT, INT, INT,
                                        PTR, PTR]
    return lib


def _lanes(rng, D, ncand, F):
    """D source shards' candidate lanes: fingerprints, validity, fields."""
    N = D * ncand
    hi = torch.from_numpy(rng.integers(-2**31, 2**31, N, dtype=np.int32))
    lo = torch.from_numpy(rng.integers(-2**31, 2**31, N, dtype=np.int32))
    valid = torch.from_numpy((rng.random(N) < 0.7).astype(np.uint8))
    fields = torch.from_numpy(rng.integers(-50, 50, (N, F), dtype=np.int32))
    return hi, lo, valid, fields


def _host_pack(lib, xrows, xlo, xhi, xvalid):
    D, S, B, F = xrows.shape
    out = np.zeros((D, S, B, F + 3), np.int32)
    lib.host_pod_exchange_pack(
        _p(xrows.numpy()), _p(xlo.numpy()), _p(xhi.numpy()),
        _p(np.ascontiguousarray(xvalid.numpy().view(np.uint8))), D * S * B,
        F, _p(out))
    return torch.from_numpy(out)


def _host_unpack(lib, recv):
    H, S, _, B, W = recv.shape
    F = W - 3
    xrows = np.zeros((S, H * S, B, F), np.int32)
    xlo = np.zeros((S, H * S, B), np.int32)
    xhi = np.zeros_like(xlo)
    xvalid = np.zeros((S, H * S, B), np.uint8)
    lib.host_pod_exchange_unpack(_p(recv.numpy()), H, S, B, F, _p(xrows),
                                 _p(xlo), _p(xhi), _p(xvalid))
    return (torch.from_numpy(xrows), torch.from_numpy(xlo),
            torch.from_numpy(xhi), torch.from_numpy(xvalid.astype(bool)))


def _host_route(lib, hi, lo, valid, fields, D, S, B):
    F = fields.shape[1]
    ncand = hi.shape[0] // S
    o = dict(order=np.zeros((S, ncand), np.int32),
             s_own=np.zeros((S, ncand), np.int32),
             s_pos=np.zeros((S, ncand), np.int32),
             s_valid=np.zeros((S, ncand), np.uint8),
             xrows=np.zeros((D, S, B, F), np.int32),
             xlo=np.zeros((D, S, B), np.int32),
             xhi=np.zeros((D, S, B), np.int32),
             xvalid=np.zeros((D, S, B), np.uint8),
             route_ovf=np.zeros(S, np.uint8))
    lib.host_route_scatter_s(
        _p(hi.numpy()), _p(lo.numpy()), _p(valid.numpy()),
        _p(fields.numpy()), ncand, D, S, B, F,
        *(_p(o[k]) for k in ("order", "s_own", "s_pos", "s_valid", "xrows",
                             "xlo", "xhi", "xvalid", "route_ovf")))
    return o


@pytest.mark.parametrize("D,H,B", [(2, 2, 40), (4, 2, 40), (8, 2, 30),
                                   (8, 4, 30), (4, 4, 12)])
def test_pod_exchange_kernels_against_the_in_process_layout(host_lib, D, H,
                                                            B):
    """Each process's K11 planes ([D, S, B], S = D / H sources), packed by
    K36, carried by an all_to_all (here: chunk q of every process's buffer
    to process q) and unpacked by K37, are the in-process engine's owner
    planes [o, s] for this process's owners, row for row - plain versions
    and the g++ build alike; K11's S-source form is the in-process route's
    rows, plain and g++."""
    rng = np.random.default_rng(D * 100 + H * 10 + B)
    S, F, ncand = D // H, 5, 96
    hi, lo, valid, fields = _lanes(rng, D, ncand, F)
    full = ts.route_out_new(D, ncand, B, F, "cpu")
    ts.route_plain(hi, lo, valid, fields, D, B, full)
    sends, sends_host = [], []
    for p in range(H):
        sl = slice(p * S * ncand, (p + 1) * S * ncand)
        rt = ts.route_out_new(D, ncand, B, F, "cpu", S=S)
        ts.route_plain(hi[sl], lo[sl], valid[sl], fields[sl], D, B, rt)
        src = slice(p * S, (p + 1) * S)
        for name in ("order", "s_own", "s_pos", "s_valid", "route_ovf"):
            assert torch.equal(getattr(rt, name), getattr(full, name)[src])
        for name in ("xrows", "xlo", "xhi", "xvalid"):
            assert torch.equal(getattr(rt, name),
                               getattr(full, name)[:, src]), name
        hr = _host_route(host_lib, hi[sl].contiguous(), lo[sl].contiguous(),
                         valid[sl].contiguous(), fields[sl].contiguous(), D,
                         S, B)
        for name in ("order", "s_own", "s_pos", "xrows", "xlo", "xhi"):
            assert np.array_equal(hr[name], getattr(rt, name).numpy()), name
        for name in ("s_valid", "xvalid", "route_ovf"):
            assert np.array_equal(hr[name].astype(bool),
                                  getattr(rt, name).numpy()), name
        planes = (rt.xrows, rt.xlo, rt.xhi, rt.xvalid)
        send = ts.pod_pack_plain(*planes)
        assert send.shape == (D, S, B, F + 3)
        assert torch.equal(_host_pack(host_lib, *planes), send)
        sends.append(send.view(H, -1))
    for q in range(H):
        recv = torch.stack([sends[p][q] for p in range(H)]).view(
            H, S, S, B, F + 3)
        own = slice(q * S, (q + 1) * S)
        want = (full.xrows[own], full.xlo[own], full.xhi[own],
                full.xvalid[own])
        for got in (ts.pod_unpack_plain(recv), _host_unpack(host_lib, recv)):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("D,H", [(4, 2), (8, 4)])
def test_verdict_fold_of_a_process_sources(host_lib, D, H):
    """K12 over a process's S sources, reading the [D, S, B] verdicts the
    pod's exchange delivers, folds the in-process engine's rows of those
    sources - plain version and g++ build."""
    rng = np.random.default_rng(D + H)
    S, F, chunk, L, n_labels = D // H, 3, 16, 4, 6
    ncand, B = chunk * L, 24
    hi, lo, valid, fields = _lanes(rng, D, ncand, F)
    full = ts.route_out_new(D, ncand, B, F, "cpu")
    ts.route_plain(hi, lo, valid, fields, D, B, full)
    verd = torch.from_numpy(
        (rng.random((D, D, B)) < 0.5).astype(np.uint8))
    faction = torch.from_numpy(
        rng.integers(0, n_labels, (D, ncand), dtype=np.int32))
    npop = torch.from_numpy(rng.integers(0, chunk + 1, D).astype(np.int64))
    od = torch.zeros(D, L + 2, dtype=torch.int64)
    ad = torch.zeros(D, n_labels + 1, dtype=torch.int64)
    ts.verdict_fold_plain(verd, full.s_own, full.s_pos, full.s_valid,
                          full.order, faction, npop, chunk, L, n_labels, od,
                          ad)
    for p in range(H):
        src = slice(p * S, (p + 1) * S)
        # owner process q sends its [S owner, D, B] rows' columns of p
        v = verd[:, src].contiguous()
        o2 = torch.zeros(S, L + 2, dtype=torch.int64)
        a2 = torch.zeros(S, n_labels + 1, dtype=torch.int64)
        args = (full.s_own[src].contiguous(), full.s_pos[src].contiguous(),
                full.s_valid[src].contiguous(), full.order[src].contiguous(),
                faction[src].contiguous(), npop[src].contiguous())
        ts.verdict_fold_plain(v, *args, chunk, L, n_labels, o2, a2)
        assert torch.equal(o2, od[src]) and torch.equal(a2, ad[src])
        ho = np.zeros((S, L + 2), np.int64)
        ha = np.zeros((S, n_labels + 1), np.int64)
        host_lib.host_verdict_fold_s(
            _p(v.numpy()), *(_p(np.ascontiguousarray(
                a.numpy().view(np.uint8) if a.dtype == torch.bool
                else a.numpy())) for a in args),
            ncand, D, S, B, chunk, L, n_labels, _p(ho), _p(ha))
        assert np.array_equal(ho, od[src].numpy())
        assert np.array_equal(ha, ad[src].numpy())


def _stat_leaves(rng, S, F=7, sites=11):
    return [
        torch.from_numpy(rng.integers(0, 2**40, S)),
        torch.from_numpy(rng.integers(-2**31, 2**31, (S, F), dtype=np.int32)),
        torch.from_numpy(rng.random(S) < 0.5),
        torch.from_numpy(rng.integers(0, 2**32, (S, sites))),
        torch.from_numpy(rng.integers(0, 255, (S, 3), dtype=np.uint8)),
    ]


@pytest.mark.parametrize("S", [1, 2, 4])
def test_pod_stats_pack(host_lib, S):
    """K38: mixed int64 / int32 / bool / byte leaves of widths 1 to 11 into
    one int64 row a shard, the words in leaf order - plain version and g++
    build - and the rows split back into the leaves."""
    leaves = _stat_leaves(np.random.default_rng(S), S)
    want = ts.pod_stats_plain(leaves)
    assert want.shape == (S, 1 + 7 + 1 + 11 + 3)
    col = 0
    for t in leaves:
        w = t[0].numel() if t.dim() > 1 else 1
        back = want[:, col:col + w].to(t.dtype).reshape(t.shape)
        assert torch.equal(back, t)
        col += w
    n = len(leaves)
    ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in leaves))
    widths = (ctypes.c_int * n)(*(t[0].numel() if t.dim() > 1 else 1
                                  for t in leaves))
    kinds = (ctypes.c_int * n)(0, 1, 2, 0, 2)
    out = np.zeros(tuple(want.shape), np.int64)
    assert host_lib.host_pod_stats_pack(ptrs, widths, kinds, n, S,
                                        _p(out)) == 0
    assert np.array_equal(out, want.numpy())


# ---------------------------------------------------------------------------
# the collectives on two gloo ranks
# ---------------------------------------------------------------------------

_RANK = r"""
import json, sys
import numpy as np, torch
from types import SimpleNamespace
from torchtlc.dist.pod import (init_pod, make_stats_gather, make_stop_vote,
                               pod_mesh)
from torchtlc.engine import sharded as ts
torch.set_num_threads(1)
port, rank = sys.argv[1], int(sys.argv[2])
assert init_pod(f"127.0.0.1:{port}", 2, rank, collectives="gloo") == "gloo"
mesh = pod_mesh(device="cpu", devices_per_host=2)
D, S, B, F = 4, 2, 10, 3
vote = make_stop_vote(mesh)
votes = [vote(rank == 1), vote(False), vote(True)]
rng = np.random.default_rng(5)
full = dict(
    generated=torch.from_numpy(rng.integers(0, 2**40, D)),
    viol_state=torch.from_numpy(rng.integers(-9, 9, (D, F),
                                             dtype=np.int32)),
    cont=torch.from_numpy(rng.random(D) < 0.5),
    cov_counts=torch.from_numpy(rng.integers(0, 2**32, (D, 6))))
carry = SimpleNamespace(**{f: mesh.local(v) for f, v in full.items()})
st = make_stats_gather(mesh, carry)(carry)
stats_ok = sorted(vars(st)) == sorted(full) and all(
    getattr(st, f).dtype == v.dtype and torch.equal(getattr(st, f), v)
    for f, v in full.items())
# the candidate and verdict exchanges against the in-process layout
xr = torch.from_numpy(rng.integers(-99, 99, (D, D, B, F), dtype=np.int32))
xl = torch.from_numpy(rng.integers(-2**31, 2**31, (D, D, B),
                                   dtype=np.int32))
xh = torch.from_numpy(rng.integers(-2**31, 2**31, (D, D, B),
                                   dtype=np.int32))
xv = torch.from_numpy(rng.random((D, D, B)) < 0.5)
src = slice(mesh.row0, mesh.row0 + S)
got = mesh.exchange(*(t[:, src].contiguous() for t in (xr, xl, xh, xv)))
cand_ok = all(g.dtype == w.dtype and torch.equal(g, mesh.local(w))
              for g, w in zip(got, (xr, xl, xh, xv)))
verd = torch.from_numpy((rng.random((D, D, B)) < 0.5).astype(np.uint8))
(vg,) = mesh.exchange(mesh.local(verd).contiguous())
verd_ok = torch.equal(vg, verd[:, src])
print(json.dumps(dict(votes=votes, stats=stats_ok, cand=cand_ok,
                      verd=verd_ok, any=[mesh.any(rank == 0)],
                      timing=sorted(mesh.timing))))
import torch.distributed as dist
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_collectives_on_two_gloo_ranks():
    """make_stop_vote and make_stats_gather on two gloo ranks (the vote is
    the max of the flags; the gather gives every rank every shard's
    leaves, dtypes kept), and the mesh's candidate and verdict exchanges
    deliver the in-process engine's planes."""
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, port, str(r)],
                              cwd=ROOT, env=subprocess_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        got = json.loads(out.strip().splitlines()[-1])
        assert got["votes"] == [True, False, True]
        assert got["stats"] and got["cand"] and got["verd"]
        assert got["any"] == [True]
        assert got["timing"] == ["exchange_s", "gather_s"]


# ---------------------------------------------------------------------------
# run_pod in one process; the drills
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_snapshot(tmp_path_factory):
    """The reference's pod on FF at D = 4, paused after two segments (its
    per-host file), and its full run's result."""
    base = str(tmp_path_factory.mktemp("refpod") / "pod.ckpt")
    pr = jpod.run_pod(J_FF, devices=4, ckpt_path=base, max_segments=2,
                      **GEO)
    assert pr.exit_code == 0 and _counts(pr) != FF_COUNTS
    return base


def test_in_process_run_pod_equals_reference(ref_snapshot, tmp_path):
    """The port's run_pod(devices=4) without torch.distributed, paused at
    the same fence as the reference's, writes the reference's file leaf
    for leaf; run to the end it gives the reference's counts."""
    base = str(tmp_path / "pod.ckpt")
    pr = tpod.run_pod(FF, devices=4, ckpt_path=base, max_segments=2,
                      device="cpu", **GEO)
    assert pr.exit_code == 0 and pr.hosts == 1 and pr.collectives is None
    jm, jfull = jpod.load_pod_full(ref_snapshot)
    tm, tfull = tpod.load_pod_full(base)
    for key in ("devices", "num_hosts", "host_rows", "pod_fields",
                "queue_capacity", "fp_capacity", "config"):
        assert tm[key] == jm[key], key
    for f in tm["pod_fields"]:
        a, b = np.asarray(getattr(jfull, f)), getattr(tfull, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    pr2 = tpod.run_pod(FF, devices=4, ckpt_path=base, resume=True,
                       device="cpu", **GEO)
    assert _counts(pr2) == FF_COUNTS and pr2.exit_code == 0 and pr2.resumed


def test_pod_checkpoints_cross_the_packages(ref_snapshot, tmp_path):
    """The reference's .h* files resume in the port's run_pod to the
    counts, and the port's files (written at the next fence) load in the
    reference's load_pod_full with the port's leaves."""
    import shutil

    base = str(tmp_path / "pod.ckpt")
    for suffix in (".h0", ".h0.journal.jsonl"):
        shutil.copy(ref_snapshot + suffix, base + suffix)
    pr = tpod.run_pod(FF, devices=4, ckpt_path=base, resume=True,
                      max_segments=1, device="cpu", **GEO)
    assert pr.resumed and pr.segments == 1
    jm, jfull = jpod.load_pod_full(base)
    tm, tfull = tpod.load_pod_full(base)
    assert jm["pod_fields"] == tm["pod_fields"]
    for f in tm["pod_fields"]:
        assert np.array_equal(np.asarray(getattr(jfull, f)),
                              getattr(tfull, f)), f
    pr2 = tpod.run_pod(FF, devices=4, ckpt_path=base, resume=True,
                       device="cpu", **GEO)
    assert _counts(pr2) == FF_COUNTS and pr2.exit_code == 0


def test_reshard_carry_equals_reference(ref_snapshot):
    """reshard_carry on the reference's saved 4-shard carry, to 2 and to 8
    shards: the port's new leaves equal the reference's word for word."""
    _, full = jpod.load_pod_full(ref_snapshot)
    for d_new in (2, 8):
        want = jpod.reshard_carry(full, j_backend(J_FF), d_new,
                                  queue_capacity=GEO["queue_capacity"],
                                  fp_capacity=GEO["fp_capacity"])
        got = tpod.reshard_carry(full, t_backend(FF), d_new,
                                 queue_capacity=GEO["queue_capacity"],
                                 fp_capacity=GEO["fp_capacity"])
        for f in want._fields:
            a, b = getattr(want, f), getattr(got, f)
            if a is None:
                assert b is None, f
                continue
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b), (d_new, f)


def test_pod_sigterm_checkpoints_and_resumes(tmp_path):
    """The reference's first drill: SIGTERM mid-run, the next fence votes,
    every shard checkpoints, exit 75; a plain resume at the same width
    completes to the reference's counts, one continuous journal."""
    from torchtlc.obs import journal as jr

    base = str(tmp_path / "pod.ckpt")
    fired = []

    def kill_once(kind, info):
        if kind == "progress" and not fired:
            fired.append(1)
            os.kill(os.getpid(), signal.SIGTERM)

    pr = tpod.run_pod(FF, devices=2, ckpt_path=base, on_event=kill_once,
                      device="cpu", **GEO)
    assert pr.exit_code == 75 and fired
    assert os.path.exists(base + ".h0")
    assert _counts(pr) != FF_COUNTS
    pr2 = tpod.run_pod(FF, devices=2, ckpt_path=base, resume=True,
                       device="cpu", **GEO)
    assert _counts(pr2) == FF_COUNTS and pr2.exit_code == 0
    assert pr2.resumed and not pr2.resharded
    events = jr.read(base + ".h0.journal.jsonl")
    kinds = [e["event"] for e in events]
    assert kinds.count("run_start") == 1 and kinds.count("run_resume") == 1
    assert "pod" in kinds and "interrupted" in kinds
    assert kinds[-1] == "final" and events[-1]["verdict"] == "ok"


def test_pod_wrong_width_refused_then_reshard_resumes(tmp_path):
    """The reference's second drill: a snapshot at 4 shards refuses a
    plain resume at 2 with the --reshard hint; reshard=True completes."""
    base = str(tmp_path / "pod.ckpt")
    pr = tpod.run_pod(FF, devices=4, ckpt_path=base, max_segments=2,
                      device="cpu", **GEO)
    assert pr.exit_code == 0 and _counts(pr) != FF_COUNTS
    with pytest.raises(ValueError, match="--reshard"):
        tpod.run_pod(FF, devices=2, ckpt_path=base, resume=True,
                     device="cpu", **GEO)
    pr2 = tpod.run_pod(FF, devices=2, ckpt_path=base, resume=True,
                       reshard=True, device="cpu", **GEO)
    assert _counts(pr2) == FF_COUNTS and pr2.exit_code == 0
    assert pr2.resumed and pr2.resharded


def test_pod_over_capacity_needs_spill():
    """The reference's third drill: tables too small for FF halt with
    VIOL_FPSET_FULL, exit 12; the spill lifeboat completes exactly."""
    geo = dict(GEO, fp_capacity=2048)
    pr = tpod.run_pod(FF, devices=2, device="cpu", **geo)
    assert pr.exit_code == 12
    assert pr.result.violation == VIOL_FPSET_FULL
    pr2 = tpod.run_pod(FF, devices=2, spill="on", spill_capacity=1 << 14,
                       device="cpu", **geo)
    assert _counts(pr2) == FF_COUNTS and pr2.exit_code == 0
    assert pr2.spilled > 0 and pr2.spill_flushes > 0
