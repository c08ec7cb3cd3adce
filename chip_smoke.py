#!/usr/bin/env python3
"""Smoke test of the torchtlc port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port's main path from torchtlc/kernels/csrc,
drives the exhaustive BFS through the user entry points (engine.bfs.check's
engine) on the FF corner, on Model_1 and on the scaled 2x1 workload, checks
every result against its pinned value, holds each kernel bitwise against
its plain torch version on the card, and prints:

* one line per phase;
* a line with the card's name and power limit (nvidia-smi);
* a JSON line {"kernels": [...]} with each kernel's launches on the main
  path (the Model_1 and scaled runs), its error against the plain version,
  its time, the plain version's time and its bound on this card;
* last, {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Any mismatch exits nonzero before the last line.  Without a CUDA device, or
without the torchtlc package beside it, it exits nonzero and prints no
result.  The build's ptxas report goes to torchtlc/kernels/_build/ptxas.txt.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

FF_KW = dict(chunk=256, queue_capacity=1 << 13, fp_capacity=1 << 15)
FF_COUNTS = (17020, 8203, 109)
FF_OUTDEGREE = (1, 0, 2, 2)
# SHA-256 of the final table words (little-endian uint32) of the reference
# engine, jaxtlc.engine.bfs.make_engine(FF, **FF_KW, sort_free=False,
# deferred=False), re-derived by tests/test_torch_engine.py
FF_TABLE_SHA256 = (
    "5429b485b823b0099ac3e09a1ff6daf8ffab07499e0f5ae253dde28c2d32c414")

M1_KW = dict(chunk=1024, queue_capacity=1 << 15, fp_capacity=1 << 18)
M1_COUNTS = (577736, 163408, 124)  # MC.out:1098,1101
M1_OUTDEGREE = (1, 0, 4, 2)  # MC.out:1104
# the reference engine at M1_KW (slow test in tests/test_torch_engine.py)
M1_TABLE_SHA256 = (
    "3783a17757c7fc171326cf2eb7bda5782e5373d271fda243d36feacac03ff4c1")
# MC.out per-action generated counts (MC.out:78-621, tests/mc_expect.py)
MC_OUT_GENERATED = {
    "DoRequest": 149766, "DoReply": 67334, "DoListRequest": 82416,
    "DoListReply": 70584, "CStart": 54342, "C1": 13373, "C10": 6257,
    "C11": 8877, "c12": 2620, "C13": 12302, "C2": 770, "C3": 1346,
    "C8": 673, "C6": 426, "C7": 708, "C4": 483, "C5": 1253,
    "PVCStart": 25217, "PVCListedPVCs": 33946, "PVCHavePVCs": 13459,
    "PVCDone": 4523, "APIStart": 27059,
}
# per-action distinct counts of the reference ENGINE at M1_KW (its in-batch
# attribution, which is not TLC's: MC.out's distinct column differs; both
# sum to 163,406 = distinct minus the 2 Init states)
M1_DISTINCT = {
    "APIStart": 11724, "C1": 13171, "C10": 6085, "C11": 8758, "C13": 12219,
    "C2": 769, "C3": 1171, "C4": 453, "C5": 1236, "C6": 418, "C7": 690,
    "C8": 663, "CStart": 28582, "DoListReply": 2529, "DoListRequest": 2471,
    "DoReply": 35025, "DoRequest": 32047, "PVCDone": 230, "PVCHavePVCs": 302,
    "PVCListedPVCs": 1171, "PVCStart": 1086, "c12": 2606,
}
SCALED_COUNTS = (62014325, 19359985, 186)  # SCALED_VALIDATION.json

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
SEED = 20261017


class SmokeFailure(Exception):
    pass


def need(cond, what):
    if not cond:
        raise SmokeFailure(what)


def table_sha256(table) -> str:
    return hashlib.sha256(
        table.cpu().numpy().astype("<i4").tobytes()).hexdigest()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torchtlc  # noqa: F401  (fails alone, outside the repository)
    from torchtlc.kernels import ops
    from torchtlc.kernels.build import BUILD_DIR

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"

    # -- phase 1: build ----------------------------------------------------
    t0 = time.time()
    info = ops.load(ptxas_report=True)
    with open(os.path.join(BUILD_DIR, "ptxas.txt"), "w") as f:
        for stem, log in info.logs.items():
            f.write(f"== {stem}.cu\n{log}\n")
    regs = {}
    for stem, log in info.logs.items():
        for line in log.splitlines():
            if "Used" in line and "registers" in line:
                regs.setdefault(stem, line.split("Used")[1].split(",")[0]
                                .strip())
    print(f"phase 1 build: {len(info.libs)} libraries with nvcc in "
          f"{time.time() - t0:.1f} s; registers {regs}", flush=True)

    runs = {}
    runs["ff"] = phase_ff(torch, ops)
    phase_violation(torch)
    runs["m1"] = phase_model1(torch, ops, card)
    runs["scaled"] = phase_scaled(torch, ops, card)
    launches = {k: runs["m1"]["launches"][k] + runs["scaled"]["launches"][k]
                for k in ops.KERNELS}
    kernels = phase_kernels(torch, ops, runs, launches)
    print(f"phase 6 launches on the Model_1 + scaled runs: {launches}",
          flush=True)
    for k, v in launches.items():
        need(v > 0, f"kernel {k} was not launched on the main path")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_engine(torch, ops, cfg, kw):
    """One exhaustive run through the port's engine entry points, with the
    launch counts reset just before and read just after."""
    from torchtlc.engine.bfs import make_engine, result_from_carry
    from torchtlc.engine.fpset import fpset_actual_collision

    init_fn, run_fn, _ = make_engine(cfg, sort_free=False, deferred=False,
                                     **kw)
    carry = init_fn()
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.time()
    carry = run_fn(carry)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    r = result_from_carry(carry, wall, iterations=run_fn.steps,
                          fp_capacity=kw["fp_capacity"])
    r = r._replace(actual_fp_collision=fpset_actual_collision(carry.fps))
    return carry, r, launches


def phase_ff(torch, ops):
    from torchtlc.config import MATRIX

    carry, r, launches = run_engine(torch, ops, MATRIX[(False, False)], FF_KW)
    sha = table_sha256(carry.fps.table)
    print(f"phase 3 FF: {r.generated} / {r.distinct} / {r.depth}, outdegree "
          f"{r.outdegree}, table sha256 {sha[:16]}, {r.iterations} steps in "
          f"{r.wall_s:.3f} s", flush=True)
    need((r.generated, r.distinct, r.depth) == FF_COUNTS, "FF counts")
    need(r.outdegree == FF_OUTDEGREE, "FF outdegree")
    need(r.violation == 0 and r.queue_left == 0, "FF verdict")
    need(sha == FF_TABLE_SHA256, "FF table words")
    return {"carry": carry, "result": r, "launches": launches}


def phase_violation(torch):
    """A Model_1 frontier seeded with a Client at C2 and an empty apiState
    fails the C2 assert (KubeAPI.tla:196): the card must report the same
    verdict, state and action as the same engine on the CPU."""
    from torchtlc.config import MODEL_1
    from torchtlc.engine.bfs import VIOL_ASSERT, make_engine
    from torchtlc.spec.codec import get_codec
    from torchtlc.spec.labels import LABEL_ID

    cdc = get_codec(MODEL_1)
    bad = cdc.initial_vectors()[1:2].copy()  # shouldReconcile = TRUE
    bad[0, cdc.offsets["pc"]] = LABEL_ID["C2"]
    packed = cdc.pack(torch.from_numpy(bad))
    got = {}
    for dev in ("cuda", "cpu"):
        init_fn, run_fn, _ = make_engine(
            MODEL_1, chunk=64, queue_capacity=1 << 10, fp_capacity=1 << 12,
            sort_free=False, deferred=False, device=dev)
        carry = init_fn()
        carry.queue[0, :2] = packed.to(dev)
        carry = run_fn(carry)
        got[dev] = (int(carry.viol), carry.viol_state.cpu().tolist(),
                    int(carry.viol_action))
    print(f"phase 3 seeded assert: violation {got['cuda'][0]}, action "
          f"{got['cuda'][2]}, state equal to the CPU run's", flush=True)
    need(got["cuda"][0] == VIOL_ASSERT, "seeded assert verdict")
    need(got["cuda"] == got["cpu"], "seeded assert differs from the CPU run")


def phase_model1(torch, ops, card):
    from torchtlc.config import MODEL_1

    carry, r, launches = run_engine(torch, ops, MODEL_1, M1_KW)
    sha = table_sha256(carry.fps.table)
    print(f"phase 4 Model_1: {r.generated} / {r.distinct} / {r.depth}, "
          f"outdegree {r.outdegree}, table sha256 {sha[:16]}, "
          f"{r.iterations} steps in {r.wall_s:.3f} s wall on {card}; "
          f"launches {launches}", flush=True)
    need((r.generated, r.distinct, r.depth) == M1_COUNTS, "Model_1 counts")
    need(r.outdegree == M1_OUTDEGREE, "Model_1 outdegree")
    need(r.violation == 0 and r.queue_left == 0, "Model_1 verdict")
    need(r.action_generated == MC_OUT_GENERATED, "Model_1 per-action generated")
    need(r.action_distinct == M1_DISTINCT, "Model_1 per-action distinct")
    need(sha == M1_TABLE_SHA256, "Model_1 table words")
    return {"carry": carry, "result": r, "launches": launches}


def phase_scaled(torch, ops, card):
    from torchtlc.config import scaled_config

    cfg, kw = scaled_config()
    carry, r, launches = run_engine(torch, ops, cfg, kw)
    rate = r.distinct / r.wall_s
    print(f"phase 5 scaled 2x1: {r.generated} / {r.distinct} / {r.depth}, "
          f"{r.iterations} steps in {r.wall_s:.3f} s wall, "
          f"{rate:.0f} distinct states/s on {card}; launches {launches}",
          flush=True)
    need((r.generated, r.distinct, r.depth) == SCALED_COUNTS, "scaled counts")
    need(r.violation == 0 and r.queue_left == 0, "scaled verdict")
    return {"carry": carry, "result": r, "launches": launches, "cfg": cfg,
            "kw": kw}


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, reps, setup=None):
    """Mean device time of fn(setup()) over reps calls (CUDA events around
    each call; setup is not timed); one untimed warm-up call first."""
    fn(setup() if setup else None)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(arg)
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def phase_kernels(torch, ops, runs, launches):
    """Hold every kernel bitwise against its plain version on the card, at
    the Model_1 and the scaled step shapes, and time both."""
    import numpy as np

    from torchtlc.config import MODEL_1
    from torchtlc.engine import bfs, fpset
    from torchtlc.engine.backend import expand_block, expand_plain
    from torchtlc.engine.fingerprint import fp64_words, fp64_words_plain
    from torchtlc.spec.codec import get_codec
    from torchtlc.spec.kernel import lane_layout

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    rows = {}

    def record(name, shape, err, ms, plain_ms, nbytes):
        rows.setdefault(name, []).append(dict(
            shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))

    def err_of(a, b):
        a = a.to(torch.int64)
        b = b.to(torch.int64)
        return int((a - b).abs().max()) if a.numel() else 0

    # Model_1: the frontier of level 40 of a fresh run, popped as the
    # engine pops it; scaled: the first chunk rows of level buffer 0 after
    # the run (states of earlier levels), all but 3 inside the pop mask
    init_fn, _, step_fn = bfs.make_engine(MODEL_1, sort_free=False,
                                          deferred=False, **M1_KW)
    c = init_fn()
    while int(c.level) < 40:
        c = step_fn(c)
    m1_block = c.queue[int(c.parity), :M1_KW["chunk"]].contiguous()
    big = runs["scaled"]["carry"].queue
    ck_big = runs["scaled"]["kw"]["chunk"]
    shapes = [
        ("model1", MODEL_1, runs["m1"]["carry"], m1_block, int(c.level_n)),
        ("scaled", runs["scaled"]["cfg"], runs["scaled"]["carry"],
         big[0, :ck_big].contiguous(), ck_big - 3),
    ]
    for tag, cfg, carry, block, n in shapes:
        cdc = get_codec(cfg)
        W, nbits = cdc.n_words, cdc.nbits
        _, L = lane_layout(cfg)
        ck = block.shape[0]
        ncand = ck * L
        R = min(2 * ck, ncand)
        n_labels = 22

        # K1 expand
        got = expand_block(cfg, block, n)
        ref = expand_plain(cfg, block, n)
        err = max(err_of(a, b) for a, b in zip(got, ref))
        need(err == 0, f"K1 expand differs from its plain version ({tag})")
        ms = cuda_ms(torch, lambda _: expand_block(cfg, block, n), 20)
        pms = cuda_ms(torch, lambda _: expand_plain(cfg, block, n), 3)
        record("expand", tag, err, ms, pms,
               ck * W * 4 + ncand * (W * 4 + 5 + 4) + n_labels * 8)
        packed, flags, action, _ = got
        valid = flags[0].bool()

        # K2 fp64 on seeded random words
        words = torch.from_numpy(rng.integers(
            0, 2**32, (ncand, W), dtype=np.uint64).astype(np.uint32).view(
                np.int32)).to(dev)
        lo, hi = fp64_words(words, nbits)
        lo2, hi2 = fp64_words_plain(words, nbits)
        err = max(err_of(lo, lo2), err_of(hi, hi2))
        need(err == 0, f"K2 fp64 differs from its plain version ({tag})")
        ms = cuda_ms(torch, lambda _: fp64_words(words, nbits), 20)
        pms = cuda_ms(torch, lambda _: fp64_words_plain(words, nbits), 2)
        record("fp64", tag, err, ms, pms, ncand * W * 4 + ncand * 8)

        # fpset_key on the step's real fingerprints
        lo, hi = fp64_words(packed, nbits)
        key = fpset.fpset_key(lo, hi, valid)
        key2 = fpset.fpset_key_plain(lo, hi, valid)
        err = err_of(key, key2)
        need(err == 0, f"fpset_key differs from its plain version ({tag})")
        ms = cuda_ms(torch, lambda _: fpset.fpset_key(lo, hi, valid), 20)
        pms = cuda_ms(torch, lambda _: fpset.fpset_key_plain(lo, hi, valid), 3)
        record("fpset_key", tag, err, ms, pms, ncand * (4 + 4 + 1 + 8))

        # K3 probe / claim / walk: a seeded batch with in-batch duplicates
        # pushes a table from 0.55 to 0.68 load, probe width R
        k3 = check_fpset(torch, fpset, rng, dev, tag, R, ncand)
        for name, (err, ms, pms, nbytes) in k3.items():
            record(name, tag, err, ms, pms, nbytes)

        # K4 commit of one real step: this block's candidates, inserted
        # into an empty table so that the step has new states
        fps = fpset.fpset_new(1 << (2 * ncand - 1).bit_length(), dev)
        _, is_new_c, c_idx, nreps = fpset.fpset_insert_sorted(
            fps, lo, hi, valid, probe_width=R, claim_width=R)
        e_idx, n_new = bfs.enqueue_order(is_new_c, c_idx, nreps, R)
        A = R
        qcap = carry.queue.shape[1] - 2 * ck
        nn = int(n_new)
        need(nn > 0, f"K4 test step has no new state ({tag})")

        def fresh(_=None):
            return (torch.zeros_like(carry.queue[:, :qcap + A]),
                    torch.zeros(n_labels + 1, dtype=torch.int64, device=dev),
                    torch.zeros(L + 2, dtype=torch.int64, device=dev))

        outs = []
        for fn in (bfs.commit_block, bfs.commit_block_plain):
            q, ad, od = fresh()
            fn(q, 1, 5, qcap, e_idx, n_new, packed, action, n, ad, od, A, L,
               n_labels)
            outs.append((q, ad, od))
        err = max(err_of(a, b) for a, b in zip(*outs))
        need(err == 0, f"K4 commit differs from its plain version ({tag})")

        def run_commit(fn):
            return lambda st: fn(st[0], 1, 5, qcap, e_idx, n_new, packed,
                                 action, n, st[1], st[2], A, L, n_labels)

        ms = cuda_ms(torch, run_commit(bfs.commit_block), 20, fresh)
        pms = cuda_ms(torch, run_commit(bfs.commit_block_plain), 3, fresh)
        nseg_rows = -(-nn // A) * A
        record("commit", tag, err, ms, pms,
               nseg_rows * (8 + 2 * W * 4) + nn * 4 + (n_labels + L) * 16)
        print(f"phase 2 kernels vs plain ({tag}, chunk {ck}, {n} popped, "
              f"{ncand} candidates, R {R}): all bitwise equal; "
              + ", ".join(f"{k} {v[-1]['ms']:.4f} ms (plain "
                          f"{v[-1]['plain_ms']:.3f} ms, bound "
                          f"{v[-1]['bound_ms']:.4f} ms)"
                          for k, v in rows.items()), flush=True)

    source = {
        "expand": ("torchtlc/kernels/csrc/expand.cu",
                   "jaxtlc/engine/backend.py:195"),
        "fp64": ("torchtlc/kernels/csrc/fp64.cu",
                 "jaxtlc/engine/fingerprint.py:241"),
        "fpset_key": ("torchtlc/kernels/csrc/fpset.cu",
                      "jaxtlc/engine/fpset.py:139"),
        "fpset_probe": ("torchtlc/kernels/csrc/fpset.cu",
                        "jaxtlc/engine/fpset.py:369"),
        "fpset_claim": ("torchtlc/kernels/csrc/fpset.cu",
                        "jaxtlc/engine/fpset.py:369"),
        "fpset_walk": ("torchtlc/kernels/csrc/fpset.cu",
                       "jaxtlc/engine/fpset.py:369"),
        "commit": ("torchtlc/kernels/csrc/commit.cu",
                   "jaxtlc/engine/bfs.py:434"),
    }
    out = []
    for name in ops.KERNELS:
        big = rows[name][-1]  # the scaled step shape
        out.append({
            "name": name, "route": "cuda", "source": source[name][0],
            "replaces": source[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "model1": {k: rows[name][0][k]
                       for k in ("ms", "plain_ms", "bound_ms")},
        })
    return out


def check_fpset(torch, fpset, rng, dev, tag, R, ncand):
    """K3 against its plain version segment by segment: the same sorted,
    compacted keys into two copies of one table; the table words, slot
    codes, pending and is_new bytes must be equal.  Returns per kernel
    (err, ms, plain_ms, bytes)."""
    import numpy as np

    from torchtlc.kernels import ops

    # a table of 2^k slots ~4.8x the candidate width, filled to 0.55 load
    # by quarter-width seeded batches; then one full-width batch of ncand
    # fingerprints over ncand/2 values (in-batch duplicates; ~0.43 ncand
    # distinct) pushes it past 0.68
    cap = 1 << int(np.floor(np.log2(4.8 * ncand)))
    table = torch.zeros(cap // 8, 16, dtype=torch.int32, device=dev)

    def batch(n):
        lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        dup = rng.integers(0, n // 2, n)
        lo, hi = lo[dup], hi[dup]
        t = [torch.from_numpy(x.view(np.int32)).to(dev) for x in (lo, hi)]
        return t[0], t[1], torch.ones(n, dtype=torch.bool, device=dev)

    while int(fpset.fpset_count(fpset.FPSet(table))) < int(0.55 * cap):
        lo, hi, m = batch(ncand // 4)
        fpset.fpset_insert_sorted(fpset.FPSet(table), lo, hi, m,
                                  probe_width=R, claim_width=R)
    lo, hi, m = batch(ncand)
    key = fpset.fpset_key(lo, hi, m)
    c_key, c_idx, nreps = fpset.dedup_compact(key)
    nseg = -(-ncand // R)
    c_key = torch.cat([c_key, torch.full((nseg * R - ncand,), fpset.KEY00,
                                         dtype=torch.int64, device=dev)])
    errs = {"fpset_probe": 0, "fpset_claim": 0, "fpset_walk": 0}
    ms = {k: 0.0 for k in errs}
    pms = {k: 0.0 for k in errs}
    stragglers, max_seg = 0, 0
    nr = int(nreps)
    for seg in range(nseg):
        off = seg * R
        if off >= nr:
            break
        keys = c_key[off:off + R]
        active = torch.arange(R, device=dev) + off < nr
        t_k, t_p = table.clone(), table.clone()

        def ev():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        e0 = ev()
        slot = ops.fpset_probe(t_k, keys, nreps, off)
        e1 = ev()
        slot_p = fpset.fpset_round0_plain(t_p, keys, active)
        e2 = ev()
        is_new = torch.empty(R, dtype=torch.uint8, device=dev)
        pend = torch.empty(R, dtype=torch.uint8, device=dev)
        npend = torch.zeros(1, dtype=torch.int32, device=dev)
        e3 = ev()
        ops.fpset_claim(t_k, keys, slot, R, is_new, pend, npend)
        e4 = ev()
        is_new_p, pend_p = fpset.fpset_claim_plain(t_p, keys, slot_p, R)
        e5 = ev()
        need(bool((slot == slot_p).all()) and bool((pend == pend_p).all())
             and bool((is_new == is_new_p).all())
             and bool((t_k == t_p).all()), f"K3 round 0 differs ({tag})")
        n_s = int(npend)
        e6 = ev()
        ops.fpset_walk(t_k, keys, pend, is_new, npend)
        e7 = ev()
        fpset.fpset_walk_plain(t_p, keys, pend_p, is_new_p)
        e8 = ev()
        torch.cuda.synchronize()
        ok = bool((t_k == t_p).all()) and bool((is_new == is_new_p).all())
        need(ok, f"K3 straggler walk differs ({tag})")
        for k, (a, b, c, d) in (("fpset_probe", (e0, e1, e1, e2)),
                                ("fpset_claim", (e3, e4, e4, e5)),
                                ("fpset_walk", (e6, e7, e7, e8))):
            ms[k] += a.elapsed_time(b)
            pms[k] += c.elapsed_time(d)
        stragglers += n_s
        max_seg = max(max_seg, n_s)
        table = t_k
    load = int(fpset.fpset_count(fpset.FPSet(table))) / cap
    need(load >= 0.68, f"K3 test table reached only {load:.3f} load ({tag})")
    need(stragglers > 0, f"K3 test walked no straggler ({tag})")
    need(R <= 2048 or max_seg > 2048,
         f"K3 test walked only {max_seg} stragglers in a segment ({tag})")
    print(f"phase 2 K3 ({tag}): {cap} slots to load {load:.3f}, {nr} distinct "
          f"of {ncand} candidates, {stragglers} stragglers walked (max "
          f"{max_seg} in one segment), table words equal", flush=True)
    nseg_run = -(-nr // R)
    per = {k: (0, ms[k] / nseg_run, pms[k] / nseg_run) for k in ms}
    return {  # per launch: mean over the nseg_run active segments
        "fpset_probe": (*per["fpset_probe"], R * (8 + 4) + nr / nseg_run * 64),
        "fpset_claim": (*per["fpset_claim"], R * (8 + 4 + 2) + nr / nseg_run * 8),
        "fpset_walk": (*per["fpset_walk"],
                       stragglers / nseg_run * (8 + 64 + 8) + R * 2),
    }


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
