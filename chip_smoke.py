#!/usr/bin/env python3
"""Smoke test of the torchtlc port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port's main path from torchtlc/kernels/csrc,
drives the exhaustive BFS through the user entry points (engine.bfs.check's
engine) on the FF corner, on Model_1 and on the scaled 2x1 workload - in the
sorted immediate mode, then Model_1 at chunk 2048 and the scaled workload in
the default modes the reference resolves there (sort-free slab dedup,
deferred invariants; the scaled run with the counter ring) - checks every
result against its pinned value, holds each kernel bitwise against its
plain torch version on the card, and prints:

* one line per phase;
* a line with the card's name and power limit (nvidia-smi);
* a JSON line {"kernels": [...]} with each kernel's launches on the main
  path (the two Model_1 and the two scaled runs), its error against the
  plain version, its time, the plain version's time and its bound on this
  card;
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

SORTED = dict(sort_free=False, deferred=False)
# Model_1 at chunk 2048 in the default modes (sort-free + deferred)
M1_2048_KW = dict(chunk=2048, queue_capacity=1 << 15, fp_capacity=1 << 18)
# the reference engine at M1_2048_KW in its default modes (slow test in
# tests/test_torch_engine.py)
M1_2048_TABLE_SHA256 = (
    "89247de671615f91c8b444bb3b3046af477a7ecf199a2d542a739225d984dc78")
M1_2048_DISTINCT = {
    "DoRequest": 32456, "DoReply": 35308, "DoListRequest": 2003,
    "DoListReply": 2174, "CStart": 29273, "C1": 13321, "C10": 6195,
    "C11": 8741, "c12": 2605, "C13": 12157, "C2": 770, "C3": 1247,
    "C8": 668, "C6": 424, "C7": 698, "C4": 483, "C5": 1186, "PVCStart": 715,
    "PVCListedPVCs": 810, "PVCHavePVCs": 237, "PVCDone": 137,
    "APIStart": 11798,
}
SCALED_OBS_SLOTS = 256

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
    runs["m1_auto"] = phase_model1_auto(torch, ops, card)
    runs["scaled"] = phase_scaled(torch, ops, card)
    runs["scaled_auto"] = phase_scaled_auto(torch, ops, card, runs["scaled"])
    main = ("m1", "m1_auto", "scaled", "scaled_auto")
    launches = {k: sum(runs[r]["launches"][k] for r in main)
                for k in ops.KERNELS}
    kernels = phase_kernels(torch, ops, runs, launches)
    print(f"phase 6 launches on the Model_1 + scaled runs (both modes): "
          f"{launches}", flush=True)
    for k, v in launches.items():
        need(v > 0, f"kernel {k} was not launched on the main path")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_engine(torch, ops, cfg, kw, modes=SORTED):
    """One exhaustive run through the port's engine entry points, with the
    launch counts reset just before and read just after; `modes` {} takes
    the defaults.  Returns (carry, result, launches, run_fn)."""
    from torchtlc.engine.bfs import make_engine, result_from_carry
    from torchtlc.engine.fpset import fpset_actual_collision

    init_fn, run_fn, _ = make_engine(cfg, **modes, **kw)
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
    return carry, r, launches, run_fn


def phase_ff(torch, ops):
    from torchtlc.config import MATRIX

    carry, r, launches, _ = run_engine(torch, ops, MATRIX[(False, False)],
                                       FF_KW)
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
            **SORTED, device=dev)
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

    carry, r, launches, _ = run_engine(torch, ops, MODEL_1, M1_KW)
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
    carry, r, launches, _ = run_engine(torch, ops, cfg, kw)
    rate = r.distinct / r.wall_s
    print(f"phase 5 scaled 2x1: {r.generated} / {r.distinct} / {r.depth}, "
          f"{r.iterations} steps in {r.wall_s:.3f} s wall, "
          f"{rate:.0f} distinct states/s on {card}; launches {launches}",
          flush=True)
    need((r.generated, r.distinct, r.depth) == SCALED_COUNTS, "scaled counts")
    need(r.violation == 0 and r.queue_left == 0, "scaled verdict")
    # the repaired rows: the library sort of the sorted dedup and the
    # actual-collision estimate, timed on this run's table
    from torchtlc.engine.fpset import fpset_actual_collision

    coll_ms = cuda_ms(torch, lambda _: fpset_actual_collision(carry.fps), 3)
    print(f"phase 5 fpset_actual_collision on the scaled table: {coll_ms:.3f}"
          f" ms (bound {carry.fps.table.numel() * 4 / HBM_BYTES_PER_S * 1e3:.4f}"
          f" ms: the table read once)", flush=True)
    return {"carry": carry, "result": r, "launches": launches, "cfg": cfg,
            "kw": kw, "sha": table_sha256(carry.fps.table),
            "collision_ms": coll_ms}


def phase_model1_auto(torch, ops, card):
    """Model_1 at chunk 2048 with default modes: the sort-free slab dedup
    and the deferred invariants, as the reference resolves them."""
    from torchtlc.config import MODEL_1

    carry, r, launches, run_fn = run_engine(torch, ops, MODEL_1, M1_2048_KW,
                                            modes={})
    sha = table_sha256(carry.fps.table)
    print(f"phase 4b Model_1 chunk 2048, default modes (slab + deferred): "
          f"{r.generated} / {r.distinct} / {r.depth}, outdegree "
          f"{r.outdegree}, table sha256 {sha[:16]}, {r.iterations} steps "
          f"({run_fn.slab_fallbacks[2048]} slab fallbacks) in "
          f"{r.wall_s:.3f} s wall on {card}; launches {launches}", flush=True)
    need((r.generated, r.distinct, r.depth) == M1_COUNTS,
         "Model_1 (2048) counts")
    need(r.outdegree == M1_OUTDEGREE, "Model_1 (2048) outdegree")
    need(r.violation == 0 and r.queue_left == 0, "Model_1 (2048) verdict")
    need(r.action_generated == MC_OUT_GENERATED,
         "Model_1 (2048) per-action generated")
    need(r.action_distinct == M1_2048_DISTINCT,
         "Model_1 (2048) per-action distinct")
    need(sha == M1_2048_TABLE_SHA256, "Model_1 (2048) table words")
    return {"carry": carry, "result": r, "launches": launches}


def phase_scaled_auto(torch, ops, card, sorted_run):
    """The scaled workload in the default modes with the counter ring: the
    sorted run's counts and table words (the reference's bit-identity of
    the modes), one ring row per level flip, the last carrying the
    totals."""
    from torchtlc.engine.bfs import obs_rows

    cfg, kw = sorted_run["cfg"], sorted_run["kw"]
    carry, r, launches, run_fn = run_engine(
        torch, ops, cfg, dict(kw, obs_slots=SCALED_OBS_SLOTS), modes={})
    sha = table_sha256(carry.fps.table)
    rows, head = obs_rows(carry)
    ck = kw["chunk"]
    full = run_fn.steps_by_width[ck]
    fb = run_fn.slab_fallbacks
    rate = r.distinct / r.wall_s
    print(f"phase 5b scaled 2x1, default modes (slab + deferred) + ring: "
          f"{r.generated} / {r.distinct} / {r.depth}, {r.iterations} steps "
          f"({full} at width {ck}, {fb[ck]} of them took the slab fallback; "
          f"small width: {fb.get(ck // 16, 0)} fallbacks) in {r.wall_s:.3f} "
          f"s wall, {rate:.0f} distinct states/s on {card}; ring head {head},"
          f" last row {rows[-1] if rows else None}; launches {launches}",
          flush=True)
    need((r.generated, r.distinct, r.depth) == SCALED_COUNTS,
         "scaled (default modes) counts")
    need(r.violation == 0 and r.queue_left == 0,
         "scaled (default modes) verdict")
    need(sha == sorted_run["sha"],
         "scaled (default modes) table words differ from the sorted run's")
    need(head == r.depth, "ring head is not the number of level flips")
    need(rows and (rows[-1]["generated"], rows[-1]["distinct"])
         == (r.generated, r.distinct), "last ring row lacks the totals")
    return {"carry": carry, "result": r, "launches": launches,
            "fallbacks": fb, "full_steps": full}


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------


SPIN_CYCLES = 4_000_000  # ~2 ms of a spinning kernel at H100 clocks


def cuda_ms(torch, fn, reps, setup=None):
    """Mean device time of fn(setup()) over reps calls (CUDA events around
    each call; setup is not timed); one untimed warm-up call first.  A
    spinning kernel queued ahead of the first event keeps the card busy
    while the host enqueues the call, so the events time the device work
    and not the host's launch latency (a call that reads back to the host
    or enqueues for longer than the spin still includes its host time)."""
    fn(setup() if setup else None)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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

    # the slice-2 kernels at the Model_1 chunk-2048 and the scaled step
    # shapes: the first 2048 rows of the same Model_1 level-40 frontier, and
    # the first chunk rows of the scaled run's first level that fills a
    # chunk (reachable states only: a level buffer's rows past its level
    # hold the enqueue tail's padding, the packed rows of disabled lanes)
    block2048 = c.queue[int(c.parity), :M1_2048_KW["chunk"]].contiguous()
    s_cfg, s_kw = runs["scaled"]["cfg"], runs["scaled"]["kw"]
    s_init, _, s_step = bfs.make_engine(s_cfg, sort_free=False,
                                        deferred=False, **s_kw)
    sc = s_init()
    while not (int(sc.level_n) >= ck_big and int(sc.qhead) == 0):
        need(int(sc.level_n) > 0, "the scaled run has no level of a chunk")
        sc = s_step(sc)
    s_level, s_level_n = int(sc.level), int(sc.level_n)
    s_block = sc.queue[int(sc.parity), :ck_big].contiguous()
    del sc
    print(f"phase 2 slice-2 scaled step: the first {ck_big} rows of level "
          f"{s_level} ({s_level_n} states) of a sorted scaled run",
          flush=True)
    first_slice = set(rows)
    for tag, cfg, block, n in (
            ("model1_2048", MODEL_1, block2048,
             min(int(c.level_n), M1_2048_KW["chunk"])),
            ("scaled", s_cfg, s_block, ck_big - 3)):
        check_new_kernels(torch, ops, rng, tag, cfg, block, n, record, runs)
        print(f"phase 2 slice-2 times ({tag}): " + ", ".join(
            f"{k} {v[-1]['ms']:.4f} ms (plain {v[-1]['plain_ms']:.3f} ms, "
            f"bound {v[-1]['bound_ms']:.4f} ms)" for k, v in rows.items()
            if v[-1]["shape"] == tag and k not in first_slice), flush=True)

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
        "slab_scatter": ("torchtlc/kernels/csrc/slab.cu",
                         "jaxtlc/engine/fpset.py:659"),
        "slab_resolve": ("torchtlc/kernels/csrc/slab.cu",
                         "jaxtlc/engine/fpset.py:659"),
        "slab_compact": ("torchtlc/kernels/csrc/slab.cu",
                         "jaxtlc/engine/fpset.py:659"),
        "slab_order": ("torchtlc/kernels/csrc/slab.cu",
                       "jaxtlc/engine/fpset.py:726"),
        "slab_mark": ("torchtlc/kernels/csrc/slab.cu",
                      "jaxtlc/engine/fpset.py:726"),
        "deferred_check": ("torchtlc/kernels/csrc/deferred.cu",
                           "jaxtlc/engine/backend.py:325"),
        "ring_row": ("torchtlc/kernels/csrc/ring.cu",
                     "jaxtlc/obs/counters.py:89"),
    }
    first = {name: rows[name][0] for name in rows}
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
            "model1": {k: first[name][k]
                       for k in ("shape", "ms", "plain_ms", "bound_ms")},
        })
        for var in rows:  # the variants measured under this kernel
            if var.startswith(name + "/"):
                out[-1].setdefault("variants", {})[var.split("/", 1)[1]] = [
                    {k: r[k] for k in ("shape", "max_abs_err", "ms",
                                       "plain_ms", "bound_ms")}
                    for r in rows[var]]
    for k in [k for k in ops.KERNELS if k not in rows]:
        raise SmokeFailure(f"kernel {k} was not held against its plain "
                           "version")
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

        torch.cuda._sleep(SPIN_CYCLES)  # time device work, not the launch
        e0 = ev()
        slot = ops.fpset_probe(t_k, keys, nreps, off)
        e1 = ev()
        slot_p = fpset.fpset_round0_plain(t_p, keys, active)
        e2 = ev()
        is_new = torch.empty(R, dtype=torch.uint8, device=dev)
        pend = torch.empty(R, dtype=torch.uint8, device=dev)
        npend = torch.zeros(1, dtype=torch.int32, device=dev)
        torch.cuda._sleep(SPIN_CYCLES)
        e3 = ev()
        ops.fpset_claim(t_k, keys, slot, R, is_new, pend, npend)
        e4 = ev()
        is_new_p, pend_p = fpset.fpset_claim_plain(t_p, keys, slot_p, R)
        e5 = ev()
        need(bool((slot == slot_p).all()) and bool((pend == pend_p).all())
             and bool((is_new == is_new_p).all())
             and bool((t_k == t_p).all()), f"K3 round 0 differs ({tag})")
        n_s = int(npend)
        torch.cuda._sleep(SPIN_CYCLES)
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


def check_new_kernels(torch, ops, rng, tag, cfg, block, n, record, runs):
    """K1's deferred variant, K5 slab, K6 slab order, K3's masked probe,
    K7 deferred_check and K8 ring_row, each against its plain version on
    the same inputs at this step shape; the slab with its default geometry,
    with slab_bits=3 (collisions everywhere) and on an all-distinct burst
    (the sorted fallback).  Also times the library sort of the sorted
    dedup at this shape."""
    import numpy as np

    from torchtlc.engine import backend, fpset
    from torchtlc.engine.fingerprint import fp64_words
    from torchtlc.obs import counters
    from torchtlc.spec.codec import get_codec
    from torchtlc.spec.kernel import lane_layout

    dev = block.device
    cdc = get_codec(cfg)
    W, F = cdc.n_words, cdc.n_fields
    _, L = lane_layout(cfg)
    ck = block.shape[0]
    ncand = ck * L
    R = min(2 * ck, ncand)

    def err_of(a, b):
        a, b = a.to(torch.int64), b.to(torch.int64)
        return int((a - b).abs().max()) if a.numel() else 0

    # K1, deferred variant
    got = backend.expand_block(cfg, block, n, True)
    ref = backend.expand_plain(cfg, block, n, True)
    err = max(err_of(a, b) for a, b in zip(got, ref))
    need(err == 0, f"K1 deferred variant differs from its plain version "
         f"({tag})")
    need(int(got[1][3:].sum()) == 0, f"K1 deferred variant flagged an "
         f"invariant ({tag})")
    ms = cuda_ms(torch, lambda _: backend.expand_block(cfg, block, n, True),
                 20)
    pms = cuda_ms(torch, lambda _: backend.expand_plain(cfg, block, n, True),
                  3)
    record("expand/deferred", tag, err, ms, pms,
           ck * W * 4 + ncand * (W * 4 + 5 + 4) + 22 * 8)
    packed, flags, action, _ = got
    valid = flags[0].bool()
    lo, hi = fp64_words(packed, cdc.nbits)

    # the library sort of the sorted dedup (the repaired row): bound = the
    # int64 keys and lanes read and written once
    key = fpset.fpset_key(lo, hi, valid)
    lib_ms = {
        "shape": tag,
        "dedup_compact_ms": cuda_ms(torch, lambda _: fpset.dedup_compact(key),
                                    10),
        "torch_sort_ms": cuda_ms(
            torch, lambda _: torch.sort(key, stable=True), 10),
        "bound_ms": 4 * 8 * ncand / HBM_BYTES_PER_S * 1e3,
    }

    def slab_case(name, keys, bits, expect_fallback):
        """One slab insert step by step, kernel against plain; returns
        (n_cand, the step's inputs for K3)."""
        N = keys.shape[0]
        m = 1 << fpset.slab_log2_cells(N, 4, bits)
        nvalid = int((keys != fpset.KEY00).sum())
        st = {}
        for impl in ("kernel", "plain"):
            unres = torch.zeros(N, dtype=torch.uint8, device=dev)
            rep = torch.zeros(N, dtype=torch.uint8, device=dev)
            cand = torch.zeros(N, dtype=torch.uint8, device=dev)
            slab = torch.zeros(m, dtype=torch.int32, device=dev)
            if impl == "kernel":
                ops.slab_scatter(keys, 0, m - 1, unres, slab)
                s_slab = slab.clone()
                ops.slab_resolve(keys, 0, m - 1, slab, unres, rep, cand)
            else:
                fpset.slab_scatter_plain(keys, 0, m - 1, unres, slab)
                s_slab = slab.clone()
                fpset.slab_resolve_plain(keys, 0, m - 1, slab, unres, rep,
                                         cand)
            pos = torch.cumsum(cand, 0)
            c_lane = torch.full((R,), -1, dtype=torch.int32, device=dev)
            (ops.slab_compact if impl == "kernel"
             else fpset.slab_compact_plain)(cand, pos, R, c_lane)
            st[impl] = (s_slab, unres, rep, cand, pos, c_lane)
        k, p = st["kernel"], st["plain"]
        errs = [err_of(a, b) for a, b in zip(k, p)]
        need(max(errs) == 0, f"K5 slab differs from its plain version "
             f"({tag}, {name}: {errs})")
        n_cand = int(k[4][-1])
        need(expect_fallback is None or (n_cand > R) == expect_fallback,
             f"K5 slab case {name} ({tag}): {n_cand} claimants for R {R}")

        def setup():
            return (torch.zeros(m, dtype=torch.int32, device=dev),
                    torch.zeros(N, dtype=torch.uint8, device=dev),
                    torch.zeros(N, dtype=torch.uint8, device=dev),
                    torch.zeros(N, dtype=torch.uint8, device=dev))

        def run_scatter(fn):
            return lambda a: fn(keys, 0, m - 1, a[1], a[0])

        def resolve_setup():
            a = setup()
            ops.slab_scatter(keys, 0, m - 1, a[1], a[0])
            return a

        def run_resolve(fn):
            return lambda a: fn(keys, 0, m - 1, a[0], a[1], a[2], a[3])

        pos, cand = k[4], k[3]
        c_lane = torch.empty(R, dtype=torch.int32, device=dev)
        suffix = "" if name == "default" else "/" + name
        # bound: keys read, unres written, one 4 B cell per valid lane; the
        # slab's zeroing is a torch.zeros outside the kernel (and outside
        # the timed call), timed on its own by the caller
        record("slab_scatter" + suffix, tag, errs[0],
               cuda_ms(torch, run_scatter(ops.slab_scatter), 10, setup),
               cuda_ms(torch, run_scatter(fpset.slab_scatter_plain), 3,
                       setup),
               (8 * N + N + 4 * nvalid))
        record("slab_resolve" + suffix, tag, max(errs[1:4]),
               cuda_ms(torch, run_resolve(ops.slab_resolve), 10,
                       resolve_setup),
               cuda_ms(torch, run_resolve(fpset.slab_resolve_plain), 3,
                       resolve_setup),
               (8 * N + 4 * nvalid + N + 3 * N))
        record("slab_compact" + suffix, tag, errs[5],
               cuda_ms(torch, lambda _: ops.slab_compact(cand, pos, R,
                                                          c_lane), 10),
               cuda_ms(torch, lambda _: fpset.slab_compact_plain(
                   cand, pos, R, c_lane), 3),
               (N + 8 * n_cand + 4 * min(n_cand, R)))  # pos read at claimants
        return n_cand, k[5], k[4][-1]

    def order_mark(name, keys, c_lane, n_cand_t):
        """K6 kernel against plain; (s_key, perm, c_idx, active)."""
        n_cand = int(n_cand_t)
        ok_ = ops.slab_order(keys, c_lane, n_cand_t)
        op_ = fpset.slab_order_plain(keys, c_lane, R, n_cand_t)
        e_order = err_of(ok_, op_)
        need(e_order == 0, f"K6 slab_order differs ({tag}, {name})")
        s_key, perm = torch.sort(ok_, stable=True)
        ci_k, ac_k = ops.slab_mark(s_key, perm, c_lane, n_cand_t, ncand)
        ci_p, ac_p = fpset.slab_mark_plain(s_key, perm, c_lane, n_cand_t,
                                           ncand)
        e_mark = max(err_of(ci_k, ci_p), err_of(ac_k, ac_p))
        need(e_mark == 0, f"K6 slab_mark differs ({tag}, {name})")
        suffix = "" if name == "default" else "/" + name
        record("slab_order" + suffix, tag, e_order,
               cuda_ms(torch, lambda _: ops.slab_order(keys, c_lane,
                                                        n_cand_t), 10),
               cuda_ms(torch, lambda _: fpset.slab_order_plain(
                   keys, c_lane, R, n_cand_t), 3),
               (4 * R + 8 * min(n_cand, R) + 8 * R))
        record("slab_mark" + suffix, tag, e_mark,
               cuda_ms(torch, lambda _: ops.slab_mark(s_key, perm, c_lane,
                                                       n_cand_t, ncand), 10),
               cuda_ms(torch, lambda _: fpset.slab_mark_plain(
                   s_key, perm, c_lane, n_cand_t, ncand), 3),
               (8 * R + 8 * R + 4 * R + 8 * R + R))
        return s_key, ci_k, ac_k, ac_p

    def order_and_probe(name, keys, c_lane, n_cand_t, table0, C):
        """K6 then K3 with the slab mask, kernel against plain."""
        s_key, ci_k, ac_k, ac_p = order_mark(name, keys, c_lane, n_cand_t)
        nrep = int(ac_k.sum())
        t_k, t_p = table0.clone(), table0.clone()
        new_k = torch.empty(R, dtype=torch.uint8, device=dev)
        fpset.probe_segment(t_k, s_key, None, 0, C, new_k,
                            torch.zeros(1, dtype=torch.int32, device=dev),
                            ac_k)
        new_p = fpset.probe_segment_plain(t_p, s_key, ac_p.bool(), C)
        e_probe = max(err_of(new_k, new_p), err_of(t_k, t_p))
        need(e_probe == 0, f"K3 masked probe differs ({tag}, {name})")
        suffix = "" if name == "default" else "/" + name
        record("fpset_probe/masked_" + name, tag, e_probe,
               cuda_ms(torch, lambda t: ops.fpset_probe(t, s_key, None, 0,
                                                         ac_k), 10,
                       lambda: table0.clone()),
               cuda_ms(torch, lambda t: fpset.fpset_round0_plain(
                   t, s_key, ac_p.bool()), 3, lambda: table0.clone()),
               (R * (8 + 1 + 4) + nrep * 64))
        return s_key, ci_k, ac_k, nrep, int((new_k != 0).sum())

    # a table at 0.55 load of 4x the candidate width, like the K3 test
    cap = 1 << int(np.floor(np.log2(4.8 * ncand)))
    table0 = torch.zeros(cap // 8, 16, dtype=torch.int32, device=dev)
    while int(fpset.fpset_count(fpset.FPSet(table0))) < int(0.55 * cap):
        r_lo = torch.from_numpy(rng.integers(0, 2**32, ncand // 4,
                                             dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(dev)
        r_hi = torch.from_numpy(rng.integers(0, 2**32, ncand // 4,
                                             dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(dev)
        fpset.fpset_insert_sorted(fpset.FPSet(table0), r_lo, r_hi,
                                  torch.ones_like(r_lo, dtype=torch.bool),
                                  probe_width=R, claim_width=R)

    # default geometry on this step's real candidates; if their claimants
    # exceed R, the valid lanes are cut to R // 2 so K6 and K3 run too
    n_cand, c_lane, n_cand_t = slab_case("default", key, 0, None)
    m_cells = 1 << fpset.slab_log2_cells(ncand)
    memset_ms = cuda_ms(torch, lambda _: torch.zeros(
        m_cells, dtype=torch.int32, device=dev), 10)
    lines = [f"default: {n_cand} claimants; the slab's zeroing (torch.zeros "
             f"of {m_cells} cells, outside K5) {memset_ms:.4f} ms, bound "
             f"{4 * m_cells / HBM_BYTES_PER_S * 1e3:.4f} ms"]
    if n_cand > R:
        keep = valid & (torch.cumsum(valid.to(torch.int64), 0) <= R // 2)
        key = fpset.fpset_key(lo, hi, keep)
        n_cand, c_lane, n_cand_t = slab_case("default_cut", key, 0, False)
        lines.append(f"cut to {R // 2} valid lanes: {n_cand} claimants")
    s_key, ci, ac, nrep, nnew = order_and_probe("default", key, c_lane,
                                                n_cand_t, table0, R)
    lines.append(f"{nrep} representatives, {nnew} new")
    # slab_bits=3: 8 cells, nearly every class unresolved; R // 2 valid
    # lanes so that the claimants fit
    keep = valid & (torch.cumsum(valid.to(torch.int64), 0) <= R // 2)
    key3 = fpset.fpset_key(lo, hi, keep)
    n3, c_lane3, n3_t = slab_case("bits3", key3, 3, False)
    _, _, ac3, nrep3, _ = order_and_probe("bits3", key3, c_lane3, n3_t,
                                          table0, R)
    need(nrep3 < n3, f"slab_bits=3 left no duplicate row ({tag})")
    lines.append(f"slab_bits=3: {n3} claimants, {nrep3} representatives")
    # an all-distinct burst: every lane valid and distinct -> fallback
    b_lo = torch.from_numpy(rng.integers(0, 2**32, ncand, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)
    b_hi = torch.from_numpy(rng.integers(0, 2**32, ncand, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)
    keyb = fpset.fpset_key(b_lo, b_hi, torch.ones(ncand, dtype=torch.bool,
                                                  device=dev))
    nb, c_lane_b, nb_t = slab_case("burst", keyb, 0, True)
    _, _, ac_b, _ = order_mark("burst", keyb, c_lane_b, nb_t)
    need(bool(ac_b[-1]), f"K6 left row R - 1 of the burst open ({tag})")
    lines.append(f"all-distinct burst: {nb} claimants > R, sorted fallback "
                 f"(K6 on the overfull slice equal too)")

    # K7 on doctored rows: every 5th popped row holds identity 0 twice
    # (two versions), so OnlyOneVersion fails on most of its lanes
    fields = cdc.unpack(block)
    api = cdc.offsets["api"]
    word = (1 << cdc.o_present) | (0 << cdc.o_ident)
    rows_d = torch.arange(0, n, 5, device=dev)
    fields[rows_d, api] = word | (1 << cdc.o_vv)
    fields[rows_d, api + 1] = word
    dblock = cdc.pack(fields).contiguous()
    dpacked, dflags, daction, _ = backend.expand_block(cfg, dblock, n, True)
    dvalid = dflags[0].bool()
    dlo, dhi = fp64_words(dpacked, cdc.nbits)
    big = 1 << (2 * ncand - 1).bit_length()
    _, fresh, c_idx, _, fell = fpset.fpset_insert_slab(
        fpset.fpset_new(big, dev), dlo, dhi, dvalid, probe_width=R,
        claim_width=R)
    rows = ncand if fell else R
    got = backend.deferred_check(cfg, dblock, fresh, c_idx, daction, rows)
    ref = backend.deferred_check_plain(cfg, dblock, fresh, c_idx, daction,
                                       rows)
    err = max(err_of(a, b) for a, b in zip(got, ref))
    need(err == 0, f"K7 deferred_check differs from its plain version "
         f"({tag})")
    need(int(got[0]) == backend.VIOL_ONLYONEVERSION,
         f"K7 reported {int(got[0])}, not OnlyOneVersion, on doctored rows "
         f"({tag})")
    d_lanes = c_idx[:rows][fresh[:rows]]
    n_doct = int(((d_lanes // (ncand // ck)) % 5 == 0).sum())
    need(n_doct > 1, f"K7: {n_doct} fresh claimants from doctored rows "
         f"({tag})")
    n_fresh = int(fresh.sum())
    ms = cuda_ms(torch, lambda _: backend.deferred_check(
        cfg, dblock, fresh, c_idx, daction, rows), 10)
    pms = cuda_ms(torch, lambda _: backend.deferred_check_plain(
        cfg, dblock, fresh, c_idx, daction, rows), 2)
    record("deferred_check", tag, err, ms, pms,
           (rows * 9 + n_fresh * (W * 4 + 4) + F * 4))
    lines.append(f"K7: {n_fresh} fresh claimants of {rows} rows, "
                 f"{n_doct} from doctored rows, violation {int(got[0])} at "
                 f"action {int(got[2])}")

    # K8 on the scaled default-mode run's counters, as they are and with
    # every counter 3 below a multiple of 2^32 (the sticky overflow)
    carry = runs["scaled_auto"]["carry"]
    n_labels = 22
    top = (1 << 32) - 3  # 3 below 2^32: +5 wraps every uint32 view
    for name, wrap in (("", False), ("/wrap", True)):
        outs = []
        for fn in (counters.ring_row, counters.ring_row_plain):
            ring = carry.obs_ring.clone()
            head, bodies, exp_ = (carry.obs_head.clone(),
                                  carry.obs_bodies.clone(),
                                  carry.obs_expanded.clone())
            acts_old = torch.cat([carry.act_gen, carry.act_dist])
            g_old, d_old = carry.generated, carry.distinct
            if wrap:
                acts_old = torch.full_like(acts_old, top)
                g_old, d_old = g_old * 0 + top, d_old * 0 + top
            n_acts = carry.act_gen.shape[0]
            fn(ring, head, bodies, exp_, ck, True, carry.level, g_old + 9,
               g_old, d_old + 7, d_old, carry.level_n,
               acts_old[:n_acts] + 5, acts_old[n_acts:] + 5, acts_old,
               n_labels)
            outs.append((ring, head, bodies, exp_))
        err = max(err_of(a, b) for a, b in zip(*outs))
        need(err == 0, f"K8 ring_row differs from its plain version ({tag}"
             f"{name})")
        if wrap:
            need(int(outs[0][0][int(carry.obs_head) % SCALED_OBS_SLOTS,
                                counters.COL_OVERFLOW]) == 1,
                 "K8 missed a uint32 wrap")

        def ring_args(fn):
            def run(st):
                fn(st[0], st[1], st[2], st[3], ck, True, carry.level,
                   carry.generated, carry.generated, carry.distinct,
                   carry.distinct, carry.level_n, carry.act_gen,
                   carry.act_dist, torch.cat([carry.act_gen,
                                              carry.act_dist]), n_labels)
            return run

        def ring_setup():
            return (carry.obs_ring.clone(), carry.obs_head.clone(),
                    carry.obs_bodies.clone(), carry.obs_expanded.clone())

        slots1, cols = carry.obs_ring.shape
        record("ring_row" + name, tag, err,
               cuda_ms(torch, ring_args(counters.ring_row), 10, ring_setup),
               cuda_ms(torch, ring_args(counters.ring_row_plain), 3,
                       ring_setup),
               (slots1 * 4 + 4 * (n_labels + 1) * 8 + cols * 4 + 10 * 8))
    print(f"phase 2 slice-2 kernels vs plain ({tag}, chunk {ck}, {n} popped, "
          f"{ncand} candidates, R {R}): all bitwise equal; "
          + "; ".join(lines) + f"; library sort {lib_ms}", flush=True)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
