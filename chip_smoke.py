#!/usr/bin/env python3
"""Smoke test of the torchtlc port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port's main path from torchtlc/kernels/csrc,
drives the exhaustive BFS through the user entry points (engine.bfs.check's
engine) on the FF corner, on Model_1 and on the scaled 2x1 workload - in the
sorted immediate mode, then Model_1 at chunk 2048 and the scaled workload in
the default modes the reference resolves there (sort-free slab dedup,
deferred invariants; the scaled run with the counter ring) - then the
user's command, ``python -m torchtlc.cli check MC.cfg``, on a Model_1
MC.tla/MC.cfg pair written to a temporary directory: a clean run (phase 7),
auto-regrow from -fpcap 65536 (7b), the host spill tier behind kernel K9 at
Model_1 and at the scaled size (8, 8b), SIGTERM -> exit 75 -> -recover
(9) and a violation's counterexample (9b); then the device coverage plane
behind kernel K10: Model_1 with coverage in both mode sets (10), the
scaled 2x1 workload with coverage, timed against coverage off (10b), and
``python -m torchtlc.cli check MC.cfg -coverage`` (10c); then the
pipelined body (``pipeline=True``, a composition of the same kernels):
Model_1 in both mode sets and the scaled workload at two chunks, timed
against the unpipelined body (11), ``check MC.cfg -pipeline`` through
SIGTERM -> exit 75 -> -recover, the wrong-mode resume refused and the
journal's segment-scope phase rows (11b), and auto-regrow under -pipeline
(11c); then the sharded engine, D fingerprint-space shards in one process
behind kernels K11-K13: ``torchtlc.entry.dryrun_multichip(8)`` on Model_1
with the reference's shard-table digest and FF at 1, 2 and 8 shards (12),
the scaled 2x1 workload on 4 shards against the single-device table's
fingerprint set, unpipelined and pipelined in turns (12b), and ``check
MC.cfg -sharded 4`` - clean, a table regrow, a route-bucket regrow
unpipelined and pipelined, -coverage, and -pipeline through SIGTERM ->
exit 75 -> -recover (12c).  It checks every
result against its pinned value, holds each kernel bitwise against its
plain torch version on the card, and prints:

* one line per phase;
* a line with the card's name and power limit (nvidia-smi);
* a JSON line {"kernels": [...]} with each kernel's launches on the main
  paths (the two Model_1 and the two scaled engine runs, the in-process
  command, regrow, spill and violation runs, the three covered engine
  runs, and the four pipelined engine runs and the pipelined regrow; each
  path's counts are reset just before it and read just after),
  its error against the plain
  version, its time, the plain version's time, its bound on this card
  and, where one PyTorch call computes the same function, that call's
  time;
* last, {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Any mismatch exits nonzero before the last line.  Without a CUDA device, or
without the torchtlc package beside it, it exits nonzero and prints no
result.  The build's ptxas report goes to torchtlc/kernels/_build/ptxas.txt.
``--phases 7,8`` runs phase 1 and the named later phases only (for
iterating on the card; the contract run takes no arguments); ``2c`` names
K10's check against its plain version, untimed; ``--phases 11,11b,11c`` is
the pipelined slice alone, ``--phases 12,12b,12c`` the sharded one.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# SHA-256 of the reference engine's 311-site coverage vector (little-endian
# uint32, site-table order) on Model_1 at M1_KW, jaxtlc.engine.bfs.check(
# MODEL_1, **M1_KW, coverage=True, sort_free=False, deferred=False); the
# vector does not depend on the modes (slow test in
# tests/test_torch_coverage_cli.py)
M1_COVERAGE_SHA256 = (
    "2c1f7f2d71ccb42bc3bad5fd96da4fcac8e5a99567ad8f829b5db9a48893cb4f")
# SHA-256 of the Model_1 per-expression dump lines of `check -coverage
# -noTool` (coverage_dump below: the timestamp masked), from the reference
# host walker (tests/test_torch_coverage_cli.py re-derives it)
M1_COVERAGE_DUMP_SHA256 = (
    "f8565fc31586f2197788242c318e445b888873d2964f8a42d349302177252c5a")

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
# the sharded engine: dryrun_multichip's Model_1 geometry (per shard), the
# SHA-256 of its 8 shard tables ([8, 2^16, 16] little-endian uint32) from
# the reference, jaxtlc.engine.sharded.make_sharded_engine(ModelConfig(
# True, True), <8-device CPU mesh>, **M1_SHARDED_KW) (re-derived by
# tests/test_torch_sharded.py), and its per-action distinct counts (its
# in-batch attribution)
M1_SHARDED_KW = dict(chunk=2048, queue_capacity=1 << 15,
                     fp_capacity=1 << 19)
M1_SHARDED_TABLE_SHA256 = (
    "5ad6e4f7ac84df02f1bbc70b175c20d30659c91e9dde60fb8f9f84dede8cbbc6")
M1_SHARDED_DISTINCT = {
    "DoRequest": 21067, "DoReply": 22194, "DoListRequest": 9096,
    "DoListReply": 19130, "CStart": 16155, "C1": 9033, "C10": 3823,
    "C11": 5933, "c12": 1703, "C13": 7089, "C2": 382, "C3": 686, "C8": 341,
    "C6": 202, "C7": 392, "C4": 279, "C5": 629, "PVCStart": 11487,
    "PVCListedPVCs": 15119, "PVCHavePVCs": 6547, "PVCDone": 1930,
    "APIStart": 10189,
}
M1_SHARDED_OUTDEGREE = (1, 0, 4, 3)
# the scaled workload on 4 shards: 32,768 per shard, 131,072 in all (phase
# 5b's width); qcap 2^20 and fp 2^24 per shard (four 128 MiB tables)
SCALED_SHARDED_KW = dict(chunk=1 << 15, queue_capacity=1 << 20,
                         fp_capacity=1 << 24)

# the command's phases: a Model_1 model directory (both constants TRUE)
MC_TLA = """---- MODULE MC ----
EXTENDS KubeAPI, TLC

\\* CONSTANT definitions @modelParameterConstants:1REQUESTS_CAN_FAIL
const_fail ==
{fail}

\\* CONSTANT definitions @modelParameterConstants:2REQUESTS_CAN_TIMEOUT
const_to ==
{timeout}
====
"""
MC_CFG = """CONSTANT defaultInitValue = defaultInitValue
CONSTANT REQUESTS_CAN_FAIL <- const_fail
CONSTANT REQUESTS_CAN_TIMEOUT <- const_to
SPECIFICATION Spec
INVARIANT TypeOK
INVARIANT OnlyOneVersion
"""
# spill at Model_1: the reference's own setting (tests/test_spill.py:325)
M1_SPILL_KW = dict(chunk=1024, queue_capacity=1 << 13, fp_capacity=1 << 17)
# spill at the scaled size: the table saturates at ~14.2M of 19.36M
SCALED_SPILL_KW = dict(chunk=8192, queue_capacity=1 << 21,
                       fp_capacity=1 << 24)
SPILL_N = 8192 * 12  # K9's lanes at the scaled spill step

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

    only = None
    if "--phases" in sys.argv:
        only = set(sys.argv[sys.argv.index("--phases") + 1].split(","))

    def want(phase):
        return only is None or phase in only

    runs = {}
    if only is None:
        runs["ff"] = phase_ff(torch, ops)
        phase_violation(torch)
        runs["m1"] = phase_model1(torch, ops, card)
        runs["m1_auto"] = phase_model1_auto(torch, ops, card)
        runs["scaled"] = phase_scaled(torch, ops, card)
        runs["scaled_auto"] = phase_scaled_auto(torch, ops, card,
                                                runs["scaled"])
    if only is not None and "2c" in only:
        check_coverage_blocks(torch, ops)
    if want("10"):
        runs.update(phase_coverage_model1(torch, ops, card))
    if want("10b"):
        runs["cov_scaled"] = phase_coverage_scaled(torch, ops, card, runs)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        model = write_model(tmp, "Model_1", True, True)
        if want("7"):
            runs["cmd"] = phase_command(torch, ops, model, card)
        if want("7b"):
            runs["regrow"] = phase_regrow(torch, ops, model, tmp, runs, card)
        if want("8"):
            runs["spill_m1"] = phase_spill_model1(torch, ops, card)
        if want("8b"):
            runs["spill_scaled"] = phase_spill_scaled(torch, ops, card)
        if want("9"):
            phase_preempt(model, tmp)
        if want("9b"):
            runs["viol_cmd"] = phase_violation_command(
                torch, ops, write_model(tmp, "Model_FF", False, False))
        if want("10c"):
            phase_coverage_command(model, tmp, card)
        if want("11"):
            runs.update(phase_pipeline(torch, ops, card))
        if want("11b"):
            phase_pipeline_command(model, tmp, card)
        if want("11c"):
            runs["pipe_regrow"] = phase_pipeline_regrow(ops, model, card)
        if want("12"):
            runs.update(phase_sharded_model1(torch, ops, card, runs))
        if want("12b"):
            runs.update(phase_sharded_scaled(torch, ops, card, runs))
        if want("12c"):
            runs.update(phase_sharded_command(ops, model, tmp, card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if only is not None and "2" in only:
        check_member(torch, ops, runs, lambda *a: None)
    if only is not None:
        print(f"chip_smoke: phases {sorted(only)} passed (a partial run "
              "prints no contract lines)", flush=True)
        return 0
    main = ("m1", "m1_auto", "scaled", "scaled_auto", "cmd", "regrow",
            "spill_m1", "spill_scaled", "viol_cmd", "cov_m1", "cov_m1_auto",
            "cov_scaled", "pipe_m1", "pipe_m1_auto", "pipe_scaled",
            "pipe_scaled_65536", "pipe_regrow", "shard_m1", "shard_scaled",
            "shard_scaled_pipe", "shard_cmd", "shard_cmd_fp",
            "shard_cmd_route", "shard_cmd_pipe_route", "shard_cmd_cov")
    launches = {k: sum(runs[r]["launches"][k] for r in main)
                for k in ops.KERNELS}
    kernels = phase_kernels(torch, ops, runs, launches)
    print(f"phase 6 launches on the main paths ({', '.join(main)}): "
          f"{launches}", flush=True)
    for r in ("shard_m1", "shard_scaled", "shard_scaled_pipe"):
        print(f"phase 6 {r}: {runs[r]['bodies']} bodies, launches per body "
              f"{runs[r]['per_body']:.1f}", flush=True)
    for k, v in launches.items():
        need(v > 0, f"kernel {k} was not launched on the main path")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_engine(torch, ops, cfg, kw, modes=SORTED, coverage=False,
               pipeline=False):
    """One exhaustive run through the port's engine entry points, with the
    launch counts reset just before and read just after; `modes` {} takes
    the defaults, coverage=True carries the coverage plane, pipeline=True
    runs the pipelined body.  Returns (carry, result, launches, run_fn)."""
    from torchtlc.engine.bfs import make_engine, result_from_carry
    from torchtlc.engine.fpset import fpset_actual_collision
    from torchtlc.spec.coverage_device import site_table

    init_fn, run_fn, _ = make_engine(cfg, **modes, **kw, coverage=coverage,
                                     pipeline=pipeline)
    carry = init_fn()
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.time()
    carry = run_fn(carry)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    r = result_from_carry(carry, wall, iterations=run_fn.steps,
                          fp_capacity=kw["fp_capacity"],
                          sites=site_table(cfg) if coverage else None)
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
# phases 7-9: the user's command, regrow, the spill tier, preemption
# ---------------------------------------------------------------------------


def write_model(tmp, name, fail, timeout):
    """A Toolbox model directory: MC.tla + MC.cfg; returns the MC.cfg."""
    d = os.path.join(tmp, name)
    os.makedirs(d)
    with open(os.path.join(d, "MC.tla"), "w") as f:
        f.write(MC_TLA.format(fail="TRUE" if fail else "FALSE",
                              timeout="TRUE" if timeout else "FALSE"))
    with open(os.path.join(d, "MC.cfg"), "w") as f:
        f.write(MC_CFG)
    return os.path.join(d, "MC.cfg")


def command_err(argv):
    """python -m torchtlc.cli check ... as a subprocess: (rc, stdout,
    stderr)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    p = subprocess.run([sys.executable, "-m", "torchtlc.cli", "check",
                        *argv], cwd=here, env=env, capture_output=True,
                       text=True, timeout=600)
    return p.returncode, p.stdout, p.stderr


def command(argv):
    """The command as a subprocess: (rc, stdout); stderr printed unless
    it exits 0, 12 or 75."""
    rc, out, err = command_err(argv)
    if rc not in (0, 12, 75):
        print(err[-4000:], file=sys.stderr)
    return rc, out


def command_here(ops, argv):
    """The same command in this process (torchtlc.cli.main), its launch
    counts reset just before and read just after: (rc, stdout, launches,
    wall)."""
    from torchtlc.cli import main as cli_main

    out = io.StringIO()
    ops.reset_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["check", *argv])
    return rc, out.getvalue(), dict(ops.LAUNCHES), time.time() - t0


def final_counts(text):
    """(generated, distinct, depth) from a transcript's 2199/2194 lines."""
    g = d = depth = None
    for line in text.splitlines():
        if line.endswith("states left on queue.") and "distinct states " \
                "found," in line and not line.startswith("Progress"):
            parts = line.split()
            g, d = int(parts[0]), int(parts[3])
        if line.startswith("The depth of the complete state graph search"):
            depth = int(line.rstrip(".").split()[-1])
    return g, d, depth


def phase_command(torch, ops, cfg, card):
    """Phase 7: the user's command on Model_1 - a subprocess in plain-text
    mode, then the same command in this process in tool mode (its kernel
    launches are counted)."""
    t0 = time.time()
    rc, out = command([cfg, "-noTool"])
    sub_wall = time.time() - t0
    need(rc == 0, f"the command exited {rc} on Model_1")
    need(final_counts(out) == M1_COUNTS,
         f"the command's counts {final_counts(out)}")
    need("Model checking completed. No error has been found" in out,
         "the command did not report success")
    rc, out, launches, wall = command_here(ops, [cfg])
    need(rc == 0, f"the command (tool mode) exited {rc}")
    for code in ("@!@!@STARTMSG 2193", "@!@!@STARTMSG 2199",
                 "@!@!@ENDMSG"):
        need(code in out, f"tool mode lacks {code}")
    need(all(f"{n:,}" in out or str(n) in out for n in M1_COUNTS[:2]),
         "tool mode lacks the counts")
    print(f"phase 7 command: `python -m torchtlc.cli check MC.cfg -noTool` "
          f"exit 0, {M1_COUNTS[0]} / {M1_COUNTS[1]} / {M1_COUNTS[2]} "
          f"({sub_wall:.1f} s as a subprocess, start-up and build lookup "
          f"included); tool mode in-process exit 0, framed 2193/2199, "
          f"{wall:.2f} s on {card}; launches {launches}", flush=True)
    return {"launches": launches}


def phase_regrow(torch, ops, cfg, tmp, runs, card):
    """Phase 7b: the command with -fpcap 65536 regrows twice (65,536 ->
    131,072 -> 262,144) to the same counts; its final checkpoint's table
    holds the same stored words as phase 4's Model_1 table (fp 2^18,
    chunk 1024), compared sorted (slots depend on insertion order)."""
    import numpy as np

    ck = os.path.join(tmp, "regrow.ckpt")
    rc, out, launches, wall = command_here(
        ops, [cfg, "-noTool", "-fpcap", "65536", "-checkpoint", ck])
    need(rc == 0, f"the regrow command exited {rc}")
    need(final_counts(out) == M1_COUNTS,
         f"the regrow command's counts {final_counts(out)}")
    grows = [line for line in out.splitlines() if "regrowing" in line]
    need(len(grows) == 2 and "65536 -> 131072" in grows[0]
         and "131072 -> 262144" in grows[1], f"regrow events {grows}")
    with np.load(ck) as z:
        table = z["leaf_0"]
    need(table.shape == (262144 // 8, 16), f"final table {table.shape}")
    ref = model1_table(torch, ops, runs).cpu().numpy().view(np.uint32)

    def stored(t):
        w = t.reshape(-1, 2).astype(np.uint64)
        w = w[(w[:, 0] != 0) | (w[:, 1] != 0)]
        return np.sort((w[:, 1] << np.uint64(32)) | w[:, 0])

    a, b = stored(table), stored(ref)
    need(a.shape == b.shape and bool((a == b).all()),
         "the regrown table's words differ from the fp 2^18 run's")
    print(f"phase 7b regrow: -fpcap 65536 -> 2 regrows ({grows[0].strip()} "
          f"| {grows[1].strip()}), {M1_COUNTS}, final table's "
          f"{a.shape[0]} stored words equal to phase 4's; {wall:.2f} s on "
          f"{card}; launches {launches}", flush=True)
    return {"launches": launches}


def model1_table(torch, ops, runs):
    """Phase 4's Model_1 table (fp 2^18, load 0.62), run anew in a partial
    run."""
    if "m1" not in runs:
        from torchtlc.config import MODEL_1

        runs["m1"] = {"carry": run_engine(torch, ops, MODEL_1, M1_KW)[0]}
    return runs["m1"]["carry"].fps.table


def run_supervised(torch, ops, cfg, kw, opts):
    """check_supervised on the card, counts reset before and read after."""
    from torchtlc.resil.supervisor import check_supervised

    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    sup = check_supervised(cfg, **kw, opts=opts)
    torch.cuda.synchronize()
    return sup, dict(ops.LAUNCHES), time.time() - t0


def phase_spill_model1(torch, ops, card):
    """Phase 8: Model_1 through the spill tier (fp 2^17 with the first
    regrow probe denied): the clean counts, K9 launched, a spilled host
    store, spill_hits in the counter ring."""
    from torchtlc.config import MODEL_1
    from torchtlc.resil.faults import FaultPlan
    from torchtlc.resil.supervisor import SupervisorOptions

    levels = []
    opts = SupervisorOptions(
        faults=FaultPlan.parse("alloc_fail@1"),
        on_event=lambda k, i: levels.append(i) if k == "level" else None)
    sup, launches, wall = run_supervised(
        torch, ops, MODEL_1, dict(M1_SPILL_KW, obs_slots=256), opts)
    r = sup.result
    print(f"phase 8 spill Model_1 (fp 2^17, alloc_fail@1): {r.generated} / "
          f"{r.distinct} / {r.depth}, {sup.spilled} fingerprints spilled in "
          f"{sup.spill_flushes} flushes, {sup.spill_hits} host hits, host "
          f"store {sup.spill_store_s:.3f} s, wall {wall:.2f} s on {card}; "
          f"K9 launches {launches['fpset_member']}", flush=True)
    need((r.generated, r.distinct, r.depth) == M1_COUNTS, "spill counts")
    need(r.violation == 0 and r.queue_left == 0, "spill verdict")
    need(sup.spilled > 0 and sup.spill_hits > 0, "nothing spilled")
    need(launches["fpset_member"] > 0, "K9 was not launched")
    need(max(row.get("spill_hits", 0) for row in levels) == sup.spill_hits,
         "the ring's spill column lacks spill_hits")
    return {"launches": launches}


def phase_spill_scaled(torch, ops, card):
    """Phase 8b: the scaled 2x1 workload at chunk 8192 with a 2^24-slot
    table and the spill tier preferred at the first saturation: phase 5's
    counts, ~14M fingerprints in the host store."""
    from torchtlc.config import scaled_config
    from torchtlc.resil.supervisor import SupervisorOptions

    cfg, _ = scaled_config()
    flushes = []
    opts = SupervisorOptions(
        spill="on",
        on_event=lambda k, i: flushes.append(i)
        if k == "spill" and i["phase"] == "flush" else None)
    sup, launches, wall = run_supervised(torch, ops, cfg, SCALED_SPILL_KW,
                                         opts)
    r = sup.result
    flush_s = sum(f["wall_s"] for f in flushes)
    print(f"phase 8b spill scaled 2x1 (chunk 8192, fp 2^24, -spill): "
          f"{r.generated} / {r.distinct} / {r.depth}, wall {wall:.2f} s on "
          f"{card}; host store {sup.spill_store_s:.2f} s ({flush_s:.2f} s "
          f"in {sup.spill_flushes} flushes, the rest probes); "
          f"{sup.spilled} fingerprints spilled, {sup.spill_hits} host hits; "
          f"K9 launches {launches['fpset_member']}, {sup.segments} "
          f"segments", flush=True)
    need((r.generated, r.distinct, r.depth) == SCALED_COUNTS,
         "scaled spill counts")
    need(r.violation == 0 and r.queue_left == 0, "scaled spill verdict")
    need(sup.spilled > 0 and launches["fpset_member"] > 0,
         "the scaled run did not spill")
    return {"launches": launches}


def phase_preempt(cfg, tmp):
    """Phase 9: SIGTERM at segment 3 -> exit 75 with a final checkpoint;
    -recover -> exit 0 with the clean counts (both as subprocesses)."""
    ck = os.path.join(tmp, "preempt.ckpt")
    base = [cfg, "-noTool", "-checkpoint", ck, "-checkpointevery", "32"]
    t0 = time.time()
    rc, out = command(base + ["-faults", "sigterm@3"])
    wall_term = time.time() - t0
    need(rc == 75, f"the SIGTERM run exited {rc}, not 75")
    need("Run interrupted by signal" in out, "no interrupt banner")
    t0 = time.time()
    rc, out2 = command(base + ["-recover"])
    wall_recover = time.time() - t0
    need(rc == 0, f"the -recover run exited {rc}")
    need(final_counts(out2) == M1_COUNTS,
         f"the resumed counts {final_counts(out2)}")
    need("Starting recovery from checkpoint" in out2, "no recovery banner")
    print(f"phase 9 preemption: sigterm@3 -> exit 75 "
          f"({final_counts(out)[:2]} checkpointed, {wall_term:.2f} s), "
          f"-recover -> exit 0, {M1_COUNTS} ({wall_recover:.2f} s; both "
          f"walls are subprocesses, interpreter start included)", flush=True)


def trace_text(text):
    """The counterexample: from "State 1:" to the final Progress line."""
    lines = text.splitlines()
    first = next(i for i, x in enumerate(lines) if x.startswith("State 1:"))
    last = max(i for i, x in enumerate(lines) if x.startswith("Progress("))
    return "\n".join(lines[first:last])


def phase_violation_command(torch, ops, cfg):
    """Phase 9b: FF with -mutation delete_noop exits 12 with the
    reference's trace re-run on the card; its text equals the -workers
    cpu run's."""
    argv = [cfg, "-noTool", "-mutation", "delete_noop", "-chunk", "256"]
    rc, out, launches, wall = command_here(ops, argv)
    need(rc == 12, f"the violation run exited {rc}, not 12")
    rc_cpu, out_cpu, _, _ = command_here(ops, argv + ["-workers", "cpu"])
    need(rc_cpu == 12, f"the -workers cpu violation run exited {rc_cpu}")
    t_gpu, t_cpu = trace_text(out), trace_text(out_cpu)
    need(t_gpu == t_cpu, "the card's trace differs from the CPU run's")
    n_states = t_gpu.count("\nState ") + 1
    need("assert" in out.lower() and n_states > 1, "no assertion trace")
    print(f"phase 9b violation: delete_noop -> exit 12, a {n_states}-state "
          f"trace equal to the -workers cpu run's ({wall:.2f} s); launches "
          f"{launches}", flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phases 10-10c: the device coverage plane (kernel K10)
# ---------------------------------------------------------------------------


def coverage_vector(result, sites):
    """The 311-site vector of a covered result ([311] little-endian
    uint32, site-table order) and its SHA-256."""
    import numpy as np

    vec = np.asarray([result.site_coverage[s.key] for s in sites], "<u4")
    return vec, hashlib.sha256(vec.tobytes()).hexdigest()


def coverage_dump(text):
    """The per-expression dump of a -noTool transcript: the lines from the
    2201 banner up to the Progress line after it, the timestamp masked."""
    import re

    lines = text.splitlines()
    first = next(i for i, x in enumerate(lines)
                 if x.startswith("The coverage statistics at "))
    last = next(i for i in range(first, len(lines))
                if lines[i].startswith("Progress("))
    return [re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", x)
            for x in lines[first:last]]


def phase_coverage_model1(torch, ops, card):
    """Phase 10: Model_1 with the coverage plane, chunk 1024 sorted and
    chunk 2048 in the default modes: the coverage-off counts and table
    words, the reference's 311-site vector, MC.out's per-action generated
    counts as its prefix, and the Init and span sites equal to the port's
    host walker."""
    from torchtlc.config import MODEL_1
    from torchtlc.spec.coverage import run_coverage
    from torchtlc.spec.coverage_device import site_table

    sites = site_table(MODEL_1)
    out, walls = {}, []
    for key, kw, modes, table_pin in (
            ("cov_m1", M1_KW, SORTED, M1_TABLE_SHA256),
            ("cov_m1_auto", M1_2048_KW, {}, M1_2048_TABLE_SHA256)):
        carry, r, launches, _ = run_engine(torch, ops, MODEL_1, kw, modes,
                                           coverage=True)
        _, sha = coverage_vector(r, sites)
        need((r.generated, r.distinct, r.depth) == M1_COUNTS,
             f"{key}: counts {(r.generated, r.distinct, r.depth)}")
        need(r.violation == 0 and r.queue_left == 0, f"{key}: verdict")
        need(table_sha256(carry.fps.table) == table_pin,
             f"{key}: table words differ from the coverage-off pin")
        need(sha == M1_COVERAGE_SHA256, f"{key}: site vector {sha[:16]}")
        need({s.key: r.site_coverage[s.key] for s in sites[:22]}
             == MC_OUT_GENERATED, f"{key}: the action prefix is not MC.out's")
        need(launches["coverage_count"] == r.iterations,
             f"{key}: {launches['coverage_count']} K10 launches in "
             f"{r.iterations} bodies")
        out[key] = {"launches": launches, "result": r}
        walls.append(r.wall_s)
    t0 = time.time()
    walk = run_coverage(MODEL_1)
    walk_s = time.time() - t0
    need((walk.generated, walk.distinct, walk.depth) == M1_COUNTS,
         "the host walker's counts")
    r = out["cov_m1"]["result"]
    bad = [s.key for s in sites if s.kind != "action"
           and r.site_coverage[s.key] != walk.cov.n.get(s.key, 0)]
    need(not bad, f"sites differ from the host walker: {bad[:8]}")
    print(f"phase 10 Model_1 with coverage: {M1_COUNTS}, site vector sha256 "
          f"{M1_COVERAGE_SHA256[:16]} at chunk 1024 sorted ({walls[0]:.3f} s)"
          f" and chunk 2048 default modes ({walls[1]:.3f} s), tables equal to"
          f" the coverage-off pins, prefix = MC.out, 289 Init and span sites "
          f"equal to the host walker ({walk_s:.1f} s) on {card}; K10 "
          f"launches {out['cov_m1']['launches']['coverage_count']} + "
          f"{out['cov_m1_auto']['launches']['coverage_count']}", flush=True)
    return out


def phase_coverage_scaled(torch, ops, card, runs):
    """Phase 10b: the scaled 2x1 workload with the coverage plane at full
    width (chunk 131072, default modes, the counter ring): the coverage-off
    counts and table words, the action prefix equal to the carry's
    per-action generated counts, K10 equal to count_plain on blocks taken
    during the run; then the wall with and without coverage, alternating."""
    from torchtlc.config import scaled_config
    from torchtlc.engine.backend import kubeapi_backend
    from torchtlc.engine.bfs import make_backend_engine, result_from_carry
    from torchtlc.spec.coverage_device import count_plain

    cfg, kw = scaled_config()
    kw_ring = dict(kw, obs_slots=SCALED_OBS_SLOTS)
    ck = kw["chunk"]
    if "scaled" in runs:
        off_sha = runs["scaled"]["sha"]
    else:  # a partial run: the coverage-off table anew
        off_sha = table_sha256(run_engine(torch, ops, cfg, kw)[0].fps.table)
    base = kubeapi_backend(cfg, coverage=True)
    plane = base.coverage
    taken = []

    def count(block, n, valid):
        # K10 as the engine calls it; the inputs and output of the first
        # body, of two full-width bodies and of a small-width body are kept
        out = plane.count(block, n, valid)
        kinds = [t[4] for t in taken]
        kind = ("first" if not taken else
                "full" if n == ck and kinds.count("full") < 2 else
                "small" if block.shape[0] < ck and "small" not in kinds
                else None)
        if kind is not None:
            taken.append((block.clone(), n, valid.clone(), out.clone(), kind))
        return out

    init_fn, run_fn, _ = make_backend_engine(
        base._replace(coverage=plane._replace(count=count)), **kw_ring)
    carry = init_fn()
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.time()
    carry = run_fn(carry)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    r = result_from_carry(carry, wall, iterations=run_fn.steps,
                          fp_capacity=kw["fp_capacity"], sites=plane.sites)
    need((r.generated, r.distinct, r.depth) == SCALED_COUNTS,
         "scaled with coverage: counts")
    need(r.violation == 0 and r.queue_left == 0, "scaled with coverage: "
         "verdict")
    need(table_sha256(carry.fps.table) == off_sha,
         "scaled with coverage: table words differ from coverage off")
    need({s.key: r.site_coverage[s.key] for s in plane.sites[:22]}
         == {a: r.action_generated.get(a, 0)
             for a in (s.key for s in plane.sites[:22])},
         "scaled: the action prefix is not the carry's act_gen")
    need(launches["coverage_count"] == r.iterations,
         "scaled: a body without K10")
    need(len(taken) >= 3, f"only {len(taken)} blocks taken")
    for block, n, valid, out, kind in taken:
        plain = count_plain(cfg, block, n, valid)
        need(torch.equal(out, plain),
             f"K10 differs from count_plain on the {kind} body ({n} rows)")
    del carry
    walls = {False: [], True: []}
    for cov in (False, True, True, False) * 2:
        c2, r2, _, _ = run_engine(torch, ops, cfg, kw_ring, modes={},
                                  coverage=cov)
        need((r2.generated, r2.distinct) == SCALED_COUNTS[:2],
             "scaled timing run: counts")
        walls[cov].append(r2.wall_s)
        del c2
    off, on = (sorted(walls[k])[1:3] for k in (False, True))
    off, on = sum(off) / 2, sum(on) / 2  # the middle two of four
    print(f"phase 10b scaled 2x1 with coverage (chunk {ck}, default modes + "
          f"ring): {SCALED_COUNTS}, table equal to coverage off, prefix = "
          f"act_gen, K10 = count_plain on {len(taken)} bodies "
          f"({', '.join(f'{t[4]} n={t[1]}' for t in taken)}); "
          f"{r.iterations} bodies in {wall:.3f} s; walls in turns "
          f"off/on/on/off/off/on/on/off: off "
          f"{[round(w, 4) for w in walls[False]]} s, on "
          f"{[round(w, 4) for w in walls[True]]} s; middle-two means: "
          f"coverage {on:.4f} s vs {off:.4f} s ({(on / off - 1) * 100:+.2f}%)"
          f" on {card}; launches {launches}", flush=True)
    return {"launches": launches, "wall_off": walls[False],
            "wall_on": walls[True]}


def phase_coverage_command(cfg, tmp, card):
    """Phase 10c: `python -m torchtlc.cli check MC.cfg -coverage` as a
    subprocess on Model_1: exit 0, the dump lines equal to the reference's
    (pinned digest), and the journal's coverage events folding to the
    final carry's totals (the checkpoint's cov_counts leaf)."""
    import numpy as np

    from torchtlc.config import MODEL_1
    from torchtlc.obs.coverage import coverage_from_events
    from torchtlc.obs.journal import read as read_journal
    from torchtlc.spec.coverage_device import site_table

    ck = os.path.join(tmp, "cov.ckpt")
    t0 = time.time()
    rc, out = command([cfg, "-noTool", "-coverage", "-checkpoint", ck])
    wall = time.time() - t0
    need(rc == 0, f"the -coverage command exited {rc}")
    need(final_counts(out) == M1_COUNTS,
         f"the -coverage command's counts {final_counts(out)}")
    dump = coverage_dump(out)
    dump_sha = hashlib.sha256("\n".join(dump).encode()).hexdigest()
    need(dump_sha == M1_COVERAGE_DUMP_SHA256,
         f"the dump's digest {dump_sha[:16]} is not the reference's")
    events = read_journal(ck + ".journal.jsonl")
    folded = coverage_from_events(events)
    with np.load(ck) as z:
        n_leaves = sum(k.startswith("leaf_") for k in z.files)
        cov = z[f"leaf_{n_leaves - 1}"]
    sites = site_table(MODEL_1)
    need(cov.shape == (311,) and hashlib.sha256(
        cov.astype("<u4").tobytes()).hexdigest() == M1_COVERAGE_SHA256,
         "the final carry's cov_counts differ from the pinned vector")
    need(folded is not None and folded["sites"] == {
        s.key: int(v) for s, v in zip(sites, cov) if v},
         "the journal's coverage events do not fold to the carry's totals")
    n_ev = sum(1 for e in events if e["event"] == "coverage")
    print(f"phase 10c command: `python -m torchtlc.cli check MC.cfg "
          f"-coverage` exit 0, {M1_COUNTS}, {len(dump)} dump lines equal to "
          f"the reference's (sha256 {dump_sha[:16]}), {n_ev} coverage events "
          f"folding to the carry's {folded['visited']} visited sites; "
          f"{wall:.1f} s as a subprocess on {card}", flush=True)


# ---------------------------------------------------------------------------
# phases 11-11c: the pipelined body
# ---------------------------------------------------------------------------


def phase_pipeline(torch, ops, card):
    """Phase 11: the pipelined engine.  Model_1 at chunk 1024 sorted pops
    the unpipelined blocks (below the two-tier threshold): MC.out's counts
    and per-action counts and phase 4's table words; at chunk 2048 in the
    default modes with coverage: phase 4b's table words and phase 10's
    site vector.  The scaled 2x1 workload in the default modes with the
    ring at chunk 131072 and 65536: single-tier there, so counts and
    per-action generated counts only (equal to the unpipelined run's);
    the 131072 walls alternate with the unpipelined body's."""
    from torchtlc.config import MODEL_1, scaled_config
    from torchtlc.engine.bfs import obs_rows
    from torchtlc.spec.coverage_device import site_table

    out, lines = {}, []
    carry, r, launches, run_fn = run_engine(torch, ops, MODEL_1, M1_KW,
                                            pipeline=True)
    sha = table_sha256(carry.fps.table)
    need((r.generated, r.distinct, r.depth) == M1_COUNTS,
         f"pipelined Model_1 counts {(r.generated, r.distinct, r.depth)}")
    need(r.outdegree == M1_OUTDEGREE and r.violation == 0
         and r.queue_left == 0, "pipelined Model_1 verdict")
    need(r.action_generated == MC_OUT_GENERATED,
         "pipelined Model_1 per-action generated")
    need(r.action_distinct == M1_DISTINCT,
         "pipelined Model_1 per-action distinct")
    need(sha == M1_TABLE_SHA256, "pipelined Model_1 table words")
    out["pipe_m1"] = {"launches": launches}
    lines.append(f"Model_1 chunk 1024 sorted {r.iterations} steps "
                 f"{r.wall_s:.3f} s")
    sites = site_table(MODEL_1)
    carry, r, launches, run_fn = run_engine(torch, ops, MODEL_1, M1_2048_KW,
                                            {}, coverage=True, pipeline=True)
    need((r.generated, r.distinct, r.depth) == M1_COUNTS,
         "pipelined Model_1 (2048, coverage) counts")
    need(r.violation == 0 and r.queue_left == 0,
         "pipelined Model_1 (2048, coverage) verdict")
    need(r.action_distinct == M1_2048_DISTINCT,
         "pipelined Model_1 (2048) per-action distinct")
    need(table_sha256(carry.fps.table) == M1_2048_TABLE_SHA256,
         "pipelined Model_1 (2048) table words")
    need(coverage_vector(r, sites)[1] == M1_COVERAGE_SHA256,
         "pipelined Model_1 (2048) site vector")
    need(launches["coverage_count"] == r.iterations,
         "pipelined Model_1 (2048): a body without K10")
    out["pipe_m1_auto"] = {"launches": launches}
    lines.append(f"Model_1 chunk 2048 default modes + coverage "
                 f"{r.iterations} steps {r.wall_s:.3f} s")
    del carry

    cfg, kw = scaled_config()
    kw_ring = dict(kw, obs_slots=SCALED_OBS_SLOTS)
    walls = {False: [], True: []}
    act_gen = {}
    for pipe in (False, True, True, False):
        c, r, launches, _ = run_engine(torch, ops, cfg, kw_ring, {},
                                       pipeline=pipe)
        need((r.generated, r.distinct, r.depth) == SCALED_COUNTS,
             f"scaled (pipeline={pipe}) counts")
        need(r.violation == 0 and r.queue_left == 0,
             f"scaled (pipeline={pipe}) verdict")
        rows, head = obs_rows(c)
        need(head == r.depth and (rows[-1]["generated"],
                                  rows[-1]["distinct"])
             == (r.generated, r.distinct),
             f"scaled (pipeline={pipe}): ring rows")
        act_gen.setdefault(pipe, r.action_generated)
        walls[pipe].append((r.wall_s, r.iterations))
        if pipe and "pipe_scaled" not in out:
            out["pipe_scaled"] = {"launches": launches}
        del c
        torch.cuda.empty_cache()
    need(act_gen[True] == act_gen[False],
         "scaled: pipelined per-action generated differ")
    c, r, launches, _ = run_engine(torch, ops, cfg,
                                   dict(kw_ring, chunk=1 << 16), {},
                                   pipeline=True)
    need((r.generated, r.distinct, r.depth) == SCALED_COUNTS,
         "scaled (pipelined, chunk 65536) counts")
    need(r.violation == 0 and r.queue_left == 0,
         "scaled (pipelined, chunk 65536) verdict")
    need(r.action_generated == act_gen[False],
         "scaled (pipelined, chunk 65536) per-action generated")
    out["pipe_scaled_65536"] = {"launches": launches}
    lines.append(f"scaled chunk 65536 pipelined {r.iterations} steps "
                 f"{r.wall_s:.3f} s")
    del c
    torch.cuda.empty_cache()
    print(f"phase 11 pipelined engine: {M1_COUNTS} with phase 4's and 4b's "
          f"table words and phase 10's site vector, {SCALED_COUNTS} at "
          f"chunk 131072 and 65536 with the unpipelined per-action "
          f"generated counts; {'; '.join(lines)}; scaled chunk {kw['chunk']}"
          f" default modes + ring, in turns unpipelined/pipelined/pipelined/"
          f"unpipelined: unpipelined "
          f"{[(round(w, 4), n) for w, n in walls[False]]}, pipelined "
          f"{[(round(w, 4), n) for w, n in walls[True]]} (s, steps) on "
          f"{card}", flush=True)
    return out


def phase_pipeline_command(cfg, tmp, card):
    """Phase 11b: `check MC.cfg -pipeline` with SIGTERM at segment 3 ->
    exit 75; -recover without -pipeline refused (the reference raises the
    same ValueError, exit 1); -recover -pipeline -> exit 0 with the
    Model_1 counts; every segment of the journal has its device and
    readback phase rows."""
    from torchtlc.obs.journal import read as read_journal

    ck = os.path.join(tmp, "pipe.ckpt")
    base = [cfg, "-noTool", "-checkpoint", ck, "-checkpointevery", "32"]
    t0 = time.time()
    rc, out = command(base + ["-pipeline", "-faults", "sigterm@3"])
    wall_term = time.time() - t0
    need(rc == 75, f"the -pipeline SIGTERM run exited {rc}, not 75")
    need(any("-recover" in x and "-pipeline" in x
             for x in out.splitlines()), "no -pipeline resume command")
    rc, _, err = command_err(base + ["-recover"])
    need(rc == 1 and "checkpoint pipeline mismatch" in err,
         f"the wrong-mode -recover exited {rc}: {err[-300:]}")
    t0 = time.time()
    rc, out = command(base + ["-pipeline", "-recover"])
    wall_recover = time.time() - t0
    need(rc == 0, f"the -pipeline -recover run exited {rc}")
    need(final_counts(out) == M1_COUNTS,
         f"the resumed -pipeline counts {final_counts(out)}")
    events = read_journal(ck + ".journal.jsonl")
    segs = [e["index"] for e in events if e["event"] == "segment"]
    phases = [(e["index"], e["phase"]) for e in events
              if e["event"] == "phase" and e["scope"] == "segment"]
    need(segs and phases == [(i, p) for i in segs
                             for p in ("device", "readback")],
         f"segment phase rows {phases[:6]} for segments {segs[:3]}")
    print(f"phase 11b command: `check MC.cfg -pipeline` sigterm@3 -> exit 75 "
          f"({wall_term:.2f} s), -recover without -pipeline refused (exit 1,"
          f" checkpoint pipeline mismatch), -recover -pipeline -> exit 0, "
          f"{M1_COUNTS} ({wall_recover:.2f} s; subprocesses); {len(segs)} "
          f"segments in the journal, each with its device and readback "
          f"phase rows, on {card}", flush=True)


def phase_pipeline_regrow(ops, cfg, card):
    """Phase 11c: `check MC.cfg -pipeline -fpcap 65536` regrows twice, the
    staged block migrated verbatim, to the Model_1 counts."""
    rc, out, launches, wall = command_here(
        ops, [cfg, "-noTool", "-pipeline", "-fpcap", "65536"])
    need(rc == 0, f"the -pipeline regrow command exited {rc}")
    need(final_counts(out) == M1_COUNTS,
         f"the -pipeline regrow counts {final_counts(out)}")
    grows = [line for line in out.splitlines() if "regrowing" in line]
    need(len(grows) == 2 and "65536 -> 131072" in grows[0]
         and "131072 -> 262144" in grows[1], f"regrow events {grows}")
    print(f"phase 11c regrow: -pipeline -fpcap 65536 -> 2 regrows, "
          f"{M1_COUNTS}; {wall:.2f} s on {card}; launches {launches}",
          flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phases 12-12c: the sharded engine (D shards in one process)
# ---------------------------------------------------------------------------


def run_sharded(torch, ops, cfg, D, kw, pipeline=False, obs_slots=0):
    """One exhaustive sharded run through the engine's entry points, the
    launch counts reset just before and read just after: (carry, result,
    launches, bodies)."""
    from torchtlc.engine import sharded as ts

    init_fn, run_fn = ts.make_sharded_engine(
        cfg, ts.ShardMesh(D), **kw, pipeline=pipeline, obs_slots=obs_slots)
    carry = init_fn()
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.time()
    carry = run_fn(carry)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    r = ts.result_from_shard_carry(carry, wall, iterations=run_fn.steps,
                                   fp_capacity_total=D * kw["fp_capacity"])
    return carry, r, launches, run_fn.steps


def _per_body(launches, bodies):
    return sum(launches.values()) / max(bodies, 1)


def sharded_kernel_checks(torch, ops, tag, cfg, kw, D, bodies, runs,
                          with_ring=False):
    """K1's sharded variant, K11 route_scatter, K12 verdict_fold, K13
    shard_enqueue, K7's received-rows variant (and K8's entry row) each
    held bitwise against its plain version and timed, on the carry of a
    sharded run `bodies` bodies in - the blocks that run pops next.  The
    rows go to runs["sharded_rows"] for the kernel table."""
    import numpy as np

    from torchtlc.engine import sharded as ts
    from torchtlc.engine.fingerprint import fp64_words
    from torchtlc.engine.fpset import FPSet, fpset_insert_dedup
    from torchtlc.obs import counters
    from torchtlc.spec.codec import get_codec

    rows = runs.setdefault("sharded_rows", {})
    library = runs.setdefault("sharded_library", {})

    def record(name, err, ms, pms, nbytes):
        rows.setdefault(name, []).append(dict(
            shape=tag, max_abs_err=err, ms=ms, plain_ms=pms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))

    def err_of(a, b):
        if a is None or b is None:
            return 0 if a is b else 1 << 62
        a, b = a.to(torch.int64), b.to(torch.int64)
        return int((a - b).abs().max()) if a.numel() else 0

    cdc = get_codec(cfg)
    init_fn, seg = ts.make_sharded_engine(cfg, ts.ShardMesh(D), **kw,
                                          segment=bodies,
                                          obs_slots=16 if with_ring else 0)
    c = seg(init_fn())
    dev = c.queue.device
    g = seg.geometry
    chunk, L, F, B, ncand = g["chunk"], g["L"], g["F"], g["B"], g["ncand"]
    W = cdc.n_words
    DB = D * B
    h = ts.read_bundle(c)
    need(h.viol == 0, f"sharded kernel step ({tag}): the run halted")
    n = [min(chunk, min(e, t) - q) for q, t, e in
         zip(h.qhead, h.qtail, h.level_end)]
    npop = torch.tensor(n, dtype=torch.int64, device=dev)
    deferred = g["deferred"]
    lines = []

    # K1, the sharded variant: the pops of all shards in one launch
    got = ts.expand_sharded(cfg, c.queue, c.qhead, npop, chunk, deferred,
                            True)
    ref = ts.expand_sharded_plain(cfg, c.queue, c.qhead, npop, chunk,
                                  deferred, True)
    err = max(err_of(a, b) for a, b in zip(got, ref))
    need(err == 0, f"K1 sharded variant differs from its plain version "
         f"({tag})")
    record("expand/sharded", err,
           cuda_ms(torch, lambda _: ts.expand_sharded(
               cfg, c.queue, c.qhead, npop, chunk, deferred, True), 20),
           cuda_ms(torch, lambda _: ts.expand_sharded_plain(
               cfg, c.queue, c.qhead, npop, chunk, deferred, True), 2),
           D * chunk * F * 4 + D * ncand * (W * 4 + 5 + 4 + F * 4)
           + D * chunk * W * 4)
    packed, flags, action, gen, fields, block = got
    lo, hi = fp64_words(packed, cdc.nbits)
    valid = flags[0]
    nvalid = int(valid.sum())

    # K11 route_scatter
    rk = ts.route_out_new(D, ncand, B, F, dev)
    rp = ts.route_out_new(D, ncand, B, F, dev)
    ts.route(hi, lo, valid, fields, D, B, rk)
    ts.route_plain(hi, lo, valid, fields, D, B, rp)
    err = max(err_of(getattr(rk, k), getattr(rp, k)) for k in (
        "order", "s_own", "s_pos", "s_valid", "xvalid", "route_ovf"))
    xv = rk.xvalid
    err = max(err, *(err_of(getattr(rk, k)[xv], getattr(rp, k)[xv])
                     for k in ("xrows", "xlo", "xhi")))
    need(err == 0, f"K11 route_scatter differs from its plain version "
         f"({tag})")
    fit = int(xv.sum())
    # the function's own traffic, once: every lane's hi and valid read and
    # its sorted-order words written (order, s_own, s_pos: 4 B each;
    # s_valid 1 B); each routed lane's fields and lo read, its row, lo and
    # hi written; the xvalid plane and the overflow flags written
    record("route_scatter", err,
           cuda_ms(torch, lambda _: ts.route(hi, lo, valid, fields, D, B,
                                             rk), 20),
           cuda_ms(torch, lambda _: ts.route_plain(hi, lo, valid, fields, D,
                                                   B, rp), 3),
           D * ncand * (4 + 1 + 13) + fit * (F * 4 + F * 4 + 4 + 8)
           + D * D * B + D)
    keys = torch.where(valid.view(D, ncand).bool(),
                       hi.view(D, ncand).to(torch.int64) & (D - 1), D)
    # the library yardstick: the owner order alone, one stable argsort
    lib_ms = cuda_ms(torch, lambda _: torch.argsort(keys, dim=1,
                                                    stable=True), 20)
    library["route_scatter"] = lib_ms  # the last shape's (scaled) wins

    # the owner-side insert (the engine's path), then K13 and K12
    is_new = torch.zeros(D, DB + 1, dtype=torch.bool, device=dev)
    fresh = []
    tables = c.table.clone()
    for o in range(D):
        _, is_new_c, c_idx, _, fell = fpset_insert_dedup(
            FPSet(tables[o]), rk.xlo[o].reshape(DB), rk.xhi[o].reshape(DB),
            rk.xvalid[o].reshape(DB), probe_width=(
                min(4 * chunk, DB) if g["sort_free"] else 0),
            sort_free=g["sort_free"])
        is_new[o, c_idx] = is_new_c
        fresh.append((is_new_c, c_idx,
                      min(4 * chunk, DB) if g["sort_free"] and not fell
                      else DB))
    is_new = is_new[:, :DB].contiguous()
    cum = torch.cumsum(is_new, 1)
    q_full = (c.qtail - c.qhead) + cum[:, -1] > kw["queue_capacity"]
    n_new = int(cum[:, -1].sum())
    xr, xvv = rk.xrows.view(D, DB, F), rk.xvalid.view(D, DB)
    qk, qp = c.queue.clone(), c.queue.clone()
    ts.shard_enqueue(qk, is_new, cum, c.qtail, q_full, xr, xvv)
    ts.shard_enqueue_plain(qp, is_new, cum, c.qtail, q_full, xr, xvv)
    err = err_of(qk, qp)
    need(err == 0, f"K13 shard_enqueue differs from its plain version "
         f"({tag})")
    record("shard_enqueue", err,
           cuda_ms(torch, lambda _: ts.shard_enqueue(
               qk, is_new, cum, c.qtail, q_full, xr, xvv), 20),
           cuda_ms(torch, lambda _: ts.shard_enqueue_plain(
               qp, is_new, cum, c.qtail, q_full, xr, xvv), 3),
           D * DB * 10 + n_new * 2 * F * 4 + D * 2 * F * 4)
    verd = is_new.view(D, D, B).to(torch.uint8)
    fa = action.view(D, ncand)

    def fold(fn, st):
        fn(verd, rk.s_own, rk.s_pos, rk.s_valid, rk.order, fa, npop, chunk,
           L, 22, st[0], st[1])

    def fresh_counters(_=None):
        return c.outdeg_hist.clone(), c.act_dist.clone()

    sk, sp = fresh_counters(), fresh_counters()
    fold(ts.verdict_fold, sk)
    fold(ts.verdict_fold_plain, sp)
    err = max(err_of(sk[0], sp[0]), err_of(sk[1], sp[1]))
    need(err == 0, f"K12 verdict_fold differs from its plain version "
         f"({tag})")
    got_n = int(sk[1][:, :22].sum() - c.act_dist[:, :22].sum())
    record("verdict_fold", err,
           cuda_ms(torch, lambda st: fold(ts.verdict_fold, st), 20,
                   fresh_counters),
           cuda_ms(torch, lambda st: fold(ts.verdict_fold_plain, st), 3,
                   fresh_counters),
           D * ncand * 13 + nvalid + got_n * 4 + D * (L + 2 + 23) * 16)

    # K7 on received rows: owner 0's batch, and the same rows with every
    # other fresh claimant doctored to hold identity 0 twice
    # (OnlyOneVersion fails)
    rows0 = xr[0].contiguous()
    doct = rows0.clone()
    api = cdc.offsets["api"]
    word = (1 << cdc.o_present) | (0 << cdc.o_ident)
    is_new_c, c_idx, nrows = fresh[0]
    pick = c_idx[:nrows][is_new_c[:nrows]][::2]
    need(pick.numel() > 0, f"K7 rows: owner 0 has no fresh claimant ({tag})")
    doct[pick, api] = word | (1 << cdc.o_vv)
    doct[pick, api + 1] = word
    for name, rws in (("", rows0), ("doctored", doct)):
        a = ts.deferred_check_rows(cfg, rws, is_new_c, c_idx, nrows)
        b = ts.deferred_check_rows_plain(cfg, rws, is_new_c, c_idx, nrows)
        err = max(err_of(x, y) for x, y in zip(a, b))
        need(err == 0, f"K7 received-rows variant differs ({tag} {name})")
        if name:
            need(int(a[0]) == 2, f"K7 rows: {int(a[0])} on doctored rows")
    nf = int(is_new_c[:nrows].sum())
    record("deferred_check/rows", err,
           cuda_ms(torch, lambda _: ts.deferred_check_rows(
               cfg, doct, is_new_c, c_idx, nrows), 20),
           cuda_ms(torch, lambda _: ts.deferred_check_rows_plain(
               cfg, doct, is_new_c, c_idx, nrows), 3),
           nrows * 9 + nf * F * 4 + F * 4)

    if with_ring:
        # K8's entry row (the pipelined sharded ring) on shard 0's ring
        outs = []
        for fn in (counters.ring_row, counters.ring_row_plain):
            ring, head = c.obs_ring[0].clone(), c.obs_head[0].clone()
            bo, ex = c.obs_bodies[0].clone(), c.obs_expanded[0].clone()
            fn(ring, head, bo, ex, n[0], True, c.level[0],
               c.generated[0] + 9, c.generated[0], c.distinct[0] + 7,
               c.distinct[0], c.qtail[0] - c.qhead[0], c.act_gen[0] + 5,
               c.act_dist[0], torch.cat([c.act_gen[0], c.act_dist[0]]), 22,
               entry=True)
            outs.append((ring, head, bo, ex))
        err = max(err_of(x, y) for x, y in zip(*outs))
        need(err == 0, f"K8 entry row differs from its plain version "
             f"({tag})")
        rows.setdefault("ring_row/entry", []).append(dict(
            shape=tag, max_abs_err=err, ms=None, plain_ms=None,
            bound_ms=None))
        lines.append("K8 entry row equal")
    print(f"phase 12 sharded kernels vs plain ({tag}, {D} shards, chunk "
          f"{chunk}, {sum(n)} popped, {nvalid} valid candidates, {fit} "
          f"routed, B {B}, {n_new} new): all bitwise equal; " + ", ".join(
              f"{k} {v[-1]['ms']:.4f} ms (plain {v[-1]['plain_ms']:.3f} ms, "
              f"bound {v[-1]['bound_ms']:.4f} ms)" for k, v in rows.items()
              if v[-1]["shape"] == tag and v[-1]["ms"] is not None)
          + f"; library argsort {lib_ms:.4f} ms"
          + (f"; {'; '.join(lines)}" if lines else ""), flush=True)
    del c, tables, qk, qp
    torch.cuda.empty_cache()


def phase_sharded_model1(torch, ops, card, runs):
    """Phase 12: torchtlc.entry.dryrun_multichip(8) - Model_1 on 8 shards
    at chunk 2048 (slab dedup and deferred invariants), MC.out's counts -
    then the same engine's carry against the reference's shard-table
    digest; FF at 1, 2 and 8 shards; K1's sharded variant and K7, K11-K13
    against their plain versions on a block the Model_1 run pops."""
    import numpy as np

    from torchtlc.config import MATRIX, MODEL_1
    from torchtlc.entry import dryrun_multichip

    ops.reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r = dryrun_multichip(8)
    launches = dict(ops.LAUNCHES)
    need((r.generated, r.distinct, r.depth) == M1_COUNTS,
         "dryrun_multichip counts")
    need(r.action_distinct == M1_SHARDED_DISTINCT,
         "sharded Model_1 per-action distinct")
    need(r.outdegree == M1_SHARDED_OUTDEGREE, "sharded Model_1 outdegree")
    need(r.action_generated == MC_OUT_GENERATED,
         "sharded Model_1 per-action generated")
    carry, r2, _, bodies = run_sharded(torch, ops, MODEL_1, 8, M1_SHARDED_KW)
    sha = table_sha256(carry.table)
    need(sha == M1_SHARDED_TABLE_SHA256,
         f"sharded Model_1 shard tables {sha[:16]}")
    need(r2.iterations == r.iterations, "two sharded Model_1 runs differ")
    ff = []
    for D in (1, 2, 8):
        _, rf, _, nb = run_sharded(torch, ops, MATRIX[(False, False)], D,
                                   dict(FF_KW, chunk=128))
        need((rf.generated, rf.distinct, rf.depth) == FF_COUNTS
             and rf.violation == 0, f"FF at {D} shards")
        ff.append(f"{D}: {nb} bodies {rf.wall_s:.3f} s")
    del carry
    sharded_kernel_checks(torch, ops, "model1_D8", MODEL_1, M1_SHARDED_KW, 8,
                          60, runs)
    per = _per_body(launches, r.iterations)
    print(f"phase 12 sharded Model_1: {out.getvalue().strip()}; "
          f"{r.iterations} bodies, {per:.1f} launches per body; per-action "
          f"distinct and outdegree {r.outdegree} as jaxtlc's sharded run, "
          f"shard tables sha256 {sha[:16]} = jaxtlc's; FF {FF_COUNTS} at "
          f"1/2/8 shards ({', '.join(ff)}) on {card}; launches {launches}",
          flush=True)
    return {"shard_m1": {"launches": launches, "bodies": r.iterations,
                         "per_body": per}}


def _stored_keys(torch, table):
    """The raw (unmixed) fingerprints a table stores, as sorted int64 keys
    hi << 32 | lo."""
    from torchtlc.engine.fpset import _unmix

    t = table.reshape(-1, 2).to(torch.int64) & 0xFFFFFFFF
    t = t[(t[:, 0] != 0) | (t[:, 1] != 0)]
    lo, hi = _unmix(t[:, 0], t[:, 1])
    return torch.sort((hi << 32) | lo).values


def phase_sharded_scaled(torch, ops, card, runs):
    """Phase 12b: the scaled 2x1 workload on 4 shards at 32,768 per shard
    (131,072 in all), qcap 2^20 and fp 2^24 per shard, default modes + the
    ring: the single-device counts and per-action generated counts, every
    stored fingerprint on its owner shard, the union of the shard tables
    equal to the single-device run's table set; then pipelined, and one
    unpipelined/pipelined pair in turns.  K1-sharded, K7, K8-entry and
    K11-K13 held against their plain versions at this step."""
    from torchtlc.config import scaled_config

    cfg, kw1 = scaled_config()
    single, rs, _, _ = run_engine(torch, ops, cfg, kw1, {})
    ref_keys = _stored_keys(torch, single.fps.table)
    del single
    torch.cuda.empty_cache()
    D = 4
    xbytes = D * D * (2 * SCALED_SHARDED_KW["chunk"] * 12 // D + 8) * (
        34 + 3) * 4
    out, walls = {}, {False: [], True: []}
    for pipe in (False, True, True, False):
        carry, r, launches, bodies = run_sharded(
            torch, ops, cfg, D, SCALED_SHARDED_KW, pipeline=pipe,
            obs_slots=SCALED_OBS_SLOTS)
        need((r.generated, r.distinct, r.depth) == SCALED_COUNTS,
             f"sharded scaled (pipeline={pipe}) counts "
             f"{(r.generated, r.distinct, r.depth)}")
        need(r.violation == 0 and r.queue_left == 0,
             f"sharded scaled (pipeline={pipe}) verdict")
        need(r.action_generated == rs.action_generated,
             f"sharded scaled (pipeline={pipe}) per-action generated")
        walls[pipe].append((r.wall_s, bodies, _per_body(launches, bodies)))
        key = "shard_scaled_pipe" if pipe else "shard_scaled"
        if key not in out:
            out[key] = {"launches": launches, "bodies": bodies,
                        "per_body": _per_body(launches, bodies)}
            keys = []
            for d in range(D):
                k = _stored_keys(torch, carry.table[d])
                need(bool(((k >> 32) & (D - 1) == d).all()),
                     f"a fingerprint off its owner shard {d}")
                keys.append(k)
            union = torch.sort(torch.cat(keys)).values
            need(union.shape == ref_keys.shape
                 and bool((union == ref_keys).all()),
                 "the shard tables' fingerprints differ from the "
                 "single-device table's")
        del carry
        torch.cuda.empty_cache()
    sharded_kernel_checks(torch, ops, "scaled_D4", cfg, SCALED_SHARDED_KW,
                          D, 140, runs, with_ring=True)
    print(f"phase 12b sharded scaled 2x1: {SCALED_COUNTS} on 4 shards, chunk "
          f"{SCALED_SHARDED_KW['chunk']} per shard (exchange planes "
          f"{xbytes / 2**20:.1f} MiB), default modes + ring; the single-"
          f"device run's per-action generated counts; every fingerprint on "
          f"its owner, the union of the 4 tables = the single-device table "
          f"({ref_keys.shape[0]} fingerprints), unpipelined and pipelined; "
          f"single-device default modes {rs.wall_s:.4f} s, {rs.iterations} "
          f"steps; in turns U/P/P/U (wall s, bodies, launches per body): "
          f"unpipelined {[(round(w, 4), b, round(p, 1)) for w, b, p in walls[False]]}"
          f", pipelined {[(round(w, 4), b, round(p, 1)) for w, b, p in walls[True]]}"
          f" on {card}", flush=True)
    return out


def phase_sharded_command(ops, cfg, tmp, card):
    """Phase 12c: `check MC.cfg -sharded 4` on Model_1 - clean (exit 0, the
    transcript's counts), -fpcap 16384 (table regrows through
    migrate_shard_carry), -routefactor 0.25 (VIOL_ROUTE_OVERFLOW and a
    route-factor regrow), the same pipelined (the pending verdicts folded
    by K12 on the card before the bucket width changes), -coverage (K10
    per shard: the dump's pinned digest, the journal's site vector the
    pinned one), all in this process; then -pipeline -checkpoint P
    -checkpointevery 32 -faults sigterm@3 -> exit 75, -recover -pipeline
    -> exit 0 (subprocesses)."""
    import numpy as np

    from torchtlc.config import MODEL_1
    from torchtlc.obs.coverage import coverage_from_events
    from torchtlc.obs.journal import read as read_journal
    from torchtlc.spec.coverage_device import site_table

    out, lines = {}, []
    ck_cov = os.path.join(tmp, "shard_cov.ckpt")
    route = "regrowing route_factor"
    for key, extra, grow in (
            ("shard_cmd", [], None),
            ("shard_cmd_fp", ["-fpcap", "16384"], "regrowing fp_capacity"),
            ("shard_cmd_route", ["-routefactor", "0.25"], route),
            ("shard_cmd_pipe_route", ["-pipeline", "-routefactor", "0.25"],
             route),
            ("shard_cmd_cov", ["-coverage", "-checkpoint", ck_cov], None)):
        rc, text, launches, wall = command_here(
            ops, [cfg, "-noTool", "-sharded", "4", *extra])
        need(rc == 0, f"`check -sharded 4 {' '.join(extra)}` exited {rc}")
        need(final_counts(text) == M1_COUNTS,
             f"`-sharded 4 {' '.join(extra)}` counts {final_counts(text)}")
        need("Model checking completed. No error has been found" in text,
             "the sharded command did not report success")
        grows = [x.strip() for x in text.splitlines() if "regrowing" in x]
        need(bool(grows) == bool(grow) and all(grow in x for x in grows),
             f"`-sharded 4 {' '.join(extra)}`: regrows {grows}")
        out[key] = {"launches": launches}
        note = ""
        if key == "shard_cmd_pipe_route":
            need(launches.get("verdict_fold", 0) > 0,
                 "the pipelined sharded run launched no K12")
        if key == "shard_cmd_cov":
            need(launches.get("coverage_count", 0) > 0,
                 "the sharded -coverage run launched no K10")
            dump = coverage_dump(text)
            dump_sha = hashlib.sha256("\n".join(dump).encode()).hexdigest()
            need(dump_sha == M1_COVERAGE_DUMP_SHA256,
                 f"the sharded dump's digest {dump_sha[:16]} is not the "
                 "reference's")
            folded = coverage_from_events(
                read_journal(ck_cov + ".journal.jsonl"))
            need(folded is not None, "the sharded run journaled no coverage")
            vec = np.array([folded["sites"].get(x.key, 0)
                            for x in site_table(MODEL_1)], dtype="<u4")
            sha = hashlib.sha256(vec.tobytes()).hexdigest()
            need(sha == M1_COVERAGE_SHA256,
                 f"the sharded run's site vector {sha[:16]} is not the "
                 "pinned one")
            note = (f", dump and site vector equal to the pinned ones "
                    f"({len(dump)} lines, {folded['visited']} sites)")
        label = " ".join(extra).replace(ck_cov, "P") or "clean"
        lines.append(f"{label}: exit 0, "
                     f"{len(grows)} regrows {grows[:3]}{note}, {wall:.2f} s")
    ck = os.path.join(tmp, "shard.ckpt")
    base = [cfg, "-noTool", "-sharded", "4", "-pipeline", "-checkpoint", ck,
            "-checkpointevery", "32"]
    t0 = time.time()
    rc, text = command(base + ["-faults", "sigterm@3"])
    wall_term = time.time() - t0
    need(rc == 75, f"the sharded -pipeline SIGTERM run exited {rc}, not 75")
    t0 = time.time()
    rc, text = command(base + ["-recover"])
    need(rc == 0, f"the sharded -recover -pipeline run exited {rc}")
    need(final_counts(text) == M1_COUNTS,
         f"the resumed sharded counts {final_counts(text)}")
    print(f"phase 12c command `check MC.cfg -sharded 4`: {'; '.join(lines)};"
          f" -pipeline sigterm@3 -> exit 75 ({wall_term:.2f} s), -recover "
          f"-pipeline -> exit 0, {M1_COUNTS} ({time.time() - t0:.2f} s; "
          f"subprocesses) on {card}", flush=True)
    return out


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
    library = {}  # kernel -> one PyTorch call's time at the scaled shape

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
    c = model1_level40()
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

        # K10 coverage_count on K1's valid flags of the same block
        check_coverage_kernel(torch, ops, tag, cfg, block, n, flags[0],
                              record)

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
        if tag == "scaled":
            library["fp64"] = fp64_library_ms(torch, words, nbits, lo, hi)

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
    s_block, s_level, s_level_n = scaled_full_level(s_cfg, s_kw)
    print(f"phase 2 slice-2 scaled step: the first {ck_big} rows of level "
          f"{s_level} ({s_level_n} states) of a sorted scaled run",
          flush=True)
    first_slice = set(rows)
    for tag, cfg, block, n in (
            ("model1_2048", MODEL_1, block2048,
             min(int(c.level_n), M1_2048_KW["chunk"])),
            ("scaled", s_cfg, s_block, ck_big - 3)):
        check_new_kernels(torch, ops, rng, tag, cfg, block, n, record, runs,
                          library)
        print(f"phase 2 slice-2 times ({tag}): " + ", ".join(
            f"{k} {v[-1]['ms']:.4f} ms (plain {v[-1]['plain_ms']:.3f} ms, "
            f"bound {v[-1]['bound_ms']:.4f} ms)" for k, v in rows.items()
            if v[-1]["shape"] == tag and k not in first_slice), flush=True)

    check_member(torch, ops, runs, record)
    source = {
        "coverage_count": ("torchtlc/kernels/csrc/coverage.cu",
                           "jaxtlc/spec/coverage_device.py:766"),
        "fpset_member": ("torchtlc/kernels/csrc/fpset.cu",
                         "jaxtlc/engine/fpset.py:292"),
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
        "route_scatter": ("torchtlc/kernels/csrc/route.cu",
                          "jaxtlc/engine/sharded.py:553"),
        "verdict_fold": ("torchtlc/kernels/csrc/route.cu",
                         "jaxtlc/engine/sharded.py:701"),
        "shard_enqueue": ("torchtlc/kernels/csrc/route.cu",
                          "jaxtlc/engine/sharded.py:685"),
    }
    for name, got in runs.get("sharded_rows", {}).items():
        rows.setdefault(name, []).extend(got)
    library.update(runs.get("sharded_library", {}))
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
            "library_ms": library.get(name),
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


def model1_level40():
    """A sorted Model_1 engine's carry when level 40 is next to pop (the
    frontier phase 2 takes its Model_1 step blocks from)."""
    from torchtlc.config import MODEL_1
    from torchtlc.engine import bfs

    init_fn, _, step_fn = bfs.make_engine(MODEL_1, **SORTED, **M1_KW)
    c = init_fn()
    while int(c.level) < 40:
        c = step_fn(c)
    return c


def scaled_full_level(cfg, kw):
    """(block, level, level_n): the first chunk rows of the first level of
    a sorted scaled run that fills a chunk - reachable states only (a level
    buffer's rows past its level hold the enqueue tail's padding)."""
    from torchtlc.engine import bfs

    init_fn, _, step_fn = bfs.make_engine(cfg, **SORTED, **kw)
    sc = init_fn()
    ck = kw["chunk"]
    while not (int(sc.level_n) >= ck and int(sc.qhead) == 0):
        need(int(sc.level_n) > 0, "the scaled run has no level of a chunk")
        sc = step_fn(sc)
    return (sc.queue[int(sc.parity), :ck].contiguous(), int(sc.level),
            int(sc.level_n))


def check_coverage_kernel(torch, ops, tag, cfg, block, n, valid,
                          record=None):
    """K10 coverage_count against count_plain on one popped block and K1's
    valid flags of it, word for word; timed when `record` is given (bound:
    the block, the flags and the 311 words, each moved once)."""
    from torchtlc.spec.coverage_device import count_plain

    got = ops.coverage_count(cfg, block, n, valid)
    ref = count_plain(cfg, block, n, valid)
    err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
    need(err == 0, f"K10 coverage_count differs from its plain version "
         f"({tag})")
    need(int((ref != 0).sum()) > 200, f"K10 test block is vacuous ({tag})")
    if record is not None:
        ck, W = block.shape
        record("coverage_count", tag, err,
               cuda_ms(torch, lambda _: ops.coverage_count(cfg, block, n,
                                                           valid), 20),
               cuda_ms(torch, lambda _: count_plain(cfg, block, n, valid), 2),
               ck * W * 4 + valid.numel() + 311 * 4)
    return err


def check_coverage_blocks(torch, ops):
    """The partial run's K10 check (--phases 2c): a Model_1 level-40 block
    and a full-width block of the scaled workload, untimed."""
    from torchtlc.config import MODEL_1, scaled_config
    from torchtlc.engine.backend import FLAG_VALID, expand_block

    c = model1_level40()
    s_cfg, s_kw = scaled_config()
    ck = s_kw["chunk"]
    for tag, cfg, block, n in (
            ("model1", MODEL_1, c.queue[int(c.parity), :M1_KW["chunk"]],
             int(c.level_n)),
            ("scaled", s_cfg, scaled_full_level(s_cfg, s_kw)[0], ck - 3)):
        block = block.contiguous()
        flags = expand_block(cfg, block, n)[1]
        check_coverage_kernel(torch, ops, tag, cfg, block, n,
                              flags[FLAG_VALID])
    print("phase 2c K10 coverage_count equal to count_plain at the Model_1 "
          "and scaled shapes (untimed)", flush=True)


def slab_scatter_library_ms(torch, fpset, keys, m, want):
    """K5 slab_scatter's library yardstick: one Tensor.scatter_reduce_
    (reduce="amax") of lane + 1 into the slab at the valid lanes' cells,
    with the cells and lanes computed beforehand (K5 computes the cell from
    the key inside its body); its slab must equal K5's."""
    u = keys != fpset.KEY00
    cell = fpset._slab_cell(keys, 0, m - 1)[u]
    lane1 = (torch.arange(1, keys.shape[0] + 1, device=keys.device)[u]
             .to(torch.int32))
    slab = torch.zeros(m, dtype=torch.int32, device=keys.device)
    slab.scatter_reduce_(0, cell, lane1, reduce="amax")
    need(torch.equal(slab, want), "scatter_reduce_ disagrees with K5")
    ms = cuda_ms(torch, lambda z: z.scatter_reduce_(0, cell, lane1,
                                                   reduce="amax"), 10,
                 lambda: torch.zeros(m, dtype=torch.int32,
                                     device=keys.device))
    print(f"phase 2 K5 library yardstick: scatter_reduce_ amax of "
          f"{cell.shape[0]} lanes into {m} cells {ms:.4f} ms (slab equal to "
          "K5's)", flush=True)
    return ms


def fp64_library_ms(torch, words, nbits, lo, hi):
    """K2's library yardstick: the reference's own form of the fingerprint
    (jaxtlc/engine/fingerprint.py:241 fp64_words_mxu) - the unpacked bit
    matrix [N, nbits] times the basis bits [nbits, 64], one torch.matmul
    in float32 (TF32 off: the sums are exact) - timed at K2's shape; its
    parity xor const must equal K2's words."""
    import numpy as np

    from torchtlc.engine.fingerprint import affine_basis

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        const, basis = affine_basis(nbits)
        shifts = torch.arange(32, device=words.device)
        bb = ((torch.from_numpy(basis.astype(np.int64)).to(words.device)[
            :, :, None] >> shifts) & 1).reshape(nbits, 64).float()
        w = words.to(torch.int64) & 0xFFFFFFFF
        bits = ((w[:, :, None] >> shifts) & 1).reshape(w.shape[0], -1)[
            :, :nbits].float().contiguous()
        par = torch.matmul(bits, bb).to(torch.int64) & 1
        lo_m = ((par[:, :32] << shifts).sum(1) ^ int(const[0])) & 0xFFFFFFFF
        hi_m = ((par[:, 32:] << shifts).sum(1) ^ int(const[1])) & 0xFFFFFFFF
        need(bool((lo_m == (lo.to(torch.int64) & 0xFFFFFFFF)).all())
             and bool((hi_m == (hi.to(torch.int64) & 0xFFFFFFFF)).all()),
             "the matmul form of K2 disagrees with K2")
        ms = cuda_ms(torch, lambda _: torch.matmul(bits, bb), 20)
        bits16, bb16 = bits.to(torch.bfloat16), bb.to(torch.bfloat16)
        ms16 = cuda_ms(torch, lambda _: torch.matmul(bits16, bb16), 20)
        print(f"phase 2 K2 library yardstick: torch.matmul [{bits.shape[0]}, "
              f"{nbits}] x [{nbits}, 64] float32 {ms:.4f} ms (parity equal to "
              f"K2's words); bfloat16 {ms16:.4f} ms", flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return ms


def check_member(torch, ops, runs, record):
    """K9 fpset_member against its plain version, word for word, on two
    tables: the Model_1 table (load 0.62) at the Model_1 step width with
    max_rounds 0 and 4, and a table filled to the 0.85 highwater - the
    spill's operating point - at the scaled spill width (98,304 lanes),
    where lanes walk the longest bucket runs.  The queries mix stored
    fingerprints (recovered from the table words), absent random keys,
    the (0, 0) and (1, 0) pair of the remap class, and masked-off lanes.
    The byte bound counts the rows the plain walk reads."""
    import numpy as np

    from torchtlc.engine import fpset

    rng = np.random.default_rng(SEED + 9)
    dev = torch.device("cuda")

    def queries(table, n):
        t = table.cpu().numpy().view(np.uint32).reshape(-1, 2)
        occ = t[(t[:, 0] != 0) | (t[:, 1] != 0)]
        pick = occ[rng.integers(0, len(occ), n // 2)]
        raw_lo, raw_hi = fpset.unmix_host(pick[:, 0], pick[:, 1])
        lo = np.concatenate([raw_lo, rng.integers(0, 2**32, n - n // 2,
                                                  dtype=np.uint64)])
        hi = np.concatenate([raw_hi, rng.integers(0, 2**32, n - n // 2,
                                                  dtype=np.uint64)])
        lo, hi = lo.astype(np.uint32), hi.astype(np.uint32)
        # the remap class: the raw words whose mix is (0, 0) or (1, 0)
        lo[:2], hi[:2] = fpset.unmix_host(np.array([0, 1], np.uint32),
                                          np.array([0, 0], np.uint32))
        perm = rng.permutation(n)
        mask = rng.random(n) < 0.9
        return [torch.from_numpy(np.ascontiguousarray(x[perm]).view(np.int32)
                                 ).to(dev) for x in (lo, hi)] + [
            torch.from_numpy(mask).to(dev)]

    # a 2^22-slot table filled to 0.85 by seeded spill-width batches
    hw = torch.zeros((1 << 22) // 8, 16, dtype=torch.int32, device=dev)
    target = int(0.85 * (1 << 22))
    while int(fpset.fpset_count(fpset.FPSet(hw))) < target:
        left = target - int(fpset.fpset_count(fpset.FPSet(hw)))
        n = min(SPILL_N, left)
        b = [torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64)
                              .astype(np.uint32).view(np.int32)).to(dev)
             for _ in range(2)]
        fpset.fpset_insert_sorted(fpset.FPSet(hw), b[0], b[1],
                                  torch.ones(n, dtype=torch.bool, device=dev),
                                  probe_width=16384, claim_width=16384)
    load = int(fpset.fpset_count(fpset.FPSet(hw))) / (1 << 22)
    m1 = model1_table(torch, ops, runs)
    lines = []
    for tag, table, n, rounds in (("model1", m1, 1024 * 12, (0, 4)),
                                  ("scaled", hw, SPILL_N, (0, 4))):
        lo, hi, mask = queries(table, n)
        for mr in rounds:
            got = fpset.fpset_member(fpset.FPSet(table), lo, hi, mask, mr)
            ref, rows_read = fpset.fpset_member_plain(table, lo, hi, mask,
                                                      mr, count_rows=True)
            err = int((got != ref).sum())
            need(err == 0, f"K9 fpset_member differs from its plain version "
                 f"({tag}, max_rounds {mr}: {err} lanes)")
            ms = cuda_ms(torch, lambda _: fpset.fpset_member(
                fpset.FPSet(table), lo, hi, mask, mr), 20)
            pms = cuda_ms(torch, lambda _: fpset.fpset_member_plain(
                table, lo, hi, mask, mr), 3)
            name = "fpset_member" if mr == 4 else "fpset_member/rounds0"
            record(name, tag, err, ms, pms, n * (4 + 4 + 1) + n
                   + 64 * rows_read)
            lines.append(f"{tag} max_rounds {mr}: {int(got.sum())} of {n} "
                         f"found, {rows_read} rows read, {ms:.4f} ms (plain "
                         f"{pms:.3f} ms, bound "
                         f"{(n * 10 + 64 * rows_read) / HBM_BYTES_PER_S * 1e3:.4f}"
                         f" ms)")
    print(f"phase 2 K9 fpset_member vs plain (Model_1 table load "
          f"{int(fpset.fpset_count(fpset.FPSet(m1))) / m1.numel() * 2:.3f}; "
          f"highwater table 2^22 slots at load {load:.3f}): all bitwise "
          f"equal; " + "; ".join(lines), flush=True)


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


def check_new_kernels(torch, ops, rng, tag, cfg, block, n, record, runs,
                      library):
    """K1's deferred variant, K5 slab, K6 slab order, K3's masked probe,
    K7 deferred_check and K8 ring_row, each against its plain version on
    the same inputs at this step shape; the slab with its default geometry,
    with slab_bits=3 (collisions everywhere) and on an all-distinct burst
    (the sorted fallback).  Also times the library sort of the sorted
    dedup at this shape and, at the scaled shape, K5's library call
    (library["slab_scatter"])."""
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
        if name == "default" and tag == "scaled":
            library["slab_scatter"] = slab_scatter_library_ms(
                torch, fpset, keys, m, k[0])
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
    # spill: the spill_hits counter after and before the body (COL_SPILL)
    spill = (torch.full((), 123457, dtype=torch.int64, device=dev),
             torch.full((), 123400, dtype=torch.int64, device=dev))
    # coverage: the 311 site counters after and before the body, one of
    # them 3 below 2^32 so that its uint32 view wraps
    cov_old = torch.arange(311, dtype=torch.int64, device=dev) * 1000
    cov_old[57] = top
    cov_pair = (cov_old + 5, cov_old)
    for name, wrap, sp, cv in (("", False, (None, None), (None, None)),
                               ("/wrap", True, (None, None), (None, None)),
                               ("/spill", False, spill, (None, None)),
                               ("/coverage", False, (None, None), cov_pair)):
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
               n_labels, *sp, *cv)
            outs.append((ring, head, bodies, exp_))
        err = max(err_of(a, b) for a, b in zip(*outs))
        need(err == 0, f"K8 ring_row differs from its plain version ({tag}"
             f"{name})")
        if wrap or cv[0] is not None:
            need(int(outs[0][0][int(carry.obs_head) % SCALED_OBS_SLOTS,
                                counters.COL_OVERFLOW]) == 1,
                 f"K8 missed a uint32 wrap ({tag}{name})")
        if sp[0] is not None:
            need(int(outs[0][0][int(carry.obs_head) % SCALED_OBS_SLOTS,
                                counters.COL_SPILL]) == 123457,
                 "K8 did not write spill_hits into COL_SPILL")

        def ring_args(fn):
            def run(st):
                fn(st[0], st[1], st[2], st[3], ck, True, carry.level,
                   carry.generated, carry.generated, carry.distinct,
                   carry.distinct, carry.level_n, carry.act_gen,
                   carry.act_dist, torch.cat([carry.act_gen,
                                              carry.act_dist]), n_labels,
                   *sp, *cv)
            return run

        def ring_setup():
            return (carry.obs_ring.clone(), carry.obs_head.clone(),
                    carry.obs_bodies.clone(), carry.obs_expanded.clone())

        slots1, cols = carry.obs_ring.shape
        record("ring_row" + name, tag, err,
               cuda_ms(torch, ring_args(counters.ring_row), 10, ring_setup),
               cuda_ms(torch, ring_args(counters.ring_row_plain), 3,
                       ring_setup),
               (slots1 * 4 + 4 * (n_labels + 1) * 8 + cols * 4 + 10 * 8
                + (311 * 16 if cv[0] is not None else 0)))
    print(f"phase 2 slice-2 kernels vs plain ({tag}, chunk {ck}, {n} popped, "
          f"{ncand} candidates, R {R}): all bitwise equal; "
          + "; ".join(lines) + f"; library sort {lib_ms}", flush=True)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
