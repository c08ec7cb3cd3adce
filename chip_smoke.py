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
Model_1, after a failed allocation and through several flushes (8, 8b),
SIGTERM -> exit 75 -> -recover
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
exit 75 -> -recover (12c) - and through its host spill tier, a denied
regrow and -spill (12d); then temporal properties behind kernels K14-K16:
``check MC.cfg`` with PROPERTY ReconcileCompletes and CleansUpProperly on
Model_1 (the host path, exit 13, the reference's lasso digest; 13),
Model_1 on the device path against the host graph and the reference's
lassos (13b), scaled 2x1 on the device path at full width with
oracle-replayed lassos (13c) and its fixpoints again on 4 shards (13d);
K16 is also swept to a fixpoint where states die (a seeded random H), on
one slice and on 4, against its plain version; then struct specs through
the structural frontend behind kernels K17 and K18: ``check_struct`` on
TwoPhase Model_1, Model_sym and RaftReplication Model_1 in both mode sets,
pinned to the reference's CPU runs, with K17 and K18 held against their
plain versions on popped blocks, one of them violating an invariant (14),
the real-size TwoPhase with RM of 8 at chunk 16,384 - 1,745,408 distinct
states, its wall, busy share and K17's time (14b) - and ``check MC.cfg``
on struct specs: transcripts equal to the reference's, auto-regrow,
SIGTERM -> exit 75 -> -recover at the real size (14c); then generic-subset
specs through the generic frontend behind kernels K19 and K20: the gen
engine on RaftElection, Reconciler and ServiceMesh pinned to the
reference's CPU runs, K19 and K20 held against their plain versions on
popped blocks, one of them failing an invariant (15), Reconciler with 5
controllers and MaxGen 4 at chunk 16,384 - 2,881,185 distinct states, its
wall, busy share, K19's time and K20's on every enumerated state (15b) -
and ``check MC.cfg`` on generic specs: the three shipped models and an
invariant violation with transcripts equal to the reference's, and
Reconciler-5 with its five Converges properties on the device liveness
path (15c); then the sharded engine over the emitted backends behind
kernel K21 (and K18 on received rows): the six shipped struct and generic
models on 4 shards (1 too for the generic ones) in the default modes,
pipelined and deferred, against the reference's counts and the single-
device table set, K21 and K18 bitwise against their plain versions on a
popped 4-shard block of each (16), TwoPhase-8 and Reconciler-5 on 4
shards at 4,096 rows a shard, timed in turns against the single-device
runs, with the device busy share and K21/K18 on a full-width block (16b),
and the commands - gen -sharded 4, -checkpoint with sigterm@3 then
-recover, unpipelined and pipelined, -sharded 4 -pipeline, -pipeline
alone, struct -sharded 4 and its table regrow, Reconciler-5's Converges
properties under -sharded 4 - against the reference's pinned transcripts
(16c); then the device coverage plane of struct specs behind kernel K22:
the three shipped struct models with coverage in both mode sets, the
site vector pinned to the reference's, K22 bitwise against its plain
version on a popped block of each (17), TwoPhase-8 with and without
coverage in turns, K22 beside K17 on a full-width block and on 4 shards
(17b), TwoPhase-8 pipelined against unpipelined in turns and spilling at a
2^20-slot table (17c), and the commands - the denied-regrow TwoPhase run
(the spill rung) on one device and on -sharded 4, -coverage with the
device dump, -pipeline through SIGTERM and -recover, pinned to the
reference's transcripts, and -phase-timing on TwoPhase-8 and Model_1
(17d); then struct -narrow behind kernel K23 (the runtime certificate,
inside K17 and K18): the three shipped struct models narrowed in both mode
sets, pinned to the reference's narrowed CPU runs, K17's kCert form, K18
with the certificate and K23 bitwise against their plain versions and K23
on doctored blocks (18), RaftReplication with five nodes narrowed (2
packed words) and not (3) in turns at chunk 16,384 - 1,205,891 distinct
states - with K17 with and without kCert and K23 alone on a full-width
block, and TwoPhase-8 with and without -narrow (18b), and the commands:
-narrow with the preflight's bound findings, -coverage, -pipeline,
-sharded 4, SIGTERM and -recover -narrow (and its refusal without
-narrow), the spill rung, the cardinality lie (exit 1), -narrow ignored on
Reconciler and the KubeAPI pair, and -traceExpressions on a KubeAPI and a
struct violation (18c); then -symmetry and -por behind kernels K24 (orbit
canonicalization, inside K17 and K21), K25 (the runtime orbit
certificate, once a body) and K26 (singleton ample sets, inside K17 and
K21): TwoPhase Model_sym, RaftReplication Model_1, TwoPhase with RM of 4
and the two-counter POR spec reduced in both mode sets (Model_sym also
pipelined and on 4 shards, RaftReplication also narrowed), pinned to the
reference's CPU runs, K17 with K24 / K26, K24, K25 and K26 bitwise
against their plain versions, the lying plan tripping K25 and COL_SYM
(19); RaftReplication with four servers (MaxTerm 7) reduced and not in
turns at chunk 16,384 - 172,222 against 3,564,961 distinct states - with
K17 with and without K24 on a 589,824-candidate block, K24, K25 and K26
alone (19b); and the commands: Model_sym with and without -symmetry, -por,
SymV's exit-12 trace with and without -symmetry, SIGTERM and -recover
-symmetry (and its refusal without the flag), the spill rung, -sharded 4,
-phase-timing, the lie (exit 1), the flags ignored on Reconciler and the
KubeAPI pair, and RaftReplication with four servers (19c); then -simulate
behind kernels K27 (the walk's round, one thread a walker) and K28 (its
fold, one block): the CPU tests' walks and TwoPhase Model_sym on the card,
each final carry pinned to the reference's CPU run, K27 (kInit, step,
packed rows) and K28 bitwise against their plain versions mid-walk, one
round violating and one deadlocking (20); RaftReplication with five
servers and MaxTerm 6 at 65,536 walkers to depth 100 - the reference's
counts, the wall, transitions per second, the busy share, K27 and K28 a
round (20b); and the commands: that walk, SimViol's exit-12 trace,
five servers' deadlock, SIGTERM and -recover, a lasso (20c); then -infer
behind kernels K29 (the predicates x states filter, one thread a row; its
matrix and fold forms) and K30 (the certify pass, one thread a row): the
CPU tests' engines on the card - TwoPhase (32), RaftElection (64 and its
whole pool of 1,446), RaftReplication (64 and 157) - each report pinned
to the reference's CPU run, K29 and K30 bitwise against their plain
versions on each exact evidence set (21); RR5T6 with its whole pool of 419
on sampled evidence at 65,536 walkers to depth 100 - the reference's
report, the walls of the build, walk, filter and certify, predicate
evaluations a second, the busy share, K29 and K30 over the union of the
sampled rounds (21b); and the commands: TwoPhase, RaftElection's whole
pool, that walk, a refuted cfg invariant (exit 12) and the refusals
(21c); then the native disk tier (-fpset DiskFPSet, engine.hybrid) on K1's
sharded variant at D = 1 and K2: FF, Model_1 and Model_1 on 4 partitions
with every result and the store and queue files pinned to the reference's
CPU run, a checkpointed Model_1 stopped and resumed to the same digests,
K1 and K2 bitwise against their plain versions on a Model_1 block (22);
the scaled 2x1 workload through the disk tier at chunk 131,072 - the
free space, the wall, distinct states a second, the wall's split and the
busy share (22b); and the commands: -fpset DiskFPSet alone, with
-sharded 4 -checkpoint then -recover, -sharded 16, -sharded 3 and -infer
-fpset DiskFPSet (exit 1) (22c); then the artifact cache behind kernel K31
(the invariant re-check, one thread a stored row): the CPU tests' cases on
ArtTiny through the command - a verdict hit with no launch and no nvcc,
an invariant-only edit and a seeded violation through K31, corrupt
artifacts, -recheck - and K31 bitwise against its plain version on the
reachable sets of TwoPhase and RaftReplication with seeded rows (23);
TwoPhase with RM of 8 in a temporary store - the inversion, write and
read seconds, the artifacts' bytes, the verdict hit's wall, K31 over
1,745,408 stored rows, the seeded violation against the full run - and
RaftReplication with five nodes narrowed through the reach tier and
un-narrowed through the verdict tier only (23b); and the commands on
TwoPhase: -artifact-cache DIR, -recheck, -no-artifact-cache, -infer with
artifact evidence and -simulate's bypass event (23c); then the serving
plane behind kernels K32 (the batched expand, rows x lanes), K33 (the
fingerprint insert over stacked tables), K34 (the batched walk round,
lane x walker) and K35 (its fold, one block a lane): TwoPhaseB with MAXR
over [0, 2] in one dispatch, each lane's counts and table words pinned to
the reference's CPU run and equal to its sequential run, K32-K35 against
their plain versions (24); RaftReplication with four servers over MaxTerm
[4, 7] in one dispatch at chunk 16,384 - the MaxTerm 7 lane's full-run
counts, every lane bit-equal to its sequential run and count-equal to its
baked-constant check, the walls in turns, the busy share, K32 and K33 at
full width (24b); RR5T6's seeds 7-10 at 65,536 walkers in one dispatch,
each lane equal to its single-lane walk, a seeds x configs batch, K34 and
K35 a round (24c); and the service on the card - sweep, smoke, pooled,
infer, supervised and cached jobs, warm resubmits with no build and no
load, SSE, /metrics, priority preemption resumed through -recover, a
running deadline, a cancel, a 429 - and `check -trace-out` / `-serve` on
TwoPhase (pinned) and Model_1 (24d); then pods behind kernels K36 (the
exchange's send buffer), K37 (the owner planes of the received buffer) and
K38 (the gathered statistic and fence rows): `python -m torchtlc.dist
--spawn 2 --devices-per-host 2` on this card over gloo - Model_1 with
MC.out's counts and the in-process 4-shard engine's table words, K36-K38
against their plain versions, K36's and K37's buffers through a one-rank
NCCL group (25); the drills - SIGTERM through the launcher, resume, a
refused width and --reshard, a table too small and the spill lifeboat -
and FF with the counter ring and coverage folded from both journals
(25b); scaled 2x1 on the 2 x 2 pod through init_pod / run_pod against the
single-device fingerprint set, its wall in turns with the in-process
4-shard engine and the collectives' share of it (25c); then the walk over
the KubeAPI backend behind kernels K39 (kube_sim_step, one thread a
walker) and K40 (kube_sim_fold, one block) and over the generic backend
behind K27 / K28 built from each spec's walk text (gen_sim.cuh): FF,
Model_1, RaftElection, Reconciler and ServiceMesh at 4,096 walkers to
depth 64, seeds 0 and 7, each final carry pinned to the reference's CPU
run, the kernels bitwise against their plain versions on the kInit form
and round by round, FF under delete_noop (the assertion) and the
NeverObserves edit (an invariant) pinned and re-walked by replay_lane on
the card (26); the scaled 2x1 model and Model_1 at 65,536 walkers to depth
256 and Reconciler-5 to depth 100 - the reference's counts, walls,
transitions per second, the busy share, the kernels a round (26b); and
the port's bench_sim price sheet, Model_1's walk against its BFS (26c).
It checks every result against its pinned value, holds each kernel
bitwise against its plain torch version on the card, and prints:

* one line per phase;
* a line with the card's name and power limit (nvidia-smi);
* a JSON line {"kernels": [...]} with each kernel's launches on the main
  paths (the two Model_1 and the two scaled engine runs, the in-process
  command, regrow, spill and violation runs, the three covered engine
  runs, the four pipelined engine runs and the pipelined regrow, the
  sharded command runs, the sharded spill runs, the liveness runs, the
  struct engine and command runs of phases 14-14c, the gen engine and
  command runs of phases 15-15c, the sharded emitted runs and commands
  of phases 16-16c, the covered, pipelined, spilling and command runs
  of phases 17-17d, the narrowed engine and command runs of phases
  18-18c, the reduced engine and command runs of phases 19-19c, the
  walks and commands of phases 20-20c, the inference runs and
  commands of phases 21-21c, the disk-tier runs and commands of phases
  22-22c, the artifact-cache commands of phases 23-23c and the batched
  sweeps, walks, jobs and commands of phases 24-24d, worker 0 of the
  pods of phases 25 and 25c, and the walks of phases 26 and 26b;
  each path's counts are reset just before it and read just after),
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
the pipelined slice alone, ``--phases 12,12b,12c`` the sharded one,
``--phases 12d,13,13b,13c`` the sharded spill and liveness slice,
``--phases 14,14b,14c`` the struct slice, ``--phases 15,15b,15c`` the
generic slice, ``--phases 16,16b,16c`` the sharded engine over the
emitted backends, ``--phases 17,17b,17c,17d`` the struct coverage,
pipeline, spill and phase-timing slice, ``--phases 18,18b,18c`` the
struct -narrow slice, ``--phases 19,19b,19c`` the -symmetry / -por slice,
``--phases 20,20b,20c`` the -simulate slice, ``--phases 21,21b,21c`` the
-infer slice, ``--phases 22,22b,22c`` the disk tier, ``--phases
23,23b,23c`` the artifact cache, ``--phases 24,24b,24c,24d`` the serving
plane (constants-class sweeps and smoke batches in one dispatch, kernels
K32-K35; the service; -serve and -trace-out), ``--phases 25,25b,25c``
the pods (kernels K36-K38), ``--phases 26,26b,26c`` the walks over
KubeAPI and generic specs (kernels K39, K40 and the generic K27 / K28).
Every run but those of phases 23-23c and 24d's cached job has the
artifact cache off (TORCHTLC_ARTIFACT_CACHE=off); those use temporary
stores.  The full run builds the emitted libraries of phases 16-21, 23b,
24 and 26 in a second process (``--prebuild DIR``, two nvcc at a time, at
the lowest priority) while phases 2-18 run, and waits for it before phase
19; those phases' build lines then time finding and loading them, and the
background build's own lines are printed at the wait.
"""

from __future__ import annotations

import atexit
import contextlib
import hashlib
import io
import json
import os
import shutil
import signal
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
# K9's lanes at a scaled spill step (chunk 8192)
SPILL_N = 8192 * 12

# temporal properties: the two KubeAPI properties (KubeAPI.tla:798-808);
# the SHA-256 of the verdict and lasso lines (liveness_text) of `python -m
# jaxtlc.cli check MC.cfg -noTool` on the Model_1 pair with both PROPERTY
# lines in MC.cfg (the reference's host path on the CPU; exit 13)
LIVE_PROPS = ["ReconcileCompletes", "CleansUpProperly"]
M1_LIVENESS_SHA256 = ("d1860e2d0ac11d3da42d8ad33ab2b667"
                      "38b59acca798ec8d4d2e59c3cbf4912b")
# lasso_digest of jaxtlc.live.check.check_properties_device(MODEL_1,
# LIVE_PROPS) on the CPU (the reference's device path; both violated,
# lassos of 10 + 15 and 42 + 5 states)
M1_DEVICE_LASSO_SHA256 = ("b2370440012e6979f2eaf0a1532a643a"
                          "68d72eb1217f3249c2481d51ec3eedbd")
# the scaled 2x1 capture: 65,536 states a sweep (786,432 lanes), the
# 19,359,985 states in a 2^25-row array and a 2^25-slot table
SCALED_LIVE_KW = dict(chunk=1 << 16, state_capacity=1 << 25,
                      fp_capacity=1 << 25)

# phases 14-14c: struct specs.  STRUCT_PINS are jaxtlc.struct.engine.
# check_struct(model, check_deadlock=False, capture_fps=True) on the CPU at
# phase 14's geometries - counts, per-action counts, outdegree and the
# SHA-256 of the final table words (little-endian uint32) - the same in the
# sorted immediate modes and in the slab deferred modes with obs_slots=64
STRUCT_PINS = {
    "TwoPhase/Model_1": dict(
        counts=[114, 56, 8], outdegree=[1, 0, 5, 3],
        act_gen={"CallOff": 16, "Collect": 16, "Decide": 1, "ObeyAbort": 36,
                 "ObeyCommit": 4, "Renege": 20, "Vote": 20},
        act_dist={"CallOff": 16, "Collect": 5, "Decide": 1, "ObeyAbort": 20,
                  "ObeyCommit": 3, "Renege": 5, "Vote": 5},
        sha=("340d063eaf4282e4958e56ef13d5fc53"
             "d7eb72b925b039d6fd01437985cdaf00")),
    "TwoPhase/Model_sym": dict(
        counts=[810, 288, 11], outdegree=[1, 0, 7, 3],
        act_gen={"CallOff": 64, "Collect": 96, "Decide": 1, "ObeyAbort": 324,
                 "ObeyCommit": 12, "Renege": 156, "Vote": 156},
        act_dist={"CallOff": 64, "Collect": 21, "Decide": 1, "ObeyAbort": 152,
                  "ObeyCommit": 7, "Renege": 21, "Vote": 21},
        sha=("0f19f2ff994bbca770a401de97252263"
             "18570ca886c568acda73692b3eb036a1")),
    "RaftReplication/Model_1": dict(
        counts=[17431, 7279, 14], outdegree=[1, 0, 6, 3],
        act_gen={"AdvanceCommit": 3078, "ClientRequest": 1185, "Elect": 3321,
                 "LearnCommit": 3030, "Replicate": 6816},
        act_dist={"AdvanceCommit": 1179, "ClientRequest": 1185, "Elect": 2230,
                  "LearnCommit": 1395, "Replicate": 1289},
        sha=("dd8de4ae707a1fc77721763c6a08e873"
             "3ae0edcf4053544f1f5b97d94a066870")),
}
RAFT_COUNTS = (17431, 7279, 14)
# TwoPhase with RM of 8: the reference's counts, and the table words of its
# CPU run at TP8_KW in the default modes (slab dedup, deferred invariants)
TP8_CFG = """CONSTANT RM = {r1, r2, r3, r4, r5, r6, r7, r8}
SPECIFICATION
Spec
INVARIANT
TypeOK
Agreement
CommitVoted
"""
TP8_KW = dict(chunk=1 << 14, queue_capacity=1 << 20, fp_capacity=1 << 22)
TP8_COUNTS = (11788290, 1745408, 26)
TP8_TABLE_SHA256 = ("09b38acd39fd7df0e187db218c38297b"
                    "0d703f92ca041da72c9da8aec6dc4f89")
# SHA-256 of the masked -noTool transcripts (struct_masked) of `python -m
# jaxtlc.cli check MC.cfg -noTool -workers cpu -no-artifact-cache` (the
# default preflight on: each prints the unreduced-symmetry warning):
# TwoPhase Model_1 (deadlock), with -nodeadlock (clean), and the
# stale-leader RaftReplication with -nodeadlock -chunk 256
STRUCT_TRANSCRIPT_SHA256 = {
    "deadlock": ("0bb79f45c02f993ec7b7e2f58aace7e3"
                 "2b969172bf1ea503b458c594d3651d84"),
    "clean": ("eefe00acd60e917601998f0e625a8637"
              "8650aa48a6267d7d7a0f1582f85ba49a"),
    "stale": ("c835d93314ccfdcf4c33f7fbc040d2c0"
              "63843a3334698f2700d602ac0ab816c0"),
}

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
    # every run answers from its engines: the artifact cache is off except
    # where phases 23-23c point a run at a temporary store
    os.environ["TORCHTLC_ARTIFACT_CACHE"] = "off"
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
    t_start = t0 = time.time()
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
    redesigned = {}
    for stem, names in (("expand", ("expand_kernel",)),
                        ("fpset", ("walk_kernel",)),
                        ("fpset_batched", ("bwalk_kernel",))):
        redesigned.update(ptxas_entries(info.logs.get(stem, ""), names))
    print(f"phase 1 ptxas of K1 and the straggler walks (K3, K33): "
          f"{redesigned}", flush=True)

    only = None
    if "--phases" in sys.argv:
        only = set(sys.argv[sys.argv.index("--phases") + 1].split(","))

    def want(phase):
        return only is None or phase in only

    runs = {}
    # the full run builds the emitted libraries of phases 16-21, 23b, 24
    # and 26 in a second process while phases 2-18 run
    prebuild = start_prebuild() if only is None else None
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
            runs["spill_flushes"] = phase_spill_flushes(torch, ops, card)
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
        if want("12d"):
            runs.update(phase_sharded_spill(ops, model, tmp, card))
        if want("13"):
            runs.update(phase_liveness_command(ops, tmp, card))
        if want("14") or want("14b") or want("14c"):
            runs.update(phase_struct(torch, ops, card, runs, tmp))
        if want("14b"):
            runs.update(phase_struct_real(torch, ops, card, runs))
        if want("14c"):
            runs.update(phase_struct_command(ops, card, runs, tmp))
        if want("15") or want("15b") or want("15c"):
            runs.update(phase_gen(torch, ops, card, runs, tmp))
        if want("15b"):
            runs.update(phase_gen_real(torch, ops, card, runs))
        if want("15c"):
            runs.update(phase_gen_command(ops, card, runs, tmp))
        if want("16") or want("16b") or want("16c"):
            runs.update(phase_shard16(torch, ops, card, runs, tmp))
        if want("16b"):
            runs.update(phase_shard16_real(torch, ops, card, runs))
        if want("16c"):
            runs.update(phase_shard16_command(ops, card, runs, tmp))
        if want("17") or want("17b") or want("17c"):
            runs.update(phase_cov17(torch, ops, card, runs, tmp))
        if want("17b"):
            runs.update(phase_cov17_real(torch, ops, card, runs))
        if want("17c"):
            runs.update(phase_struct17c(torch, ops, card, runs))
        if want("17d"):
            runs.update(phase_command17(ops, card, runs, tmp, model))
        if want("18") or want("18b"):
            runs.update(phase_narrow18(torch, ops, card, runs, tmp))
        if want("18b"):
            runs.update(phase_narrow18_real(torch, ops, card, runs))
        if want("18c"):
            runs.update(phase_command18(ops, card, runs, tmp))
        if prebuild is not None:
            wait_prebuild(*prebuild)
        if want("19") or want("19b"):
            runs.update(phase_reduce19(torch, ops, card, runs, tmp))
        if want("19b"):
            runs.update(phase_reduce19_real(torch, ops, card, runs))
        if want("19c"):
            runs.update(phase_command19(ops, card, runs, tmp))
        if want("20") or want("20b"):
            runs.update(phase_sim20(torch, ops, card, runs, tmp))
        if want("20b"):
            runs.update(phase_sim20_real(torch, ops, card, runs))
        if want("20c"):
            runs.update(phase_command20(ops, card, runs, tmp))
        if want("21") or want("21b"):
            runs.update(phase_infer21(torch, ops, card, runs, tmp))
        if want("21b"):
            runs.update(phase_infer21_real(torch, ops, card, runs))
        if want("21c"):
            runs.update(phase_command21(ops, card, runs, tmp))
        if want("22"):
            runs.update(phase_hybrid22(torch, ops, card, runs, tmp))
        if want("22b"):
            runs.update(phase_hybrid22_real(torch, ops, card, runs, tmp))
        if want("22c"):
            runs.update(phase_command22(ops, card, runs, tmp))
        if want("23") or want("23b"):
            runs.update(phase_art23(torch, ops, card, runs, tmp))
        if want("23b"):
            runs.update(phase_art23_real(torch, ops, card, runs, tmp))
        if want("23c"):
            runs.update(phase_command23(ops, card, runs, tmp))
        if want("24") or want("24b") or want("24c") or want("24d"):
            runs.update(phase_sweep24(torch, ops, card, runs, tmp))
        if want("24b"):
            runs.update(phase_sweep24_real(torch, ops, card, runs, tmp))
        if want("24c"):
            runs.update(phase_smoke24_real(torch, ops, card, runs, tmp))
        if want("24d"):
            runs.update(phase_service24(torch, ops, card, runs, tmp, model))
        if want("25"):
            runs.update(phase_pod25(torch, ops, card, runs, tmp))
        if want("25b") or want("25c"):
            runs.update(phase_pod25bc(torch, ops, card, runs, tmp,
                                      want("25b"), want("25c")))
        if want("26"):
            runs.update(phase_sim26(torch, ops, card, runs, tmp))
        if want("26b"):
            runs.update(phase_sim26_real(torch, ops, card, runs, tmp))
        if want("26c"):
            runs.update(phase_bench26(torch, ops, card, runs))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if want("13b"):
        runs.update(phase_liveness_model1(torch, ops, card, runs))
    if want("13c"):
        runs.update(phase_liveness_scaled(torch, ops, card, runs))
    if only is not None and "2" in only:
        check_member(torch, ops, runs, lambda *a: None)
    if only is not None:
        print(f"chip_smoke: {time.time() - t_start:.1f} s in all",
              flush=True)
        print(f"chip_smoke: phases {sorted(only)} passed (a partial run "
              "prints no contract lines)", flush=True)
        return 0
    main = ("m1", "m1_auto", "scaled", "scaled_auto", "cmd", "regrow",
            "spill_m1", "spill_flushes", "viol_cmd", "cov_m1", "cov_m1_auto",
            "cov_scaled", "pipe_m1", "pipe_m1_auto", "pipe_scaled",
            "pipe_scaled_65536", "pipe_regrow", "shard_m1", "shard_scaled",
            "shard_scaled_pipe", "shard_cmd", "shard_cmd_fp",
            "shard_cmd_route", "shard_cmd_pipe_route", "shard_cmd_cov",
            "shard_spill", "shard_spill_first", "live_cmd", "live_m1",
            "live_scaled", "live_scaled_4") + tuple(
                f"struct_{name}_{mode}" for name, _, _ in
                _struct_geometries() for mode in ("sorted", "slab")) + (
                "struct_tp8", "struct_cmd_deadlock", "struct_cmd_clean",
                "struct_cmd_stale", "struct_cmd_regrow") + tuple(
                    f"gen_{name}" for name in GEN_NAMES) + (
                "gen_r5",) + tuple(
                    f"gen_cmd_{tag}" for tag in GEN_NAMES + ("never", "r5")
                ) + tuple(k for k, v in runs.items()
                          if k.startswith(("shard16", "p17", "p18", "p19",
                                           "p20", "p21", "p22", "p23",
                                           "p24", "p25", "p26"))
                          and isinstance(v, dict) and "launches" in v)
    launches = {k: sum(runs[r]["launches"][k] for r in main)
                for k in ops.KERNELS}
    kernels = phase_kernels(torch, ops, runs, launches)
    print(f"phase 6 launches on the main paths ({', '.join(main)}): "
          f"{launches}", flush=True)
    cert = {h: sum(runs[r].get("cert", {}).get(h, 0) for r in main)
            for h in ops.CERT_LAUNCHES}
    print(f"phase 6 K23 struct_cert_check's {launches['struct_cert_check']} "
          f"launches on the main paths by where it ran: {cert}", flush=True)
    for pre, what, names in (("p22", "the disk tier", ("expand", "fp64")),
                             ("p23", "the artifact cache",
                              ("struct_recheck",))):
        got = {k: sum(runs[r]["launches"][k] for r in main
                      if r.startswith(pre)) for k in names}
        print(f"phase 6 launches on the {pre}* paths ({what}): {got}",
              flush=True)
    for r in ("shard_m1", "shard_scaled", "shard_scaled_pipe"):
        print(f"phase 6 {r}: {runs[r]['bodies']} bodies, launches per body "
              f"{runs[r]['per_body']:.1f}", flush=True)
    for k, v in launches.items():
        need(v > 0, f"kernel {k} was not launched on the main path")
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all", flush=True)
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


def command_inproc(argv):
    """The command in this process (torchtlc.cli.main), both streams
    captured: (rc, stdout, stderr).  For a -recover, which needs no signal
    of its own: it skips an interpreter's start and torch's import (~11 s
    a process on the card's machine)."""
    from torchtlc.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(["check", *argv])
    return rc, out.getvalue(), err.getvalue()


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


def phase_spill_flushes(torch, ops, card):
    """Phase 8b: Model_1 with the spill tier preferred at the first
    saturation of a 2^16-slot table (chunk 1024): phase 4's counts through
    several flushes."""
    from torchtlc.config import MODEL_1
    from torchtlc.resil.supervisor import SupervisorOptions

    flushes = []
    opts = SupervisorOptions(
        spill="on",
        on_event=lambda k, i: flushes.append(i)
        if k == "spill" and i["phase"] == "flush" else None)
    sup, launches, wall = run_supervised(
        torch, ops, MODEL_1, dict(M1_SPILL_KW, fp_capacity=1 << 16), opts)
    r = sup.result
    flush_s = sum(f["wall_s"] for f in flushes)
    print(f"phase 8b spill Model_1 (chunk 1024, fp 2^16, -spill): "
          f"{r.generated} / {r.distinct} / {r.depth}, wall {wall:.2f} s on "
          f"{card}; host store {sup.spill_store_s:.2f} s ({flush_s:.2f} s "
          f"in {sup.spill_flushes} flushes, the rest probes); "
          f"{sup.spilled} fingerprints spilled, {sup.spill_hits} host hits; "
          f"K9 launches {launches['fpset_member']}, {sup.segments} "
          f"segments", flush=True)
    need((r.generated, r.distinct, r.depth) == M1_COUNTS,
         "Model_1 spill counts")
    need(r.violation == 0 and r.queue_left == 0, "Model_1 spill verdict")
    need(sup.spilled > 0 and sup.spill_flushes > 1
         and launches["fpset_member"] > 0,
         "the Model_1 run did not spill in several flushes")
    return {"launches": launches}


def phase_preempt(cfg, tmp):
    """Phase 9: SIGTERM at segment 3 -> exit 75 with a final checkpoint (a
    subprocess); -recover -> exit 0 with the clean counts (in this
    process)."""
    ck = os.path.join(tmp, "preempt.ckpt")
    base = [cfg, "-noTool", "-checkpoint", ck, "-checkpointevery", "32"]
    t0 = time.time()
    rc, out = command(base + ["-faults", "sigterm@3"])
    wall_term = time.time() - t0
    need(rc == 75, f"the SIGTERM run exited {rc}, not 75")
    need("Run interrupted by signal" in out, "no interrupt banner")
    t0 = time.time()
    rc, out2, _ = command_inproc(base + ["-recover"])
    wall_recover = time.time() - t0
    need(rc == 0, f"the -recover run exited {rc}")
    need(final_counts(out2) == M1_COUNTS,
         f"the resumed counts {final_counts(out2)}")
    need("Starting recovery from checkpoint" in out2, "no recovery banner")
    print(f"phase 9 preemption: sigterm@3 -> exit 75 "
          f"({final_counts(out)[:2]} checkpointed, {wall_term:.2f} s), "
          f"-recover -> exit 0, {M1_COUNTS} ({wall_recover:.2f} s; the first "
          f"wall a subprocess, interpreter start included, the second in "
          f"this process)", flush=True)


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
    """Phase 10c: `python -m torchtlc.cli check MC.cfg -coverage` on Model_1
    (in this process): exit 0, the dump lines equal to the reference's
    (pinned digest), and the journal's coverage events folding to the
    final carry's totals (the checkpoint's cov_counts leaf)."""
    import numpy as np

    from torchtlc.config import MODEL_1
    from torchtlc.obs.coverage import coverage_from_events
    from torchtlc.obs.journal import read as read_journal
    from torchtlc.spec.coverage_device import site_table

    ck = os.path.join(tmp, "cov.ckpt")
    t0 = time.time()
    rc, out, _ = command_inproc([cfg, "-noTool", "-coverage", "-checkpoint",
                                 ck])
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
          f"{wall:.1f} s in this process on {card}", flush=True)


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
    try:  # the command's uncaught refusal (its process exits 1)
        command_inproc(base + ["-recover"])
        refusal = ""
    except ValueError as e:
        refusal = str(e)
    need("checkpoint pipeline mismatch" in refusal,
         f"the wrong-mode -recover was not refused: {refusal!r}")
    t0 = time.time()
    rc, out, _ = command_inproc(base + ["-pipeline", "-recover"])
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
          f"({wall_term:.2f} s), -recover without -pipeline refused "
          f"(ValueError: checkpoint pipeline mismatch), -recover -pipeline "
          f"-> exit 0, "
          f"{M1_COUNTS} ({wall_recover:.2f} s; the SIGTERM run a "
          f"subprocess, the -recover runs in this process); "
          f"{len(segs)} "
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

    def record(name, err, ms, pms, nbytes, nops=0):
        bound, by = gen_bound_ms(nbytes, nops)
        rows.setdefault(name, []).append(dict(
            shape=tag, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bound,
            bound_by=by))

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
           + D * chunk * W * 4,
           D * ncand * kube_expand_ops(cfg, deferred, sharded=True))
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
    -checkpointevery 32 -faults sigterm@3 -> exit 75 (a subprocess),
    -recover -pipeline -> exit 0 (in this process)."""
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
    rc, text, _ = command_inproc(base + ["-recover"])
    need(rc == 0, f"the sharded -recover -pipeline run exited {rc}")
    need(final_counts(text) == M1_COUNTS,
         f"the resumed sharded counts {final_counts(text)}")
    print(f"phase 12c command `check MC.cfg -sharded 4`: {'; '.join(lines)};"
          f" -pipeline sigterm@3 -> exit 75 ({wall_term:.2f} s), -recover "
          f"-pipeline -> exit 0, {M1_COUNTS} ({time.time() - t0:.2f} s; the "
          f"SIGTERM run a subprocess, -recover in this process) on {card}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 12d: the sharded spill tier; phases 13-13d: temporal properties
# ---------------------------------------------------------------------------


def phase_sharded_spill(ops, cfg, tmp, card):
    """Phase 12d: `check MC.cfg -sharded 4` on Model_1 through the sharded
    spill tier (engine.sharded.ShardedSpillRuntime), in this process: a
    table of 2^16 slots a shard whose regrow is denied (-faults
    alloc_fail@1) takes the spill rung and exits 0, then -spill (the
    spill-first policy); MC.out's counts, flushes and host hits from the
    journal, K9 launched on the owners' received rows."""
    from torchtlc.obs.journal import read as read_journal

    out, lines = {}, []
    for key, extra in (("shard_spill", ["-faults", "alloc_fail@1"]),
                       ("shard_spill_first", ["-spill"])):
        ck = os.path.join(tmp, key + ".ckpt")
        rc, text, launches, wall = command_here(
            ops, [cfg, "-noTool", "-sharded", "4", "-fpcap", "65536",
                  "-checkpoint", ck, *extra])
        need(rc == 0, f"`check -sharded 4 {' '.join(extra)}` exited {rc}")
        need(final_counts(text) == M1_COUNTS,
             f"`-sharded 4 {' '.join(extra)}` counts {final_counts(text)}")
        need("Host fingerprint spill tier activated" in text,
             f"`-sharded 4 {' '.join(extra)}` did not take the spill rung")
        evs = [e for e in read_journal(ck + ".journal.jsonl")
               if e["event"] == "spill"]
        flushes = [e for e in evs if e["phase"] == "flush"]
        need(flushes and flushes[-1]["hits"] > 0,
             f"`-sharded 4 {' '.join(extra)}`: no flush or no host hit")
        need(launches["fpset_member"] > 0, "K9 was not launched on the "
             "owners' received rows")
        out[key] = {"launches": launches}
        lines.append(
            f"{' '.join(extra)}: exit 0, {len(flushes)} flushes "
            f"({sum(e['flushed_tables'] for e in flushes)} tables), "
            f"{flushes[-1]['spilled']} fingerprints spilled, spill_hits "
            f"{flushes[-1]['hits']} at the last flush, "
            f"{flushes[-1]['probes']} host probes, K9 launches "
            f"{launches['fpset_member']}, flush walls "
            f"{sum(e['wall_s'] for e in flushes):.3f} s, wall {wall:.2f} s")
    print(f"phase 12d sharded spill `check MC.cfg -sharded 4 -fpcap 65536`: "
          f"{'; '.join(lines)}; {M1_COUNTS} on {card}", flush=True)
    return out


def liveness_text(text):
    """The liveness verdict and lasso lines of a transcript."""
    return [x for x in text.splitlines()
            if x.startswith(("Temporal propert", "State ", "/\\ ",
                             "-- The following"))]


def lasso_lengths(results):
    return [(r.name, r.holds) if r.holds else
            (r.name, len(r.prefix), len(r.cycle)) for r in results]


def phase_liveness_command(ops, tmp, card):
    """Phase 13: Model_1 through `check MC.cfg` with PROPERTY
    ReconcileCompletes and CleansUpProperly in its MC.cfg (in this
    process): the host liveness path (163,408 states, under the device
    path's threshold) exits 13 with the reference's verdicts and lassos
    (their lines' pinned digest)."""
    cfg = write_model(tmp, "Model_1_live", True, True)
    with open(cfg, "a") as f:
        f.write("PROPERTY ReconcileCompletes\nPROPERTY CleansUpProperly\n")
    rc, text, launches, wall = command_here(ops, [cfg, "-noTool"])
    need(rc == 13, f"`check MC.cfg` with PROPERTY exited {rc}, not 13")
    need(final_counts(text) == M1_COUNTS, "the liveness run's counts")
    need("(host liveness engine)" in text, "the host path did not run")
    lines = liveness_text(text)
    sha = hashlib.sha256("\n".join(lines).encode()).hexdigest()
    need(sha == M1_LIVENESS_SHA256,
         f"the liveness lines' digest {sha[:16]} is not the reference's")
    verdicts = [x for x in lines if x.startswith("Temporal propert")]
    print(f"phase 13 liveness command (Model_1, PROPERTY in MC.cfg): exit "
          f"13, {verdicts}, {len(lines)} verdict and lasso lines, digest "
          f"{sha[:16]} = jaxtlc's, {wall:.2f} s on {card}", flush=True)
    return {"live_cmd": {"launches": launches}}


def lasso_digest(results):
    """SHA-256 of liveness results: each verdict and, for a violation, its
    prefix and cycle states (int32 fields) and their action names."""
    import numpy as np

    h = hashlib.sha256()
    for r in results:
        h.update(f"{r.name} {r.holds}\n".encode())
        if r.holds:
            continue
        for part in (r.prefix, r.cycle):
            h.update(f"{len(part)}\n".encode())
            for st in part:
                h.update(np.asarray(st, np.int32).tobytes())
        h.update(repr((list(r.prefix_actions),
                       list(r.cycle_actions))).encode())
    return h.hexdigest()


def staged_capture(torch, cfg, kw):
    """capture_kube_graph's three stages, each timed on the host clock
    after a device sync: (graph, raw edge count, walls)."""
    from torchtlc.engine.backend import kubeapi_backend
    from torchtlc.live.capture import (captured_graph, enumerate_states,
                                       sweep_edges)

    backend = kubeapi_backend(cfg)
    t0 = time.time()
    states = enumerate_states(backend, **kw)
    torch.cuda.synchronize()
    t1 = time.time()
    raw = sweep_edges(backend, states, chunk=kw["chunk"])
    t2 = time.time()
    graph = captured_graph(backend, states, raw)
    walls = dict(enumerate_s=t1 - t0, capture_s=t2 - t1,
                 dedup_s=time.time() - t2)
    return graph, len(raw), walls


def timed_fixpoints(torch, cfg, graph, mesh=None):
    """The K15 masks of a captured graph and the survive fixpoint of each
    zone of the two properties (live.check's zones), timed: (zones,
    masks_s, [(alive, sweeps, wall_s)])."""
    import numpy as np

    from torchtlc.live.capture import state_masks
    from torchtlc.live.fixpoint import has_nonself, surviving_set

    t0 = time.time()
    masks = state_masks(cfg, torch.from_numpy(graph.states.view(
        np.int32)).cuda()).cpu().numpy().astype(bool)
    masks_s = time.time() - t0
    nr = cfg.n_reconcilers
    zones = [masks[k] for k in range(nr)] + [
        ~masks[k] & masks[nr + k] for k in range(nr)]
    nonself = has_nonself(graph)
    out = []
    for in_h in zones:
        t0 = time.time()
        alive, sweeps = surviving_set(graph, in_h, mesh=mesh,
                                      nonself=nonself)
        out.append((alive, sweeps, time.time() - t0))
    return zones, masks_s, out


def fixpoint_text(zones, fixes):
    return ", ".join(f"zone {k}: {sw} sweeps {wall:.3f} s ({int(h.sum())} "
                     f"in H, {int(alive.sum())} alive)"
                     for k, (h, (alive, sw, wall)) in enumerate(
                         zip(zones, fixes)))


def phase_liveness_model1(torch, ops, card, runs):
    """Phase 13b: Model_1 through check_properties_device (capture and
    all): its verdicts equal the host path's and its lassos (states and
    actions) the reference's device path's (pinned digest); then the
    capture's stages again, timed: the raw edges are the generated
    successors of non-initial states, the captured states equal the host
    graph's state for state; K14-K16 against their plain versions on
    Model_1 shapes."""
    import numpy as np

    from torchtlc.config import MODEL_1
    from torchtlc.engine.liveness import build_graph, check_properties
    from torchtlc.live.check import check_properties_device
    from torchtlc.spec.codec import get_codec

    kw = dict(chunk=1024, state_capacity=1 << 18, fp_capacity=1 << 19)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = check_properties_device(MODEL_1, LIVE_PROPS, **kw)
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    digest = lasso_digest(res)
    need(digest == M1_DEVICE_LASSO_SHA256, f"the device path's lassos "
         f"(digest {digest[:16]}) are not the reference's")
    t0 = time.time()
    host = build_graph(MODEL_1)
    host_wall = time.time() - t0
    href = check_properties(MODEL_1, LIVE_PROPS, graph=host)
    need([(r.name, r.holds) for r in res]
         == [(r.name, r.holds) for r in href],
         "device and host verdicts differ")

    graph, n_raw, walls = staged_capture(torch, MODEL_1, kw)
    need(n_raw == M1_COUNTS[0] - graph.init_count,
         f"Model_1 raw edges {n_raw}")
    cdc = get_codec(MODEL_1)
    packed = cdc.pack(torch.from_numpy(host.states.astype(np.int32)))
    need(graph.n_states == host.states.shape[0] == M1_COUNTS[1],
         "Model_1 captured state count")

    def rows_sorted(a):
        return a[np.lexsort(a.T[::-1])]

    need(np.array_equal(rows_sorted(packed.numpy().view(np.uint32)),
                        rows_sorted(graph.states)),
         "the captured states are not the host graph's")
    zones, masks_s, fixes = timed_fixpoints(torch, MODEL_1, graph)
    live_kernel_checks(torch, ops, "model1", MODEL_1, graph, runs)
    print(f"phase 13b liveness Model_1, device path: verdicts "
          f"{lasso_lengths(res)} = the host path's, lassos = the "
          f"reference's device path's (digest {digest[:16]}); check "
          f"{wall:.2f} s, host graph {host_wall:.2f} s; stages: "
          f"{graph.n_states} captured states = the host graph's, {n_raw} "
          f"raw / {len(graph.src)} deduplicated edges, enumerate "
          f"{walls['enumerate_s']:.3f} s, capture {walls['capture_s']:.3f} "
          f"s, dedup {walls['dedup_s']:.3f} s, masks {masks_s:.3f} s, "
          f"fixpoints {fixpoint_text(zones, fixes)} on {card}; launches "
          f"{launches}", flush=True)
    return {"live_m1": {"launches": launches}}


def phase_liveness_scaled(torch, ops, card, runs):
    """Phase 13c: scaled 2x1 on the device path at full width: the
    capture's stages (timed) and check_properties_device on its graph -
    19,359,985 captured states, the raw edges the generated successors of
    non-initial states, both verdicts with oracle-replayed lassos; the
    masks and each fixpoint timed.  13d: every fixpoint again on 4 shards
    (the same alive set and sweep count).  K14-K16 against their plain
    versions on blocks of this capture, and the fixpoint, on one device
    and on 4 slices, where states die."""
    import numpy as np

    from torchtlc.config import scaled_config
    from torchtlc.engine.sharded import ShardMesh
    from torchtlc.live.check import check_properties_device

    cfg, _ = scaled_config()
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    graph, n_raw, walls = staged_capture(torch, cfg, SCALED_LIVE_KW)
    t1 = time.time()
    res = check_properties_device(cfg, LIVE_PROPS, graph=graph)
    check_s = time.time() - t1
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    need(graph.n_states == SCALED_COUNTS[1],
         f"scaled captured {graph.n_states} states")
    need(n_raw == SCALED_COUNTS[0] - graph.init_count,
         f"scaled raw edges {n_raw}")
    out = {"live_scaled": {"launches": launches}}
    zones, masks_s, ones = timed_fixpoints(torch, cfg, graph)
    print(f"phase 13c liveness scaled 2x1, device path: {graph.n_states} "
          f"captured states, {n_raw} raw / {len(graph.src)} deduplicated "
          f"edges; verdicts {lasso_lengths(res)} (every lasso replayed "
          f"through the oracle); enumerate {walls['enumerate_s']:.3f} s, "
          f"capture {walls['capture_s']:.3f} s, dedup "
          f"{walls['dedup_s']:.3f} s, check_properties_device {check_s:.2f} "
          f"s ({wall:.2f} s in all); again outside it: masks "
          f"{masks_s:.3f} s, fixpoints {fixpoint_text(zones, ones)} on "
          f"{card}; launches {launches}", flush=True)

    # 13d: the same fixpoints over 4 edge slices
    ops.reset_counts()
    _, _, fours = timed_fixpoints(torch, cfg, graph, mesh=ShardMesh(4))
    out["live_scaled_4"] = {"launches": dict(ops.LAUNCHES)}
    for k, (one, four) in enumerate(zip(ones, fours)):
        need(np.array_equal(one[0], four[0]) and one[1] == four[1],
             f"zone {k}: the 4-shard fixpoint differs")
    print(f"phase 13d scaled fixpoints on 4 shards = on one device: "
          f"{fixpoint_text(zones, fours)} on {card}", flush=True)
    live_kernel_checks(torch, ops, "scaled", cfg, graph, runs,
                       zone=max(zones, key=lambda z: int(z.sum())))
    return out


def live_kernel_checks(torch, ops, tag, cfg, graph, runs, zone=None):
    """K14, K15 and K16 against their plain versions on the card, timed, on
    a capture's own data: K14 on the sweep block in the middle of the
    states, K15 over all states, K16 one sweep over the largest zone's
    edges (or `zone`).  Rows go to runs["live_rows"], the library calls'
    times to runs["live_library"]."""
    import numpy as np

    from torchtlc.engine.backend import FLAG_VALID, expand_block
    from torchtlc.engine.fingerprint import fp64_words
    from torchtlc.live import capture, fixpoint
    from torchtlc.spec.codec import get_codec
    from torchtlc.spec.kernel import lane_layout

    rows = runs.setdefault("live_rows", {})
    library = runs.setdefault("live_library", {})

    def record(name, err, ms, pms, nbytes, **extra):
        rows.setdefault(name, []).append(dict(
            shape=tag, max_abs_err=err, ms=ms, plain_ms=pms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, **extra))

    def err_of(a, b):
        if a.shape != b.shape:
            return 1 << 31
        a, b = a.to(torch.int64), b.to(torch.int64)
        return int((a - b).abs().max()) if a.numel() else 0

    cdc = get_codec(cfg)
    _, L = lane_layout(cfg)
    V = graph.n_states
    states = torch.from_numpy(graph.states.view(np.int32)).cuda()
    lo, hi = fp64_words(states, cdc.nbits)
    s_hi, s_lo, perm = capture.sorted_ids(lo, hi)

    # K14 on one capture sweep block
    ck = SCALED_LIVE_KW["chunk"] if tag == "scaled" else 1024
    off = (V // 2) // ck * ck
    packed, flags, action, _ = expand_block(
        cfg, states[off:off + ck].contiguous(), ck, deferred=True)
    q_lo, q_hi = fp64_words(packed, cdc.nbits)
    valid = flags[FLAG_VALID].contiguous()
    args = (s_hi, s_lo, perm, q_hi, q_lo, valid, action, off, L)
    got, ref = ops.edge_capture(*args), capture.edge_capture_plain(*args)
    err = max(err_of(got[0], ref[0]), int(bool(got[1]) != bool(ref[1])))
    need(err == 0 and not bool(got[1]),
         f"K14 edge_capture differs from its plain version ({tag})")
    N, nv = q_hi.shape[0], got[0].shape[0]

    def key(h, lo_):
        return (((h.to(torch.int64) & 0xFFFFFFFF) - (1 << 31)) * (1 << 32)
                + (lo_.to(torch.int64) & 0xFFFFFFFF))

    s_key, q_key = key(s_hi, s_lo), key(q_hi, q_lo)
    lib_idx = torch.searchsorted(s_key, q_key)
    need(torch.equal(perm[lib_idx.clamp(max=V - 1)][valid.bool()],
                     got[0][:, 1]), f"searchsorted disagrees with K14 ({tag})")
    # K14's time: its two launches on device events, the inclusive count
    # and the edge buffer made outside the timed call (the wrapper reads
    # the count to the host between them: timed apart as wrapper_ms)
    cum = torch.cumsum(valid, 0, dtype=torch.int64)
    buf = torch.empty(nv, 4, dtype=torch.int32, device=valid.device)

    def launches_only(_):
        dst, chg, _m = ops.edge_search(s_hi, s_lo, perm, q_hi, q_lo, valid,
                                       off, L)
        ops.edge_compact(valid, cum, off, L, dst, chg, action, buf)

    launches_only(None)
    need(torch.equal(buf, ref[0]), f"K14's launches alone differ ({tag})")
    cumsum_ms = cuda_ms(torch, lambda _: torch.cumsum(
        valid, 0, dtype=torch.int64), 10)
    record("edge_capture", err, cuda_ms(torch, launches_only, 10),
           cuda_ms(torch, lambda _: capture.edge_capture_plain(*args), 3),
           V * 12 + N * 13 + nv * 16,
           wrapper_ms=cuda_ms(torch, lambda _: ops.edge_capture(*args), 10))
    library["edge_capture"] = cuda_ms(
        torch, lambda _: torch.searchsorted(s_key, q_key), 10)

    # K15 over every state
    params = capture.mask_params(cfg)
    got = ops.state_masks(params, states)
    ref = capture.state_masks_plain(cfg, states)
    err = err_of(got, ref)
    need(err == 0, f"K15 state_masks differs from its plain version ({tag})")
    record("state_masks", err,
           cuda_ms(torch, lambda _: ops.state_masks(params, states), 10),
           cuda_ms(torch, lambda _: capture.state_masks_plain(cfg, states),
                   2),
           V * cdc.n_words * 4 + got.shape[0] * V)
    if zone is None:
        m = got.cpu().numpy().astype(bool)
        nr = cfg.n_reconcilers
        zone = max([m[k] for k in range(nr)]
                   + [~m[k] & m[nr + k] for k in range(nr)],
                   key=lambda z: int(z.sum()))
    del got, ref

    # K16: the first sweep over the zone's edges
    keep = graph.changed & zone[graph.src] & zone[graph.dst]
    src = torch.from_numpy(np.ascontiguousarray(graph.src[keep])).cuda()
    dst = torch.from_numpy(np.ascontiguousarray(graph.dst[keep])).cuda()
    alive = torch.from_numpy(zone.astype(np.uint8)).cuda()
    term = torch.from_numpy((zone & ~fixpoint.has_nonself(graph))
                            .astype(np.uint8)).cuda()
    got = ops.survive_sweep(src, dst, 1, alive, term)
    ref = fixpoint.survive_sweep_plain(src, dst, 1, alive, term)
    err = max(err_of(got[0], ref[0]), int(bool(got[1]) != bool(ref[1])))
    need(err == 0, f"K16 survive_sweep differs from its plain version "
         f"({tag})")
    E = src.shape[0]
    record("survive_sweep", err,
           cuda_ms(torch, lambda _: ops.survive_sweep(src, dst, 1, alive,
                                                      term), 10),
           cuda_ms(torch, lambda _: fixpoint.survive_sweep_plain(
               src, dst, 1, alive, term), 3),
           E * 8 + V * 3)
    # the support scatter as one library call (its gathered values and
    # int64 indices prepared outside the timed call)
    src64, vals = src.to(torch.int64), alive[dst.to(torch.int64)]
    library["survive_sweep"] = cuda_ms(
        torch, lambda _: torch.zeros(V, dtype=torch.uint8, device="cuda")
        .scatter_reduce_(0, src64, vals, "amax"), 10)
    dying = dying_fixpoints(torch, ops, tag, graph)
    times = "; ".join(
        f"{k} {r[-1]['ms']:.4f} ms (bound {r[-1]['bound_ms']:.4f}, plain "
        f"{r[-1]['plain_ms']:.3f}, library {library.get(k, '-')})"
        for k, r in rows.items())
    print(f"phase 13 kernels vs plain ({tag}): K14 on {N} lanes ({nv} "
          f"edges) of the block at {off}, K15 over {V} states, K16 over "
          f"{E} edges of a {int(zone.sum())}-state zone: all bitwise "
          f"equal; torch.searchsorted agrees with K14; {times}; K14's "
          f"wrapper {rows['edge_capture'][-1]['wrapper_ms']:.4f} ms (its "
          f"torch.cumsum {cumsum_ms:.4f} ms and the host read of the count "
          f"included); {dying}", flush=True)


def dying_fixpoints(torch, ops, tag, graph):
    """K16 held against its plain version where states die: H a seeded
    random half of the captured states, so that H-states lose their
    support sweep after sweep.  Both routes sweep in lockstep from the
    same alive plane, on one slice and on 4 (the padded slices of
    engine.sharded.sharded_survive_fixpoint), each sweep bitwise equal;
    then live.fixpoint.surviving_set on one device and on a 4-shard mesh
    reach the same alive set in the same number of sweeps.  Needs more
    than one sweep and a state removed by the first."""
    import numpy as np

    from torchtlc.engine.sharded import ShardMesh
    from torchtlc.live import fixpoint

    V = graph.n_states
    in_h = np.random.default_rng(SEED + 14).random(V) < 0.5
    term = in_h & ~fixpoint.has_nonself(graph)
    keep = graph.changed & in_h[graph.src] & in_h[graph.dst]
    src, dst = graph.src[keep], graph.dst[keep]
    E = len(src)
    out = []
    for D in (1, 4):
        Ep = max(-(-max(E, 1) // D) * D, D)
        src_p = np.full(Ep, V, np.int32)
        dst_p = np.zeros(Ep, np.int32)
        src_p[:E], dst_p[:E] = src, dst
        s_t = torch.from_numpy(src_p).cuda()
        d_t = torch.from_numpy(dst_p).cuda()
        term_t = torch.from_numpy(term.astype(np.uint8)).cuda()
        alive = torch.from_numpy(in_h.astype(np.uint8)).cuda()
        sweeps, removed = 0, []
        while True:
            got = ops.survive_sweep(s_t, d_t, D, alive, term_t)
            ref = fixpoint.survive_sweep_plain(s_t, d_t, D, alive, term_t)
            need(torch.equal(got[0], ref[0])
                 and bool(got[1]) == bool(ref[1]),
                 f"K16 differs from its plain version at sweep {sweeps} of "
                 f"the random-H fixpoint, {D} slices ({tag})")
            removed.append(int((alive != got[0]).sum()))
            sweeps += 1
            alive = got[0]
            if not bool(got[1]):
                break
        need(sweeps > 1 and removed[0] > 0,
             f"the random-H fixpoint ({tag}) removed {removed[0]} states "
             f"in its first sweep and ended after {sweeps}")
        out.append((alive.cpu().numpy().astype(bool), sweeps, removed))
    one = fixpoint.surviving_set(graph, in_h)
    four = fixpoint.surviving_set(graph, in_h, mesh=ShardMesh(4))
    for D, (alive, sweeps, _) in zip((1, 4), out):
        need(np.array_equal(alive, one[0]) and sweeps == one[1]
             and np.array_equal(four[0], one[0]) and four[1] == one[1],
             f"the random-H fixpoints differ ({tag}, {D} slices)")
    return (f"K16 where states die (a seeded half of the states as H, {E} "
            f"edges): {one[1]} sweeps on 1 and on 4 slices, each bitwise "
            f"equal to the plain version, {out[0][2][0]} states removed by "
            f"the first sweep, {int(in_h.sum())} in H, "
            f"{int(one[0].sum())} alive; surviving_set on 1 device = on 4 "
            f"shards")


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


def cuda_ms_once(torch, fn):
    """fn() once, its device time taken as cuda_ms takes a call's (a
    spinning kernel queued ahead of the first event) but with no warm-up
    call: (its result, ms).  For plain versions that take seconds a call,
    whose warm-up would cost as much as the call."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def check_expand_wide(torch, rng):
    """K1 (both variants) and its sharded variant on rows wider than the
    main path's: scaled 3x0 with both faults (9 packed words), seeded
    random fields, bitwise against the plain versions (untimed)."""
    import numpy as np

    from torchtlc.config import make_scaled
    from torchtlc.engine import sharded as ts
    from torchtlc.engine.backend import expand_block, expand_plain
    from torchtlc.kernels import ops
    from torchtlc.spec.codec import get_codec

    cfg = make_scaled(3, 0, True, True)
    cdc = get_codec(cfg)
    ck, D = 512, 2
    fields = torch.from_numpy(np.stack(
        [rng.integers(0, 1 << w, D * (ck + 1)) for w in cdc.lane_widths],
        1).astype(np.int32)).cuda()
    block = cdc.pack(fields[:ck])
    for deferred in (False, True):
        got = expand_block(cfg, block, ck - 5, deferred)
        ref = expand_plain(cfg, block, ck - 5, deferred)
        need(all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, ref)),
             f"K1 expand differs from its plain version (W = {cdc.n_words}, "
             f"deferred {deferred})")
    queue = fields.reshape(D, ck + 1, -1)
    qhead = torch.tensor([0, 7], dtype=torch.int64, device="cuda")
    npop = torch.tensor([ck, ck - 9], dtype=torch.int64, device="cuda")
    got = ops.expand_sharded(cfg, queue, qhead, npop, ck, True, True)
    ref = ts.expand_sharded_plain(cfg, queue, qhead, npop, ck, True, True)
    need(all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, ref)),
         f"K1's sharded variant differs from its plain version (W = "
         f"{cdc.n_words})")
    print(f"phase 2 K1 on {cdc.n_words}-word rows (scaled 3x0, both "
          "faults): both variants and the sharded one equal their plain "
          "versions", flush=True)


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

    def record(name, shape, err, ms, plain_ms, nbytes, nops=0):
        bound, by = gen_bound_ms(nbytes, nops)
        rows.setdefault(name, []).append(dict(
            shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by))

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
               ck * W * 4 + ncand * (W * 4 + 5 + 4) + n_labels * 8,
               ncand * kube_expand_ops(cfg, False))
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

    check_expand_wide(torch, rng)
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
        "edge_capture": ("torchtlc/kernels/csrc/liveness.cu",
                         "jaxtlc/live/capture.py:117"),
        "state_masks": ("torchtlc/kernels/csrc/liveness.cu",
                        "jaxtlc/live/capture.py:252"),
        "survive_sweep": ("torchtlc/kernels/csrc/liveness.cu",
                          "jaxtlc/live/fixpoint.py:41"),
        "struct_expand": ("torchtlc/kernels/csrc/struct_expand.cuh",
                          "jaxtlc/struct/backend.py:169"),
        "struct_inv_rows": ("torchtlc/kernels/csrc/struct_inv_rows.cuh",
                            "jaxtlc/engine/backend.py:325"),
        "gen_expand": ("torchtlc/kernels/csrc/gen_expand.cuh",
                       "jaxtlc/gen/engine.py:130"),
        "gen_state_masks": ("torchtlc/kernels/csrc/gen_masks.cuh",
                            "jaxtlc/live/check.py:205"),
        "emitted_expand_sharded": ("torchtlc/kernels/csrc/emitted_sharded.cuh",
                                   "jaxtlc/engine/sharded.py:510"),
        "struct_cov_count": ("torchtlc/kernels/csrc/struct_cov.cuh",
                             "jaxtlc/struct/compile.py:2224"),
        "struct_cert_check": ("torchtlc/kernels/csrc/struct_cert.cuh",
                              "jaxtlc/struct/backend.py:46"),
        "struct_canon": ("torchtlc/kernels/csrc/struct_reduce.cuh",
                         "jaxtlc/engine/reduce.py:205"),
        "struct_orbit_check": ("torchtlc/kernels/csrc/struct_reduce.cuh",
                               "jaxtlc/engine/reduce.py:327"),
        "struct_por_keep": ("torchtlc/kernels/csrc/struct_reduce.cuh",
                            "jaxtlc/engine/reduce.py:376"),
        "struct_sim_step": ("torchtlc/kernels/csrc/emitted_sim.cuh",
                            "jaxtlc/sim/engine.py:232"),
        "sim_fold": ("torchtlc/kernels/csrc/emitted_sim.cuh",
                     "jaxtlc/sim/engine.py:264"),
        "struct_pred_matrix": ("torchtlc/kernels/csrc/struct_infer.cuh",
                               "jaxtlc/infer/filter.py:71"),
        "struct_pred_alive": ("torchtlc/kernels/csrc/struct_infer.cuh",
                              "jaxtlc/infer/filter.py:71"),
        "struct_certify": ("torchtlc/kernels/csrc/struct_infer.cuh",
                           "jaxtlc/infer/certify.py:38"),
        "struct_recheck": ("torchtlc/kernels/csrc/struct_recheck.cuh",
                           "jaxtlc/struct/artifacts.py:722"),
        "emitted_expand_batched": (
            "torchtlc/kernels/csrc/emitted_batched.cuh",
            "jaxtlc/serve/sweep.py:260"),
        "fpset_insert_batched": ("torchtlc/kernels/csrc/fpset_batched.cu",
                                 "jaxtlc/serve/sweep.py:260"),
        "struct_sim_step_batched": (
            "torchtlc/kernels/csrc/emitted_batched.cuh",
            "jaxtlc/sim/engine.py:477"),
        "sim_fold_batched": ("torchtlc/kernels/csrc/emitted_batched.cuh",
                             "jaxtlc/sim/engine.py:477"),
        "pod_exchange_pack": ("torchtlc/kernels/csrc/pod.cuh",
                              "jaxtlc/engine/sharded.py:572"),
        "pod_exchange_unpack": ("torchtlc/kernels/csrc/pod.cuh",
                                "jaxtlc/engine/sharded.py:572"),
        "pod_stats_pack": ("torchtlc/kernels/csrc/pod.cuh",
                           "jaxtlc/dist/pod.py:224"),
        "kube_sim_step": ("torchtlc/kernels/csrc/kube_sim.cu",
                          "jaxtlc/sim/engine.py:232"),
        "kube_sim_fold": ("torchtlc/kernels/csrc/kube_sim.cu",
                          "jaxtlc/sim/engine.py:264"),
        "gen_sim_step": ("torchtlc/kernels/csrc/gen_sim.cuh",
                         "jaxtlc/sim/engine.py:232"),
        "gen_sim_fold": ("torchtlc/kernels/csrc/gen_sim.cuh",
                         "jaxtlc/sim/engine.py:264"),
    }
    for key in ("sharded", "live", "struct", "gen", "shard16", "p17", "p18",
                "p19", "p20", "p21", "p22", "p23", "p24", "p25", "p25c",
                "p26"):
        for name, got in runs.get(f"{key}_rows", {}).items():
            rows.setdefault(name, []).extend(got)
        library.update(runs.get(f"{key}_library", {}))
    first = {name: rows[name][0] for name in rows}
    out = []
    for name in ops.KERNELS:
        big = rows[name][-1]  # the scaled step shape
        out.append({
            "name": name, "route": "cuda", "source": source[name][0],
            "replaces": source[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"],
            "bound_by": big.get("bound_by", "bytes"),
            "library_ms": library.get(name),
            "model1": {k: first[name][k]
                       for k in ("shape", "ms", "plain_ms", "bound_ms")},
        })
        if "wrapper_ms" in big:  # K14: the wrapper, its host read included
            out[-1]["wrapper_ms"] = big["wrapper_ms"]
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


def kube_expand_ops(cfg, deferred, sharded=False) -> int:
    """K1's integer operations a candidate lane, counted low: the copy of
    the row's F fields into the lane's frame and the handler's reads and
    writes of them (2 F each), the canonicalizing sorts (ni^2 compares of
    the API rows), the invariants unless deferred (~8 a field), the test
    of each field against the row's (2 F), and the lane's share of its
    row's decode (~6 a field; the sharded variant's pack of the row, ~4 a
    field and word)."""
    from torchtlc.engine.backend import kernel_layout

    lay = kernel_layout(cfg)
    ni, F, W, L = int(lay[0]), int(lay[24]), int(lay[25]), int(lay[28])
    row = 4 * F * W if sharded else 6 * F
    return 6 * F + ni * ni + (0 if deferred else 8 * F) + -(-row // L)


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
    wstats = torch.zeros(3, dtype=torch.int32, device=dev)
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
        ops.fpset_walk(t_k, keys, pend, is_new, npend, wstats)
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
    slices, rounds, general = (int(x) for x in wstats.tolist())
    need(general == 0, f"K3 walk: {general} slices took the general order "
         f"({tag}): the sorted keys' homes did not ascend")
    nseg_run = -(-nr // R)
    row_us = dependent_row_us(torch, table.shape[0], dev)
    print(f"phase 2 K3 ({tag}): {cap} slots to load {load:.3f}, {nr} distinct "
          f"of {ncand} candidates, {stragglers} stragglers walked (max "
          f"{max_seg} in one segment), table words equal; the walk: "
          f"{slices} slices, {rounds} rounds in {nseg_run} launches, "
          f"general order 0; one dependent row read {row_us:.4f} us (K9 "
          f"over a run of full rows), so a latency floor of "
          f"{rounds / nseg_run * row_us / 1e3:.4f} ms a launch", flush=True)
    per = {k: (0, ms[k] / nseg_run, pms[k] / nseg_run) for k in ms}
    return {  # per launch: mean over the nseg_run active segments
        "fpset_probe": (*per["fpset_probe"], R * (8 + 4) + nr / nseg_run * 64),
        "fpset_claim": (*per["fpset_claim"], R * (8 + 4 + 2) + nr / nseg_run * 8),
        "fpset_walk": (*per["fpset_walk"],
                       stragglers / nseg_run * (8 + 64 + 8) + R * 2),
    }


def dependent_row_us(torch, nb, dev, hops=64):
    """One dependent bucket-row read on this card, in microseconds: K9
    over one lane whose walk must cross `hops` full rows, less the same
    lane stopped after its first row, over hops - 1, on a zeroed table of
    nb rows (L2-warm after cuda_ms's warm-up call).  The straggler walk's
    rounds each wait on one such read."""
    from torchtlc.engine import fpset
    from torchtlc.kernels import ops

    lo = torch.tensor([12345], dtype=torch.int32)
    hi = torch.tensor([678], dtype=torch.int32)
    m = torch.ones(1, dtype=torch.bool)
    klo, khi = fpset.key_words(fpset.fpset_key_plain(lo, hi, m))
    home = int(fpset._bucket_of(khi, nb)[0])
    table = torch.zeros(nb, 16, dtype=torch.int32)
    rows = (home + torch.arange(hops)) % nb
    table[rows, 0::2] = fpset.to_i32(~klo & fpset.MASK32)  # never the key
    table[rows, 1::2] = 1
    table, lo, hi, m = (t.to(dev) for t in (table, lo, hi, m))
    far = cuda_ms(torch, lambda _: ops.fpset_member(table, lo, hi, m, hops),
                  20)
    near = cuda_ms(torch, lambda _: ops.fpset_member(table, lo, hi, m, 1),
                   20)
    return (far - near) / (hops - 1) * 1e3


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
           ck * W * 4 + ncand * (W * 4 + 5 + 4) + 22 * 8,
           ncand * kube_expand_ops(cfg, True))
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
    # cert: the carry's sticky certificate flag of a narrowed struct run,
    # set (COL_CERT)
    cert = torch.ones((), dtype=torch.bool, device=dev)
    none2 = (None, None)
    for name, wrap, sp, cv, ce in (("", False, none2, none2, None),
                                   ("/wrap", True, none2, none2, None),
                                   ("/spill", False, spill, none2, None),
                                   ("/coverage", False, none2, cov_pair,
                                    None),
                                   ("/cert", False, none2, none2, cert)):
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
               n_labels, *sp, *cv, cert=ce)
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
        need(int(outs[0][0][int(carry.obs_head) % SCALED_OBS_SLOTS,
                            counters.COL_CERT]) == int(ce is not None),
             f"K8's COL_CERT ({tag}{name})")

        def ring_args(fn):
            def run(st):
                fn(st[0], st[1], st[2], st[3], ck, True, carry.level,
                   carry.generated, carry.generated, carry.distinct,
                   carry.distinct, carry.level_n, carry.act_gen,
                   carry.act_dist, torch.cat([carry.act_gen,
                                              carry.act_dist]), n_labels,
                   *sp, *cv, cert=ce)
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
                + (311 * 16 if cv[0] is not None else 0)
                + (1 if ce is not None else 0)))
    print(f"phase 2 slice-2 kernels vs plain ({tag}, chunk {ck}, {n} popped, "
          f"{ncand} candidates, R {R}): all bitwise equal; "
          + "; ".join(lines) + f"; library sort {lib_ms}", flush=True)


# ---------------------------------------------------------------------------
# phases 14-14c: struct specs through the structural frontend (K17, K18)
# ---------------------------------------------------------------------------


def _struct_geometries():
    """(name, MC.cfg, engine geometry) of phase 14's shipped models."""
    here = os.path.dirname(os.path.abspath(__file__))
    tb = os.path.join(here, "specs")
    return [
        ("TwoPhase/Model_1", os.path.join(tb, "TwoPhase.toolbox", "Model_1",
                                          "MC.cfg"),
         dict(chunk=64, queue_capacity=512, fp_capacity=4096)),
        ("TwoPhase/Model_sym", os.path.join(tb, "TwoPhase.toolbox",
                                            "Model_sym", "MC.cfg"),
         dict(chunk=64, queue_capacity=1024, fp_capacity=4096)),
        ("RaftReplication/Model_1", os.path.join(
            tb, "RaftReplication.toolbox", "Model_1", "MC.cfg"),
         dict(chunk=256, queue_capacity=1 << 13, fp_capacity=1 << 15)),
    ]


def write_struct_models(tmp):
    """The two derived models of phases 14-14c in `tmp`: the stale-leader
    RaftReplication (Elect without its up-to-dateness restriction,
    tests/test_raft_replication.py:49-60) and TwoPhase with RM of 8.
    Returns (stale MC.cfg, TwoPhase-8 MC.cfg)."""
    here = os.path.dirname(os.path.abspath(__file__))
    raft = os.path.join(here, "specs", "RaftReplication.toolbox", "Model_1")
    two = os.path.join(here, "specs", "TwoPhase.toolbox", "Model_1")
    src = open(os.path.join(raft, "RaftReplication.tla")).read()
    needle = ("/\\ 2 * Cardinality({m \\in Nodes : UpToDate(n, m)}) "
              "> NodeCount\n            ")
    need(needle in src, "the stale-leader needle is not in the spec")
    out = []
    for name, files in (
            ("stale", {"RaftReplication.tla": src.replace(needle, "", 1),
                       "MC.cfg": open(os.path.join(raft, "MC.cfg")).read()}),
            ("tp8", {"TwoPhase.tla": open(os.path.join(
                two, "TwoPhase.tla")).read(), "MC.cfg": TP8_CFG})):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for fname, text in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        out.append(os.path.join(d, "MC.cfg"))
    return tuple(out)


def struct_digest(table) -> str:
    import numpy as np

    return hashlib.sha256(np.asarray(table).astype("<u4").tobytes()
                          ).hexdigest()


def struct_run(ops, model, kw, modes):
    """check_struct on the card with the launch counts reset just before
    and read just after: (result, launches)."""
    from torchtlc.struct.engine import check_struct

    ops.reset_counts()
    r = check_struct(model, check_deadlock=False, capture_fps=True, **kw,
                     **modes)
    return r, dict(ops.LAUNCHES)


def struct_pinned(tag, r, pin):
    need([r.generated, r.distinct, r.depth] == pin["counts"],
         f"{tag} counts {(r.generated, r.distinct, r.depth)}")
    need(r.violation == 0 and r.queue_left == 0, f"{tag} verdict")
    need(r.action_generated == pin["act_gen"], f"{tag} per-action generated")
    need(r.action_distinct == pin["act_dist"], f"{tag} per-action distinct")
    need(list(r.outdegree) == pin["outdegree"], f"{tag} outdegree")
    need(struct_digest(r.fp_table) == pin["sha"], f"{tag} table words")


def struct_block(torch, backend, kw, until):
    """A real popped block of a sorted, immediate run: the rows the engine
    pops in the first step for which until(carry) holds after it, and the
    count it pops.  Returns (block, n, carry after the step)."""
    from torchtlc.engine import bfs

    init_fn, _, step_fn = bfs.make_backend_engine(
        backend, kw["chunk"], kw["queue_capacity"], kw["fp_capacity"],
        sort_free=False, deferred=False)
    c = init_fn()
    while True:
        h = bfs.read_bundle(c)
        need(bfs._running(h), "the run ended before the wanted block")
        block = c.queue[h.parity, h.qhead:h.qhead + kw["chunk"]].clone()
        n = min(h.level_n - h.qhead, kw["chunk"])
        c = step_fn(c)
        if until(c):
            return block, n, c


def struct_kernel_checks(torch, ops, tag, prog, block, n, record,
                         want_viol=False, reps=20):
    """K17 (both modes) and K18 against their plain versions on the card,
    on one popped block: bitwise, and timed when `record` is given.  K18's
    claimants are the block's real ones: K17's deferred output through
    the fingerprints (K2) and the slab dedup into a fresh table.  Returns
    K18's verdict."""
    from torchtlc.engine import fpset
    from torchtlc.engine.fingerprint import fp64_words

    def err_of(a, b):
        if a is None:
            return 0
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0

    ck = block.shape[0]
    ncand = ck * prog.L
    for deferred in (False, True):
        got = ops.struct_expand(prog, block, n, deferred)
        ref = prog.expand_plain(block, n, deferred)
        err = max(err_of(a, b) for a, b in zip(got, ref))
        need(err == 0, f"K17 struct_expand differs from its plain version "
             f"({tag}, deferred={deferred})")
        if not deferred:
            bad = int(got[1][3:].sum())
            need(bad > 0 if want_viol else bad == 0,
                 f"K17 invariant flags ({tag}): {bad} failing lanes")
            if record is not None:
                nbytes = (ck * prog.W * 4 + ncand * (
                    prog.W * 4 + 3 + prog.n_inv + 4) + prog.n_labels * 8)
                record("struct_expand", tag, err,
                       cuda_ms(torch, lambda _: ops.struct_expand(
                           prog, block, n, False), reps),
                       cuda_ms(torch, lambda _: prog.expand_plain(
                           block, n, False), 2), nbytes)
    packed, flags, action, _, flat = got[:5]
    valid = flags[0].bool()
    lo, hi = fp64_words(packed, prog.cdc.nbits)
    R = min(2 * ck, ncand)
    fps = fpset.fpset_new(max(1 << 10, 1 << (4 * ncand - 1).bit_length()),
                          block.device)
    _, is_new_c, c_idx, nreps, fell_back = fpset.fpset_insert_dedup(
        fps, lo, hi, valid, probe_width=R, claim_width=R, sort_free=True)
    rows = R if not fell_back else ncand
    got = ops.struct_inv_rows(prog, flat, is_new_c, c_idx, action, rows)
    ref = prog.inv_rows_plain(flat, is_new_c, c_idx, action, rows)
    err = max(err_of(a, b) for a, b in zip(got, ref))
    need(err == 0, f"K18 struct_inv_rows differs from its plain version "
         f"({tag})")
    viol = int(got[0])
    need(viol >= 100 if want_viol else viol == 0, f"K18 verdict {viol} "
         f"({tag})")
    if record is not None:
        fresh = int(is_new_c[:rows].sum())
        record("struct_inv_rows", tag, err,
               cuda_ms(torch, lambda _: ops.struct_inv_rows(
                   prog, flat, is_new_c, c_idx, action, rows), reps),
               cuda_ms(torch, lambda _: prog.inv_rows_plain(
                   flat, is_new_c, c_idx, action, rows), 2),
               inv_rows_bytes(prog, rows, fresh))
    return viol


def phase_struct(torch, ops, card, runs, tmp):
    """Phase 14: check_struct on TwoPhase Model_1, Model_sym and
    RaftReplication Model_1 in the sorted immediate modes and in the slab
    deferred modes with the counter ring, every result pinned to the
    reference's CPU run at the same geometry (counts, per-action counts,
    outdegree, table words); K17 and K18 bitwise against their plain
    versions on real popped blocks of each, and on the block where the
    stale-leader RaftReplication violates an invariant."""
    from concurrent.futures import ThreadPoolExecutor

    from torchtlc.struct.cache import get_backend
    from torchtlc.struct.loader import load

    stale, tp8 = write_struct_models(tmp)
    models = {name: (load(cfg), kw) for name, cfg, kw in
              _struct_geometries()}
    models["stale"] = (load(stale), _struct_geometries()[2][2])
    models["TwoPhase/RM8"] = (load(tp8), TP8_KW)
    progs = {name: get_backend(m, False).kernels.prog
             for name, (m, _) in models.items()}
    t0 = time.time()
    with ThreadPoolExecutor(len(progs)) as pool:  # one nvcc per spec
        list(pool.map(ops.struct_lib, progs.values()))
    print(f"phase 14 build: {len(progs)} struct kernel libraries (K17, "
          f"K18) with nvcc in {time.time() - t0:.1f} s; lane IR "
          + "; ".join(f"{k} {p.stats()['step']['elements']}+"
                      f"{p.stats()['invariants']['elements']} elements, "
                      f"largest node {p.stats()['step']['largest_node']}, "
                      f"table {p.K.size}" for k, p in progs.items()),
          flush=True)
    rows = {}

    def record(name, shape, err, ms, plain_ms, nbytes):
        rows.setdefault(name, []).append(dict(
            shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))

    out = {}
    for name, cfg, kw in _struct_geometries():
        m = models[name][0]
        for mode, modes in (("sorted", SORTED),
                            ("slab", dict(sort_free=True, deferred=True,
                                          obs_slots=64))):
            r, launches = struct_run(ops, m, kw, modes)
            struct_pinned(f"{name} {mode}", r, STRUCT_PINS[name])
            out[f"struct_{name}_{mode}"] = {"launches": launches}
            print(f"phase 14 {name} {mode}: {r.generated} / {r.distinct} / "
                  f"{r.depth}, outdegree {r.outdegree}, table sha256 "
                  f"{struct_digest(r.fp_table)[:16]} = the reference's, "
                  f"{r.iterations} steps in {r.wall_s:.3f} s; K17 "
                  f"{launches['struct_expand']}, K18 "
                  f"{launches['struct_inv_rows']} launches", flush=True)
        backend = get_backend(m, False)
        half = STRUCT_PINS[name]["counts"][2] // 2
        block, n, _ = struct_block(torch, backend, kw,
                                   lambda c, h=half: int(c.level) > h)
        struct_kernel_checks(torch, ops, name, progs[name], block, n,
                             record if name.startswith("Raft") else None)
    m, kw = models["stale"]
    block, n, c = struct_block(torch, get_backend(m, False), kw,
                               lambda c: int(c.viol) != 0)
    viol = struct_kernel_checks(torch, ops, "stale", progs["stale"], block,
                                n, None, want_viol=True)
    print(f"phase 14 K17/K18 vs plain: bitwise equal on a popped block of "
          f"each model (sorted and deferred); the stale-leader block "
          f"({n} rows) fails an invariant in K17's flags and K18 reports "
          f"code {viol}; RaftReplication step (chunk {kw['chunk']}): "
          + ", ".join(f"{k} {v[-1]['ms']:.4f} ms (plain "
                      f"{v[-1]['plain_ms']:.3f} ms, bound "
                      f"{v[-1]['bound_ms']:.5f} ms)"
                      for k, v in rows.items()) + f" on {card}", flush=True)
    out["struct_rows"] = rows
    out["struct_models"] = models
    out["struct_progs"] = progs
    out["struct_cfgs"] = dict(stale=stale, tp8=tp8)
    return out


def device_busy(torch, fn):
    """fn() once under torch.profiler: (its result, traced wall, device
    busy seconds, {kernel name: device seconds}).  Only the device's
    activity is traced: recording every host-side op of a sharded run
    made the profiler's own bookkeeping take half a minute a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0) + us / 1e6
    need(by_name, "the profiler recorded no device time")
    return res, wall, sum(by_name.values()), by_name


def phase_struct_real(torch, ops, card, runs):
    """Phase 14b: TwoPhase with RM of 8 (r1..r8) at chunk 16,384 in the
    modes the reference resolves there (slab dedup, deferred invariants):
    the reference's counts and table words at the same geometry; the wall,
    distinct states per second, the device's busy share (torch.profiler)
    and K17's device time; K17 and K18 against their plain versions on a
    popped block of the run, timed."""
    m, kw = runs["struct_models"]["TwoPhase/RM8"]
    prog = runs["struct_progs"]["TwoPhase/RM8"]
    r, launches = struct_run(ops, m, kw, {})
    need((r.generated, r.distinct, r.depth) == TP8_COUNTS,
         f"TwoPhase-8 counts {(r.generated, r.distinct, r.depth)}")
    need(r.violation == 0 and r.queue_left == 0, "TwoPhase-8 verdict")
    need(struct_digest(r.fp_table) == TP8_TABLE_SHA256,
         "TwoPhase-8 table words")
    (r2, _), traced, busy, by_name = device_busy(
        torch, lambda: struct_run(ops, m, kw, {}))
    need(r2.distinct == TP8_COUNTS[1], "TwoPhase-8 traced run")
    k17_s = sum(v for k, v in by_name.items() if "struct_expand" in k)
    k18_s = sum(v for k, v in by_name.items() if "struct_inv_rows" in k)
    rows = runs["struct_rows"]

    def record(name, shape, err, ms, plain_ms, nbytes):
        rows.setdefault(name, []).append(dict(
            shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))

    from torchtlc.struct.cache import get_backend

    block, n, _ = struct_block(torch, get_backend(m, False), kw,
                               lambda c: int(c.qhead) > 0
                               and int(c.level_n) >= kw["chunk"] * 4)
    struct_kernel_checks(torch, ops, "TwoPhase-8", prog, block, n, record,
                         reps=10)
    print(f"phase 14b TwoPhase-8 (chunk {kw['chunk']}, qcap "
          f"{kw['queue_capacity']}, fp {kw['fp_capacity']}, slab + "
          f"deferred): {r.generated} / {r.distinct} / {r.depth}, table "
          f"sha256 {struct_digest(r.fp_table)[:16]} = the reference's; wall "
          f"{r.wall_s:.3f} s, {r.distinct / r.wall_s:.0f} distinct states/s; "
          f"traced wall {traced:.3f} s, device busy {busy:.3f} s "
          f"({busy / traced:.1%}); K17 {launches['struct_expand']} launches, "
          f"{k17_s * 1e3:.1f} ms on the device; K18 "
          f"{launches['struct_inv_rows']} launches, {k18_s * 1e3:.1f} ms; "
          f"step block: K17 {rows['struct_expand'][-1]['ms']:.3f} ms "
          f"(plain {rows['struct_expand'][-1]['plain_ms']:.1f} ms, bound "
          f"{rows['struct_expand'][-1]['bound_ms']:.4f} ms), K18 "
          f"{rows['struct_inv_rows'][-1]['ms']:.4f} ms (plain "
          f"{rows['struct_inv_rows'][-1]['plain_ms']:.1f} ms) on {card}",
          flush=True)
    return {"struct_tp8": {"launches": launches}}


def struct_masked(text, cfg):
    """A transcript without the lines naming the program and the device,
    with the model directory, dates, walls and rates masked (the form the
    pinned reference transcripts were digested in)."""
    import re

    lines = [ln for ln in text.splitlines()
             if not ln.startswith(("jaxtlc ", "torchtlc ",
                                   "Running breadth-first search"))]
    text = "\n".join(lines).replace(
        os.path.dirname(os.path.abspath(cfg)), "MODEL")
    text = re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", "DATE", text)
    text = re.sub(r"Finished in \d+ms", "Finished in Nms", text)
    return re.sub(r"\([\d,]+ (s|ds)/min\)", r"(N \1/min)", text)


def phase_struct_command(ops, card, runs, tmp):
    """Phase 14c: `python -m torchtlc.cli check` on struct specs - TwoPhase
    Model_1 (a deadlock, exit 12) and with -nodeadlock (exit 0), the
    stale-leader RaftReplication (exit 12), each transcript equal to the
    reference's (its digest pinned); auto-regrow from -fpcap 4096;
    SIGTERM -> exit 75 -> -recover -> exit 0 on TwoPhase-8."""
    two = _struct_geometries()[0][1]
    raft = _struct_geometries()[2][1]
    cfgs = runs["struct_cfgs"]
    out = {}
    for tag, cfg, extra, rc_want in (
            ("deadlock", two, [], 12), ("clean", two, ["-nodeadlock"], 0),
            ("stale", cfgs["stale"], ["-nodeadlock", "-chunk", "256"], 12)):
        rc, text, launches, wall = command_here(ops, [cfg, "-noTool"]
                                                + extra)
        need(rc == rc_want, f"struct command {tag} exited {rc}")
        sha = hashlib.sha256(struct_masked(text, cfg).encode()).hexdigest()
        need(sha == STRUCT_TRANSCRIPT_SHA256[tag],
             f"struct command {tag}: the transcript differs from the "
             "reference's")
        out[f"struct_cmd_{tag}"] = {"launches": launches}
        print(f"phase 14c check {os.path.basename(os.path.dirname(cfg))} "
              f"{' '.join(extra)}: exit {rc}, transcript = the reference's "
              f"({wall:.2f} s)", flush=True)
    rc, text, launches, wall = command_here(
        ops, [raft, "-noTool", "-nodeadlock", "-chunk", "64", "-fpcap",
              "4096"])
    regrow_counts = final_counts(text)
    need(rc == 0 and regrow_counts == RAFT_COUNTS,
         f"struct regrow: exit {rc}, {regrow_counts}")
    need("fp_capacity" in text, "struct regrow: no regrow banner")
    out["struct_cmd_regrow"] = {"launches": launches}
    ck = os.path.join(tmp, "tp8.ckpt")
    base = [cfgs["tp8"], "-noTool", "-nodeadlock", "-chunk",
            str(TP8_KW["chunk"]), "-qcap", str(TP8_KW["queue_capacity"]),
            "-fpcap", str(TP8_KW["fp_capacity"]), "-checkpoint", ck,
            "-checkpointevery", "32"]
    t0 = time.time()
    rc, text = command(base + ["-faults", "sigterm@3"])
    wall_term = time.time() - t0
    need(rc == 75 and "Run interrupted by signal" in text,
         f"TwoPhase-8 SIGTERM run exited {rc}")
    t0 = time.time()
    rc, text2, _ = command_inproc(base + ["-recover"])
    need(rc == 0 and final_counts(text2) == TP8_COUNTS,
         f"TwoPhase-8 -recover exited {rc}, {final_counts(text2)}")
    need("Starting recovery from checkpoint" in text2, "no recovery banner")
    wall_rec = time.time() - t0
    print(f"phase 14c auto-regrow from -fpcap 4096: exit 0, "
          f"{regrow_counts} ({wall:.2f} s); TwoPhase-8 "
          f"sigterm@3 -> exit 75 ({final_counts(text)[:2]} checkpointed, "
          f"{wall_term:.1f} s), -recover -> exit 0, {TP8_COUNTS} "
          f"({wall_rec:.1f} s; the SIGTERM run a subprocess, -recover in "
          f"this process)", flush=True)
    return out



# ---------------------------------------------------------------------------
# phases 15-15c: generic-frontend specs (kernels K19, K20)
# ---------------------------------------------------------------------------

GEN_NAMES = ("RaftElection", "Reconciler", "ServiceMesh")
# the NeverObserves edit of Reconciler.tla (the reference's
# tests/test_gen.py:116): an invariant that the first Observe breaks
NEVER_OBSERVES = ("NeverObserves == \\A self \\in Controllers : "
                  "observed[self] = 0\n====")
# Reconciler scaled as its users scale it: 5 controllers, MaxGen 4 (F 16,
# a 43-bit state in two words, 17 lanes), at full width
R5_CFG = """CONSTANT Controllers = {c1, c2, c3, c4, c5}
CONSTANT MaxGen = 4
SPECIFICATION Spec
INVARIANT TypeOK
INVARIANT AppliedBounded
INVARIANT ObservedBounded
PROPERTY Converges
"""
R5_KW = dict(chunk=1 << 14, queue_capacity=1 << 21, fp_capacity=1 << 22)
R5_COUNTS = (13994838, 2881185, 30)
# GEN_PINS: jaxtlc.gen.engine.make_gen_engine(spec, **GEN_KW) run on the
# CPU for each shipped MC.cfg (the command's default geometry) - counts,
# per-action counts and the SHA-256 of the final table words (little-
# endian uint32); R5_PIN the same at R5_KW (tests/test_torch_gen_engine.py
# re-derives the shipped ones)
GEN_KW = dict(chunk=1024, queue_capacity=1 << 15, fp_capacity=1 << 20)
GEN_PINS = {
    "RaftElection": dict(
        counts=[1223, 492, 8],
        act_gen={"Terminating": 190, "Timeout": 414, "BecomeLeader": 270,
                 "HandleVote": 348},
        act_dist={'Timeout': 155, 'BecomeLeader': 171, 'HandleVote': 165},
        sha=("af99c142455f81de0417d60d4150fc0a"
             "846effc6224477ac78b1352d7cb39d42")),
    "Reconciler": dict(
        counts=[155, 81, 13],
        act_gen={"Bump": 17, "Terminating": 1, "Wake": 40, "Observe": 40,
                 "Apply": 56},
        act_dist={'Bump': 17, 'Wake': 19, 'Observe': 29, 'Apply': 15},
        sha=("a104813e66b5320758ad8f57765d5358"
             "0826c1e3bdf2ea22a466504659531f59")),
    "ServiceMesh": dict(
        counts=[6421, 1444, 17],
        act_gen={"Terminating": 36, "Fail": 1444, "Recover": 1444,
                 "Send": 1216, "Succeed": 608, "Timeout": 608, "Probe": 1064},
        act_dist={"Fail": 385, "Recover": 496, "Send": 220, "Succeed": 74,
                  "Timeout": 268},
        sha=("751e357aee78b3fd8f9d5e1db72da420"
             "d5e8758d0ee90b369e03852fac01af3a")),
}
R5_PIN = dict(
    counts=[13994838, 2881185, 30],
    act_gen={"Bump": 405086, "Terminating": 1, "Wake": 3077075,
             "Observe": 3077075, "Apply": 7435600},
    act_dist={"Bump": 365852, "Wake": 811346, "Observe": 1358642,
              "Apply": 345344},
    sha=("387662821a85aaaba54f58d522b9f76c"
         "d1517eccdca8c5e28a7276c060a5f7df"))
# SHA-256 of the masked -noTool transcripts (struct_masked) of `python -m
# jaxtlc.cli check MC.cfg -noTool -workers cpu` with
# JAXTLC_ARTIFACT_CACHE=off (the default preflight finds nothing here):
# the three shipped models and the NeverObserves edit
GEN_TRANSCRIPT_SHA256 = {
    "RaftElection": ("1e5a653cbc647e15c466da538494b0b9"
                     "e66286bb3986eca4a9526a0d4757113e"),
    "Reconciler": ("e25bed2ddec9c0c3740bd65ac895276e"
                   "5b9aef9fd6cdee16625395e027dd645f"),
    "ServiceMesh": ("eb95808f0342a13225229e8165e6c9f0"
                    "77af699db2a8a10dbff121b27d577277"),
    "never": ("b5d2437fb5e6bbd54872a3b7e33aeb09"
              "0d5b7777a9698eb072a4480b08d8a40b"),
}
# jaxtlc.live.check.check_leads_to_device on the CPU for each Converges
# binding of Reconciler-5, on one capture (jaxtlc.live.capture.
# capture_edges at R5_KW's chunk, 2^22 state rows and table slots: 2,881,185
# states, 13,994,837 distinct edges): every binding holds
R5_VERDICTS = {f"Converges[c{i}]": True for i in range(1, 6)}


def write_gen_models(tmp):
    """The two derived generic models of phases 15-15c in `tmp`: the
    NeverObserves edit of Reconciler (MC.cfg lists it) and Reconciler-5.
    Returns (never MC.cfg, Reconciler-5 MC.cfg)."""
    here = os.path.dirname(os.path.abspath(__file__))
    rec = os.path.join(here, "specs", "Reconciler.toolbox", "Model_1")
    src = open(os.path.join(rec, "Reconciler.tla")).read()
    cfg = open(os.path.join(rec, "MC.cfg")).read()
    out = []
    for name, files in (
            ("never", {"Reconciler.tla": src.replace("====",
                                                     NEVER_OBSERVES, 1),
                       "MC.cfg": cfg + "INVARIANT NeverObserves\n"}),
            ("r5", {"Reconciler.tla": src, "MC.cfg": R5_CFG})):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for fname, text in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        out.append(os.path.join(d, "MC.cfg"))
    return tuple(out)


def gen_run(torch, ops, prog, kw, deadlock=True):
    """The gen engine on the card (kernels built first), its launch counts
    reset just before the run and read just after: (carry, result,
    launches)."""
    from torchtlc.gen.engine import make_gen_engine, result_from_gen_carry

    init_fn, run_fn, _, _ = make_gen_engine(prog.spec, **kw, prog=prog,
                                            check_deadlock=deadlock)
    c = init_fn()
    ops.gen_lib(prog)
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.time()
    c = run_fn(c)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    r = result_from_gen_carry(prog.spec, c, time.time() - t0, run_fn.steps)
    return c, r, launches


def gen_pinned(tag, c, r, pin):
    need([r.generated, r.distinct, r.depth] == pin["counts"],
         f"{tag} counts {(r.generated, r.distinct, r.depth)}")
    need(r.violation == 0 and r.queue_left == 0, f"{tag} verdict")
    need(r.action_generated == pin["act_gen"], f"{tag} per-action generated")
    need(r.action_distinct == pin["act_dist"], f"{tag} per-action distinct")
    need(struct_digest(c.fps.table.cpu().numpy().view("uint32"))
         == pin["sha"], f"{tag} table words")


def gen_block(torch, prog, kw, until):
    """A real popped block of a gen engine run on the card: the rows the
    body pops when until(carry after it) first holds, and their count."""
    from torchtlc.gen.engine import make_gen_engine

    init_fn, run_fn, _, _ = make_gen_engine(prog.spec, **kw, prog=prog)
    c = init_fn()
    while True:
        need((c.qhead < c.level_n or c.next_n > 0) and c.viol == 0,
             "the run ended before the wanted block")
        block = c.queue[c.parity, c.qhead:c.qhead + kw["chunk"]].clone()
        n = min(c.level_n - c.qhead, kw["chunk"])
        c = run_fn.body(c)
        if until(c):
            return block, n


INT_OPS_PER_S = 67e12  # the card's non-tensor peak (float32 rate)


def gen_recorder(rows):
    """record(name, shape, err, ms, plain_ms, bound_ms, bound_by) appending
    one measured row to rows[name]."""
    def record(name, shape, err, ms, plain_ms, bound_ms, bound_by):
        rows.setdefault(name, []).append(dict(
            shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by))
    return record


def gen_bound_ms(nbytes, ops_):
    """(bound ms, bound_by): the larger of bytes over the memory rate and
    integer operations over the non-tensor peak.  The emitted kernels'
    bytes leave their constant table K out: a body reads only the entries
    it indexes, and which those are depends on the data."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops_ / INT_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def inv_rows_bytes(prog, rows, n_fresh):
    """K18's bytes over `rows` claimant rows of which n_fresh are fresh: a
    fresh byte a row, then each fresh claimant's c_idx word and the F
    fields of its row, and the verdict out."""
    return rows + n_fresh * (8 + prog.F * 4) + prog.F * 4 + 16


def gen_kernel_checks(torch, ops, tag, prog, masks, block, n, record,
                      want=None, reps=20):
    """K19 (both invariant modes) and K20 against their plain versions on
    the card, on one popped block: bitwise, and timed when `record` is
    given.  want names the fold entry (invariant k, n_inv = overflow,
    n_inv + 1 = deadlock) that must fire, None for a clean block."""
    def err_of(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0

    for inv in (False, True):
        got = ops.gen_expand(prog, block, n, inv, True)
        ref = prog.expand_plain(block, n, inv, True)
        err = max(err_of(a, b) for a, b in zip(got, ref))
        need(err == 0, f"K19 gen_expand differs from its plain version "
             f"({tag}, inv={inv})")
    fired = [k for k, v in enumerate(got[4].tolist()) if v != 0x7FFFFFFF]
    need(want in fired if want is not None else not fired,
         f"K19 verdict fold ({tag}): entries {fired} fired")
    planes = masks.masks(block)
    err = err_of(planes, masks.masks_plain(block))
    need(err == 0, f"K20 gen_state_masks differs from its plain version "
         f"({tag})")
    if record is not None:
        stats = prog.stats()
        ncand = block.shape[0] * prog.L
        n_valid = int(got[1][0].sum())
        nbytes = (block.shape[0] * prog.W * 4 + ncand * (
            prog.W * 4 + 3 + prog.n_inv + 4) + prog.n_labels * 8
            + (prog.n_inv + 2) * 4)
        record("gen_expand", tag, 0,
               cuda_ms(torch, lambda _: ops.gen_expand(prog, block, n), reps),
               cuda_ms(torch, lambda _: prog.expand_plain(block, n), 2),
               *gen_bound_ms(nbytes, stats["step"]["elements"] * n
                             + stats["invariants"]["elements"] * n_valid))
    return fired


def gen_masks_row(torch, ops, tag, masks, states, record, reps=20):
    """K20 on `states` against its plain version, timed into `record`."""
    from torchtlc.struct import lanes

    planes = ops.gen_state_masks(masks, states)
    err = int((planes.to(torch.int64) - masks.masks_plain(states).to(
        torch.int64)).abs().max())
    need(err == 0, f"K20 gen_state_masks differs from its plain version "
         f"({tag})")
    V = states.shape[0]
    elements = lanes.stats(masks.preds)["elements"]
    record("gen_state_masks", tag, err,
           cuda_ms(torch, lambda _: ops.gen_state_masks(masks, states), reps),
           cuda_ms(torch, lambda _: masks.masks_plain(states), 2),
           *gen_bound_ms(V * masks.W * 4 + V * masks.n_pred, elements * V))
    return planes


def phase_gen(torch, ops, card, runs, tmp):
    """Phase 15: the gen engine on RaftElection, Reconciler and ServiceMesh
    at the command's geometry, each pinned to the reference's CPU run
    (counts, per-action counts, table words); K19 and K20 bitwise against
    their plain versions on a popped block of each, and on the block where
    the NeverObserves edit fails its invariant."""
    from concurrent.futures import ThreadPoolExecutor

    from torchtlc.frontend.model import resolve
    from torchtlc.gen.program import GenProgram
    from torchtlc.live.check import gen_operand_masks

    never, r5 = write_gen_models(tmp)
    here = os.path.dirname(os.path.abspath(__file__))
    cfgs = {name: os.path.join(here, "specs", f"{name}.toolbox", "Model_1",
                               "MC.cfg") for name in GEN_NAMES}
    cfgs.update(never=never, r5=r5)
    specs = {k: resolve(v, workers="gpu").genspec for k, v in cfgs.items()}
    progs = {k: GenProgram(g) for k, g in specs.items()}
    # K20's programs: each spec's first property; and every property of
    # Reconciler-5, whose texts the command builds in phase 15c
    masks, prebuilt = {}, []
    for k, g in specs.items():
        for name, (p, q) in g.properties.items():
            m = gen_operand_masks(g, progs[k].cdc, p, q, title=name)
            masks.setdefault(k, m)
            if k == "r5":
                prebuilt.append(m)
    t0 = time.time()
    with ThreadPoolExecutor(8) as pool:  # one nvcc per text
        list(pool.map(ops.gen_lib, progs.values()))
        # one build per distinct text (two specs may share one)
        texts = {m.text: m for m in list(masks.values()) + prebuilt}
        list(pool.map(ops.gen_masks_lib, texts.values()))
    print(f"phase 15 build: {len(progs)} K19 and {len(texts)} K20 "
          f"libraries with nvcc in {time.time() - t0:.1f} s; lane IR "
          + "; ".join(f"{k} F {p.F} / W {p.W} / L {p.L}, "
                      f"{p.stats()['step']['elements']}+"
                      f"{p.stats()['invariants']['elements']} elements"
                      for k, p in progs.items()), flush=True)
    rows = {}
    record = gen_recorder(rows)

    out = {}
    for name in GEN_NAMES:
        c, r, launches = gen_run(torch, ops, progs[name], GEN_KW)
        gen_pinned(name, c, r, GEN_PINS[name])
        out[f"gen_{name}"] = {"launches": launches}
        print(f"phase 15 {name}: {r.generated} / {r.distinct} / {r.depth}, "
              f"table sha256 {GEN_PINS[name]['sha'][:16]} = the "
              f"reference's, {r.iterations} bodies in {r.wall_s:.3f} s; K19 "
              f"{launches['gen_expand']} launches", flush=True)
        half = GEN_PINS[name]["counts"][2] // 2
        block, n = gen_block(torch, progs[name], GEN_KW,
                             lambda c, h=half: c.level > h)
        gen_kernel_checks(torch, ops, name, progs[name], masks[name], block,
                          n, record if name == "ServiceMesh" else None)
    prog = progs["never"]
    block, n = gen_block(torch, prog, GEN_KW, lambda c: c.viol != 0)
    fired = gen_kernel_checks(torch, ops, "never", prog, masks["never"],
                              block, n, None, want=prog.n_inv - 1)
    print(f"phase 15 K19/K20 vs plain: bitwise equal on a popped block of "
          f"each model; the NeverObserves block ({n} rows) fires fold "
          f"entries {fired}; ServiceMesh step (chunk {GEN_KW['chunk']}): "
          + ", ".join(f"{k} {v[-1]['ms']:.4f} ms (plain "
                      f"{v[-1]['plain_ms']:.3f} ms, bound "
                      f"{v[-1]['bound_ms']:.5f} ms by {v[-1]['bound_by']})"
                      for k, v in rows.items()) + f" on {card}", flush=True)
    out.update(gen_rows=rows, gen_progs=progs, gen_masks=masks,
               gen_cfgs=cfgs)
    return out


def phase_gen_real(torch, ops, card, runs):
    """Phase 15b: Reconciler-5 at full width (chunk 16,384, qcap 2^21, fp
    2^22): the reference's counts and table words; wall, distinct states
    per second and the device busy share (torch.profiler); K19 against
    its plain version on a full-width popped block, timed; K20 on the
    2,881,185 enumerated states (the liveness path's shape), timed."""
    from torchtlc.engine.backend import gen_backend
    from torchtlc.live.capture import enumerate_states

    prog = runs["gen_progs"]["r5"]
    c, r, launches = gen_run(torch, ops, prog, R5_KW)
    need((r.generated, r.distinct, r.depth) == R5_COUNTS,
         f"Reconciler-5 counts {(r.generated, r.distinct, r.depth)}")
    gen_pinned("Reconciler-5", c, r, R5_PIN)
    del c
    (res, traced, busy, by_name) = device_busy(
        torch, lambda: gen_run(torch, ops, prog, R5_KW))
    need(res[1].distinct == R5_COUNTS[1], "Reconciler-5 traced run")
    k19_s = sum(v for k, v in by_name.items() if "gen_expand" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    rows = runs["gen_rows"]
    record = gen_recorder(rows)

    masks = runs["gen_masks"]["r5"]
    block, n = gen_block(torch, prog, R5_KW,
                         lambda c: c.qhead > 0
                         and c.level_n >= R5_KW["chunk"] * 4)
    gen_kernel_checks(torch, ops, "Reconciler-5", prog, masks, block, n,
                      record, reps=10)
    t0 = time.time()
    states = enumerate_states(gen_backend(prog.spec, prog=prog),
                              chunk=R5_KW["chunk"],
                              state_capacity=R5_KW["fp_capacity"],
                              fp_capacity=R5_KW["fp_capacity"])
    torch.cuda.synchronize()
    t_enum = time.time() - t0
    need(states.shape[0] == R5_COUNTS[1], "Reconciler-5 enumeration")
    gen_masks_row(torch, ops, "Reconciler-5 states", masks, states, record)
    k19 = rows["gen_expand"][-1]
    k20 = rows["gen_state_masks"][-1]
    print(f"phase 15b Reconciler-5 (chunk {R5_KW['chunk']}, qcap "
          f"{R5_KW['queue_capacity']}, fp {R5_KW['fp_capacity']}): "
          f"{r.generated} / {r.distinct} / {r.depth}, table sha256 "
          f"{R5_PIN['sha'][:16]} = the reference's; wall {r.wall_s:.3f} s, "
          f"{r.distinct / r.wall_s:.0f} distinct states/s, {r.iterations} "
          f"bodies; traced wall {traced:.3f} s, device busy {busy:.3f} s "
          f"({busy / traced:.1%}); top device items "
          + ", ".join(f"{k[:40]} {v * 1e3:.1f} ms" for k, v in top)
          + f"; K19 {launches['gen_expand']} launches, {k19_s * 1e3:.1f} ms "
          f"on the device; step block ({n} rows): K19 {k19['ms']:.4f} ms "
          f"(plain {k19['plain_ms']:.1f} ms, bound {k19['bound_ms']:.5f} ms "
          f"by {k19['bound_by']}); enumeration {t_enum:.2f} s; K20 on "
          f"{states.shape[0]} states {k20['ms']:.4f} ms (plain "
          f"{k20['plain_ms']:.1f} ms, bound {k20['bound_ms']:.5f} ms by "
          f"{k20['bound_by']}) on {card}", flush=True)
    return {"gen_r5": {"launches": launches}}


def phase_gen_command(ops, card, runs, tmp):
    """Phase 15c: `python -m torchtlc.cli check` on generic specs (in this
    process): the three shipped MC.cfgs (exit 13, 0, 13: transcripts and
    lassos equal to the reference's, their digests pinned), the
    NeverObserves edit (exit 12 with the host oracle's trace, digest
    pinned), Reconciler-5 with its five Converges properties on the device
    liveness path (K14, K20, K16 at 2,881,185 states; the verdicts of the
    reference's check_leads_to_device)."""
    cfgs = runs["gen_cfgs"]
    out = {}
    for tag, rc_want in (("RaftElection", 13), ("Reconciler", 0),
                         ("ServiceMesh", 13), ("never", 12)):
        rc, text, launches, wall = command_here(ops, [cfgs[tag], "-noTool"])
        need(rc == rc_want, f"gen command {tag} exited {rc}")
        sha = hashlib.sha256(struct_masked(text, cfgs[tag]).encode()
                             ).hexdigest()
        need(sha == GEN_TRANSCRIPT_SHA256[tag],
             f"gen command {tag}: the transcript differs from the "
             "reference's")
        out[f"gen_cmd_{tag}"] = {"launches": launches}
        lasso = sum(1 for x in liveness_text(text) if x.startswith("State "))
        print(f"phase 15c check {tag}: exit {rc}, transcript = the "
              f"reference's ({lasso} lasso or trace states, {wall:.2f} s)",
              flush=True)
    rc, text, launches, wall = command_here(
        ops, [cfgs["r5"], "-noTool", "-chunk", str(R5_KW["chunk"]), "-qcap",
              str(R5_KW["queue_capacity"]), "-fpcap",
              str(R5_KW["fp_capacity"])])
    need(rc == 0, f"Reconciler-5 command exited {rc}")
    need(final_counts(text) == R5_COUNTS, "Reconciler-5 command counts")
    need("(device liveness engine)" in text,
         "the device liveness path did not run")
    verdicts = {}
    for line in text.splitlines():
        m = line.startswith("Temporal property ") and line.split()
        if m and line.endswith("(fairness: wf_next)."):
            verdicts[m[2]] = m[3] == "holds"
    need(verdicts == R5_VERDICTS, f"Reconciler-5 verdicts {verdicts}")
    need(launches["gen_state_masks"] == len(R5_VERDICTS),
         f"K20 launches {launches['gen_state_masks']}")
    out["gen_cmd_r5"] = {"launches": launches}
    print(f"phase 15c Reconciler-5 with PROPERTY Converges: exit 0, "
          f"{R5_COUNTS}, {len(verdicts)} properties hold on the device path "
          f"= the reference's verdicts; K19 {launches['gen_expand']}, K14 "
          f"{launches['edge_capture']}, K20 {launches['gen_state_masks']}, "
          f"K16 {launches['survive_sweep']} launches; {wall:.1f} s on {card}",
          flush=True)
    return out

# ---------------------------------------------------------------------------
# phases 16-16c: the sharded engine over the emitted backends (K21, K18)
# ---------------------------------------------------------------------------

SHARD16_D = 4
# jaxtlc.engine.sharded.make_sharded_engine on the CPU (4 virtual devices,
# GEN_KW) over the NeverObserves edit: its violation code, counts and
# state in the default and pipelined modes (the single-device run's too)
# and in the slab deferred mode, where the owner's received-rows check
# reports the highest violating lane
NEVER16_PIN = dict(code=103, counts=[13, 10, 4],
                   state=dict(first=[1, 1, 0, 0, 0, 0, 1],
                              deferred=[1, 0, 1, 0, 0, 1, 0]))
# phase 16b: 4,096 rows a shard on 4 shards (16,384 in all, the single-
# device chunk of 14b and 15b); per-shard table and queue sized so that no
# regrow fires (the busiest shard of either stays under 0.45 of its table)
TP8_SHARDED_KW = dict(chunk=1 << 12, queue_capacity=1 << 19,
                      fp_capacity=1 << 21)
R5_SHARDED_KW = dict(chunk=1 << 12, queue_capacity=1 << 19,
                     fp_capacity=1 << 21)
# phase 16c: (exit code, SHA-256 of the masked -noTool transcript,
# struct_masked) of `python -m jaxtlc.cli check MC.cfg -noTool -workers cpu
# <flags>` with JAXTLC_ARTIFACT_CACHE=off - the reference's CPU runs, the
# default preflight on
SHARD16_COMMANDS = {
    "gen_sharded": ("RaftElection", ["-sharded", "4"]),
    "gen_sharded_pipe": ("ServiceMesh", ["-sharded", "4", "-pipeline"]),
    "gen_ckpt": ("Reconciler", ["-checkpoint", "CK1", "-checkpointevery",
                                "2", "-faults", "sigterm@3"]),
    "gen_ckpt_recover": ("Reconciler", ["-checkpoint", "CK1",
                                        "-checkpointevery", "2",
                                        "-recover"]),
    "gen_ckpt_pipe": ("Reconciler", ["-checkpoint", "CK2",
                                     "-checkpointevery", "2", "-faults",
                                     "sigterm@3", "-pipeline"]),
    "gen_ckpt_pipe_recover": ("Reconciler", ["-checkpoint", "CK2",
                                             "-checkpointevery", "2",
                                             "-recover", "-pipeline"]),
    "struct_sharded": ("TwoPhase", ["-sharded", "4"]),
    "struct_sharded_regrow": ("TwoPhase", ["-sharded", "4", "-nodeadlock",
                                           "-fpcap", "64", "-chunk", "16"]),
    "gen_pipeline_alone": ("RaftElection", ["-pipeline"]),
}
SHARD16_TRANSCRIPT = {
    "gen_sharded": (13, "1e5a653cbc647e15c466da538494b0b9"
                        "e66286bb3986eca4a9526a0d4757113e"),
    "gen_sharded_pipe": (13, "eb95808f0342a13225229e8165e6c9f0"
                             "77af699db2a8a10dbff121b27d577277"),
    "gen_ckpt": (0, "fc2de2e4afdb8d6cf824dae853b83e4e"
                    "aa85636fcb97e2a25f144972d4aa7a66"),
    "gen_ckpt_recover": (0, "fc2de2e4afdb8d6cf824dae853b83e4e"
                            "aa85636fcb97e2a25f144972d4aa7a66"),
    "gen_ckpt_pipe": (0, "fc2de2e4afdb8d6cf824dae853b83e4e"
                         "aa85636fcb97e2a25f144972d4aa7a66"),
    "gen_ckpt_pipe_recover": (0, "fc2de2e4afdb8d6cf824dae853b83e4e"
                                 "aa85636fcb97e2a25f144972d4aa7a66"),
    "struct_sharded": (12, "0bb79f45c02f993ec7b7e2f58aace7e3"
                           "2b969172bf1ea503b458c594d3651d84"),
    "struct_sharded_regrow": (0, "826af8c71b3bca8997739c9ecb59157d"
                                 "f19ff59708796075a26241ceb7ba01e2"),
    "gen_pipeline_alone": (13, "1e5a653cbc647e15c466da538494b0b9"
                               "e66286bb3986eca4a9526a0d4757113e"),
}


def shard16_models(ops, tmp):
    """The shipped emitted models of phase 16 and the full-width ones of
    16b: {name: (kind, backend, program, single-device geometry, pin)},
    every emitted library built first (one nvcc per text, in parallel;
    each holds K21 and K18 beside K17 or K19)."""
    from concurrent.futures import ThreadPoolExecutor

    from torchtlc.engine.backend import gen_backend
    from torchtlc.frontend.model import resolve
    from torchtlc.gen.program import GenProgram
    from torchtlc.struct.cache import get_backend
    from torchtlc.struct.loader import load

    d = os.path.join(tmp, "p16")
    os.makedirs(d, exist_ok=True)
    _, tp8 = write_struct_models(d)
    never, r5 = write_gen_models(d)
    models = {}
    for name, cfg, kw in _struct_geometries():
        backend = get_backend(load(cfg), False)
        models[name] = ("struct", backend, backend.kernels.prog, kw,
                        STRUCT_PINS[name])
    backend = get_backend(load(tp8), False)
    models["TwoPhase-8"] = ("struct", backend, backend.kernels.prog, TP8_KW,
                            dict(counts=list(TP8_COUNTS)))
    here = os.path.dirname(os.path.abspath(__file__))
    for name, cfg, kw, pin in [
            (n, os.path.join(here, "specs", f"{n}.toolbox", "Model_1",
                             "MC.cfg"), GEN_KW, GEN_PINS[n])
            for n in GEN_NAMES] + [("Reconciler-5", r5, R5_KW, R5_PIN),
                                   ("never", never, GEN_KW, NEVER16_PIN)]:
        prog = GenProgram(resolve(cfg, workers="gpu").genspec)
        models[name] = ("gen", gen_backend(prog.spec, prog=prog), prog, kw,
                        pin)
    t0 = time.time()
    with ThreadPoolExecutor(len(models)) as pool:
        list(pool.map(lambda m: ops.emitted_lib(m[2]), models.values()))
    print(f"phase 16 build: {len(models)} emitted libraries (K17 or K19, "
          f"K18, K21) in {time.time() - t0:.1f} s", flush=True)
    return models


def single_table_keys(torch, ops, kind, backend, prog, kw):
    """The single-device run of a model at `kw` (check_struct or the gen
    engine, default modes): (result, its table's sorted fingerprint keys,
    table digest)."""
    if kind == "struct":
        from torchtlc.engine.bfs import make_backend_engine, result_from_carry

        init_fn, run_fn, _ = make_backend_engine(
            backend, kw["chunk"], kw["queue_capacity"], kw["fp_capacity"])
        c = init_fn()
        torch.cuda.synchronize()
        t0 = time.time()
        c = run_fn(c)
        torch.cuda.synchronize()
        r = result_from_carry(c, time.time() - t0, iterations=run_fn.steps,
                              fp_capacity=kw["fp_capacity"],
                              labels=backend.labels,
                              viol_names=backend.viol_names)
    else:
        c, r, _ = gen_run(torch, ops, prog, kw)
    table = c.fps.table
    return (r, _stored_keys(torch, table),
            struct_digest(table.cpu().numpy().view("uint32")))


def shard16_run(torch, ops, backend, D, kw, **modes):
    """The sharded engine over an emitted backend, its launch counts reset
    just before the run and read just after: (carry, result, launches,
    bodies)."""
    from torchtlc.engine import sharded as ts

    init_fn, run_fn = ts.make_sharded_engine(None, ts.ShardMesh(D),
                                             backend=backend, **kw, **modes)
    carry = init_fn()
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.time()
    carry = run_fn(carry)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    r = ts.result_from_shard_carry(carry, wall, iterations=run_fn.steps,
                                   labels=backend.labels,
                                   viol_names=backend.viol_names,
                                   fp_capacity_total=D * kw["fp_capacity"])
    return carry, r, launches, run_fn.steps


def shard16_union(torch, tag, carry, ref_keys):
    """Every stored fingerprint on its owner shard, and the union of the
    shard tables equal to the single-device table's set."""
    D = carry.table.shape[0]
    keys = []
    for d in range(D):
        k = _stored_keys(torch, carry.table[d])
        need(bool(((k >> 32) & (D - 1) == d).all()),
             f"{tag}: a fingerprint off its owner shard {d}")
        keys.append(k)
    union = torch.sort(torch.cat(keys)).values
    need(union.shape == ref_keys.shape and bool((union == ref_keys).all()),
         f"{tag}: the shard tables' fingerprints differ from the single-"
         "device table's")


def shard16_block(torch, backend, D, kw, full=False, viol=False):
    """A carry of a deferred sharded run on the card and the pops of its
    next body: the first body where every shard pops a whole chunk (full),
    the body that finds the run's violation (viol), else the body of the
    run whose pops reach the most shards (then the most rows).  Returns
    (carry, bundle, npop, expand half)."""
    from torchtlc.engine import sharded as ts

    init_fn, run_fn = ts.make_sharded_engine(
        None, ts.ShardMesh(D), backend=backend, **kw, segment=1,
        deferred=True)

    def pops(h):
        return [min(kw["chunk"], min(e, t) - q)
                for q, t, e in zip(h.qhead, h.qtail, h.level_end)]

    target = None
    if not full:  # a first pass picks the body
        c, i, best = init_fn(), 0, (0, 0)
        while ts.read_bundle(c).cont:
            n = pops(ts.read_bundle(c))
            score = (sum(x > 0 for x in n), sum(n))
            if score > best and not viol:
                best, target = score, i
            c = run_fn(c)
            if viol and ts.read_bundle(c).viol != 0:
                target = i
                break
            i += 1
        need(target is not None, "the sharded run popped nothing" if not
             viol else "the sharded run found no violation")
    c, i = init_fn(), 0
    while True:
        h = ts.read_bundle(c)
        need(h.cont, "the sharded run ended before the wanted block")
        n = pops(h)
        if (min(n) == kw["chunk"]) if full else i == target:
            npop = torch.tensor(n, dtype=torch.int64, device=c.queue.device)
            return c, h, npop, run_fn.halves[0]
        c = run_fn(c)
        i += 1


def shard16_kernel_checks(torch, ops, tag, prog, backend, D, kw, record,
                          full=False, reps=20, want_viol=0):
    """K21 (both invariant modes, with the popped block) and K18 on one
    owner's received rows bitwise against their plain versions on the
    card; timed into `record` when given.  With want_viol (a violation
    code) the block is the body that finds the run's violation: K21's
    immediate invariant rows flag a lane, and K18 on the received rows of
    an owner that holds the violating claimant reports that code with
    action -1.  Returns (popped rows, fresh claimants checked)."""
    from torchtlc.engine.fpset import FPSet, fpset_insert_dedup

    def err_of(a, b):
        if a is None:
            return 0
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0

    c, h, npop, expand_half = shard16_block(torch, backend, D, kw, full,
                                            viol=bool(want_viol))
    need(bool((npop > 0).any()), f"an empty block ({tag})")
    ck = kw["chunk"]
    for deferred in (False, True):
        got = ops.emitted_expand_sharded(prog, c.queue, c.qhead, npop, ck,
                                         deferred, True)
        ref = prog.expand_sharded_plain(c.queue, c.qhead, npop, ck,
                                        deferred, True)
        err = max(err_of(a, b) for a, b in zip(got, ref))
        need(err == 0, f"K21 emitted_expand_sharded differs from its plain "
             f"version ({tag}, deferred={deferred})")
        bad = int(got[1][3:].sum())
        need(bad == 0 if deferred or not want_viol else bad > 0,
             f"K21 invariant rows ({tag}, deferred={deferred}): {bad} "
             "failing lanes")
    popped = int(npop.sum())
    if record is not None:
        stats = prog.stats()
        ncand = D * ck * prog.L
        got = ops.emitted_expand_sharded(prog, c.queue, c.qhead, npop, ck)
        n_valid = int(got[1][0].sum())
        nbytes = (popped * prog.F * 4 + ncand * (
            prog.W * 4 + prog.F * 4 + 3 + prog.n_inv + 4)
            + D * prog.n_labels * 8)
        record("emitted_expand_sharded", tag, 0,
               cuda_ms(torch, lambda _: ops.emitted_expand_sharded(
                   prog, c.queue, c.qhead, npop, ck), reps),
               cuda_ms(torch, lambda _: prog.expand_sharded_plain(
                   c.queue, c.qhead, npop, ck), 2),
               *gen_bound_ms(nbytes, stats["step"]["elements"] * popped
                             + stats["invariants"]["elements"] * n_valid))
    # K18 on the received rows of the owner with the most fresh claimants
    ex = expand_half(c, h)
    DB = ex.xvalid.shape[1] * ex.xvalid.shape[2]
    claims = []
    for o in range(D):
        _, fresh, c_idx, _, _ = fpset_insert_dedup(
            FPSet(c.table[o].clone()), ex.xlo[o].view(DB),
            ex.xhi[o].view(DB), ex.xvalid[o].view(DB), probe_width=0,
            sort_free=False)
        claims.append((int(fresh.sum()), o, fresh, c_idx))
    if want_viol:  # the owners whose fresh claimants violate
        claims = [x for x in claims if int(prog.inv_rows_plain(
            ex.xrows[x[1]].view(DB, prog.F), x[2], x[3], None, DB)[0])]
        need(claims, f"no owner's received rows violate ({tag})")
    _, o, fresh, c_idx = max(claims, key=lambda x: (x[0], -x[1]))
    rows_in = ex.xrows[o].view(DB, prog.F)
    got = ops.struct_inv_rows(prog, rows_in, fresh, c_idx, None, DB)
    ref = prog.inv_rows_plain(rows_in, fresh, c_idx, None, DB)
    err = max(err_of(a, b) for a, b in zip(got, ref))
    need(err == 0, f"K18 on received rows differs from its plain version "
         f"({tag})")
    need(int(got[0]) == want_viol and int(got[2]) == -1,
         f"K18 verdict {int(got[0])}, action {int(got[2])} ({tag})")
    n_fresh = int(fresh.sum())
    need(n_fresh > 0, f"no fresh claimant among the received rows ({tag})")
    if record is not None:
        record("struct_inv_rows/received", tag, err,
               cuda_ms(torch, lambda _: ops.struct_inv_rows(
                   prog, rows_in, fresh, c_idx, None, DB), reps),
               cuda_ms(torch, lambda _: prog.inv_rows_plain(
                   rows_in, fresh, c_idx, None, DB), 2),
               *gen_bound_ms(inv_rows_bytes(prog, DB, n_fresh),
                             prog.stats()["invariants"]["elements"]
                             * n_fresh))
    return popped, n_fresh


def shard16_never(torch, ops, models, D, out, lines):
    """Phase 16's violating model, the NeverObserves edit of Reconciler, at
    D shards in the default, pipelined and slab deferred modes (where K18
    on the received rows finds the violation): the violation code and
    counts of the single-device run and the reference's state; K21 and
    K18 bitwise against their plain versions on the body that finds it."""
    _, backend, prog, kw, pin = models["never"]
    _, r1, _ = gen_run(torch, ops, prog, kw)
    need(r1.violation == pin["code"]
         and [int(x) for x in r1.violation_state] == pin["state"]["first"],
         f"never: single-device verdict {r1.violation}")
    for mode, modes in (("default", {}), ("pipelined", dict(pipeline=True)),
                        ("deferred", dict(sort_free=True, deferred=True))):
        tag = f"never D{D} {mode}"
        carry, r, launches, bodies = shard16_run(torch, ops, backend, D, kw,
                                                 **modes)
        state = pin["state"]["deferred" if mode == "deferred" else "first"]
        need(r.violation == r1.violation
             and [r.generated, r.distinct, r.depth] == pin["counts"]
             and [int(x) for x in r.violation_state] == state,
             f"{tag}: verdict {r.violation}, counts "
             f"{(r.generated, r.distinct, r.depth)}, state "
             f"{[int(x) for x in r.violation_state]}")
        if mode == "deferred":
            need(launches["struct_inv_rows"] > 0,
                 f"{tag}: K18 never ran on received rows")
        out[f"shard16_never_D{D}_{mode}"] = {"launches": launches}
        lines.append(f"never D{D} {mode} {bodies} bodies {r.wall_s:.3f} s")
        del carry
    popped, fresh = shard16_kernel_checks(torch, ops, "never", prog, backend,
                                          D, kw, None, want_viol=pin["code"])
    print(f"phase 16 never: violation {pin['code']} at "
          f"{tuple(pin['counts'])} on {D} shards in every mode, the state the "
          f"single-device run's (the reference's deferred one in the "
          f"deferred mode); K21 bitwise = plain on the violating body "
          f"({popped} rows), K18 on the violating owner's received rows "
          f"({fresh} fresh claimants) bitwise = plain, code "
          f"{pin['code']}, action -1", flush=True)


def phase_shard16(torch, ops, card, runs, tmp):
    """Phase 16: the sharded engine over the six shipped emitted models -
    TwoPhase Model_1 and Model_sym, RaftReplication (struct backends: K21
    over the struct step, K18), RaftElection, Reconciler and ServiceMesh
    (generic backends: K21 over the gen step, K18) - at 4 shards in the
    default modes, pipelined and in the deferred slab modes (K18 on every
    owner's received rows), the generic ones also on 1 shard (the
    -checkpoint path's mesh): the reference's counts, per-action generated
    counts and depth; every shard's table fingerprints on their owner and
    their union the single-device run's table set (whose words are the
    reference's, phases 14 and 15); K21 and K18 on received rows bitwise
    against their plain versions on a popped 4-shard block of each."""
    models = shard16_models(ops, tmp)
    rows = {}
    record = gen_recorder(rows)
    out, lines = {}, []
    D = SHARD16_D
    for name in [n for n, _, _ in _struct_geometries()] + list(GEN_NAMES):
        kind, backend, prog, kw, pin = models[name]
        r1, ref_keys, sha = single_table_keys(torch, ops, kind, backend,
                                              prog, kw)
        need(sha == pin["sha"], f"{name}: the single-device table words")
        cases = [(D, "default", {}), (D, "pipelined", dict(pipeline=True)),
                 (D, "deferred", dict(sort_free=True, deferred=True))]
        if kind == "gen":
            cases += [(1, "default", {}), (1, "pipelined",
                                           dict(pipeline=True))]
        for n_sh, mode, modes in cases:
            tag = f"{name} D{n_sh} {mode}"
            carry, r, launches, bodies = shard16_run(torch, ops, backend,
                                                     n_sh, kw, **modes)
            need([r.generated, r.distinct, r.depth] == pin["counts"],
                 f"{tag} counts {(r.generated, r.distinct, r.depth)}")
            need(r.violation == 0 and r.queue_left == 0, f"{tag} verdict")
            need(r.action_generated == pin["act_gen"],
                 f"{tag} per-action generated")
            shard16_union(torch, tag, carry, ref_keys)
            need(launches["emitted_expand_sharded"] == bodies,
                 f"{tag}: K21 launches {launches['emitted_expand_sharded']}"
                 f" != bodies {bodies}")
            if mode == "deferred":
                need(launches["struct_inv_rows"] > 0,
                     f"{tag}: K18 never ran on received rows")
            out[f"shard16_{name}_D{n_sh}_{mode}"] = {"launches": launches}
            lines.append(f"{name} D{n_sh} {mode} {bodies} bodies "
                         f"{r.wall_s:.3f} s")
            del carry
        popped, fresh = shard16_kernel_checks(
            torch, ops, name, prog, backend, D, kw,
            record if name in ("RaftReplication/Model_1", "ServiceMesh")
            else None)
        print(f"phase 16 {name}: {tuple(pin['counts'])} and the per-action "
              f"generated counts at 1/4 shards in every mode, the shard "
              f"tables' union = the single-device table ({ref_keys.shape[0]}"
              f" fingerprints, sha256 {sha[:16]} = the reference's); K21 "
              f"bitwise = plain on a 4-shard block ({popped} rows), K18 on "
              f"an owner's received rows ({fresh} fresh claimants) bitwise "
              f"= plain", flush=True)
    shard16_never(torch, ops, models, D, out, lines)
    print("phase 16 walls: " + "; ".join(lines) + " ; step times: "
          + ", ".join(f"{k} {v[-1]['shape']} {v[-1]['ms']:.4f} ms (plain "
                      f"{v[-1]['plain_ms']:.3f} ms, bound "
                      f"{v[-1]['bound_ms']:.5f} ms by {v[-1]['bound_by']})"
                      for k, v in rows.items()) + f" on {card}", flush=True)
    out.update(shard16_rows=rows, shard16_models=models)
    return out


def phase_shard16_real(torch, ops, card, runs):
    """Phase 16b: TwoPhase-8 and Reconciler-5 on 4 shards at 4,096 rows a
    shard (the 16,384 rows of 14b / 15b in all) in the default modes,
    which resolve to the slab dedup and deferred invariants there (K18 on
    every owner's received rows): the reference's counts, the union of
    the shard tables equal to the single-device table set; the sharded
    and single-device walls in turns (single, sharded, sharded, single),
    bodies, launches a body, the device busy share of a sharded run
    (torch.profiler); K21 and K18 on received rows timed on a full-width
    block against their bound and plain versions."""
    models = runs["shard16_models"]
    rows = runs["shard16_rows"]
    record = gen_recorder(rows)
    out = {}
    D = SHARD16_D
    for name, skw, counts in (("TwoPhase-8", TP8_SHARDED_KW, TP8_COUNTS),
                              ("Reconciler-5", R5_SHARDED_KW, R5_COUNTS)):
        kind, backend, prog, kw, pin = models[name]
        walls = {"single": [], "sharded": []}
        ref_keys = None
        for which in ("single", "sharded", "sharded", "single"):
            if which == "single":
                r, keys, _ = single_table_keys(torch, ops, kind, backend,
                                               prog, kw)
                if ref_keys is None:
                    ref_keys = keys
                del keys
                walls["single"].append((r.wall_s, r.iterations))
            else:
                carry, r, launches, bodies = shard16_run(torch, ops, backend,
                                                         D, skw)
                if not walls["sharded"]:
                    shard16_union(torch, name, carry, ref_keys)
                    out[f"shard16b_{name}"] = {"launches": launches}
                    per_body = _per_body(launches, bodies)
                    k21, k18 = (launches["emitted_expand_sharded"],
                                launches["struct_inv_rows"])
                walls["sharded"].append((r.wall_s, bodies))
                del carry
            need((r.generated, r.distinct, r.depth) == counts,
                 f"{name} {which} counts {(r.generated, r.distinct, r.depth)}")
            need(r.violation == 0 and r.queue_left == 0,
                 f"{name} {which} verdict")
            torch.cuda.empty_cache()
        t_prof = time.time()
        (res, traced, busy, by_name) = device_busy(
            torch, lambda: shard16_run(torch, ops, backend, D, skw))
        t_prof = time.time() - t_prof
        need(res[1].distinct == counts[1], f"{name} traced sharded run")
        del res
        torch.cuda.empty_cache()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        popped, fresh = shard16_kernel_checks(
            torch, ops, f"{name} full width", prog, backend, D, skw, record,
            full=True, reps=10)
        a = rows["emitted_expand_sharded"][-1]
        b = rows["struct_inv_rows/received"][-1]
        print(f"phase 16b {name} on {D} shards (chunk {skw['chunk']}, qcap "
              f"{skw['queue_capacity']}, fp {skw['fp_capacity']} per shard, "
              f"slab + deferred): {counts}, the shard tables' union = the "
              f"single-device table ({ref_keys.shape[0]} fingerprints); "
              f"walls in turns (s, bodies or steps): single "
              f"{[(round(w, 4), n) for w, n in walls['single']]}, sharded "
              f"{[(round(w, 4), n) for w, n in walls['sharded']]}; "
              f"{per_body:.1f} launches a body (K21 {k21}, K18 {k18}); "
              f"traced wall {traced:.3f} s, device busy {busy:.3f} s "
              f"({busy / traced:.1%}; the profiled call {t_prof:.1f} s); "
              "top device items "
              + ", ".join(f"{k[:40]} {v * 1e3:.1f} ms" for k, v in top)
              + f"; full-width block ({popped} rows, {fresh} fresh "
              f"received claimants): K21 {a['ms']:.4f} ms (plain "
              f"{a['plain_ms']:.1f} ms, bound {a['bound_ms']:.5f} ms by "
              f"{a['bound_by']}), K18 {b['ms']:.4f} ms (plain "
              f"{b['plain_ms']:.1f} ms, bound {b['bound_ms']:.5f} ms by "
              f"{b['bound_by']}) on {card}", flush=True)
    return out


def phase_shard16_command(ops, card, runs, tmp):
    """Phase 16c: `python -m torchtlc.cli check` through the sharded engine
    over emitted backends, in this process: a generic spec with -sharded
    4, -sharded 4 -pipeline, -checkpoint with -faults sigterm@3 (the
    reference's generic checkpoint path has no supervisor, so the run
    completes) then -recover, unpipelined and pipelined, -pipeline alone
    (the gen engine, as the reference); TwoPhase with -sharded 4 (a
    deadlock, exit 12) and with a small -fpcap (table regrows on the
    shards) - each exit code and transcript equal to the reference's
    (digests pinned); the default transcript shows the preflight warning;
    and Reconciler-5 with PROPERTY Converges under -sharded 4 (the device
    liveness path, its fixpoint over 4 edge slices): the reference's
    counts and verdicts."""
    here = os.path.dirname(os.path.abspath(__file__))
    out, lines = {}, []
    cks = {"CK1": os.path.join(tmp, "g16a.ckpt"),
           "CK2": os.path.join(tmp, "g16b.ckpt")}
    for tag, (spec, extra) in SHARD16_COMMANDS.items():
        cfg = os.path.join(here, "specs", f"{spec}.toolbox", "Model_1",
                           "MC.cfg")
        argv = [cfg, "-noTool"] + [cks.get(x, x) for x in extra]
        rc, text, launches, wall = command_here(ops, argv)
        rc_want, sha_want = SHARD16_TRANSCRIPT[tag]
        need(rc == rc_want, f"command {tag} exited {rc}")
        sha = hashlib.sha256(struct_masked(text, cfg).encode()).hexdigest()
        need(sha == sha_want, f"command {tag}: the transcript differs from "
             "the reference's")
        if tag.startswith("struct"):
            need("Preflight warning [spec/unreduced-symmetry]" in text,
                 f"command {tag}: no preflight warning")
        if ("-sharded" in extra or "-checkpoint" in extra) \
                and "-recover" not in extra:  # a resumed run may be done
            need(launches["emitted_expand_sharded"] > 0,
                 f"command {tag}: K21 never ran")
        if tag == "struct_sharded_regrow":
            need("regrowing fp_capacity" in text,
                 "the sharded struct command did not regrow")
        out[f"shard16_cmd_{tag}"] = {"launches": launches}
        lines.append(f"{tag} exit {rc} ({wall:.2f} s)")
    r5 = os.path.join(tmp, "p16", "r5", "MC.cfg")
    rc, text, launches, wall = command_here(
        ops, [r5, "-noTool", "-sharded", "4", "-chunk",
              str(R5_SHARDED_KW["chunk"]), "-qcap",
              str(R5_SHARDED_KW["queue_capacity"]), "-fpcap",
              str(1 << 22)])
    need(rc == 0, f"Reconciler-5 -sharded 4 exited {rc}")
    need(final_counts(text) == R5_COUNTS,
         f"Reconciler-5 -sharded 4 counts {final_counts(text)}")
    need("(device liveness engine)" in text,
         "the device liveness path did not run")
    verdicts = {}
    for line in text.splitlines():
        m = line.startswith("Temporal property ") and line.split()
        if m and line.endswith("(fairness: wf_next)."):
            verdicts[m[2]] = m[3] == "holds"
    need(verdicts == R5_VERDICTS, f"Reconciler-5 -sharded 4 verdicts "
         f"{verdicts}")
    need(launches["survive_sweep"] > 0, "K16 never ran")
    out["shard16_cmd_r5"] = {"launches": launches}
    print("phase 16c commands, transcripts = the reference's: "
          + "; ".join(lines) + f"; Reconciler-5 -sharded 4 with PROPERTY "
          f"Converges: exit 0, {R5_COUNTS}, {len(verdicts)} properties hold "
          f"on the device path (fixpoint over 4 edge slices) = the "
          f"reference's verdicts; K21 {launches['emitted_expand_sharded']}, "
          f"K18 {launches['struct_inv_rows']}, K19 "
          f"{launches['gen_expand']}, K14 {launches['edge_capture']}, K16 "
          f"{launches['survive_sweep']} launches; {wall:.1f} s on {card}",
          flush=True)
    return out



# ---------------------------------------------------------------------------
# phases 17-17d: struct -coverage behind kernel K22, the pipelined and the
# spilling struct runs, -phase-timing and the slice's commands
# ---------------------------------------------------------------------------

# SHA-256 of the site vector ("key count" lines in site-table order) and
# the table's size, of the reference's covered check_struct runs on the
# CPU at phase 14's geometries (the same in the sorted immediate and in the
# slab deferred modes with obs_slots=64)
STRUCT_COV_PINS = {
    "TwoPhase/Model_1": ("03f433214a05fce7fedc415ac3e9a731"
                         "f82edc74a344d7a0fb1441d65d478ee0", 37),
    "TwoPhase/Model_sym": ("3cc0ca7112f404a6521681a5fdf8d744"
                           "21e62e5b47676de4ef4a25a247f2bf78", 37),
    "RaftReplication/Model_1": ("582597a73f70f005c5dd5ff832255d41"
                                "4d18e3f35ceee06928dba82f1d5d1140", 36),
}
# the same for TwoPhase-8 at TP8_KW in the default modes
TP8_COV_SHA256 = ("c054b0d7bfd318a01bd36604c48d4451"
                  "0b83f1eae63030eddc6bb3a1a53ba8b6")
# the table words of the reference's pipelined TwoPhase-8 run at TP8_KW
TP8_PIPE_TABLE_SHA256 = ("fb0e5d787dc068a2cee75f3e39f66371"
                         "9156419307d658f1febb952c3d8a0e39")
# phase 17c's spilling run: a table that cannot hold the 1,745,408 states
TP8_SPILL_FPCAP = 1 << 20
# (exit code, SHA-256 of the cmd17_masked transcript) of `python -m
# jaxtlc.cli check MC.cfg -noTool -workers cpu <flags>` with
# JAXTLC_ARTIFACT_CACHE=off, the checkpoint family in a temporary
# directory (CK) - the reference's CPU runs
CMD17_SMALL = ["-nodeadlock", "-chunk", "16", "-qcap", "256", "-fpcap", "64",
               "-faults", "alloc_fail@1"]
CMD17 = {
    "denied": ("Model_1", CMD17_SMALL + ["-checkpoint", "CK/d"]),
    "denied_sharded": ("Model_1", CMD17_SMALL + ["-checkpoint", "CK/s",
                                                 "-sharded", "4"]),
    "coverage": ("Model_1", ["-nodeadlock", "-coverage"]),
    "pipe_term": ("Model_sym", ["-nodeadlock", "-chunk", "16", "-pipeline",
                                "-checkpoint", "CK/p", "-checkpointevery",
                                "4", "-faults", "sigterm@3"]),
    "pipe_recover": ("Model_sym", ["-nodeadlock", "-chunk", "16",
                                   "-pipeline", "-checkpoint", "CK/p",
                                   "-checkpointevery", "4", "-recover"]),
}
CMD17_TRANSCRIPT = {
    "denied": (0, "5ac62b785a89ec2f4fda8538bac493bc"
                  "b0bc54cc9266862bc8bb717d52134145"),
    "denied_sharded": (0, "ddf10b01bd620af61ca7aab43ef3e4ad"
                          "1e90e4c1d23b8315cf65f86bed19f321"),
    "coverage": (0, "1c9e4a665aeb2045e9e9b89e7253392c"
                    "bdc76ea8512517b821bb2d4c082a56aa"),
    "pipe_term": (75, "dd7d5a7554becd6634737d6bebe07077"
                      "d090cca27a6a0b6c1ee09d630b1d560b"),
    "pipe_recover": (0, "65cfcc04a5c27b1e9652744c8ae89501"
                        "6acbe45263c21255f36e416ca7108f58"),
}


def site_digest(sites, site_coverage) -> str:
    return hashlib.sha256("\n".join(
        f"{s.key} {site_coverage[s.key]}" for s in sites).encode()
    ).hexdigest()


def cmd17_masked(text, cfg, ckdir):
    """struct_masked with the checkpoint directory masked and the resume
    hint (which names the program) dropped."""
    lines = [ln for ln in text.replace(ckdir, "CK").splitlines()
             if not ln.startswith("Resume with: ")]
    return struct_masked("\n".join(lines), cfg)


def cov17_models(ops, tmp):
    """The covered struct backends of phases 17-17c - the three shipped
    models at phase 14's geometries and TwoPhase-8 - with their emitted
    libraries (K17/K18/K21 and K22) built, one nvcc per text, in
    parallel: {name: (model, backend, geometry)}."""
    from concurrent.futures import ThreadPoolExecutor

    from torchtlc.struct.cache import get_backend
    from torchtlc.struct.loader import load

    d = os.path.join(tmp, "p17")
    os.makedirs(d, exist_ok=True)
    _, tp8 = write_struct_models(d)
    models = {}
    for name, cfg, kw in _struct_geometries() + [("TwoPhase-8", tp8,
                                                   TP8_KW)]:
        m = load(cfg)
        models[name] = (m, get_backend(m, False, coverage=True), kw)
    texts = {}
    for _, b, _ in models.values():
        texts[b.kernels.prog.text] = (ops.struct_lib, b.kernels.prog)
        texts[b.kernels.cov.text] = (ops.struct_cov_lib, b.kernels.cov)
    t0 = time.time()
    with ThreadPoolExecutor(len(texts)) as pool:
        list(pool.map(lambda fa: fa[0](fa[1]), texts.values()))
    print(f"phase 17 build: {len(texts)} emitted libraries (K17/K18/K21, "
          f"K22) in {time.time() - t0:.1f} s; coverage conditions "
          + "; ".join(f"{k} {b.kernels.cov.M} conditions, "
                      f"{b.kernels.cov.stats()['elements']} elements, "
                      f"{b.kernels.cov.n_sites} sites"
                      for k, (_, b, _) in models.items()), flush=True)
    return models


def cov17_check(torch, ops, tag, backend, block, n, record=None, reps=20):
    """K22 bitwise against its plain version on one popped block (the
    packed rows and K17's valid flags for them); timed into `record`
    beside K17 (deferred, as the run's default modes) on the same block
    when given.  Returns (sites the block visits, K22 ms, K17 ms)."""
    prog, cov = backend.kernels.prog, backend.kernels.cov
    valid = ops.struct_expand(prog, block, n)[1][0]
    got = ops.struct_cov_count(cov, block, n, valid)
    ref = cov.count_plain(block, n, valid)
    err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
    need(err == 0, f"K22 struct_cov_count differs from its plain version "
         f"({tag})")
    fine = got[cov.n_labels:]
    need(bool((fine != 0).any()), f"K22 ({tag}): no fine site visited")
    k22_ms = k17_ms = None
    if record is not None:
        ck = block.shape[0]
        k22_ms = cuda_ms(torch, lambda _: ops.struct_cov_count(
            cov, block, n, valid), reps)
        k17_ms = cuda_ms(torch, lambda _: ops.struct_expand(
            prog, block, n, True), reps)
        # K22 reads the W words of the n live rows alone, the valid flags of
        # every row of the block, and writes each site once
        nbytes = n * cov.W * 4 + ck * cov.L + cov.n_sites * 4
        record("struct_cov_count", tag, err, k22_ms,
               cuda_ms(torch, lambda _: cov.count_plain(block, n, valid), 2),
               *gen_bound_ms(nbytes, cov.stats()["elements"] * n))
    return int((got != 0).sum()), k22_ms, k17_ms


def phase_cov17(torch, ops, card, runs, tmp):
    """Phase 17: check_struct with coverage on TwoPhase Model_1, Model_sym
    and RaftReplication Model_1 at phase 14's geometries, sorted immediate
    and slab deferred (ring on): the site vector equal to the reference's
    CPU run (its digest pinned), counts, per-action counts, outdegree and
    table words unchanged from the coverage-off pins; K22 bitwise against
    its plain version on a popped block of each model."""
    models = cov17_models(ops, tmp)
    rows = {}
    record = gen_recorder(rows)
    out, lines = {}, []
    for name, _, kw in _struct_geometries():
        m, backend, _ = models[name]
        sites = backend.coverage.sites
        sha, n_sites = STRUCT_COV_PINS[name]
        need(len(sites) == n_sites, f"{name}: {len(sites)} sites")
        for mode, modes in (("sorted", SORTED),
                            ("slab", dict(sort_free=True, deferred=True,
                                          obs_slots=64))):
            r, launches = struct_run(ops, m, kw, dict(modes, coverage=True))
            struct_pinned(f"{name} {mode} coverage", r, STRUCT_PINS[name])
            need(site_digest(sites, r.site_coverage) == sha,
                 f"{name} {mode}: the site vector differs from the "
                 "reference's")
            need(launches["struct_cov_count"] == r.iterations,
                 f"{name} {mode}: K22 launches "
                 f"{launches['struct_cov_count']} != steps {r.iterations}")
            out[f"p17_{name}_{mode}"] = {"launches": launches}
            lines.append(f"{name} {mode} {r.iterations} steps "
                         f"{r.wall_s:.3f} s")
        half = STRUCT_PINS[name]["counts"][2] // 2
        block, n, _ = struct_block(torch, backend, kw,
                                   lambda c, h=half: int(c.level) > h)
        hit, _, _ = cov17_check(torch, ops, name, backend, block, n,
                                record if name.startswith("Raft") else None)
        lines.append(f"{name} K22 block {n} rows, {hit} sites visited")
    k = rows["struct_cov_count"][-1]
    print(f"phase 17 coverage: the reference's site vector (sha256 pinned) "
          f"and the coverage-off pins on every model in both mode sets; K22 "
          f"bitwise = plain on a popped block of each; " + "; ".join(lines)
          + f"; RaftReplication block: K22 {k['ms']:.4f} ms (plain "
          f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.6f} ms by "
          f"{k['bound_by']}) on {card}", flush=True)
    out.update(p17_rows=rows, p17_models=models)
    return out


def phase_cov17_real(torch, ops, card, runs):
    """Phase 17b: TwoPhase-8 at chunk 16,384 (default modes) with and
    without coverage in turns (off, on, on, off): the reference's counts
    and table words in both, the site vector of the reference's covered CPU
    run; K22 and K17 timed on a full-width block, K22 against its bound
    and plain version; TwoPhase-8 on 4 shards (16b's geometry) with
    coverage: the summed shard vectors equal the single-device vector."""
    m, backend, kw = runs["p17_models"]["TwoPhase-8"]
    rows = runs["p17_rows"]
    record = gen_recorder(rows)
    sites = backend.coverage.sites
    walls = {"off": [], "on": []}
    vec = None
    out = {}
    for which in ("off", "on", "on", "off"):
        r, launches = struct_run(ops, m, kw, dict(coverage=which == "on"))
        need((r.generated, r.distinct, r.depth) == TP8_COUNTS,
             f"TwoPhase-8 coverage {which}: counts")
        need(r.violation == 0 and struct_digest(r.fp_table)
             == TP8_TABLE_SHA256, f"TwoPhase-8 coverage {which}: table")
        if which == "on":
            need(site_digest(sites, r.site_coverage) == TP8_COV_SHA256,
                 "TwoPhase-8: the site vector differs from the reference's")
            need(launches["struct_cov_count"] == r.iterations,
                 "TwoPhase-8: K22 not once a step")
            vec = r.site_coverage
            out["p17b_tp8"] = {"launches": launches}
        walls[which].append(round(r.wall_s, 4))
        del r
        torch.cuda.empty_cache()
    block, n, _ = struct_block(torch, backend, kw,
                               lambda c: int(c.qhead) > 0
                               and int(c.level_n) >= kw["chunk"] * 4)
    hit, k22_ms, k17_ms = cov17_check(torch, ops, "TwoPhase-8", backend,
                                      block, n, record, reps=10)
    carry, r4, launches4, bodies = shard16_run(torch, ops, backend,
                                               SHARD16_D, TP8_SHARDED_KW)
    need((r4.generated, r4.distinct, r4.depth) == TP8_COUNTS,
         "TwoPhase-8 on 4 shards with coverage: counts")
    summed = (carry.cov_counts.sum(0) & 0xFFFFFFFF).tolist()
    need(summed == [vec[s.key] & 0xFFFFFFFF for s in sites],
         "TwoPhase-8 on 4 shards: the summed shard vectors differ from the "
         "single-device vector")
    need(launches4["struct_cov_count"] == SHARD16_D * bodies,
         "TwoPhase-8 on 4 shards: K22 not once a shard a body")
    out["p17b_tp8_sharded"] = {"launches": launches4}
    del carry
    torch.cuda.empty_cache()
    k = rows["struct_cov_count"][-1]
    print(f"phase 17b TwoPhase-8 (chunk {kw['chunk']}, slab + deferred): "
          f"{TP8_COUNTS}, table words = the reference's with and without "
          f"coverage, the site vector = the reference's ({len(sites)} "
          f"sites); walls in turns (off, on, on, off): off {walls['off']} "
          f"s, on {walls['on']} s; full-width block ({n} rows, {hit} sites "
          f"visited): K22 {k22_ms:.4f} ms (plain {k['plain_ms']:.1f} ms, "
          f"bound {k['bound_ms']:.5f} ms by {k['bound_by']}) beside K17 "
          f"{k17_ms:.4f} ms; 4 shards ({TP8_SHARDED_KW['chunk']} rows a "
          f"shard): {bodies} bodies, {launches4['struct_cov_count']} K22 "
          f"launches, summed shard vectors = the single-device vector, "
          f"{r4.wall_s:.3f} s on {card}", flush=True)
    return out


def phase_struct17c(torch, ops, card, runs):
    """Phase 17c: TwoPhase-8 pipelined against unpipelined in turns
    (unpipelined, pipelined, pipelined, unpipelined; default modes): the
    reference's counts, the unpipelined table words of phase 14b's pin and
    the pipelined ones of the reference's pipelined run; bodies and walls.
    Then TwoPhase-8 under the supervisor with -spill at -fpcap 2^20, a
    table that cannot hold its 1,745,408 states: the host store takes the
    rest (K9 filters each step's candidates); counts, host-store seconds
    and K9 launches."""
    from torchtlc.resil.supervisor import SupervisorOptions, check_supervised
    from torchtlc.struct.backend import struct_meta_config
    from torchtlc.struct.cache import get_backend

    m, _, kw = runs["p17_models"]["TwoPhase-8"]
    walls = {"unpipelined": [], "pipelined": []}
    out = {}
    for which in ("unpipelined", "pipelined", "pipelined", "unpipelined"):
        r, launches = struct_run(ops, m, kw,
                                 dict(pipeline=which == "pipelined"))
        need((r.generated, r.distinct, r.depth) == TP8_COUNTS,
             f"TwoPhase-8 {which}: counts")
        need(r.violation == 0 and struct_digest(r.fp_table) == (
            TP8_PIPE_TABLE_SHA256 if which == "pipelined"
            else TP8_TABLE_SHA256), f"TwoPhase-8 {which}: table words")
        if which == "pipelined" and not walls["pipelined"]:
            out["p17c_tp8_pipe"] = {"launches": launches}
        walls[which].append((round(r.wall_s, 4), r.iterations))
        del r
        torch.cuda.empty_cache()
    flushes = []
    opts = SupervisorOptions(
        spill="on", ckpt_every=32,
        on_event=lambda k, i: flushes.append(i)
        if k == "spill" and i["phase"] == "flush" else None)
    backend = get_backend(m, False)
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.time()
    sup = check_supervised(
        None, chunk=kw["chunk"], queue_capacity=kw["queue_capacity"],
        fp_capacity=TP8_SPILL_FPCAP, opts=opts, backend=backend,
        meta_config=struct_meta_config(m))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    r = sup.result
    need((r.generated, r.distinct, r.depth) == TP8_COUNTS,
         f"TwoPhase-8 spill counts {(r.generated, r.distinct, r.depth)}")
    need(r.violation == 0 and r.queue_left == 0, "TwoPhase-8 spill verdict")
    need(sup.spilled > 0 and launches["fpset_member"] > 0,
         "TwoPhase-8 did not spill")
    out["p17c_tp8_spill"] = {"launches": launches}
    print(f"phase 17c TwoPhase-8 pipelined vs unpipelined in turns (wall s, "
          f"bodies or steps): unpipelined {walls['unpipelined']}, "
          f"pipelined {walls['pipelined']}; table words = the reference's "
          f"in both; -spill at fp {TP8_SPILL_FPCAP}: {TP8_COUNTS}, wall "
          f"{wall:.2f} s, host store {sup.spill_store_s:.2f} s "
          f"({sum(f['wall_s'] for f in flushes):.2f} s in "
          f"{sup.spill_flushes} flushes, the rest probes), {sup.spilled} "
          f"fingerprints spilled, {sup.spill_hits} host hits, K9 "
          f"{launches['fpset_member']} launches, {sup.segments} segments "
          f"on {card}", flush=True)
    return out


def phase_command17(ops, card, runs, tmp, m1_cfg):
    """Phase 17d: `python -m torchtlc.cli check` in this process - the
    denied-regrow TwoPhase command (the spill rung, exit 0) on one device
    and on -sharded 4, -coverage on TwoPhase Model_1 with the device dump,
    -pipeline through SIGTERM (exit 75) and -recover -pipeline on
    Model_sym - each exit code and transcript equal to the reference's
    (digests pinned); then -phase-timing -checkpoint P on TwoPhase-8 and on
    the KubeAPI Model_1 pair: the journal's level rows cover every level,
    the counts unchanged, the per-level expand and commit sums beside the
    same command's wall without the flag."""
    here = os.path.dirname(os.path.abspath(__file__))
    ckdir = os.path.join(tmp, "ck17")
    os.makedirs(ckdir)
    out, lines = {}, []
    for tag, (model, extra) in CMD17.items():
        cfg = os.path.join(here, "specs", "TwoPhase.toolbox", model,
                           "MC.cfg")
        argv = [cfg, "-noTool"] + [x.replace("CK", ckdir) for x in extra]
        rc, text, launches, wall = command_here(ops, argv)
        rc_want, sha_want = CMD17_TRANSCRIPT[tag]
        need(rc == rc_want, f"command {tag} exited {rc}")
        sha = hashlib.sha256(cmd17_masked(text, cfg, ckdir).encode()
                             ).hexdigest()
        need(sha == sha_want, f"command {tag}: the transcript differs from "
             "the reference's")
        if tag.startswith("denied"):
            need("Capacity ladder [spill] fp_capacity: activate" in text,
                 f"command {tag}: the spill rung was not taken")
        if tag == "coverage":
            need(launches["struct_cov_count"] > 0, "-coverage: K22 never ran")
        out[f"p17d_{tag}"] = {"launches": launches}
        lines.append(f"{tag} exit {rc} ({wall:.2f} s)")
    tp8 = os.path.join(tmp, "p17", "tp8", "MC.cfg")
    if not os.path.exists(tp8):  # 17d alone
        os.makedirs(os.path.join(tmp, "p17"), exist_ok=True)
        write_struct_models(os.path.join(tmp, "p17"))
    phased = []
    for tag, cfg, extra, counts in (
            ("TwoPhase-8", tp8, ["-nodeadlock", "-chunk",
                                 str(TP8_KW["chunk"]), "-qcap",
                                 str(TP8_KW["queue_capacity"]), "-fpcap",
                                 str(TP8_KW["fp_capacity"])], TP8_COUNTS),
            ("Model_1", m1_cfg, [], M1_COUNTS)):
        walls = {}
        for flag in ("-phase-timing", None):
            ck = os.path.join(ckdir, f"pt_{tag}_{bool(flag)}")
            argv = [cfg, "-noTool", *extra, "-checkpoint", ck] + (
                [flag] if flag else [])
            rc, text, launches, wall = command_here(ops, argv)
            need(rc == 0 and final_counts(text) == counts,
                 f"{tag} {flag}: exit {rc}, {final_counts(text)}")
            walls[flag] = wall
            if flag:
                evs = [json.loads(x) for x in open(ck + ".journal.jsonl")]
                lv = [e for e in evs if e["event"] == "phase"
                      and e["scope"] == "level"]
                need({e["index"] for e in lv} == set(range(1, counts[2] + 1)),
                     f"{tag} -phase-timing: the level rows miss a level")
                sums = {p: sum(e["wall_s"] for e in lv if e["phase"] == p)
                        for p in ("expand", "commit")}
                out[f"p17d_phases_{tag}"] = {"launches": launches}
        phased.append(f"{tag}: expand {sums['expand']:.3f} s + commit "
                      f"{sums['commit']:.3f} s over {counts[2]} levels, "
                      f"fenced command {walls['-phase-timing']:.2f} s, "
                      f"unfenced {walls[None]:.2f} s")
    print("phase 17d commands, transcripts = the reference's: "
          + "; ".join(lines) + "; -phase-timing " + "; ".join(phased)
          + f" on {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 18-18c: struct -narrow, the runtime certificate (K23) and
# -traceExpressions
# ---------------------------------------------------------------------------

# (packed words, SHA-256 of the final table words) of jaxtlc.struct.engine.
# check_struct(model, check_deadlock=False, capture_fps=True, bounds=
# jaxtlc.analysis.absint.analyze_bounds(model)) on the CPU at phase 14's
# geometries - the same in the sorted immediate and the slab deferred modes
# with obs_slots=64; the counts, per-action counts and outdegree are
# STRUCT_PINS's (narrowing changes no count).  TwoPhase's certified bounds
# are its inferred shapes: the same codec, the un-narrowed table words
NARROW_PINS = {
    "TwoPhase/Model_1": (1, STRUCT_PINS["TwoPhase/Model_1"]["sha"]),
    "TwoPhase/Model_sym": (1, STRUCT_PINS["TwoPhase/Model_sym"]["sha"]),
    "RaftReplication/Model_1": (1, "38930dbe3f7454723a35a9d4acae9ed8"
                                   "2ff97495722bc7857ef7158ed7102020"),
}
# RaftReplication with five nodes, the standard Raft deployment
RR5_CFG = """CONSTANT Nodes = {n1, n2, n3, n4, n5}
CONSTANT MaxLog = 2
CONSTANT MaxTerm = 3
SPECIFICATION
Spec
INVARIANT
TypeOK
AtMostOneLeader
CommitWithinLog
CommittedAgree
"""
RR5_KW = dict(chunk=1 << 14, queue_capacity=1 << 21, fp_capacity=1 << 22)
RR5_COUNTS = (4376601, 1205891, 21)
# (packed words, table SHA-256) of the reference's CPU check_struct at
# RR5_KW in the default modes (slab dedup, deferred invariants), narrowed
# (67 -> 53 bits) and not
RR5_PINS = {"narrow": (2, "5232abe47e65c05cac3511a79584cbcb"
                          "4024501c50a78aa7fbf4918c8e3d9fed"),
            "base": (3, "3ff352e052b1cebf35b4ef15f59c0fdd"
                        "2dbea9a03f1dd5025d01778ec394f096")}
# the slot-count synthetic of the reference's tests/test_absint.py:97-111,
# whose cardinality lie (|msgs| <= 1) only the runtime certificate catches
SLOTC_TLA = """---- MODULE SlotC ----
EXTENDS Naturals, FiniteSets
CONSTANTS RM
VARIABLES msgs, n
Init == /\\ msgs = {} /\\ n = 0
Send == /\\ n < 2
        /\\ \\E r \\in RM : msgs' = msgs \\cup {[kind |-> "a", from |-> r]}
        /\\ n' = n + 1
Drop == /\\ \\E m \\in msgs : msgs' = msgs \\ {m}
        /\\ UNCHANGED n
Next == Send \\/ Drop
TypeOK == /\\ \\A m \\in msgs : m.from \\in RM /\\ n \\in 0..5
====
"""
SLOTC_CFG = ("CONSTANT RM = {r1, r2, r3, r4, r5, r6, r7, r8, r9, "
             "ra, rb, rc, rd}\nINVARIANT\nTypeOK\n")
# -traceExpressions files of phase 18c (written into the checkpoint
# directory, which the transcripts mask as CK)
TEXPR_FF = 'NObjects == Cardinality(apiState)\nClientPC == pc["Client"]\n'
TEXPR_TWO = "Prepared == Cardinality(tmPrepared)\nTM == tmState\n"
RAFT_256 = ["-nodeadlock", "-narrow", "-chunk", "256"]
# phase 18c: model key -> argv after the MC.cfg (CK: the checkpoint
# directory); the keys of models18c
CMD18 = {
    "raft": ("raft", RAFT_256),
    "rr5": ("rr5", ["-nodeadlock", "-narrow", "-chunk", str(RR5_KW["chunk"]),
                    "-qcap", str(RR5_KW["queue_capacity"]), "-fpcap",
                    str(RR5_KW["fp_capacity"])]),
    "twophase": ("two", ["-nodeadlock", "-narrow"]),
    "coverage": ("raft", RAFT_256 + ["-coverage"]),
    "pipeline": ("raft", RAFT_256 + ["-pipeline"]),
    "sharded": ("raft", RAFT_256 + ["-sharded", "4"]),
    "term": ("raft", RAFT_256 + ["-checkpoint", "CK/r", "-checkpointevery",
                                 "4", "-faults", "sigterm@3"]),
    "recover": ("raft", RAFT_256 + ["-checkpoint", "CK/r",
                                    "-checkpointevery", "4", "-recover"]),
    "spill": ("two", ["-nodeadlock", "-narrow", "-chunk", "16", "-qcap",
                      "256", "-fpcap", "64", "-faults", "alloc_fail@1",
                      "-checkpoint", "CK/s"]),
    "lie": ("slotc", ["-frontend", "struct", "-narrow", "-nodeadlock",
                      "-chunk", "64", "-checkpoint", "CK/l"]),
    "reconciler": ("recon", ["-narrow"]),
    "kubeapi": ("ff", ["-narrow", "-chunk", "128"]),
    "texpr_ff": ("ff", ["-mutation", "delete_noop", "-chunk", "128",
                        "-traceExpressions", "CK/te_ff.txt"]),
    "texpr_struct": ("two", ["-traceExpressions", "CK/te_two.txt"]),
}
# (exit code, SHA-256 of cmd17_masked) of `python -m jaxtlc.cli check
# <MC.cfg> -noTool <argv> -workers cpu` in one process, in CMD18's order,
# the reference's 8 virtual CPU devices for -sharded, the lie through
# jaxtlc.struct.cache.get_bounds returning the lying report
CMD18_TRANSCRIPT = {
    "raft": (0, "47906c7b48ea4b9a2d71f61f2e986c95"
             "04995bbb5b22e27c0caae59aaa8a7777"),
    "rr5": (0, "64fe2672274fd42c3fd5155672cc9225"
            "de6bc6b9fb9818584a5673d4fb4a69f2"),
    "twophase": (0, "eefe00acd60e917601998f0e625a8637"
                 "8650aa48a6267d7d7a0f1582f85ba49a"),
    "coverage": (0, "1b2f3e56216f9426d3a81b5ec4b10193"
                 "f99e2bc3a415cfdb07ac2ac17d1341f4"),
    "pipeline": (0, "47906c7b48ea4b9a2d71f61f2e986c95"
                 "04995bbb5b22e27c0caae59aaa8a7777"),
    "sharded": (0, "4d3a2a05e2a5c67e5018955b6a1172f1"
                "219fba89a68b1505351c16f48187ba21"),
    "term": (75, "df1005ee6e50f13b11574da6472c85fe"
             "960af6c42c9af0f270b1029a33bdaebf"),
    "recover": (0, "9074a67ce2ef6a2c565c52a6724eb8e4"
                "07b409dcfbd1440ccf96e44466d6504e"),
    "spill": (0, "3228a7147a3f3269f7afe5746304b190"
              "47f4ca89ad022fc0b2050182eb907d9a"),
    "lie": (1, "5c516ad7c82486a73f8572d90beda087"
            "e777a6af3b2a5e30a1376a3e76b63c03"),
    "reconciler": (0, "e25bed2ddec9c0c3740bd65ac895276e"
                   "5b9aef9fd6cdee16625395e027dd645f"),
    "kubeapi": (0, "c20393cb8e8dd988887dea062d04c820"
                "de8c90c04988422077711953e6055417"),
    "texpr_ff": (12, "b782dcdabb9b9021f5c95822afe9b6ce"
                 "9f31b664a32432c2341e5c477edbbcb7"),
    "texpr_struct": (12, "b93771cefbbee58ae2366512da23ce8d"
                     "1e6b434f4a391dd094ca297eb998d90e"),
}


def models18(tmp):
    """The model files of phases 18-18c in `tmp`/p18: {key: MC.cfg}."""
    here = os.path.dirname(os.path.abspath(__file__))
    specs = os.path.join(here, "specs")
    d = os.path.join(tmp, "p18")
    os.makedirs(d, exist_ok=True)
    out = {"two": os.path.join(specs, "TwoPhase.toolbox", "Model_1",
                               "MC.cfg"),
           "raft": os.path.join(specs, "RaftReplication.toolbox", "Model_1",
                                "MC.cfg"),
           "recon": os.path.join(specs, "Reconciler.toolbox", "Model_1",
                                 "MC.cfg")}
    for key, files in (
            ("rr5", {"RaftReplication.tla": open(os.path.join(
                os.path.dirname(out["raft"]), "RaftReplication.tla")).read(),
                "MC.cfg": RR5_CFG}),
            ("slotc", {"SlotC.tla": SLOTC_TLA, "SlotC.cfg": SLOTC_CFG}),
            ("tp8", {"TwoPhase.tla": open(os.path.join(
                os.path.dirname(out["two"]), "TwoPhase.tla")).read(),
                "MC.cfg": TP8_CFG})):
        os.makedirs(os.path.join(d, key), exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(d, key, fname), "w") as f:
                f.write(text)
        out[key] = os.path.join(d, key, "MC.cfg" if key != "slotc"
                                else "SlotC.cfg")
    if not os.path.exists(os.path.join(d, "Model_FF")):
        write_model(d, "Model_FF", False, False)
    out["ff"] = os.path.join(d, "Model_FF", "MC.cfg")
    return out


def card_lie(report):
    """The reference test's cardinality lie: |msgs| <= 1."""
    import dataclasses

    return dataclasses.replace(
        report, card_bounds={**report.card_bounds, "msgs": 1})


def narrow18_backends(ops, tmp):
    """The narrowed struct backends of phases 18-18c and their emitted
    libraries, built one nvcc per text, in parallel: {name: (model,
    report, backend, geometry)} for phase 14's models, RaftReplication
    with five nodes (and its baseline backend as "RR5/base"), TwoPhase-8
    and the slot-count synthetic under its cardinality lie; plus the
    texts phase 18c's commands build (-sharded: every trap kept, no
    certificate; -coverage: K22)."""
    from concurrent.futures import ThreadPoolExecutor

    from torchtlc.struct.cache import get_backend, get_bounds
    from torchtlc.struct.loader import load

    cfgs = models18(tmp)
    out = {}
    for name, cfg, kw in _struct_geometries() + [
            ("RR5", cfgs["rr5"], RR5_KW), ("TwoPhase-8", cfgs["tp8"], TP8_KW),
            ("SlotC/lie", cfgs["slotc"], dict(chunk=64, queue_capacity=1024,
                                              fp_capacity=8192))]:
        m = load(cfg)
        rep = get_bounds(m)
        need(rep.certified, f"{name}: the bound report is not certified")
        if name == "SlotC/lie":
            rep = card_lie(rep)
        out[name] = (m, rep, get_backend(m, False, bounds=rep), kw)
    m, _, _, _ = out["RR5"]
    out["RR5/base"] = (m, None, get_backend(m, False), RR5_KW)
    m8 = out["TwoPhase-8"][0]
    out["TwoPhase-8/base"] = (m8, None, get_backend(m8, False), TP8_KW)
    mr, rr, _, _ = out["RaftReplication/Model_1"]
    texts = {}
    for _, _, b, _ in out.values():
        texts[b.kernels.prog.text] = (ops.struct_lib, b.kernels.prog)
    for b in (get_backend(mr, False, bounds=rr, elide=False),
              get_backend(mr, False, bounds=rr, coverage=True)):
        texts[b.kernels.prog.text] = (ops.struct_lib, b.kernels.prog)
        if b.kernels.cov is not None:
            texts[b.kernels.cov.text] = (ops.struct_cov_lib, b.kernels.cov)
    t0 = time.time()
    with ThreadPoolExecutor(len(texts)) as pool:
        list(pool.map(lambda fa: fa[0](fa[1]), texts.values()))
    print(f"phase 18 build: {len(texts)} emitted libraries (K17/K18/K21/K23, "
          f"K22) in {time.time() - t0:.1f} s; narrowed codecs "
          + "; ".join(f"{k} {r.baseline_nbits} -> {r.narrowed_nbits} bits, "
                      f"{b.cdc.n_words} words, traps {b.cdc.trap_stats}"
                      for k, (_, r, b, _) in out.items() if r is not None),
          flush=True)
    return out, cfgs


def struct_run18(ops, model, kw, modes):
    """struct_run with the certificate's launch breakdown: (result,
    launches, K23 launches by the kernel it rode in)."""
    r, launches = struct_run(ops, model, kw, modes)
    return r, launches, dict(ops.CERT_LAUNCHES)


def cert_rows_bytes_ops(prog, N, n_valid):
    """K23's bytes and integer operations over N rows of which n_valid are
    valid: a valid byte a row, the F words of each valid row (an invalid
    row's fields are not needed), the flag; two compares a field and, per
    bounded mask field, a popcount and an add, one compare a mask, on each
    valid row."""
    specs = prog.cert[1]
    nbytes = N + n_valid * prog.F * 4 + 4
    ops_ = n_valid * (2 * prog.F + sum(2 * nf + 1 for _, nf, _ in specs))
    return nbytes, ops_


def k23_check(torch, ops, tag, prog, rows, valid, record=None, reps=20):
    """K23 bitwise against its plain version on raw rows [N, F] under
    valid [N]: clean, then doctored - a field past its maximum code and a
    negative field in a valid row (tripped), the same rows marked invalid
    (clean), and with a cardinality-bounded mask, bound + 1 bits in it
    (tripped).  Timed into `record` when given.  Returns the cases."""
    max_code, specs = prog.cert
    i = int(torch.nonzero(valid).flatten()[0])
    j = max(range(len(max_code)), key=lambda k: max_code[k])
    cases = {"clean": (rows, valid, False)}
    r = rows.clone()
    r[i, j] = max_code[j] + 1
    cases["past-max"] = (r, valid, True)
    r = rows.clone()
    r[i, 0] = -1
    cases["negative"] = (r, valid, True)
    v = valid.clone()
    v[i] = False
    cases["invalid"] = (cases["past-max"][0], v, False)
    if specs:
        off, nf, bound = specs[0]
        r = rows.clone()
        r[i, off:off + nf] = 0
        r[i, off] = (1 << (bound + 1)) - 1
        cases["mask-over-bound"] = (r, valid, True)
    for case, (rr, vv, want) in cases.items():
        got = bool(ops.struct_cert_check(prog, rr, vv))
        plain = bool(prog.cert_plain(rr, vv))
        need(got == plain == want, f"K23 ({tag}, {case}): kernel {got}, "
             f"plain {plain}, want {want}")
    if record is not None:
        N = rows.shape[0]
        record("struct_cert_check", tag, 0,
               cuda_ms(torch, lambda _: ops.struct_cert_check(
                   prog, rows, valid), reps),
               cuda_ms(torch, lambda _: prog.cert_plain(rows, valid), 2),
               *gen_bound_ms(*cert_rows_bytes_ops(prog, N,
                                                  int(valid.sum()))))
    return sorted(cases)


def kcert_check(torch, ops, tag, prog, block, n, want):
    """K17's kCert form and K18 with the certificate against their plain
    versions on one popped block (K18's claimants: every valid lane, all
    fresh); the certificate must read `want`.  Returns K17's raw
    successors and valid flags (the deferred form's)."""
    got = ops.struct_expand(prog, block, n, False, True)
    ref = prog.expand_plain(block, n, False, cert=True)
    for a, b in zip(got, ref):
        if a is not None:
            need(torch.equal(a.to(torch.int64), b.to(torch.int64)),
                 f"K17 kCert ({tag}) differs from its plain version")
    need(bool(got[5]) == want, f"K17 kCert ({tag}): certificate "
         f"{bool(got[5])}, want {want}")
    _, flags, action, _, flat = ops.struct_expand(prog, block, n, True)[:5]
    valid = flags[0].bool()
    lanes_ = torch.nonzero(valid).flatten().to(torch.int64)
    fresh = torch.ones(lanes_.numel(), dtype=torch.bool, device=block.device)
    k18 = ops.struct_inv_rows(prog, flat, fresh, lanes_, action,
                              max(1, lanes_.numel()), cert=True)
    p18 = prog.inv_rows_plain(flat, fresh, lanes_, action,
                              max(1, lanes_.numel()), cert=True)
    need(all(torch.equal(a.to(torch.int64), b.to(torch.int64))
             for a, b in zip(k18, p18)) and bool(k18[3]) == want,
         f"K18 with the certificate ({tag}) differs from its plain version")
    return flat, valid


def phase_narrow18(torch, ops, card, runs, tmp):
    """Phase 18: check_struct with -narrow (a certified bound report) on
    TwoPhase Model_1, Model_sym and RaftReplication Model_1 at phase 14's
    geometries, sorted immediate and slab deferred (ring on): the counts,
    per-action counts and outdegree of the un-narrowed pins, the narrowed
    codec's packed words (RaftReplication 1 against 2), the table words of
    the reference's narrowed CPU run, the certificate clean; K23 inside K17
    (immediate) and K18 (deferred).  K17's kCert form, K18 with the
    certificate and K23 bitwise against their plain versions on a popped
    block, and K23 on doctored blocks (the cardinality lie's synthetic for
    a mask over its bound)."""
    backends, cfgs = narrow18_backends(ops, tmp)
    rows = {}
    record = gen_recorder(rows)
    out, lines = {}, []
    for name, _, kw in _struct_geometries():
        m, rep, backend, _ = backends[name]
        words, sha = NARROW_PINS[name]
        need(backend.cdc.n_words == words and backend.cert_check is not None,
             f"{name}: {backend.cdc.n_words} packed words")
        for mode, modes in (("sorted", SORTED),
                            ("slab", dict(sort_free=True, deferred=True,
                                          obs_slots=64))):
            r, launches, cert = struct_run18(ops, m, kw,
                                             dict(modes, bounds=rep))
            struct_pinned(f"{name} {mode} narrowed", r,
                          dict(STRUCT_PINS[name], sha=sha))
            need(r.cert_violated is False, f"{name} {mode}: certificate "
                 f"{r.cert_violated}")
            host = "struct_expand" if mode == "sorted" else "struct_inv_rows"
            need(cert[host] == launches[host] > 0
                 and launches["struct_cert_check"] == cert[host],
                 f"{name} {mode}: K23 rode in {cert}, launches {launches}")
            out[f"p18_{name}_{mode}"] = {"launches": launches, "cert": cert}
            lines.append(f"{name} {mode} {r.iterations} steps "
                         f"{r.wall_s:.3f} s")
    # the kernels on popped blocks
    m, rep, backend, kw = backends["RaftReplication/Model_1"]
    prog = backend.kernels.prog
    block, n, _ = struct_block(torch, backend, kw,
                               lambda c: int(c.level) > 7)
    flat, valid = kcert_check(torch, ops, "RaftReplication", prog, block, n,
                              False)
    k23_cases = k23_check(torch, ops, "RaftReplication", prog, flat, valid,
                          record)
    k23_n = flat.shape[0]
    _, _, lie, kwl = backends["SlotC/lie"]
    lprog = lie.kernels.prog
    block, n, _ = struct_block(torch, lie, kwl, lambda c: True)
    flat, valid = kcert_check(torch, ops, "SlotC lie, Init block", lprog,
                              block, n, False)
    lie_cases = k23_check(torch, ops, "SlotC lie", lprog, flat, valid)
    block, n, _ = struct_block(torch, lie, kwl, lambda c: int(c.level) > 2)
    kcert_check(torch, ops, "SlotC lie, level 3", lprog, block, n, True)
    k = rows["struct_cert_check"][-1]
    print(f"phase 18 -narrow: the un-narrowed counts and the reference's "
          f"narrowed table words on every model in both mode sets, "
          f"RaftReplication on 1 packed word (2 un-narrowed), certificate "
          f"clean, K23 once a step inside K17 (immediate) or K18 "
          f"(deferred); " + "; ".join(lines) + f"; K17 kCert, K18 and K23 "
          f"bitwise = plain on a popped RaftReplication block, K23 on "
          f"doctored blocks {k23_cases} and (the lie's synthetic) "
          f"{lie_cases}, K17 kCert tripped by the lie at level 3; K23 "
          f"{k['ms']:.4f} ms on a RaftReplication block of {k23_n} rows "
          f"(plain {k['plain_ms']:.3f} ms, bound {k['bound_ms']:.6f} ms by "
          f"{k['bound_by']}) on {card}", flush=True)
    out.update(p18_rows=rows, p18_backends=backends, p18_cfgs=cfgs)
    return out


def phase_narrow18_real(torch, ops, card, runs):
    """Phase 18b: RaftReplication with five nodes at chunk 16,384 (default
    modes), narrowed (2 packed words) and not (3) in turns (narrowed,
    baseline, baseline, narrowed): the reference's counts and each
    variant's table words, the certificate clean; walls and distinct
    states per second.  On a full-width block of raw successors: K17 with
    and without kCert, K23 alone, its bound and plain version.  TwoPhase-8
    with and without -narrow in turns (certified, nothing narrowed: the
    same table words)."""
    backends = runs["p18_backends"]
    rows = runs["p18_rows"]
    record = gen_recorder(rows)
    out = {}
    m, rep, narrow, kw = backends["RR5"]
    base = backends["RR5/base"][2]
    walls = {"narrow": [], "base": []}
    for which in ("narrow", "base", "base", "narrow"):
        words, sha = RR5_PINS[which]
        b = narrow if which == "narrow" else base
        need(b.cdc.n_words == words, f"RR5 {which}: {b.cdc.n_words} words")
        r, launches, cert = struct_run18(
            ops, m, kw, dict(bounds=rep if which == "narrow" else None))
        need((r.generated, r.distinct, r.depth) == RR5_COUNTS
             and r.violation == 0, f"RR5 {which}: "
             f"{(r.generated, r.distinct, r.depth)}, {r.violation}")
        need(struct_digest(r.fp_table) == sha, f"RR5 {which}: table words")
        need(r.cert_violated is (False if which == "narrow" else None),
             f"RR5 {which}: certificate {r.cert_violated}")
        if which == "narrow":
            need(cert["struct_inv_rows"] == launches["struct_inv_rows"] > 0,
                 f"RR5 narrowed: K23 inside K18 {cert}")
        out.setdefault(f"p18b_rr5_{which}", {"launches": launches,
                                             "cert": cert})
        walls[which].append((round(r.wall_s, 4),
                             int(r.distinct / r.wall_s)))
        del r
        torch.cuda.empty_cache()
    prog, bprog = narrow.kernels.prog, base.kernels.prog
    block, n, _ = struct_block(torch, narrow, kw,
                               lambda c: int(c.qhead) > 0
                               and int(c.level_n) >= kw["chunk"] * 4)
    need(n == kw["chunk"], f"RR5 block of {n} rows")
    flat, valid = kcert_check(torch, ops, "RR5", prog, block, n, False)
    k17_cert = cuda_ms(torch, lambda _: ops.struct_expand(
        prog, block, n, False, True), 10)
    k17_plain = cuda_ms(torch, lambda _: ops.struct_expand(
        prog, block, n, False), 10)
    k23_check(torch, ops, "RR5", prog, flat, valid, record, reps=10)
    k = rows["struct_cert_check"][-1]
    m8, rep8, tp8, kw8 = backends["TwoPhase-8"]
    need(tp8.cdc.n_words == backends["TwoPhase-8/base"][2].cdc.n_words,
         "TwoPhase-8: -narrow changed the packed words")
    walls8 = {"narrow": [], "base": []}
    for which in ("narrow", "base", "base", "narrow"):
        r, launches, cert = struct_run18(
            ops, m8, kw8, dict(bounds=rep8 if which == "narrow" else None))
        need((r.generated, r.distinct, r.depth) == TP8_COUNTS
             and struct_digest(r.fp_table) == TP8_TABLE_SHA256,
             f"TwoPhase-8 {which}: counts or table words")
        need(r.cert_violated is (False if which == "narrow" else None),
             f"TwoPhase-8 {which}: certificate {r.cert_violated}")
        out.setdefault(f"p18b_tp8_{which}", {"launches": launches,
                                             "cert": cert})
        walls8[which].append(round(r.wall_s, 4))
        del r
        torch.cuda.empty_cache()
    print(f"phase 18b RR5 (Nodes n1..n5, MaxLog 2, MaxTerm 3; chunk "
          f"{kw['chunk']}, slab + deferred): {RR5_COUNTS} narrowed on "
          f"{prog.W} words and on {bprog.W} un-narrowed, each variant's "
          f"table words = the reference's, certificate clean; (wall s, "
          f"distinct/s) in turns: narrowed {walls['narrow']}, baseline "
          f"{walls['base']}; full-width block ({n} rows, {flat.shape[0]} "
          f"raw successors): K17 {k17_plain:.4f} ms, with kCert "
          f"{k17_cert:.4f} ms; K23 alone {k['ms']:.4f} ms (plain "
          f"{k['plain_ms']:.1f} ms, bound {k['bound_ms']:.5f} ms by "
          f"{k['bound_by']}); TwoPhase-8 walls in turns: -narrow "
          f"{walls8['narrow']} s, without {walls8['base']} s (same table "
          f"words) on {card}", flush=True)
    out["p18b_k17"] = dict(k17_ms=k17_plain, k17_cert_ms=k17_cert,
                           rows=flat.shape[0])
    return out


def phase_command18(ops, card, runs, tmp):
    """Phase 18c: `python -m torchtlc.cli check` in this process with
    -narrow - RaftReplication Model_1, RR5 and TwoPhase (the preflight's
    bound findings), -coverage, -pipeline, -sharded 4 (the narrowed text
    through K21, traps kept), SIGTERM (exit 75) then -recover -narrow, the
    spill rung on TwoPhase, the cardinality lie (exit 1 and the banner),
    Reconciler and the KubeAPI pair (ignored) - and -traceExpressions on
    the FF violation and on TwoPhase's deadlock (exit 12): each exit code
    and transcript equal to the reference's (digests pinned).  -recover
    without -narrow on the narrowed checkpoint is refused (its bound
    digest), as the reference refuses it."""
    from torchtlc.struct import cache

    cfgs = (runs["p18_cfgs"] if "p18_cfgs" in runs else models18(tmp))
    ckdir = os.path.join(tmp, "ck18")
    os.makedirs(ckdir)
    with open(os.path.join(ckdir, "te_ff.txt"), "w") as f:
        f.write(TEXPR_FF)
    with open(os.path.join(ckdir, "te_two.txt"), "w") as f:
        f.write(TEXPR_TWO)
    out, lines = {}, []
    for tag, (key, extra) in CMD18.items():
        cfg = cfgs[key]
        argv = [cfg, "-noTool"] + [x.replace("CK", ckdir) for x in extra]
        if tag == "recover":  # first without -narrow: refused
            try:
                command_here(ops, [a for a in argv if a != "-narrow"])
            except ValueError as e:
                need("checkpoint config mismatch" in str(e)
                     and "bound_digest" in str(e),
                     f"-recover without -narrow: {e}")
            else:
                raise SmokeFailure("-recover without -narrow resumed a "
                                   "narrowed checkpoint")
        real = cache.get_bounds
        if tag == "lie":
            cache.get_bounds = lambda mdl: card_lie(real(mdl))
        try:
            rc, text, launches, wall = command_here(ops, argv)
        finally:
            cache.get_bounds = real
        rc_want, sha_want = CMD18_TRANSCRIPT[tag]
        need(rc == rc_want, f"command {tag} exited {rc}")
        sha = hashlib.sha256(cmd17_masked(text, cfg, ckdir).encode()
                             ).hexdigest()
        need(sha == sha_want, f"command {tag}: the transcript differs from "
             "the reference's")
        if tag == "lie":
            need(text.count("ERROR: runtime certificate violation - ") == 1,
                 "the lie's banner is not there once")
        if tag == "coverage":
            need(launches["struct_cov_count"] > 0, "-coverage: K22 never ran")
        if tag == "sharded":
            need(launches["emitted_expand_sharded"] > 0
                 and launches["struct_cert_check"] == 0,
                 "-sharded 4: K21 never ran, or a certificate did")
        out[f"p18c_{tag}"] = {"launches": launches,
                              "cert": dict(ops.CERT_LAUNCHES)}
        lines.append(f"{tag} exit {rc} ({wall:.2f} s)")
    print("phase 18c commands, transcripts = the reference's: "
          + "; ".join(lines) + "; -recover without -narrow refused (bound "
          f"digest) on {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 19-19c: -symmetry and -por (kernels K24, K25, K26)
# ---------------------------------------------------------------------------

TP4_CFG = TP8_CFG.replace("r1, r2, r3, r4, r5, r6, r7, r8", "r1, r2, r3, r4")
# the reference's two-counter POR spec (tests/test_reduce.py:203-234), its
# counters bounded by {N}: 4 shipped, 128 for the full-width block of 19b
PORV_TLA = """---- MODULE PorV ----
EXTENDS Naturals
VARIABLES x, y

Init == x = 0 /\\ y = 0

IncX == /\\ x < {N}
        /\\ x' = x + 1
        /\\ UNCHANGED <<y>>

IncY == /\\ y < {N}
        /\\ y' = y + 1
        /\\ UNCHANGED <<x>>

Next == IncX \\/ IncY

Spec == Init /\\ [][Next]_<<x, y>>

InRange == x <= {N}
====
"""
PORV_CFG = "SPECIFICATION\nSpec\nINVARIANT\nInRange\n"
PORW_N = 128  # 128 x 128 = 16,384 states: one full-width block
# the reference's exit-12 symmetric spec (tests/test_reduce.py:147-160)
SYMV_TLA = """---- MODULE SymV ----
EXTENDS Naturals, FiniteSets
CONSTANTS RM
VARIABLES voted, n
Init == voted = {} /\\ n = 0
Vote == /\\ \\E r \\in RM \\ voted : voted' = voted \\cup {r}
        /\\ n' = n + 1
Next == Vote
Small == n < 2
====
"""
SYMV_CFG = "CONSTANT RM = {r1, r2, r3}\nINVARIANT\nSmall\n"
# RaftReplication with four servers declared SYMMETRY: 4! = 24 permutations,
# the largest group the reduction admits (analysis.symfind PERM_LIMIT)
RR4_CFG = RR5_CFG.replace("n1, n2, n3, n4, n5", "n1, n2, n3, n4").replace(
    "MaxTerm = 3", "MaxTerm = 7")
RR4_KW = dict(chunk=1 << 14, queue_capacity=1 << 21)
RR4_FP = {"sym": 1 << 21, "base": 1 << 23}
# the reference's CPU runs (generated, distinct, depth)
RR4_COUNTS = {"sym": (531900, 172222, 22), "base": (10959821, 3564961, 22)}
SYM_KW = dict(chunk=64, queue_capacity=1024, fp_capacity=4096)
RAFT_SYM_KW = dict(chunk=256, queue_capacity=1 << 13, fp_capacity=1 << 15)
# (name, model key, geometry, reduction, modes) of phase 19's engine runs
P19_RUNS = (
    ("TwoPhase/Model_sym", "sym", SYM_KW, dict(symmetry=True),
     ("sorted", "slab", "pipeline")),
    ("RaftReplication/Model_1", "raft", RAFT_SYM_KW, dict(symmetry=True),
     ("sorted", "slab", "narrow")),
    ("TwoPhase/RM4", "tp4", dict(chunk=64, queue_capacity=2048,
                                 fp_capacity=8192), dict(symmetry=True),
     ("sorted", "slab")),
    ("PorV", "porv", dict(chunk=4, queue_capacity=64, fp_capacity=256),
     dict(por=True), ("sorted", "slab")),
)
P19_MODES = {"sorted": SORTED,
             "slab": dict(sort_free=True, deferred=True, obs_slots=64),
             "pipeline": dict(SORTED, pipeline=True, obs_slots=64),
             "narrow": SORTED}
# the reference's CPU check_struct of each P19_RUNS run (sym: the orbit
# check, pruned: the POR count), the same in every mode but the narrowed
# codec's table words
_P19_RUN_PINS = {
    "TwoPhase/Model_sym": dict(
        counts=[228, 80, 11], outdegree=[1, 0, 3, 3],
        act_gen={"CallOff": 20, "Collect": 30, "Decide": 1, "ObeyAbort": 84,
                 "ObeyCommit": 6, "Renege": 43, "Vote": 43},
        act_dist={"CallOff": 20, "Collect": 10, "Decide": 1, "ObeyAbort": 36,
                  "ObeyCommit": 3, "Renege": 3, "Vote": 6},
        sym=False, pruned=None,
        sha=("f642e254d10975153d14cc65e12d46cb"
             "6767f38edc92c03ad03d59969b9c4c89")),
    "RaftReplication/Model_1": dict(
        counts=[3169, 1320, 14], outdegree=[1, 0, 4, 3],
        act_gen={"AdvanceCommit": 552, "ClientRequest": 219, "Elect": 635,
                 "LearnCommit": 560, "Replicate": 1202},
        act_dist={"AdvanceCommit": 176, "ClientRequest": 219, "Elect": 456,
                  "LearnCommit": 232, "Replicate": 236},
        sym=False, pruned=None,
        sha=("df6fdd5d23334590d2fe9ed02d6c1aa6"
             "5e3b74800b98d4715b5b66a1868a27eb")),
    "PorV": dict(
        counts=[9, 9, 9], outdegree=[1, 0, 1, 1],
        act_gen={"IncX": 4, "IncY": 4}, act_dist={"IncX": 4, "IncY": 4},
        sym=None, pruned=4,
        sha=("7ddff4a79ee6edfaa52c641880e2e298"
             "b0745f8e9540caf8b35c48430cf00f48")),
}
P19_PINS = {f"{name}/{mode}": _P19_RUN_PINS[name]
            for name, _, _, _, modes in P19_RUNS for mode in modes
            if name in _P19_RUN_PINS}
P19_PINS["RaftReplication/Model_1/narrow"] = dict(
    _P19_RUN_PINS["RaftReplication/Model_1"],
    sha=("b567dc3fdfd2138a21d63f6de7bfb25c"
         "370da7f260ab095ba7f11ea94a65f0f8"))


def models19(tmp):
    """The model files of phases 19-19c in `tmp`/p19: {key: MC.cfg}."""
    here = os.path.dirname(os.path.abspath(__file__))
    specs = os.path.join(here, "specs")
    d = os.path.join(tmp, "p19")
    os.makedirs(d, exist_ok=True)
    out = {"sym": os.path.join(specs, "TwoPhase.toolbox", "Model_sym",
                               "MC.cfg"),
           "raft": os.path.join(specs, "RaftReplication.toolbox", "Model_1",
                                "MC.cfg"),
           "recon": os.path.join(specs, "Reconciler.toolbox", "Model_1",
                                 "MC.cfg")}
    two = open(os.path.join(specs, "TwoPhase.toolbox", "Model_1",
                            "TwoPhase.tla")).read()
    raft = open(os.path.join(os.path.dirname(out["raft"]),
                             "RaftReplication.tla")).read()
    for key, files, cfg in (
            ("tp4", {"TwoPhase.tla": two, "MC.cfg": TP4_CFG}, "MC.cfg"),
            ("porv", {"PorV.tla": PORV_TLA.replace("{N}", "4"),
                      "PorV.cfg": PORV_CFG}, "PorV.cfg"),
            ("porw", {"PorV.tla": PORV_TLA.replace("{N}", str(PORW_N)),
                      "PorV.cfg": PORV_CFG}, "PorV.cfg"),
            ("symv", {"SymV.tla": SYMV_TLA, "SymV.cfg": SYMV_CFG},
             "SymV.cfg"),
            ("rr4", {"RaftReplication.tla": raft, "MC.cfg": RR4_CFG},
             "MC.cfg"),
            # Model_sym with a comment appended: another digest, so the
            # lying plan's backend is a memo entry of its own
            ("lie", {"TwoPhase.tla": open(os.path.join(
                os.path.dirname(out["sym"]), "TwoPhase.tla")).read()
                + "\n\\* orbit-lie copy\n", "MC.cfg": open(out["sym"]).read()},
             "MC.cfg")):
        os.makedirs(os.path.join(d, key), exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(d, key, fname), "w") as f:
                f.write(text)
        out[key] = os.path.join(d, key, cfg)
    if not os.path.exists(os.path.join(d, "Model_FF")):
        write_model(d, "Model_FF", False, False)
    out["ff"] = os.path.join(d, "Model_FF", "MC.cfg")
    return out


def ptxas_lines(prog, kernels):
    """Registers, stack frame and spills of the named kernels (and of the
    out-of-line st_canon_row) from the `-Xptxas -v` report of a program's
    emitted library."""
    from torchtlc.kernels.build import build_struct

    log = os.path.join(os.path.dirname(build_struct(prog.text)), "nvcc.log")
    out, entry = {}, None
    for line in open(log).read().splitlines():
        if "Function properties for " in line:
            entry = line.split("Function properties for ")[1].strip()
        elif entry and "stack frame" in line:
            out.setdefault(entry, {})["frame"] = line.strip()
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "Used" in line and "registers" in line:
            out.setdefault(entry, {})["regs"] = line.split("Used")[1].split(
                ",")[0].strip()
    return {k: v for k, v in out.items()
            if any(n in k for n in kernels + ("st_canon_row",))}


def backends19(ops, tmp):
    """The reduced struct backends of phases 19-19c and their emitted
    libraries, built one nvcc per text, in parallel: {name: backend} -
    every P19_RUNS model reduced (RaftReplication also narrowed), the POR
    spec and its widened form with and without -por, RaftReplication with
    four servers with and without -symmetry, SymV, and the lying plan
    (TORCHTLC_DEBUG_SYM_LIE=1 while its backend is built, on a copy of
    Model_sym: phase 19c's command finds it in the memo)."""
    from concurrent.futures import ThreadPoolExecutor

    from torchtlc.struct.cache import get_backend, get_bounds
    from torchtlc.struct.loader import load

    cfgs = models19(tmp)
    models = {k: load(cfgs[k]) for k in ("sym", "raft", "tp4", "porv",
                                         "porw", "symv", "rr4", "lie")}
    out = {}
    for name, key, _, red, modes in P19_RUNS:
        out[name] = get_backend(models[key], False, **red)
        if "narrow" in modes:
            out[name + "/narrow"] = get_backend(
                models[key], False, bounds=get_bounds(models[key]), **red)
    out["PorV/base"] = get_backend(models["porv"], False)
    out["PorW"] = get_backend(models["porw"], False, por=True)
    out["PorW/base"] = get_backend(models["porw"], False)
    out["RR4"] = get_backend(models["rr4"], False, symmetry=True)
    out["RR4/base"] = get_backend(models["rr4"], False)
    out["SymV"] = get_backend(models["symv"], True, symmetry=True)
    os.environ["TORCHTLC_DEBUG_SYM_LIE"] = "1"
    try:
        out["lie"] = get_backend(models["lie"], False, symmetry=True)
    finally:
        del os.environ["TORCHTLC_DEBUG_SYM_LIE"]
    texts = {b.kernels.prog.text: b.kernels.prog for b in out.values()}
    t0 = time.time()
    with ThreadPoolExecutor(len(texts)) as pool:
        list(pool.map(ops.struct_lib, texts.values()))
    prog = out["RR4"].kernels.prog
    print(f"phase 19 build: {len(texts)} emitted libraries (K17/K18/K21 "
          f"with K24-K26) in {time.time() - t0:.1f} s; RR4 F {prog.F}, L "
          f"{prog.L}, {len(prog.sym_programs)} programs, K {prog.K.size} "
          f"words; ptxas (RR4 -symmetry): " + "; ".join(
              f"{k[:60]}: {v.get('regs', '-')}, "
              f"{v.get('frame', '-')}" for k, v in ptxas_lines(
                  prog, ("struct_expand_kernel", "struct_canon_kernel",
                         "struct_orbit_check_kernel",
                         "emitted_expand_sharded_kernel")).items()),
          flush=True)
    return out, models, cfgs


def struct_run19(ops, model, kw, modes):
    """struct_run with the reduction's launch breakdown: (result, launches,
    {K24 / K26: launches by the kernel they rode in})."""
    r, launches = struct_run(ops, model, kw, modes)
    return r, launches, {k: dict(v) for k, v in ops.REDUCE_LAUNCHES.items()}


def canon_bytes_ops(prog, N):
    """K24's bytes and integer operations over N rows: F words in and out
    a row; a program's gather (F), its remap tables (a clip, a read, a
    guard, a select: 4 each), its mask bits (a shift, a mask and an or:
    3 each) and the F-wide lexicographic compare and select (3F)."""
    per = sum(prog.F + 4 * len(p.tables) + 3 * sum(len(m[2])
                                                   for m in p.masks)
              + 3 * prog.F for p in prog.sym_programs)
    return N * prog.F * 8, N * per


def k24_check(torch, ops, tag, prog, rows, record=None, reps=20):
    """K24 bitwise against its plain version on raw rows [N, F] - and on
    seeded rows with codes out of range, which go through the same
    clipped lookups; timed into `record` when given."""
    import numpy as np

    got = ops.struct_canon(prog, rows)
    want = prog.plan.canon(rows)
    need(torch.equal(got, want), f"K24 ({tag}) differs from its plain "
         "version")
    mc = np.asarray(prog.cdc.max_codes(), np.int64)
    rnd = torch.from_numpy(np.random.default_rng(SEED).integers(
        -2, mc + 3, size=(4096, prog.F)).astype(np.int32)).to(rows.device)
    need(torch.equal(ops.struct_canon(prog, rnd), prog.plan.canon(rnd)),
         f"K24 ({tag}, out-of-range codes) differs from its plain version")
    if record is not None:
        N = rows.shape[0]
        record("struct_canon", tag, 0,
               cuda_ms(torch, lambda _: ops.struct_canon(prog, rows), reps),
               cuda_ms(torch, lambda _: prog.plan.canon(rows), 2),
               *gen_bound_ms(*canon_bytes_ops(prog, N)))
    return got


def k17_red_check(torch, ops, tag, prog, block, n):
    """K17 with K24 / K26 inside (both modes) and K25 after it against
    their plain versions on one popped block: every output bitwise, the
    pruned count and the orbit check included.  Returns (deferred flat,
    valid flags, the orbit check)."""
    for deferred in (False, True):
        got = ops.struct_expand(prog, block, n, deferred)
        ref = prog.expand_red_plain(block, n, deferred)
        pairs = zip(got[:5] + got[6:], ref[:5] + ref[7:])  # cert: None
        for i, (a, b) in enumerate(pairs):
            need((a is None) == (b is None) and (
                a is None or torch.equal(a.to(torch.int64),
                                         b.to(torch.int64))),
                 f"K17 with K24/K26 ({tag}, deferred={deferred}) output {i} "
                 "differs from its plain version")
        if prog.sym_programs:
            k25 = bool(ops.struct_orbit_check(prog, block, got[1][0]))
            need(k25 == bool(ref[6]), f"K25 ({tag}): kernel {k25}, plain "
                 f"{bool(ref[6])}")
    return got[4], got[1][0], bool(ref[6]) if ref[6] is not None else None


def plain_pin19(model, kw, modes):
    """The pin of a run the reference's CPU engine could not give in
    minutes (TwoPhase with RM of 4: its XLA program of 23 mask programs):
    the port's plain run on the host, whose plan CPU tests hold against
    the reference's program for program."""
    from torchtlc.struct.engine import check_struct

    r = check_struct(model, check_deadlock=False, capture_fps=True,
                     device="cpu", **kw, **modes)
    return dict(counts=[r.generated, r.distinct, r.depth],
                outdegree=list(r.outdegree), act_gen=r.action_generated,
                act_dist=r.action_distinct, sha=struct_digest(r.fp_table),
                sym=r.sym_violated, pruned=r.por_pruned)


def phase_reduce19(torch, ops, card, runs, tmp):
    """Phase 19: check_struct reduced at the shipped sizes - TwoPhase
    Model_sym and RaftReplication Model_1 (-symmetry), TwoPhase with RM of
    4 (24 permutations, the mask programs), the two-counter spec (-por),
    sorted immediate and slab deferred (ring on), Model_sym pipelined,
    RaftReplication narrowed and reduced together: the reference's counts,
    per-action counts, outdegree and table words (TwoPhase-4: the plain
    run's on the host), the orbit check clean,
    the POR count 4; K24 in every K17 launch, K25 once a body, K26 in
    K17.  Model_sym on 4 shards (K24 in K21).  K17 with K24 / K26 and K25
    bitwise against their plain versions on popped blocks, K24 on raw and
    out-of-range rows, K26 on random masks; the lying plan trips K25 (and
    its plain version) and latches the carry's flag and the ring's COL_SYM
    (K8 against its plain version)."""
    import numpy as np

    from torchtlc.engine import bfs
    from torchtlc.engine.sharded import ShardMesh
    from torchtlc.obs import counters
    from torchtlc.struct.engine import check_struct_sharded

    backends, models, cfgs = backends19(ops, tmp)
    rows = {}
    record = gen_recorder(rows)
    out, lines = {}, []
    for name, key, kw, red, modes in P19_RUNS:
        for mode in modes:
            extra = dict(P19_MODES[mode], **red)
            if mode == "narrow":
                from torchtlc.struct.cache import get_bounds

                extra["bounds"] = get_bounds(models[key])
            r, launches, rl = struct_run19(ops, models[key], kw, extra)
            pin = P19_PINS.get(f"{name}/{mode}")
            if pin is None:  # TwoPhase/RM4: the plain run on the host
                pin = plain_pin19(models[key], kw, extra)
            struct_pinned(f"{name} {mode}", r, pin)
            need(r.sym_violated == pin["sym"]
                 and r.por_pruned == pin["pruned"],
                 f"{name} {mode}: orbit check {r.sym_violated}, pruned "
                 f"{r.por_pruned}")
            k17 = launches["struct_expand"]
            if red.get("symmetry"):
                # K24 rides in every K17 launch, and once alone on the
                # Init seeds
                need(rl["struct_canon"]["struct_expand"] == k17 > 0
                     and launches["struct_orbit_check"] == k17
                     and rl["struct_canon"]["struct_canon"] == 1,
                     f"{name} {mode}: K24 / K25 launches {rl}, {launches}")
            if red.get("por"):
                need(rl["struct_por_keep"]["struct_expand"] == k17 > 0,
                     f"{name} {mode}: K26 launches {rl}")
            out[f"p19_{name}_{mode}"] = {"launches": launches}
            lines.append(f"{name} {mode} {r.iterations} steps "
                         f"{r.wall_s:.3f} s")
    # Model_sym on 4 shards: K24 inside K21, canonical seeds
    ops.reset_counts()
    r = check_struct_sharded(models["sym"], ShardMesh(4, "cuda"),
                             check_deadlock=False, symmetry=True, **SYM_KW)
    pin = P19_PINS["TwoPhase/Model_sym/sorted"]
    need([r.generated, r.distinct, r.depth] == pin["counts"]
         and r.action_generated == pin["act_gen"] and r.violation == 0,
         f"Model_sym on 4 shards: {(r.generated, r.distinct, r.depth)}")
    need(ops.REDUCE_LAUNCHES["struct_canon"]["emitted_expand_sharded"]
         == ops.LAUNCHES["emitted_expand_sharded"] > 0,
         "Model_sym on 4 shards: K24 did not ride in K21")
    out["p19_sym_sharded"] = {"launches": dict(ops.LAUNCHES)}
    # the kernels on popped blocks
    checks = []
    for name, kw in (("RaftReplication/Model_1", RAFT_SYM_KW),
                     ("TwoPhase/RM4", P19_RUNS[2][2])):
        b = backends[name]
        prog = b.kernels.prog
        block, n, _ = struct_block(torch, b, kw, lambda c: int(c.level) > 5)
        flat, valid, k25 = k17_red_check(torch, ops, name, prog, block, n)
        raw = prog.step_plain(prog.cdc.unpack(block))[0].reshape(
            -1, prog.F).to(torch.int32).contiguous()  # the raw successors
        k24_check(torch, ops, name, prog, raw, record)
        record("struct_orbit_check", name, 0,
               cuda_ms(torch, lambda _: ops.struct_orbit_check(
                   prog, block, valid), 20),
               cuda_ms(torch, lambda _: prog.plan.orbit_check(
                   flat, valid.bool()), 2),
               *gen_bound_ms(int(torch.nonzero(valid)[0]) + 1
                             + prog.W * 4 + 4,
                             canon_bytes_ops(prog, 1 + len(
                                 prog.sym_programs))[1]))
        checks.append(f"{name} block of {n} rows: K17 (both modes) and K25 "
                      f"= plain, orbit check {k25}")
    pb = backends["PorV"]
    pprog = pb.kernels.prog
    block, n, _ = struct_block(torch, pb, P19_RUNS[3][2], lambda c: True)
    k17_red_check(torch, ops, "PorV", pprog, block, n)
    rng = np.random.default_rng(SEED)
    for B, dens in ((1, 0.5), (4097, 0.4), (16384, 0.9)):
        v = torch.from_numpy(rng.random((B, pprog.L)) < dens).cuda()
        need(torch.equal(ops.struct_por_keep(pprog, v),
                         pb.kernels.por_keep(v.cpu()).cuda()),
             f"K26 on a random [{B}, {pprog.L}] mask differs from its "
             "plain version")
    # the lie: K25 trips (kernel and plain), the flag and COL_SYM latch
    lb = backends["lie"]
    lprog = lb.kernels.prog
    init_fn, run_fn, _ = bfs.make_backend_engine(
        lb, obs_slots=8, sort_free=False, deferred=False,
        **dict(SYM_KW, chunk=32))
    c = run_fn(init_fn())
    rows_ = bfs.obs_rows(c)[0]
    need(bool(c.sym_viol) and rows_ and rows_[-1].get("sym_violation"),
         "the lying plan did not latch the orbit flag and COL_SYM")
    tripped = 0
    init_fn, _, step_fn = bfs.make_backend_engine(
        lb, sort_free=False, deferred=False, **dict(SYM_KW, chunk=8))
    c2 = init_fn()
    while not bfs.carry_done(c2) and tripped == 0:
        h = bfs.read_bundle(c2)
        blk = c2.queue[h.parity, h.qhead:h.qhead + 8].clone()
        k = min(h.level_n - h.qhead, 8)
        _, _, k25 = k17_red_check(torch, ops, "lie", lprog, blk, k)
        tripped += int(k25)
        c2 = step_fn(c2)
    need(tripped, "K25 never tripped on the lying plan's blocks")
    ring = c.obs_ring.clone()
    hb = [x.clone() for x in (c.obs_head, c.obs_bodies, c.obs_expanded)]
    outs = []
    for fn in (counters.ring_row, counters.ring_row_plain):
        rr = ring.clone()
        st = [x.clone() for x in hb]
        fn(rr, *st, 8, True, c.level, c.generated, c.generated, c.distinct,
           c.distinct, c.level_n, c.act_gen, c.act_dist,
           torch.cat([c.act_gen, c.act_dist]), len(lb.labels),
           sym=c.sym_viol)
        outs.append(rr)
    need(torch.equal(outs[0], outs[1])
         and int(outs[0][int(c.obs_head) % 8, counters.COL_SYM]) == 1,
         "K8's COL_SYM differs from its plain version")
    print(f"phase 19 -symmetry / -por: the reference's counts, per-action "
          f"counts, outdegree and table words on every run, orbit check "
          f"clean, K24 in every K17 launch, K25 once a body, POR pruned 4; "
          + "; ".join(lines) + f"; Model_sym on 4 shards {r.distinct} "
          f"distinct, K24 in K21; " + "; ".join(checks) + "; K26 = plain "
          f"on random masks; the lie latched COL_SYM (K8 = plain) and "
          f"tripped K25 on a block; K24 {rows['struct_canon'][0]['ms']:.4f} "
          f"ms on {rows['struct_canon'][0]['shape']} (plain "
          f"{rows['struct_canon'][0]['plain_ms']:.3f} ms), K25 "
          f"{rows['struct_orbit_check'][0]['ms']:.4f} ms on {card}",
          flush=True)
    out.update(p19_rows=rows, p19_backends=backends, p19_models=models,
               p19_cfgs=cfgs)
    return out


def full_block(torch, backend, kw):
    """The first full-width block of a sorted immediate run: the `chunk`
    rows the engine is about to pop when a level holds at least that many
    more.  Returns (block, chunk)."""
    from torchtlc.engine import bfs

    ck = kw["chunk"]
    init_fn, _, step_fn = bfs.make_backend_engine(
        backend, ck, kw["queue_capacity"], kw["fp_capacity"],
        sort_free=False, deferred=False)
    c = init_fn()
    while True:
        h = bfs.read_bundle(c)
        need(bfs._running(h), "the run ended before a full-width block")
        if h.level_n - h.qhead >= ck:
            return c.queue[h.parity, h.qhead:h.qhead + ck].clone(), ck
        c = step_fn(c)


def phase_reduce19_real(torch, ops, card, runs):
    """Phase 19b: RaftReplication with four servers (MaxLog 2, MaxTerm 7)
    at chunk 16,384 in the default modes, reduced (fp 2^21) and not (fp
    2^23) in turns (reduced, full, full, reduced): the reference's counts,
    the orbit check clean, each variant's table words the same in both of
    its runs; walls, distinct states per second, the reduction factor, the
    device's busy share of a reduced run (torch.profiler).  On a
    16,384-row block (589,824 candidates): K17 with K24 (the reduced text)
    and without (the full one), K24 alone on the block's raw successors,
    K25; on a full-width block of the widened POR spec (16,384 live rows):
    K17 with K26 and without, K26 alone."""
    import numpy as np

    backends = runs["p19_backends"]
    models = runs["p19_models"]
    rows = runs["p19_rows"]
    record = gen_recorder(rows)
    out = {}
    walls = {"sym": [], "base": []}
    shas = {"sym": set(), "base": set()}
    m = models["rr4"]
    for which in ("sym", "base", "base", "sym"):
        kw = dict(RR4_KW, fp_capacity=RR4_FP[which])
        r, launches, rl = struct_run19(ops, m, kw, dict(
            symmetry=which == "sym"))
        need((r.generated, r.distinct, r.depth) == RR4_COUNTS[which]
             and r.violation == 0, f"RR4 {which}: "
             f"{(r.generated, r.distinct, r.depth)}, {r.violation}")
        need(r.sym_violated is (False if which == "sym" else None),
             f"RR4 {which}: orbit check {r.sym_violated}")
        shas[which].add(struct_digest(r.fp_table))
        if which == "sym":
            need(launches["struct_orbit_check"] == launches["struct_expand"]
                 == rl["struct_canon"]["struct_expand"] > 0,
                 f"RR4: K24 / K25 launches {rl}, {launches}")
        out.setdefault(f"p19b_rr4_{which}", {"launches": launches})
        walls[which].append((round(r.wall_s, 4),
                             int(r.distinct / r.wall_s)))
        del r
        torch.cuda.empty_cache()
    need(len(shas["sym"]) == len(shas["base"]) == 1,
         "RR4: a variant's table words differ between its two runs")
    kw = dict(RR4_KW, fp_capacity=RR4_FP["sym"])
    (r, _, _), traced, busy, by_name = device_busy(
        torch, lambda: struct_run19(ops, m, kw, dict(symmetry=True)))
    k17_s = sum(v for k, v in by_name.items() if "struct_expand" in k)
    k25_s = sum(v for k, v in by_name.items() if "orbit_check" in k)
    prog = backends["RR4"].kernels.prog
    bprog = backends["RR4/base"].kernels.prog
    block, n = full_block(torch, backends["RR4"], kw)
    flat19, valid, _ = k17_red_check(torch, ops, "RR4", prog, block, n)
    raw = ops.struct_expand(bprog, block, n, True)[4]
    k24_check(torch, ops, "RR4", prog, raw, record, reps=10)
    t_sym = cuda_ms(torch, lambda _: ops.struct_expand(prog, block, n, True),
                    10)
    t_base = cuda_ms(torch, lambda _: ops.struct_expand(bprog, block, n,
                                                        True), 10)
    t25 = cuda_ms(torch, lambda _: ops.struct_orbit_check(prog, block,
                                                          valid), 10)
    record("struct_orbit_check", "RR4", 0, t25,
           cuda_ms(torch, lambda _: prog.plan.orbit_check(
               flat19, valid.bool()), 2),
           *gen_bound_ms(int(torch.nonzero(valid)[0]) + 1 + prog.W * 4 + 4,
                         canon_bytes_ops(prog, 1 + len(prog.sym_programs))[1]
                         ))
    # K26 on a full-width block of the widened POR spec: every (x, y)
    pw = backends["PorW"].kernels.prog
    pwb = backends["PorW/base"].kernels.prog
    states = [(x, y) for x in range(PORW_N) for y in range(PORW_N)]
    wblock = pw.cdc.pack(torch.from_numpy(np.stack(
        [pw.cdc.encode(st) for st in states]).astype(np.int32))).cuda()
    wn = wblock.shape[0]
    got = k17_red_check(torch, ops, "PorW", pw, wblock, wn)
    t_por = cuda_ms(torch, lambda _: ops.struct_expand(pw, wblock, wn, True),
                    20)
    t_nopor = cuda_ms(torch, lambda _: ops.struct_expand(pwb, wblock, wn,
                                                         True), 20)
    wvalid = ops.struct_expand(pwb, wblock, wn, True)[1][0].bool().view(
        wn, pw.L).contiguous()
    need(torch.equal(ops.struct_por_keep(pw, wvalid),
                     backends["PorW"].kernels.por_keep(wvalid.cpu()).cuda()),
         "K26 on the widened block differs from its plain version")
    B, L = wvalid.shape
    record("struct_por_keep", "PorW", 0,
           cuda_ms(torch, lambda _: ops.struct_por_keep(pw, wvalid), 20),
           cuda_ms(torch, lambda _: backends["PorW"].kernels.prog._pruned(
               wvalid), 3),
           *gen_bound_ms(2 * B * L, 4 * B * L))
    pruned = int(ops.struct_expand(pw, wblock, wn, True)[6])
    k24 = rows["struct_canon"][-1]
    k25 = rows["struct_orbit_check"][-1]
    k26 = rows["struct_por_keep"][-1]
    print(f"phase 19b RR4 (Nodes n1..n4, MaxLog 2, MaxTerm 7; chunk "
          f"{kw['chunk']}, slab + deferred): reduced {RR4_COUNTS['sym']}, "
          f"full {RR4_COUNTS['base']} (the reference's counts), factor "
          f"{RR4_COUNTS['base'][1] / RR4_COUNTS['sym'][1]:.2f}, orbit check "
          f"clean; (wall s, distinct/s) in turns: reduced {walls['sym']}, "
          f"full {walls['base']}; reduced run under torch.profiler: wall "
          f"{traced:.3f} s, device busy {busy:.3f} s ({busy / traced:.1%}), "
          f"K17 {k17_s:.3f} s, K25 {k25_s:.4f} s; 16,384-row block "
          f"({raw.shape[0]} candidates): K17 with K24 {t_sym:.4f} ms, "
          f"without {t_base:.4f} ms; K24 alone {k24['ms']:.4f} ms (plain "
          f"{k24['plain_ms']:.2f} ms, bound {k24['bound_ms']:.5f} ms by "
          f"{k24['bound_by']}); K25 {k25['ms']:.4f} ms a body (plain "
          f"{k25['plain_ms']:.2f} ms); widened POR block ({wn} rows, "
          f"{wn * pw.L} candidates, {pruned} pruned): K17 with K26 "
          f"{t_por:.4f} ms, without {t_nopor:.4f} ms; K26 alone "
          f"{k26['ms']:.4f} ms (plain {k26['plain_ms']:.3f} ms, bound "
          f"{k26['bound_ms']:.6f} ms) on {card}", flush=True)
    out["p19b_k17"] = dict(k17_ms=t_base, k17_sym_ms=t_sym, k25_ms=t25,
                           k17_por_ms=t_por, k17_nopor_ms=t_nopor,
                           busy=busy / traced, walls=walls)
    return out


SYM19 = ["-symmetry", "-nodeadlock"]
TERM19 = SYM19 + ["-chunk", "4", "-checkpoint", "CK/s", "-checkpointevery",
                  "2"]
# phase 19c: tag -> (model key of models19, argv after the MC.cfg; CK: the
# checkpoint directory)
CMD19 = {
    "sym": ("sym", SYM19),
    "nosym": ("sym", ["-no-symmetry", "-nodeadlock"]),
    "porv": ("porv", ["-por", "-nodeadlock", "-frontend", "struct", "-chunk",
                      "4"]),
    "symv": ("symv", ["-symmetry", "-frontend", "struct", "-chunk", "64"]),
    "symv_full": ("symv", ["-no-symmetry", "-frontend", "struct", "-chunk",
                           "64"]),
    "term": ("sym", TERM19 + ["-faults", "sigterm@3"]),
    "recover": ("sym", TERM19 + ["-recover"]),
    "spill": ("sym", SYM19 + ["-chunk", "16", "-qcap", "256", "-fpcap", "64",
                              "-faults", "alloc_fail@1", "-checkpoint",
                              "CK/sp"]),
    "sharded": ("sym", SYM19 + ["-sharded", "4"]),
    "phase_timing": ("sym", SYM19 + ["-phase-timing"]),
    "lie": ("lie", SYM19),
    "reconciler": ("recon", ["-symmetry", "-por"]),
    "kubeapi": ("ff", ["-symmetry", "-por", "-chunk", "128"]),
    "rr4": ("rr4", SYM19 + ["-chunk", str(RR4_KW["chunk"]), "-qcap",
                            str(RR4_KW["queue_capacity"]), "-fpcap",
                            str(RR4_FP["sym"])]),
}
# (exit code, SHA-256 of cmd17_masked) of `python -m jaxtlc.cli check
# <MC.cfg> -noTool <argv> -workers cpu` in one process, in CMD19's order,
# the reference's 8 virtual CPU devices for -sharded, JAXTLC_DEBUG_SYM_LIE=1
# for the lie; RR4: its counts are checked instead (RR4_COUNTS)
CMD19_TRANSCRIPT = {
    'sym': (0, '8b0d8cde456bcaf5ca802996f87050b6'
            '2794f960c8dd3488f556375b4d0bc8e5'),
    'nosym': (0, 'ec88180cb75aa1ea3eef95a397a93bf0'
              'f8685dab0774402f05ebbbd7d26935b1'),
    'porv': (0, 'ad6c5daa2888235092e1a1e7fe76dfc1'
             'f32582ddec6ef8d1a74a8e6b0c1aa15d'),
    'symv': (12, '9e1af10bc4f0cd46f1c7ac0c0db1981c'
             '2a43c1ef351168e3301b23079c4f79db'),
    'symv_full': (12, '5fbca144b87406e6aa58626867971468'
                  '56859ada0383f8232dea30570f3966ae'),
    'term': (75, '1d4f7a9804819d76a5692625746176a7'
             '199a138d290e5ff2fc263f1f67843c9e'),
    'recover': (0, '978ac605360d8f028a5e0808e4c8f963'
                'ae5118054e15b17c814c2087722ccddc'),
    'spill': (0, 'd2dd600c992e9d04ba58ded2ce854b90'
              '33d53d6dd646541cf93b4c8cce21bab9'),
    'sharded': (0, '20f3f128f446e28022710ddde69be76f'
                '726832179747e7d50113a7730fef7c49'),
    'phase_timing': (0, '8b0d8cde456bcaf5ca802996f87050b6'
                     '2794f960c8dd3488f556375b4d0bc8e5'),
    'lie': (1, '343bf14fd0dc468ebe55c30ff1a87910'
            '9bb4063f7271dbb9fb4df2130a96598e'),
    'reconciler': (0, 'e25bed2ddec9c0c3740bd65ac895276e'
                   '5b9aef9fd6cdee16625395e027dd645f'),
    'kubeapi': (0, 'c20393cb8e8dd988887dea062d04c820'
                'de8c90c04988422077711953e6055417'),
    'rr4': (0, None),
}


def phase_command19(ops, card, runs, tmp):
    """Phase 19c: `python -m torchtlc.cli check` in this process with
    -symmetry / -por - Model_sym with and without -symmetry, the POR spec,
    SymV's exit-12 trace with and without -symmetry (the same trace from
    the banner to the Progress line), SIGTERM (exit 75) then -recover
    -symmetry (and -recover without the flag refused: the checkpoint's
    symmetry key), the spill rung, -sharded 4, -phase-timing, the lying
    plan (exit 1, its banner once), Reconciler and the KubeAPI pair (the
    flags ignored): each exit code and transcript equal to the
    reference's (digests pinned); RR4 with -symmetry: the reference's
    counts."""
    cfgs = runs["p19_cfgs"] if "p19_cfgs" in runs else models19(tmp)
    ckdir = os.path.join(tmp, "ck19")
    os.makedirs(ckdir)
    out, lines, texts = {}, [], {}
    for tag, (key, extra) in CMD19.items():
        cfg = cfgs[key]
        argv = [cfg, "-noTool"] + [x.replace("CK", ckdir) for x in extra]
        if tag == "recover":  # first without -symmetry: refused
            try:
                command_here(ops, [a for a in argv if a != "-symmetry"])
            except ValueError as e:
                need("checkpoint symmetry mismatch" in str(e),
                     f"-recover without -symmetry: {e}")
            else:
                raise SmokeFailure("-recover without -symmetry resumed a "
                                   "reduced checkpoint")
        if tag == "lie":
            os.environ["TORCHTLC_DEBUG_SYM_LIE"] = "1"
        try:
            rc, text, launches, wall = command_here(ops, argv)
        finally:
            os.environ.pop("TORCHTLC_DEBUG_SYM_LIE", None)
        rc_want, sha_want = CMD19_TRANSCRIPT[tag]
        need(rc == rc_want, f"command {tag} exited {rc}")
        if sha_want is None:  # RR4: the reference's counts
            need(final_counts(text) == RR4_COUNTS["sym"],
                 f"command {tag}: {final_counts(text)}")
        else:
            sha = hashlib.sha256(cmd17_masked(text, cfg, ckdir).encode()
                                 ).hexdigest()
            need(sha == sha_want, f"command {tag}: the transcript differs "
                 "from the reference's")
        red = {k: dict(v) for k, v in ops.REDUCE_LAUNCHES.items()}
        if tag == "lie":
            need(text.count("ERROR: runtime orbit-certificate violation - ")
                 == 1 and "orbit-certificate violation: the symmetry"
                 in text, "the lie's banner and verdict")
        if tag == "sharded":
            need(red["struct_canon"]["emitted_expand_sharded"]
                 == launches["emitted_expand_sharded"] > 0
                 and launches["struct_orbit_check"] == 0,
                 "-sharded 4: K24 did not ride in K21, or K25 ran")
        if tag in ("reconciler", "kubeapi"):
            need(launches["struct_canon"] == launches["struct_por_keep"]
                 == launches["struct_orbit_check"] == 0,
                 f"{tag}: a reduction kernel ran")
        if tag in ("sym", "rr4", "phase_timing", "spill"):
            need(launches["struct_orbit_check"] > 0
                 and red["struct_canon"]["struct_expand"] > 0,
                 f"{tag}: K24 / K25 never ran")
        texts[tag] = text
        out[f"p19c_{tag}"] = {"launches": launches}
        lines.append(f"{tag} exit {rc} ({wall:.2f} s)")
    traces = [t[t.index("Invariant Small is violated"):t.index("Progress(")]
              for t in (texts["symv"], texts["symv_full"])]
    need(traces[0] == traces[1], "SymV: the trace differs with -symmetry")
    print("phase 19c commands, transcripts = the reference's: "
          + "; ".join(lines) + "; -recover without -symmetry refused; SymV's "
          f"trace the same with and without -symmetry on {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 20-20c: -simulate behind K27 struct_sim_step and K28 sim_fold
# ---------------------------------------------------------------------------

# the reference's sim models (tests/test_sim.py:33-101) and its lasso model
# (tests/test_infer.py:74-94)
SIM_TINY_TLA = """---- MODULE SimTiny ----
EXTENDS Naturals
CONSTANTS MAX
VARIABLES x, y

Init == /\\ x = 0
        /\\ y = 0

Up == /\\ x < MAX
      /\\ x' = x + 1
      /\\ y' = y

Down == /\\ x > 0
        /\\ x' = x - 1
        /\\ y' = y

Flip == /\\ x > 0
        /\\ y' = 1 - y
        /\\ x' = x

Next == Up \\/ Down \\/ Flip

Spec == Init /\\ [][Next]_<<x, y>>

InRange == x <= MAX
====
"""
SIM_TINY_CFG = "CONSTANT MAX = 4\nSPECIFICATION\nSpec\nINVARIANT\nInRange\n"
SIM_STEP_TLA = """---- MODULE {name} ----
EXTENDS Naturals
VARIABLES x

Init == x = 0

Step == /\\ x < 3
        /\\ x' = x + 1

Next == Step

Spec == Init /\\ [][Next]_x
{inv}====
"""
SIM_VIOL_CFG = "SPECIFICATION\nSpec\nINVARIANT\nNotOne\n"
LIVE_TLA = """---- MODULE LiveTiny ----
EXTENDS Naturals
VARIABLES x

Init == x = 0

Inc == /\\ x < 3
       /\\ x' = x + 1

Stay == /\\ x = 3
        /\\ x' = x

Next == Inc \\/ Stay

Spec == Init /\\ [][Next]_x

Unreached == (x = 1) ~> (x = 5)
====
"""
# RaftReplication with five servers and MaxTerm 6 ("RR5T6"): F 18, 3
# packed words, L 55, 5 actions, 4 invariants
RR5T6_CFG = RR5_CFG.replace("MaxTerm = 3", "MaxTerm = 6")
# phase 20: name -> (model key, check_deadlock, walkers, depth, fp
# capacity, seed)
SIM20 = {
    "SimTiny": ("tiny", False, 256, 64, 1 << 16, 7),
    "SimViol": ("viol", True, 256, 64, 1 << 16, 5),
    "SimDead": ("dead", True, 256, 64, 1 << 16, 1),
    "TwoPhase/Model_1": ("two", True, 256, 64, 1 << 16, 3),
    "TwoPhase/Model_1/nodeadlock": ("two", False, 256, 64, 1 << 16, 3),
    "RaftReplication/Model_1": ("raft", False, 256, 64, 1 << 16, 7),
    "TwoPhase/Model_sym": ("sym", False, 256, 64, 1 << 16, 11),
}
# phase 20b: RR5T6 at full width (the reference's counts, run on the CPU)
RR5T6_KW = dict(seed=7, walkers=65536, depth=100, fp_capacity=1 << 22,
                check_deadlock=False)
RR5T6_COUNTS = dict(steps=36, generated=6521172, transitions=1593840,
                    distinct=750018, fp_saturated=False, violation=0,
                    halted=65536)


def models20(tmp):
    """The model files of phases 20-20c in `tmp`/p20: {key: MC.cfg}."""
    here = os.path.dirname(os.path.abspath(__file__))
    specs = os.path.join(here, "specs")
    d = os.path.join(tmp, "p20")
    out = {"two": os.path.join(specs, "TwoPhase.toolbox", "Model_1",
                               "MC.cfg"),
           "sym": os.path.join(specs, "TwoPhase.toolbox", "Model_sym",
                               "MC.cfg"),
           "raft": os.path.join(specs, "RaftReplication.toolbox", "Model_1",
                                "MC.cfg")}
    raft = open(os.path.join(os.path.dirname(out["raft"]),
                             "RaftReplication.tla")).read()
    for key, files, cfg in (
            ("tiny", {"SimTiny.tla": SIM_TINY_TLA,
                      "SimTiny.cfg": SIM_TINY_CFG}, "SimTiny.cfg"),
            ("viol", {"SimViol.tla": SIM_STEP_TLA.format(
                name="SimViol", inv="\nNotOne == x # 1\n"),
                "SimViol.cfg": SIM_VIOL_CFG}, "SimViol.cfg"),
            ("dead", {"SimDead.tla": SIM_STEP_TLA.format(name="SimDead",
                                                         inv=""),
                      "SimDead.cfg": "SPECIFICATION\nSpec\n"}, "SimDead.cfg"),
            ("live", {"LiveTiny.tla": LIVE_TLA, "LiveTiny.cfg":
                      "SPECIFICATION\nSpec\nPROPERTY\nUnreached\n"},
             "LiveTiny.cfg"),
            ("rr5", {"RaftReplication.tla": raft, "MC.cfg": RR5_CFG},
             "MC.cfg"),
            ("rr5t6", {"RaftReplication.tla": raft, "MC.cfg": RR5T6_CFG},
             "MC.cfg"),
            ("tpb1", {"TwoPhaseB.tla": TPB24_TLA,
                      "TwoPhaseB.cfg": TPB24_CFG.replace("MAXR = 2",
                                                         "MAXR = 1")},
             "TwoPhaseB.cfg"),
            ("chain", {"LoadChain.tla": CHAIN24_TLA,
                       "LoadChain.cfg": CHAIN24_CFG}, "LoadChain.cfg")):
        os.makedirs(os.path.join(d, key), exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(d, key, fname), "w") as f:
                f.write(text)
        out[key] = os.path.join(d, key, cfg)
    return out


def sim_sha(leaves) -> str:
    """SHA-256 of a walk carry's leaves in the reference's order: each
    leaf's dtype, shape and bytes (the form the pins were digested in)."""
    import numpy as np

    h = hashlib.sha256()
    for a in map(np.asarray, leaves):
        h.update(f"{a.dtype.str}{tuple(a.shape)}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


# the reference's final carries on the CPU (jaxtlc.sim.engine
# get_sim_engine's run_fn after jit(init_fn)(seed), SIM20's geometry):
# (steps, generated, transitions, distinct, violation, sim_sha)
SIM20_PINS = {
    'SimTiny': (64, 43425, 16384, 10, 0,
        'ea2dfc6b352001ffae9e536c72fdbed0'
        'dadb0521adfaa660f8fe8135b877b873'),
    'SimViol': (1, 512, 256, 2, 100,
        'd272d616f5032fa52f7692146eb3ed95'
        '0b2b2e13612855fee568ac0767144193'),
    'SimDead': (4, 1024, 768, 4, 4,
        '499db222eae8fad2444367b4e5bff8a2'
        'd54e20ba4ccff0e14f88521508ef1c53'),
    'TwoPhase/Model_1': (4, 3560, 941, 36, 4,
        'e0fee2d8fde281bf45228afa46638d34'
        '9391ab89bbeee14eec1d1e8aeb1dcc67'),
    'TwoPhase/Model_1/nodeadlock': (14, 3875, 1114, 54, 0,
        'cfa8a68ba18f24c7ce6552589898bf64'
        'afc3826380738c2cb84cd38fc80b47d9'),
    'RaftReplication/Model_1': (18, 9437, 3606, 1414, 0,
        '032ae1e46ac66baeac41772f41cd1d5d'
        '4e7680d20d7ae81efea9d5ee7f53a23a'),
    'TwoPhase/Model_sym': (20, 7028, 1568, 224, 0,
        '783f619f7cc58e414652d6304fa27663'
        '9275d6105b1740cf082be5b33688c9e7'),
}


def backends20(ops, tmp):
    """The struct backends of phases 20-20c with their emitted libraries
    (K17/K18/K21 and K27/K28), one nvcc per text, in parallel:
    (cfgs, models, {key: backend})."""
    from concurrent.futures import ThreadPoolExecutor

    from torchtlc.struct.cache import get_backend
    from torchtlc.struct.loader import load

    cfgs = models20(tmp)
    models = {k: load(c) for k, c in cfgs.items()}
    out = {}
    for key, dl, *_ in SIM20.values():
        out[key, dl] = get_backend(models[key], dl)
    for key, dl in (("rr5t6", False), ("rr5", True), ("live", True)):
        out[key, dl] = get_backend(models[key], dl)
    texts = {b.kernels.prog.text: b.kernels.prog for b in out.values()}
    t0 = time.time()
    with ThreadPoolExecutor(len(texts)) as pool:
        list(pool.map(ops.struct_lib, texts.values()))
    prog = out["rr5t6", False].kernels.prog
    print(f"phase 20 build: {len(texts)} emitted libraries (K17/K18/K21 "
          f"with K27/K28) in {time.time() - t0:.1f} s; RR5T6 F {prog.F}, "
          f"W {prog.W}, L {prog.L}, {prog.n_labels} actions, {prog.n_inv} "
          f"invariants; ptxas: {ptxas_kernels(prog, ('sim_step', 'sim_fold'))}",
          flush=True)
    return cfgs, models, out


def ptxas_kernels(prog, names, text=None):
    """{kernel entry: 'N registers, S bytes stack, spills'} of the entries
    of a spec's library (built from `text`, by default the program's) whose
    mangled names hold one of `names`, from the ptxas report nvcc left
    beside it."""
    from torchtlc.kernels.build import build_struct

    log = os.path.join(os.path.dirname(build_struct(text or prog.text)),
                       "nvcc.log")
    return ptxas_entries(open(log).read(), names)


def ptxas_entries(log, names):
    """ptxas_kernels' parse of one nvcc report."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            cur = name if any(n in name for n in names) else None
            if cur:
                out[cur] = []
        elif cur and ("stack frame" in line or "Used" in line):
            out[cur].append(line.split(":")[-1].strip())

    def short(mangled):  # struct_sim_step_kernel<0,1>: its bool flags
        base = re.match(r"_Z\d+(\w+?kernel)", mangled).group(1)
        flags = re.findall(r"Lb(\d)E", mangled)
        return base + (f"<{','.join(flags)}>" if flags else "")

    return {short(k): "; ".join(v) for k, v in out.items()}


def clone_carry(c):
    from torchtlc.engine.fpset import FPSet

    return c._replace(**{
        f: (FPSet(v.table.clone()) if f == "fps" else v.clone())
        for f, v in c._asdict().items() if v is not None})


def clone_buffers(b):
    return b._replace(**{f: v.clone() for f, v in b._asdict().items()
                         if v is not None})


def sim_lane_ops(prog) -> int:
    """K27's integer operations a live lane: the statements of the emitted
    step and invariants (one operation each), the enabled count and the
    pick (2 a lane), three threefry2x32 (20 rounds of 3 operations plus
    the key schedule: ~80 each), the pack (~4 a field)."""
    body = prog.text.split("HD void st_step(", 1)[1]
    body = body.split("#include", 1)[0]
    return body.count(";") + 2 * prog.L + 3 * 80 + 4 * prog.F


def k27_bytes(prog, n_live, W) -> int:
    """K27's bytes once: the alive flag of every lane; of a live lane its
    F fields in and out, its steps_taken word, its packed row and take
    flag; the scratch."""
    return W * 2 + n_live * (prog.F * 8 + 4 + prog.W * 4 + 1) + 4 * (
        prog.n_inv + 6 + prog.n_labels)


def k27_k28_check(torch, ops, tag, prog, c, check_deadlock, depth,
                  record=None, reps=10):
    """K27 (its step form, with the packed rows) and then K28 against
    their plain versions on copies of the carry `c` and of fresh buffers:
    states, alive, steps_taken, the scratch, the packed rows and take
    flags, the old rows and actions at every class lane; then every leaf
    of the carry, the go flag and the reset scratch after K28.  Timed with
    `record`.  Returns the violation code K28 set."""
    from torchtlc.sim.engine import (SIM_MIN, SIM_NONE, carry_to_reference,
                                     sim_buffers)

    W = c.states.shape[0]
    base = sim_buffers(prog, W, "cuda", True)
    base.go.fill_(1)
    outs = []
    for kernel in (True, False):
        cc, bb = clone_carry(c), clone_buffers(base)
        if kernel:
            ops.struct_sim_step(prog, bb, cc.key, cc.step_i, cc.states,
                                cc.alive, cc.steps_taken, check_deadlock)
        else:
            prog.sim_step_plain(bb, cc.key, cc.step_i, cc.states, cc.alive,
                                cc.steps_taken, check_deadlock)
        outs.append((cc, bb))
    (ck, bk), (cp, bp) = outs
    for name in ("states", "alive", "steps_taken"):
        need(torch.equal(getattr(ck, name), getattr(cp, name)),
             f"K27 {name} differs from its plain version ({tag})")
    for name in ("scratch", "packed", "take"):
        need(torch.equal(getattr(bk, name), getattr(bp, name)),
             f"K27 {name} differs from its plain version ({tag})")
    mins = bk.scratch[SIM_MIN:SIM_MIN + prog.n_inv + 3].tolist()
    for lane in {m for m in mins if m != SIM_NONE}:
        need(torch.equal(bk.vact[lane], bp.vact[lane])
             and torch.equal(bk.vold[lane], bp.vold[lane]),
             f"K27 lane {lane}'s saved row or action ({tag})")
    ops.sim_fold(prog, bk, ck, depth)
    prog.sim_fold_plain(bp, cp, depth)
    for a, b in zip(carry_to_reference(ck), carry_to_reference(cp)):
        need(a.shape == b.shape and (a == b).all(),
             f"K28 differs from its plain version ({tag})")
    need(torch.equal(bk.go, bp.go) and torch.equal(bk.scratch, bp.scratch),
         f"K28 go / reset scratch differ from the plain version ({tag})")
    if record is not None:
        n_live = int(c.alive.sum())

        def setup():
            return clone_carry(c), clone_buffers(base)

        def k27(a):
            ops.struct_sim_step(prog, a[1], a[0].key, a[0].step_i,
                                a[0].states, a[0].alive, a[0].steps_taken,
                                check_deadlock)

        def k27_plain(a):
            prog.sim_step_plain(a[1], a[0].key, a[0].step_i, a[0].states,
                                a[0].alive, a[0].steps_taken, check_deadlock)

        def setup28():  # K28's input: a carry and scratch K27 stepped
            cc, bb = clone_carry(c), clone_buffers(base)
            k27((cc, bb))
            return cc, bb

        record("struct_sim_step", tag, 0, cuda_ms(torch, k27, reps, setup),
               cuda_ms(torch, k27_plain, 2, setup),
               *gen_bound_ms(k27_bytes(prog, n_live, W),
                             n_live * sim_lane_ops(prog)))
        S = bk.scratch.numel()
        record("sim_fold", tag, 0,
               cuda_ms(torch, lambda a: ops.sim_fold(prog, a[1], a[0],
                                                     depth), reps, setup28),
               cuda_ms(torch, lambda a: prog.sim_fold_plain(a[1], a[0],
                                                            depth), 2,
                       setup28),
               *gen_bound_ms(8 * S + 4 * prog.n_labels * 2 + 8 * prog.F
                             + 64, S + prog.n_labels + prog.F))
    return int(ck.viol)


def k27_init_check(torch, ops, tag, prog, backend, W, seed):
    """K27's kInit form against its plain version: the chosen Init states,
    the scratch, the packed rows and take flags."""
    import numpy as np

    from torchtlc.sim import threefry
    from torchtlc.sim.engine import sim_buffers, u32_tensor

    inits = torch.from_numpy(np.ascontiguousarray(np.asarray(
        backend.initial_vectors(), np.int32))).cuda()
    key = u32_tensor(threefry.prng_key(seed), "cuda")
    outs = []
    for kernel in (True, False):
        b = sim_buffers(prog, W, "cuda", True)
        st = torch.zeros(W, prog.F, dtype=torch.int32, device="cuda")
        if kernel:
            ops.struct_sim_init(prog, b, key, inits, st)
        else:
            prog.sim_init_plain(b, key, inits, st)
        outs.append((st, b))
    (sk, bk), (sp, bp) = outs
    need(torch.equal(sk, sp) and torch.equal(bk.scratch, bp.scratch)
         and torch.equal(bk.packed, bp.packed)
         and torch.equal(bk.take, bp.take),
         f"K27's kInit form differs from its plain version ({tag})")


def sim_run20(torch, ops, backend, W, D, cap, dl, seed):
    """One walk on the card through make_sim_engine's init_fn and run_fn,
    its launch counts reset just before and read just after: (carry, wall
    of run_fn, launches, engine)."""
    from torchtlc.sim.engine import make_sim_engine

    eng = make_sim_engine(backend, W, D, fp_capacity=cap, check_deadlock=dl)
    ops.reset_counts()
    c = eng[0](seed)
    torch.cuda.synchronize()
    t0 = time.time()
    c = eng[1](c)
    torch.cuda.synchronize()
    return c, time.time() - t0, dict(ops.LAUNCHES), eng


def phase_sim20(torch, ops, card, runs, tmp):
    """Phase 20: the walks of the CPU tests' models and TwoPhase Model_sym
    on the card through make_sim_engine (K27 and K28 every round, K2 and
    the sorted insert feeding the sampling filter): every final carry's
    leaves digested and pinned to the reference's CPU run.  K27 (kInit,
    the step with the packed rows) and K28 bitwise against their plain
    versions on walkers mid-walk - RaftReplication at round 5, a step
    where SimViol's lanes break NotOne and one where SimDead's deadlock."""
    from torchtlc.sim.engine import carry_to_reference

    cfgs, models, backends = backends20(ops, tmp)
    rows = {}
    record = gen_recorder(rows)
    out, lines = {}, []
    for name, (key, dl, W, D, cap, seed) in SIM20.items():
        b = backends[key, dl]
        c, wall, launches, eng = sim_run20(torch, ops, b, W, D, cap, dl, seed)
        leaves = carry_to_reference(c)
        steps, gen, trans, distinct, viol, sha = SIM20_PINS[name]
        got = (int(leaves[2]), int(leaves[5]), int(leaves[6]),
               int(leaves[14]), int(leaves[8]))
        need(got == (steps, gen, trans, distinct, viol),
             f"{name}: (steps, generated, transitions, distinct, viol) "
             f"{got}, the reference's {(steps, gen, trans, distinct, viol)}")
        need(sim_sha(leaves) == sha,
             f"{name}: the final carry differs from the reference's")
        # kInit and a round each (run_fn stops at most GO_READ_EVERY - 1
        # identity rounds after the walk's condition turns false)
        need(launches["struct_sim_step"] == launches["sim_fold"] > steps,
             f"{name}: K27 / K28 launches {launches}")
        out[f"p20_{name}"] = {"launches": launches}
        lines.append(f"{name} {steps} steps, {gen} generated, viol {viol} "
                     f"({wall:.3f} s)")
    checks = []
    for name, key, dl, seed, k, want in (
            ("RaftReplication/Model_1", "raft", False, 7, 5, 0),
            ("SimViol", "viol", True, 5, 0, 100),
            ("SimDead", "dead", True, 1, 3, 4)):
        b = backends[key, dl]
        prog = b.kernels.prog
        k27_init_check(torch, ops, name, prog, b, 256, seed)
        init_fn, _, step_fn = sim_run20(torch, ops, b, 256, 64, 1 << 16, dl,
                                        seed)[3]
        c = init_fn(seed)
        for _ in range(k):
            c = step_fn(c)
        got = k27_k28_check(torch, ops, name, prog, c, dl, 64,
                            record if key == "raft" else None)
        need(got == want, f"{name}: round {k + 1} set violation {got}")
        checks.append(f"{name} round {k + 1} (violation {got})")
    print("phase 20 -simulate: every final carry = the reference's "
          "(digests pinned): " + "; ".join(lines) + "; K27 (kInit, step, "
          "packed rows) and K28 = plain on " + ", ".join(checks) +
          f"; K27 {rows['struct_sim_step'][0]['ms']:.4f} ms, K28 "
          f"{rows['sim_fold'][0]['ms']:.4f} ms at 256 walkers on {card}",
          flush=True)
    out.update(p20_rows=rows, p20_cfgs=cfgs, p20_models=models,
               p20_backends=backends)
    return out


def phase_sim20_real(torch, ops, card, runs):
    """Phase 20b: RR5T6 at full width - 65,536 walkers, depth 100, seed 7,
    fp capacity 2^22, deadlock off - through torchtlc.sim.driver.run_sim:
    the reference's counts; the execution-only wall and transitions per
    second, the device's busy share (torch.profiler); K27 and K28 a round
    at 65,536 walkers mid-walk against their plain versions, timed, with
    their bounds."""
    from torchtlc.sim.driver import run_sim

    models, backends = runs["p20_models"], runs["p20_backends"]
    rows = runs["p20_rows"]
    record = gen_recorder(rows)
    m = models["rr5t6"]
    walls = []
    out = {}
    for i in range(2):
        ops.reset_counts()
        r = run_sim(m, **RR5T6_KW)
        got = {k: getattr(r, k) for k in RR5T6_COUNTS}
        need(got == RR5T6_COUNTS, f"RR5T6: {got}, the reference's "
             f"{RR5T6_COUNTS}")
        walls.append(round(r.wall_s, 4))
        out[f"p20b_rr5t6_{i}"] = {"launches": dict(ops.LAUNCHES)}
    r, traced, busy, by_name = device_busy(
        torch, lambda: run_sim(m, **RR5T6_KW))
    k27_s = sum(v for k, v in by_name.items() if "sim_step" in k)
    k28_s = sum(v for k, v in by_name.items() if "sim_fold" in k)
    b = backends["rr5t6", False]
    prog = b.kernels.prog
    from torchtlc.sim.engine import make_sim_engine

    init_fn, _, step_fn = make_sim_engine(
        b, 65536, 100, fp_capacity=1 << 22, check_deadlock=False)
    c = init_fn(7)
    for _ in range(10):
        c = step_fn(c)
    k27_k28_check(torch, ops, "RR5T6", prog, c, False, 100, record, reps=10)
    k27, k28 = rows["struct_sim_step"][-1], rows["sim_fold"][-1]
    print(f"phase 20b RR5T6 (Nodes n1..n5, MaxLog 2, MaxTerm 6; 65,536 "
          f"walkers, depth 100, seed 7, fp 2^22): {RR5T6_COUNTS} (the "
          f"reference's counts); execution walls {walls} s, "
          f"{RR5T6_COUNTS['transitions'] / min(walls):,.0f} transitions/s; "
          f"under torch.profiler: wall {traced:.3f} s, device busy "
          f"{busy:.3f} s ({busy / traced:.1%}), K27 {k27_s:.3f} s, K28 "
          f"{k28_s:.4f} s; a round at round 11: K27 {k27['ms']:.4f} ms "
          f"(plain {k27['plain_ms']:.1f} ms, bound {k27['bound_ms']:.5f} ms "
          f"by {k27['bound_by']}), K28 {k28['ms']:.4f} ms (plain "
          f"{k28['plain_ms']:.2f} ms, bound {k28['bound_ms']:.7f} ms) on "
          f"{card}", flush=True)
    out["p20b_rr5t6"] = dict(walls=walls, busy=busy / traced,
                             k27_ms=k27["ms"], k28_ms=k28["ms"])
    return out


SIM20_CMD = ["-simulate", "-walkers", "256", "-depth", "64"]
TERM20 = SIM20_CMD + ["-nodeadlock", "-sim-seed", "11", "-checkpoint",
                      "CK/s", "-checkpointevery", "4"]
# phase 20c: tag -> (model key of models20, argv after the MC.cfg; CK: the
# checkpoint directory)
CMD20 = {
    "rr5t6": ("rr5t6", ["-simulate", "-walkers", "65536", "-depth", "100",
                        "-sim-seed", "7", "-fpcap", str(1 << 22),
                        "-nodeadlock"]),
    "viol": ("viol", ["-simulate", "-walkers", "4", "-depth", "8",
                      "-sim-seed", "5", "-nodeadlock"]),
    "rr5_deadlock": ("rr5", ["-simulate", "-walkers", "8192", "-depth",
                             "100", "-sim-seed", "7"]),
    "clean": ("sym", TERM20[:-4] + ["-checkpoint", "CK/c"]),
    "term": ("sym", TERM20 + ["-faults", "sigterm@2"]),
    "recover": ("sym", TERM20 + ["-recover"]),
    "lasso": ("live", ["-simulate", "-walkers", "4", "-depth", "16"]),
}
# (exit code, SHA-256 of cmd17_masked) of `python -m jaxtlc.cli check
# <MC.cfg> -noTool <argv> -workers cpu` in one process, in CMD20's order;
# rr5t6: the reference's counts are checked instead (RR5T6_COUNTS)
CMD20_TRANSCRIPT = {
    'rr5t6': (0, None),
    'viol': (12, '1144414854b0039a56c35d9b8ab1543a'
        'a6d42009cc06a3e4d28549f2c726273b'),
    'rr5_deadlock': (12, '08b06dae8a30c92fa9cc44a30eafe58f'
        '4f7d76d789f0bb4a429a72369d3de297'),
    'clean': (0, 'e956ad72f5bae8a3f763e2cdae5a4f42'
        '327e88a9ceb4ff8f049fc4528417a572'),
    'term': (75, 'd57aa31988eaed91df793069fd38f4dc'
        '1f0ecdb67fb9100fe4473733ecf91cb8'),
    'recover': (0, '8ae7fde46903c3953c6f0b3fecc79324'
        'b9eab6ddc1695ed2b67146412f4f9367'),
    'lasso': (13, 'ae8c152e88f1b073c4d24a71733bf7e2'
        '5f082035906d83b1238eedafd26e21f8'),
}


def phase_command20(ops, card, runs, tmp):
    """Phase 20c: `python -m torchtlc.cli check ... -simulate` in this
    process - RR5T6 at 65,536 walkers (the reference's counts), SimViol's
    exit-12 trace, RaftReplication with five servers and deadlock on
    ("Deadlock reached" and its replayed trace, exit 12), Model_sym
    clean, stopped by sigterm@2 (exit 75) and resumed with -recover to the
    clean run's counts, and LiveTiny's lasso (exit 13): each exit code
    and transcript equal to the reference's (digests pinned)."""
    cfgs = runs["p20_cfgs"] if "p20_cfgs" in runs else models20(tmp)
    ckdir = os.path.join(tmp, "ck20")
    os.makedirs(ckdir)
    out, lines, texts = {}, [], {}
    for tag, (key, extra) in CMD20.items():
        cfg = cfgs[key]
        argv = [cfg, "-noTool"] + [x.replace("CK", ckdir) for x in extra]
        rc, text, launches, wall = command_here(ops, argv)
        rc_want, sha_want = CMD20_TRANSCRIPT[tag]
        need(rc == rc_want, f"command {tag} exited {rc}")
        if sha_want is None:  # RR5T6: the reference's counts
            c = RR5T6_COUNTS
            need(f"Simulation complete: 65536 walks, {c['transitions']} "
                 f"transitions taken to depth {c['steps']}, "
                 f"~{c['distinct']} distinct states sampled." in text
                 and f"{c['generated']} states generated, {c['distinct']} "
                 "distinct states found, 0 states left on queue." in text,
                 f"command {tag}: the counts differ from the reference's")
        else:
            sha = hashlib.sha256(cmd17_masked(text, cfg, ckdir).encode()
                                 ).hexdigest()
            need(sha == sha_want, f"command {tag}: the transcript differs "
                 "from the reference's")
        need(launches["struct_sim_step"] > 0 and launches["sim_fold"] > 0
             or tag == "recover", f"command {tag}: K27 / K28 never ran")
        texts[tag] = text
        out[f"p20c_{tag}"] = {"launches": launches}
        lines.append(f"{tag} exit {rc} ({wall:.2f} s)")
    need("Deadlock reached" in texts["rr5_deadlock"]
         and "State 1: <Initial predicate>" in texts["rr5_deadlock"],
         "RR5 with deadlock: no replayed deadlock trace")
    need(final_counts(texts["recover"])[:2] == final_counts(
        texts["clean"])[:2], "the resumed walk's counts differ from the "
         "uninterrupted run's")
    print("phase 20c commands, transcripts = the reference's: "
          + "; ".join(lines) + f"; the resumed walk = the clean one on "
          f"{card}", flush=True)
    return out



# -- phases 21-21c: invariant inference (K29, K30) ---------------------------

# x climbs to 3; Small says it never passes 1: exact evidence refutes it
INFER_VIOL_TLA = """---- MODULE InferViol ----
EXTENDS Naturals
VARIABLES x

Init == x = 0

Next == /\\ x < 3
        /\\ x' = x + 1

Spec == Init /\\ [][Next]_x

Small == x <= 1
====
"""
INFER_VIOL_CFG = "SPECIFICATION\nSpec\nINVARIANT\nSmall\n"
# phase 21: name -> (model key, budget); every run at seed 0 with the
# engine's defaults (64 walkers, depth 64, deadlock on, host BFS to 50,000)
INFER21 = {
    "TwoPhase/32": ("two", 32),
    "RaftElection/64": ("elect", 64),
    "RaftElection/1446": ("elect", 1446),
    "RaftReplication/64": ("repl", 64),
    "RaftReplication/157": ("repl", 157),
}
# phase 21b: RR5T6 (RaftReplication, Nodes n1..n5, MaxLog 2, MaxTerm 6),
# its whole pool, sampled evidence at full width, deadlock off
RR5T6_INFER_KW = dict(budget=419, walkers=65536, depth=100,
                      check_deadlock=False)
RR5T6_INFER_SEED = 7


def models21(tmp):
    """The model files of phases 21-21c in `tmp`/p21: {key: MC.cfg}."""
    here = os.path.dirname(os.path.abspath(__file__))
    specs = os.path.join(here, "specs")
    out = {key: os.path.join(specs, f"{name}.toolbox", "Model_1", "MC.cfg")
           for key, name in (("two", "TwoPhase"), ("elect", "RaftElection"),
                             ("repl", "RaftReplication"))}
    raft = open(os.path.join(os.path.dirname(out["repl"]),
                             "RaftReplication.tla")).read()
    d = os.path.join(tmp, "p21")
    for key, files, cfg in (
            ("viol", {"InferViol.tla": INFER_VIOL_TLA,
                      "InferViol.cfg": INFER_VIOL_CFG}, "InferViol.cfg"),
            ("rr5t6", {"RaftReplication.tla": raft, "MC.cfg": RR5T6_CFG},
             "MC.cfg"),
            ("tpb1", {"TwoPhaseB.tla": TPB24_TLA,
                      "TwoPhaseB.cfg": TPB24_CFG.replace("MAXR = 2",
                                                         "MAXR = 1")},
             "TwoPhaseB.cfg"),
            ("chain", {"LoadChain.tla": CHAIN24_TLA,
                       "LoadChain.cfg": CHAIN24_CFG}, "LoadChain.cfg")):
        os.makedirs(os.path.join(d, key), exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(d, key, fname), "w") as f:
                f.write(text)
        out[key] = os.path.join(d, key, cfg)
    return out


def infer_summary(rep) -> tuple:
    """(candidates, dropped, evidence, n_states, round sizes, killed,
    survivors, certified, SHA-256 of every field but the walls) of an
    InferReport: the form the reference's reports were pinned in."""
    whole = dict(
        candidates=rep.candidates, dropped=rep.dropped,
        uncompiled=list(rep.uncompiled), evidence=rep.evidence,
        exact=bool(rep.exact), n_states=int(rep.n_states),
        rounds=[dict(r) for r in rep.rounds], killed=int(rep.killed),
        survivors=[c.name for c in rep.survivors],
        certified=[c.name for c in rep.certified],
        cert_basis=list(rep.cert_basis), cfg_killed=list(rep.cfg_killed),
        seed=int(rep.seed))
    sha = hashlib.sha256(json.dumps(whole, sort_keys=True).encode())
    return (rep.candidates, rep.dropped, rep.evidence, int(rep.n_states),
            tuple(int(r["n_states"]) for r in rep.rounds), int(rep.killed),
            len(rep.survivors), len(rep.certified), sha.hexdigest())


# the reference's reports on the CPU (jaxtlc.infer.driver.InferEngine,
# JAXTLC_ARTIFACT_CACHE=off, .run(seed)): infer_summary's tuple
INFER21_PINS = {
    'TwoPhase/32': (5, 0, 'bfs', 56, (56,), 0, 5, 5,
        'f66e240f9ef2b79ec717c0e05acc5bc9'
        '1c4d577ee35497666206d23c5a674c6b'),
    'RaftElection/64': (64, 1382, 'bfs', 492, (492,), 56, 8, 8,
        '1c5381805c8d606728e3c8e03de7ed35'
        '511250b8b503b39cab53e5178723645e'),
    'RaftElection/1446': (1446, 0, 'bfs', 492, (492,), 1368, 78, 78,
        'b5a7363803a6d9d5c9ecffa7cdcf66b6'
        '33f5d6e2fb389177b1914f012bb38d83'),
    'RaftReplication/64': (64, 93, 'bfs', 7279, (7279,), 50, 14, 14,
        'ba14f98bd880bc3d536e4eb7e9e3aff8'
        'b71a8ae8bf58b01e2cb02c84c59dfafa'),
    'RaftReplication/157': (157, 0, 'bfs', 7279, (7279,), 141, 16, 16,
        'c77744f7dd7c7bab2b0136579b73cd7f'
        '0df7e3b6f563078b732e932b14d6e356'),
}
RR5T6_INFER_PIN = (
    419, 0, 'sim', 791410, (748613, 17369, 12714, 12714), 395, 24, 15,
    'ee2e09647573c39c819b2a8f9783fce4'
    '40387ffd318084d9c73ecbff7f9cb87b')
# RR5T6's survivors and certified candidates in the reference's report
RR5T6_INFER_NAMES = (
    ['TypeOK', 'AtMostOneLeader', 'CommitWithinLog', 'CommittedAgree']
    + [f"B{k}" for k in range(15)] + ['I1', 'I85', 'I169', 'I253', 'I337'],
    [f"B{k}" for k in range(15)])


def pred_stmts(prog) -> int:
    """The statements of the P emitted predicate bodies (st_pred_k), one
    integer operation each."""
    body = prog.text.split("HD bool st_pred_0(", 1)[-1]
    return body.split("HDN uint32_t st_pred_word_0(", 1)[0].count(";")


def step_stmts(prog) -> int:
    """The statements of the emitted step (st_step)."""
    body = prog.text.split("HD void st_step(", 1)[1]
    return body.split("HD bool st_pred_0(", 1)[0].count(";")


def valid_lanes(torch, prog, rows, chunk=1 << 14) -> int:
    """The valid successors of rows [S, F] (the step graph by torch)."""
    n = 0
    for s in range(0, rows.shape[0], chunk):
        n += int(prog.step_prog.step_plain(rows[s:s + chunk])[1].sum())
    return n


def infer_kernel_checks(torch, ops, tag, prog, rows, record=None, reps=10,
                        plain_rows=1 << 14):
    """K29 (matrix and fold forms) and K30 bitwise against their plain
    versions on the evidence rows [S, F] on the card; timed with
    `record` (the plain versions `plain_rows` rows a call).  Returns the
    K30 escape bits."""
    from torchtlc.infer.program import words_to_bits

    S, P = rows.shape[0], prog.P
    mat = ops.struct_pred_matrix(prog, rows)
    mat_p, mat_p_ms = cuda_ms_once(
        torch, lambda: prog.matrix_plain(rows, rows=plain_rows))
    need(torch.equal(mat, mat_p), f"K29 matrix differs from its plain "
         f"version ({tag})")
    alive = words_to_bits(ops.struct_pred_alive(prog, rows), P)
    need(torch.equal(alive, mat_p.bool().all(1)),
         f"K29 fold differs from its plain version ({tag})")
    esc = words_to_bits(ops.struct_certify(prog, rows), P)
    esc_p, esc_p_ms = cuda_ms_once(
        torch, lambda: prog.certify_plain(rows, rows=plain_rows))
    need(torch.equal(esc, esc_p), f"K30 differs from its plain version "
         f"({tag})")
    if record is not None:
        n_pred, n_step = pred_stmts(prog), step_stmts(prog)
        n_valid = valid_lanes(torch, prog, rows)
        inb = S * prog.F * 4
        shape = f"{tag}: S {S}, P {P}, F {prog.F}, L {prog.L}"
        record("struct_pred_matrix", shape, 0,
               cuda_ms(torch, lambda _: ops.struct_pred_matrix(prog, rows),
                       reps), mat_p_ms,
               *gen_bound_ms(inb + P * S, S * (n_pred + P)))
        record("struct_pred_alive", shape, 0,
               cuda_ms(torch, lambda _: ops.struct_pred_alive(prog, rows),
                       reps),
               cuda_ms_once(torch, lambda: prog.alive_plain(
                   rows, rows=plain_rows))[1],
               *gen_bound_ms(inb + 4 * prog.NPW, S * (n_pred + P)))
        record("struct_certify", shape + f", {n_valid} valid successors",
               0, cuda_ms(torch, lambda _: ops.struct_certify(prog, rows),
                          reps), esc_p_ms,
               *gen_bound_ms(inb + 4 * prog.NPW,
                             S * (n_pred + n_step + P)
                             + n_valid * (n_pred + 2 * prog.NPW)))
    return esc


def infer_programs21(ops, models):
    """The inference programs of phases 21 and 21b with their emitted
    libraries (K29/K30), one nvcc per text, all started together:
    ({name: InferProgram}, {name: nvcc wall s})."""
    from concurrent.futures import ThreadPoolExecutor

    from torchtlc.infer.candidates import conjecture
    from torchtlc.infer.filter import (compile_predicates, infer_program,
                                       predicate_compiler)
    from torchtlc.struct.cache import get_backend, get_bounds

    progs = {}
    for name, (key, budget, dl) in {
            **{n: (k, b, True) for n, (k, b) in INFER21.items()},
            "RR5T6/419": ("rr5t6", RR5T6_INFER_KW["budget"],
                          RR5T6_INFER_KW["check_deadlock"])}.items():
        m = models[key]
        backend = get_backend(m, dl)
        cands, _ = conjecture(m, bounds=get_bounds(m), budget=budget)
        fns, _ = compile_predicates(predicate_compiler(m, backend), cands)
        progs[name] = infer_program(backend, fns)
    walls = {}

    def build(name):
        t0 = time.time()
        ops.infer_lib(progs[name])
        walls[name] = time.time() - t0

    with ThreadPoolExecutor(len(progs)) as pool:
        list(pool.map(build, progs))
    return progs, walls


def phase_infer21(torch, ops, card, runs, tmp):
    """Phase 21: the CPU tests' inference engines on the card (K29's fold
    form kills, its matrix form gives Init => cand, K30 the closure bits):
    every InferReport pinned to the reference's CPU run - TwoPhase (32),
    RaftElection (64 and its whole pool of 1,446), RaftReplication (64 and
    157); K29 (both forms) and K30 bitwise against their plain versions on
    each model's exact evidence."""
    from torchtlc.infer.driver import InferEngine
    from torchtlc.struct.loader import load

    cfgs = models21(tmp)
    models = {k: load(c) for k, c in cfgs.items()}
    t0 = time.time()
    progs, nvcc = infer_programs21(ops, models)
    build = time.time() - t0
    rows = {}
    record = gen_recorder(rows)
    out, lines = {}, []
    for name, (key, budget) in INFER21.items():
        t0 = time.time()
        eng = InferEngine(models[key], budget=budget)
        wall_build = time.time() - t0
        need(eng.program is progs[name], f"{name}: a second program")
        ops.reset_counts()
        rep = eng.run(seed=0)
        launches = dict(ops.LAUNCHES)
        got = infer_summary(rep)
        need(got == INFER21_PINS[name], f"{name}: {got}, the reference's "
             f"{INFER21_PINS[name]}")
        need(launches["struct_pred_alive"] == len(rep.rounds)
             and launches["struct_pred_matrix"] == 1
             and launches["struct_certify"] == 1,
             f"{name}: K29 / K30 launches {launches}")
        out[f"p21_{name}"] = {"launches": launches}
        infer_kernel_checks(torch, ops, name, eng.program, eng._exact_rows,
                            record if name == "RaftElection/1446" else None)
        lines.append(f"{name}: {got[0]} candidates, {got[5]} killed, "
                     f"{got[7]} certified over {got[3]} states (engine "
                     f"{wall_build:.2f} s, run {rep.wall_s:.4f} s)")
    k29 = rows["struct_pred_alive"][0]
    k30 = rows["struct_certify"][0]
    print(f"phase 21 build: {len(progs)} K29/K30 libraries with nvcc in "
          f"{build:.1f} s (each: " + ", ".join(
              f"{n} P {progs[n].P} {w:.1f} s" for n, w in nvcc.items())
          + "); ptxas (RaftElection/1446, RR5T6/419): " + str([{
              k: "; ".join(v.split("; ")[:2])  # the entry's own lines
              for k, v in ptxas_kernels(progs[n], (
                  "pred_matrix", "pred_alive", "certify")).items()}
              for n in ("RaftElection/1446", "RR5T6/419")]), flush=True)
    print("phase 21 -infer: every report = the reference's (pinned): "
          + "; ".join(lines) + "; K29 (matrix, fold) and K30 = plain on "
          f"every exact evidence set; RaftElection/1446: K29 fold "
          f"{k29['ms']:.4f} ms (plain {k29['plain_ms']:.2f} ms), K30 "
          f"{k30['ms']:.4f} ms (plain {k30['plain_ms']:.2f} ms) on {card}",
          flush=True)
    out.update(p21_rows=rows, p21_cfgs=cfgs, p21_models=models,
               p21_progs=progs, p21_nvcc=nvcc)
    return out


def phase_infer21_real(torch, ops, card, runs):
    """Phase 21b: RR5T6 (Nodes n1..n5, MaxLog 2, MaxTerm 6) with its whole
    pool of 419 candidates on sampled evidence at full width - 65,536
    walkers, depth 100, seed 7, deadlock off: the report pinned to the
    reference's CPU run (survivor and certified names too); the walls of
    the engine's build, the evidence walk, the filter and the certify
    pass; predicate evaluations a second; the device's busy share
    (torch.profiler); K29 and K30 a launch over the union of the sampled
    rounds, bitwise against their plain versions, timed with their
    bounds."""
    from torchtlc.infer.certify import certify_closed
    from torchtlc.infer.driver import InferEngine
    from torchtlc.infer.filter import sim_fields

    m = runs["p21_models"]["rr5t6"]
    rows = runs["p21_rows"]
    record = gen_recorder(rows)
    kw = dict(RR5T6_INFER_KW)
    t0 = time.time()
    eng = InferEngine(m, **kw)
    wall_build = time.time() - t0 + runs["p21_nvcc"]["RR5T6/419"]
    need(eng.evidence == "sim", f"RR5T6: evidence {eng.evidence}")
    out, walls = {}, []
    for i in range(2):
        ops.reset_counts()
        rep = eng.run(seed=RR5T6_INFER_SEED)
        out[f"p21b_rr5t6_{i}"] = {"launches": dict(ops.LAUNCHES)}
        got = infer_summary(rep)
        need(got == RR5T6_INFER_PIN, f"RR5T6 infer: {got}, the "
             f"reference's {RR5T6_INFER_PIN}")
        need(([c.name for c in rep.survivors],
              [c.name for c in rep.certified]) == RR5T6_INFER_NAMES,
             "RR5T6 infer: the survivors / certified names differ")
        walls.append((rep.wall_s, rep.filter_wall_s, rep.certify_wall_s))
    need(set(rep.cert_basis) == {"absint"}, "RR5T6: a certificate that is "
         "not absint on sampled evidence")
    torch.cuda.synchronize()
    t0 = time.time()
    chunks = sim_fields(m, kw["walkers"], kw["depth"], RR5T6_INFER_SEED,
                        check_deadlock=kw["check_deadlock"])
    torch.cuda.synchronize()
    walk = time.time() - t0
    rep2, traced, busy, by_name = device_busy(
        torch, lambda: eng.run(seed=RR5T6_INFER_SEED))
    need(infer_summary(rep2) == RR5T6_INFER_PIN, "RR5T6 under the profiler")
    k_s = {k: sum(v for n, v in by_name.items() if k in n)
           for k in ("pred_alive", "pred_matrix", "certify", "sim_step")}
    union = torch.cat(chunks)
    prog = eng.program
    esc = infer_kernel_checks(torch, ops, "RR5T6 sampled union", prog, union,
                              record)
    t0 = time.time()
    closed = certify_closed(eng.certify_fn, union, prog.P)
    torch.cuda.synchronize()
    need((~closed == esc.cpu().numpy()).all(),
         "certify_closed differs from K30's bits")
    S, P = union.shape[0], prog.P
    best = min(walls)
    m29 = rows["struct_pred_alive"][-1]
    m29m = rows["struct_pred_matrix"][-1]
    m30 = rows["struct_certify"][-1]
    print(f"phase 21b RR5T6 -infer (Nodes n1..n5, MaxLog 2, MaxTerm 6; "
          f"budget 419, 65,536 walkers, depth 100, seed 7, deadlock off): "
          f"{RR5T6_INFER_PIN[:8]} (the reference's report); engine build "
          f"{wall_build:.1f} s with nvcc; walls (run, filter, certify) "
          f"{[tuple(round(x, 4) for x in w) for w in walls]} s; the walk "
          f"alone {walk:.3f} s; {P * S / best[1]:,.0f} predicate "
          f"evaluations/s in the filter ({P} x {S:,}); under "
          f"torch.profiler: wall {traced:.3f} s, device busy {busy:.3f} s "
          f"({busy / traced:.1%}), K27 {k_s['sim_step']:.3f} s, K29 fold "
          f"{k_s['pred_alive']:.4f} s, K29 matrix {k_s['pred_matrix']:.4f} "
          f"s; over the union ({S:,} rows): K29 matrix {m29m['ms']:.3f} ms "
          f"(plain {m29m['plain_ms']:.1f} ms, bound {m29m['bound_ms']:.4f} "
          f"ms by {m29m['bound_by']}), K29 fold {m29['ms']:.3f} ms (plain "
          f"{m29['plain_ms']:.1f} ms, bound {m29['bound_ms']:.4f} ms by "
          f"{m29['bound_by']}), K30 {m30['ms']:.3f} ms through "
          f"certify_closed {time.time() - t0:.3f} s (plain "
          f"{m30['plain_ms']:.1f} ms, bound {m30['bound_ms']:.4f} ms by "
          f"{m30['bound_by']}); {int((~closed).sum())} of {P} escape on "
          f"{card}", flush=True)
    out["p21b_rr5t6"] = dict(walls=walls, busy=busy / traced, walk=walk,
                             build=wall_build)
    return out


# phase 21c: tag -> (model key of models21, argv after the MC.cfg)
CMD21 = {
    "twophase": ("two", ["-infer"]),
    "raftelection-1446": ("elect", ["-frontend", "struct", "-infer",
                                    "-infer-budget", "1446"]),
    "rr5t6": ("rr5t6", ["-infer", "-infer-budget", "419", "-walkers",
                        "65536", "-depth", "100", "-sim-seed", "7",
                        "-nodeadlock"]),
    "refuted": ("viol", ["-infer"]),
}
# (exit code, SHA-256 of struct_masked) of `python -m jaxtlc.cli check
# <MC.cfg> -noTool <argv> -workers cpu` in one process, in CMD21's order
CMD21_TRANSCRIPT = {
    'twophase': (0, '39d136cfea1ebf46a8f307bc7e0facf0'
        'dd5f1ed1555696573c7b9772977fb83c'),
    'raftelection-1446': (0, '13e71d245100d4ffcdf211b715db82e8'
        '2dad8b9eed8e58769c006e5cf4bb007f'),
    'rr5t6': (0, '32cae85f4ef45db47e6f92dfc6b4f9e3'
        '3b8fc9f95c3bf2c6fa252a2c881ff94f'),
    'refuted': (12, '4e259ae5b1d51e7b139a91a75b1788c5'
        '1f559546e983ba0940eff11079f14fee'),
}
# the refusals: (argv after the MC.cfg of a model key, the error's text)
REFUSE21 = {
    "simulate": ("two", ["-infer", "-simulate"],
                 "Error: -infer and -simulate are distinct job classes "
                 "(pick one)"),
    "kubeapi": ("kube", ["-infer"], "Error: -infer requires the "
                "structural frontend (re-run with -frontend struct)"),
    "sharded": ("two", ["-infer", "-sharded", "2"],
                "Error: -sharded not supported with -infer (inference "
                "carries no frontier/checkpoint machinery)"),
    "checkpoint": ("two", ["-infer", "-checkpoint", "CK/i"],
                   "Error: -checkpoint not supported with -infer "
                   "(inference carries no frontier/checkpoint machinery)"),
}


def phase_command21(ops, card, runs, tmp):
    """Phase 21c: `python -m torchtlc.cli check ... -infer` in this
    process - TwoPhase, RaftElection's whole pool under -frontend struct,
    the RR5T6 walk of phase 21b and the module whose named invariant is
    refuted (exit 12) - each exit code and transcript equal to the
    reference's (digests pinned); and the refusals, exit 1 with the
    reference's error."""
    cfgs = dict(runs["p21_cfgs"] if "p21_cfgs" in runs else models21(tmp))
    cfgs["kube"] = write_model(tmp, "Model_FF21", False, False)
    ckdir = os.path.join(tmp, "ck21")
    os.makedirs(ckdir)
    out, lines = {}, []
    for tag, (key, extra) in CMD21.items():
        cfg = cfgs[key]
        rc, text, launches, wall = command_here(ops, [cfg, "-noTool",
                                                      *extra])
        rc_want, sha_want = CMD21_TRANSCRIPT[tag]
        need(rc == rc_want, f"command {tag} exited {rc}")
        sha = hashlib.sha256(struct_masked(text, cfg).encode()).hexdigest()
        need(sha == sha_want, f"command {tag}: the transcript differs from "
             "the reference's")
        need(launches["struct_pred_alive"] > 0
             and launches["struct_pred_matrix"] > 0,
             f"command {tag}: K29 never ran")
        out[f"p21c_{tag}"] = {"launches": launches}
        lines.append(f"{tag} exit {rc} ({wall:.2f} s)")
    for tag, (key, extra, want) in REFUSE21.items():
        argv = [cfgs[key], "-noTool"] + [x.replace("CK", ckdir)
                                         for x in extra]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, _, _, _ = command_here(ops, argv)
        need(rc == 1 and err.getvalue().strip() == want,
             f"refusal {tag}: exit {rc}, {err.getvalue()!r}")
        lines.append(f"{tag} refused (exit 1)")
    print("phase 21c commands, transcripts = the reference's: "
          + "; ".join(lines) + f" on {card}", flush=True)
    return out


# phases 22-22c: the native disk tier (-fpset DiskFPSet, engine.hybrid:
# K1's sharded variant at D = 1 and K2 on the card, the store and queue
# on the host).  HYB22_PINS are jaxtlc.engine.hybrid.check_hybrid(cfg,
# chunk, fp_partitions=D, fp_path=..., queue_path=...) on the CPU: the
# counts, the hybrid's own outdegree (first-lane attribution), the
# per-action counts, the chunks, and the SHA-256 of the store file(s)
# (concatenated in partition order) and of the queue file
HYB22_PINS = {
    'ff': dict(
        counts=[17020, 8203, 109], outdegree=[1, 0, 3, 2],
        iterations=109,
        act_gen={'APIStart': 2284, 'C1': 546, 'C10': 546, 'C11': 365, 'C13':
                 547, 'C2': 81, 'C3': 56, 'C4': 51, 'C5': 132, 'C6': 27, 'C7':
                 22, 'C8': 56, 'CStart': 1224, 'DoListReply': 1584,
                 'DoListRequest': 1271, 'DoReply': 1799, 'DoRequest': 2313,
                 'PVCDone': 319, 'PVCHavePVCs': 770, 'PVCListedPVCs': 1528,
                 'PVCStart': 1132, 'c12': 365},
        act_dist={'APIStart': 1655, 'C1': 338, 'C10': 338, 'C11': 234, 'C13':
                  335, 'C2': 42, 'C3': 30, 'C4': 29, 'C5': 71, 'C6': 14, 'C7':
                  13, 'C8': 30, 'CStart': 437, 'DoListReply': 570,
                  'DoListRequest': 338, 'DoReply': 1085, 'DoRequest': 992,
                  'PVCDone': 165, 'PVCHavePVCs': 210, 'PVCListedPVCs': 540,
                  'PVCStart': 501, 'c12': 234},
        store_sha=('6312ebc979e653f33c18b444429f7f74'
                   '6d3d74e4c0ace9b761b97f23522e4454'),
        queue_sha=('a7421e42de2a175c0822f218c5e9e6f0'
                   '070f4c4af32a63a858981de3c0456ff7')),
    'm1': dict(
        counts=[577736, 163408, 124], outdegree=[1, 0, 3, 2],
        iterations=237,
        act_gen={'APIStart': 27059, 'C1': 13373, 'C10': 6257, 'C11': 8877,
                 'C13': 12302, 'C2': 770, 'C3': 1346, 'C4': 483, 'C5': 1253,
                 'C6': 426, 'C7': 708, 'C8': 673, 'CStart': 54342,
                 'DoListReply': 70584, 'DoListRequest': 82416, 'DoReply':
                 67334, 'DoRequest': 149766, 'PVCDone': 4523, 'PVCHavePVCs':
                 13459, 'PVCListedPVCs': 33946, 'PVCStart': 25217, 'c12': 2620},
        act_dist={'APIStart': 17759, 'C1': 8345, 'C10': 3937, 'C11': 5518,
                  'C13': 6771, 'C2': 430, 'C3': 748, 'C4': 271, 'C5': 615,
                  'C6': 238, 'C7': 396, 'C8': 377, 'CStart': 17188,
                  'DoListReply': 14371, 'DoListRequest': 10804, 'DoReply':
                  22595, 'DoRequest': 21066, 'PVCDone': 1565, 'PVCHavePVCs':
                  4085, 'PVCListedPVCs': 13623, 'PVCStart': 11123, 'c12': 1581},
        store_sha=('deb476b120577ccdc9b95606452d8495'
                   '8b4a1c543bb4f2c3dca2f7d62a1661fc'),
        queue_sha=('ae18409081501357cc799dab859bf203'
                   '1f82382ec27b97a37317cf350b4a76a3')),
    'm1_4': dict(
        counts=[577736, 163408, 124], outdegree=[1, 0, 3, 2],
        iterations=237,
        act_gen={'APIStart': 27059, 'C1': 13373, 'C10': 6257, 'C11': 8877,
                 'C13': 12302, 'C2': 770, 'C3': 1346, 'C4': 483, 'C5': 1253,
                 'C6': 426, 'C7': 708, 'C8': 673, 'CStart': 54342,
                 'DoListReply': 70584, 'DoListRequest': 82416, 'DoReply':
                 67334, 'DoRequest': 149766, 'PVCDone': 4523, 'PVCHavePVCs':
                 13459, 'PVCListedPVCs': 33946, 'PVCStart': 25217, 'c12': 2620},
        act_dist={'APIStart': 17759, 'C1': 8345, 'C10': 3937, 'C11': 5518,
                  'C13': 6771, 'C2': 430, 'C3': 748, 'C4': 271, 'C5': 615,
                  'C6': 238, 'C7': 396, 'C8': 377, 'CStart': 17188,
                  'DoListReply': 14371, 'DoListRequest': 10804, 'DoReply':
                  22595, 'DoRequest': 21066, 'PVCDone': 1565, 'PVCHavePVCs':
                  4085, 'PVCListedPVCs': 13623, 'PVCStart': 11123, 'c12': 1581},
        store_sha=('8687ffcf369e5785791a11a1c48d2ab6'
                   '19d5486785929e120606400ca2ab038d'),
        queue_sha=('ae18409081501357cc799dab859bf203'
                   '1f82382ec27b97a37317cf350b4a76a3')),
}
HYB22_CFGS = {"ff": (False, False, 256, 1), "m1": (True, True, 1024, 1),
              "m1_4": (True, True, 1024, 4)}
HYB22_CKPT = dict(ckpt_every=32, max_chunks=100)
# phase 22c: (exit code, SHA-256 of struct_masked, stderr) of `python -m
# jaxtlc.cli check <MC.cfg> <argv>` on the Model_1 pair (the -infer row on
# TwoPhase Model_1), in one process in this order
CMD22 = {
    "disk": ["-noTool", "-fpset", "DiskFPSet"],
    "ckpt": ["-noTool", "-fpset", "DiskFPSet", "-sharded", "4",
             "-checkpoint", "CK/h", "-checkpointevery", "32"],
    "recover": ["-noTool", "-fpset", "DiskFPSet", "-sharded", "4",
                "-checkpoint", "CK/h", "-recover"],
    "p16": ["-noTool", "-fpset", "DiskFPSet", "-sharded", "16"],
    "p3": ["-noTool", "-fpset", "DiskFPSet", "-sharded", "3"],
    "infer": ["-noTool", "-infer", "-fpset", "DiskFPSet"],
}
CMD22_TRANSCRIPT = {
    'disk': (0, 'be940ce6df34a1b9d701ef0291dc7c34'
            'f3a2f1df01e9dbb2750548ffb977980d',
            ''),
    'ckpt': (0, 'be940ce6df34a1b9d701ef0291dc7c34'
            'f3a2f1df01e9dbb2750548ffb977980d',
            ''),
    'recover': (0, 'be940ce6df34a1b9d701ef0291dc7c34'
               'f3a2f1df01e9dbb2750548ffb977980d',
               ''),
    'p16': (0, 'be940ce6df34a1b9d701ef0291dc7c34'
           'f3a2f1df01e9dbb2750548ffb977980d',
           ''),
    'p3': (1, '77a6651c193f2438517b35c36fb48235'
          '8201d7685ff2307ed0138c0955a9393c',
          'Error: -sharded with -fpset DiskFPSet needs a power-of-two partition count, got 3\n'),
    'infer': (1, 'e3b0c44298fc1c149afbf4c8996fb924'
             '27ae41e4649b934ca495991b7852b855',
             'Error: -fpset DiskFPSet not supported with -infer (inference carries no frontier/checkpoint machinery)\n'),
}


def hybrid22_run(torch, ops, cfg, chunk, d, D=1, **kw):
    """check_hybrid on the card with its store and queue files in d, the
    launch counts reset just before and read just after: (result,
    launches)."""
    from torchtlc.engine.hybrid import check_hybrid

    os.makedirs(d, exist_ok=True)
    ops.reset_counts()
    r = check_hybrid(cfg, chunk=chunk, fp_partitions=D,
                     fp_path=os.path.join(d, "s.fps"),
                     queue_path=os.path.join(d, "q.sq"), **kw)
    torch.cuda.synchronize()
    return r, dict(ops.LAUNCHES)


def file_sha(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for buf in iter(lambda: f.read(1 << 24), b""):
            h.update(buf)
    return h.hexdigest()


def hybrid22_digests(d):
    """(store SHA-256 over the partition files in order, queue SHA-256)."""
    h = hashlib.sha256()
    for name in sorted(n for n in os.listdir(d) if n.startswith("s.fps")):
        with open(os.path.join(d, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest(), file_sha(os.path.join(d, "q.sq"))


def hybrid22_pinned(tag, r, d, pin):
    got = dict(counts=[r.generated, r.distinct, r.depth],
               outdegree=list(r.outdegree), act_gen=r.action_generated,
               act_dist=r.action_distinct, iterations=r.iterations)
    for k, v in got.items():
        need(v == pin[k], f"hybrid {tag}: {k} {v}, the reference's {pin[k]}")
    need(r.violation == 0 and r.queue_left == 0, f"hybrid {tag}: verdict")
    need(hybrid22_digests(d) == (pin["store_sha"], pin["queue_sha"]),
         f"hybrid {tag}: the store or queue file differs from the "
         "reference's")


def hybrid22_kernel_checks(torch, ops, tag, cfg, rows, n, chunk, record):
    """K1's sharded variant at D = 1 over the staged block and K2 on its
    packed words, bitwise against their plain versions on the card (every
    lane, the rows past n included), timed."""
    from torchtlc.engine import sharded as ts
    from torchtlc.engine.fingerprint import fp64_words, fp64_words_plain
    from torchtlc.spec.codec import get_codec
    from torchtlc.spec.kernel import lane_layout

    cdc = get_codec(cfg)
    F, W, nbits = cdc.n_fields, cdc.n_words, cdc.nbits
    _, L = lane_layout(cfg)
    dev = torch.device("cuda")
    stage = torch.zeros((1, chunk + 1, F), dtype=torch.int32, device=dev)
    stage[0, :rows.shape[0]] = torch.from_numpy(rows).to(dev)
    qhead = torch.zeros(1, dtype=torch.int64, device=dev)
    npop = torch.full((1,), n, dtype=torch.int64, device=dev)

    def err_of(a, b):
        if a is None or b is None:
            return 0 if a is b else 1 << 62
        a, b = a.to(torch.int64), b.to(torch.int64)
        return int((a - b).abs().max()) if a.numel() else 0

    got = ts.expand_sharded(cfg, stage, qhead, npop, chunk)
    ref = ts.expand_sharded_plain(cfg, stage, qhead, npop, chunk)
    err = max(err_of(a, b) for a, b in zip(got, ref))
    need(err == 0, f"K1 (D = 1) differs from its plain version ({tag})")
    ncand = chunk * L
    record("expand/hybrid", f"{tag}: chunk {chunk}, {n} popped", err,
           cuda_ms(torch, lambda _: ts.expand_sharded(
               cfg, stage, qhead, npop, chunk), 20),
           cuda_ms(torch, lambda _: ts.expand_sharded_plain(
               cfg, stage, qhead, npop, chunk), 2),
           *gen_bound_ms(chunk * F * 4 + ncand * (W * 4 + 5 + 4 + F * 4),
                         ncand * kube_expand_ops(cfg, False, sharded=True)))
    packed = got[0]
    lo, hi = fp64_words(packed, nbits)
    lo2, hi2 = fp64_words_plain(packed, nbits)
    err = max(err_of(lo, lo2), err_of(hi, hi2))
    need(err == 0, f"K2 differs from its plain version ({tag})")
    record("fp64/hybrid", f"{tag}: {ncand} lanes", err,
           cuda_ms(torch, lambda _: fp64_words(packed, nbits), 20),
           cuda_ms(torch, lambda _: fp64_words_plain(packed, nbits), 2),
           *gen_bound_ms(ncand * (W * 4 + 8), 0))
    return int(got[1][0].sum())


def phase_hybrid22(torch, ops, card, runs, tmp):
    """Phase 22: check_hybrid on the card - FF at chunk 256, Model_1 at
    chunk 1024 and on 4 partitions - each result and the store and queue
    files pinned to the reference's CPU run; Model_1 checkpointed every 32
    chunks, stopped at chunk 100 and resumed to the same digests; K1 (D =
    1) and K2 bitwise against their plain versions on a Model_1 block."""
    import numpy as np

    from torchtlc.config import ModelConfig

    print(f"phase 22 numpy {np.__version__}, torch {torch.__version__} "
          f"(CUDA {torch.version.cuda})", flush=True)
    rows = {}
    record = gen_recorder(rows)
    out, lines = {}, []
    d0 = os.path.join(tmp, "p22")
    for tag, (fail, to, chunk, D) in HYB22_CFGS.items():
        cfg = ModelConfig(fail, to)
        d = os.path.join(d0, tag)
        r, launches = hybrid22_run(torch, ops, cfg, chunk, d, D)
        hybrid22_pinned(tag, r, d, HYB22_PINS[tag])
        need(launches["expand"] == r.iterations
             and launches["fp64"] == r.iterations + 1,
             f"hybrid {tag}: launches {launches}")
        out[f"p22_{tag}"] = {"launches": launches}
        lines.append(f"{tag} (chunk {chunk}, D {D}): {r.generated} / "
                     f"{r.distinct} / {r.depth}, outdegree {r.outdegree}, "
                     f"{r.iterations} chunks in {r.wall_s:.2f} s")
    # checkpoint every 32 chunks, stop at 100, resume
    m1 = ModelConfig(True, True)
    d = os.path.join(d0, "ckpt")
    ck = os.path.join(d, "h")
    part, l1 = hybrid22_run(torch, ops, m1, 1024, d, ckpt_path=ck,
                            **HYB22_CKPT)
    need(part.iterations == HYB22_CKPT["max_chunks"]
         and part.queue_left > 0, f"hybrid ckpt: {part.iterations} chunks")
    r, l2 = hybrid22_run(torch, ops, m1, 1024, d, ckpt_path=ck,
                         ckpt_every=32, resume=True)
    hybrid22_pinned("m1 resumed", r, d, HYB22_PINS["m1"])
    out["p22_ckpt"] = {"launches": {k: l1[k] + l2[k] for k in l1}}
    lines.append(f"m1 checkpointed every 32 chunks, stopped at "
                 f"{part.iterations} and resumed to the same digests")
    # K1 (D = 1) and K2 on a Model_1 block: 1,000 rows popped of 1,024
    q = np.fromfile(os.path.join(d0, "m1", "q.sq"), dtype=np.int32)
    from torchtlc.spec.codec import get_codec

    q = q.reshape(-1, get_codec(m1).n_fields)
    nvalid = hybrid22_kernel_checks(torch, ops, "model1", m1,
                                    np.ascontiguousarray(q[50000:51024]),
                                    1000, 1024, record)
    k1, k2 = rows["expand/hybrid"][0], rows["fp64/hybrid"][0]
    print("phase 22 -fpset DiskFPSet (check_hybrid), every result and file "
          "= the reference's (pinned): " + "; ".join(lines)
          + f"; on a Model_1 block ({nvalid} valid lanes) K1 (D = 1) "
          f"{k1['ms']:.4f} ms (plain {k1['plain_ms']:.2f} ms, bound "
          f"{k1['bound_ms']:.4f} ms), K2 {k2['ms']:.4f} ms (plain "
          f"{k2['plain_ms']:.2f} ms, bound {k2['bound_ms']:.4f} ms), both "
          f"bitwise = plain, on {card}", flush=True)
    out["p22_rows"] = rows
    return out


def phase_hybrid22_real(torch, ops, card, runs, tmp):
    """Phase 22b: the scaled 2x1 workload through the disk tier at chunk
    131,072 - 62,014,325 / 19,359,985 / 186, a queue file of every
    distinct state (136 B each, 2.63 GB) and a store grown to 2^25 slots
    (256 MiB): the temporary directory's free space first, then the wall,
    distinct states a second, the wall's split (K1 and K2, the copies,
    the store inserts, the queue's push and pop, the numpy statistics),
    and the device's busy share under torch.profiler."""
    from torchtlc.config import scaled_config

    cfg, _ = scaled_config()
    d = os.path.join(tmp, "p22b")
    os.makedirs(d, exist_ok=True)
    free = shutil.disk_usage(d).free
    print(f"phase 22b temporary directory: {free / 2**30:.1f} GiB free",
          flush=True)
    timing = {}
    (r, launches), traced, busy, by_name = device_busy(
        torch, lambda: hybrid22_run(torch, ops, cfg, 1 << 17, d,
                                    timing=timing))
    need((r.generated, r.distinct, r.depth) == SCALED_COUNTS,
         f"hybrid scaled: {(r.generated, r.distinct, r.depth)}")
    need(r.violation == 0 and r.queue_left == 0, "hybrid scaled: verdict")
    from torchtlc.spec.codec import get_codec

    F = get_codec(cfg).n_fields
    qbytes = os.path.getsize(os.path.join(d, "q.sq"))
    sbytes = os.path.getsize(os.path.join(d, "s.fps"))
    need(qbytes == r.distinct * F * 4, f"hybrid scaled: queue {qbytes} B")
    need(sbytes == 32 + 8 * (1 << 25), f"hybrid scaled: store {sbytes} B")
    k1 = sum(v for n, v in by_name.items() if "expand" in n)
    k2 = sum(v for n, v in by_name.items() if "fp64" in n)
    split = ", ".join(f"{k} {v:.3f} s" for k, v in sorted(
        timing.items(), key=lambda kv: -kv[1]))
    print(f"phase 22b scaled 2x1 through the disk tier (chunk 131,072): "
          f"{r.generated} / {r.distinct} / {r.depth}, outdegree "
          f"{r.outdegree}, {r.iterations} chunks; wall {r.wall_s:.3f} s "
          f"(traced), {r.distinct / r.wall_s:,.0f} distinct states/s; "
          f"split: {split} (sum {sum(timing.values()):.3f} s); queue file "
          f"{qbytes:,} B, store {sbytes:,} B; device busy {busy:.3f} s "
          f"({busy / traced:.1%} of {traced:.3f} s): K1 {k1:.3f} s, K2 "
          f"{k2:.3f} s on {card}", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    return {"p22b_scaled": {"launches": launches, "wall": r.wall_s,
                            "split": timing, "busy": busy / traced}}


def phase_command22(ops, card, runs, tmp):
    """Phase 22c: `python -m torchtlc.cli check MC.cfg -fpset DiskFPSet` on
    the Model_1 pair in this process - alone, with -sharded 4 -checkpoint
    -checkpointevery 32 then -recover, with -sharded 16 (16 partitions,
    past the sharded engine's limit of 8) and -sharded 3 (exit 1) - and
    -infer -fpset DiskFPSet on TwoPhase (exit 1): exit codes, transcripts
    and errors equal to the reference's (pinned)."""
    d = os.path.join(tmp, "p22c")
    ckdir = os.path.join(d, "ck")
    os.makedirs(ckdir)
    m1 = write_model(d, "Model_1", True, True)
    two = os.path.join(os.path.dirname(os.path.abspath(__file__)), "specs",
                       "TwoPhase.toolbox", "Model_1", "MC.cfg")
    out, lines = {}, []
    for tag, extra in CMD22.items():
        cfg = two if tag == "infer" else m1
        argv = [cfg] + [x.replace("CK", ckdir) for x in extra]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, text, launches, wall = command_here(ops, argv)
        rc_want, sha_want, err_want = CMD22_TRANSCRIPT[tag]
        sha = hashlib.sha256(struct_masked(text, cfg).encode()).hexdigest()
        need(rc == rc_want and sha == sha_want and err.getvalue()
             == err_want, f"command {tag}: exit {rc}, {err.getvalue()!r}, "
             "the transcript or error differs from the reference's")
        if rc == 0 and tag != "recover":
            # (-recover resumes from the final snapshot: its queue is
            # empty, so it expands nothing)
            need(launches["expand"] > 0 and launches["fp64"] > 0,
                 f"command {tag}: K1 / K2 never ran")
            out[f"p22c_{tag}"] = {"launches": launches}
        lines.append(f"{tag} exit {rc} ({wall:.2f} s)")
    print("phase 22c -fpset DiskFPSet commands, transcripts = the "
          "reference's: " + "; ".join(lines) + f" on {card}", flush=True)
    return out


# phases 23-23c: the artifact cache (struct.artifacts) and kernel K31
# struct_recheck.  ArtTiny is the reference's artifact-test spec; the
# TwoPhase copies of phase 23b carry two more definitions that no action
# references (so the behavior digest, the reach key, is TwoPhase's): a
# satisfied one for the invariant-only edit and one violated in two steps
ART23_TLA = """---- MODULE ArtTiny ----
EXTENDS Naturals
CONSTANTS MAX
VARIABLES x, y

Init == /\\ x = 0
        /\\ y = 0

Up == /\\ x < MAX
      /\\ x' = x + 1
      /\\ y' = y

Flip == /\\ x > 0
        /\\ y' = 1 - y
        /\\ x' = x

Reset == /\\ x = MAX
         /\\ x' = 0
         /\\ y' = y

Next == Up \\/ Flip \\/ Reset

Spec == Init /\\ [][Next]_<<x, y>>

InRange == x <= MAX
YBit == y <= 1
YNonNeg == y >= 0
NoTop == x < MAX
====
"""
TP23_DEFS = ("PreparedKnown == tmPrepared \\subseteq RM\n"
             "TMRunning == tmState = \"running\"\n")
ART23_GEOM = ["-chunk", "64", "-qcap", "1024", "-fpcap", "4096"]
TP23_GEOM = ["-chunk", str(TP8_KW["chunk"]), "-qcap",
             str(TP8_KW["queue_capacity"]), "-fpcap",
             str(TP8_KW["fp_capacity"])]
RR23_GEOM = ["-chunk", str(RR5_KW["chunk"]), "-qcap",
             str(RR5_KW["queue_capacity"]), "-fpcap",
             str(RR5_KW["fp_capacity"])]
_A = ["-frontend", "struct", "-noTool", "-artifact-cache", "STORE"]
# phase 23's steps on one store (tag -> (model key, argv after the
# MC.cfg, whether the process store is pointed at STORE)), and phase 23c's
# on TwoPhase Model_1; ART23_TRANSCRIPT / CMD23_TRANSCRIPT are (exit code,
# SHA-256 of struct_masked) of `python -m jaxtlc.cli check <MC.cfg> <argv>`
# on the CPU running the same steps in this order on a store of its own
ART23_STEPS = {
    "fresh": ("base", _A + ART23_GEOM, False),
    "hit": ("base", _A + ART23_GEOM, False),
    "edit": ("edit", _A + ART23_GEOM, False),
    "seeded": ("seeded", _A + ART23_GEOM, False),
    "full": ("seeded", ["-frontend", "struct", "-noTool",
                        "-no-artifact-cache"] + ART23_GEOM, False),
}
ART23_TRANSCRIPT = {
    'fresh': (0, '20c493d22b8d11ef44cb7a6193e9554d'
              'a49b9af8d38070b01a256964fbfe3027'),
    'hit': (0, '4f6d9cd06d6eb8a09c529a23aea32cd8'
            'b64db3ccb7e1c8dca458497566c1624b'),
    'edit': (0, '0e46dec1c4adb0730d92cf96eecec828'
             'd0135bf992255c2753b71f0adc47945c'),
    'seeded': (12, '14ec87f6f0be4df82659430cdfbe8b45'
               '89111326e1d941d62d2610645f627449'),
    'full': (12, '07814fdccfaff09a083da203cffea047'
             '955beb304284c582fc1cc5f494febb77'),
}
_T = ["-noTool", "-nodeadlock"]
CMD23 = {
    "fresh": ("two", _T + ["-artifact-cache", "STORE"], False),
    "hit": ("two", _T + ["-artifact-cache", "STORE"], False),
    "recheck": ("two", _T + ["-artifact-cache", "STORE", "-recheck"],
                False),
    "noart": ("two", _T + ["-no-artifact-cache"], False),
    "infer": ("two", _T + ["-infer"], True),
    "sim": ("two", _T + ["-simulate", "-walkers", "16", "-depth", "12",
                         "-artifact-cache", "STORE"], False),
}
CMD23_TRANSCRIPT = {
    'fresh': (0, 'eefe00acd60e917601998f0e625a8637'
              '8650aa48a6267d7d7a0f1582f85ba49a'),
    'hit': (0, 'cc7c01fc20a5db8539d442db02c385db'
            '22a466edda380be99465f21595dbcc97'),
    'recheck': (0, 'eefe00acd60e917601998f0e625a8637'
                '8650aa48a6267d7d7a0f1582f85ba49a'),
    'noart': (0, 'eefe00acd60e917601998f0e625a8637'
              '8650aa48a6267d7d7a0f1582f85ba49a'),
    'infer': (0, '9146e22c13c7239b1e802b4b4a7a5957'
              '0eff88bad606ffd76dde9a94974a382a'),
    'sim': (0, '9d682f8726143798cdbdcc9b3921f698'
            '2bcce36e1dc2df31079432b42793861d'),
}


def models23(tmp):
    """The model files of phases 23-23c in `tmp`/p23: {key: MC.cfg}."""
    here = os.path.dirname(os.path.abspath(__file__))
    specs = os.path.join(here, "specs")
    two = os.path.join(specs, "TwoPhase.toolbox", "Model_1")
    raft = os.path.join(specs, "RaftReplication.toolbox", "Model_1")
    d = os.path.join(tmp, "p23")
    out = {"two": os.path.join(two, "MC.cfg"),
           "raft": os.path.join(raft, "MC.cfg")}
    tp_tla = open(os.path.join(two, "TwoPhase.tla")).read().replace(
        "\n====", "\n" + TP23_DEFS + "====")
    rr_tla = open(os.path.join(raft, "RaftReplication.tla")).read()

    def cfg(*invs, **consts):
        return "".join(f"CONSTANT {k} = {v}\n" for k, v in consts.items()) \
            + "SPECIFICATION\nSpec\nINVARIANT\n" + "\n".join(invs) + "\n"

    tp8 = dict(RM="{r1, r2, r3, r4, r5, r6, r7, r8}")
    rr5 = dict(Nodes="{n1, n2, n3, n4, n5}", MaxLog="2", MaxTerm="3")
    files = {
        "base": ("ArtTiny", ART23_TLA, cfg("InRange", "YBit", MAX="4")),
        "edit": ("ArtTiny", ART23_TLA, cfg("InRange", "YBit", "YNonNeg",
                                           MAX="4")),
        "seeded": ("ArtTiny", ART23_TLA, cfg("InRange", "YBit", "NoTop",
                                             MAX="4")),
        "tp8": ("TwoPhase", tp_tla, cfg("TypeOK", "Agreement",
                                        "CommitVoted", **tp8)),
        "tp8_edit": ("TwoPhase", tp_tla, cfg(
            "TypeOK", "Agreement", "CommitVoted", "PreparedKnown", **tp8)),
        "tp8_seeded": ("TwoPhase", tp_tla, cfg(
            "TypeOK", "Agreement", "TMRunning", "CommitVoted", **tp8)),
        "rr5_3": ("RaftReplication", rr_tla, cfg(
            "TypeOK", "AtMostOneLeader", "CommitWithinLog", **rr5)),
        "rr5_4": ("RaftReplication", rr_tla, cfg(
            "TypeOK", "AtMostOneLeader", "CommitWithinLog",
            "CommittedAgree", **rr5)),
    }
    for key, (mod, tla, text) in files.items():
        os.makedirs(os.path.join(d, key), exist_ok=True)
        with open(os.path.join(d, key, f"{mod}.tla"), "w") as f:
            f.write(tla)
        with open(os.path.join(d, key, "MC.cfg"), "w") as f:
            f.write(text)
        out[key] = os.path.join(d, key, "MC.cfg")
    return out


@contextlib.contextmanager
def counted_nvcc():
    """Count the compiler runs of the kernel builds inside the block:
    yields a list that gets one entry per nvcc resolution (every build,
    the libraries' and the emitted texts', asks for nvcc first)."""
    from torchtlc.kernels import build

    calls, real = [], build.nvcc

    def nvcc():
        calls.append(1)
        return real()

    build.nvcc = nvcc
    try:
        yield calls
    finally:
        build.nvcc = real


@contextlib.contextmanager
def artifact_timers():
    """Seconds spent in the artifact store's inversion, writes and reads
    inside the block: yields {name: [seconds, ...]}."""
    from torchtlc.struct import artifacts as ta

    spent = {}
    saved = {}

    def wrap(owner, name, key):
        real = getattr(owner, name)
        saved[(owner, name)] = real

        def timed(*a, **k):
            t0 = time.time()
            try:
                return real(*a, **k)
            finally:
                spent.setdefault(key, []).append(time.time() - t0)

        setattr(owner, name, timed)

    wrap(ta, "states_from_table", "inversion")
    for name in ("put_verdict", "put_reach", "lookup_verdict",
                 "lookup_reach"):
        wrap(ta.ArtifactStore, name, name)
    try:
        yield spent
    finally:
        for (owner, name), real in saved.items():
            setattr(owner, name, real)


def journal_cache(path):
    with open(path) as f:
        return [(e["tier"], e["outcome"]) for e in map(json.loads, f)
                if e["event"] == "cache"]


def art23_steps(ops, cfgs, steps, pins, store, tag0):
    """Run `steps` through the command in this process on `store`, each
    exit code and masked transcript against the reference's: {tag: (rc,
    text, launches, wall, nvcc runs, journal events)}."""
    out = {}
    for tag, (key, extra, env) in steps.items():
        cfg = cfgs[key]
        journal = os.path.join(os.path.dirname(store), f"{tag0}_{tag}.jsonl")
        argv = [cfg] + [x.replace("STORE", store) for x in extra] + [
            "-journal", journal]
        saved = os.environ.get("TORCHTLC_ARTIFACT_CACHE")
        if env:
            os.environ["TORCHTLC_ARTIFACT_CACHE"] = store
        try:
            with counted_nvcc() as nv:
                rc, text, launches, wall = command_here(ops, argv)
        finally:
            os.environ["TORCHTLC_ARTIFACT_CACHE"] = saved
        sha = hashlib.sha256(struct_masked(text, cfg).encode()).hexdigest()
        need([rc, sha] == list(pins[tag]), f"{tag0} {tag}: exit {rc}, the "
             "transcript differs from the reference's")
        out[tag] = (rc, text, launches, wall, len(nv),
                    journal_cache(journal))
    return out


def violation_section(text):
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if "is violated" in ln)
    end = next(i for i, ln in enumerate(lines) if ln.startswith("Progress("))
    return lines[start:end]


def recheck_row_ops(prog) -> int:
    """K31's integer operations a stored row: the statements of the
    emitted invariants (st_inv_k and st_inv_bits, one operation each) and
    three a field for the unpack (a shift, a mask and an or)."""
    body = prog.text.split("HD bool st_inv_0(", 1)[-1]
    return body.split('#include "struct_expand.cuh"', 1)[0].count(";") \
        + 3 * prog.F


def k31_check(torch, ops, tag, prog, words, record=None, reps=20):
    """K31 bitwise against its plain version on stored rows [N, W] on the
    card (the bits and the first failing row); timed with `record`.
    Returns (bits, first)."""
    bits, first = ops.struct_recheck(prog, words)
    bits_p, first_p = prog.recheck_plain(words)
    need(torch.equal(bits, bits_p) and int(first) == int(first_p),
         f"K31 differs from its plain version ({tag})")
    if record is not None:
        N = words.shape[0]
        record("struct_recheck", f"{tag}: {N:,} rows, W {prog.W}, "
               f"{prog.n_inv} invariants, {recheck_row_ops(prog)} "
               "operations a row", 0,
               cuda_ms(torch, lambda _: ops.struct_recheck(prog, words),
                       reps),
               cuda_ms(torch, lambda _: prog.recheck_plain(words), 2),
               *gen_bound_ms(N * (prog.W * 4 + 4),
                             N * recheck_row_ops(prog)))
    return bits, first


def art23_reach_sets(torch, ops, cfgs, record):
    """K31 bitwise against its plain version on the reachable sets of
    TwoPhase and RaftReplication Model_1 (clean check_struct runs on the
    card, recovered from their final tables), alone and with seeded random
    rows appended."""
    import numpy as np

    from torchtlc.engine.fingerprint import DEFAULT_FP_INDEX, DEFAULT_SEED
    from torchtlc.struct import artifacts as ta
    from torchtlc.struct.cache import get_backend
    from torchtlc.struct.engine import check_struct
    from torchtlc.struct.loader import load

    rng = np.random.default_rng(SEED)
    lines = []
    for name, key in (("TwoPhase", "two"), ("RaftReplication", "raft")):
        m = load(cfgs[key])
        be = get_backend(m, False)
        prog = be.kernels.prog
        r = check_struct(m, check_deadlock=False, capture_fps=True,
                         chunk=256, fp_capacity=1 << 15)
        st = ta.states_from_table(r.fp_table, be.cdc.nbits,
                                  DEFAULT_FP_INDEX, DEFAULT_SEED)
        need(st is not None and st.shape[0] == r.distinct,
             f"{name}: the table did not invert")
        words = torch.from_numpy(st.view(np.int32)).cuda()
        _, first = k31_check(torch, ops, name, prog, words)
        need(int(first) == st.shape[0], f"{name}: a reachable state fails")
        rnd = rng.integers(0, 2 ** 32, size=(4096, prog.W), dtype=np.uint64)
        rnd = rnd.astype(np.uint32)
        if prog.cdc.nbits % 32:
            rnd[:, -1] &= np.uint32((1 << (prog.cdc.nbits % 32)) - 1)
        seeded = torch.cat([words, torch.from_numpy(
            rnd.view(np.int32)).cuda()])
        bits, first = k31_check(torch, ops, f"{name} seeded", prog, seeded,
                                record)
        lines.append(f"{name} {st.shape[0]} states (+4,096 seeded rows: "
                     f"first failing row {int(first)})")
    return lines


def phase_art23(torch, ops, card, runs, tmp):
    """Phase 23: the CPU tests' artifact cases on the card, ArtTiny through
    the command on a temporary store - a fresh run writes both tiers, the
    verdict hit makes no launch and starts no nvcc, the invariant-only
    edit is a reach hit through one K31 launch, the seeded violation exits
    12 with the violation section of the full run, each transcript equal
    to the reference's (pinned); corrupt artifacts are loud misses that
    heal; -recheck bypasses the read; K31 bitwise against its plain
    version on the reachable sets of TwoPhase and RaftReplication with
    seeded rows."""
    from torchtlc.struct import artifacts as ta
    from torchtlc.struct.loader import load

    cfgs = models23(tmp)
    rows = {}
    record = gen_recorder(rows)
    store = os.path.join(tmp, "p23", "tiny_store")
    res = art23_steps(ops, cfgs, ART23_STEPS, ART23_TRANSCRIPT, store,
                      "art23")
    need(sorted(os.listdir(store)) == ["reach", "verdict"],
         "ArtTiny: the fresh run wrote no artifacts")
    _, text, launches, _, nv, evs = res["hit"]
    need(not any(launches.values()) and nv == 0
         and evs == [("verdict", "hit")]
         and "Incremental re-check: verdict replayed" in text,
         f"ArtTiny verdict hit: launches {launches}, {nv} nvcc runs, {evs}")
    for tag in ("edit", "seeded"):
        launches, evs = res[tag][2], res[tag][5]
        need(launches["struct_recheck"] == 1
             and sum(launches.values()) == 1 and ("reach", "hit") in evs,
             f"ArtTiny {tag}: launches {launches}, {evs}")
    need(res["seeded"][0] == res["full"][0] == 12
         and violation_section(res["seeded"][1])
         == violation_section(res["full"][1]),
         "ArtTiny seeded: the violation differs from the full run's")
    out = {f"p23_{t}": {"launches": r[2]} for t, r in res.items()}
    st = ta.ArtifactStore(store)
    m = load(cfgs["base"])
    for p in (st._path("verdict", ta.verdict_key(m)),
              st._path("reach", ta.reach_key(m))):
        raw = open(p, "rb").read()
        with open(p, "wb") as f:
            f.write(raw[:-5] + bytes(5))
    heal = {"corrupt": ("base", _A + ART23_GEOM, False),
            "recheck": ("base", _A + ART23_GEOM + ["-recheck"], False)}
    for tag, (key, extra, _) in heal.items():
        journal = os.path.join(tmp, "p23", f"{tag}.jsonl")
        rc, text, launches, _ = command_here(ops, [cfgs[key]] + [
            x.replace("STORE", store) for x in extra] + ["-journal",
                                                         journal])
        evs = journal_cache(journal)
        need(rc == 0 and final_counts(text) == final_counts(
            res["fresh"][1]), f"ArtTiny {tag}: exit {rc}")
        if tag == "corrupt":
            need(text.count("corrupt") >= 2 and {
                ("verdict", "corrupt"), ("reach", "corrupt"),
                ("verdict", "write"), ("reach", "write")} <= set(evs)
                and all(r["ok"] for r in st.verify()),
                f"ArtTiny corrupt: {evs}")
        else:
            need(evs == [("verdict", "bypass"), ("verdict", "write")],
                 f"ArtTiny -recheck: {evs}")
        out[f"p23_{tag}"] = {"launches": launches}
    lines = art23_reach_sets(torch, ops, cfgs, record)
    k31 = rows["struct_recheck"][-1]
    print("phase 23 artifact cache (ArtTiny through the command, "
          "transcripts = the reference's): fresh wrote both tiers, verdict "
          "hit with 0 launches and 0 nvcc runs, invariant-only edit and "
          "seeded violation (exit 12, the full run's violation) through one "
          "K31 launch each, corrupt artifacts healed, -recheck bypassed; "
          "K31 bitwise = plain on " + "; ".join(lines)
          + f" (RaftReplication seeded: {k31['ms']:.4f} ms, plain "
          f"{k31['plain_ms']:.2f} ms) on {card}", flush=True)
    out.update(p23_rows=rows, p23_cfgs=cfgs)
    return out


def phase_art23_real(torch, ops, card, runs, tmp):
    """Phase 23b: TwoPhase with RM of 8 (1,745,408 distinct states) in a
    temporary store - the fresh run writes both tiers (the inversion, write
    and read seconds, the artifacts' bytes), the verdict hit (its wall, no
    launch, no nvcc), the invariant-only edit a reach hit through K31 over
    the 1,745,408 stored rows (K31 timed a launch against its bound), the
    seeded violation exit 12 with the port's full run's trace; then
    RaftReplication with five nodes narrowed (53 bits) through the reach
    tier and un-narrowed (67 bits) through the verdict tier only."""
    import numpy as np

    from torchtlc.struct import artifacts as ta
    from torchtlc.struct.cache import get_backend, get_bounds
    from torchtlc.struct.loader import load

    cfgs = runs.get("p23_cfgs") or models23(tmp)
    rows = runs.setdefault("p23_rows", {})
    record = gen_recorder(rows)
    out, lines = {}, []
    nvcc_s = prebuild23(ops, cfgs)
    store = os.path.join(tmp, "p23", "tp8_store")
    tp = ["-noTool", "-nodeadlock", "-artifact-cache", store] + TP23_GEOM

    def step(tag, key, extra):
        path = os.path.join(tmp, "p23", f"tp8_{tag}.jsonl")
        with counted_nvcc() as nv:
            rc, text, launches, wall = command_here(
                ops, [cfgs[key]] + extra + ["-journal", path])
        out[f"p23b_{tag}"] = {"launches": launches}
        return rc, text, launches, wall, len(nv), journal_cache(path)

    with artifact_timers() as spent:
        rc, fresh, _, wall_fresh, _, evs = step("fresh", "tp8", tp)
    need(rc == 0 and final_counts(fresh) == TP8_COUNTS
         and ("reach", "write") in evs, f"TwoPhase-8 fresh: {rc}, {evs}")
    nbytes = {t: sum(os.path.getsize(os.path.join(store, t, f))
                     for f in os.listdir(os.path.join(store, t)))
              for t in ("verdict", "reach")}
    with artifact_timers() as spent_hit:
        rc, text, launches, wall_hit, nv, evs = step("hit", "tp8", tp)
    need(rc == 0 and final_counts(text) == TP8_COUNTS and nv == 0
         and not any(launches.values()) and evs == [("verdict", "hit")],
         f"TwoPhase-8 verdict hit: {launches}, {nv} nvcc runs, {evs}")
    with artifact_timers() as spent_edit:
        rc, text, launches, wall_edit, _, evs = step("edit", "tp8_edit", tp)
    need(rc == 0 and final_counts(text) == TP8_COUNTS
         and launches["struct_recheck"] == 1 and ("reach", "hit") in evs,
         f"TwoPhase-8 edit: {rc}, {launches}, {evs}")
    m = load(cfgs["tp8_edit"])
    states, _ = ta.ArtifactStore(store).lookup_reach(ta.reach_key(m, False))
    prog = get_backend(m, False).kernels.prog
    words = torch.from_numpy(states.view(np.int32)).cuda()
    _, first = k31_check(torch, ops, "TwoPhase-8", prog, words, record)
    need(int(first) == TP8_COUNTS[1], "TwoPhase-8: a stored state fails")
    rc, seeded, launches, wall_seed, _, evs = step("seeded", "tp8_seeded",
                                                   tp)
    need(rc == 12 and launches["struct_recheck"] == 1,
         f"TwoPhase-8 seeded: exit {rc}, {launches}")
    rc_full, full, _, wall_full, _, _ = step(
        "full", "tp8_seeded", ["-noTool", "-nodeadlock",
                               "-no-artifact-cache"] + TP23_GEOM)
    need(rc_full == 12 and violation_section(seeded)
         == violation_section(full),
         "TwoPhase-8 seeded: the trace differs from the full run's")
    k31 = rows["struct_recheck"][-1]
    lines.append(
        f"TwoPhase-8: fresh {wall_fresh:.2f} s (inversion "
        f"{sum(spent['inversion']):.3f} s, writes "
        f"{sum(spent.get('put_verdict', [])) + sum(spent['put_reach']):.3f}"
        f" s; artifacts {nbytes['verdict']:,} B verdict, "
        f"{nbytes['reach']:,} B reach), verdict hit {wall_hit:.3f} s (read "
        f"{sum(spent_hit['lookup_verdict']):.4f} s, 0 launches, 0 nvcc), "
        f"edit {wall_edit:.3f} s (reach read "
        f"{sum(spent_edit['lookup_reach']):.3f} s; K31 {k31['ms']:.4f} ms "
        f"a launch over {TP8_COUNTS[1]:,} rows, plain "
        f"{k31['plain_ms']:.2f} ms, bound {k31['bound_ms']:.4f} ms by "
        f"{k31['bound_by']}: {k31['shape']}), "
        f"seeded exit 12 in {wall_seed:.2f} s = the full run's trace "
        f"({wall_full:.2f} s)")
    # RaftReplication with five nodes: narrowed through the reach tier,
    # un-narrowed through the verdict tier only
    m5 = load(cfgs["rr5_4"])
    need(get_backend(m5, False).cdc.nbits == 67 and get_backend(
        m5, False, bounds=get_bounds(m5)).cdc.nbits == 53,
        "RR5: the codec widths changed")
    for mode, flags in (("narrow", ["-narrow"]), ("base", [])):
        store = os.path.join(tmp, "p23", f"rr5_{mode}_store")
        rr = ["-noTool", "-nodeadlock", "-artifact-cache", store] + flags \
            + RR23_GEOM
        rc, text, _, wall_a, _, evs_a = step(f"rr5_{mode}", "rr5_3", rr)
        need(rc == 0 and final_counts(text) == RR5_COUNTS,
             f"RR5 {mode} fresh: exit {rc}, {final_counts(text)}")
        if mode == "base":
            # no affine inverse at 67 bits: the verdict tier only
            reach_dir = os.path.join(store, "reach")
            need(("reach", "skip") in evs_a and not (
                os.path.isdir(reach_dir) and os.listdir(reach_dir)),
                f"RR5 base: {evs_a}")
            lines.append(f"RR5 base: fresh {wall_a:.2f} s {evs_a}")
            continue
        rc, text, launches, wall_b, _, evs_b = step(f"rr5_{mode}_edit",
                                                    "rr5_4", rr)
        need(rc == 0 and final_counts(text) == RR5_COUNTS
             and ("reach", "write") in evs_a and ("reach", "hit") in evs_b
             and launches["struct_recheck"] == 1,
             f"RR5 narrowed: exit {rc}, {evs_a}, {evs_b}, {launches}")
        lines.append(f"RR5 {mode}: fresh {wall_a:.2f} s {evs_a}, "
                     f"invariant-only edit {wall_b:.2f} s {evs_b}")
    print(f"phase 23b artifact cache at the real size (the six spec "
          f"libraries built first, nvcc in parallel {nvcc_s:.1f} s): "
          + "; ".join(lines) + f" on {card}", flush=True)
    return out


def prebuild23(ops, cfgs) -> float:
    """Build the libraries the commands of phase 23b load (one nvcc a
    text, all started together), so that each step's wall is its run's:
    the TwoPhase-8 copies and RaftReplication-5 narrowed and not.
    Returns the build's wall seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from torchtlc.struct.cache import get_backend, get_bounds
    from torchtlc.struct.loader import load

    progs = []
    for key, narrow in (("tp8", False), ("tp8_edit", False),
                        ("tp8_seeded", False), ("rr5_3", True),
                        ("rr5_4", True), ("rr5_3", False)):
        m = load(cfgs[key])
        b = get_backend(m, False, bounds=get_bounds(m) if narrow else None)
        progs.append(b.kernels.prog)
    t0 = time.time()
    with ThreadPoolExecutor(len(progs)) as pool:
        list(pool.map(ops.struct_lib, progs))
    return time.time() - t0


def phase_command23(ops, card, runs, tmp):
    """Phase 23c: the commands on TwoPhase Model_1 with a temporary store -
    -artifact-cache DIR fresh and hit, -recheck, -no-artifact-cache,
    -infer reading exact evidence from the stored artifact, and -simulate's
    bypass event - exit codes and transcripts equal to the reference's
    (pinned), the journal's cache events as the reference's."""
    cfgs = runs.get("p23_cfgs") or models23(tmp)
    store = os.path.join(tmp, "p23", "cmd_store")
    res = art23_steps(ops, cfgs, CMD23, CMD23_TRANSCRIPT, store, "cmd23")
    want = {"fresh": [("verdict", "miss"), ("reach", "miss"),
                      ("verdict", "write"), ("reach", "write")],
            "hit": [("verdict", "hit")],
            "recheck": [("verdict", "bypass"), ("verdict", "write")],
            "noart": [], "infer": [("verdict", "bypass")],
            "sim": [("verdict", "bypass")]}
    for tag, evs in want.items():
        need(res[tag][5] == evs, f"command {tag}: cache events "
             f"{res[tag][5]}")
    need(not any(res["hit"][2].values()) and res["hit"][4] == 0,
         "command hit: launches or nvcc")
    need("exact artifact evidence" in res["infer"][1],
         "command -infer: no artifact evidence")
    print("phase 23c artifact-cache commands, transcripts and cache events "
          "= the reference's: " + "; ".join(
              f"{t} exit {r[0]} ({r[3]:.2f} s)" for t, r in res.items())
          + f" on {card}", flush=True)
    return {f"p23c_{t}": {"launches": r[2]} for t, r in res.items()
            if r[0] in (0, 12)}


# ---------------------------------------------------------------------------
# phases 24-24d: the serving plane - constants-class sweeps and batched
# smoke walks in one dispatch (K32-K35), the warm pool, the scheduler and
# its HTTP service, -serve and -trace-out
# ---------------------------------------------------------------------------

# TwoPhase with a bounded renege count MAXR, the reference's sweep spec
# (tests/test_service.py _TPB): MAXR swept over [0, 2]
TPB24_TLA = """---- MODULE TwoPhaseB ----
EXTENDS Naturals, FiniteSets, TLC

CONSTANTS RM, MAXR

VARIABLES rmState, tmState, tmPrepared, msgs, reneged

vars == <<rmState, tmState, tmPrepared, msgs, reneged>>

Init == /\\ rmState = [r \\in RM |-> "working"]
        /\\ tmState = "running"
        /\\ tmPrepared = {}
        /\\ msgs = {}
        /\\ reneged = 0

Vote(r) == /\\ rmState[r] = "working"
           /\\ rmState' = [rmState EXCEPT ![r] = "prepared"]
           /\\ msgs' = msgs \\cup {[kind |-> "vote", from |-> r]}
           /\\ UNCHANGED <<tmState, tmPrepared, reneged>>

Renege(r) == /\\ rmState[r] = "working"
             /\\ reneged < MAXR
             /\\ reneged' = reneged + 1
             /\\ rmState' = [rmState EXCEPT ![r] = "aborted"]
             /\\ UNCHANGED <<tmState, tmPrepared, msgs>>

Collect(r) == /\\ tmState = "running"
              /\\ [kind |-> "vote", from |-> r] \\in msgs
              /\\ tmPrepared' = tmPrepared \\cup {r}
              /\\ UNCHANGED <<rmState, tmState, msgs, reneged>>

Decide == /\\ tmState = "running"
          /\\ tmPrepared = RM
          /\\ tmState' = "committed"
          /\\ msgs' = msgs \\cup {[kind |-> "commit"]}
          /\\ UNCHANGED <<rmState, tmPrepared, reneged>>

CallOff == /\\ tmState = "running"
           /\\ tmState' = "aborted"
           /\\ msgs' = msgs \\cup {[kind |-> "stop"]}
           /\\ UNCHANGED <<rmState, tmPrepared, reneged>>

ObeyCommit(r) == /\\ [kind |-> "commit"] \\in msgs
                 /\\ rmState[r] = "prepared"
                 /\\ rmState' = [rmState EXCEPT ![r] = "committed"]
                 /\\ UNCHANGED <<tmState, tmPrepared, msgs, reneged>>

ObeyAbort(r) == /\\ [kind |-> "stop"] \\in msgs
                /\\ rmState[r] # "committed"
                /\\ rmState[r] # "aborted"
                /\\ rmState' = [rmState EXCEPT ![r] = "aborted"]
                /\\ UNCHANGED <<tmState, tmPrepared, msgs, reneged>>

Next == \\/ Decide
        \\/ CallOff
        \\/ \\E r \\in RM : \\/ Vote(r)
                         \\/ Renege(r)
                         \\/ Collect(r)
                         \\/ ObeyCommit(r)
                         \\/ ObeyAbort(r)

Spec == /\\ Init
        /\\ [][Next]_vars

Agreement == \\A r1, r2 \\in RM : ~(/\\ rmState[r1] = "aborted"
                                  /\\ rmState[r2] = "committed")

CommitVoted == tmState = "committed" => tmPrepared = RM
====
"""
TPB24_CFG = ("CONSTANT RM = {r1, r2}\nCONSTANT MAXR = 2\nSPECIFICATION\n"
             "Spec\nINVARIANT\nAgreement\nCommitVoted\n")
TPB24_PARAMS = {"MAXR": (0, 2)}
TPB24_KW = dict(chunk=64, queue_capacity=1 << 10, fp_capacity=1 << 12,
                check_deadlock=False, width=3)
# (generated, distinct, depth, Renege fires) per MAXR, and the SHA-256 of
# each lane's final table words: the reference's SweepEngine.run on the
# CPU at TPB24_KW
TPB24_COUNTS = {0: (81, 49, 8, 0), 1: (119, 66, 8, 18), 2: (124, 68, 8, 22)}
TPB24_TABLES = (
    "e3803467e86c082d76cfc8a7698fd3407b8e532d839afd9b923b124e39fd31dc",
    "59db59af65d02f74ffd48a79fcd13420bda0d6c965595c86dd079315d2fae60e",
    "44f9d256c7f4a7ed7c8b1b081ad5c2cb63bbb646c4e6f0194b023f080c3fee89")
# RaftReplication with four servers over its term bound: MaxTerm swept over
# [4, 7] (anchor 7) at phase 19b's geometry.  TypeOK leaves the cfg: its
# `currentTerm \in [Nodes -> 0..MaxTerm]` sizes a range, which no swept
# field can (the reference's class compile raises "dynamic .. range" on
# it, as the port's does); it holds on every state, so the counts are the
# full run's
RR4S_CFG = RR4_CFG.replace("TypeOK\n", "")
RR4S_PARAMS = {"MaxTerm": (4, 7)}
RR4S_KW = dict(chunk=1 << 14, queue_capacity=1 << 21, fp_capacity=1 << 23,
               check_deadlock=False, width=4)
# phase 24c: RR5T6's seeds 7-10 at phase 20b's geometry in one dispatch
RR5T6_SEEDS = (7, 8, 9, 10)
# phase 24d: a long chain for the preemption flows (tests/test_service.py
# _CHAIN_SPEC, its MAX 2,000 cut to 400 for the script's time limit)
CHAIN24_TLA = """---- MODULE LoadChain ----
EXTENDS Naturals
CONSTANTS MAX
VARIABLES x

Init == x = 0

Up == /\\ x < MAX
      /\\ x' = x + 1

Next == Up

Spec == Init /\\ [][Next]_x

InRange == x <= MAX
====
"""
# at MAX 400 each of 24d's chain jobs is ~400 bodies, still long enough to
# be preempted, to expire its 0.3 s deadline, to be cancelled and to hold
# the one-job queue while the 429 is provoked
CHAIN24_CFG = "CONSTANT MAX = 400\nSPECIFICATION\nSpec\nINVARIANT\nInRange\n"
CHAIN24_OPTS = dict(chunk=16, qcap=256, fpcap=1024, nodeadlock=True,
                    checkpointevery=8, noartifactcache=True)
SWEEP24 = {"const": "MAXR", "lo": 0, "hi": 2}
OPTS24 = dict(chunk=64, qcap=1 << 10, fpcap=1 << 12, nodeadlock=True)
SIM24 = dict(simulate=True, walkers=8, depth=12, fpcap=1 << 10,
             nodeadlock=True)
# `check TwoPhase/Model_1/MC.cfg -noTool -nodeadlock -no-artifact-cache
# -journal J` with -trace-out P (P masked as TRACE) or -serve PORT: the
# reference's exit code, the SHA-256 of struct_masked(transcript) and its
# journal's event kinds, on the CPU
TWO24_EVENTS = ["run_start", "analysis", "analysis_summary", "segment"] + [
    "level"] * 8 + ["phase", "phase", "final"]
TWO24_PINS = {
    "traceout": (0, "48d49d63c1856c6db1362da08bf32d5b"
                    "7eb361c6798e4a92e2c3149452f42668",
                 TWO24_EVENTS + ["trace_export"]),
    "serve": (0, "eefe00acd60e917601998f0e625a8637"
                 "8650aa48a6267d7d7a0f1582f85ba49a", TWO24_EVENTS),
}


def models24(tmp):
    """The model files of phases 24-24d in `tmp`/p24: {key: MC.cfg}."""
    here = os.path.dirname(os.path.abspath(__file__))
    raft = open(os.path.join(here, "specs", "RaftReplication.toolbox",
                             "Model_1", "RaftReplication.tla")).read()
    out = {}
    for key, files, cfg in (
            ("tpb", {"TwoPhaseB.tla": TPB24_TLA,
                     "TwoPhaseB.cfg": TPB24_CFG}, "TwoPhaseB.cfg"),
            ("rr4s", {"RaftReplication.tla": raft, "MC.cfg": RR4S_CFG},
             "MC.cfg"),
            ("rr5t6", {"RaftReplication.tla": raft, "MC.cfg": RR5T6_CFG},
             "MC.cfg"),
            ("tpb1", {"TwoPhaseB.tla": TPB24_TLA,
                      "TwoPhaseB.cfg": TPB24_CFG.replace("MAXR = 2",
                                                         "MAXR = 1")},
             "TwoPhaseB.cfg"),
            ("chain", {"LoadChain.tla": CHAIN24_TLA,
                       "LoadChain.cfg": CHAIN24_CFG}, "LoadChain.cfg")):
        d = os.path.join(tmp, "p24", key)
        os.makedirs(d, exist_ok=True)
        for name, text in files.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        out[key] = os.path.join(d, cfg)
    out["two"] = os.path.join(here, "specs", "TwoPhase.toolbox", "Model_1",
                              "MC.cfg")
    return out


def prebuild24(ops, cfgs):
    """Every emitted library phases 24-24d run, built at once (one nvcc a
    text, in parallel): the TwoPhaseB and RR4 classes, RR4's four
    baked-constant checks, RR5T6, and the texts of 24d's jobs and
    commands (a library is found again by its text).  Returns the seconds
    it took and the number of texts."""
    from concurrent.futures import ThreadPoolExecutor

    from torchtlc.serve.sweep import load_anchored, sweep_backend
    from torchtlc.struct.cache import get_backend
    from torchtlc.struct.loader import load

    # the batched texts (K32, K34, K35 beside K17): the two classes and
    # the smoke batches of one configuration
    progs = [sweep_backend(load_anchored(cfgs["tpb"], TPB24_PARAMS),
                           TPB24_PARAMS, False).kernels.prog,
             sweep_backend(load_anchored(cfgs["rr4s"], RR4S_PARAMS),
                           RR4S_PARAMS, False).kernels.prog,
             sweep_backend(load(cfgs["rr5t6"]), {}, False).kernels.prog,
             sweep_backend(load(cfgs["tpb"]), {}, False).kernels.prog]
    models = [load(cfgs["rr4s"], const_overrides={"MaxTerm": v})
              for v in (4, 5, 6, 7)]
    models += [load(cfgs[k]) for k in ("tpb", "tpb1", "chain", "two")]
    progs += [get_backend(m, False).kernels.prog for m in models]
    texts = {p.text: p for p in progs}
    t0 = time.time()
    with ThreadPoolExecutor(len(texts)) as pool:
        list(pool.map(ops.struct_lib, texts.values()))
    return time.time() - t0, len(texts)


def step_row_ops(prog) -> int:
    """K32's integer operations a popped row: the statements of the
    emitted step (one operation each) and three a field for the unpack
    and the pack of each lane's successor."""
    body = prog.text.split("HD void st_step(", 1)[1].split("#include", 1)[0]
    return body.count(";") + 3 * prog.F * (1 + prog.L)


def sweep_lane_words(carries):
    """The interop words of each lane carry (the reference's leaf names)."""
    from torchtlc.engine.interop import carry_to_numpy

    return [carry_to_numpy(c) for c in carries]


def words_equal(a, b) -> bool:
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and (a[k] == b[k]).all() for k in a)


def sweep_pops(b, C):
    """The [K, 4] pops K32 takes at the next body of batched carry `b`
    (the engine's own rule: two-tier width, frozen lanes 0)."""
    from torchtlc.engine.bfs import _running

    pops = []
    small = C // 16 if C >= 1 << 14 else 0
    for c in b.lanes:
        h = c.bundle
        if not _running(h):
            pops.append([0, 0, 0, 0])
            continue
        w = small if small and h.level_n - h.qhead < C // 2 else C
        pops.append([h.parity, h.qhead, min(max(h.level_n - h.qhead, 0), w),
                     w])
    return pops


def k32_k33_check(torch, ops, tag, eng, b, record, reps=10):
    """K32 on the batched carry `b`'s next pops and K33 on that block's
    valid candidates (each lane's table), against their plain versions:
    bitwise; timed with `record`, K33's library time being the one sort
    over (lane, key) at that shape."""
    import numpy as np

    from torchtlc.engine import fpset
    from torchtlc.engine.fingerprint import fp64_words

    prog = eng.backend.kernels.prog
    C, L = eng.chunk, prog.L
    pops = sweep_pops(b, C)
    pop = torch.tensor(pops, dtype=torch.int64)
    deferred = eng.deferred
    got = ops.emitted_expand_batched(prog, b.queue, pop.cuda(), C, deferred)
    ref = prog.expand_batched_plain(b.queue, pop, C, deferred)
    for k, (_, _, _, ck) in enumerate(pops):
        m = ck * L
        nf = (3 + prog.n_inv) * m
        for i, cut in ((0, m), (1, nf), (2, m), (4, m)):
            if got[i] is not None:
                need(torch.equal(got[i][k, :cut], ref[i][k, :cut]),
                     f"K32 output {i} differs from its plain version "
                     f"({tag}, lane {k})")
        need(torch.equal(got[3][k], ref[3][k]), f"K32 gen ({tag}, lane {k})")
    # K33 on the widest lanes' candidates (lanes of one body may differ)
    w = max(p[3] for p in pops)
    live = [k for k, p in enumerate(pops) if p[3] == w]
    rows_popped = sum(p[2] for p in pops)
    record("emitted_expand_batched", f"{tag}: {len(pops)} lanes, "
           f"{rows_popped:,} rows popped, L {L}, W {prog.W}", 0,
           cuda_ms(torch, lambda _: ops.emitted_expand_batched(
               prog, b.queue, pop.cuda(), C, deferred), reps),
           cuda_ms(torch, lambda _: prog.expand_batched_plain(
               b.queue, pop, C, deferred), 2),
           *gen_bound_ms(rows_popped * prog.W * 4 + sum(
               p[3] for p in pops) * L * (prog.W * 4 + 3 + prog.n_inv + 4
                                          + (prog.F * 4 if deferred else 0)),
               rows_popped * step_row_ops(prog)))
    n = w * L
    lo, hi = fp64_words(got[0][live, :n].reshape(-1, prog.W),
                        prog.cdc.nbits)
    lo, hi = lo.view(len(live), n), hi.view(len(live), n)
    mask = got[1][live, :n].bool()
    R = min(2 * w, n)
    tables = b.table.clone()
    wstats = torch.zeros(3, dtype=torch.int32, device=tables.device)
    res = fpset.fpset_insert_sorted_batched(tables, live, lo, hi, mask,
                                            probe_width=R, claim_width=R,
                                            walk_stats=wstats)
    plain_tables = b.table.clone()
    ref = fpset.fpset_insert_sorted_batched(
        plain_tables, live, lo, hi, mask, probe_width=R, claim_width=R,
        plain=True)
    for a, r in zip(res, ref):
        need(torch.equal(a, r), f"K33 differs from its plain version "
             f"({tag})")
    need(torch.equal(tables, plain_tables), f"K33 table words ({tag})")
    keys = fpset.fpset_key_batched(lo, hi, mask)
    n_valid = int(mask.sum())
    nreps = int(res[2].sum())
    slices, rounds, general = (int(x) for x in wstats.tolist())
    need(general == 0, f"K33 walk: {general} slices took the general order "
         f"({tag})")
    record("fpset_insert_batched", f"{tag}: {len(live)} lanes x {n:,} "
           f"candidates, {n_valid:,} valid, {nreps:,} distinct, R {R:,}; "
           f"the walks {slices} slices, {rounds} rounds", 0,
           cuda_ms(torch, lambda t: fpset.fpset_insert_sorted_batched(
               t, live, lo, hi, mask, probe_width=R, claim_width=R), reps,
               lambda: b.table.clone()),
           cuda_ms(torch, lambda t: fpset.fpset_insert_sorted_batched(
               t, live, lo, hi, mask, probe_width=R, claim_width=R,
               plain=True), 1, lambda: b.table.clone()),
           *gen_bound_ms(len(live) * n * (8 + 9) + nreps * 64 * 2,
                         len(live) * n * 40))
    lib = cuda_ms(torch, lambda _: torch.sort(keys, dim=1, stable=True),
                  reps)
    return lib


def k34_k35_check(torch, ops, tag, be, init, run, seeds, inits, depth,
                  record, rounds=3, reps=10, dl=False):
    """K34 / K35 on the card against their plain versions over a batched
    walk: `rounds` rounds from round 0 of the kernel route beside the plain
    route on the same stacked carry, every leaf equal after each; then one
    round of each kernel timed mid-walk with `record`."""
    from torchtlc.sim import engine as se

    prog = be.kernels.prog
    c = init(seeds, inits)
    buf = init.buffers
    for r in range(rounds):
        c = run(c, 1)
    K, W = c.states.shape[:2]
    outs = []
    for kernel in (True, False):
        cc, bb = clone_carry(c), clone_buffers(buf)
        bb.go.copy_(((cc.step_i < depth) & (cc.viol == 0)
                     & cc.alive.any(1)).to(torch.int32))
        if kernel:
            ops.struct_sim_step_batched(prog, bb, cc, dl)
        else:
            prog.sim_step_batched_plain(bb, cc, dl)
        outs.append((cc, bb))
    (ck, bk), (cp, bp) = outs
    for name in ("states", "alive", "steps_taken"):
        need(torch.equal(getattr(ck, name), getattr(cp, name)),
             f"K34 {name} differs from its plain version ({tag})")
    for name in ("scratch", "packed", "take"):
        if getattr(bk, name) is not None:
            need(torch.equal(getattr(bk, name), getattr(bp, name)),
                 f"K34 {name} differs from its plain version ({tag})")
    ops.sim_fold_batched(prog, bk, ck, depth)
    prog.sim_fold_batched_plain(bp, cp, depth)
    for k in range(K):
        for a, b in zip(se.carry_to_reference(se.lane_carry(ck, k)),
                        se.carry_to_reference(se.lane_carry(cp, k))):
            need(a.shape == b.shape and (a == b).all(),
                 f"K35 differs from its plain version ({tag}, lane {k})")
    need(torch.equal(bk.go, bp.go) and torch.equal(bk.scratch, bp.scratch),
         f"K35 go / reset scratch ({tag})")

    def setup():
        cc, bb = clone_carry(c), clone_buffers(buf)
        bb.go.copy_(((cc.step_i < depth) & (cc.viol == 0)
                     & cc.alive.any(1)).to(torch.int32))
        return cc, bb

    def setup35():
        cc, bb = setup()
        ops.struct_sim_step_batched(prog, bb, cc, dl)
        return cc, bb

    n_live = int(c.alive.sum())
    record("struct_sim_step_batched", f"{tag}: {K} lanes x {W:,} walkers "
           f"({n_live:,} live) at round {rounds + 1}", 0,
           cuda_ms(torch, lambda a: ops.struct_sim_step_batched(
               prog, a[1], a[0], dl), reps, setup),
           cuda_ms(torch, lambda a: prog.sim_step_batched_plain(
               a[1], a[0], dl), 1, setup),
           *gen_bound_ms(k27_bytes(prog, n_live, K * W),
                         n_live * sim_lane_ops(prog)))
    S = bk.scratch.shape[1]
    record("sim_fold_batched", f"{tag}: {K} lanes", 0,
           cuda_ms(torch, lambda a: ops.sim_fold_batched(
               prog, a[1], a[0], depth), reps, setup35),
           cuda_ms(torch, lambda a: prog.sim_fold_batched_plain(
               a[1], a[0], depth), 1, setup35),
           *gen_bound_ms(K * (8 * S + 4 * prog.n_labels * 2 + 8 * prog.F
                              + 64), K * (S + prog.n_labels + prog.F)))
    return c


def phase_sweep24(torch, ops, card, runs, tmp):
    """Phase 24: the shipped sweep - TwoPhaseB with MAXR over [0, 2] at
    width 3 in one dispatch: each lane's counts and table words against
    the reference's CPU run (pinned), each lane bit-equal to its
    sequential run on the card; K32 and K33 against their plain versions
    on that class mid-run, K34 and K35 on a 256-walker smoke batch."""
    from torchtlc.serve.sweep import SweepEngine, config_inits, load_anchored
    from torchtlc.sim.engine import make_batched_sim

    cfgs = models24(tmp)
    build_s, n_texts = prebuild24(ops, cfgs)
    print(f"phase 24 build: {n_texts} emitted libraries (K17-K18, K21, "
          f"K27-K28, K31 in each; K32, K34-K35 in the four batched texts) "
          f"in {build_s:.1f} s", flush=True)
    rows = {}
    record = gen_recorder(rows)
    m = load_anchored(cfgs["tpb"], TPB24_PARAMS)
    eng = SweepEngine(m, TPB24_PARAMS, **TPB24_KW)
    prog = eng.backend.kernels.prog
    ops.struct_lib(prog)  # built before the timed and counted run
    configs = [{"MAXR": v} for v in (0, 1, 2)]
    ops.reset_counts()
    carries, wall = eng.run_carries(configs)
    launches = dict(ops.LAUNCHES)
    for k, v in enumerate((0, 1, 2)):
        r = eng._result(carries[k], wall)
        got = (r.generated, r.distinct, r.depth,
               r.action_generated.get("Renege", 0))
        need(got == TPB24_COUNTS[v], f"TwoPhaseB MAXR {v}: {got}")
        need(table_sha256(carries[k].fps.table) == TPB24_TABLES[k],
             f"TwoPhaseB MAXR {v}: table words differ from the reference's")
    batched = sweep_lane_words(carries)
    seq = eng.sequential_carries(configs)
    for k, (c, _, _) in enumerate(seq):
        need(words_equal(batched[k], sweep_lane_words([c])[0]),
             f"TwoPhaseB lane {k} differs from its sequential run")
    b = eng._stack_fn([eng.carry_for(v) for v in configs])
    for _ in range(3):
        b = eng._brun.body(b)
    lib33 = k32_k33_check(torch, ops, "TwoPhaseB class, body 4", eng, b,
                          record)
    # K34 / K35: a 256-walker smoke batch of the class, seeds x configs
    be = eng.backend
    init, run = make_batched_sim(be, 3, walkers=256, depth=24,
                                 fp_capacity=1 << 12, check_deadlock=False)
    inits = [config_inits(m, TPB24_PARAMS, v, be.cdc) for v in configs]
    ops.reset_counts()
    run(init([1, 2, 3], inits))
    sim_launches = dict(ops.LAUNCHES)
    k34_k35_check(torch, ops, "TwoPhaseB smoke", be, init, run, [1, 2, 3],
                  inits, 24, record)
    k32, k33 = rows["emitted_expand_batched"][-1], \
        rows["fpset_insert_batched"][-1]
    print(f"phase 24 shipped sweep (TwoPhaseB, MAXR [0, 2], width 3, one "
          f"dispatch of {eng._brun.bodies} bodies, {wall:.3f} s): counts "
          f"{[TPB24_COUNTS[v] for v in (0, 1, 2)]} and table words = the "
          f"reference's, every lane = its sequential run; K32 "
          f"{k32['ms']:.4f} ms, K33 {k33['ms']:.4f} ms (sort {lib33:.4f} "
          f"ms), K34 / K35 = plain on 3 x 256 walkers; launches "
          f"{ {k: v for k, v in launches.items() if v} } on {card}",
          flush=True)
    return {"p24_tpb": {"launches": launches},
            "p24_smoke": {"launches": sim_launches}, "p24_rows": rows,
            "p24_library": {"fpset_insert_batched": lib33},
            "p24_cfgs": cfgs}


def phase_sweep24_real(torch, ops, card, runs, tmp):
    """Phase 24b: RaftReplication with four servers over MaxTerm [4, 7]
    (anchor 7, width 4) in one dispatch at phase 19b's geometry (chunk
    16,384, qcap 2^21, fp 2^23 a lane: two-tier, sort-free and deferred
    all live): the MaxTerm 7 lane gives the full run's counts, every lane
    is bit-equal (carry leaf for leaf, table words included) to its
    sequential run and count-equal to the baked-constant check of its
    MaxTerm; the dispatch's wall against the four sequential runs' in
    turns; busy share and top device items under torch.profiler; K32 and
    K33 against their plain versions at full width mid-run."""
    from torchtlc.serve.sweep import SweepEngine, load_anchored
    from torchtlc.struct.engine import check_struct
    from torchtlc.struct.loader import load

    cfgs = runs.get("p24_cfgs") or models24(tmp)
    rows = runs.setdefault("p24_rows", {})
    record = gen_recorder(rows)
    m = load_anchored(cfgs["rr4s"], RR4S_PARAMS)
    eng = SweepEngine(m, RR4S_PARAMS, **RR4S_KW)
    ops.struct_lib(eng.backend.kernels.prog)
    configs = [{"MaxTerm": v} for v in (4, 5, 6, 7)]
    walls = {"batched": [], "sequential": []}
    out = {}
    for turn in range(2):
        ops.reset_counts()
        carries, wall = eng.run_carries(configs)
        out[f"p24b_rr4_{turn}"] = {"launches": dict(ops.LAUNCHES)}
        walls["batched"].append(round(wall, 4))
        if turn == 0:
            results = [eng._result(c, wall) for c in carries]
            counts = [(r.generated, r.distinct, r.depth) for r in results]
            need(counts[3] == RR4_COUNTS["base"], f"RR4 MaxTerm 7 lane: "
                 f"{counts[3]}, the full run's {RR4_COUNTS['base']}")
            batched = sweep_lane_words(carries)
            bodies, lane_bodies = eng._brun.bodies, eng._brun.lane_bodies
        del carries
        seq = eng.sequential_carries(configs)
        walls["sequential"].append(round(sum(w for _, w, _ in seq), 4))
        if turn == 0:
            for k, (c, _, _) in enumerate(seq):
                need(words_equal(batched[k], sweep_lane_words([c])[0]),
                     f"RR4 lane {k} differs from its sequential run")
        del seq
    del batched
    for k, v in enumerate((4, 5, 6, 7)):
        base = load(cfgs["rr4s"], const_overrides={"MaxTerm": v})
        r = check_struct(base, check_deadlock=False,
                         **{k2: v2 for k2, v2 in RR4S_KW.items()
                            if k2 not in ("width", "check_deadlock")})
        need((r.generated, r.distinct, r.depth) == counts[k],
             f"RR4 MaxTerm {v}: {counts[k]}, the baked check's "
             f"{(r.generated, r.distinct, r.depth)}")
    _, traced, busy, by_name = device_busy(
        torch, lambda: eng.run_carries(configs))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    b = eng._stack_fn([eng.carry_for(v) for v in configs])
    for _ in range(60):
        b = eng._brun.body(b)
    lib33 = k32_k33_check(torch, ops, "RR4 class, body 61", eng, b, record,
                          reps=5)
    del b
    k32, k33 = rows["emitted_expand_batched"][-1], \
        rows["fpset_insert_batched"][-1]
    print(f"phase 24b RR4 class (Nodes n1..n4, MaxLog 2, MaxTerm [4, 7], "
          f"width 4, chunk 16,384, fp 2^23 a lane): counts {counts} in one "
          f"dispatch of {bodies} bodies ({lane_bodies} lane bodies), the "
          f"MaxTerm 7 lane = the full run's, every lane = its sequential "
          f"run leaf for leaf and = its baked-constant check's counts; "
          f"walls in turns: batched {walls['batched']} s, the four "
          f"sequential runs {walls['sequential']} s; under torch.profiler: "
          f"wall {traced:.3f} s, device busy {busy:.3f} s "
          f"({busy / traced:.1%}), top {[(k[:40], round(v, 4)) for k, v in top]}; "
          f"K32 {k32['ms']:.4f} ms (plain {k32['plain_ms']:.1f} ms, bound "
          f"{k32['bound_ms']:.4f} ms by {k32['bound_by']}), K33 "
          f"({k33['shape']}) "
          f"{k33['ms']:.4f} ms (plain {k33['plain_ms']:.1f} ms, its sort "
          f"{lib33:.4f} ms); the dispatch's launches "
          f"{ {k: v for k, v in out['p24b_rr4_0']['launches'].items() if v} } "
          f"on {card}", flush=True)
    out["p24b_rr4"] = dict(walls=walls, busy=busy / traced, top=top)
    out["p24_library"] = {"fpset_insert_batched": lib33}
    return out


def phase_smoke24_real(torch, ops, card, runs, tmp):
    """Phase 24c: RR5T6 at 65,536 walkers, depth 100, fp 2^22, deadlock
    off, seeds 7-10 in one dispatch: lane 7 gives phase 20b's pinned counts, every
    lane is bit-equal (walk carry leaf for leaf) to the single-lane engine
    of its seed; then a seeds x configs batch over the RR4 MaxTerm class
    against its single-lane runs; K34 and K35 a round at 4 x 65,536
    walkers against their plain versions, timed."""
    from torchtlc.serve.sweep import config_inits, load_anchored
    from torchtlc.sim.engine import SimEngine, carry_to_reference
    from torchtlc.struct.loader import load

    cfgs = runs.get("p24_cfgs") or models24(tmp)
    rows = runs.setdefault("p24_rows", {})
    record = gen_recorder(rows)
    kw = dict(walkers=65536, depth=100, fp_capacity=1 << 22,
              check_deadlock=False, width=4)
    eng = SimEngine(load(cfgs["rr5t6"]), **kw)
    ops.struct_lib(eng.backend.kernels.prog)
    items = [(s, None) for s in RR5T6_SEEDS]
    ops.reset_counts()
    carries, wall = eng.run_carries(items)
    out = {"p24c_rr5t6": {"launches": dict(ops.LAUNCHES)}}
    res = [eng._result(c, wall, s) for c, s in zip(carries, RR5T6_SEEDS)]
    got = {k: getattr(res[0], k) for k in RR5T6_COUNTS}
    need(got == RR5T6_COUNTS, f"RR5T6 seed 7 lane: {got}")
    lanes = [carry_to_reference(c) for c in carries]
    del carries
    for k, s in enumerate(RR5T6_SEEDS):
        c = eng._run_fn(eng.carry_for(s))
        for a, b in zip(carry_to_reference(c), lanes[k]):
            need(a.shape == b.shape and (a == b).all(),
                 f"RR5T6 seed {s}: the lane differs from its single-lane run")
    # the walls in turns: one dispatch of the four seeds, the four
    # single-lane walks (execution only, each after its carry's init)
    walls = {"batched": [], "sequential": []}
    for _ in range(2):
        walls["batched"].append(round(eng.run_carries(items)[1], 4))
        walls["sequential"].append(round(sum(
            r.wall_s for r in eng.run_sequential(items)), 4))
    # seeds x configs over the RR4 MaxTerm class
    m4 = load_anchored(cfgs["rr4s"], RR4S_PARAMS)
    e4 = SimEngine(m4, params=RR4S_PARAMS, **kw)
    ops.struct_lib(e4.backend.kernels.prog)
    items4 = [(7, {"MaxTerm": 4}), (8, {"MaxTerm": 5}), (7, {"MaxTerm": 7}),
              (9, {"MaxTerm": 7})]
    ops.reset_counts()
    r4 = e4.run(items4)
    out["p24c_rr4"] = {"launches": dict(ops.LAUNCHES)}
    s4 = e4.run_sequential(items4)
    fields = ("steps", "generated", "transitions", "distinct", "violation",
              "depth_hist", "action_generated", "halted")
    for a, b in zip(r4, s4):
        need([getattr(a, f) for f in fields] == [getattr(b, f)
                                                 for f in fields],
             "RR4 seeds x configs: a lane differs from its single-lane run")
    inits = [eng.backend.initial_vectors()] * 4
    k34_k35_check(torch, ops, "RR5T6 smoke batch", eng.backend, eng._binit,
                  eng._brun, list(RR5T6_SEEDS), inits, 100, record,
                  rounds=10, reps=5)
    k34, k35 = rows["struct_sim_step_batched"][-1], rows["sim_fold_batched"][-1]
    print(f"phase 24c RR5T6 smoke batch (65,536 walkers, depth 100, fp "
          f"2^22, seeds {list(RR5T6_SEEDS)}; walls in turns: one dispatch "
          f"{walls['batched']} s, the four single-lane walks "
          f"{walls['sequential']} s): seed "
          f"7 lane = {RR5T6_COUNTS}, lanes {[(r.steps, r.generated, r.transitions, r.distinct) for r in res]}, "
          f"every lane = its single-lane run leaf for leaf; RR4 MaxTerm "
          f"class seeds x configs {[(r.steps, r.generated, r.distinct) for r in r4]} "
          f"= single-lane; a round at round 11: K34 {k34['ms']:.4f} ms "
          f"(plain {k34['plain_ms']:.1f} ms, bound {k34['bound_ms']:.5f} ms "
          f"by {k34['bound_by']}), K35 {k35['ms']:.4f} ms (plain "
          f"{k35['plain_ms']:.2f} ms) on {card}", flush=True)
    out["p24c"] = dict(walls=walls)
    return out


def phase_service24(torch, ops, card, runs, tmp, model):
    """Phase 24d: the service in-process on the card - the TwoPhaseB trio
    (one batched dispatch), a smoke job, a pooled job, an infer job, a
    large supervised job and a cached re-submit; a warm resubmit that
    meters 0 builds and 0 loads; an SSE stream to `final`; /metrics;
    priority preemption resumed through -recover to the uninterrupted
    run's counts; a running deadline, a running cancel, a 429; then `check
    ... -trace-out` and `-serve` on TwoPhase (transcripts and journal
    events pinned to the reference's CPU runs) and on Model_1 (counts, the
    trace's events, the monitor answering mid-run)."""
    import threading
    import urllib.request

    from torchtlc.obs import journal as obs_journal
    from torchtlc.serve import client
    from torchtlc.serve.pool import builds, loads
    from torchtlc.serve.server import start_server

    cfgs = runs.get("p24_cfgs") or models24(tmp)
    root = os.path.join(tmp, "p24", "serve")
    t0 = time.time()
    srv = start_server(root, sweep_width=3)
    out = {}
    try:
        url = srv.url
        tpb = TPB24_TLA
        cfg2 = TPB24_CFG
        cfg1 = cfg2.replace("MAXR = 2", "MAXR = 1")
        ops.reset_counts()
        ids = {v: client.submit(url, tpb, cfg2, name=f"tpb{v}",
                                constants={"MAXR": v}, sweep=SWEEP24,
                                options=OPTS24) for v in (0, 1, 2)}
        ids["smoke"] = client.submit(url, tpb, cfg2, name="smoke",
                                     options=dict(SIM24, simseed=1))
        ids["pool"] = client.submit(url, tpb, cfg2, name="pool",
                                    options=OPTS24)
        ids["infer"] = client.submit(url, tpb, cfg2, name="infer",
                                     options=dict(infer=True, inferbudget=16,
                                                  nodeadlock=True))
        ids["large"] = client.submit(url, tpb, cfg1, name="large",
                                     options=dict(OPTS24, fpcap=1 << 17,
                                                  noartifactcache=True))
        st = {k: client.wait(url, i, timeout=120) for k, i in ids.items()}
        out["p24d_jobs"] = {"launches": dict(ops.LAUNCHES)}
        for v in (0, 1, 2):
            r = st[v]["result"]
            need(st[v]["state"] == "done" and r["engine"] == "sweep"
                 and (r["generated"], r["distinct"], r["depth"],
                      r["action_generated"].get("Renege", 0))
                 == TPB24_COUNTS[v], f"service sweep job {v}: {st[v]}")
        need(st["smoke"]["result"]["engine"] == "sim"
             and st["smoke"]["result"]["sim"]["transitions"] > 0,
             f"service smoke job: {st['smoke']}")
        need(st["pool"]["result"]["engine"] == "pool"
             and st["pool"]["result"]["distinct"] == TPB24_COUNTS[2][1],
             f"service pooled job: {st['pool']}")
        need(st["infer"]["result"]["engine"] == "infer"
             and st["infer"]["result"]["infer"]["exact"],
             f"service infer job: {st['infer']}")
        need(st["large"]["result"]["engine"] == "supervised"
             and st["large"]["result"]["distinct"] == TPB24_COUNTS[1][1],
             f"service large job: {st['large']}")
        # warm resubmits: 0 builds, 0 library loads
        warm = {}
        for name, kw in (("pool", dict(options=OPTS24)),
                         ("sweep", dict(constants={"MAXR": 1},
                                        sweep=SWEEP24, options=OPTS24)),
                         ("smoke", dict(options=dict(SIM24, simseed=2)))):
            pre = builds(), loads()
            s = client.check(url, tpb, cfg2, name=f"warm-{name}",
                             timeout=300, **kw)
            warm[name] = (builds() - pre[0], loads() - pre[1])
            need(s["result"]["pool_hit"] is True and warm[name] == (0, 0),
                 f"warm {name} resubmit: {warm[name]} builds, loads")
        # the cached re-submit, through a temporary artifact store
        os.environ["TORCHTLC_ARTIFACT_CACHE"] = os.path.join(root, "arts")
        try:
            first = client.check(url, tpb, cfg1, name="cache-fresh",
                                 options=OPTS24, timeout=300)
            hit = client.check(url, tpb, cfg1, name="cache-hit",
                               options=OPTS24, timeout=300)
        finally:
            os.environ["TORCHTLC_ARTIFACT_CACHE"] = "off"
        need(first["result"]["engine"] == "pool"
             and hit["result"]["engine"] == "cache"
             and hit["result"]["distinct"] == first["result"]["distinct"],
             f"cached re-submit: {hit['result']}")
        events = list(client.stream(url, ids[1], timeout=120))
        need(events[0]["event"] == "run_start"
             and events[-1]["event"] == "final"
             and events[-1]["distinct"] == TPB24_COUNTS[1][1],
             "the job's SSE stream did not end at its final event")
        with urllib.request.urlopen(f"{url}/metrics?run={ids[1]}",
                                    timeout=60) as r:
            metrics = r.read().decode()
        need("jaxtlc_distinct_total 66" in metrics, "/metrics")
        # priority preemption, resumed through -recover
        ck = os.path.join(root, "ck")
        os.makedirs(ck, exist_ok=True)
        ref = client.check(url, CHAIN24_TLA, CHAIN24_CFG, name="chain-ref",
                           options=dict(CHAIN24_OPTS, checkpoint=os.path.join(
                               ck, "ref.npz")), timeout=300)
        low = {}
        for attempt in range(3):
            lo = client.submit(url, CHAIN24_TLA, CHAIN24_CFG,
                               name=f"lo{attempt}", options=dict(
                                   CHAIN24_OPTS, priority=0,
                                   checkpoint=os.path.join(
                                       ck, f"lo{attempt}.npz")))
            deadline = time.time() + 120
            while client.status(url, lo)["state"] == "queued":
                need(time.time() < deadline, "the low job never started")
                time.sleep(0.005)
            hi = client.submit(url, CHAIN24_TLA, CHAIN24_CFG,
                               name=f"hi{attempt}", options=dict(
                                   CHAIN24_OPTS, priority=10,
                                   checkpoint=os.path.join(
                                       ck, f"hi{attempt}.npz")))
            low = client.wait(url, lo, timeout=300)
            client.wait(url, hi, timeout=300)
            if low.get("requeues", 0) >= 1:
                break
        need(low.get("requeues", 0) >= 1 and low["state"] == "done"
             and all(low["result"][k] == ref["result"][k] for k in (
                 "generated", "distinct", "depth", "action_generated")),
             f"preemption: {low.get('requeues')} requeues, {low['result']}")
        dl = client.check(url, CHAIN24_TLA, CHAIN24_CFG, name="deadline",
                          options=dict(CHAIN24_OPTS, deadline_s=0.3,
                                       checkpoint=os.path.join(ck,
                                                               "dl.npz")),
                          timeout=300)
        need(dl["state"] == "expired" and dl["result"]["exit_code"] == 75,
             f"running deadline: {dl['state']}")
        cx = client.submit(url, CHAIN24_TLA, CHAIN24_CFG, name="cancel",
                           options=dict(CHAIN24_OPTS, checkpoint=os.path.join(
                               ck, "cx.npz")))
        while client.status(url, cx)["state"] == "queued":
            time.sleep(0.005)
        client.cancel(url, cx)
        cx = client.wait(url, cx, timeout=300)
        need(cx["state"] == "canceled", f"running cancel: {cx['state']}")
    finally:
        srv.shutdown()
    # admission: a server whose queue holds one job
    small = start_server(os.path.join(root, "small"), queue_bound=1)
    try:
        busy = client.submit(small.url, CHAIN24_TLA, CHAIN24_CFG,
                             name="busy", options=dict(
                                 CHAIN24_OPTS, checkpoint=os.path.join(
                                     root, "busy.npz")))
        while client.status(small.url, busy)["state"] == "queued":
            time.sleep(0.005)
        client.submit(small.url, CHAIN24_TLA, CHAIN24_CFG, name="queued",
                      options=dict(CHAIN24_OPTS, checkpoint=os.path.join(
                          root, "q.npz")))
        try:
            client._post(small.url + "/jobs", dict(
                spec=CHAIN24_TLA, cfg=CHAIN24_CFG, name="over"))
            rejected = None
        except client.ClientError as e:
            rejected = (e.code, e.retry_after)
        need(rejected is not None and rejected[0] == 429
             and rejected[1] >= 1, f"admission: {rejected}")
        small.scheduler.drain(timeout=300)
    finally:
        small.shutdown()
    svc_wall = time.time() - t0
    # the commands: -trace-out and -serve on TwoPhase and Model_1
    two = cfgs["two"]
    cmd = {}
    for tag in ("traceout", "serve"):
        d = os.path.join(tmp, "p24", f"cmd_{tag}")
        os.makedirs(d, exist_ok=True)
        journal = os.path.join(d, "run.journal.jsonl")
        trace = os.path.join(d, "t.json")
        extra = (["-trace-out", trace] if tag == "traceout"
                 else ["-serve", str(free_port())])
        rc, text, launches, wall = command_here(ops, [
            two, "-noTool", "-nodeadlock", "-no-artifact-cache", "-journal",
            journal] + extra)
        sha = hashlib.sha256(struct_masked(text.replace(trace, "TRACE"),
                                           two).encode()).hexdigest()
        kinds = [e["event"] for e in obs_journal.read(journal,
                                                      validate=False)]
        need((rc, sha, kinds) == TWO24_PINS[tag],
             f"TwoPhase -{tag}: exit {rc}, transcript or journal events "
             f"differ from the reference's ({kinds})")
        cmd[f"two_{tag}"] = (rc, wall)
        out[f"p24d_two_{tag}"] = {"launches": launches}
    d = os.path.join(tmp, "p24", "m1")
    os.makedirs(d, exist_ok=True)
    trace = os.path.join(d, "t.json")
    journal = os.path.join(d, "run.journal.jsonl")
    rc, text, launches, wall = command_here(
        ops, [model, "-noTool", "-trace-out", trace, "-journal", journal])
    with open(trace) as f:
        n_trace = len(json.load(f)["traceEvents"])
    exp = [e for e in obs_journal.read(journal, validate=False)
           if e["event"] == "trace_export"]
    need(rc == 0 and final_counts(text) == M1_COUNTS and len(exp) == 1
         and exp[0]["events"] == n_trace
         and f"Timeline trace written to {trace} ({n_trace} events"
         in text, f"Model_1 -trace-out: exit {rc}")
    cmd["m1_traceout"] = (rc, wall)
    out["p24d_m1_traceout"] = {"launches": launches}
    port = free_port()
    seen = []

    def scrape():
        deadline = time.time() + 120
        while time.time() < deadline and not seen:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                    seen.append(r.read().decode())
            except OSError:
                time.sleep(0.01)

    th = threading.Thread(target=scrape, daemon=True)
    th.start()
    rc, text, launches, wall = command_here(
        ops, [model, "-noTool", "-serve", str(port), "-journal",
              os.path.join(d, "serve.journal.jsonl")])
    th.join(timeout=130)
    need(rc == 0 and final_counts(text) == M1_COUNTS and seen
         and "jaxtlc_run_info" in seen[0],
         f"Model_1 -serve: exit {rc}, monitor answered {bool(seen)}")
    cmd["m1_serve"] = (rc, wall)
    out["p24d_m1_serve"] = {"launches": launches}
    print(f"phase 24d service on the card ({svc_wall:.1f} s): the TwoPhaseB "
          f"trio in batched dispatches, smoke, pooled, infer, supervised "
          f"large and cached jobs with the reference's counts; warm "
          f"resubmits (builds, loads) {warm}; SSE to final, /metrics; "
          f"priority preemption resumed through -recover to the "
          f"uninterrupted counts ({low['requeues']} requeue), a running "
          f"deadline expired, a running cancel, a 429; commands "
          f"{ {k: (v[0], round(v[1], 2)) for k, v in cmd.items()} } "
          f"(TwoPhase transcripts and journal events = the reference's, "
          f"Model_1 {M1_COUNTS} with {n_trace} trace events and the monitor "
          f"answering mid-run) on {card}", flush=True)
    return out


# phases 25-25c: pods (torchtlc.dist).  Model_1 on a 2-process pod of 2
# shards each at the sharded geometry of phase 12 with qcap 2^15; FF at
# the geometry of the reference's two-process test
# (tests/test_multihost.py:305-309)
POD_M1_KW = dict(chunk=2048, queue_capacity=1 << 15, fp_capacity=1 << 19)
POD_FF_ARGS = ["--ff", "--chunk", "128", "--queue-capacity", "4096",
               "--fp-capacity", "16384"]
POD_D, POD_H = 4, 2
# the pod runs of phases 25b and 25c through the library's entry points
# (init_pod, run_pod) in one pair of worker processes on this card - each
# process start costs an interpreter and torch's import, ~11 s on the
# card's machine.  "drills": after a preemption, the resume, a resume at
# another width refused, --reshard, a table too small, the spill lifeboat;
# "ffobs": FF with the counter ring and coverage; "scaled": scaled 2x1 (the
# command has Model_1 and FF only, as the reference's does)
POD_TASKS = r"""
import json, sys, time
import torch.distributed as dist
from torchtlc.config import ModelConfig, scaled_config
from torchtlc.dist.pod import init_pod, run_pod
from torchtlc.kernels import ops
port, rank, tasks = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
init_pod(f"127.0.0.1:{port}", 2, rank, collectives="gloo")
ff = ModelConfig(False, False)
geo = dict(chunk=128, queue_capacity=4096, fp_capacity=16384)


def counts(pr):
    r = pr.result
    return [pr.exit_code, r.generated, r.distinct, r.depth, r.violation]


out = {}
t0 = time.time()
if "drills" in tasks:
    base, other = tasks["drills"]
    pr = run_pod(ff, ckpt_path=base, resume=True, devices_per_host=2, **geo)
    out["resume"] = counts(pr) + [pr.resumed]
    try:
        run_pod(ff, ckpt_path=other, resume=True, devices_per_host=1, **geo)
        out["refused"] = ""
    except ValueError as e:
        out["refused"] = str(e)
    pr = run_pod(ff, ckpt_path=other, resume=True, reshard=True,
                 devices_per_host=1, **geo)
    out["reshard"] = counts(pr) + [pr.resharded]
    small = dict(geo, fp_capacity=2048, devices_per_host=1)
    out["full"] = counts(run_pod(ff, **small))
    t1 = time.time()
    pr = run_pod(ff, spill="on", spill_capacity=16384, **small)
    out["spill"] = counts(pr) + [pr.spilled, pr.spill_flushes]
    out["walls"] = dict(drills=round(t1 - t0, 1),
                        spill=round(time.time() - t1, 1))
if "ffobs" in tasks:
    t1 = time.time()
    pr = run_pod(ff, devices_per_host=2, obs_slots=128, coverage=True,
                 ckpt_path=tasks["ffobs"], ckpt_every=64, **geo)
    out["ffobs"] = counts(pr) + [pr.result.action_generated]
    out.setdefault("walls", {})["ffobs"] = round(time.time() - t1, 1)
if "scaled" in tasks:
    t1 = time.time()
    base, every, kw = tasks["scaled"]
    ops.reset_counts()
    pr = run_pod(scaled_config()[0], devices_per_host=2, ckpt_path=base,
                 ckpt_every=every, **kw)
    r = pr.result
    out["scaled"] = dict(
        counts=counts(pr), action_generated=r.action_generated,
        segments=pr.segments, collective_s=pr.timing,
        collectives=pr.collectives,
        launches={k: v for k, v in ops.LAUNCHES.items() if v})
    out.setdefault("walls", {})["scaled"] = round(time.time() - t1, 1)
dist.destroy_process_group()
out["host"] = rank
print("POD_RESULT " + json.dumps(out), flush=True)
"""


def pod_result(text):
    """The POD_RESULT object of a worker's output, or None."""
    for line in text.splitlines():
        if line.startswith("POD_RESULT "):
            return json.loads(line[len("POD_RESULT "):])
    return None


def pod_command(argv, timeout=600, sigterm_when=None):
    """`python -m torchtlc.dist --spawn 2 ...` as a subprocess (both workers
    on this card): (rc, output, POD_RESULT of worker 0, wall).  With
    sigterm_when (a path), SIGTERM goes to the launcher once the path
    exists."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.time()
    p = subprocess.Popen([sys.executable, "-m", "torchtlc.dist", "--spawn",
                          str(POD_H), *argv], cwd=here, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        if sigterm_when is not None:
            while not os.path.exists(sigterm_when) and p.poll() is None \
                    and time.time() - t0 < timeout:
                time.sleep(0.02)
            p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    text = out + err
    if p.returncode not in (0, 12, 75):
        print(text[-4000:], file=sys.stderr)
    return p.returncode, text, pod_result(out), time.time() - t0


def pod_worker_pair(script, args, timeout=900):
    """`script` (POD_TASKS) as the two processes of a pod on this card,
    each given a fresh port, its rank and `args`: (the two POD_RESULT
    objects, wall)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    port = str(free_port())
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, port, str(r), *args], cwd=here,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(POD_H)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            print(err[-4000:], file=sys.stderr)
        need(p.returncode == 0, f"a pod worker exited {p.returncode}")
    return [pod_result(out) for out, _ in outs], time.time() - t0


def pod_launches(ops, res):
    """A worker's launch counts over every kernel (its POD_RESULT names the
    ones it launched)."""
    return {k: int(res.get("launches", {}).get(k, 0)) for k in ops.KERNELS}


def pod_in_process(torch, ops, cfg, kw, D=POD_D):
    """The same engine in one process at D shards (make_sharded_engine):
    (carry, result, bodies)."""
    carry, r, _, bodies = run_sharded(torch, ops, cfg, D, kw)
    return carry, r, bodies


def pod_tables(base):
    """The full carry of a pod's per-host files (numpy leaves: the table
    words [D, cap/8, 16] uint32 among them)."""
    from torchtlc.dist.pod import load_pod_full

    _, full = load_pod_full(base)
    return full


def pod_kernel_checks(torch, ops, tag, cfg, kw, bodies, record, library):
    """K36, K37 and K38 against their plain versions on the buffers of a
    2-process pod at body `bodies` - the in-process engine's planes, split
    as the two processes hold them (the pod's words, as phases 25 and 25c
    show) - and timed; K37's owner planes equal the in-process engine's.
    Returns the K36 buffer of the whole engine (one process of D shards)
    and its planes, for the NCCL check."""
    import numpy as np

    from torchtlc.engine import sharded as ts

    D, H = POD_D, POD_H
    S = D // H
    init_fn, run_fn = ts.make_sharded_engine(cfg, ts.ShardMesh(D), **kw,
                                             segment=bodies)
    c = run_fn(init_fn())
    expand_half, _ = run_fn.halves
    ex = expand_half(c, ts.read_bundle(c))
    planes = tuple(t.clone() for t in (ex.xrows, ex.xlo, ex.xhi, ex.xvalid))
    B, F = planes[0].shape[2], planes[0].shape[3]
    n_valid = int(planes[3].sum())
    sends = []
    for p in range(H):
        mine = [t[:, p * S:(p + 1) * S].contiguous() for t in planes]
        got = ops.pod_exchange_pack(*mine)
        want = ts.pod_pack_plain(*mine)
        err = int((got.to(torch.int64) - want).abs().max())
        need(err == 0, f"K36 differs from its plain version ({tag})")
        sends.append(got.view(H, -1))
    lanes = D * S * B
    nbytes = lanes * (F * 4 + 9) + lanes * (F + 3) * 4
    v32 = mine[3].to(torch.int32)
    record("pod_exchange_pack", f"{tag}: [{D}, {S}, {B}, {F}+3]", 0,
           cuda_ms(torch, lambda _: ops.pod_exchange_pack(*mine), 20),
           cuda_ms(torch, lambda _: ts.pod_pack_plain(*mine), 20),
           *gen_bound_ms(nbytes, 0))
    library["pod_exchange_pack"] = cuda_ms(torch, lambda _: torch.cat(
        [mine[0], mine[1][..., None], mine[2][..., None], v32[..., None]],
        -1), 20)
    for q in range(H):
        recv = torch.stack([sends[p][q] for p in range(H)]).view(
            H, S, S, B, F + 3)
        got = ops.pod_exchange_unpack(recv)
        want = ts.pod_unpack_plain(recv)
        own = [t[q * S:(q + 1) * S] for t in planes]
        for g, w, o in zip(got, want, own):
            need(torch.equal(g, w), f"K37 differs from its plain version "
                 f"({tag})")
            need(torch.equal(g, o), f"K37's planes differ from the "
                 f"in-process engine's ({tag})")
    record("pod_exchange_unpack", f"{tag}: [{H}, {S}, {S}, {B}, {F}+3]", 0,
           cuda_ms(torch, lambda _: ops.pod_exchange_unpack(recv), 20),
           cuda_ms(torch, lambda _: ts.pod_unpack_plain(recv), 20),
           *gen_bound_ms(nbytes, 0))
    library["pod_exchange_unpack"] = cuda_ms(
        torch, lambda _: recv.transpose(0, 1).contiguous(), 20)
    # K38: process 0's statistic leaves, and the body's fence columns
    from torchtlc.dist.pod import _STAT_FIELDS

    leaves = [getattr(c, f)[:S].contiguous() for f in _STAT_FIELDS
              if getattr(c, f, None) is not None]
    fence = [c.qhead[:S], c.qtail[:S], c.level_end[:S], c.viol[:S],
             c.distinct[:S]]
    for what, ls in (("stats", leaves), ("fence", fence)):
        ls = [t.contiguous() for t in ls]
        got = ops.pod_stats_pack(ls)
        want = ts.pod_stats_plain(ls)
        need(torch.equal(got, want), f"K38 ({what}) differs from its plain "
             f"version ({tag})")
    W = ts.pod_stats_plain(leaves).shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in leaves) + S * W * 8
    record("pod_stats_pack", f"{tag}: {len(leaves)} leaves -> [{S}, {W}]", 0,
           cuda_ms(torch, lambda _: ops.pod_stats_pack(leaves), 20),
           cuda_ms(torch, lambda _: ts.pod_stats_plain(leaves), 20),
           *gen_bound_ms(nbytes, 0))
    whole = ops.pod_exchange_pack(*planes)
    del c, ex
    return whole, planes, n_valid


def nccl_one_rank(torch, ops, whole, planes):
    """The NCCL branch's calls on the card, in a one-rank group: K36's
    buffer of the whole engine through all_to_all_single, K37 on what came
    back (the in-process planes), a verdict plane, a K38 gather and the
    vote's all_reduce."""
    import torch.distributed as dist

    from torchtlc.engine import sharded as ts

    D, _, B, W = whole.shape
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = ts.ShardMesh(D, torch.device("cuda", 0), collectives="nccl")
        got = mesh._all_to_all(whole.view(1, -1))
        need(torch.equal(got.view(-1), whole.view(-1)),
             "the NCCL all_to_all changed the buffer")
        back = ops.pod_exchange_unpack(got.view(1, D, D, B, W))
        for g, w in zip(back, planes):
            need(torch.equal(g, w), "K37 after NCCL differs from the planes")
        verd = planes[3].to(torch.uint8).view(D, 1, D, B).transpose(0, 1)
        vgot = mesh._all_to_all(verd)
        need(torch.equal(vgot.view(D, D, B), planes[3].to(torch.uint8)),
             "the NCCL verdict all_to_all")
        words = ops.pod_stats_pack([torch.arange(D, device="cuda")])
        out = torch.empty_like(words)
        ts._all_gather(out, words, group=None)
        need(torch.equal(out, words), "the NCCL all_gather")
        flag = torch.ones(1, dtype=torch.int32, device="cuda")
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        need(int(flag.item()) == 1, "the NCCL all_reduce")
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()


def fold_pod_journals(base, hosts):
    """(folded level rows, folded coverage) of a pod's per-host journals."""
    from torchtlc.obs import journal as jr
    from torchtlc.obs.coverage import coverage_from_events
    from torchtlc.obs.views import fold_pod_levels, merge_journals

    events = merge_journals(*(jr.read(f"{base}.h{h}.journal.jsonl",
                                      validate=False)
                              for h in range(hosts)))
    levels = [e for e in fold_pod_levels(events)
              if e.get("event") == "level"]
    return levels, coverage_from_events(events), events


def phase_pod25(torch, ops, card, runs, tmp):
    """Phase 25: `python -m torchtlc.dist --spawn 2 --devices-per-host 2` on
    this card (both workers over gloo): Model_1 at chunk 2048 a shard (slab
    + deferred), qcap 2^15, fp 2^19 a shard - MC.out's counts and
    per-action generated counts, the in-process 4-shard engine's outdegree,
    per-action distinct counts and four table words; K36-K38 against their
    plain versions on the pod's buffers and timed; K36's and K37's buffers
    through a one-rank NCCL group."""
    import numpy as np

    from torchtlc.config import MODEL_1

    from torchtlc.kernels import build

    build.build()  # the workers' libraries, built once before they start
    rows, library = {}, {}
    record = gen_recorder(rows)
    base = os.path.join(tmp, "m1pod")
    rc, text, res, wall = pod_command([
        "--devices-per-host", "2", "--chunk", str(POD_M1_KW["chunk"]),
        "--queue-capacity", str(POD_M1_KW["queue_capacity"]),
        "--fp-capacity", str(POD_M1_KW["fp_capacity"]), "--ckpt", base,
        "--ckpt-every", "64"])
    need(rc == 0 and res is not None, f"the Model_1 pod exited {rc}")
    need(res["collectives"] == "gloo" and res["hosts"] == POD_H,
         f"the Model_1 pod ran {res['hosts']} hosts over "
         f"{res['collectives']}")
    got = (res["generated"], res["distinct"], res["depth"])
    need(got == M1_COUNTS, f"the Model_1 pod's counts {got}")
    need(res["action_generated"] == MC_OUT_GENERATED,
         "the Model_1 pod's per-action generated counts")
    carry, r4, bodies = pod_in_process(torch, ops, MODEL_1, POD_M1_KW)
    need((r4.generated, r4.distinct, r4.depth) == M1_COUNTS,
         "in-process Model_1 at 4 shards")
    need(tuple(res["outdegree"]) == tuple(float(v) for v in r4.outdegree),
         f"the Model_1 pod's outdegree {res['outdegree']}")
    need(res["action_distinct"] == r4.action_distinct,
         "the Model_1 pod's per-action distinct counts")
    full = pod_tables(base)
    here_words = carry.table.cpu().numpy().view(np.uint32)
    need(full.table.shape == here_words.shape
         and np.array_equal(full.table, here_words),
         "the Model_1 pod's shard tables differ from the in-process "
         "engine's")
    sha = hashlib.sha256(full.table.astype("<u4").tobytes()).hexdigest()
    del carry
    torch.cuda.empty_cache()
    whole, planes, n_valid = pod_kernel_checks(
        torch, ops, "Model_1 D4 body 60", MODEL_1, POD_M1_KW, 60, record,
        library)
    nccl_one_rank(torch, ops, whole, planes)
    del whole, planes
    k36, k37, k38 = (rows[k][-1] for k in (
        "pod_exchange_pack", "pod_exchange_unpack", "pod_stats_pack"))
    print(f"phase 25 pod: `python -m torchtlc.dist --spawn 2 "
          f"--devices-per-host 2` on one card over gloo - Model_1 "
          f"{M1_COUNTS} in {res['segments']} segments ({wall:.1f} s of "
          f"command, {res['wall_s']:.3f} s of run; in-process 4 shards "
          f"{r4.wall_s:.3f} s, {bodies} bodies; collectives "
          f"{res['collective_s']}), MC.out's per-action generated counts, "
          f"outdegree {res['outdegree']}, per-action distinct and the four "
          f"shard tables (sha256 {sha[:16]}) = the in-process engine's; "
          f"K36 {k36['ms']:.4f} ms (plain {k36['plain_ms']:.4f}, cat "
          f"{library['pod_exchange_pack']:.4f}, bound {k36['bound_ms']:.4f}"
          f"), K37 {k37['ms']:.4f} ms (plain {k37['plain_ms']:.4f}, "
          f"transpose {library['pod_exchange_unpack']:.4f}, bound "
          f"{k37['bound_ms']:.4f}), K38 {k38['ms']:.4f} ms (plain "
          f"{k38['plain_ms']:.4f}) at body 60 ({n_valid} valid lanes); the "
          f"NCCL branch on a one-rank group; launches (worker 0) "
          f"{res['launches']} on {card}", flush=True)
    return {"p25_m1": {"launches": pod_launches(ops, res)},
            "p25_rows": rows, "p25_library": library}


def phase_pod25bc(torch, ops, card, runs, tmp, drills, scaled):
    """Phases 25b (`drills`) and 25c (`scaled`), their library runs in one
    pair of worker processes (POD_TASKS).

    25b: the reference's drills on FF - SIGTERM through the launcher ->
    exit 75 with .h0 / .h1; then, in the pair, the resume of that snapshot
    to the counts, a resume of a copy at 1 shard a process refused with
    the --reshard hint, --reshard to the counts, a table too small -> exit
    12 (VIOL_FPSET_FULL), the spill lifeboat with spilled states; and FF
    with the counter ring and coverage, its two journals folded to 109
    level rows and a site table equal to the per-action counts.

    25c: scaled 2x1 on the 2 x 2 pod (SCALED_SHARDED_KW): the counts, the
    single-device run's per-action generated counts, the union of the four
    shard tables = the single-device table's fingerprint set; its wall in
    turns with the in-process 4-shard engine (in-process, pod,
    in-process); the collectives' share of the wall from the journals'
    segment rows, and the exchange a body; K36-K38 against their plain
    versions at this width."""
    from torchtlc.config import scaled_config

    t0 = time.time()
    tasks, out, cmd = {}, {}, []
    if drills:
        base = os.path.join(tmp, "drill")
        rc, text, res, w = pod_command(
            ["--devices-per-host", "2", *POD_FF_ARGS, "--ckpt", base,
             "--ckpt-every", "1"], sigterm_when=base + ".h1")
        cmd.append(round(w, 1))
        need(rc == 75 and res is not None and res["rc"] == 75,
             f"SIGTERM through the launcher: exit {rc}")
        need(os.path.exists(base + ".h0") and os.path.exists(base + ".h1"),
             "the preempted pod left no per-host files")
        stopped = (res["generated"], res["distinct"], res["depth"])
        need(stopped != FF_COUNTS, "the preempted pod had finished")
        other = os.path.join(tmp, "drill2")
        for h in range(POD_H):
            shutil.copy(f"{base}.h{h}", f"{other}.h{h}")
        ffbase = os.path.join(tmp, "ffpod")
        tasks.update(drills=[base, other], ffobs=ffbase)
    if scaled:
        cfg, kw1 = scaled_config()
        single, rs, _, _ = run_engine(torch, ops, cfg, kw1, {})
        ref_keys = _stored_keys(torch, single.fps.table)
        del single
        torch.cuda.empty_cache()
        carry, r4, bodies = pod_in_process(torch, ops, cfg, SCALED_SHARDED_KW)
        need((r4.generated, r4.distinct, r4.depth) == SCALED_COUNTS,
             "in-process scaled at 4 shards")
        walls = [("in-process", r4.wall_s)]
        del carry
        torch.cuda.empty_cache()
        sbase = os.path.join(tmp, "scaledpod")
        tasks["scaled"] = [sbase, bodies, SCALED_SHARDED_KW]
    outs, w = pod_worker_pair(POD_TASKS, [json.dumps(tasks)])
    cmd.append(round(w, 1))
    ff = list(FF_COUNTS)
    if drills:
        for o in outs:
            need(o["resume"] == [0, *ff, 0, True],
                 f"the resume: {o['resume']}")
            need("--reshard" in o["refused"],
                 f"a resume at another width: {o['refused']!r}")
            need(o["reshard"] == [0, *ff, 0, True],
                 f"--reshard: {o['reshard']}")
            need(o["full"][0] == 12 and o["full"][4] == 6,
                 f"a table too small: {o['full']}")
            need(o["spill"][:5] == [0, *ff, 0] and o["spill"][5] > 0,
                 f"the spill lifeboat: {o['spill']}")
            need(o["ffobs"][:5] == [0, *ff, 0], f"FF obs: {o['ffobs']}")
        levels, cov, _ = fold_pod_journals(ffbase, POD_H)
        need(len(levels) == FF_COUNTS[2], f"the FF pod's journals fold to "
             f"{len(levels)} level rows")
        need((levels[-1]["generated"], levels[-1]["distinct"])
             == FF_COUNTS[:2], "the FF pod's last folded level row")
        for name, g in outs[0]["ffobs"][5].items():
            need(cov["sites"].get(name, 0) == g,
                 f"the FF pod's coverage site {name}")
        spill = outs[0]["spill"]
        print(f"phase 25b drills on FF: SIGTERM through the launcher -> "
              f"exit 75 at {stopped} with .h0/.h1 -> resume {FF_COUNTS}; at "
              f"1 shard a process a plain resume refused with the --reshard "
              f"hint -> reshard {FF_COUNTS}; fp 2048 a shard -> exit 12 "
              f"(VIOL_FPSET_FULL) -> spill on {FF_COUNTS} with {spill[5]} "
              f"spilled in {spill[6]} flushes (host 0); FF with ring and "
              f"coverage {FF_COUNTS}, two journals fold to {len(levels)} "
              f"levels and the per-action sites; walls (launcher, library "
              f"pair) {cmd} s ({time.time() - t0:.1f} s in all; worker 0's "
              f"tasks {outs[0].get('walls')} s) on {card}",
              flush=True)
    if not scaled:
        return out
    res = [o["scaled"] for o in outs]
    for h, sres in enumerate(res):
        need(sres["counts"] == [0, *SCALED_COUNTS, 0],
             f"the scaled pod's counts on host {h}: {sres['counts']}")
        need(sres["action_generated"] == rs.action_generated,
             "the scaled pod's per-action generated counts")
        need(sres["segments"] == 1 and sres["collectives"] == "gloo",
             "the scaled pod's segments")
    _, _, events = fold_pod_journals(sbase, POD_H)
    segs = [e for e in events if e["event"] == "segment"]
    seg_wall = max(e["wall_s"] for e in segs)
    xch = {h: sum(e.get("exchange_us", 0) for e in segs
                  if e.get("host") == h) / 1e6 for h in range(POD_H)}
    gat = {h: sum(e.get("gather_us", 0) for e in segs
                  if e.get("host") == h) / 1e6 for h in range(POD_H)}
    walls.append(("pod", seg_wall))
    carry, r4b, _ = pod_in_process(torch, ops, cfg, SCALED_SHARDED_KW)
    walls.append(("in-process", r4b.wall_s))
    del carry
    torch.cuda.empty_cache()
    full = pod_tables(sbase)
    keys = []
    for d in range(POD_D):
        k = _stored_keys(torch, torch.from_numpy(
            full.table[d].view("int32")).cuda())
        need(bool(((k >> 32) & (POD_D - 1) == d).all()),
             f"a fingerprint off its owner shard {d}")
        keys.append(k)
    union = torch.sort(torch.cat(keys)).values
    need(union.shape == ref_keys.shape and bool((union == ref_keys).all()),
         "the scaled pod's tables differ from the single-device table's "
         "fingerprint set")
    del full, keys, union
    rows, library = {}, {}
    pod_kernel_checks(torch, ops, "scaled D4 body 140", cfg,
                      SCALED_SHARDED_KW, 140, gen_recorder(rows), library)
    torch.cuda.empty_cache()
    k36, k37, k38 = (rows[k][-1] for k in (
        "pod_exchange_pack", "pod_exchange_unpack", "pod_stats_pack"))
    B = route_bucket(SCALED_SHARDED_KW["chunk"], 12)
    sent = POD_D * (POD_D // POD_H) * B * (34 + 3) * 4
    share = {h: round((xch[h] + gat[h]) / seg_wall, 4) for h in xch}
    print(f"phase 25c scaled 2x1 on the 2 x 2 pod: {SCALED_COUNTS}, the "
          f"single-device per-action generated counts, every fingerprint on "
          f"its owner and the union of the 4 tables = the single-device "
          f"table ({ref_keys.shape[0]}); {bodies} bodies in one segment; "
          f"walls in turns {[(k, round(v, 4)) for k, v in walls]} s; each "
          f"process sends {sent / 2**20:.1f} MiB a body (half across the "
          f"boundary); exchange s {xch}, fence gathers s {gat}, the "
          f"collectives' share of the segment wall {share}; exchange a body "
          f"{ {h: round(xch[h] / bodies * 1e3, 2) for h in xch} } ms; "
          f"worker 0's collective seconds {res[0]['collective_s']}; at "
          f"body 140 K36 {k36['ms']:.4f} ms (plain {k36['plain_ms']:.4f}, "
          f"cat {library['pod_exchange_pack']:.4f}, bound "
          f"{k36['bound_ms']:.4f}), K37 {k37['ms']:.4f} ms (plain "
          f"{k37['plain_ms']:.4f}, transpose "
          f"{library['pod_exchange_unpack']:.4f}, bound "
          f"{k37['bound_ms']:.4f}), K38 {k38['ms']:.4f} ms (plain "
          f"{k38['plain_ms']:.4f}, bound {k38['bound_ms']:.6f}) on {card}",
          flush=True)
    out.update(p25c_scaled={"launches": pod_launches(ops, res[0])},
               p25c_rows=rows, p25c_library=library)
    return out


# ---------------------------------------------------------------------------
# the full run's background build
# ---------------------------------------------------------------------------

PREBUILD_NVCC = 2  # nvcc processes of the background build at a time


class BuildOnly:
    """The `ops` that the build helpers of phases 16-21, 23b, 24 and 26
    call, in the background build's process: each library is built into
    torchtlc/kernels/_build (nvcc, at most PREBUILD_NVCC at a time) and
    none is loaded; the phases then find them there by their texts."""

    def __init__(self):
        import threading

        self.sem = threading.Semaphore(PREBUILD_NVCC)

    def _build(self, text):
        from torchtlc.kernels.build import build_struct

        with self.sem:
            build_struct(text)

    def struct_lib(self, prog):
        self._build(prog.text)

    infer_lib = emitted_lib = struct_cov_lib = struct_lib

    def gen_sim_lib(self, prog):
        self._build(prog.sim_text)


def prebuild_main(tmp) -> int:
    """``chip_smoke.py --prebuild DIR``: the background build (the model
    files written to DIR), at the lowest priority; the helpers' build
    lines go to its log."""
    from torchtlc.struct.loader import load

    os.nice(19)
    t_start = time.time()
    ops = BuildOnly()
    for phase, build in (
            ("16", lambda: shard16_models(ops, tmp)),
            ("17", lambda: cov17_models(ops, tmp)),
            ("18", lambda: narrow18_backends(ops, tmp)),
            ("19", lambda: backends19(ops, tmp)),
            ("20", lambda: backends20(ops, tmp)),
            ("21", lambda: infer_programs21(
                ops, {k: load(c) for k, c in models21(tmp).items()})),
            ("23b", lambda: prebuild23(ops, models23(tmp))),
            ("24", lambda: prebuild24(ops, models24(tmp))),
            ("26", lambda: backends26(ops, tmp))):
        t0 = time.time()
        build()
        print(f"prebuild: phase {phase}'s libraries in {time.time() - t0:.1f}"
              f" s", flush=True)
    print(f"prebuild: done in {time.time() - t_start:.1f} s", flush=True)
    return 0


def start_prebuild():
    """Start the background build; it is stopped and its directory removed
    when the script exits.  Returns (process, log path, start time)."""
    d = tempfile.mkdtemp(prefix="chip_smoke_pre_")
    log_path = os.path.join(d, "prebuild.log")
    log = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--prebuild", d],
        stdout=log, stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log.close()
        shutil.rmtree(d, ignore_errors=True)

    atexit.register(stop)
    return proc, log_path, time.time()


def wait_prebuild(proc, log_path, t_start):
    """Wait for the background build and print its build lines: the
    phases after it find their libraries built (their own build lines then
    time the loads)."""
    t0 = time.time()
    rc = proc.wait()
    lines = open(log_path).read().splitlines()
    builds = [ln for ln in lines if "build" in ln]
    print(f"phase 19 background build (phases 16-21, 23b, 24, 26; "
          f"{PREBUILD_NVCC} nvcc at a time, started {t0 - t_start:.1f} s "
          f"before): rc {rc}, waited {time.time() - t0:.1f} s; "
          + " | ".join(builds) + (" | " + " | ".join(lines[-5:])
                                  if rc else ""), flush=True)


# ---------------------------------------------------------------------------
# phases 26-26c: the random walk over the KubeAPI and generic backends
# (kernels K39 kube_sim_step, K40 kube_sim_fold; K27 / K28 of the generic
# specs' walk texts)
# ---------------------------------------------------------------------------

# the small pins' geometry: every model walks SIM26_SEEDS at SIM26 with
# deadlock on; round-by-round kernel checks over SIM26_ROUNDS rounds
SIM26 = dict(walkers=4096, depth=64, fp_capacity=1 << 16)
SIM26_SEEDS = (0, 7)
SIM26_ROUNDS = 6
SIM26_KUBE = ("FF", "Model_1")
# the reference's final carries on the CPU (jaxtlc.sim.engine.
# make_sim_engine over jaxtlc's kubeapi_backend / gen_backend at SIM26,
# run_fn after jit(init_fn)(seed)): (steps, generated, transitions,
# distinct, violation, sim_sha)
SIM26_PINS = {
    'FF/0': (64, 545963, 262144, 3367, 0,
        '6f18e2f06fa273c830880fb51a32b573'
        '92cdbaecefd5b01523e1cdd686d34ef1'),
    'FF/7': (64, 545944, 262144, 3320, 0,
        '1db631ed5c10038e20d3af9624632abd'
        '1eb483bf6072f4e59252342b61ce97d5'),
    'Model_1/0': (64, 865392, 262144, 3937, 0,
        'ebeaaf2195aa63b23fb5900e256717c4'
        'd021742dd8718cd9dd4f28dab7763a34'),
    'Model_1/7': (64, 865210, 262144, 4019, 0,
        'e970173deb39d43bdf1b828d38bcb6b7'
        '8a55df19a82a09b35fc0f07cf49f50a4'),
    'RaftElection/0': (64, 343122, 262144, 491, 0,
        '1710eef82a46ec7356a8883a78ce6962'
        'c4cfb42e9e68ef9ca74e5cadb09805c6'),
    'RaftElection/7': (64, 343148, 262144, 491, 0,
        '6747eb56f4ae80bcfd4ed31752a1b034'
        'b215cff333422eafd46990e85855825e'),
    'Reconciler/0': (64, 302819, 262144, 81, 0,
        '95abe58e880d8dd0e4eea7de00d8e783'
        '90a9b52522639a7c2d78aa6b20baab51'),
    'Reconciler/7': (64, 303345, 262144, 81, 0,
        'e1eb112ccef9e85bfb9fab53887ea9f3'
        '6c618b36cce2e0d282046b72252a3a36'),
    'ServiceMesh/0': (64, 955995, 262144, 1444, 0,
        '716912eeeeac2294031090b049e19d96'
        '5b5841d6c12ce670aa1a5d7cf3a3742d'),
    'ServiceMesh/7': (64, 956495, 262144, 1444, 0,
        '2ec9dd040a1c767a4ad93e690d395f56'
        'b8f0bbd1e7b90a757cc5800b97831e6d'),
}
SIM26_VIOL_PINS = {
    'FF/delete_noop': dict(
        counts=(47, 402884, 192512, 2031, 3),
        sha=('70ad2597fa5659a226189d8233a8ca0a'
             'b9c87ba7fa291711b32d2b9144f8e44d'),
        lane=752, step=47, action=15,
        state=(63, 42, 2912, 2681, 9, 13, 40, 59, 15, 3, 21, 0, 114, 0, 0,
               0, 0, 0, 2, 0)),
    'Reconciler/never': dict(
        counts=(3, 31397, 12288, 10, 103),
        sha=('0c51bc16a1075ed9ed84aa022279cf69'
             'ea0bd5aa4447d2ccca15542ad2b10b60'),
        lane=4, step=3, action=3,
        state=(1, 1, 0, 0, 0, 0, 1)),
}
# full width: (walkers, depth, seed, fp capacity) and the reference's
# result on the CPU (jaxtlc.sim.engine.result_from_sim_carry's fields)
SIM26B = {"Model_1": (65536, 256, 7, 1 << 22),
          "scaled": (65536, 256, 7, 1 << 22),
          "R5": (65536, 100, 7, 1 << 22)}
SIM26B_PINS = {
    'scaled': dict(
        steps=256, generated=52567138, transitions=16777216,
        distinct=1709494, violation=0, halted=0,
        action_generated={'DoRequest': 2524203, 'DoReply': 2461215,
            'DoListRequest': 775487, 'DoListReply': 759903, 'CStart': 848958,
            'C1': 694367, 'C10': 686070, 'C11': 652910, 'c12': 644663,
            'C13': 611253, 'C2': 64667, 'C3': 118511, 'C8': 117719,
            'C6': 29240, 'C7': 27635, 'C4': 114883, 'C5': 177961,
            'PVCStart': 661756, 'PVCListedPVCs': 633402,
            'PVCHavePVCs': 468484, 'PVCDone': 443581, 'APIStart': 3260348},
        depth_hist=((256, 65536),)),
    'Model_1': dict(
        steps=256, generated=54888137, transitions=16777216,
        distinct=38762, violation=0, halted=0,
        action_generated={'DoRequest': 2140236, 'DoReply': 2118737,
            'DoListRequest': 1751611, 'DoListReply': 1734282,
            'CStart': 1772614, 'C1': 1696322, 'C10': 278509, 'C11': 271448,
            'c12': 44374, 'C13': 43200, 'C2': 113, 'C3': 33480, 'C8': 5566,
            'C6': 14, 'C7': 14, 'C4': 5555, 'C5': 5665, 'PVCStart': 1727998,
            'PVCListedPVCs': 1684108, 'PVCHavePVCs': 90857, 'PVCDone': 87224,
            'APIStart': 1285289},
        depth_hist=((256, 65536),)),
    'R5': dict(
        steps=100, generated=13918416, transitions=6553600,
        distinct=445506, violation=0, halted=0,
        action_generated={'Bump': 262144, 'Terminating': 4476243,
            'Wake': 605071, 'Observe': 605071, 'Apply': 605071},
        depth_hist=((100, 65536),)),
}
# phase 26c: the port's bench_sim (jaxtlc bench.py:1240-1300) - Model_1
# walked at 4,096 walkers to depth 256 against the BFS at chunk 1024
BENCH26C_SIM = dict(walkers=4096, depth=256, fp_capacity=1 << 20)
BENCH26C_BFS = dict(chunk=1024, queue_capacity=1 << 15, fp_capacity=1 << 20)


def backends26(ops, tmp):
    """The backends of phases 26-26c: KubeAPI's FF, Model_1, FF under
    delete_noop and the scaled 2x1 model; the generic RaftElection,
    Reconciler, ServiceMesh, the NeverObserves edit and Reconciler-5 -
    their walk libraries (K27 / K28 around each spec's step, gen_sim.cuh)
    built in parallel, one nvcc a text.  Returns (backends, the nvcc
    seconds)."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from torchtlc.config import MODEL_1, ModelConfig, scaled_config
    from torchtlc.engine.backend import gen_backend, kubeapi_backend
    from torchtlc.frontend.model import resolve

    here = os.path.dirname(os.path.abspath(__file__))
    never, r5 = write_gen_models(os.path.join(tmp, "p26"))
    ff = ModelConfig(False, False)
    out = {"FF": kubeapi_backend(ff), "Model_1": kubeapi_backend(MODEL_1),
           "FF/delete_noop": kubeapi_backend(
               dataclasses.replace(ff, mutation="delete_noop")),
           "scaled": kubeapi_backend(scaled_config()[0])}
    cfgs = {n: os.path.join(here, "specs", f"{n}.toolbox", "Model_1",
                            "MC.cfg") for n in GEN_NAMES}
    cfgs.update({"Reconciler/never": never, "R5": r5})
    for name, cfg in cfgs.items():
        out[name] = gen_backend(resolve(cfg, workers="gpu").genspec)
    progs = [out[n].kernels.prog for n in cfgs]
    t0 = time.time()
    with ThreadPoolExecutor(len(progs)) as pool:
        list(pool.map(ops.gen_sim_lib, progs))
    return out, time.time() - t0


def is_kube26(backend) -> bool:
    return backend.cfg is not None


def walk_kernels26(ops, backend):
    """(K_init, K_step, K_fold) of a backend's walk on the card - K39 /
    K40 for KubeAPI, the walk text's K27 / K28 for a generic spec - with
    the plain versions' signatures, and their LAUNCHES names."""
    prog = backend.kernels.prog
    if is_kube26(backend):
        return ((lambda *a: ops.kube_sim_init(prog, *a),
                 lambda *a: ops.kube_sim_step(prog, *a),
                 lambda *a: ops.kube_sim_fold(prog, *a)),
                ("kube_sim_step", "kube_sim_fold"))
    return ((lambda *a: ops.struct_sim_init(prog, *a),
             lambda *a: ops.struct_sim_step(prog, *a),
             lambda *a: ops.sim_fold(prog, *a)),
            ("gen_sim_step", "gen_sim_fold"))


def walk26(torch, ops, backend, walkers, depth, fp_capacity, seed):
    """One walk on the card through make_sim_engine's init_fn and run_fn
    (deadlock on), its launch counts reset just before and read just after:
    (carry, wall of run_fn, launches, engine)."""
    from torchtlc.sim.engine import make_sim_engine

    eng = make_sim_engine(backend, walkers, depth, fp_capacity=fp_capacity)
    ops.reset_counts()
    c = eng[0](seed)
    torch.cuda.synchronize()
    t0 = time.time()
    c = eng[1](c)
    torch.cuda.synchronize()
    return c, time.time() - t0, dict(ops.LAUNCHES), eng


def kube_lane_ops(prog) -> int:
    """K39's integer operations a live walker, counted low: the enabled
    test of each of the L lanes (its handler reads and writes the F
    fields once: 2 F), the chosen lane once more with the canonicalizing
    sorts (ni^2 compares of the API rows), three threefry2x32 (~80
    operations each), the invariants (~8 a field) and the pack (~4 a
    field)."""
    ni = prog.cdc.ni
    return (prog.L + 1) * 2 * prog.F + ni * ni + 3 * 80 + 12 * prog.F


def walk_bound26(backend, n_live, W):
    """(bound ms, bound_by) of one step-kernel round with n_live live
    walkers of W."""
    prog = backend.kernels.prog
    lane = kube_lane_ops(prog) if is_kube26(backend) else sim_lane_ops(prog)
    return gen_bound_ms(k27_bytes(prog, n_live, W), n_live * lane)


def walk_round_check26(torch, ops, tag, backend, c, depth, record=None,
                       reps=10):
    """The step kernel (K39, or the walk text's K27; with the packed rows)
    and then the fold kernel (K40 / K28) against their plain versions on
    copies of the carry `c` and of fresh buffers: states, alive,
    steps_taken, the scratch, the packed rows and take flags, the old
    rows and actions at every class lane; then every leaf of the carry,
    the go flag and the reset scratch after the fold.  Timed with
    `record` under the kernels' names.  Returns the violation code the
    fold set."""
    from torchtlc.sim.engine import (SIM_MIN, SIM_NONE, carry_to_reference,
                                     sim_buffers)

    prog = backend.kernels.prog
    (_, k_step, k_fold), (n_step, n_fold) = walk_kernels26(ops, backend)
    W = c.states.shape[0]
    dl = backend.check_deadlock
    base = sim_buffers(prog, W, "cuda", True)
    base.go.fill_(1)
    outs = []
    for kernel in (True, False):
        cc, bb = clone_carry(c), clone_buffers(base)
        (k_step if kernel else prog.sim_step_plain)(
            bb, cc.key, cc.step_i, cc.states, cc.alive, cc.steps_taken, dl)
        outs.append((cc, bb))
    (ck, bk), (cp, bp) = outs
    for name in ("states", "alive", "steps_taken"):
        need(torch.equal(getattr(ck, name), getattr(cp, name)),
             f"{n_step} {name} differs from its plain version ({tag})")
    for name in ("scratch", "packed", "take"):
        need(torch.equal(getattr(bk, name), getattr(bp, name)),
             f"{n_step} {name} differs from its plain version ({tag})")
    mins = bk.scratch[SIM_MIN:SIM_MIN + prog.n_inv + 3].tolist()
    for lane in {m for m in mins if m != SIM_NONE}:
        need(torch.equal(bk.vact[lane], bp.vact[lane])
             and torch.equal(bk.vold[lane], bp.vold[lane]),
             f"{n_step} lane {lane}'s saved row or action ({tag})")
    k_fold(bk, ck, depth)
    prog.sim_fold_plain(bp, cp, depth)
    for a, b in zip(carry_to_reference(ck), carry_to_reference(cp)):
        need(a.shape == b.shape and (a == b).all(),
             f"{n_fold} differs from its plain version ({tag})")
    need(torch.equal(bk.go, bp.go) and torch.equal(bk.scratch, bp.scratch),
         f"{n_fold} go / reset scratch differ from the plain version ({tag})")
    if record is not None:
        n_live = int(c.alive.sum())

        def setup():
            return clone_carry(c), clone_buffers(base)

        def step(a, fn=k_step):
            fn(a[1], a[0].key, a[0].step_i, a[0].states, a[0].alive,
               a[0].steps_taken, dl)

        def setup_fold():  # the fold's input: a carry the kernel stepped
            a = setup()
            step(a)
            return a

        record(n_step, tag, 0, cuda_ms(torch, step, reps, setup),
               cuda_ms(torch, lambda a: step(a, prog.sim_step_plain), 2,
                       setup),
               *walk_bound26(backend, n_live, W))
        S = bk.scratch.numel()
        record(n_fold, tag, 0,
               cuda_ms(torch, lambda a: k_fold(a[1], a[0], depth), reps,
                       setup_fold),
               cuda_ms(torch, lambda a: prog.sim_fold_plain(a[1], a[0],
                                                            depth), 2,
                       setup_fold),
               *gen_bound_ms(8 * S + 8 * prog.n_labels + 8 * prog.F + 64,
                             S + prog.n_labels + prog.F))
    return int(ck.viol)


def walk_init_check26(torch, ops, tag, backend, W, seed):
    """The step kernel's kInit form against its plain version: the chosen
    Init states, the scratch, the packed rows and take flags."""
    import numpy as np

    from torchtlc.sim import threefry
    from torchtlc.sim.engine import sim_buffers, u32_tensor

    prog = backend.kernels.prog
    (k_init, _, _), (n_step, _) = walk_kernels26(ops, backend)
    inits = torch.from_numpy(np.ascontiguousarray(np.asarray(
        backend.initial_vectors(), np.int32))).cuda()
    key = u32_tensor(threefry.prng_key(seed), "cuda")
    outs = []
    for kernel in (True, False):
        b = sim_buffers(prog, W, "cuda", True)
        st = torch.zeros(W, prog.F, dtype=torch.int32, device="cuda")
        (k_init if kernel else prog.sim_init_plain)(b, key, inits, st)
        outs.append((st, b))
    (sk, bk), (sp, bp) = outs
    need(torch.equal(sk, sp) and torch.equal(bk.scratch, bp.scratch)
         and torch.equal(bk.packed, bp.packed)
         and torch.equal(bk.take, bp.take),
         f"{n_step}'s kInit form differs from its plain version ({tag})")


def walk_pinned26(tag, leaves, pin):
    steps, gen, trans, distinct, viol, sha = pin
    got = (int(leaves[2]), int(leaves[5]), int(leaves[6]), int(leaves[14]),
           int(leaves[8]))
    need(got == (steps, gen, trans, distinct, viol),
         f"{tag}: (steps, generated, transitions, distinct, viol) {got}, "
         f"the reference's {(steps, gen, trans, distinct, viol)}")
    need(sim_sha(leaves) == sha,
         f"{tag}: the final carry differs from the reference's")


def replay_check26(torch, tag, backend, c, seed):
    """replay_lane on the card (K1's sharded variant and K7's, or K21 and
    K18, on a one-row queue a step) re-walks the violating lane of `c` to
    the same violation, step, action and state."""
    import numpy as np

    from torchtlc.engine.backend import VIOL_ASSERT
    from torchtlc.sim.replay import replay_lane

    viol, lane, step = int(c.viol), int(c.viol_lane), int(c.viol_step)
    walk = replay_lane(backend, seed, lane, step)
    state = c.viol_state.cpu().numpy()
    # the assertion reports the state the lane stood in, an invariant the
    # state it reached
    got = walk.fields[-2] if viol == VIOL_ASSERT else walk.fields[-1]
    act = backend.labels[int(c.viol_action)]
    need(walk.violation == viol and walk.violation_step == step
         and walk.labels[-1] == act and np.array_equal(got, state),
         f"{tag}: replay_lane on the card gives ({walk.violation}, "
         f"{walk.violation_step}, {walk.labels[-1]}), the walk ({viol}, "
         f"{step}, {act})")


def phase_sim26(torch, ops, card, runs, tmp):
    """Phase 26: the walk over the KubeAPI backend (K39 and K40 every
    round) and over the generic backend (the walk text's K27 and K28) on
    the card through make_sim_engine - FF and Model_1, RaftElection,
    Reconciler and ServiceMesh at 4,096 walkers to depth 64, seeds 0 and
    7, the sampling filter on: every final carry pinned to the reference's
    CPU run.  The kernels held against their plain versions on the kInit
    form and round by round on popped carries; FF under delete_noop (the
    assertion) and the NeverObserves edit (an invariant), each pinned
    (lane, step, action, state) and re-walked by replay_lane on the
    card."""
    from torchtlc.sim.engine import carry_to_reference

    backends, nvcc_s = backends26(ops, tmp)
    k39_ptxas = ptxas_entries(ops.load().logs.get("kube_sim", ""),
                              ("kube_sim",))
    gen_prog = backends["R5"].kernels.prog
    gen_sim = gen_prog.sim_text
    print(f"phase 26 build: K39 / K40 in kube_sim.cu (phase 1's build; "
          f"ptxas: {k39_ptxas}); {len(GEN_NAMES) + 2} generic walk "
          f"libraries (K27 / K28, gen_sim.cuh) in {nvcc_s:.1f} s; "
          f"Reconciler-5's walk text: "
          f"{ptxas_kernels(gen_prog, ('sim_step', 'sim_fold'), gen_sim)}",
          flush=True)
    rows = {}
    record = gen_recorder(rows)
    out, lines = {}, []
    W, D, cap = SIM26["walkers"], SIM26["depth"], SIM26["fp_capacity"]
    for name in SIM26_KUBE + GEN_NAMES:
        b = backends[name]
        _, (n_step, n_fold) = walk_kernels26(ops, b)
        for seed in SIM26_SEEDS:
            c, wall, launches, eng = walk26(torch, ops, b, W, D, cap, seed)
            leaves = carry_to_reference(c)
            walk_pinned26(f"{name} seed {seed}", leaves,
                          SIM26_PINS[f"{name}/{seed}"])
            need(launches[n_step] == launches[n_fold] > int(leaves[2])
                 and launches["struct_sim_step"] == 0,
                 f"{name}: walk launches {launches}")
            out[f"p26_{name}_{seed}"] = {"launches": launches}
            lines.append(f"{name}/{seed} {int(leaves[2])} steps, "
                         f"{int(leaves[6])} transitions ({wall:.3f} s)")
        walk_init_check26(torch, ops, name, b, W, 0)
        init_fn, _, step_fn = eng
        c = init_fn(0)
        for d in range(SIM26_ROUNDS):
            walk_round_check26(torch, ops, f"{name} round {d + 1}", b, c, D,
                               record if d == SIM26_ROUNDS - 1 else None)
            c = step_fn(c)
    checks = []
    for name, pin in SIM26_VIOL_PINS.items():
        b = backends[name]
        c, wall, launches, eng = walk26(torch, ops, b, W, D, cap, 0)
        leaves = carry_to_reference(c)
        walk_pinned26(name, leaves, pin["counts"] + (pin["sha"],))
        need((int(c.viol_lane), int(c.viol_step), int(c.viol_action))
             == (pin["lane"], pin["step"], pin["action"])
             and tuple(c.viol_state.tolist()) == pin["state"],
             f"{name}: violation lane / step / action / state")
        out[f"p26_{name}"] = {"launches": launches}
        replay_check26(torch, name, b, c, 0)
        # the violating round, kernels against plain versions
        init_fn, _, step_fn = eng
        v = init_fn(0)
        for _ in range(pin["step"] - 1):
            v = step_fn(v)
        got = walk_round_check26(torch, ops, f"{name} round {pin['step']}",
                                 b, v, D)
        need(got == pin["counts"][4],
             f"{name}: round {pin['step']} set violation {got}")
        checks.append(f"{name}: code {got} at lane {pin['lane']}, step "
                      f"{pin['step']}, action {b.labels[pin['action']]}, "
                      f"replayed")
    k39, k27 = rows["kube_sim_step"][-1], rows["gen_sim_step"][-1]
    print("phase 26 walks over KubeAPI and generic specs: every final "
          "carry = the reference's (digests pinned): " + "; ".join(lines)
          + "; K39 / K40 and the generic K27 / K28 = plain (kInit and "
          f"{SIM26_ROUNDS} rounds each); " + "; ".join(checks) + "; at "
          f"4,096 walkers round {SIM26_ROUNDS}: K39 {k39['ms']:.4f} ms "
          f"(ServiceMesh's K27 {k27['ms']:.4f} ms) on {card}", flush=True)
    out.update(p26_rows=rows, p26_backends=backends)
    return out


def phase_sim26_real(torch, ops, card, runs, tmp):
    """Phase 26b: the walks at full width - the scaled 2x1 KubeAPI model
    and Model_1 at 65,536 walkers to depth 256, Reconciler-5 to depth 100,
    seed 7, fp capacity 2^22: steps, generated, transitions, sampled
    distinct, action_generated and the depth histogram pinned to the
    reference's CPU run; the execution walls (two runs), transitions per
    second, the device's busy share (torch.profiler) and the step and fold
    kernels a round at round 11 against their plain versions, timed, with
    their bounds."""
    from torchtlc.sim.engine import result_from_sim_carry

    backends = runs.get("p26_backends") or backends26(ops, tmp)[0]
    rows = runs.setdefault("p26_rows", {})
    record = gen_recorder(rows)
    out, lines = {}, []
    for name, (W, D, seed, cap) in SIM26B.items():
        b = backends[name]
        pin = SIM26B_PINS[name]
        _, (n_step, n_fold) = walk_kernels26(ops, b)
        walls = []
        for i in range(2):
            c, wall, launches, eng = walk26(torch, ops, b, W, D, cap, seed)
            r = result_from_sim_carry(c, wall, b, W, D, seed)
            got = dict(steps=r.steps, generated=r.generated,
                       transitions=r.transitions, distinct=r.distinct,
                       violation=r.violation,
                       action_generated=r.action_generated,
                       depth_hist=r.depth_hist, halted=r.halted)
            need(got == pin, f"{name} at full width: {got}, the "
                 f"reference's {pin}")
            walls.append(round(wall, 4))
            out[f"p26b_{name}_{i}"] = {"launches": launches}
        _, traced, busy, by_name = device_busy(
            torch, lambda: eng[1](eng[0](seed)))
        k_s = sum(v for k, v in by_name.items() if "sim_step" in k)
        init_fn, _, step_fn = eng
        c = init_fn(seed)
        for _ in range(10):
            c = step_fn(c)
        walk_round_check26(torch, ops, f"{name} {W} walkers round 11", b, c,
                           D, record, reps=10)
        ks, kf = rows[n_step][-1], rows[n_fold][-1]
        lines.append(
            f"{name} (W {W}, depth {D}): {pin['steps']} rounds, "
            f"{pin['generated']:,} generated, {pin['transitions']:,} "
            f"transitions, {pin['distinct']:,} sampled distinct (the "
            f"reference's); walls {walls} s, "
            f"{pin['transitions'] / min(walls):,.0f} transitions/s; traced "
            f"{traced:.3f} s, busy {busy:.3f} s ({busy / traced:.1%}), "
            f"{n_step} {k_s:.3f} s; a round at round 11: {n_step} "
            f"{ks['ms']:.4f} ms (plain {ks['plain_ms']:.1f} ms, bound "
            f"{ks['bound_ms']:.5f} ms by {ks['bound_by']}), {n_fold} "
            f"{kf['ms']:.4f} ms")
        out[f"p26b_{name}"] = dict(walls=walls, busy=busy / traced,
                                   step_ms=ks["ms"], fold_ms=kf["ms"])
    print("phase 26b full-width walks: " + "; ".join(lines) + f" on {card}",
          flush=True)
    return out


def phase_bench26(torch, ops, card, runs):
    """Phase 26c: the port's bench_sim price sheet (jaxtlc bench.py:
    1240-1300): Model_1 walked at 4,096 walkers to depth 256 (fp 2^20, seed
    0) against the exhaustive BFS at chunk 1024 (qcap 2^15, fp 2^20, its
    default modes), interleaved best of 5; transitions/s over the BFS's
    distinct states/s.  A measurement, no claim: the two tiers answer
    different questions."""
    from torchtlc.config import MODEL_1
    from torchtlc.engine.backend import kubeapi_backend
    from torchtlc.engine.bfs import make_backend_engine, result_from_carry
    from torchtlc.sim.engine import make_sim_engine, result_from_sim_carry

    backend = kubeapi_backend(MODEL_1)
    s_init, s_run, _ = make_sim_engine(backend, **BENCH26C_SIM)
    b_init, b_run, _ = make_backend_engine(backend, **BENCH26C_BFS)
    sim_walls, bfs_walls = [], []
    for _ in range(5):
        c = s_init(0)
        torch.cuda.synchronize()
        t0 = time.time()
        c = s_run(c)
        torch.cuda.synchronize()
        sim_walls.append(time.time() - t0)
        bc = b_init()
        torch.cuda.synchronize()
        t0 = time.time()
        bc = b_run(bc)
        torch.cuda.synchronize()
        bfs_walls.append(time.time() - t0)
    r = result_from_sim_carry(c, min(sim_walls), backend,
                              BENCH26C_SIM["walkers"],
                              BENCH26C_SIM["depth"], 0)
    br = result_from_carry(bc, min(bfs_walls))
    need(r.violation == 0 and r.steps == BENCH26C_SIM["depth"],
         f"26c: the walk {r.violation}, {r.steps} rounds")
    need((br.generated, br.distinct, br.depth) == (577736, 163408, 124),
         f"26c: the BFS {(br.generated, br.distinct, br.depth)}")
    trans_s = r.transitions / min(sim_walls)
    bfs_s = br.distinct / min(bfs_walls)
    print(f"phase 26c bench_sim price sheet (Model_1): walk "
          f"{BENCH26C_SIM['walkers']} walkers x {BENCH26C_SIM['depth']} "
          f"rounds, {r.transitions:,} transitions, {r.distinct:,} sampled "
          f"distinct, best {min(sim_walls):.4f} s of "
          f"{[round(w, 4) for w in sim_walls]}: {trans_s:,.0f} "
          f"transitions/s; BFS chunk 1024 best {min(bfs_walls):.4f} s of "
          f"{[round(w, 4) for w in bfs_walls]}: {bfs_s:,.0f} distinct "
          f"states/s; ratio {trans_s / bfs_s:.3f} (a price sheet, no "
          f"claim) on {card}", flush=True)
    return {"p26c": dict(trans_s=trans_s, bfs_s=bfs_s,
                         ratio=trans_s / bfs_s)}


def route_bucket(chunk, lanes, D=POD_D, factor=2.0):
    from torchtlc.engine.sharded import route_bucket_width

    return route_bucket_width(chunk, lanes, D, factor)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    if "--prebuild" in sys.argv:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(prebuild_main(sys.argv[sys.argv.index("--prebuild") + 1]))
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
