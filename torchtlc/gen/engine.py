"""Exhaustive BFS engine for generic specs (port of jaxtlc/gen/engine.py).

The reference's design: ping-pong packed level buffers, the sort-
compacted dedup against the bucketized fingerprint table, the contiguous
enqueue, per-action statistics through the static lane -> action map.
One body, word for word the reference's (jaxtlc/gen/engine.py:120-251):

1. pop ``n = min(chunk, level_n - qhead)`` rows of the current level;
2. kernel K19 ``gen_expand`` (gen.program): unpack, the compiled lanes
   masked by the pop, every invariant on every valid candidate, pack,
   the per-action generated counts, and the fold of the verdict's
   candidates (lowest failing candidate per invariant, lowest
   overflowing candidate, lowest dead row);
3. fingerprints (kernel K2) over the gen codec's ``nbits``;
4. ``fpset_insert_sorted`` at probe and claim width ``R = min(2*chunk,
   chunk*L)`` (kernel K3 around the library sort), all inserts off when
   the gen engine's own fp-full rule ``distinct + chunk*L > 0.85*cap``
   holds;
5. the stable ``(~is_new, c_idx)`` order over every candidate and the
   A-wide enqueue segments clamped at ``qcap``, with ``act_dist`` by
   ``lane_action[e_idx % L]`` (kernel K4, given K19's lane actions and a
   scratch outdegree histogram the carry does not hold);
6. the verdict, first wins: the invariants in order (the state of the
   first failing flat candidate), slot overflow (its parent row), deadlock
   (the first dead row), fp full, queue full; then the level flip.

The reference runs the body in one ``lax.while_loop``; here a host loop
drives it and reads one bundle of scalars a body (new states, valid
candidates and K19's fold).  Every carry leaf - table words, queue words,
counters, ``act_gen``, ``act_dist``, ``viol``, ``viol_state`` - equals the
reference's after the run.  A body updates the table, queue and counter
tensors in place.  Runs on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..engine.backend import FLAG_VALID
from ..engine.bfs import (
    OK,
    VIOL_DEADLOCK,
    VIOL_FPSET_FULL,
    VIOL_QUEUE_FULL,
    VIOL_SLOT_OVERFLOW,
    VIOLATION_NAMES,
    CheckResult,
    commit_block,
    enqueue_order,
    resolve_device,
)
from ..engine.fingerprint import DEFAULT_FP_INDEX, fp64_words
from ..engine.fpset import FPSet, fpset_insert_sorted, fpset_new
from .ir import GenSpec
from .kernel import initial_field_vectors
from .program import GEN_NONE, GenKernels, GenProgram

VIOL_INVARIANT_BASE = 100  # violation code 100+k = k-th invariant


class GenCarry(NamedTuple):
    """The reference's GenCarry leaves; the scalars live on the host."""

    fps: FPSet
    queue: torch.Tensor  # [2, qcap + 2*chunk, W] int32
    parity: int
    qhead: int
    level_n: int
    next_n: int
    level: int
    depth: int
    generated: int
    distinct: int
    act_gen: torch.Tensor  # [n_actions] int64
    act_dist: torch.Tensor  # [n_actions] int64 (new states per action)
    viol: int
    viol_state: torch.Tensor  # [F] int32


def make_gen_engine(
    spec: GenSpec,
    chunk: int = 1024,
    queue_capacity: int = 1 << 15,
    fp_capacity: int = 1 << 20,
    fp_index: int = DEFAULT_FP_INDEX,
    check_deadlock: bool = True,
    device=None,
    prog: GenProgram = None,
):
    """(init_fn, run_fn, cdc, prog) of the gen engine on `device` (None =
    the card); run_fn.steps counts the bodies of its last call and
    run_fn.body is one body."""
    prog = prog or GenProgram(spec)
    kernels = GenKernels(prog)
    cdc = prog.cdc
    F = cdc.n_fields
    W = cdc.n_words
    L = prog.L
    nbits = cdc.nbits
    qcap = queue_capacity
    n_actions = len(spec.actions)
    n_inv = prog.n_inv
    dev = resolve_device(device)
    ncand = chunk * L
    R = min(2 * chunk, ncand)
    A = min(2 * chunk, ncand)
    fp_limit = int(fp_capacity * 0.85)
    # K4's outdegree histogram: the gen carry keeps none
    outdeg = torch.zeros(L + 2, dtype=torch.int64, device=dev)

    def init_fn() -> GenCarry:
        inits = torch.from_numpy(initial_field_vectors(spec, cdc))
        n0 = inits.shape[0]
        assert n0 <= chunk and n0 <= qcap
        packed0 = cdc.pack(inits).to(dev)
        queue = torch.zeros(2, qcap + 2 * chunk, W, dtype=torch.int32,
                            device=dev)
        queue[0, :n0] = packed0
        lo, hi = fp64_words(packed0, nbits, fp_index)
        fps = fpset_new(fp_capacity, dev)
        _, is_new_c, _, _ = fpset_insert_sorted(
            fps, lo, hi, torch.ones(n0, dtype=torch.bool, device=dev))
        # initial-state invariant check (the few Init rows, on the host)
        viol = OK
        viol_state = torch.zeros(F, dtype=torch.int32)
        bits = prog.inv_bits_plain(inits)
        for k in range(n_inv):
            bad = ((bits >> k) & 1) == 0
            if bool(bad.any()) and viol == OK:
                viol = VIOL_INVARIANT_BASE + k
                viol_state = inits[int(torch.argmax(bad.to(torch.uint8)))]
        return GenCarry(
            fps=fps, queue=queue, parity=0, qhead=0, level_n=n0, next_n=0,
            level=1, depth=1, generated=n0, distinct=int(is_new_c.sum()),
            act_gen=torch.zeros(n_actions, dtype=torch.int64, device=dev),
            act_dist=torch.zeros(n_actions, dtype=torch.int64, device=dev),
            viol=viol, viol_state=viol_state.to(torch.int32).to(dev))

    def body(c: GenCarry) -> GenCarry:
        n = min(chunk, c.level_n - c.qhead)
        block = c.queue[c.parity, c.qhead:c.qhead + chunk]
        packed, flags, action, gen, first = kernels.step(block, n,
                                                         check_deadlock)
        fvalid = flags[FLAG_VALID].bool()
        lo, hi = fp64_words(packed, nbits, fp_index)
        fp_full = c.distinct + ncand > fp_limit
        insert_mask = torch.zeros_like(fvalid) if fp_full else fvalid
        fps, is_new_c, c_idx, nreps = fpset_insert_sorted(
            c.fps, lo, hi, insert_mask, probe_width=R, claim_width=R)
        # the reference sorts (~is_new, c_idx) over every candidate
        e_idx, n_new = enqueue_order(is_new_c, c_idx, nreps, ncand)
        commit_block(c.queue, 1 - c.parity, c.next_n, qcap, e_idx, n_new,
                     packed, action, n, c.act_dist, outdeg, A, L, n_actions)
        c.act_gen.add_(gen)
        vals = torch.cat([torch.stack([n_new, fvalid.sum()]),
                          first.to(torch.int64)]).tolist()
        new, n_valid, fold = vals[0], vals[1], vals[2:]

        viol, viol_state = c.viol, c.viol_state
        for k in range(n_inv):
            if fold[k] != GEN_NONE and viol == OK:
                viol = VIOL_INVARIANT_BASE + k
                viol_state = cdc.unpack(packed[fold[k]])
        if fold[n_inv] != GEN_NONE and viol == OK:
            viol = VIOL_SLOT_OVERFLOW
            viol_state = cdc.unpack(block[fold[n_inv] // L])
        if fold[n_inv + 1] != GEN_NONE and viol == OK:
            viol = VIOL_DEADLOCK
            viol_state = cdc.unpack(block[fold[n_inv + 1]])
        if fp_full and n_valid and viol == OK:
            viol = VIOL_FPSET_FULL
        if c.next_n + new > qcap and viol == OK:
            viol = VIOL_QUEUE_FULL

        qhead = c.qhead + n
        next_n = min(c.next_n + new, qcap)
        level_done = qhead >= c.level_n
        advance = level_done and next_n > 0
        parity, level_n = c.parity, c.level_n
        if level_done:
            parity, level_n, next_n, qhead = 1 - c.parity, next_n, 0, 0
        level = c.level + 1 if advance else c.level
        return c._replace(
            fps=fps, parity=parity, qhead=qhead, level_n=level_n,
            next_n=next_n, level=level, depth=max(c.depth, level),
            generated=c.generated + n_valid, distinct=c.distinct + new,
            viol=viol, viol_state=viol_state)

    def cond(c: GenCarry) -> bool:
        return (c.qhead < c.level_n or c.next_n > 0) and c.viol == OK

    def run_fn(c: GenCarry) -> GenCarry:
        steps = 0
        while cond(c):
            c = body(c)
            steps += 1
        run_fn.steps = steps
        return c

    run_fn.steps = 0
    run_fn.body = body  # one body, for callers that step it themselves
    return init_fn, run_fn, cdc, prog


def violation_name(spec: GenSpec, code: int) -> str:
    if code >= VIOL_INVARIANT_BASE:
        names = list(spec.invariants.keys())
        k = code - VIOL_INVARIANT_BASE
        if k < len(names):
            return f"Invariant {names[k]} is violated"
        return "Invariant violated"
    return VIOLATION_NAMES[code]


def result_from_gen_carry(spec: GenSpec, out: GenCarry, wall: float,
                          iterations: int = -1) -> CheckResult:
    """The reference check_gen's CheckResult of a finished carry."""
    act_gen = out.act_gen.cpu().numpy()
    act_dist = out.act_dist.cpu().numpy()
    return CheckResult(
        generated=out.generated,
        distinct=out.distinct,
        depth=out.depth,
        queue_left=out.level_n - out.qhead + out.next_n,
        violation=out.viol,
        violation_name=violation_name(spec, out.viol),
        violation_state=out.viol_state.cpu().numpy(),
        violation_action=-1,
        action_generated={spec.actions[i].name: int(v)
                          for i, v in enumerate(act_gen) if v},
        action_distinct={spec.actions[i].name: int(v)
                         for i, v in enumerate(act_dist) if v},
        wall_s=wall,
        iterations=iterations,
    )


def check_gen(
    spec: GenSpec,
    chunk: int = 1024,
    queue_capacity: int = 1 << 15,
    fp_capacity: int = 1 << 20,
    fp_index: int = DEFAULT_FP_INDEX,
    check_deadlock: bool = True,
    device=None,
) -> CheckResult:
    """Exhaustive check of a generic spec on `device` (None = the card).
    wall_s times execution only: the program is compiled and its kernel
    built before the clock starts."""
    init_fn, run_fn, _, prog = make_gen_engine(
        spec, chunk, queue_capacity, fp_capacity, fp_index, check_deadlock,
        device)
    carry = init_fn()
    if carry.queue.is_cuda:
        from ..kernels import ops

        ops.gen_lib(prog)  # built before the clock
        torch.cuda.synchronize()
    t0 = time.time()
    out = run_fn(carry)
    if out.queue.is_cuda:
        torch.cuda.synchronize()
    return result_from_gen_carry(spec, out, time.time() - t0, run_fn.steps)
