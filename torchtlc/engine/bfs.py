"""Exhaustive single-device BFS engine (port of jaxtlc/engine/bfs.py:241-1105).

The frontier is a ping-pong pair of level buffers of packed states
(``[2, qcap + 2*chunk, W]`` int32).  One chunk step:

1. pops up to ``ck`` states contiguously from the current level;
2. expands them (kernel K1), fingerprints the candidates (kernel K2) and
   reduces the expand-stage violation (backend.make_expand_stage);
3. dedups and inserts the valid candidates into the fingerprint table
   (fpset.fpset_insert_dedup): the sorted path (kernel K3 around a
   library sort) or, in the sort-free mode, the slab path (kernels K5, K6
   and K3 around an R-wide library sort);
4. appends the new states, in candidate-lane order, to the next level and
   adds the per-action distinct counts and the outdegree histogram
   (``commit_block``: kernel K4);
5. in the deferred mode, checks the invariants of the fresh-insert
   claimants (backend.make_deferred_checker: kernel K7);
6. merges violations first-wins (carried > deferred invariant > expand
   stage > fp-full > queue-full) and flips the level when the current one
   is exhausted;
7. with ``obs_slots > 0``, writes the body's row of the counter ring
   (obs.counters.ring_row: kernel K8).

A backend with a runtime certificate (a narrowed struct backend,
``SpecBackend.cert_check``) carries the sticky ``cert_viol`` leaf: the
expand stage's certificate of the block's valid successors (K23 inside
K17) in the immediate mode, the deferred checker's of the fresh claimants
(K23 inside K18) in the deferred mode, ORed in every commit and written
to the ring's COL_CERT (jaxtlc/engine/bfs.py:602-610).  It feeds no
arbitration: counts and table words equal the uncertified run's.

A backend with the state-space reduction (``SpecBackend.reduce``, a
struct backend built with symmetry or POR) canonicalizes its Init seeds
(kernel K24) and carries, with a symmetry plan, the sticky ``sym_viol``
leaf - the expand stage's orbit check of each block (K25), ORed in every
commit and written to the ring's COL_SYM - and, under POR, the cumulative
``por_pruned`` count of the lanes K26 pruned (jaxtlc/engine/bfs.py:
155-168, 612-619); the pipelined carry stages both (``st_sym``,
``st_pruned``).  Canonicalization and pruning themselves run inside the
expand kernel, so every later stage sees reduced candidates.

With a coverage plane on the backend (``backend.kubeapi_backend(cfg,
coverage=True)``), the expand stage also counts the block's site
increments (kernel K10) and the commit folds them into the carry's
cumulative ``cov_counts`` - telemetry only, so every other result equals
the coverage-off run's.

In spill mode (``make_stage_pair(..., spill=True)``, driven by
engine.spill.SpillRuntime) the commit also takes a host ``veto`` mask -
candidates the host spill store already holds - that dedups like a
table hit, the fp-full halt is off (the host driver flushes the table
before it could fill), and the carry's ``spill_hits`` counts the vetoed
valid candidates (ring column 7).

``make_segment`` runs exactly ``ckpt_every`` step bodies - the
reference's ``lax.fori_loop(0, ckpt_every, step_fn)`` segment - each of
them the identity on a finished carry, so segment boundaries (and with
them checkpoints) fall where the reference's do.

Modes resolve as the reference's do (``resolve_sort_free``,
``resolve_deferred``): at chunk >= 2048 both the sort-free slab dedup and
the deferred invariants are on.

``pipeline=True`` runs the reference's two-deep pipelined body
(jaxtlc/engine/bfs.py:938-995): the carry stages one expanded block (the
``st_*`` leaves) and each body commits the staged block k-1, then stages
block k - expanded from the pre-commit carry, or at a level flip from the
post-commit carry.  It is the same two halves in another order on one
stream (no kernel of its own), single-tier at every chunk, and every
carry word equals the reference's pipelined carry at the same body.

The reference runs the step inside one ``lax.while_loop``; here a host
loop drives it, and reads one small bundle of scalars per step (the pop
cursor, level sizes, distinct count and verdict) for the two-tier choice
and the termination test.  The sort-free mode reads one more scalar per
step, the claimant count, for the fallback to the sorted path (the
reference decides it in a ``lax.cond`` on the device).  Every result -
counts, depth, per-action statistics, outdegree, fingerprint-table words,
queue words, ring words - equals the reference engine's at the same
geometry and modes.

A step updates the carry's table, queue and counter tensors IN PLACE (the
reference donates its carry the same way); keep a copy
(interop.carry_to_numpy) to compare carries.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelConfig
from ..obs.counters import ring_new, ring_row, rows_from_ring
from ..obs.coverage import site_totals_dict
from ..spec.labels import LABELS
from .backend import (
    FLAG_OVF,
    FLAG_VALID,
    OK,
    ExpandOut,
    VIOL_ASSERT,
    VIOL_DEADLOCK,
    VIOL_FPSET_FULL,
    VIOL_ONLYONEVERSION,
    VIOL_QUEUE_FULL,
    VIOL_ROUTE_OVERFLOW,
    VIOL_SLOT_OVERFLOW,
    VIOL_TYPEOK,
    kubeapi_backend,
    make_deferred_checker,
    make_expand_stage,
)
from .fingerprint import DEFAULT_FP_INDEX, fp64_words
from .fpset import (
    FPSet,
    fpset_actual_collision,
    fpset_insert_dedup,
    fpset_insert_sorted,
    fpset_new,
)

__all__ = [
    "OK", "VIOL_TYPEOK", "VIOL_ONLYONEVERSION", "VIOL_ASSERT", "VIOL_DEADLOCK",
    "VIOL_SLOT_OVERFLOW", "VIOL_FPSET_FULL", "VIOL_QUEUE_FULL",
    "VIOL_ROUTE_OVERFLOW",
    "VIOLATION_NAMES", "EngineCarry", "CheckResult", "make_engine",
    "make_backend_engine", "make_stage_pair", "check", "result_from_carry",
    "outdegree_from_hist", "commit_block", "commit_block_plain",
    "enqueue_order", "resolve_device", "resolve_sort_free",
    "resolve_deferred", "obs_rows", "make_segment", "carry_done",
    "clone_carry", "cov_totals", "staged_block", "EnumCarry",
    "make_enumerator", "resolve_symmetry", "resolve_por",
]

VIOLATION_NAMES = {
    OK: "none",
    VIOL_TYPEOK: "Invariant TypeOK is violated",
    VIOL_ONLYONEVERSION: "Invariant OnlyOneVersion is violated",
    VIOL_ASSERT: "Assertion failure (PlusCal assert)",
    VIOL_DEADLOCK: "Deadlock reached",
    VIOL_SLOT_OVERFLOW: "Codec slot overflow (raise ModelConfig bounds)",
    VIOL_FPSET_FULL: ("Fingerprint table full (auto-grow doubles it; "
                      "when device memory is exhausted the host spill "
                      "tier takes over - raise fp_capacity only to "
                      "avoid the regrow recompiles)"),
    VIOL_QUEUE_FULL: "Frontier queue full (raise queue_capacity)",
    VIOL_ROUTE_OVERFLOW: "Routing bucket overflow (raise route_factor)",
}

# fingerprint-table load at which a run halts with VIOL_FPSET_FULL rather
# than degrade into long straggler walks (the reference's default)
FP_HIGHWATER = 0.85
# the reference's auto thresholds for the sort-free and deferred modes
SORT_FREE_AUTO_CHUNK = 2048
DEFERRED_AUTO_CHUNK = 2048


class Bundle(NamedTuple):
    """Host copy of the carry scalars a step needs before it launches."""

    parity: int
    qhead: int
    level_n: int
    next_n: int
    distinct: int
    viol: int
    st_n: int = 0  # rows of the staged block (pipelined carries)


class EngineCarry(NamedTuple):
    fps: FPSet
    queue: torch.Tensor  # [2, qcap + 2*chunk, W] int32 packed level buffers
    parity: torch.Tensor  # which buffer holds the CURRENT level
    qhead: torch.Tensor  # pop position within the current level
    level_n: torch.Tensor  # states in the current level
    next_n: torch.Tensor  # states appended to the next level so far
    level: torch.Tensor  # BFS level of states being popped (init = 1)
    depth: torch.Tensor  # deepest nonempty level
    generated: torch.Tensor
    distinct: torch.Tensor
    act_gen: torch.Tensor  # [n_labels + 1] int64
    act_dist: torch.Tensor  # [n_labels + 1] int64
    outdeg_hist: torch.Tensor  # [L + 2] int64: popped states with d new children
    viol: torch.Tensor  # violation code
    viol_state: torch.Tensor  # [F] int32
    viol_action: torch.Tensor
    # scalars above as of the step that made this carry (None: read them)
    bundle: Bundle = None
    # observability counter ring (None when obs is off): one row per
    # completed level, non-flip bodies write the dump row (obs.counters)
    obs_ring: torch.Tensor = None  # [obs_slots + 1, cols] int32 words
    obs_head: torch.Tensor = None  # rows ever written
    obs_bodies: torch.Tensor = None  # engine bodies executed
    obs_expanded: torch.Tensor = None  # states popped so far
    # host spill tier (None when spill mode is off): candidates the host
    # fingerprint store vetoed so far (engine.spill)
    spill_hits: torch.Tensor = None
    # device coverage plane (None without one): [n_sites] int64 cumulative
    # per-site visits (their low 32 bits are the reference's uint32
    # counters), seeded with the Init-site visits
    cov_counts: torch.Tensor = None
    # the pipelined engine's staged block (None on unpipelined carries): the
    # expand-stage output of the last pop, committed by the next body.  The
    # popped rows themselves stay in the current level buffer at
    # queue[parity, qhead - st_n:], which no commit writes.
    st_packed: torch.Tensor = None  # [chunk*L, W] int32
    st_lo: torch.Tensor = None  # [chunk*L] int32
    st_hi: torch.Tensor = None  # [chunk*L] int32
    st_valid: torch.Tensor = None  # [chunk*L] bool
    st_action: torch.Tensor = None  # [chunk*L] int32
    st_gen: torch.Tensor = None  # [n_labels] int64
    st_n: torch.Tensor = None  # rows staged (0 = empty)
    st_viol: torch.Tensor = None  # expand-stage violation code
    # [W] int32: the expand-stage violating state PACKED (ExpandOut.
    # viol_words); interop unpacks it to the reference's [F] fields
    st_viol_state: torch.Tensor = None
    st_viol_action: torch.Tensor = None
    st_cov: torch.Tensor = None  # [n_sites] int32 words (coverage plane)
    # the staged block's popped rows as they stood before a regrow's
    # migration ([chunk, W] int32; None otherwise, and cleared by the next
    # body): a migrated queue keeps only the level's rows, and the
    # reference carries its pre-pack `st_flat` leaf over from the old
    # queue, so interop derives that leaf from these rows
    st_block: torch.Tensor = None
    # the staged block's pre-pack successor fields ([chunk*L, F] int32):
    # carried in the deferred mode over an emitted backend, whose deferred
    # check (K18) reads them at the commit; KubeAPI's K7 derives them
    # again from the staged rows, so its carries hold None here
    st_flat: torch.Tensor = None
    # the runtime certificate (None without a backend cert_check): sticky
    # 0-dim bool, some generated state violated a certified bound; and the
    # staged block's certificate (pipelined immediate-mode carries)
    cert_viol: torch.Tensor = None
    st_cert: torch.Tensor = None
    # the state-space reduction (None without backend.reduce): the sticky
    # orbit-certificate flag (0-dim bool, K25 every body; the ring's
    # COL_SYM) and the staged block's bit (pipelined carries); the
    # cumulative count of candidate lanes the POR ample sets pruned (0-dim
    # int64, whose low 32 bits are the reference's wrapping uint32) and
    # the staged block's count
    sym_viol: torch.Tensor = None
    st_sym: torch.Tensor = None
    por_pruned: torch.Tensor = None
    st_pruned: torch.Tensor = None


class CheckResult(NamedTuple):
    generated: int
    distinct: int
    depth: int
    queue_left: int
    violation: int
    violation_name: str
    violation_state: np.ndarray
    violation_action: int
    action_generated: dict
    action_distinct: dict
    wall_s: float
    iterations: int
    outdegree: tuple = None  # (avg, min, max, p95), MC.out:1104
    actual_fp_collision: float = None  # MC.out:42
    fp_occupancy: float = None  # distinct / fp_capacity
    site_coverage: dict = None  # {site key: visits}; None without coverage
    # the final fingerprint table ([cap/8, 16] uint32 words), when the
    # caller asked for it on a clean verdict (struct.engine.check_struct)
    fp_table: np.ndarray = None
    # the runtime certificate of a narrowed run: None = no certificate
    # carried; False = every generated state satisfied the certified
    # bounds; True = a claimed bound was violated (the run's counts are not
    # to be trusted)
    cert_violated: bool = None
    # the runtime orbit certificate of a symmetry-reduced run: None = no
    # symmetry plan; True = some body's orbit check failed (the run's
    # dedup is not to be trusted)
    sym_violated: bool = None
    # candidate lanes the POR ample sets pruned (uint32, wrapping as the
    # reference's); None without POR
    por_pruned: int = None


def resolve_device(device) -> torch.device:
    """None means the card; without one, only an explicit CPU request runs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain torch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def read_bundle(c: EngineCarry) -> Bundle:
    if c.bundle is not None:
        return c.bundle
    st_n = c.st_n if c.st_n is not None else c.qhead * 0
    vals = torch.stack([c.parity, c.qhead, c.level_n, c.next_n, c.distinct,
                        c.viol, st_n]).tolist()
    return Bundle(*vals)


def resolve_sort_free(sort_free, chunk: int) -> bool:
    """The tri-state sort-free flag (None = auto: on at chunk >= 2048)."""
    if sort_free is not None:
        return bool(sort_free)
    return chunk >= SORT_FREE_AUTO_CHUNK


def resolve_deferred(deferred, chunk: int) -> bool:
    """The tri-state deferred-invariant flag (None = auto: on at chunk >=
    2048)."""
    if deferred is not None:
        return bool(deferred)
    return chunk >= DEFERRED_AUTO_CHUNK


def resolve_symmetry(symmetry, chunk: int = 0) -> bool:
    """The tri-state -symmetry flag (None = auto: OFF - orbit dedup shrinks
    the distinct count, so it is opted into; `chunk` keeps the resolver
    shape of resolve_sort_free)."""
    if symmetry is not None:
        return bool(symmetry)
    return False


def resolve_por(por, chunk: int = 0) -> bool:
    """The tri-state -por flag (None = auto: OFF - ample-set pruning
    changes the explored counts, not the verdicts)."""
    if por is not None:
        return bool(por)
    return False


def staged_block(c: EngineCarry, h: Bundle, chunk: int) -> torch.Tensor:
    """The popped rows of a pipelined carry's staged block ([chunk, W]
    int32): a view of the current level buffer from st_n rows before the
    pop cursor, valid until the level flips twice because no commit writes
    the buffer being popped."""
    start = h.qhead - h.st_n
    return c.queue[h.parity, start:start + chunk]


def _running(h: Bundle) -> bool:
    return (h.qhead < h.level_n or h.next_n > 0 or h.st_n > 0) and (
        h.viol == OK)


def carry_done(c: EngineCarry) -> bool:
    """Host-side termination test: a violation, or both levels and the
    staged block empty."""
    return not _running(read_bundle(c))


# ---------------------------------------------------------------------------
# commit: enqueue order (library scans) + kernel K4
# ---------------------------------------------------------------------------


def enqueue_order(is_new_c: torch.Tensor, c_idx: torch.Tensor, nreps,
                  R: int, slab: bool = False):
    """The reference's enqueue order e_idx [ncand] (int64) and n_new.

    The reference sorts (not new, c_idx) stably over the first R rows of
    the insert's layout (all rows when R >= ncand or nreps > R) and pads
    with zeros: e_idx lists the new entries by candidate lane, then the
    other lanes of that window by lane, then - in the slab layout
    (`slab`) - one entry per padding row of the window, whose sentinel
    lane ncand the reference's gather clamps to ncand - 1, then zeros.
    Here that is a stable partition by prefix sums.  The tail rows matter:
    the enqueue copies whole A-wide segments, so they land past the
    level's end in the queue buffer, exactly as in the reference."""
    ncand = is_new_c.shape[0]
    dev = is_new_c.device
    lane_new = torch.zeros(ncand + 1, dtype=torch.bool, device=dev)
    lane_new[c_idx] = is_new_c  # the sentinel row's writes are all False
    lane_new = lane_new[:ncand]
    win = c_idx[:min(R, ncand)]
    if R >= ncand and not slab:
        tail = ~lane_new
    else:
        in_w = torch.zeros(ncand + 1, dtype=torch.bool, device=dev)
        in_w[win] = True
        tail = ~lane_new & in_w[:ncand]
        if R < ncand:  # nreps > R: the sorted layout, every lane present
            tail = tail | (~lane_new & (nreps > R))
    ni = lane_new.to(torch.int64)
    cn = torch.cumsum(ni, 0)
    n_new = cn[-1]
    ti = tail.to(torch.int64)
    ct = torch.cumsum(ti, 0)
    pos = torch.where(lane_new, cn - 1,
                      torch.where(tail, n_new + ct - 1, ncand))
    e_idx = torch.zeros(ncand + 1, dtype=torch.int64, device=dev)
    e_idx[pos] = torch.arange(ncand, device=dev)  # only position ncand repeats
    e_idx = e_idx[:ncand]
    if slab:
        first = n_new + ct[-1]
        n_sent = (win == ncand).sum()
        ar = torch.arange(ncand, device=dev)
        e_idx = torch.where((ar >= first) & (ar < first + n_sent), ncand - 1,
                            e_idx)
    return e_idx, n_new


def commit_block_plain(queue, dst: int, next_n: int, qcap: int, e_idx,
                       n_new, packed, action, n_pop: int, act_dist,
                       outdeg_hist, A: int, L: int, n_labels: int):
    """Torch version of kernel K4: append A-row segments of packed rows
    (gathered through e_idx) to level buffer `dst` at next_n + offs while
    offs < n_new, add per-action distinct counts of the n_new new entries,
    and add the outdegree histogram from run lengths of e_idx // L (bin 0
    gets the popped states with no new child).  In place."""
    ncand = e_idx.shape[0]
    nn = int(n_new)
    dev = e_idx.device
    e_p = torch.cat([e_idx, torch.zeros(A, dtype=e_idx.dtype, device=dev)])
    s = 0
    while s * A < nn:
        offs = s * A
        idx = e_p[offs:offs + A]
        woff = min(next_n + offs, qcap)
        queue[dst, woff:woff + A] = packed[idx]
        active = torch.arange(A, device=dev) + offs < nn
        acts = action[idx].to(torch.int64)
        act_dist[:n_labels] += torch.bincount(
            acts[active & (acts >= 0) & (acts < n_labels)],
            minlength=n_labels)[:n_labels]
        s += 1
    pos = torch.arange(ncand, device=dev)
    active_new = pos < nn
    src = torch.where(active_new, e_idx // L, -1)
    change = src[1:] != src[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    startf = torch.cat([one, change]) & active_new
    endf = torch.cat([change, one]) & active_new
    run0 = torch.cummax(torch.where(startf, pos, 0), 0).values
    run_len = (pos - run0 + 1)[endf]
    outdeg_hist[1:L + 1] += torch.bincount(run_len, minlength=L + 1)[1:L + 1]
    outdeg_hist[0] += n_pop - startf.sum()


def commit_block(queue, dst: int, next_n: int, qcap: int, e_idx, n_new,
                 packed, action, n_pop: int, act_dist, outdeg_hist, A: int,
                 L: int, n_labels: int):
    """Kernel K4 on CUDA tensors (n_new read on the device), the plain
    version on CPU tensors."""
    if not queue.is_cuda:
        return commit_block_plain(queue, dst, next_n, qcap, e_idx, n_new,
                                  packed, action, n_pop, act_dist,
                                  outdeg_hist, A, L, n_labels)
    from ..kernels import ops

    ops.commit(queue, dst, next_n, qcap, e_idx, n_new, packed, action, n_pop,
               act_dist, outdeg_hist, A, L, n_labels)


# ---------------------------------------------------------------------------
# the two halves of a step
# ---------------------------------------------------------------------------


def make_stage_pair(backend, ck: int, *, queue_capacity: int,
                    fp_capacity: int, sort_free: bool = False,
                    deferred: bool = False, obs_slots: int = 0,
                    spill: bool = False, fp_index: int = DEFAULT_FP_INDEX):
    """(pop_expand, commit) at pop width ck, in the RESOLVED modes:
    sort_free commits through the hash-slab dedup, deferred checks the
    invariants on the fresh-insert claimants, obs_slots > 0 writes the
    counter ring.  commit.slab_fallbacks counts the commits whose slab
    claimants exceeded R (the sorted fallback).  commit takes an insert's
    results (``ins``) when the caller ran it (the batched engine's K33),
    and with read=False returns (carry, its bundle tensor, ex) for the
    caller to read many bundles at once and finish with commit.settle.

    spill=True builds the spill-mode commit (jaxtlc/engine/bfs.py:
    434-447, 598-600, 639-649): it takes `veto` ([ck * L] bool, the
    candidates the host store holds), inserts valid & ~veto, never raises
    the fp-full halt, and adds the vetoed valid candidates to the carry's
    spill_hits."""
    cdc = backend.cdc
    L = backend.n_lanes
    n_labels = len(backend.labels)
    qcap = queue_capacity
    ncand = ck * L
    R = min(2 * ck, ncand)  # fpset probe width
    CW = min(2 * ck, R)  # fpset round-0 claim width
    A = min(2 * ck, ncand)  # enqueue segment width
    fp_limit = int(fp_capacity * FP_HIGHWATER)
    expand = make_expand_stage(backend, ck, deferred=deferred,
                               fp_index=fp_index)
    checker = make_deferred_checker(backend) if deferred else None

    def pop_expand(c: EngineCarry, h: Bundle):
        n = min(max(h.level_n - h.qhead, 0), ck)
        block = c.queue[h.parity, h.qhead:h.qhead + ck]
        return expand(block, n), n

    def insert_mask(ex, h: Bundle, veto=None):
        """(fp_full, the candidates the body inserts)."""
        if spill:
            # the host driver keeps the table below the high-water mark;
            # a host-vetoed candidate dedups like a table hit
            return False, ex.valid & ~veto
        # the body's own candidate width against the high-water mark
        fp_full = h.distinct + ncand > fp_limit
        return fp_full, (torch.zeros_like(ex.valid) if fp_full
                         else ex.valid)

    def commit(c: EngineCarry, ex, n: int, qhead_pop: int, qhead_out: int,
               h: Bundle, veto=None, ins=None, read=True):
        fp_full, mask = insert_mask(ex, h, veto)
        if ins is None:
            ins = fpset_insert_dedup(c.fps, ex.lo, ex.hi, mask,
                                     probe_width=R, claim_width=CW,
                                     sort_free=sort_free)
        fps, is_new_c, c_idx, nreps, fell_back = ins
        commit.slab_fallbacks += fell_back
        # the slab layout's claimants sit in the first R rows
        fresh_rows = R if sort_free and not fell_back else ncand
        e_idx, n_new = enqueue_order(is_new_c, c_idx, nreps, R,
                                     slab=sort_free)
        acts_old = (torch.cat([c.act_gen, c.act_dist]) if obs_slots
                    else None)
        cov_counts = c.cov_counts
        if ex.cov is not None and cov_counts is not None:
            # fold the block's site increments (uint32 words) into the
            # cumulative counters (telemetry only)
            cov_counts = cov_counts + (ex.cov.to(torch.int64) & 0xFFFFFFFF)
        commit_block(c.queue, 1 - h.parity, h.next_n, qcap, e_idx, n_new,
                     ex.packed, ex.action, n, c.act_dist, c.outdeg_hist, A, L,
                     n_labels)
        c.act_gen[:n_labels] += ex.gen
        generated = c.generated + ex.valid.sum()
        distinct = c.distinct + n_new

        # violations, first wins: carried > deferred invariant > expand
        # stage > capacity
        viol, viol_state = c.viol, c.viol_state
        viol_action = c.viol_action
        d_cert = None
        if checker is not None:
            d_viol, d_state, d_action, d_cert = checker(ex, is_new_c, c_idx,
                                                        fresh_rows)
            hit_d = (d_viol != OK) & (viol == OK)
            viol = torch.where(hit_d, d_viol, viol)
            viol_state = torch.where(hit_d, d_state, viol_state)
            viol_action = torch.where(hit_d, d_action, viol_action)
        hit_ex = (ex.viol != OK) & (viol == OK)
        viol = torch.where(hit_ex, ex.viol, viol)
        viol_action = torch.where(hit_ex, ex.viol_action, viol_action)
        if fp_full:
            viol = torch.where(ex.valid.any() & (viol == OK), VIOL_FPSET_FULL,
                               viol)
        viol = torch.where((h.next_n + n_new > qcap) & (viol == OK),
                           VIOL_QUEUE_FULL, viol)

        # level bookkeeping: ping-pong at the level boundary
        next_n = torch.clamp(c.next_n + n_new, max=qcap)
        level_done = qhead_pop >= h.level_n
        if level_done:
            parity, level_n, qhead = 1 - c.parity, next_n, c.qhead * 0
            level = torch.where(next_n > 0, c.level + 1, c.level)
            next_n = next_n * 0
        else:
            parity, level_n, level = c.parity, c.level_n, c.level
            qhead = c.qhead + (qhead_out - h.qhead)
        depth = torch.maximum(c.depth, level)
        spill_hits = c.spill_hits
        if spill:
            spill_hits = c.spill_hits + (veto & ex.valid).sum()
        cert_viol = c.cert_viol
        cert_src = d_cert if deferred else ex.cert
        if cert_src is not None and cert_viol is not None:
            # sticky: once a block's certificate fired, every later carry
            # and ring row carries the flag
            cert_viol = cert_viol | cert_src
        sym_viol, por_pruned = c.sym_viol, c.por_pruned
        if ex.sym is not None and sym_viol is not None:
            # the orbit check (K25) latches the same way; it ran at the
            # expand on canonical fields, so the deferred mode has no
            # commit-side variant
            sym_viol = sym_viol | ex.sym
        if ex.pruned is not None and por_pruned is not None:
            por_pruned = por_pruned + ex.pruned
        if obs_slots:
            # one telemetry row per body (post-commit cumulative counters;
            # non-flip bodies write the dump row)
            ring_row(c.obs_ring, c.obs_head, c.obs_bodies, c.obs_expanded, n,
                     level_done, c.level, generated, c.generated, distinct,
                     c.distinct, level_n, c.act_gen, c.act_dist, acts_old,
                     n_labels, spill_hits if spill else None,
                     c.spill_hits if spill else None,
                     cov_counts if ex.cov is not None else None,
                     c.cov_counts if ex.cov is not None else None,
                     cert=cert_viol, sym=sym_viol)

        vals_t = torch.stack([parity, qhead, level_n, next_n, distinct,
                              viol, hit_ex.to(torch.int64)])
        c = c._replace(
            fps=fps, parity=parity, qhead=qhead, level_n=level_n,
            next_n=next_n, level=level, depth=depth, generated=generated,
            distinct=distinct, viol=viol, viol_state=viol_state,
            viol_action=viol_action, spill_hits=spill_hits,
            cov_counts=cov_counts, cert_viol=cert_viol, sym_viol=sym_viol,
            por_pruned=por_pruned)
        if not read:
            # the caller reads the bundles of many commits at once
            # (engine.batched) and finishes each with settle()
            return c, vals_t, ex
        return settle(c, vals_t.tolist(), ex)

    def settle(c: EngineCarry, vals, ex) -> EngineCarry:
        """The carry with its host bundle; a hit of the expand stage's
        violation unpacks its state on the host."""
        if vals[6]:
            row = ex.viol_words.cpu()[None]
            c = c._replace(viol_state=cdc.unpack(row)[0].to(
                c.viol_state.device))
        return c._replace(bundle=Bundle(*vals[:6]))

    commit.slab_fallbacks = 0
    commit.insert_mask = insert_mask
    commit.settle = settle
    commit.widths = (R, CW)
    pop_expand.expand = expand
    return pop_expand, commit


# ---------------------------------------------------------------------------
# engine factory
# ---------------------------------------------------------------------------


def _resolve_modes(chunk, sort_free, deferred, pipeline):
    """The reference's mode resolution: (sort_free, deferred) as resolved
    bools, the same for the pipelined and the unpipelined body."""
    return resolve_sort_free(sort_free, chunk), resolve_deferred(deferred,
                                                                 chunk)


def make_backend_engine(
    backend,
    chunk: int = 1024,
    queue_capacity: int = 1 << 15,
    fp_capacity: int = 1 << 20,
    pipeline: bool = False,
    obs_slots: int = 0,
    sort_free: bool = None,
    deferred: bool = None,
    device=None,
    fp_index: int = DEFAULT_FP_INDEX,
):
    """Build (init_fn, run_fn, step_fn) over a SpecBackend.

    init_fn() -> EngineCarry seeded with the Init states.
    run_fn(carry) -> EngineCarry after exhaustion or a violation.
    step_fn(carry) -> EngineCarry after ONE chunk step (unchanged when the
    run is over).

    Two-tier stepping as in the reference: at chunk >= 2^14, a level
    remainder below chunk // 2 is popped by a small body of chunk // 16.
    pipeline=True builds the pipelined body instead (the module
    docstring), single-tier as the reference's: its staged block has one
    width.

    sort_free and deferred are tri-state (None = auto, on at chunk >=
    2048, as the reference resolves them) and apply to both body widths;
    obs_slots > 0 carries the counter ring (obs.counters); a backend with
    a coverage plane carries ``cov_counts``.  After a run,
    run_fn.steps counts its bodies, run_fn.steps_by_width maps each body
    width to its bodies and run_fn.slab_fallbacks each width to its
    sorted fallbacks (cumulative over the engine's life); run_fn.pick(h)
    returns the unpipelined body's (width, (pop_expand, commit)) for the
    bundle h, the choice obs.phases.PhasedRuntime fences around."""
    sort_free, deferred = _resolve_modes(chunk, sort_free, deferred, pipeline)
    dev = resolve_device(device)
    cdc = backend.cdc
    F = cdc.n_fields
    W = cdc.n_words
    L = backend.n_lanes
    n_labels = len(backend.labels)
    qcap = queue_capacity
    small = chunk // 16 if chunk >= 1 << 14 and not pipeline else 0
    kw = dict(queue_capacity=qcap, fp_capacity=fp_capacity,
              sort_free=sort_free, deferred=deferred, obs_slots=obs_slots,
              fp_index=fp_index)
    big_stages = make_stage_pair(backend, chunk, **kw)
    small_stages = make_stage_pair(backend, small, **kw) if small else None
    widths = {chunk: big_stages} | ({small: small_stages} if small else {})
    # a pipelined deferred carry over an emitted backend stages the raw
    # successors its deferred check (K18) reads at the commit
    stage_flat = pipeline and deferred and backend.cfg is None
    # a pipelined immediate-mode carry stages its block's certificate; the
    # deferred checker derives it at the commit from st_flat
    has_cert = backend.cert_check is not None
    stage_cert = pipeline and has_cert and not deferred
    # the state-space reduction: the plan and the POR rights decide the
    # carry leaves, as the expand route decides ExpandOut.sym / .pruned
    red = backend.reduce
    has_sym = red is not None and red.plan is not None
    has_por = red is not None and red.por_on

    def i64(v):
        return torch.full((), v, dtype=torch.int64, device=dev)

    def init_fn(inits=None) -> EngineCarry:
        # Init is encoded, packed and invariant-checked on the host
        if inits is None:
            inits = backend.initial_vectors()
        inits = torch.as_tensor(np.asarray(inits, dtype=np.int32))
        if has_sym:
            # orbit-representative seeds (K24 on the card): Init is closed
            # under the verified permutations, so no orbit is lost
            inits = backend.kernels.canon(inits.to(dev)).cpu()
        n0 = inits.shape[0]
        assert n0 <= chunk and n0 <= qcap, "raise chunk/queue_capacity"
        packed0 = cdc.pack(inits)
        queue = torch.zeros(2, qcap + 2 * chunk, W, dtype=torch.int32,
                            device=dev)
        queue[0, :n0] = packed0.to(dev)
        lo, hi = fp64_words(packed0.to(dev), cdc.nbits, fp_index)
        fps, is_new_c, _, _ = fpset_insert_sorted(
            fpset_new(fp_capacity, dev), lo, hi,
            torch.ones(n0, dtype=torch.bool, device=dev))
        inv0 = backend.inv_check(inits)
        viol, viol_state = OK, torch.zeros(F, dtype=torch.int32)
        for k, code in enumerate(backend.inv_codes):
            bad = (inv0 & (1 << k)) == 0
            if viol == OK and bool(bad.any()):
                viol = code
                viol_state = inits[int(torch.argmax(bad.to(torch.uint8)))]
        extra = {}
        if obs_slots:
            ring, head = ring_new(obs_slots, n_labels, dev)
            extra = dict(obs_ring=ring, obs_head=head, obs_bodies=i64(0),
                         obs_expanded=i64(0))
        if backend.coverage is not None:
            # the coverage counters start at the Init-site visits
            extra["cov_counts"] = torch.from_numpy(
                backend.coverage.seed(inits.numpy()).astype(np.int64)).to(dev)
        if pipeline:
            # an empty staged block: the first body commits nothing
            ncand = chunk * L

            def zeros(*shape, dtype=torch.int32):
                return torch.zeros(*shape, dtype=dtype, device=dev)

            extra.update(
                st_packed=zeros(ncand, W), st_lo=zeros(ncand),
                st_hi=zeros(ncand), st_valid=zeros(ncand, dtype=torch.bool),
                st_action=zeros(ncand),
                st_gen=zeros(n_labels, dtype=torch.int64), st_n=i64(0),
                st_viol=i64(OK), st_viol_state=zeros(W),
                st_viol_action=i64(-1))
            if backend.coverage is not None:
                extra["st_cov"] = zeros(backend.coverage.n_sites)
            if stage_flat:
                extra["st_flat"] = zeros(ncand, F)
            if stage_cert:
                extra["st_cert"] = torch.zeros((), dtype=torch.bool,
                                               device=dev)
            if has_sym:
                extra["st_sym"] = torch.zeros((), dtype=torch.bool,
                                              device=dev)
            if has_por:
                extra["st_pruned"] = i64(0)
        if has_cert:
            extra["cert_viol"] = torch.zeros((), dtype=torch.bool,
                                             device=dev)
        if has_sym:
            extra["sym_viol"] = torch.zeros((), dtype=torch.bool, device=dev)
        if has_por:
            extra["por_pruned"] = i64(0)
        return EngineCarry(
            fps=fps, queue=queue, parity=i64(0), qhead=i64(0),
            level_n=i64(n0), next_n=i64(0), level=i64(1), depth=i64(1),
            generated=i64(n0), distinct=is_new_c.sum(),
            act_gen=torch.zeros(n_labels + 1, dtype=torch.int64, device=dev),
            act_dist=torch.zeros(n_labels + 1, dtype=torch.int64, device=dev),
            outdeg_hist=torch.zeros(L + 2, dtype=torch.int64, device=dev),
            viol=i64(viol), viol_state=viol_state.to(dev), viol_action=i64(-1),
            **extra,
        )

    def pick(h: Bundle):
        # (width, stage pair) of the next unpipelined body; break-even:
        # the big body only when the level remainder mostly fills it
        width = chunk
        if small and h.level_n - h.qhead < chunk // 2:
            width = small
        return width, widths[width]

    def fused_body(c: EngineCarry, h: Bundle) -> EngineCarry:
        width, (pop_expand, commit) = pick(h)
        run_fn.steps_by_width[width] += 1
        ex, n = pop_expand(c, h)
        return commit(c, ex, n, h.qhead + n, h.qhead + n, h)

    def staged_ex(c: EngineCarry, h: Bundle) -> ExpandOut:
        # block: the staged rows the deferred checker reads
        return ExpandOut(
            packed=c.st_packed, lo=c.st_lo, hi=c.st_hi, valid=c.st_valid,
            action=c.st_action, gen=c.st_gen, viol=c.st_viol,
            viol_words=c.st_viol_state, viol_action=c.st_viol_action,
            block=staged_block(c, h, chunk), cov=c.st_cov, flat=c.st_flat,
            cert=c.st_cert, sym=c.st_sym, pruned=c.st_pruned)

    def with_staged(c: EngineCarry, ex: ExpandOut, n: int) -> EngineCarry:
        # rebinds the expand stage's outputs, which are fresh tensors of
        # this body (no copy), and advances the pop cursor past them
        h = c.bundle
        return c._replace(
            qhead=c.qhead + n, st_packed=ex.packed, st_lo=ex.lo,
            st_hi=ex.hi, st_valid=ex.valid, st_action=ex.action,
            st_gen=ex.gen, st_n=i64(n), st_viol=ex.viol,
            st_viol_state=ex.viol_words, st_viol_action=ex.viol_action,
            st_cov=ex.cov, st_flat=ex.flat if stage_flat else None,
            st_cert=ex.cert if stage_cert else None, st_block=None,
            st_sym=ex.sym if has_sym else None,
            st_pruned=ex.pruned if has_por else None,
            bundle=h._replace(qhead=h.qhead + n, st_n=n))

    def pipelined_body(c: EngineCarry, h: Bundle) -> EngineCarry:
        # commit the staged block k-1 and stage block k.  At a level flip
        # (the staged block was the level's last pop) block k comes from
        # the post-commit carry, the freshly flipped level.  Otherwise it
        # comes from the pre-commit carry: the expansion reads only rows
        # of the current level buffer, and the commit writes in place
        # only the other buffer (K4) and counters the expansion does not
        # read, so expanding first is the reference's expand_pre.
        pop_expand, commit = big_stages
        run_fn.steps_by_width[chunk] += 1
        will_flip = h.qhead >= h.level_n
        if not will_flip:
            ex, n = pop_expand(c, h)
        c2 = commit(c, staged_ex(c, h), h.st_n, h.qhead, h.qhead, h)
        if will_flip:
            ex, n = pop_expand(c2, c2.bundle)
        return with_staged(c2, ex, n)

    body = pipelined_body if pipeline else fused_body

    def step_fn(c: EngineCarry) -> EngineCarry:
        h = read_bundle(c)
        return body(c, h) if _running(h) else c._replace(bundle=h)

    def run_fn(c: EngineCarry) -> EngineCarry:
        steps = 0
        h = read_bundle(c)
        while _running(h):
            c = body(c, h)
            h = c.bundle
            steps += 1
        run_fn.steps = steps
        run_fn.slab_fallbacks = {w: st[1].slab_fallbacks
                                 for w, st in widths.items()}
        return c

    run_fn.steps = 0
    run_fn.steps_by_width = {w: 0 for w in widths}
    run_fn.slab_fallbacks = {w: 0 for w in widths}
    run_fn.pick = pick
    return init_fn, run_fn, step_fn


def clone_carry(c):
    """A copy of every tensor of a carry - an EngineCarry or the sharded
    engine's ShardCarry (the engines step in place; the supervisor keeps
    its last good carry intact this way)."""
    return type(c)(**{
        k: (FPSet(v.table.clone()) if isinstance(v, FPSet)
            else v.clone() if isinstance(v, torch.Tensor) else v)
        for k, v in c._asdict().items()})


def make_segment(step_fn, ckpt_every: int):
    """seg(carry) -> the carry after exactly ckpt_every step bodies (the
    reference's lax.fori_loop(0, ckpt_every, step_fn)); a body on a
    finished carry leaves it as it is, so the loop stops early with the
    same result."""

    def seg(c: EngineCarry) -> EngineCarry:
        for _ in range(ckpt_every):
            if carry_done(c):
                break
            c = step_fn(c)
        return c

    return seg


def make_engine(cfg: ModelConfig, chunk: int = 1024,
                queue_capacity: int = 1 << 15, fp_capacity: int = 1 << 20,
                pipeline: bool = False, obs_slots: int = 0,
                coverage: bool = False, sort_free: bool = None,
                deferred: bool = None, device=None,
                fp_index: int = DEFAULT_FP_INDEX):
    """(init_fn, run_fn, step_fn) for one KubeAPI configuration;
    coverage=True carries the device coverage plane."""
    return make_backend_engine(
        kubeapi_backend(cfg, coverage=coverage), chunk, queue_capacity,
        fp_capacity, pipeline=pipeline, obs_slots=obs_slots,
        sort_free=sort_free, deferred=deferred, device=device,
        fp_index=fp_index)


def check(cfg: ModelConfig, chunk: int = 1024, queue_capacity: int = 1 << 15,
          fp_capacity: int = 1 << 20, pipeline: bool = False,
          obs_slots: int = 0, coverage: bool = False,
          sort_free: bool = None, deferred: bool = None,
          device=None, fp_index: int = DEFAULT_FP_INDEX) -> CheckResult:
    """Run an exhaustive check on `device` (None = the card).  wall_s
    times the run only: the kernels are built and loaded before it.  With
    coverage=True the result's site_coverage holds the plane's totals."""
    backend = kubeapi_backend(cfg, coverage=coverage)
    init_fn, run_fn, _ = make_backend_engine(
        backend, chunk, queue_capacity, fp_capacity, pipeline=pipeline,
        obs_slots=obs_slots, sort_free=sort_free, deferred=deferred,
        device=device, fp_index=fp_index)
    carry = init_fn()
    if carry.queue.is_cuda:
        torch.cuda.synchronize()
    t0 = time.time()
    carry = run_fn(carry)
    if carry.queue.is_cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    sites = backend.coverage.sites if backend.coverage else None
    return result_from_carry(
        carry, wall, iterations=run_fn.steps, fp_capacity=fp_capacity,
        sites=sites,
    )._replace(actual_fp_collision=fpset_actual_collision(carry.fps))


def obs_rows(carry, labels: tuple = None, since: int = 0,
             fp_capacity: int = 0):
    """Decode the carry's counter ring into journal-`level`-event dicts
    (oldest first) plus the new head cursor; ([], since) when obs is
    off (the reference's obs_rows, jaxtlc/engine/bfs.py:1089)."""
    if getattr(carry, "obs_ring", None) is None:
        return [], int(since)
    head = int(carry.obs_head)
    return (rows_from_ring(carry.obs_ring.cpu().numpy(), head, labels=labels,
                           since=since, fp_capacity=fp_capacity), head)


def outdegree_from_hist(hist: np.ndarray):
    """(avg, min, max, p95) of TLC's outdegree from a new-children
    histogram; None if empty (MC.out:1104's convention)."""
    hist = np.asarray(hist, dtype=np.int64)
    total = hist.sum()
    if total == 0:
        return None
    degs = np.arange(len(hist))
    nz = np.flatnonzero(hist)
    cum = np.cumsum(hist)
    p95 = int(degs[np.searchsorted(cum, 0.95 * total)])
    return (
        int(round((degs * hist).sum() / total)),
        int(nz[0]),
        int(nz[-1]),
        p95,
    )


def cov_totals(carry) -> "np.ndarray | None":
    """Cumulative per-site coverage counters of a carry ([n_sites] int64
    host array of the reference's uint32 values; a ShardCarry's [D,
    n_sites] partials summed, as the reference sums them), or None when no
    coverage plane rides the carry."""
    counts = getattr(carry, "cov_counts", None)
    if counts is None:
        return None
    counts = counts.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    return counts.sum(axis=0) if counts.ndim == 2 else counts


def result_from_carry(carry: EngineCarry, wall_s: float, iterations: int = -1,
                      fp_capacity: int = 0, labels: tuple = LABELS,
                      sites: tuple = None,
                      viol_names: dict = None) -> CheckResult:
    """Pull a finished (or interrupted) carry to the host; `sites` (the
    coverage plane's table) keys site_coverage; `viol_names` (the
    backend's) override VIOLATION_NAMES."""
    act_gen = carry.act_gen.cpu().numpy()[: len(labels)]
    act_dist = carry.act_dist.cpu().numpy()[: len(labels)]
    hist = carry.outdeg_hist.cpu().numpy()[:-1]  # drop the dump row
    viol = int(carry.viol)
    totals = cov_totals(carry)
    cert = getattr(carry, "cert_viol", None)
    sym = getattr(carry, "sym_viol", None)
    pruned = getattr(carry, "por_pruned", None)
    if pruned is not None:
        # a ShardCarry holds per-shard partials
        pruned = int(pruned.sum()) & 0xFFFFFFFF
    return CheckResult(
        generated=int(carry.generated),
        distinct=int(carry.distinct),
        depth=int(carry.depth),
        # a staged block counts as still queued
        queue_left=(int(carry.level_n) - int(carry.qhead)
                    + int(carry.next_n)
                    + (int(carry.st_n) if carry.st_n is not None else 0)),
        violation=viol,
        violation_name=((viol_names or {}).get(viol)
                        or VIOLATION_NAMES.get(viol, f"violation {viol}")),
        violation_state=carry.viol_state.cpu().numpy(),
        violation_action=int(carry.viol_action),
        action_generated={labels[i]: int(v) for i, v in enumerate(act_gen) if v},
        action_distinct={labels[i]: int(v) for i, v in enumerate(act_dist) if v},
        wall_s=wall_s,
        iterations=iterations,
        outdegree=outdegree_from_hist(hist),
        fp_occupancy=int(carry.distinct) / fp_capacity if fp_capacity else None,
        site_coverage=(None if totals is None or sites is None
                       else site_totals_dict(sites, totals)),
        cert_violated=None if cert is None else bool(cert),
        sym_violated=None if sym is None else bool(sym),
        por_pruned=pruned,
    )


# ---------------------------------------------------------------------------
# the append-only state enumerator (liveness capture, pass 1)
# ---------------------------------------------------------------------------


class EnumCarry(NamedTuple):
    """Carry of the state enumerator (jaxtlc/engine/bfs.py:1108).  `states`
    is APPEND-ONLY: a state's row is its permanent id (BFS append order),
    the ids the liveness edge capture (live.capture) speaks of.  Rows past
    `tail` are padding left by the A-wide appends."""

    fps: FPSet
    states: torch.Tensor  # [cap + A, W] int32 packed states, id = row
    head: int  # next id to expand
    tail: int  # distinct states stored
    viol: int  # OK or a capacity / overflow code


def make_enumerator(backend, chunk: int = 1024,
                    state_capacity: int = 1 << 20,
                    fp_capacity: int = 1 << 20,
                    fp_index: int = DEFAULT_FP_INDEX,
                    fp_highwater: float = FP_HIGHWATER, device=None):
    """(init_fn, run_fn) of the distinct-state enumerator
    (jaxtlc/engine/bfs.py:1128 make_enumerator, without its optional ring).

    A body pops up to `chunk` rows at `head` from the states array itself,
    expands them through the backend's expand route (kernel K1 for
    KubeAPI, K19 for a generic spec), fingerprints the candidates (K2),
    inserts them with the sorted path at probe and claim width R =
    min(2*chunk, ncand) (K3), and appends the new rows at `tail` in
    candidate-lane order in A-wide segments (K4, its queue being the
    states array and its counters scratch).  It halts with VIOL_SLOT_OVERFLOW, VIOL_FPSET_FULL
    (the body's candidate width over the high-water mark) or
    VIOL_QUEUE_FULL (more than `state_capacity` states), as the reference
    does.  run_fn.steps counts the bodies of its last call."""
    cdc = backend.cdc
    L = backend.n_lanes
    n_labels = len(backend.labels)
    cap = state_capacity
    ncand = chunk * L
    R = min(2 * chunk, ncand)
    A = R
    fp_limit = int(fp_capacity * fp_highwater)
    dev = resolve_device(device)
    # K4's counters, not read: the enumerator keeps no statistics
    scratch = (torch.zeros(n_labels, dtype=torch.int64, device=dev),
               torch.zeros(L + 2, dtype=torch.int64, device=dev))

    def init_fn() -> EnumCarry:
        inits = torch.from_numpy(np.asarray(backend.initial_vectors(),
                                            np.int32))
        n0 = inits.shape[0]
        assert n0 <= chunk and n0 <= cap, "raise chunk/state_capacity"
        packed0 = cdc.pack(inits).to(dev)
        states = torch.zeros(cap + A, cdc.n_words, dtype=torch.int32,
                             device=dev)
        states[:n0] = packed0
        lo, hi = fp64_words(packed0, cdc.nbits, fp_index)
        fps = fpset_new(fp_capacity, dev)
        fpset_insert_sorted(fps, lo, hi, torch.ones(n0, dtype=torch.bool,
                                                    device=dev))
        return EnumCarry(fps=fps, states=states, head=0, tail=n0, viol=OK)

    def body(c: EnumCarry) -> EnumCarry:
        n = min(chunk, c.tail - c.head)
        block = c.states[c.head:c.head + chunk]
        packed, flags, action = backend.kernels.expand(block, n,
                                                       deferred=True)[:3]
        fvalid = flags[FLAG_VALID].bool()
        lo, hi = fp64_words(packed, cdc.nbits, fp_index)
        fp_full = c.tail + ncand > fp_limit
        mask = torch.zeros_like(fvalid) if fp_full else fvalid
        fps, is_new_c, c_idx, nreps = fpset_insert_sorted(
            c.fps, lo, hi, mask, probe_width=R, claim_width=R)
        e_idx, n_new = enqueue_order(is_new_c, c_idx, nreps, R)
        commit_block(c.states[None], 0, c.tail, cap, e_idx, n_new, packed,
                     action, n, *scratch, A, L, n_labels)
        new, ovf, anyv = torch.stack([n_new, flags[FLAG_OVF].any(),
                                      fvalid.any()]).tolist()
        s_full = c.tail + new > cap
        viol = c.viol
        if ovf and viol == OK:
            viol = VIOL_SLOT_OVERFLOW
        if fp_full and anyv and viol == OK:
            viol = VIOL_FPSET_FULL
        if s_full and viol == OK:
            viol = VIOL_QUEUE_FULL
        return EnumCarry(fps=fps, states=c.states, head=c.head + n,
                         tail=c.tail if s_full else c.tail + new, viol=viol)

    def run_fn(c: EnumCarry) -> EnumCarry:
        steps = 0
        while c.head < c.tail and c.viol == OK:
            c = body(c)
            steps += 1
        run_fn.steps = steps
        return c

    run_fn.steps = 0
    return init_fn, run_fn
