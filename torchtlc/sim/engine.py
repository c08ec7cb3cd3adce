"""Device-resident random-walk engine (port of jaxtlc/sim/engine.py).

W walker lanes each hold one state; a transition round expands every
live lane's current state through the spec's emitted step, advances it to
one uniformly random enabled successor and checks the invariants on the
chosen state.  The choice bits are counter-based threefry (sim.threefry):
transition ``d`` of lane ``l`` under run seed ``s`` consumes exactly
``bits(fold_in(fold_in(prng_key(s), l), d))`` (``d = 0`` picks the lane's
initial state), so a lane's whole trajectory is a pure function of
``(s, l)`` - what sim.replay turns into exact host-side violation replay.

A round is two kernels of the spec's emitted library
(torchtlc/kernels/csrc/emitted_sim.cuh): K27 ``struct_sim_step`` (one
thread a walker: the step, the draw, the invariants of the chosen state,
block partials into a scratch) and K28 ``sim_fold`` (one block: the
first-wins violation, the uint32 counters, the step cursor and the device
flag ``go``, the walk's condition).  Both return at once while ``go`` is
0, so a round after the condition turned false is the identity and
``run_fn`` launches rounds with no host read, looking at ``go`` once every
``GO_READ_EVERY`` rounds to stop early.  Between them, with the sampling
filter on, kernel K2 fingerprints K27's packed chosen rows and the sorted
insert (K3) feeds them to the device fpset; its saturation rule stays on
the device.  On CPU tensors the backend's routes take the plain versions
(struct.backend.StructProgram.sim_*_plain), buffer for buffer.

The kernel routes update the carry's tensors in place (the states, the
lanes' cursors, the scalar leaves, the fpset table) and return it: a
caller that needs an earlier carry copies it first.

Violation semantics (first wins, deterministic): invariant codes in
backend order > PlusCal assert > deadlock > codec slot overflow, ties to
the lowest lane; the reported state is the new one for an invariant, the
old one otherwise.  ``generated``, ``transitions`` and ``act_taken`` are
uint32 and wrap: ``torch.uint32`` on the card (K28 adds to them), int64
masked to 32 bits on the CPU (CPU ``torch.uint32`` has no arithmetic).

Every backend of the port carries a walk: its kernels' routes ``sim_init``,
``sim_step`` and ``sim_fold`` (and ``prog``, the walk program that sizes
the buffers) run K27 / K28 from a struct spec's own library or a generic
spec's walk library (gen.program.GenProgram.sim_text), and K39
``kube_sim_step`` / K40 ``kube_sim_fold`` (torchtlc/kernels/csrc/
kube_sim.cu) over the KubeAPI spec - one thread a walker, the same round,
buffers and fold.  The sampling filter packs through the backend's codec
(K27's st_pack, K39's kube_pack) and fingerprints ``cdc.nbits`` bits.

``SimEngine`` (the serving plane's smoke class, jaxtlc/sim/engine.py:
429-541) runs up to `width` (seed, config) lanes in one dispatch through
``make_batched_sim``: the lanes' carries are stacked on a leading axis
(``[K, W, F]`` states, ``[K]`` scalars, ``[K, cap/8, 16]`` sampling
tables) and a round is one launch of K34 ``struct_sim_step_batched`` (K27
over lane x walker, each lane with its own key, cursor, ``go`` and
scratch), K2 over every lane's packed rows and the batched sorted insert
(K33) for the sampling filter, and one launch of K35 ``sim_fold_batched``
(K28 with one block a lane).  A lane whose ``go`` is 0 is the identity,
so each lane's final carry is its single-lane run's (``run_sequential``).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..engine.backend import OK, SpecBackend
from ..engine.bfs import FP_HIGHWATER, VIOLATION_NAMES, resolve_device
from ..engine.fingerprint import DEFAULT_FP_INDEX, DEFAULT_SEED, fp64_words
from ..engine.fpset import (
    FPSet,
    fpset_insert_sorted,
    fpset_insert_sorted_batched,
    fpset_new,
)
from ..spec.codec import to_i32
from . import threefry

DEFAULT_WALKERS = 256
DEFAULT_DEPTH = 100
DEFAULT_SIM_WIDTH = 4  # (seed, config) lanes per batched dispatch
M32 = 0xFFFFFFFF
# run_fn reads the device's `go` flag once this many rounds
GO_READ_EVERY = 16

# K27 / K28's scratch layout (emitted_sim.cuh): int32 words, the counters
# uint32 bit patterns; then the n_inv + 3 class minima, then the histogram
SIM_GEN, SIM_TRANS, SIM_ANY, SIM_MIN = 0, 1, 2, 3
SIM_NONE = 0x7FFFFFFF


def hist_offset(n_inv: int) -> int:
    return SIM_MIN + n_inv + 3


def scratch_words(n_inv: int, n_labels: int) -> int:
    return hist_offset(n_inv) + n_labels


def scratch_reset(scratch: torch.Tensor, n_inv: int) -> None:
    """The scratch as K28 leaves it: counters 0, class minima SIM_NONE."""
    scratch.zero_()
    scratch[SIM_MIN:hist_offset(n_inv)] = SIM_NONE


def fold_classes(scratch: torch.Tensor, masks) -> None:
    """Fold each class's lowest lane ([W] bool masks, in class order) into
    the scratch's minima (the kernels' atomicMin)."""
    for c, m in enumerate(masks):
        lane = torch.where(m.any(), m.to(torch.int32).argmax(),
                           torch.tensor(SIM_NONE, device=m.device))
        scratch[SIM_MIN + c] = torch.minimum(scratch[SIM_MIN + c],
                                             lane.to(torch.int32))


def u32_word(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 unsigned values."""
    return t.to(torch.int64) & M32


def fold_add(scratch: torch.Tensor, i, v) -> None:
    """scratch[i] += v, uint32 words with wrap (the kernels' atomicAdd)."""
    scratch[i] = to_i32(u32_word(scratch[i]) + v)


# -- uint32 leaves: torch.uint32 on the card, int64 masked on the CPU -------


def u32_tensor(values, device) -> torch.Tensor:
    v = torch.as_tensor(np.asarray(values, np.int64) & M32)
    dev = torch.device(device)
    if dev.type == "cuda":
        return to_i32(v).to(dev).view(torch.uint32)
    return v.to(dev)


def u32_get(t: torch.Tensor) -> torch.Tensor:
    """A uint32 leaf as int64 values."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & M32
    return t & M32


def u32_set(dst: torch.Tensor, v: torch.Tensor) -> None:
    """dst = v mod 2^32, in place."""
    if dst.dtype == torch.uint32:
        dst.view(torch.int32).copy_(to_i32(v))
    else:
        dst.copy_(v & M32)


# -- the carry ---------------------------------------------------------------

# the reference carry's leaves, in its order, with their numpy dtypes
LEAF_DTYPES = dict(
    key=np.uint32, states=np.int32, step_i=np.int32, alive=np.bool_,
    steps_taken=np.int32, generated=np.uint32, transitions=np.uint32,
    act_taken=np.uint32, viol=np.int32, viol_lane=np.int32,
    viol_step=np.int32, viol_state=np.int32, viol_action=np.int32,
    fps=np.uint32, distinct=np.uint32, fp_sat=np.bool_)
LEAF_ORDER = tuple(LEAF_DTYPES)


class SimCarry(NamedTuple):
    """The whole walk state, in the reference's field order (its pytree
    leaf order: the checkpoint's `leaf_i`)."""

    key: torch.Tensor  # [2] uint32 threefry key of the run's seed
    states: torch.Tensor  # [W, F] int32 current state per lane
    step_i: torch.Tensor  # int32 transition rounds completed (the cursor)
    alive: torch.Tensor  # [W] bool: lane still walking
    steps_taken: torch.Tensor  # [W] int32 transitions this lane took
    generated: torch.Tensor  # uint32 enabled successors examined
    transitions: torch.Tensor  # uint32 transitions taken (all lanes)
    act_taken: torch.Tensor  # [n_labels] uint32 actions taken
    viol: torch.Tensor  # int32 first-wins violation code
    viol_lane: torch.Tensor  # int32 lane that tripped it
    viol_step: torch.Tensor  # int32 transition index (0 = an Init state)
    viol_state: torch.Tensor  # [F] int32 the violating state
    viol_action: torch.Tensor  # int32 action taken into it (-1 = none)
    # --- optional distinct-fp sampling filter (None = estimate off) ---
    fps: FPSet = None  # table [cap / 8, 16] int32
    distinct: torch.Tensor = None  # int64 (uint32 values) distinct sampled
    fp_sat: torch.Tensor = None  # bool: filter full, estimate is a floor

    # the checkpoint protocol (engine.checkpoint's generic snapshots)
    def checkpoint_leaves(self) -> list:
        return carry_to_reference(self)

    def checkpoint_specs(self) -> list:
        return [(name, tuple((v.table if name == "fps" else v).shape),
                 np.dtype(LEAF_DTYPES[name]))
                for name, v in zip(LEAF_ORDER, self) if v is not None]

    def from_checkpoint(self, named: dict) -> "SimCarry":
        return carry_from_reference(list(named.values()),
                                    self.states.device)


def carry_to_reference(carry: SimCarry) -> list:
    """The carry's leaves as numpy arrays in the reference's order and
    dtypes (jax.tree_util.tree_leaves of its SimCarry: None fields dropped,
    the fpset's table one uint32 leaf, 0-dim scalars)."""
    out = []
    for name, v in zip(LEAF_ORDER, carry):
        if v is None:
            continue
        if name == "fps":
            v = v.table.view(torch.int32)
        elif LEAF_DTYPES[name] == np.uint32:
            v = u32_get(v)
        out.append(v.cpu().numpy().astype(LEAF_DTYPES[name]))
    return out


def carry_from_reference(leaves, device=None) -> SimCarry:
    """A carry on `device` (None: the card) from the reference's leaves (a
    list in its order: 13 without the sampling filter, 16 with it)."""
    if len(leaves) not in (13, 16):
        raise ValueError(f"a sim carry has 13 or 16 leaves, got "
                         f"{len(leaves)}")
    dev = resolve_device(device)
    kw = {}
    for name, a in zip(LEAF_ORDER, leaves):
        a = np.asarray(a, LEAF_DTYPES[name])
        if name == "fps":
            kw[name] = FPSet(torch.from_numpy(
                a.view(np.int32).copy()).to(dev))
        elif name == "distinct":
            kw[name] = torch.tensor(int(a), dtype=torch.int64, device=dev)
        elif LEAF_DTYPES[name] == np.uint32:
            kw[name] = u32_tensor(a, dev)
        else:
            kw[name] = torch.from_numpy(a.copy()).to(dev)
    return SimCarry(**kw)


class SimBuffers(NamedTuple):
    """The walk's device buffers between K27 and K28 (one set an engine)."""

    go: torch.Tensor  # [1] int32: the walk's condition, K28 writes it
    scratch: torch.Tensor  # [scratch_words] int32: K27's partials
    vold: torch.Tensor  # [W, F] int32: old rows of violating lanes
    vact: torch.Tensor  # [W] int32: actions of violating lanes
    packed: torch.Tensor = None  # [W, words] int32 chosen rows (sampling)
    take: torch.Tensor = None  # [W] bool lanes that took a transition


def sim_buffers(prog, walkers: int, device, pack: bool) -> SimBuffers:
    W, dev = int(walkers), torch.device(device)
    scratch = torch.zeros(scratch_words(prog.n_inv, prog.n_labels),
                          dtype=torch.int32, device=dev)
    scratch_reset(scratch, prog.n_inv)
    return SimBuffers(
        go=torch.zeros(1, dtype=torch.int32, device=dev), scratch=scratch,
        vold=torch.zeros(W, prog.F, dtype=torch.int32, device=dev),
        vact=torch.zeros(W, dtype=torch.int32, device=dev),
        packed=(torch.zeros(W, prog.W, dtype=torch.int32, device=dev)
                if pack else None),
        take=torch.zeros(W, dtype=torch.bool, device=dev) if pack else None)


class SimResult(NamedTuple):
    """Host-side result of one walk run (the reference's fields: the same
    names as engine.bfs.CheckResult where the fact is the same)."""

    walkers: int
    depth: int  # requested walk depth
    seed: int
    steps: int  # transition rounds completed
    generated: int  # enabled successors examined
    transitions: int  # transitions actually taken
    distinct: int  # sampled distinct-state estimate (0 = filter off)
    fp_saturated: bool
    violation: int
    violation_name: str
    violation_state: np.ndarray
    violation_action: int
    violation_lane: int
    violation_step: int
    action_generated: dict  # {label: times taken} - walk composition
    action_distinct: dict  # always {} (walks do not dedup per action)
    depth_hist: tuple  # sorted (steps_taken, n_lanes) pairs
    halted: int  # lanes that stopped early (deadlock w/ -nodeadlock)
    wall_s: float
    queue_left: int = 0  # CheckResult-compat (walks carry no frontier)


def make_sim_engine(
    backend: SpecBackend,
    walkers: int = DEFAULT_WALKERS,
    depth: int = DEFAULT_DEPTH,
    fp_capacity: int = 0,
    fp_index: int = DEFAULT_FP_INDEX,
    fp_seed: int = DEFAULT_SEED,
    fp_highwater: float = FP_HIGHWATER,
    check_deadlock: bool = None,
    device=None,
):
    """Build ``(init_fn, run_fn, step_fn)`` for the random-walk engine on
    `device` (None: the card).

    ``init_fn(seed, inits=None) -> SimCarry`` seeds every lane with a
    random member of the Init set (`inits` overrides it); the seed is run
    data, one engine serves every seed.  ``run_fn(carry, rounds=None)``
    walks to depth / first violation / all lanes halted (at most `rounds`
    rounds when given: the supervised driver's segment); ``step_fn(carry)``
    advances one transition round (the identity once the walk's condition
    is false).  ``fp_capacity > 0`` carries the distinct-fp sampling
    filter, which saturates (sticky ``fp_sat``) instead of halting."""
    kern = backend.kernels
    if getattr(kern, "sim_step", None) is None:
        raise NotImplementedError(
            "the random walk needs a backend whose kernels carry its round "
            "(sim_init, sim_step, sim_fold)")
    prog = kern.prog
    cdc = backend.cdc
    F = cdc.n_fields
    W = int(walkers)
    depth = int(depth)
    n_labels = len(backend.labels)
    dev = resolve_device(device)
    if check_deadlock is None:
        check_deadlock = backend.check_deadlock
    sample = fp_capacity > 0
    limit = int(fp_capacity * fp_highwater)
    buf = sim_buffers(prog, W, dev, sample)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def set_go(c: SimCarry) -> None:
        buf.go.copy_(((c.step_i < depth) & (c.viol == OK)
                      & c.alive.any()).to(torch.int32).reshape(1))

    def sample_insert(c: SimCarry, go) -> SimCarry:
        """Feed the sampling filter K27's packed rows (every lane on round
        0, `go` None; else the lanes that took a transition while the
        round ran); saturate instead of halting."""
        lo, hi = fp64_words(buf.packed, cdc.nbits, fp_index, fp_seed)
        would = (to_i32(c.distinct).to(torch.int64) + W) > limit
        mask = buf.take
        if go is not None:
            would = would & go
            mask = mask & go
        sat = c.fp_sat | would
        fps, is_new, _, _ = fpset_insert_sorted(c.fps, lo, hi, mask & ~sat)
        return c._replace(fps=fps, distinct=(c.distinct + is_new.sum())
                          & M32, fp_sat=sat)

    def init_fn(seed: int, inits=None) -> SimCarry:
        if inits is None:
            inits = backend.initial_vectors()
        inits = torch.from_numpy(np.ascontiguousarray(
            np.asarray(inits, np.int32))).to(dev)
        extra = {}
        if sample:
            extra = dict(fps=fpset_new(fp_capacity, dev),
                         distinct=torch.zeros((), dtype=torch.int64,
                                              device=dev),
                         fp_sat=torch.zeros((), dtype=torch.bool,
                                            device=dev))
        c = SimCarry(
            key=u32_tensor(threefry.prng_key(seed), dev),
            states=torch.empty(W, F, dtype=torch.int32, device=dev),
            step_i=i32(0),
            alive=torch.ones(W, dtype=torch.bool, device=dev),
            steps_taken=torch.zeros(W, dtype=torch.int32, device=dev),
            generated=u32_tensor(W, dev),
            transitions=u32_tensor(0, dev),
            act_taken=u32_tensor(np.zeros(n_labels, np.int64), dev),
            viol=i32(OK), viol_lane=i32(-1), viol_step=i32(0),
            viol_state=torch.zeros(F, dtype=torch.int32, device=dev),
            viol_action=i32(-1), **extra)
        kern.sim_init(buf, c.key, inits, c.states)
        if sample:
            c = sample_insert(c, None)
        kern.sim_fold(buf, c, depth, init=True)
        return c

    def round_(c: SimCarry) -> SimCarry:
        kern.sim_step(buf, c.key, c.step_i, c.states, c.alive,
                      c.steps_taken, check_deadlock)
        if sample:
            c = sample_insert(c, buf.go[0] != 0)
        kern.sim_fold(buf, c, depth)
        return c

    def step_fn(c: SimCarry) -> SimCarry:
        set_go(c)
        return round_(c)

    def run_fn(c: SimCarry, rounds: int = None) -> SimCarry:
        set_go(c)
        left = max(depth - int(c.step_i), 0)
        for i in range(left if rounds is None else min(rounds, left)):
            c = round_(c)
            if (i + 1) % GO_READ_EVERY == 0 and not int(buf.go[0]):
                break
        return c

    return init_fn, run_fn, step_fn


# ---------------------------------------------------------------------------
# the batched walk (kernels K34, K35; the serving plane's smoke class)
# ---------------------------------------------------------------------------


def lane_carry(carry: SimCarry, k: int) -> SimCarry:
    """Lane k of a stacked carry: views of its slices (0-dim scalars)."""
    return SimCarry(**{
        name: (None if v is None else FPSet(v.table[k]) if name == "fps"
               else v[k])
        for name, v in zip(LEAF_ORDER, carry)})


def lane_buffers(buf: SimBuffers, k: int) -> SimBuffers:
    """Lane k's slice of batched buffers (go [K] -> its [1] view)."""
    return SimBuffers(
        go=buf.go[k:k + 1], scratch=buf.scratch[k], vold=buf.vold[k],
        vact=buf.vact[k],
        packed=None if buf.packed is None else buf.packed[k],
        take=None if buf.take is None else buf.take[k])


def make_batched_sim(
    backend: SpecBackend,
    K: int,
    walkers: int = DEFAULT_WALKERS,
    depth: int = DEFAULT_DEPTH,
    fp_capacity: int = 0,
    fp_index: int = DEFAULT_FP_INDEX,
    fp_seed: int = DEFAULT_SEED,
    fp_highwater: float = FP_HIGHWATER,
    check_deadlock: bool = None,
    device=None,
):
    """``(init_fn, run_fn)`` of K walk lanes in one dispatch on `device`.

    ``init_fn(seeds, inits)`` -> the stacked carry (SimCarry with a leading
    lane axis on every leaf): lane k walks under seeds[k] from Init
    vectors inits[k] ([n0_k, F]).  ``run_fn(carry)`` walks every lane to
    its depth / first violation / all walkers halted; ``lane_carry(c, k)``
    is lane k's carry, equal to make_sim_engine's run of the same seed and
    Init set; ``run_fn(carry, rounds)`` launches at most `rounds` rounds.
    run_fn.rounds counts the rounds of its last call."""
    kern = backend.kernels
    if getattr(kern, "sim_step_batched", None) is None:
        raise NotImplementedError(
            "the batched walk runs over struct backends (kernels K34, K35)")
    prog = kern.prog
    cdc = backend.cdc
    F = cdc.n_fields
    W = int(walkers)
    depth = int(depth)
    n_labels = len(backend.labels)
    dev = resolve_device(device)
    if check_deadlock is None:
        check_deadlock = backend.check_deadlock
    sample = fp_capacity > 0
    limit = int(fp_capacity * fp_highwater)
    scratch = torch.zeros(K, scratch_words(prog.n_inv, prog.n_labels),
                          dtype=torch.int32, device=dev)
    for k in range(K):
        scratch_reset(scratch[k], prog.n_inv)
    buf = SimBuffers(
        go=torch.zeros(K, dtype=torch.int32, device=dev), scratch=scratch,
        vold=torch.zeros(K, W, F, dtype=torch.int32, device=dev),
        vact=torch.zeros(K, W, dtype=torch.int32, device=dev),
        packed=(torch.zeros(K, W, prog.W, dtype=torch.int32, device=dev)
                if sample else None),
        take=torch.zeros(K, W, dtype=torch.bool, device=dev)
        if sample else None)

    def i32(v):
        return torch.full((K,), v, dtype=torch.int32, device=dev)

    def set_go(c: SimCarry) -> None:
        buf.go.copy_(((c.step_i < depth) & (c.viol == OK)
                      & c.alive.any(1)).to(torch.int32))

    def sample_insert(c: SimCarry, go) -> SimCarry:
        lo, hi = fp64_words(buf.packed.view(K * W, -1), cdc.nbits, fp_index,
                            fp_seed)
        would = (to_i32(c.distinct).to(torch.int64) + W) > limit
        mask = buf.take
        if go is not None:
            would = would & go
            mask = mask & go[:, None]
        sat = c.fp_sat | would
        is_new = fpset_insert_sorted_batched(
            c.fps.table, range(K), lo.view(K, W), hi.view(K, W),
            mask & ~sat[:, None])[0]
        return c._replace(distinct=(c.distinct + is_new.sum(1)) & M32,
                          fp_sat=sat)

    def init_fn(seeds, inits) -> SimCarry:
        n0 = [int(np.asarray(x).shape[0]) for x in inits]
        stacked = np.zeros((K, max(n0), F), np.int32)
        for k, x in enumerate(inits):
            stacked[k, :n0[k]] = np.asarray(x, np.int32)
        extra = {}
        if sample:
            extra = dict(
                fps=FPSet(torch.zeros(K, fp_capacity // 8, 16,
                                      dtype=torch.int32, device=dev)),
                distinct=torch.zeros(K, dtype=torch.int64, device=dev),
                fp_sat=torch.zeros(K, dtype=torch.bool, device=dev))
        c = SimCarry(
            key=u32_tensor(np.stack([threefry.prng_key(s) for s in seeds]),
                           dev),
            states=torch.empty(K, W, F, dtype=torch.int32, device=dev),
            step_i=i32(0),
            alive=torch.ones(K, W, dtype=torch.bool, device=dev),
            steps_taken=torch.zeros(K, W, dtype=torch.int32, device=dev),
            generated=u32_tensor(np.full(K, W), dev),
            transitions=u32_tensor(np.zeros(K, np.int64), dev),
            act_taken=u32_tensor(np.zeros((K, n_labels), np.int64), dev),
            viol=i32(OK), viol_lane=i32(-1), viol_step=i32(0),
            viol_state=torch.zeros(K, F, dtype=torch.int32, device=dev),
            viol_action=i32(-1), **extra)
        kern.sim_step_batched(buf, c, check_deadlock, init=True,
                              inits=torch.from_numpy(stacked).to(dev),
                              n0=torch.tensor(n0, dtype=torch.int32,
                                              device=dev))
        if sample:
            c = sample_insert(c, None)
        kern.sim_fold_batched(buf, c, depth, init=True)
        return c

    def round_(c: SimCarry) -> SimCarry:
        kern.sim_step_batched(buf, c, check_deadlock)
        if sample:
            c = sample_insert(c, buf.go != 0)
        kern.sim_fold_batched(buf, c, depth)
        return c

    def run_fn(c: SimCarry, rounds: int = None) -> SimCarry:
        set_go(c)
        left = max(depth - int(c.step_i.min()), 0)
        if rounds is not None:
            left = min(left, rounds)
        rounds = 0
        for i in range(left):
            c = round_(c)
            rounds += 1
            if (i + 1) % GO_READ_EVERY == 0 and not bool(buf.go.any()):
                break
        run_fn.rounds = rounds
        return c

    run_fn.rounds = 0
    init_fn.buffers = buf
    return init_fn, run_fn


def sim_done(carry: SimCarry, depth: int) -> bool:
    """Host-side termination check (the supervised driver's fence)."""
    if int(carry.viol) != OK:
        return True
    return int(carry.step_i) >= depth or not bool(carry.alive.any())


def depth_histogram(steps_taken) -> tuple:
    """Sorted (steps, lanes) pairs of the walks' final depths."""
    vals, counts = np.unique(np.asarray(steps_taken), return_counts=True)
    return tuple((int(v), int(n)) for v, n in zip(vals, counts))


def result_from_sim_carry(
    carry: SimCarry, wall_s: float, backend: SpecBackend,
    walkers: int, depth: int, seed: int, viol_names: dict = None,
) -> SimResult:
    labels = backend.labels
    act = u32_get(carry.act_taken).cpu().numpy()
    viol = int(carry.viol)
    vname = (viol_names or backend.viol_names or {}).get(viol) or \
        VIOLATION_NAMES.get(viol, f"violation {viol}")
    steps_taken = carry.steps_taken.cpu().numpy()
    return SimResult(
        walkers=int(walkers),
        depth=int(depth),
        seed=int(seed),
        steps=int(carry.step_i),
        generated=int(u32_get(carry.generated)),
        transitions=int(u32_get(carry.transitions)),
        distinct=int(carry.distinct) if carry.distinct is not None else 0,
        fp_saturated=(bool(carry.fp_sat)
                      if carry.fp_sat is not None else False),
        violation=viol,
        violation_name=vname,
        violation_state=carry.viol_state.cpu().numpy().copy(),
        violation_action=int(carry.viol_action),
        violation_lane=int(carry.viol_lane),
        violation_step=int(carry.viol_step),
        action_generated={
            labels[i]: int(v) for i, v in enumerate(act) if v
        },
        action_distinct={},
        depth_hist=depth_histogram(steps_taken),
        halted=int((~carry.alive).sum()),
        wall_s=wall_s,
    )


# ---------------------------------------------------------------------------
# struct-model memo (the api / driver / liveness share one engine)
# ---------------------------------------------------------------------------

SIM_MEMO_CAP = 8
_SIM_MEMO: OrderedDict = OrderedDict()


def sim_engine_key(model, walkers: int, depth: int, fp_capacity: int,
                   check_deadlock: bool = True, device=None) -> tuple:
    """The sim-engine memo key: spec meaning x walk geometry x device.
    The seed is absent - it is run data, one engine serves every seed."""
    from ..struct.cache import model_key

    return ("sim", model_key(model), int(walkers), int(depth),
            int(fp_capacity), bool(check_deadlock),
            str(resolve_device(device)))


def get_sim_engine(model, walkers: int, depth: int,
                   fp_capacity: int = 0, check_deadlock: bool = True,
                   device=None):
    """Memoized (backend, init_fn, run_fn, step_fn) for a struct model on
    `device` (None: the card); the struct backend is struct.cache's."""
    from ..struct.cache import _memo, get_backend

    key = sim_engine_key(model, walkers, depth, fp_capacity,
                         check_deadlock, device)

    def build():
        backend = get_backend(model, check_deadlock)
        return (backend,) + make_sim_engine(
            backend, walkers=walkers, depth=depth,
            fp_capacity=fp_capacity, check_deadlock=check_deadlock,
            device=device)

    return _memo(_SIM_MEMO, key, build, cap=SIM_MEMO_CAP)


# ---------------------------------------------------------------------------
# the smoke class's warm engine (jaxtlc/sim/engine.py:429-541)
# ---------------------------------------------------------------------------


class SimEngine:
    """A warm smoke-class engine: one struct backend (its emitted library
    built at the first launch) and the batched walk that runs up to
    `width` (seed, config) lanes per dispatch - serve.sweep.SweepEngine's
    shape applied to the seed axis.  `params` (swept constant domains)
    promotes the swept CONSTANTs to state fields through the same sweep
    compiler, so seeds x configs batch in one dispatch with one build per
    class."""

    def __init__(self, model, params=None, walkers: int = DEFAULT_WALKERS,
                 depth: int = DEFAULT_DEPTH, fp_capacity: int = 0,
                 check_deadlock: bool = True,
                 width: int = DEFAULT_SIM_WIDTH, device=None):
        self.model = model
        self.params = (
            {c: (int(lo), int(hi)) for c, (lo, hi) in params.items()}
            if params else None
        )
        self.walkers = int(walkers)
        self.depth = int(depth)
        self.width = max(1, int(width))
        self.fp_capacity = int(fp_capacity)
        self.device = resolve_device(device)
        from ..serve.sweep import sweep_backend

        # the batched walk's kernels (K34, K35) live in a batched library:
        # the class's sweep compile, or with no params the model's own step
        self.backend = sweep_backend(model, self.params or {},
                                     check_deadlock)
        geo = dict(walkers=self.walkers, depth=self.depth,
                   fp_capacity=self.fp_capacity,
                   check_deadlock=check_deadlock, device=self.device)
        self._init_fn, self._run_fn, _ = make_sim_engine(self.backend, **geo)
        self._binit, self._brun = make_batched_sim(self.backend, self.width,
                                                   **geo)

    def _inits(self, values=None) -> np.ndarray:
        if self.params:
            from ..serve.sweep import config_inits

            return config_inits(self.model, self.params, values or {},
                                self.backend.cdc)
        return self.backend.initial_vectors()

    def carry_for(self, seed: int, values=None) -> SimCarry:
        """A fresh single-lane walk carry for one (seed, config) lane."""
        return self._init_fn(seed, self._inits(values))

    def _result(self, carry: SimCarry, wall_s: float, seed: int):
        return result_from_sim_carry(carry, wall_s, self.backend,
                                     self.walkers, self.depth, seed)

    def run_carries(self, items):
        """(the K lane carries, pad lanes included, and the dispatch's wall)
        of one batched dispatch of (seed, values-or-None) items."""
        if not items:
            raise ValueError("empty sim batch")
        if len(items) > self.width:
            raise ValueError(
                f"{len(items)} sim lanes > width {self.width} "
                "(the scheduler slices batches to width)")
        pad = list(items) + [items[-1]] * (self.width - len(items))
        c = self._binit([int(s) for s, _ in pad],
                        [self._inits(v) for _, v in pad])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.time()
        c = self._brun(c)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return ([lane_carry(c, k) for k in range(self.width)],
                time.time() - t0)

    def run(self, items) -> list:
        """Walk up to `width` (seed, config-values-or-None) lanes in ONE
        dispatch; per-lane results in submission order."""
        carries, wall = self.run_carries(items)
        return [self._result(carries[k], wall, items[k][0])
                for k in range(len(items))]

    def run_sequential(self, items) -> list:
        """The parity baseline: the same walk, one lane at a time (the
        tests pin run() bit for bit against this, the sampling table
        included)."""
        out = []
        for seed, values in items:
            c = self.carry_for(seed, values)
            t0 = time.time()
            c = self._run_fn(c)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            out.append(self._result(c, time.time() - t0, seed))
        return out
