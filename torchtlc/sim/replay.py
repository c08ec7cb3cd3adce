"""Seed-exact host replay of one walker lane (port of jaxtlc/sim/replay.py).

A sim lane's trajectory is a pure function of ``(run_seed, lane_id)``
(sim.engine): transition ``d`` consumes exactly
``bits(fold_in(fold_in(prng_key(seed), lane), d))`` and picks the idx-th
enabled successor lane in the emitted lane order.  This module re-derives
the identical draw on the host (sim.threefry) and re-steps the lane one
state at a time through the backend's expand route on the run's device -
kernel K17 on a one-row block and K18 on the chosen row on the card, their
plain versions on the CPU - a path independent of the walk's kernels, so a
disagreement between the two is caught, not repeated.  A backend whose
expand route returns no raw successors (``flat`` None: KubeAPI's K1, a
generic spec's K19) re-steps through its sharded engine's expand route
instead, which returns them (K1's sharded variant, K21, on a one-row
queue), and checks the invariants through its received-rows route (K7's
variant, K18).  The walk prefix is the counterexample trace: decoded
through the backend's codec (spec.codec's for KubeAPI, the struct or the
generic codec), it renders as the same exit-12 trace a BFS run prints for
the same path.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..engine.backend import (
    OK,
    VIOL_ASSERT,
    VIOL_DEADLOCK,
    VIOL_SLOT_OVERFLOW,
    SpecBackend,
)
from ..engine.bfs import resolve_device
from .threefry import draw, prng_key


class ReplayedWalk(NamedTuple):
    """One lane's re-walked trajectory, host-side."""

    seed: int
    lane: int
    # the visited states as raw [F] int32 field vectors, init first
    fields: List[np.ndarray]
    # action label per entry (None for the initial state)
    labels: List[Optional[str]]
    violation: int  # OK when the walk just ran out of steps
    violation_step: int  # index into `fields` of the violating state
    halted: bool  # lane stopped at a successor-less state (no-deadlock)


def replay_lane(
    backend: SpecBackend,
    seed: int,
    lane: int,
    steps: int,
    inits: Optional[np.ndarray] = None,
    check_deadlock: bool = None,
    device=None,
) -> ReplayedWalk:
    """Re-walk lane `lane` of run `seed` for up to `steps` transitions on
    `device` (None: the card).

    Stops early at the first violation on the walked path (invariant >
    assert > deadlock > slot overflow - the engine's own priority, so
    the replay lands on the same state the device reported)."""
    if check_deadlock is None:
        check_deadlock = backend.check_deadlock
    dev = resolve_device(device)
    kern = backend.kernels
    cdc = backend.cdc
    key = prng_key(seed)
    if inits is None:
        inits = backend.initial_vectors()
    inits = np.asarray(inits)
    n0 = inits.shape[0]
    labels = backend.labels
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.zeros(1, dtype=torch.int64, device=dev)

    state = np.asarray(inits[draw(key, lane, 0) % n0], np.int32)
    fields = [state]
    lbls: List[Optional[str]] = [None]

    def inv_viol(vec) -> int:
        # K18 (or its plain version) on the one row: the first invariant,
        # in code order, that the state breaks
        row = torch.from_numpy(vec[None].copy()).to(dev)
        viol, _ = kern.deferred_rows(row, one, first, 1)
        return int(viol)

    code = inv_viol(state)
    if code != OK:
        return ReplayedWalk(seed, lane, fields, lbls, code, 0, False)

    qhead = torch.zeros(1, dtype=torch.int64, device=dev)
    npop = torch.ones(1, dtype=torch.int64, device=dev)

    def successors(vec):
        # (flags, action, raw successor fields) of the one row
        row = torch.from_numpy(vec[None].copy()).to(dev)
        _, flags, action, _, flat = kern.expand(cdc.pack(row), 1,
                                                deferred=True)[:5]
        if flat is None:
            # the sharded expand of a one-row queue: qrows 2, one popped
            queue = torch.cat([row, torch.zeros_like(row)])[None]
            _, flags, action, _, flat = kern.expand_sharded(
                queue, qhead, npop, 1, deferred=True)[:5]
        return flags, action, flat

    for d in range(1, steps + 1):
        flags, action, flat = successors(state)
        flags = flags.cpu().numpy()
        valid = flags[0].astype(bool)
        n = int(valid.sum())
        if n == 0:
            if check_deadlock:
                return ReplayedWalk(seed, lane, fields, lbls,
                                    VIOL_DEADLOCK, len(fields) - 1,
                                    False)
            return ReplayedWalk(seed, lane, fields, lbls, OK,
                                len(fields) - 1, True)
        idx = draw(key, lane, d) % n
        chosen = int(np.flatnonzero(valid)[idx])
        state = flat[chosen].cpu().numpy().astype(np.int32)
        act_id = int(action[chosen])
        fields.append(state)
        lbls.append(labels[act_id] if 0 <= act_id < len(labels)
                    else None)
        if flags[2, chosen]:
            return ReplayedWalk(seed, lane, fields, lbls,
                                VIOL_SLOT_OVERFLOW, len(fields) - 1,
                                False)
        if flags[1, chosen]:
            return ReplayedWalk(seed, lane, fields, lbls, VIOL_ASSERT,
                                len(fields) - 1, False)
        code = inv_viol(state)
        if code != OK:
            return ReplayedWalk(seed, lane, fields, lbls, code,
                                len(fields) - 1, False)
    return ReplayedWalk(seed, lane, fields, lbls, OK, len(fields) - 1,
                        False)


def walk_trace(walk: ReplayedWalk, cdc) -> List[Tuple[tuple, object]]:
    """The walk as [(decoded state, action label | None), ...] through the
    backend's codec `cdc` (its ``decode`` of one raw field vector: the
    struct codec's state tuple, spec.codec's KubeAPI state, the generic
    codec's) - for a struct spec the shape struct.oracle.violation_trace
    returns, so the api's trace renderer prints a replayed walk and a
    BFS-found trace through one code path."""
    return [
        (cdc.decode(vec), lbl)
        for vec, lbl in zip(walk.fields, walk.labels)
    ]
