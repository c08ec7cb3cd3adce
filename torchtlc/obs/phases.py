"""Phase attribution (the port's own copy of jaxtlc/obs/phases.py:44-223,
which imports no jax): two capture modes of increasing resolution.

1. **Fence mode** (always on with the journal): the supervisor already
   pays a host sync at every segment fence; ``segment_phases`` turns the
   device wall it measures there (dispatch to fence) and the host
   readback wall after it (progress, ring and coverage reads) into
   ``phase`` journal events of scope "segment".  Pure host arithmetic
   over timestamps that already exist: no device work, no extra sync.
2. **``-phase-timing``** (``PhasedRuntime``): the supervisor swaps its
   segment function for a host-fenced step loop whose expand and commit
   halves are the very ``make_stage_pair`` closures the fused body
   composes - so results stay bit-for-bit while every level gets
   measured expand/commit walls (``PhaseRecorder``, scope="level"
   ``phase`` events).  Each half ends in a ``torch.cuda.synchronize()``
   on the card: the fences cost real wall time, which is why it is a
   flag.  Unpipelined single-device engines only, as in the reference:
   fencing the pipelined body would serialize the overlap it exists to
   create, and the sharded body's halves run for all shards at once.

The reference's differential sub-phase profiler (``subphase_walls``) and
the Chrome-trace exporter that renders these rows are not ported.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

# canonical phase names (the `phase` field vocabulary)
PHASE_EXPAND = "expand"
PHASE_COMMIT = "commit"
PHASE_DEVICE = "device"
PHASE_READBACK = "readback"


class PhaseRecorder:
    """Accumulates per-level expand/commit walls between fences.

    The phased step loop calls `step(level, expand_s, commit_s)` per
    engine step; the supervisor drains completed measurements at each
    segment fence and journals them as `phase` events.  `reset()` drops
    measurements of a segment that is about to be replayed (retry /
    regrow roll back the carry; its timings must not double-count)."""

    def __init__(self):
        self._levels: Dict[int, Dict[str, float]] = {}
        self._order: List[int] = []

    def step(self, level: int, expand_s: float, commit_s: float) -> None:
        row = self._levels.get(level)
        if row is None:
            row = {"expand": 0.0, "commit": 0.0, "bodies": 0}
            self._levels[level] = row
            self._order.append(level)
        row["expand"] += expand_s
        row["commit"] += commit_s
        row["bodies"] += 1

    def reset(self) -> None:
        self._levels.clear()
        self._order.clear()

    def drain(self) -> List[dict]:
        """Completed measurements as `phase`-event field dicts (oldest
        first, expand before commit per level), then reset.  A level
        spanning two segments yields one row per segment; walls are
        additive, so consumers sum by level."""
        out = []
        for lvl in self._order:
            row = self._levels[lvl]
            for phase in (PHASE_EXPAND, PHASE_COMMIT):
                out.append({
                    "scope": "level", "index": lvl, "phase": phase,
                    "wall_s": round(row[phase], 6),
                    "bodies": row["bodies"],
                })
        self.reset()
        return out


def segment_phases(index: int, wall_s: float,
                   readback_s: float = None) -> List[dict]:
    """Fence-mode `phase` event rows for one supervised segment: the
    device dispatch->fence wall plus the host readback wall the
    supervisor measures around the progress/ring/coverage reads."""
    rows = [{"scope": "segment", "index": index, "phase": PHASE_DEVICE,
             "wall_s": round(wall_s, 6)}]
    if readback_s is not None:
        rows.append({"scope": "segment", "index": index,
                     "phase": PHASE_READBACK,
                     "wall_s": round(readback_s, 6)})
    return rows


class PhasedRuntime:
    """`-phase-timing` execution of the single-device engine over any
    backend: the same supervision contract as engine.spill.SpillRuntime
    (the supervisor swaps its segment function), but the host sits in the
    step loop to FENCE between the expand and commit halves, crediting
    each level's wall to the half that spent it.

    Bit-exactness: the halves are the stage pair the fused body picks
    (engine.bfs make_backend_engine's run_fn.pick, the same two-tier
    small-body choice), with the same pop-cursor arithmetic, so the carry
    after N phased steps equals the carry after N fused steps."""

    def __init__(self, backend, chunk: int, queue_capacity: int,
                 fp_capacity: int, obs_slots: int = 0,
                 sort_free: bool = None, deferred: bool = None, device=None,
                 fp_index: int = None,
                 recorder: Optional[PhaseRecorder] = None):
        from ..engine.bfs import make_backend_engine
        from ..engine.fingerprint import DEFAULT_FP_INDEX

        self.recorder = recorder if recorder is not None else PhaseRecorder()
        # the production factory's init template and its body choice
        self._base_init, run_fn, _ = make_backend_engine(
            backend, chunk, queue_capacity, fp_capacity, obs_slots=obs_slots,
            sort_free=sort_free, deferred=deferred, device=device,
            fp_index=DEFAULT_FP_INDEX if fp_index is None else fp_index)
        self._pick = run_fn.pick

    def init_fn(self):
        return self._base_init()

    def segment_fn(self, ckpt_every: int) -> Callable:
        """seg_fn(carry) -> carry after up to `ckpt_every` steps, fully
        fenced, recording per-level expand/commit walls."""
        from ..engine.bfs import _running, read_bundle

        rec = self.recorder

        def fence(c):
            if c.queue.is_cuda:
                torch.cuda.synchronize(c.queue.device)

        def seg(carry):
            for _ in range(ckpt_every):
                h = read_bundle(carry)
                if not _running(h):
                    break
                level = int(carry.level)
                _, (pop_expand, commit) = self._pick(h)
                t0 = time.perf_counter()
                ex, n = pop_expand(carry, h)
                fence(carry)
                t1 = time.perf_counter()
                carry = commit(carry, ex, n, h.qhead + n, h.qhead + n, h)
                fence(carry)
                t2 = time.perf_counter()
                rec.step(level, t1 - t0, t2 - t1)
            return carry

        return seg
