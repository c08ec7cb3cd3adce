"""Segment-scope phase attribution (the port's own copy of the fence mode
of jaxtlc/obs/phases.py:44-47,95-107, which imports no jax).

The supervisor already pays a host sync at every segment fence;
``segment_phases`` turns the device wall it measures there (dispatch to
fence) and the host readback wall after it (progress, ring and coverage
reads) into ``phase`` journal events of scope "segment".  Pure host
arithmetic over timestamps that already exist: no device work, no extra
sync.  The per-level expand/commit walls of ``-phase-timing`` (the
reference's PhasedRuntime) are not ported yet.
"""

from __future__ import annotations

from typing import List

# canonical phase names (the `phase` field vocabulary)
PHASE_EXPAND = "expand"
PHASE_COMMIT = "commit"
PHASE_DEVICE = "device"
PHASE_READBACK = "readback"


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
