"""Engine-layer arithmetic of the preflight (jaxtlc/analysis/
engine_audit.py:143 ``audit_counter_width``, copied).  The reference's
jaxpr audits in the same module (donation, purity, ``audit_engine``)
trace its engines and go with ``-analyze`` (ROADMAP Queue A item 13).
"""

from __future__ import annotations

from typing import List

from . import SEV_WARNING, Finding


def audit_counter_width(subject: str, fp_capacity: int, n_lanes: int,
                        dtype_bits: int = 32) -> List[Finding]:
    """Static saturation bound for the cumulative uint32 counters: a
    run can expand up to fp_capacity distinct states, each generating
    up to n_lanes candidates, so cumulative `generated` (and the
    per-action columns summing to it) is bounded by fp_capacity *
    n_lanes.  Past 2^32 the uint32 columns wrap silently - exactly
    where ROADMAP #3's billion-state runs are headed.

    Note the bound assumes fp_capacity caps the distinct-state count.
    Once the HOST SPILL TIER activates (engine.spill - the recovery
    story for fpset saturation), distinct states are bounded by host
    RAM instead, so a spilling run can saturate these counters at ANY
    fp_capacity; the ring's sticky overflow column is then the only
    guard."""
    bound = int(fp_capacity) * max(int(n_lanes), 1)
    if bound < (1 << dtype_bits):
        return []
    return [Finding(
        layer="engine", check="counter-width", severity=SEV_WARNING,
        subject=subject,
        detail=(f"cumulative uint32 counters can saturate: fp_capacity "
                f"{fp_capacity} x {n_lanes} lanes bounds `generated` at "
                f"{bound} >= 2^{dtype_bits} (and the host spill tier, "
                "once active, lifts the fp_capacity bound entirely); "
                "the obs ring's sticky overflow column will flag it at "
                "runtime, but totals will be wrong - shard the fp "
                "space or lower fp_capacity"),
    )]
