"""Carry migration between engine geometries, the core of auto-regrow
(port of jaxtlc/resil/regrow.py, single-device half).

A capacity halt leaves a poisoned carry: the step that saturated popped a
chunk whose successors were discarded.  The supervisor therefore regrows
from the LAST GOOD carry (the segment boundary before the halt): the
functions here rebuild that carry inside the doubled geometry - every
stored fingerprint re-inserted into the larger table through the
production insert path, the level buffers re-seated, every counter kept -
and the supervisor replays the segment.  Dedup verdicts do not depend on
the table geometry, so the regrown run's final statistics equal an
uninterrupted correctly sized run's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..engine.bfs import (
    VIOL_FPSET_FULL,
    VIOL_QUEUE_FULL,
    EngineCarry,
    resolve_device,
)
from ..engine.fpset import (
    BUCKET,
    FPSet,
    fpset_insert_sorted,
    fpset_new,
    unmix_host,
)

# violation code -> the engine parameter whose doubling clears it
GROWABLE = {
    VIOL_FPSET_FULL: "fp_capacity",
    VIOL_QUEUE_FULL: "queue_capacity",
}


def grown(params: Dict, resource: str) -> Dict:
    """The parameter dict with `resource` doubled."""
    out = dict(params)
    out[resource] = int(out[resource]) * 2
    return out


def migrate_table(old_table: np.ndarray, new_capacity: int,
                  batch: int = 8192, device=None) -> FPSet:
    """Re-insert every stored fingerprint of `old_table` ([cap/8, 16]
    uint32 words) into a fresh table of `new_capacity` slots on `device`:
    the stored MIXED words are unmixed on the host (fpset.unmix_host) and
    fed, in table order and in batches, through fpset_insert_sorted - so
    the new table's words are the reference's migration's; `device` None
    is the card.  Asserts that no entry was lost or duplicated."""
    device = resolve_device(device)
    old_table = np.asarray(old_table).view(np.uint32)
    lo = old_table[:, 0::2].reshape(-1)
    hi = old_table[:, 1::2].reshape(-1)
    occ = (lo != 0) | (hi != 0)
    lo, hi = lo[occ], hi[occ]
    n = int(lo.shape[0])
    assert n <= new_capacity, "new capacity below current occupancy"
    raw_lo, raw_hi = unmix_host(lo, hi)
    fps = fpset_new(new_capacity, device)
    inserted = 0
    for off in range(0, n, batch):
        b_lo = np.zeros(batch, np.uint32)
        b_hi = np.zeros(batch, np.uint32)
        nb = min(batch, n - off)
        b_lo[:nb] = raw_lo[off:off + nb]
        b_hi[:nb] = raw_hi[off:off + nb]
        mask = torch.from_numpy(np.arange(batch) < nb).to(device)
        fps, is_new_c, _, _ = fpset_insert_sorted(
            fps, torch.from_numpy(b_lo.view(np.int32)).to(device),
            torch.from_numpy(b_hi.view(np.int32)).to(device), mask)
        inserted += int(is_new_c.sum())
    assert inserted == n, f"fpset migration lost entries: {inserted} != {n}"
    return fps


def migrate_engine_carry(carry: EngineCarry, old_params: Dict,
                         new_params: Dict,
                         new_chunk: int = None) -> EngineCarry:
    """Rebuild a single-device carry inside the new geometry, on its own
    device.  Counters, level fencing and the pop cursor are kept; the
    table is re-bucketized into the new capacity and the level buffers are
    copied into the new queue, normalized to parity 0.  `new_chunk`
    re-seats the queue's chunk padding for another pop width (the
    ladder's chunk shrink: counts and verdict are kept, in-batch
    attribution may shift).  The ring, spill_hits and the coverage
    counters travel verbatim."""
    dev = carry.queue.device
    chunk = (carry.queue.shape[1] - int(old_params["queue_capacity"])) // 2
    if new_chunk is not None:
        chunk = int(new_chunk)
    W = carry.queue.shape[2]
    qcap2 = int(new_params["queue_capacity"])
    par, lvl, nxt = int(carry.parity), int(carry.level_n), int(carry.next_n)
    assert lvl <= qcap2 and nxt <= qcap2, "regrown queue still too small"
    queue2 = torch.zeros(2, qcap2 + 2 * chunk, W, dtype=torch.int32,
                         device=dev)
    queue2[0, :lvl] = carry.queue[par, :lvl]
    queue2[1, :nxt] = carry.queue[1 - par, :nxt]
    fp_cap2 = int(new_params["fp_capacity"])
    if fp_cap2 != int(old_params["fp_capacity"]):
        fps2 = migrate_table(carry.fps.table.cpu().numpy(), fp_cap2,
                             device=dev)
    else:
        fps2 = FPSet(carry.fps.table.clone())
        assert fps2.table.shape[0] * BUCKET == fp_cap2

    def copy(t):
        return None if t is None else t.clone()

    return EngineCarry(
        fps=fps2, queue=queue2, parity=carry.parity * 0,
        qhead=copy(carry.qhead), level_n=copy(carry.level_n),
        next_n=copy(carry.next_n), level=copy(carry.level),
        depth=copy(carry.depth), generated=copy(carry.generated),
        distinct=copy(carry.distinct), act_gen=copy(carry.act_gen),
        act_dist=copy(carry.act_dist), outdeg_hist=copy(carry.outdeg_hist),
        viol=copy(carry.viol), viol_state=copy(carry.viol_state),
        viol_action=copy(carry.viol_action), obs_ring=copy(carry.obs_ring),
        obs_head=copy(carry.obs_head), obs_bodies=copy(carry.obs_bodies),
        obs_expanded=copy(carry.obs_expanded),
        spill_hits=copy(carry.spill_hits),
        cov_counts=copy(carry.cov_counts),
    )
