"""Carry migration between engine geometries, the core of auto-regrow
(port of jaxtlc/resil/regrow.py).

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
    VIOL_ROUTE_OVERFLOW,
    EngineCarry,
    read_bundle,
    resolve_device,
    staged_block,
)
from ..engine.interop import STAGED
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
    VIOL_ROUTE_OVERFLOW: "route_factor",
}


def grown(params: Dict, resource: str) -> Dict:
    """The parameter dict with `resource` doubled (capacities stay powers
    of two; route_factor is a float multiplier)."""
    out = dict(params)
    out[resource] = (out[resource] * 2.0 if resource == "route_factor"
                     else int(out[resource]) * 2)
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
    attribution may shift; unpipelined carries only, the staged block is
    chunk-shaped).  The ring, spill_hits, the coverage counters, the
    runtime certificate's sticky flag, the reduction's orbit flag and POR
    count and a pipelined carry's staged block (st_cov, st_cert, st_sym
    and st_pruned with it) travel verbatim: the
    replayed segment commits the staged candidates against the regrown
    table and queue.  The staged block's popped rows are rows of the
    current level, which the new queue keeps at the same positions; its
    whole pop window as it stood in the old queue rides along as st_block,
    from which interop derives KubeAPI's st_flat (the reference carries
    that leaf over verbatim, as the port does over an emitted backend)."""
    dev = carry.queue.device
    chunk = (carry.queue.shape[1] - int(old_params["queue_capacity"])) // 2
    if new_chunk is not None:
        if carry.st_n is not None:
            raise ValueError("chunk re-seat supports unpipelined carries "
                             "only")
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
        cert_viol=copy(carry.cert_viol), sym_viol=copy(carry.sym_viol),
        por_pruned=copy(carry.por_pruned),
        **{f: copy(getattr(carry, f))
           for f in STAGED + ("st_cov", "st_flat", "st_cert", "st_sym",
                              "st_pruned")},
        st_block=staged_window(carry, chunk),
    )


def staged_window(carry: EngineCarry, chunk: int):
    """The pop window of a pipelined carry's staged block ([chunk, W], a
    copy), as interop reads it (None on unpipelined carries)."""
    if carry.st_n is None:
        return None
    if carry.st_block is not None:
        return carry.st_block.clone()
    return staged_block(carry, read_bundle(carry), chunk).clone()


def migrate_shard_carry(carry, old_params: Dict, new_params: Dict):
    """Rebuild a ShardCarry inside the new geometry, on its own device
    (jaxtlc/resil/regrow.py:219; capacities are PER SHARD, and ownership -
    hi & (D - 1) - does not depend on them, so no entry changes shard).
    Each shard's table is re-inserted through the production insert path;
    a grown queue is renumbered to qhead = 0 in pop order.  A route_factor
    change resizes only the bucket width: a pipelined carry's pending
    verdicts are then folded through K12 on the carry's device
    (sharded.drain_pending_host) and its pending-verdict buffer re-seated
    empty at the new width.  Every
    other leaf travels verbatim."""
    from ..engine.sharded import (
        drain_pending_host,
        route_bucket_width,
    )

    dev = carry.queue.device
    D = carry.qhead.shape[0]
    carry = carry._replace(bundle=None)
    if carry.pv_n is not None:
        old_B = carry.pv_send.shape[2]
        ncand = carry.pv_sown.shape[1]
        L = carry.outdeg_hist.shape[1] - 2
        new_B = route_bucket_width(
            ncand // L, L, D, float(new_params.get("route_factor", 2.0)))
        if new_B != old_B:
            carry = drain_pending_host(carry)
            carry = carry._replace(pv_send=torch.zeros(
                D, D, new_B, dtype=torch.uint8, device=dev))
    qcap = int(old_params["queue_capacity"])
    qcap2 = int(new_params["queue_capacity"])
    fp_cap2 = int(new_params["fp_capacity"])
    out = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
           for k, v in carry._asdict().items()}
    if fp_cap2 != int(old_params["fp_capacity"]):
        table = carry.table.cpu().numpy()
        out["table"] = torch.stack([
            migrate_table(table[d], fp_cap2, device=dev).table
            for d in range(D)])
    if qcap2 != qcap:
        F = carry.queue.shape[2]
        qhead, qtail = carry.qhead.tolist(), carry.qtail.tolist()
        queue2 = torch.zeros(D, qcap2 + 1, F, dtype=torch.int32, device=dev)
        qtail2 = []
        for d in range(D):
            cnt = qtail[d] - qhead[d]
            assert cnt <= qcap2, "regrown queue still too small"
            idx = (qhead[d] + torch.arange(cnt, device=dev)) % qcap
            queue2[d, :cnt] = carry.queue[d, idx]
            qtail2.append(cnt)
        out.update(queue=queue2, qhead=torch.zeros_like(carry.qhead),
                   qtail=torch.tensor(qtail2, dtype=torch.int64, device=dev),
                   level_end=carry.level_end - carry.qhead)
    return type(carry)(**out)
