"""On-device counter ring (port of jaxtlc/obs/counters.py).

A fixed-shape ring of 32-bit words rides in the engine carry when
``obs_slots > 0``: ``[slots + 1, cols]`` int32 (bit patterns of the
reference's uint32 words), row ``slots`` being the dump row.  Every engine
body writes one row - at ``head % slots`` when the level flipped, else into
the dump row - and ``head`` counts the rows ever written, so the host
detects wrap-around.  The ring is telemetry: it feeds no control flow.

Row layout (cumulative counters; the layout constants and ``rows_from_ring``
are copies of the reference's, so a ring decodes the same in both
packages):

    col 0  level      BFS level just completed
    col 1  generated  states generated so far
    col 2  distinct   distinct states found so far
    col 3  queue      width of the NEXT level
    col 4  bodies     engine loop bodies executed so far
    col 5  expanded   states popped so far
    col 6  overflow   STICKY: 1 once any cumulative counter's uint32 view
                      wrapped
    col 7  spill      host-spill hits (spill mode; else 0)
    col 8  cert       sticky certificate flag (0: no certificate check)
    col 9  sym        sticky orbit flag (0: no symmetry reduction)
    col 10..10+A-1      per-action generated
    col 10+A..10+2A-1   per-action distinct

The port's counters are int64 and the ring stores their low 32 bits, which
are the reference's wrapping uint32 values; ``wrapped_any`` fires when a
counter's uint32 view wrapped during the body, so the sticky overflow word
equals the reference's.  With the coverage plane the site counters'
pair joins that wrap test (jaxtlc/engine/bfs.py:641-642).  A carry with
the runtime certificate (a narrowed struct run) writes its sticky
``cert_viol`` flag into COL_CERT (jaxtlc/obs/counters.py:105-121): the
flag is ORed into the carry by every commit, so once set every later row
carries it.  A symmetry-reduced carry writes its sticky ``sym_viol`` flag
(the runtime orbit certificate, kernel K25) into COL_SYM the same way.

``ring_row`` writes one row: kernel K8 (torchtlc/kernels/csrc/ring.cu) on a
CUDA tensor, ``ring_row_plain`` - the composition of ``pack_row``,
``sticky_overflow``, ``wrapped_any`` and ``ring_update`` below, the
readable specification of K8 - on a CPU tensor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DEFAULT_OBS_SLOTS = 256

N_FIXED_COLS = 10
(COL_LEVEL, COL_GENERATED, COL_DISTINCT, COL_QUEUE, COL_BODIES,
 COL_EXPANDED, COL_OVERFLOW, COL_SPILL, COL_CERT,
 COL_SYM) = range(N_FIXED_COLS)
COL_RES0 = COL_OVERFLOW  # pre-overflow name of col 6
COL_RES1 = COL_SPILL  # pre-spill name of col 7

MASK32 = 0xFFFFFFFF


def ring_cols(n_labels: int) -> int:
    """Row width for an engine with `n_labels` actions."""
    return N_FIXED_COLS + 2 * n_labels


def ring_new(slots: int, n_labels: int, device=None):
    """Fresh ring ([slots + 1, cols] int32; last row = dump) + head, on
    `device` (None: the card)."""
    from ..engine.bfs import resolve_device

    device = resolve_device(device)
    return (torch.zeros(slots + 1, ring_cols(n_labels), dtype=torch.int32,
                        device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def _word(v: torch.Tensor) -> torch.Tensor:
    """int64 counter(s) -> their low 32 bits as int32 bit patterns."""
    v = v.to(torch.int64) & MASK32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def pack_row(level, generated, distinct, queue, bodies, expanded, act_gen,
             act_dist, overflow=None, spill=None, cert=None,
             sym=None) -> torch.Tensor:
    """One ring row ([cols] int32) from the counters (0-dim int64 tensors;
    act_gen / act_dist [n_labels]); spill (the spill_hits counter), cert
    (the carry's 0-dim bool certificate flag) and sym (its orbit-
    certificate flag) write 0 when None."""
    zero = torch.zeros((), dtype=torch.int64, device=act_gen.device)
    fixed = torch.stack([
        level, generated, distinct, queue, bodies, expanded,
        zero if overflow is None else overflow,
        zero if spill is None else spill,
        zero if cert is None else cert.to(torch.int64),
        zero if sym is None else sym.to(torch.int64),
    ]).to(torch.int64)
    return _word(torch.cat([fixed, act_gen.to(torch.int64),
                            act_dist.to(torch.int64)]))


def sticky_overflow(ring: torch.Tensor, wrapped: torch.Tensor) -> torch.Tensor:
    """The overflow word of the row about to be written: the max of the
    column over the whole ring (the flag never unsets) and this body's
    wrap (0-dim bool)."""
    prev = ring[:, COL_OVERFLOW].to(torch.int64).max() & MASK32
    return torch.maximum(prev, wrapped.to(torch.int64))


def wrapped_any(pairs) -> torch.Tensor:
    """0-dim bool: any (new, old) int64 counter pair whose uint32 view
    wrapped this body (new < old as uint32)."""
    out = None
    for new, old in pairs:
        w = ((new & MASK32) < (old & MASK32)).any()
        out = w if out is None else out | w
    return out


def ring_update(ring: torch.Tensor, head: torch.Tensor, row: torch.Tensor,
                flip: bool) -> None:
    """Write `row` at head % slots when `flip`, else into the dump row;
    head += flip.  In place."""
    slots = ring.shape[0] - 1
    if flip:
        ring[int(head) % slots] = row
        head += 1
    else:
        ring[slots] = row


def ring_row_plain(ring, head, bodies, expanded, n_pop: int, flip: bool,
                   level, gen_new, gen_old, dist_new, dist_old, queue_n,
                   act_gen, act_dist, acts_old, n_labels: int,
                   spill_new=None, spill_old=None, cov_new=None,
                   cov_old=None, entry: bool = False, cert=None,
                   sym=None) -> None:
    """Torch version of kernel K8: the row of one engine body, after its
    commit.  act_gen / act_dist are the [n_labels + 1] counters after the
    body, acts_old their concatenation before it; bodies and expanded are
    advanced by 1 and n_pop; spill_new / spill_old (spill mode) are the
    spill_hits counter after and before the body, cov_new / cov_old (with
    the coverage plane) the [n_sites] site counters.  `entry` (the sharded
    engine's pipelined ring) writes the counters as they were before the
    body - gen_old, dist_old, bodies, expanded, the act_gen half of
    acts_old - with the same wrap test and updates.  `cert` (the carry's
    0-dim bool certificate flag after the body) fills COL_CERT and `sym`
    (its orbit-certificate flag) COL_SYM.  Updates
    ring, head, bodies and expanded in place."""
    n_acts = act_gen.shape[0]
    b1 = bodies + 1
    e1 = expanded + n_pop
    pairs = [
        (gen_new, gen_old), (dist_new, dist_old),
        (act_gen, acts_old[:n_acts]), (act_dist, acts_old[n_acts:]),
        (b1, bodies), (e1, expanded),
    ]
    if spill_new is not None:
        pairs.append((spill_new, spill_old))
    if cov_new is not None:
        pairs.append((cov_new, cov_old))
    vals = ((gen_old, dist_old, bodies, expanded, acts_old[:n_labels])
            if entry else (gen_new, dist_new, b1, e1, act_gen[:n_labels]))
    row = pack_row(level, vals[0], vals[1], queue_n, vals[2], vals[3],
                   vals[4], act_dist[:n_labels],
                   overflow=sticky_overflow(ring, wrapped_any(pairs)),
                   spill=spill_new, cert=cert, sym=sym)
    ring_update(ring, head, row, flip)
    bodies.copy_(b1)
    expanded.copy_(e1)


def ring_row(ring, head, bodies, expanded, n_pop: int, flip: bool, level,
             gen_new, gen_old, dist_new, dist_old, queue_n, act_gen,
             act_dist, acts_old, n_labels: int, spill_new=None,
             spill_old=None, cov_new=None, cov_old=None,
             entry: bool = False, cert=None, sym=None) -> None:
    """Kernel K8 on CUDA tensors, the plain version on CPU tensors."""
    args = (ring, head, bodies, expanded, n_pop, flip, level, gen_new,
            gen_old, dist_new, dist_old, queue_n, act_gen, act_dist,
            acts_old, n_labels, spill_new, spill_old, cov_new, cov_old,
            entry, cert, sym)
    if not ring.is_cuda:
        return ring_row_plain(*args)
    from ..kernels import ops

    ops.ring_row(*args)


def rows_from_ring(
    ring: np.ndarray,
    head: int,
    labels: Optional[Sequence[str]] = None,
    since: int = 0,
    fp_capacity: int = 0,
) -> List[Dict]:
    """Decode the ring rows written in [since, head) that are still
    resident (ring wrap drops the oldest; cumulative counters mean the
    NEXT retained row still carries exact totals).  Returns journal-
    `level`-event-shaped dicts, oldest first.  `ring` holds the words as
    uint32 (an int32 array is read as its bit patterns)."""
    ring = np.asarray(ring)
    if ring.dtype == np.int32:
        ring = ring.view(np.uint32)
    head = int(head)
    slots = ring.shape[0] - 1
    first = max(int(since), head - slots, 0)
    out = []
    for k in range(first, head):
        r = ring[k % slots].astype(np.int64)
        row = {
            "level": int(r[COL_LEVEL]),
            "generated": int(r[COL_GENERATED]),
            "distinct": int(r[COL_DISTINCT]),
            "queue": int(r[COL_QUEUE]),
            "bodies": int(r[COL_BODIES]),
            "expanded": int(r[COL_EXPANDED]),
        }
        if fp_capacity:
            row["fp_load"] = round(int(r[COL_DISTINCT]) / fp_capacity, 6)
        if r[COL_OVERFLOW]:
            row["counter_overflow"] = True
        if r[COL_SPILL]:
            row["spill_hits"] = int(r[COL_SPILL])
        if r[COL_CERT]:
            row["cert_violation"] = True
        if r[COL_SYM]:
            row["sym_violation"] = True
        if labels is not None:
            a = len(labels)
            gen = r[N_FIXED_COLS:N_FIXED_COLS + a]
            dist = r[N_FIXED_COLS + a:N_FIXED_COLS + 2 * a]
            row["action_generated"] = {
                labels[i]: int(v) for i, v in enumerate(gen) if v
            }
            row["action_distinct"] = {
                labels[i]: int(v) for i, v in enumerate(dist) if v
            }
        out.append(row)
    return out


def shard_rows_from_ring(
    ring: np.ndarray,
    head: np.ndarray,
    labels: Optional[Sequence[str]] = None,
    since: int = 0,
    fp_capacity_total: int = 0,
) -> List[Dict]:
    """The sharded decode (jaxtlc/obs/counters.py:210): every shard flips
    levels in lock-step (the level fence is a sum over the shards), so row
    k of each shard's ring describes the same level with partial counters
    - sum them; the level column is the max."""
    ring = np.asarray(ring)  # [D, slots + 1, cols]
    if ring.dtype == np.int32:
        ring = ring.view(np.uint32)
    h = int(np.asarray(head).min())
    summed = ring.astype(np.int64).sum(axis=0)
    summed[:, COL_LEVEL] = ring[:, :, COL_LEVEL].max(axis=0)
    return rows_from_ring(summed, h, labels=labels, since=since,
                          fp_capacity=fp_capacity_total)
