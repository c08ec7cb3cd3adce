"""Host-looped BFS driver (port of jaxtlc/engine/hostdriver.py).

The trace-mode driver: the BFS loop runs in Python with dedup in a host
dict that keeps per-state parent pointers, while successor expansion runs
on the device - kernel K1 over fixed-size chunks of the frontier, padded
and masked, followed by the codec's unpack of the packed successors.  The
violation re-run of the `check` command uses it to reconstruct a
counterexample (engine.trace), as TLC's trace explorer re-runs its
search.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..spec.codec import get_codec
from ..spec.kernel import initial_vectors
from .backend import (
    FLAG_AFAIL,
    FLAG_BAD_ONLYONE,
    FLAG_BAD_TYPEOK,
    FLAG_OVF,
    FLAG_VALID,
    expand_block,
)
from .bfs import resolve_device


class HostBFSResult(NamedTuple):
    generated: int
    distinct: int
    depth: int
    max_outdegree: int
    min_outdegree: int
    violations: List[Tuple[str, tuple]]  # (kind, encoded state tuple)
    levels: List[int]
    action_generated: Dict[int, int]  # action label id -> generated count
    parents: Dict[tuple, Tuple[Optional[tuple], int]]  # child -> (parent, action)


def host_bfs(
    cfg: ModelConfig,
    chunk: int = 512,
    on_level: Optional[Callable] = None,
    keep_parents: bool = False,
    stop_on_violation: bool = True,
    check_deadlock: bool = True,
    journal=None,
    device=None,
) -> HostBFSResult:
    """BFS with host-side dedup over the device expansion (K1 on the
    card, its plain version on the CPU).  `journal` (an obs.journal
    RunJournal) gets one `level` event per BFS level."""
    dev = resolve_device(device)
    cdc = get_codec(cfg)
    F = cdc.n_fields

    inits = initial_vectors(cfg)
    seen: Dict[tuple, int] = {}
    parents: Dict[tuple, Tuple[Optional[tuple], int]] = {}
    frontier: List[np.ndarray] = []
    generated = 0
    violations: List[Tuple[str, tuple]] = []
    for s in inits:
        generated += 1
        t = tuple(map(int, s))
        if t not in seen:
            seen[t] = 1
            parents[t] = (None, -1)
            frontier.append(np.asarray(s, np.int32))
    depth = 1
    levels = [len(frontier)]
    max_out, min_out = 0, 1 << 30
    action_generated: Dict[int, int] = {}
    bodies = expanded = 0

    def expand(buf: np.ndarray, n: int):
        """K1 over one padded chunk: (succ fields [chunk, L, F], flags
        [5, chunk, L], action [chunk, L]) on the host."""
        block = cdc.pack(torch.from_numpy(buf)).to(dev)
        packed, flags, action, _ = expand_block(cfg, block, n)
        succs = cdc.unpack(packed)
        out = torch.cat([succs.reshape(-1), flags.reshape(-1).to(torch.int32),
                         action]).cpu().numpy()  # the one device read
        nf = succs.numel()
        L = action.shape[0] // chunk
        return (out[:nf].reshape(chunk, L, F),
                out[nf:nf + flags.numel()].reshape(5, chunk, L) != 0,
                out[nf + flags.numel():].reshape(chunk, L))

    while frontier:
        if on_level is not None:
            on_level(depth, frontier)
        if journal is not None:
            journal.event("level", level=depth, generated=generated,
                          distinct=len(seen), queue=len(frontier),
                          bodies=bodies, expanded=expanded)
        expanded += len(frontier)
        nxt: List[np.ndarray] = []
        for base in range(0, len(frontier), chunk):
            batch = frontier[base:base + chunk]
            n = len(batch)
            buf = np.zeros((chunk, F), dtype=np.int32)
            buf[:n] = np.stack(batch)
            bodies += 1
            succs, flags, action = expand(buf, n)
            valid = flags[FLAG_VALID]
            afail = flags[FLAG_AFAIL]
            ovf = flags[FLAG_OVF]
            if ovf.any():
                b = int(np.argwhere(ovf)[0][0])
                raise RuntimeError(
                    f"codec slot overflow expanding state "
                    f"{cdc.decode(buf[b])!r} - raise ModelConfig bounds")
            generated += int(valid.sum())
            for b in range(n):
                src_t = tuple(map(int, buf[b]))
                succ_set = set()
                for lane in range(succs.shape[1]):
                    if not valid[b, lane]:
                        continue
                    aid = int(action[b, lane])
                    action_generated[aid] = action_generated.get(aid, 0) + 1
                    t = tuple(map(int, succs[b, lane]))
                    succ_set.add(t)
                    if afail[b, lane]:
                        violations.append((f"assert@action{aid}", src_t))
                    if t not in seen:
                        seen[t] = depth + 1
                        nxt.append(succs[b, lane])
                        if keep_parents:
                            parents[t] = (src_t, aid)
                        if flags[FLAG_BAD_TYPEOK, b, lane]:
                            violations.append(("TypeOK", t))
                        if flags[FLAG_BAD_ONLYONE, b, lane]:
                            violations.append(("OnlyOneVersion", t))
                outdeg = len(succ_set)
                max_out = max(max_out, outdeg)
                min_out = min(min_out, outdeg)
                if outdeg == 0 and check_deadlock:
                    violations.append(("deadlock", src_t))
        if violations and stop_on_violation:
            break
        frontier = nxt
        if frontier:
            depth += 1
            levels.append(len(frontier))
    return HostBFSResult(generated, len(seen), depth, max_out, min_out,
                         violations, levels, action_generated, parents)
