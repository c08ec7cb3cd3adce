"""Counterexample traces (port of jaxtlc/engine/trace.py).

The segmented engine carries only counters and the violating state; on a
violation the `check` command re-runs the search in the host driver
(engine.hostdriver), which keeps a parent pointer per distinct state.
The violation is deterministic, so the re-run finds it again; this module
walks the parent chain back to an initial state and decodes the states
with the action labels that produced them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ModelConfig
from ..spec.codec import get_codec
from ..spec.labels import LABELS


def reconstruct(
    parents: Dict[tuple, Tuple[Optional[tuple], int]],
    violating: tuple,
) -> List[Tuple[tuple, Optional[str]]]:
    """Walk child -> parent links: [(encoded_state, action_label)], the
    first an initial state (action None)."""
    chain: List[Tuple[tuple, Optional[str]]] = []
    cur: Optional[tuple] = violating
    while cur is not None:
        parent, aid = parents[cur]
        chain.append((cur, LABELS[aid] if aid >= 0 else None))
        cur = parent
    chain.reverse()
    return chain


def decode_trace(cfg: ModelConfig, chain):
    """Decoded (spec.values.State, action_label) pairs for rendering."""
    cdc = get_codec(cfg)
    return [(cdc.decode(np.asarray(enc, dtype=np.int32)), act)
            for enc, act in chain]


def find_violation_trace(cfg: ModelConfig, chunk: int = 512,
                         check_deadlock: bool = True, device=None):
    """Re-run in the host driver, stop at the first violation, return
    (kind, [(state, action), ...]) or None if the model is clean."""
    from .hostdriver import host_bfs

    r = host_bfs(cfg, chunk=chunk, keep_parents=True, stop_on_violation=True,
                 check_deadlock=check_deadlock, device=device)
    if not r.violations:
        return None
    kind, enc = r.violations[0]
    return kind, decode_trace(cfg, reconstruct(r.parents, enc))
