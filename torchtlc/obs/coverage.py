"""The coverage plane's shared vocabulary (the port's own copy of what it
uses from jaxtlc/obs/coverage.py:43-140, which imports no jax).

* ``Site`` / ``CoveragePlane`` - what a SpecBackend exposes: an ordered
  site table plus a per-block ``count`` hook whose ``[n_sites]`` uint32
  increments the commit folds into the carry's cumulative ``cov_counts``.
  The first ``len(LABELS)`` sites are the per-action sites (kind
  "action"), so the per-action generated counts are a prefix view of the
  site vector.
* ``coverage_delta_event`` / ``coverage_from_events`` - the supervisor
  journals per-segment deltas as ``coverage`` events; folding them back
  gives the cumulative totals.

The port's ``CoveragePlane.count`` takes the popped block as the engine
holds it - ``count(block [ck, W] int32 packed, n, valid [ck*L] uint8)`` -
and runs kernel K10 on a CUDA tensor (spec.coverage_device); the
reference's takes the unpacked fields and the pop mask.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np


class Site(NamedTuple):
    """One coverage site: a stable key, its kind, the action it belongs
    to, and its source span when the frontend knows one (the KubeAPI span
    table).  Kinds: "action" (per-action header site), "init" (Init
    conjunct), "span" (a tracked expression span)."""

    key: str
    kind: str
    action: str
    loc: str = ""


class CoveragePlane(NamedTuple):
    """The backend -> engine coverage seam (SpecBackend.coverage).

    ``count(block, n, valid) -> [n_sites]`` uint32 increments of one
    expanded block; ``init_count`` is a HOST function charging the Init
    sites for the seed states (None = all-zero seed).  Pure telemetry:
    neither feeds control flow, so coverage-on results are coverage-off
    results."""

    sites: tuple  # tuple[Site]
    count: object  # fn(block, n, valid) -> [n_sites] uint32 (int32 words)
    init_count: object = None  # host fn(inits [n0, F] np) -> [n_sites]
    module: str = ""  # module name for the MC.out-format dump

    @property
    def n_sites(self) -> int:
        return len(self.sites)

    def seed(self, inits) -> np.ndarray:
        """[n_sites] uint32 Init-visit seed for `inits` (host-side)."""
        if self.init_count is None:
            return np.zeros(self.n_sites, np.uint32)
        out = np.asarray(self.init_count(np.asarray(inits)), np.uint32)
        assert out.shape == (self.n_sites,)
        return out


def action_site_table(module: str, actions: Sequence[str],
                      locs: Optional[Dict[str, str]] = None) -> list:
    """The per-action prefix of a site table: one "action" site per
    action, in rendering order."""
    locs = locs or {}
    return [Site(key=a, kind="action", action=a, loc=locs.get(a, ""))
            for a in actions]


def site_totals_dict(sites: Sequence[Site], counts) -> Dict[str, int]:
    """{site key: cumulative count} from a counts vector."""
    counts = np.asarray(counts)
    return {s.key: int(c) for s, c in zip(sites, counts)}


def coverage_delta_event(sites: Sequence[Site], totals: np.ndarray,
                         seen: Optional[np.ndarray]) -> Optional[dict]:
    """The `coverage` journal-event payload for one segment fence:
    nonzero per-site deltas since `seen` plus the visited/total header;
    None when nothing moved (no event is journaled)."""
    totals = np.asarray(totals, np.int64)
    prev = (np.zeros_like(totals) if seen is None
            else np.asarray(seen, np.int64))
    delta = totals - prev
    if not (delta != 0).any():
        return None
    return {
        "visited": int((totals > 0).sum()),
        "sites": len(sites),
        "delta": {s.key: int(d) for s, d in zip(sites, delta) if d},
    }


def coverage_from_events(events) -> Optional[dict]:
    """Fold a journal's `coverage` delta events back into cumulative
    totals; None when the run carried no coverage plane.  `visited` is
    recomputed from the folded totals, and the run counts as saturated
    when every journal that emitted coverage carried its saturation event
    (the level reported is the max)."""
    totals: Dict[str, int] = {}
    n_sites = 0
    sat: Dict = {}  # host key (None = single journal) -> sat level
    covered = set()
    for ev in events:
        if ev.get("event") != "coverage":
            continue
        hk = ev.get("host")
        covered.add(hk)
        for k, d in ev.get("delta", {}).items():
            totals[k] = totals.get(k, 0) + int(d)
        n_sites = ev.get("sites", n_sites)
        if ev.get("saturated"):
            sat[hk] = ev.get("level")
    if not totals and n_sites == 0:
        return None
    saturated_at = None
    if covered and covered <= set(sat):
        levels = [v for v in sat.values() if v is not None]
        saturated_at = max(levels) if levels else None
    return {
        "sites": totals,
        "visited": sum(1 for v in totals.values() if v),
        "n_sites": n_sites or len(totals),
        "saturated_at_level": saturated_at,
    }
