"""Carries across the two packages: the "weights carried across" step of a
model checker.

``carry_to_numpy(c)`` gives a dict with the field names of the reference
EngineCarry (unpipelined fields), each leaf a numpy array in the
reference's dtype; the fingerprint set appears as ``fps``, its
``[cap/8, 16]`` uint32 table words.  The observability leaves
(``OBS_FIELDS``: the ring as uint32 words, its head as int32, the bodies
and expanded counters as uint32) appear when the carry has them.  A
spill-mode carry adds ``spill_hits`` (uint32), a covered carry its
``cov_counts`` ([n_sites] uint32).
``carry_from_numpy(d)`` takes such a
dict - or any object with those attributes, such as a reference carry whose
leaves were pulled to numpy - and builds the port's carry on `device`.
Converting a reference carry, stepping both, and converting back gives
word-equal leaves (tests/test_torch_engine.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .bfs import EngineCarry, resolve_device
from .fpset import FPSet

SCALARS = {
    "parity": np.int32, "qhead": np.int32, "level_n": np.int32,
    "next_n": np.int32, "level": np.int32, "depth": np.int32,
    "generated": np.uint32, "distinct": np.uint32, "viol": np.int32,
    "viol_action": np.int32,
}
COUNTERS = ("act_gen", "act_dist", "outdeg_hist")  # uint32 in the reference
FIELDS = ("fps", "queue", "parity", "qhead", "level_n", "next_n", "level",
          "depth", "generated", "distinct", "act_gen", "act_dist",
          "outdeg_hist", "viol", "viol_state", "viol_action")
OBS_SCALARS = {"obs_head": np.int32, "obs_bodies": np.uint32,
               "obs_expanded": np.uint32}
OBS_FIELDS = ("obs_ring", *OBS_SCALARS)
# the reference carry's leaf order (jax.tree_util.tree_leaves of an
# unpipelined EngineCarry: NamedTuple field order, None fields dropped)
LEAF_ORDER = FIELDS + OBS_FIELDS + ("spill_hits", "cov_counts")


def _has(d, name) -> bool:
    v = d.get(name) if isinstance(d, dict) else getattr(d, name, None)
    return v is not None


def _get(d, name):
    v = d[name] if isinstance(d, dict) else getattr(d, name)
    if name == "fps" and not isinstance(v, np.ndarray):
        v = v.table if hasattr(v, "table") else v
    return np.asarray(v)


def carry_to_numpy(c: EngineCarry) -> dict:
    out = {
        "fps": c.fps.table.cpu().numpy().view(np.uint32),
        "queue": c.queue.cpu().numpy().view(np.uint32),
        "viol_state": c.viol_state.cpu().numpy().astype(np.int32),
    }
    for name, dt in SCALARS.items():
        out[name] = np.asarray(int(getattr(c, name)) & 0xFFFFFFFF,
                               np.uint32).astype(dt)
    for name in COUNTERS:
        out[name] = (getattr(c, name).cpu().numpy() & 0xFFFFFFFF).astype(
            np.uint32)
    if c.obs_ring is not None:
        out["obs_ring"] = c.obs_ring.cpu().numpy().view(np.uint32)
        for name, dt in OBS_SCALARS.items():
            out[name] = np.asarray(int(getattr(c, name)) & 0xFFFFFFFF,
                                   np.uint32).astype(dt)
    if c.spill_hits is not None:
        out["spill_hits"] = np.asarray(int(c.spill_hits) & 0xFFFFFFFF,
                                       np.uint32)
    if c.cov_counts is not None:
        out["cov_counts"] = (c.cov_counts.cpu().numpy() & 0xFFFFFFFF).astype(
            np.uint32)
    return out


def carry_from_numpy(d, device=None) -> EngineCarry:
    dev = resolve_device(device)

    def words(a):  # a copy: the engine updates its carry in place
        return torch.from_numpy(
            np.array(a, dtype=np.uint32).view(np.int32)).to(dev)

    vals = {name: torch.tensor(int(_get(d, name)), dtype=torch.int64,
                               device=dev) for name in SCALARS}
    for name in COUNTERS:
        vals[name] = torch.from_numpy(
            _get(d, name).astype(np.int64)).to(dev)
    if _has(d, "obs_ring"):
        vals["obs_ring"] = words(_get(d, "obs_ring"))
        for name in OBS_SCALARS:
            vals[name] = torch.tensor(int(_get(d, name)), dtype=torch.int64,
                                      device=dev)
    if _has(d, "spill_hits"):
        vals["spill_hits"] = torch.tensor(int(_get(d, "spill_hits")),
                                          dtype=torch.int64, device=dev)
    if _has(d, "cov_counts"):
        vals["cov_counts"] = torch.from_numpy(
            _get(d, "cov_counts").astype(np.int64)).to(dev)
    return EngineCarry(
        fps=FPSet(words(_get(d, "fps"))),
        queue=words(_get(d, "queue")),
        viol_state=torch.from_numpy(
            _get(d, "viol_state").astype(np.int32)).to(dev),
        **vals,
    )
