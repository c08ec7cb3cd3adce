"""Carries across the two packages: the "weights carried across" step of a
model checker.

``carry_to_numpy(c)`` gives a dict with the field names of the reference
EngineCarry (unpipelined fields), each leaf a numpy array in the
reference's dtype; the fingerprint set appears as ``fps``, its
``[cap/8, 16]`` uint32 table words.  The observability leaves
(``OBS_FIELDS``: the ring as uint32 words, its head as int32, the bodies
and expanded counters as uint32) appear when the carry has them.  A
spill-mode carry adds ``spill_hits`` (uint32), a covered carry its
``cov_counts`` ([n_sites] uint32), a carry with the runtime certificate (a
narrowed struct run) its sticky ``cert_viol`` (bool) and, pipelined in the
immediate mode, the staged block's ``st_cert`` (bool); a reduced carry
(``REDUCE_DTYPES``) its sticky orbit flag ``sym_viol`` (bool) and POR
count ``por_pruned`` (uint32), pipelined the staged ``st_sym`` and
``st_pruned``.
A pipelined carry adds the staged block (``STAGED``, in the reference's
dtypes; ``st_cov`` with coverage and, in the deferred mode, ``st_flat``)
and needs its codec both ways (`codec`, or KubeAPI's from its
ModelConfig `cfg`) for the two leaves the port does not hold in the
reference's form:

* ``st_viol_state``: the reference's [F] int32 state, zeros when
  ``st_viol`` is OK; the port stages it packed ([W] words), so it is
  unpacked on the way out and packed on the way in;
* ``st_flat``: the reference's [chunk*L, F] int32 pre-pack successor
  fields of every lane.  The port's K7 derives them again from the parent
  rows, so the port holds no such leaf: on the way out it is computed with
  K1's plain twin (spec.kernel.make_kernel) on the staged parents
  ``queue[parity, qhead - st_n:][:chunk]`` - or, on a carry a regrow just
  migrated, on that window as it stood in the old queue (``st_block``) -;
  on the way in it is dropped.
  ``unpack(st_packed)`` is not that leaf: it differs on disabled lanes of
  rows past the level (fields out of their packed range).  A carry that
  stages the leaf itself (a deferred pipelined carry over an emitted
  backend, whose deferred check, K18, reads it) writes it verbatim, and
  ``flat=True`` reads it back.

``carry_from_numpy(d)`` takes such a
dict - or any object with those attributes, such as a reference carry whose
leaves were pulled to numpy - and builds the port's carry on `device`.
Converting a reference carry, stepping both, and converting back gives
word-equal leaves (tests/test_torch_engine.py, tests/test_torch_pipeline.py).

``shard_carry_to_numpy`` / ``shard_carry_from_numpy`` do the same for the
sharded engine's ShardCarry: the reference ShardCarry's leaves
(``SHARD_LEAF_ORDER``, every one with its leading shard axis) in its
dtypes, both ways (tests/test_torch_sharded.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .bfs import EngineCarry, read_bundle, resolve_device, staged_block
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
# the pipelined engine's staged block, and the dtypes of its leaves
STAGED = ("st_packed", "st_lo", "st_hi", "st_valid", "st_action", "st_gen",
          "st_n", "st_viol", "st_viol_state", "st_viol_action")
STAGED_DTYPES = {
    "st_packed": np.uint32, "st_lo": np.uint32, "st_hi": np.uint32,
    "st_valid": np.bool_, "st_action": np.int32, "st_gen": np.uint32,
    "st_n": np.int32, "st_viol": np.int32, "st_viol_state": np.int32,
    "st_viol_action": np.int32, "st_flat": np.int32, "st_cov": np.uint32,
    "st_cert": np.bool_, "st_sym": np.bool_, "st_pruned": np.uint32,
}
# the state-space reduction's leaves (jaxtlc/engine/bfs.py:162-168)
REDUCE_DTYPES = {"sym_viol": np.bool_, "st_sym": np.bool_,
                 "por_pruned": np.uint32, "st_pruned": np.uint32}
# the reference carry's leaf order (jax.tree_util.tree_leaves of an
# EngineCarry: NamedTuple field order, None fields dropped)
LEAF_ORDER = (FIELDS + STAGED + OBS_FIELDS
              + ("spill_hits", "cert_viol", "st_cert", "st_flat",
                 "cov_counts", "st_cov") + tuple(REDUCE_DTYPES))


def _has(d, name) -> bool:
    v = d.get(name) if isinstance(d, dict) else getattr(d, name, None)
    return v is not None


def _get(d, name):
    v = d[name] if isinstance(d, dict) else getattr(d, name)
    if name == "fps" and not isinstance(v, np.ndarray):
        v = v.table if hasattr(v, "table") else v
    return np.asarray(v)


def staged_codec(cfg, codec=None):
    """The codec a pipelined carry's staged leaves convert with: `codec`,
    else KubeAPI's of the ModelConfig `cfg`."""
    if codec is not None:
        return codec
    if cfg is None:
        raise ValueError("a pipelined carry converts with its codec "
                         "(codec=...) or its ModelConfig (cfg=...)")
    from ..spec.codec import get_codec

    return get_codec(cfg)


def _staged_to_numpy(c: EngineCarry, cfg, codec, deferred: bool) -> dict:
    from ..spec.kernel import lane_layout, make_kernel

    cdc = staged_codec(cfg, codec)
    out = {
        "st_packed": c.st_packed.cpu().numpy().view(np.uint32),
        "st_lo": c.st_lo.cpu().numpy().view(np.uint32),
        "st_hi": c.st_hi.cpu().numpy().view(np.uint32),
        "st_valid": c.st_valid.cpu().numpy().astype(np.bool_),
        "st_action": c.st_action.cpu().numpy().astype(np.int32),
        "st_gen": (c.st_gen.cpu().numpy() & 0xFFFFFFFF).astype(np.uint32),
    }
    for name in ("st_n", "st_viol", "st_viol_action"):
        out[name] = np.asarray(int(getattr(c, name)), np.int32)
    if int(c.st_viol) != 0:
        out["st_viol_state"] = cdc.unpack(
            c.st_viol_state.cpu()[None])[0].numpy().astype(np.int32)
    else:
        out["st_viol_state"] = np.zeros(cdc.n_fields, np.int32)
    if deferred and c.st_flat is not None:
        out["st_flat"] = c.st_flat.cpu().numpy().astype(np.int32)
    elif deferred:
        chunk = c.st_packed.shape[0] // lane_layout(cfg)[1]
        if int(c.qhead) == 0 and int(c.level_n) > 0:
            # no body has run (every body leaves the cursor past its pop
            # or the level empty): the reference's all-zero seed block
            out["st_flat"] = np.zeros((chunk * lane_layout(cfg)[1],
                                       cdc.n_fields), np.int32)
        else:
            block = (c.st_block if c.st_block is not None
                     else staged_block(c, read_bundle(c), chunk)).cpu()
            succ = make_kernel(cfg)(cdc.unpack(block))[0]
            out["st_flat"] = succ.reshape(-1, cdc.n_fields).numpy().astype(
                np.int32)
    if c.st_cov is not None:
        out["st_cov"] = c.st_cov.cpu().numpy().view(np.uint32)
    if c.st_cert is not None:
        out["st_cert"] = np.asarray(bool(c.st_cert), np.bool_)
    return out


def carry_to_numpy(c: EngineCarry, cfg=None, deferred: bool = False,
                   codec=None) -> dict:
    """The reference's leaves of a port carry; a pipelined carry needs its
    `codec` or its ModelConfig `cfg`, and `deferred` adds st_flat (derived
    through `cfg` when the carry does not stage it)."""
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
    if c.cert_viol is not None:
        out["cert_viol"] = np.asarray(bool(c.cert_viol), np.bool_)
    for name, dt in REDUCE_DTYPES.items():
        v = getattr(c, name)
        if v is not None:  # a flag, or a counter's low 32 bits
            out[name] = np.asarray(int(v) & 0xFFFFFFFF, np.uint32).astype(dt)
    if c.st_n is not None:
        out.update(_staged_to_numpy(c, cfg, codec, deferred))
    return out


def carry_from_numpy(d, device=None, cfg=None, codec=None,
                     flat: bool = False) -> EngineCarry:
    """The port's carry from reference leaves; a pipelined one (with
    st_n) needs its `codec` or its ModelConfig `cfg`, and keeps the
    st_flat leaf when `flat` (a carry that stages it)."""
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
    if _has(d, "cert_viol"):
        vals["cert_viol"] = torch.tensor(bool(_get(d, "cert_viol")),
                                         device=dev)
    for name, dt in REDUCE_DTYPES.items():
        if _has(d, name):
            vals[name] = (torch.tensor(bool(_get(d, name)), device=dev)
                          if dt is np.bool_ else
                          torch.tensor(int(_get(d, name)), dtype=torch.int64,
                                       device=dev))
    if _has(d, "st_n"):
        vals.update(_staged_from_numpy(d, staged_codec(cfg, codec), flat,
                                       dev, words))
    return EngineCarry(
        fps=FPSet(words(_get(d, "fps"))),
        queue=words(_get(d, "queue")),
        viol_state=torch.from_numpy(
            _get(d, "viol_state").astype(np.int32)).to(dev),
        **vals,
    )


def _staged_from_numpy(d, cdc, flat: bool, dev, words) -> dict:
    def t(name, dtype):
        return torch.from_numpy(np.array(_get(d, name)).astype(dtype)).to(dev)

    def i64(name):
        return torch.tensor(int(_get(d, name)), dtype=torch.int64,
                            device=dev)

    out = {
        "st_packed": words(_get(d, "st_packed")),
        "st_lo": words(_get(d, "st_lo")), "st_hi": words(_get(d, "st_hi")),
        "st_valid": t("st_valid", np.bool_),
        "st_action": t("st_action", np.int32),
        "st_gen": t("st_gen", np.int64),
        "st_n": i64("st_n"), "st_viol": i64("st_viol"),
        "st_viol_action": i64("st_viol_action"),
        "st_viol_state": cdc.pack(torch.from_numpy(
            np.array(_get(d, "st_viol_state"), np.int32))[None])[0].to(dev),
    }
    if _has(d, "st_cov"):
        out["st_cov"] = words(_get(d, "st_cov"))
    if _has(d, "st_cert"):
        out["st_cert"] = torch.tensor(bool(_get(d, "st_cert")), device=dev)
    if flat:
        out["st_flat"] = t("st_flat", np.int32)
    return out


# ---------------------------------------------------------------------------
# the sharded engine's carry (engine.sharded.ShardCarry)
# ---------------------------------------------------------------------------

# the reference ShardCarry's fields in order (jaxtlc/engine/sharded.py:
# 119-179; None fields drop out of its leaves) and each leaf's dtype
SHARD_DTYPES = {
    "table": np.uint32, "queue": np.int32, "qhead": np.int32,
    "qtail": np.int32, "level_end": np.int32, "level": np.int32,
    "depth": np.int32, "generated": np.uint32, "distinct": np.uint32,
    "act_gen": np.uint32, "act_dist": np.uint32, "outdeg_hist": np.uint32,
    "viol": np.int32, "viol_state": np.int32, "viol_local": np.bool_,
    "cont": np.bool_, "pv_send": np.uint8, "pv_sown": np.int32,
    "pv_pos": np.int32, "pv_svalid": np.bool_, "pv_order": np.int32,
    "pv_faction": np.int32, "pv_n": np.int32, "obs_ring": np.uint32,
    "obs_head": np.int32, "obs_bodies": np.uint32,
    "obs_expanded": np.uint32, "obs_pl_level": np.int32,
    "obs_pl_flag": np.bool_, "cov_counts": np.uint32,
    "spill_hits": np.uint32,
}
SHARD_LEAF_ORDER = tuple(SHARD_DTYPES)
# the port's dtype of each leaf: int32 words, bool/uint8 flags, int64
# counters (the reference's uint32 words in their low 32 bits)
_SHARD_TORCH = {"table": torch.int32, "queue": torch.int32,
                "viol_state": torch.int32, "obs_ring": torch.int32,
                "pv_send": torch.uint8, "pv_sown": torch.int32,
                "pv_pos": torch.int32, "pv_order": torch.int32,
                "pv_faction": torch.int32, "viol_local": torch.bool,
                "cont": torch.bool, "pv_svalid": torch.bool,
                "obs_pl_flag": torch.bool}


def shard_carry_to_numpy(c) -> dict:
    """The reference's ShardCarry leaves of a port ShardCarry, as numpy
    arrays in the reference's dtypes (the carry's None leaves left out)."""
    out = {}
    for name, dt in SHARD_DTYPES.items():
        v = getattr(c, name, None)
        if v is None:
            continue
        a = v.cpu().numpy()
        if a.dtype == np.int64:  # a counter: its low 32 bits
            a = (a & 0xFFFFFFFF).astype(np.uint32)
        # 32-bit words keep their bit patterns; flags keep their values
        out[name] = a.view(dt) if a.dtype.itemsize == 4 else a.astype(dt)
    return out


def shard_carry_from_numpy(d, device=None):
    """The port's ShardCarry from reference leaves (a dict, or an object
    with those attributes such as a reference ShardCarry), on `device`."""
    from .sharded import ShardCarry

    dev = resolve_device(device)
    vals = {}
    for name, dt in SHARD_DTYPES.items():
        if not _has(d, name):
            continue
        a = np.array(_get(d, name), dtype=dt)
        want = _SHARD_TORCH.get(name)
        if want is torch.int32:
            t = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                 else a.astype(np.int32))
        elif want is not None:
            t = torch.from_numpy(a).to(want)
        else:  # counters: int64 holding the uint32 words
            t = torch.from_numpy(a.astype(np.int64))
        vals[name] = t.to(dev)
    return ShardCarry(**vals)
