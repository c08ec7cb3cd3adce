"""Edge capture: the successor relation as index tensors (port of
jaxtlc/live/capture.py).

Pass 1 (engine.bfs.make_enumerator) leaves the reachable set on the card
as an append-only packed-state array whose row is the state id.  Pass 2
expands every state again through the backend's expand route (kernel K1
for KubeAPI, K19 for a generic spec) and fingerprints the successors
(K2), resolves each successor's id
by a binary search over the fingerprint-sorted states and compacts the
valid lanes into (src, dst, action, changed) int32 edges in lane order
(kernel K14), one chunk a launch.  The host keeps the drained chunks in
RAM up to ``ram_edges`` and past that, when a spill path is given, writes
them as CRC'd .npz part files (the checkpoint tier's fsync-and-rename
publish), read back once at the end.  Parallel (src, dst, action) edges
are then dropped on the host (``np.unique``), as in the reference.

The per-state property operands of the KubeAPI temporal properties (the
``sr`` bits and "the reconciler's secret is present") come from kernel
K15 over the packed states (``state_masks``); a generic spec's come from
kernel K20 (gen.program.GenMasks).

Exactness: ids are resolved by 64-bit fingerprint, the collision risk the
exhaustive engine already accepts; a successor whose fingerprint is not
in the enumerated set raises (the two passes would disagree).
"""

from __future__ import annotations

import os
import zlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..engine.backend import FLAG_VALID
from ..engine.bfs import OK, VIOLATION_NAMES, make_enumerator, resolve_device
from ..engine.fingerprint import DEFAULT_FP_INDEX, fp64_words


class CapturedGraph(NamedTuple):
    """The device-captured reachable graph; ids are enumerator rows."""

    n_states: int
    init_count: int  # ids 0..init_count-1 are the initial states
    states: np.ndarray  # [V, W] uint32 packed states, id = row
    src: np.ndarray  # [E] int32
    dst: np.ndarray  # [E] int32
    action: np.ndarray  # [E] int32 action label id
    changed: np.ndarray  # [E] bool: state-changing edge (src != dst)


class _EdgeSpill:
    """Host tier of drained [n, 4] int32 edge blocks: RAM up to
    `ram_edges`, then (with a spill path) sequential .npz part files,
    re-read once at finalize."""

    def __init__(self, spill_path: Optional[str] = None,
                 ram_edges: int = 1 << 26):
        self.spill_path = spill_path
        self.ram_edges = ram_edges
        self.blocks: List[np.ndarray] = []
        self.in_ram = 0
        self.parts: List[str] = []

    def append(self, block: np.ndarray) -> None:
        if not len(block):
            return
        self.blocks.append(block)
        self.in_ram += len(block)
        if self.spill_path is not None and self.in_ram > self.ram_edges:
            self._spill()

    def _spill(self) -> None:
        from ..engine.checkpoint import fsync_replace

        part = f"{self.spill_path}.edges{len(self.parts):05d}.npz"
        tmp = part + ".tmp"
        edges = np.concatenate(self.blocks)
        crc = np.uint32(zlib.crc32(np.ascontiguousarray(edges).tobytes()))
        with open(tmp, "wb") as f:
            np.savez_compressed(f, edges=edges, crc=crc)
            # fsync before the rename: a crash must not publish a part
            # whose bytes never reached the disk
            fsync_replace(tmp, part, f=f)
        self.parts.append(part)
        self.blocks = []
        self.in_ram = 0

    def finalize(self) -> np.ndarray:
        loaded = []
        for part in self.parts:
            with np.load(part) as z:
                edges = z["edges"]
                if "crc" in z.files and zlib.crc32(
                        np.ascontiguousarray(edges).tobytes()
                ) != int(z["crc"]):
                    raise IOError(
                        f"edge-spill part {part!r} failed CRC verification "
                        "- torn write or bit rot; re-run the capture")
                loaded.append(edges)
            os.remove(part)
        if self.blocks:
            loaded.append(np.concatenate(self.blocks))
        if not loaded:
            return np.zeros((0, 4), np.int32)
        return np.concatenate(loaded)


# ---------------------------------------------------------------------------
# the fingerprint-sorted id map and kernel K14
# ---------------------------------------------------------------------------


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 words as their unsigned values in int64."""
    return t.to(torch.int64) & 0xFFFFFFFF


def sorted_ids(lo: torch.Tensor, hi: torch.Tensor):
    """The states' fingerprints in unsigned (hi, lo) order: (s_hi, s_lo,
    perm) [V] int32, the reference's ``lax.sort((hi, lo, arange),
    num_keys=2)``.  One library sort of a 64-bit key whose order is the
    unsigned pair order (hi biased by 2^31 into the signed range)."""
    key = (_u32(hi) - (1 << 31)) * (1 << 32) + _u32(lo)
    perm = torch.sort(key, stable=True).indices
    return hi[perm], lo[perm], perm.to(torch.int32)


def edge_capture_plain(s_hi, s_lo, perm, q_hi, q_lo, valid, action,
                       offset: int, L: int):
    """Torch version of kernel K14 (jaxtlc/live/capture.py:117,187-219):
    each lane's lower bound of (q_hi, q_lo) over the sorted pairs in
    max(1, bit_length(V - 1)) rounds, its id dst = perm[idx] and changed =
    dst != src, then the valid lanes' (src, dst, action, changed) rows in
    lane order.  -> (edges [nv, 4] int32, missing 0-dim bool)."""
    V = s_hi.shape[0]
    dev = q_hi.device
    sh, sl, qh, ql = _u32(s_hi), _u32(s_lo), _u32(q_hi), _u32(q_lo)
    lo_i = torch.zeros(qh.shape, dtype=torch.int64, device=dev)
    hi_i = torch.full(qh.shape, V, dtype=torch.int64, device=dev)
    for _ in range(max(1, (V - 1).bit_length())):
        cont = lo_i < hi_i
        mid = (lo_i + hi_i) >> 1
        m = torch.clamp(mid, max=V - 1)
        less = (sh[m] < qh) | ((sh[m] == qh) & (sl[m] < ql))
        lo_i = torch.where(cont & less, mid + 1, lo_i)
        hi_i = torch.where(cont & ~less, mid, hi_i)
    idx_c = torch.clamp(lo_i, max=V - 1)
    found = (sh[idx_c] == qh) & (sl[idx_c] == ql) & (lo_i < V)
    dst = perm[idx_c]
    src = offset + torch.arange(qh.shape[0], device=dev,
                                dtype=torch.int32) // L
    fvalid = valid.bool()
    edges = torch.stack([src, dst, action, (dst != src).to(torch.int32)],
                        1)[fvalid]
    return edges, (fvalid & ~found).any()


def edge_capture(s_hi, s_lo, perm, q_hi, q_lo, valid, action, offset: int,
                 L: int):
    """Kernel K14 on CUDA tensors, the plain version on CPU tensors."""
    if not q_hi.is_cuda:
        return edge_capture_plain(s_hi, s_lo, perm, q_hi, q_lo, valid,
                                  action, offset, L)
    from ..kernels import ops

    return ops.edge_capture(s_hi, s_lo, perm, q_hi, q_lo, valid, action,
                            offset, L)


def enumerate_states(backend, chunk: int = 1024,
                     state_capacity: int = 1 << 20,
                     fp_capacity: int = 1 << 20,
                     fp_index: int = DEFAULT_FP_INDEX,
                     device=None) -> torch.Tensor:
    """Pass 1: the reachable set as packed states [V, W] int32 on the
    device, in the enumerator's append order (row = state id)."""
    init_fn, run_fn = make_enumerator(
        backend, chunk=chunk, state_capacity=state_capacity,
        fp_capacity=fp_capacity, fp_index=fp_index,
        device=resolve_device(device))
    carry = run_fn(init_fn())
    if carry.viol != OK:
        raise RuntimeError(
            f"liveness enumeration halted: {VIOLATION_NAMES[carry.viol]}")
    return carry.states[:carry.tail]


def sweep_edges(backend, states: torch.Tensor, chunk: int = 1024,
                fp_index: int = DEFAULT_FP_INDEX,
                spill_path: Optional[str] = None,
                ram_edges: int = 1 << 26) -> np.ndarray:
    """Pass 2: every state of `states` expanded again, its successors
    resolved to ids (K14): the raw edges [n, 4] int32 (src, dst, action,
    changed) in lane order, parallel edges included."""
    cdc = backend.cdc
    L = backend.n_lanes
    V = states.shape[0]

    # the fingerprint-sorted id map
    lo, hi = fp64_words(states, cdc.nbits, fp_index)
    s_hi, s_lo, perm = sorted_ids(lo, hi)

    # states padded to whole sweep chunks
    Vp = -(-V // chunk) * chunk
    pad = torch.zeros(Vp, cdc.n_words, dtype=torch.int32,
                      device=states.device)
    pad[:V] = states
    spillway = _EdgeSpill(spill_path, ram_edges=ram_edges)
    for off in range(0, Vp, chunk):
        packed, flags, action = backend.kernels.expand(
            pad[off:off + chunk], min(chunk, V - off), deferred=True)[:3]
        q_lo, q_hi = fp64_words(packed, cdc.nbits, fp_index)
        edges, missing = edge_capture(s_hi, s_lo, perm, q_hi, q_lo,
                                      flags[FLAG_VALID], action, off, L)
        if bool(missing):
            raise RuntimeError(
                "edge capture found a successor outside the enumerated set "
                "(enumeration/capture disagree - checker bug)")
        spillway.append(edges.cpu().numpy())
    return spillway.finalize()


def captured_graph(backend, states: torch.Tensor,
                   raw: np.ndarray) -> CapturedGraph:
    """The CapturedGraph of the enumerated states and their raw edges,
    parallel (src, dst, action) triples dropped on the host in first-seen
    order; `changed` is determined by (src, dst), so it survives the
    dedup."""
    V = states.shape[0]
    if len(raw):
        n_act = int(raw[:, 2].max()) + 1
        key = (raw[:, 0].astype(np.int64) * V
               + raw[:, 1].astype(np.int64)) * n_act \
            + raw[:, 2].astype(np.int64)
        _, uniq = np.unique(key, return_index=True)
        raw = raw[np.sort(uniq)]
    return CapturedGraph(
        n_states=V,
        init_count=int(np.asarray(backend.initial_vectors()).shape[0]),
        states=states.cpu().numpy().view(np.uint32),
        src=raw[:, 0].astype(np.int32), dst=raw[:, 1].astype(np.int32),
        action=raw[:, 2].astype(np.int32), changed=raw[:, 3].astype(bool))


def capture_edges(backend, chunk: int = 1024, state_capacity: int = 1 << 20,
                  fp_capacity: int = 1 << 20,
                  fp_index: int = DEFAULT_FP_INDEX,
                  spill_path: Optional[str] = None, ram_edges: int = 1 << 26,
                  device=None) -> CapturedGraph:
    """Enumerate the reachable set and capture its edge relation, on the
    card unless `device` says otherwise: enumerate_states, sweep_edges,
    captured_graph."""
    states = enumerate_states(
        backend, chunk=chunk, state_capacity=state_capacity,
        fp_capacity=fp_capacity, fp_index=fp_index, device=device)
    raw = sweep_edges(backend, states, chunk=chunk, fp_index=fp_index,
                      spill_path=spill_path, ram_edges=ram_edges)
    return captured_graph(backend, states, raw)


# ---------------------------------------------------------------------------
# kernel K15: the property operands
# ---------------------------------------------------------------------------


def mask_params(cfg) -> np.ndarray:
    """The MaskParams words of kernel K15 (csrc/liveness.cuh): the packed
    bit offsets of the apiState slots and the sr bits, and the identity of
    each reconciler's secret (KubeAPI.tla:806-808), in
    cfg.reconciler_indices order."""
    from ..spec.codec import get_codec

    cdc = get_codec(cfg)
    starts = np.concatenate([[0], np.cumsum(cdc.lane_widths)])
    api = starts[cdc.sl("api")]
    sr = starts[cdc.sl("sr")]
    sec = [cfg.targets[ci][0] for ci in cfg.reconciler_indices]
    max_api, max_sr = 32, 16  # MASK_MAX_API, MASK_MAX_SR
    if len(api) > max_api or len(sr) > max_sr:
        raise ValueError("the configuration exceeds K15's slot tables")

    def pad(xs, n):
        return list(xs) + [0] * (n - len(xs))

    return np.array([cdc.n_words, cdc.o_present, cdc.o_ident, cdc.ib,
                     cdc.obj_bits, len(api), len(sr), len(sec)]
                    + pad(api, max_api) + pad(sr, max_sr)
                    + pad(sec, max_sr), np.int32)


def state_masks_plain(cfg, states: torch.Tensor) -> torch.Tensor:
    """Torch version of kernel K15 (jaxtlc/live/capture.py:252 with the
    predicates of jaxtlc/live/check.py:99-117): packed states [V, W] int32
    -> [nr + n_sec, V] uint8, row k < nr sr[k] == 1, row nr + j the j-th
    reconciler's secret present in apiState."""
    from ..spec.codec import get_codec

    cdc = get_codec(cfg)
    f = cdc.unpack(states).to(torch.int64)
    rows = [f[:, cdc.offsets["sr"] + k] == 1 for k in range(cdc.nr)]
    api = f[:, cdc.sl("api")]
    pres = (api >> cdc.o_present) & 1
    ident = (api >> cdc.o_ident) & ((1 << cdc.ib) - 1)
    for ci in cfg.reconciler_indices:
        si, _ = cfg.targets[ci]
        rows.append(((pres == 1) & (ident == si)).any(1))
    if not rows:
        return torch.zeros(0, states.shape[0], dtype=torch.uint8,
                           device=states.device)
    return torch.stack(rows).to(torch.uint8)


def state_masks(cfg, states: torch.Tensor) -> torch.Tensor:
    """Kernel K15 on a CUDA tensor, the plain version on a CPU tensor."""
    if not states.is_cuda:
        return state_masks_plain(cfg, states)
    from ..kernels import ops

    return ops.state_masks(mask_params(cfg), states)
