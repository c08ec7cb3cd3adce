"""ctypes wrappers of the CUDA kernels (torchtlc/kernels/csrc).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with torch, launches on ``torch.cuda.current_stream()``, raises if
the launch returned a CUDA error, and adds one to ``LAUNCHES[name]`` per
kernel launch.  Nothing here runs on a CPU tensor: the callers
(engine.backend, engine.fingerprint, engine.fpset, engine.bfs) take the
plain torch versions for CPU tensors, and a CUDA tensor always reaches a
kernel here.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build as _build

KERNELS = ("expand", "fp64", "fpset_key", "fpset_probe", "fpset_claim",
           "fpset_walk", "commit", "slab_scatter", "slab_resolve",
           "slab_compact", "slab_order", "slab_mark", "deferred_check",
           "ring_row", "fpset_member", "coverage_count", "route_scatter",
           "verdict_fold", "shard_enqueue", "edge_capture", "state_masks",
           "survive_sweep", "struct_expand", "struct_inv_rows",
           "gen_expand", "gen_state_masks", "emitted_expand_sharded",
           "struct_cov_count", "struct_cert_check", "struct_canon",
           "struct_orbit_check", "struct_por_keep", "struct_sim_step",
           "sim_fold", "struct_pred_matrix", "struct_pred_alive",
           "struct_certify", "struct_recheck", "emitted_expand_batched",
           "fpset_insert_batched", "struct_sim_step_batched",
           "sim_fold_batched", "pod_exchange_pack", "pod_exchange_unpack",
           "pod_stats_pack", "kube_sim_step", "kube_sim_fold",
           "gen_sim_step", "gen_sim_fold")
# K27 / K28 launched from a generic spec's walk library (gen_sim.cuh) count
# as gen_sim_step / gen_sim_fold, from a struct spec's library as
# struct_sim_step / sim_fold
LAUNCHES = {name: 0 for name in KERNELS}
# K23's certificate runs standalone (its own wrapper) or inside K17 (kCert)
# and K18: each launch that evaluates it adds one to
# LAUNCHES["struct_cert_check"] and one here under the kernel it rode in
CERT_LAUNCHES = {"struct_cert_check": 0, "struct_expand": 0,
                 "struct_inv_rows": 0}
# K24's canonicalization and K26's pruning run standalone (their own
# wrappers) or inside K17 and K21 (a text with ST_SYM / ST_POR 1): each
# launch that runs them adds one to LAUNCHES[kernel] and one here under
# the kernel it rode in
REDUCE_LAUNCHES = {
    k: {k: 0, "struct_expand": 0, "emitted_expand_sharded": 0}
    for k in ("struct_canon", "struct_por_keep")}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "tt_layout_words": ("expand", []),
    "tt_expand": ("expand", [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P]),
    "tt_expand_sharded": ("expand", [_P, _P, _LL, _I, _P, _P, _I, _I, _I, _P,
                                     _P, _P, _P, _P, _P, _P]),
    "tt_fp64": ("fp64", [_P, _LL, _I, _I, _P, _P, _P, _P]),
    "tt_fpset_key": ("fpset", [_P, _P, _P, _LL, _P, _P]),
    "tt_fpset_probe": ("fpset", [_P, _I, _P, _I, _P, _P, _LL, _P, _P]),
    "tt_fpset_claim": ("fpset", [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P]),
    "tt_fpset_walk": ("fpset", [_P, _I, ctypes.c_uint, _P, _I, _P, _P, _P,
                                _P, _P]),
    "tt_fpset_member": ("fpset", [_P, _I, ctypes.c_uint, _P, _P, _P, _LL,
                                  _LL, _P, _P]),
    "tt_fpset_bkey": ("fpset_batched", [_P, _P, _P, _LL, _P, _P]),
    "tt_fpset_bprobe": ("fpset_batched", [_P, _I, _P, _I, _I, _P, _P, _P,
                                          _LL, _P, _P]),
    "tt_fpset_bclaim": ("fpset_batched", [_P, _I, _P, _I, _I, _P, _P, _P,
                                          _I, _P, _P, _P, _P]),
    "tt_fpset_bwalk": ("fpset_batched", [_P, _I, ctypes.c_uint, _P, _I, _I,
                                         _P, _P, _P, _P, _P, _P]),
    "tt_commit": ("commit", [_P, _I, _LL, _LL, _P, _LL, _P, _P, _P, _LL, _P,
                             _P, _I, _I, _I, _P]),
    "tt_slab_scatter": ("slab", [_P, _LL, _I, ctypes.c_uint, _P, _P, _P]),
    "tt_slab_resolve": ("slab", [_P, _LL, _I, ctypes.c_uint, _P, _P, _P, _P,
                                 _P]),
    "tt_slab_compact": ("slab", [_P, _P, _LL, _I, _P, _P]),
    "tt_slab_order": ("slab", [_P, _P, _I, _P, _P, _P]),
    "tt_slab_mark": ("slab", [_P, _P, _P, _I, _P, _LL, _P, _P, _P]),
    "tt_deferred_check": ("deferred", [_P, _P, _LL, _P, _P, _P, _P, _P, _P,
                                       _P, _P]),
    "tt_deferred_check_rows": ("deferred", [_P, _P, _LL, _P, _P, _P, _P, _P,
                                            _P]),
    "tt_coverage_words": ("coverage", []),
    "tt_coverage_count": ("coverage", [_P, _P, _I, _I, _P, _P, _P]),
    "tt_ring_row": ("ring", [_P, _I, _I, _P, _P, _P, _LL, _I, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I,
                             _I, _P, _P, _P]),
    "tt_route_scatter": ("route", [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P,
                                   _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]),
    "tt_verdict_fold": ("route", [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                                  _I, _I, _I, _P, _P, _P, _P]),
    "tt_shard_enqueue": ("route", [_P, _LL, _I, _P, _P, _P, _P, _P, _P, _LL,
                                   _I, _I, _P]),
    "tt_edge_search": ("liveness", [_P, _P, _P, _I, _I, _P, _P, _P, _LL, _I,
                                    _I, _P, _P, _P, _P]),
    "tt_edge_compact": ("liveness", [_P, _P, _LL, _I, _I, _P, _P, _P, _P,
                                     _P]),
    "tt_mask_words": ("liveness", []),
    "tt_state_masks": ("liveness", [_P, _P, _LL, _P, _P]),
    "tt_survive_sweep": ("liveness", [_P, _P, _LL, _LL, _I, _P, _P, _LL, _P,
                                      _P, _P, _P]),
    "tt_pod_exchange_pack": ("pod", [_P, _P, _P, _P, _LL, _I, _P, _P]),
    "tt_pod_exchange_unpack": ("pod", [_P, _I, _I, _I, _I, _P, _P, _P, _P,
                                       _P]),
    "tt_pod_stats_pack": ("pod", [_P, _P, _P, _I, _I, _P, _P]),
    "tt_kube_sim_dims": ("kube_sim", [_P]),
    "tt_kube_sim_step": ("kube_sim", [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I,
                                      _I, _I, _P, _P, _P, _P, _P, _P]),
    "tt_kube_sim_fold": ("kube_sim", [_I, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                                      _P, _P, _P, _P, _P, _P, _P, _P]),
}


class _Lib:
    def __init__(self, info: _build.BuildInfo):
        self.info = info
        dlls = {stem: ctypes.CDLL(path) for stem, path in info.libs.items()}
        _build.meter("loads", len(dlls))
        for fn, (stem, argtypes) in _SIGNATURES.items():
            f = getattr(dlls[stem], fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            setattr(self, fn, f)


_lib = None


def load(ptxas_report: bool = False) -> _build.BuildInfo:
    """Build (at first use) and load the kernel libraries."""
    global _lib
    if _lib is None or ptxas_report:
        _lib = _Lib(_build.build(ptxas_report=ptxas_report))
    return _lib.info


def lib() -> _Lib:
    load()
    return _lib


def reset_counts() -> None:
    for counts in (LAUNCHES, CERT_LAUNCHES, *REDUCE_LAUNCHES.values()):
        for k in counts:
            counts[k] = 0


def _cert_launched(host: str) -> None:
    """One launch that evaluated K23's certificate, inside `host`."""
    LAUNCHES["struct_cert_check"] += 1
    CERT_LAUNCHES[host] += 1


def _reduce_launched(prog, host: str) -> None:
    """One launch of `host` over `prog`'s text: K24 and K26 ride in it
    when the text carries the symmetry plan / the POR flags."""
    for kernel, on in (("struct_canon", prog.sym_programs),
                       ("struct_por_keep", prog.por_safe is not None)):
        if on:
            LAUNCHES[kernel] += 1
            REDUCE_LAUNCHES[kernel][host] += 1


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"kernel {name}: launch failed, CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _need(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


@functools.lru_cache(maxsize=None)
def _layout(cfg) -> np.ndarray:
    from ..engine.backend import kernel_layout

    words = kernel_layout(cfg)
    n = lib().tt_layout_words()
    if n != words.shape[0]:
        raise RuntimeError(f"KubeLayout mismatch: kernel has {n} words, "
                           f"kernel_layout gives {words.shape[0]}")
    return words


# ---------------------------------------------------------------------------
# K1 expand
# ---------------------------------------------------------------------------


def expand(cfg, block: torch.Tensor, n: int, deferred: bool = False):
    """-> (packed [ck*L, W] int32, flags [5, ck*L] uint8, action [ck*L]
    int32, gen [n_labels] int64); see engine.backend.expand_block.
    deferred launches the variant without invariants."""
    from ..spec.labels import LABELS

    lay = _layout(cfg)
    ck, W = block.shape
    L, F_W = int(lay[28]), int(lay[25])
    _need(block, "block", torch.int32, (ck, F_W))
    dev = block.device
    ncand = ck * L
    packed = torch.empty(ncand, W, dtype=torch.int32, device=dev)
    flags = torch.empty(5, ncand, dtype=torch.uint8, device=dev)
    action = torch.empty(ncand, dtype=torch.int32, device=dev)
    gen = torch.zeros(len(LABELS), dtype=torch.int64, device=dev)
    rc = lib().tt_expand(lay.ctypes.data_as(_P), _ptr(block), ck, n,
                         int(deferred), _ptr(packed), _ptr(flags), _ptr(action), _ptr(gen),
                         _stream())
    _launched("expand", rc)
    return packed, flags, action, gen


def expand_sharded(cfg, queue: torch.Tensor, qhead: torch.Tensor,
                   npop: torch.Tensor, ck: int, deferred: bool = False,
                   with_block: bool = False):
    """K1 over the pops of all D shards of the sharded engine: -> (packed
    [D*ck*L, W] int32, flags [5, D*ck*L] uint8, action [D*ck*L] int32, gen
    [D, n_labels] int64, fields [D*ck*L, F] int32, block [D*ck, W] int32 or
    None); see engine.sharded.expand_sharded_plain."""
    from ..spec.labels import LABELS

    lay = _layout(cfg)
    L, F, W = int(lay[28]), int(lay[24]), int(lay[25])
    D, qrows = queue.shape[0], queue.shape[1]
    _need(queue, "queue", torch.int32, (D, qrows, F))
    _need(qhead, "qhead", torch.int64, (D,))
    _need(npop, "npop", torch.int64, (D,))
    dev = queue.device
    ncand = D * ck * L
    packed = torch.empty(ncand, W, dtype=torch.int32, device=dev)
    flags = torch.empty(5, ncand, dtype=torch.uint8, device=dev)
    action = torch.empty(ncand, dtype=torch.int32, device=dev)
    fields = torch.empty(ncand, F, dtype=torch.int32, device=dev)
    block = (torch.empty(D * ck, W, dtype=torch.int32, device=dev)
             if with_block else None)
    gen = torch.zeros(D, len(LABELS), dtype=torch.int64, device=dev)
    rc = lib().tt_expand_sharded(
        lay.ctypes.data_as(_P), _ptr(queue), qrows, qrows - 1, _ptr(qhead),
        _ptr(npop), D, ck, int(deferred), _ptr(packed), _ptr(flags),
        _ptr(action), _ptr(fields), None if block is None else _ptr(block),
        _ptr(gen), _stream())
    _launched("expand", rc)
    return packed, flags, action, gen, fields, block


# ---------------------------------------------------------------------------
# K2 fp64
# ---------------------------------------------------------------------------


def fp64(words: torch.Tensor, basis: torch.Tensor, nbits: int):
    """[N, W] int32 packed rows -> (lo, hi) [N] int32; basis [nbits+1, 2]
    int32 (basis rows then const, engine.fingerprint._basis_words)."""
    N, W = words.shape
    if not 0 < nbits <= 32 * W:
        raise ValueError(f"nbits {nbits} does not fit {W} words")
    _need(words, "words", torch.int32)
    _need(basis, "basis", torch.int32, (nbits + 1, 2))
    lo = torch.empty(N, dtype=torch.int32, device=words.device)
    hi = torch.empty(N, dtype=torch.int32, device=words.device)
    rc = lib().tt_fp64(_ptr(words), N, W, nbits, _ptr(basis), _ptr(lo),
                       _ptr(hi), _stream())
    _launched("fp64", rc)
    return lo, hi


# ---------------------------------------------------------------------------
# K3 fingerprint set
# ---------------------------------------------------------------------------


def fpset_key(lo: torch.Tensor, hi: torch.Tensor, mask: torch.Tensor):
    """Mixed, remapped, masked sort keys [N] int64."""
    N = lo.shape[0]
    _need(lo, "lo", torch.int32, (N,))
    _need(hi, "hi", torch.int32, (N,))
    _need(mask, "mask", torch.bool, (N,))
    key = torch.empty(N, dtype=torch.int64, device=lo.device)
    rc = lib().tt_fpset_key(_ptr(lo), _ptr(hi), _ptr(mask), N, _ptr(key),
                            _stream())
    _launched("fpset_key", rc)
    return key


def _table_geom(table: torch.Tensor):
    nb = table.shape[0]
    if nb & (nb - 1):
        raise ValueError("table rows must be a power of two")
    _need(table, "table", torch.int32, (nb, 16))
    return nb, nb.bit_length() - 1


def fpset_probe(table: torch.Tensor, keys: torch.Tensor, nreps, off: int,
                active=None) -> torch.Tensor:
    """Round 0 over one R-wide block of sorted keys, lanes active where
    active[i] ([R] uint8) when given, else where off + i < nreps (read on
    the device): slot codes [R] int32, as engine.fpset.fpset_round0_plain."""
    _, lognb = _table_geom(table)
    R = keys.shape[0]
    _need(keys, "keys", torch.int64, (R,))
    if active is None:
        _need(nreps, "nreps", torch.int64, ())
    else:
        _need(active, "active", torch.uint8, (R,))
    slot = torch.empty(R, dtype=torch.int32, device=keys.device)
    _launched("fpset_probe", lib().tt_fpset_probe(
        _ptr(table), lognb, _ptr(keys), R,
        None if active is not None else _ptr(nreps),
        None if active is None else _ptr(active), off, _ptr(slot),
        _stream()))
    return slot


def fpset_claim(table: torch.Tensor, keys: torch.Tensor, slot: torch.Tensor,
                C: int, is_new: torch.Tensor, pending: torch.Tensor,
                npend: torch.Tensor) -> None:
    """Write the first C round-0 claims; fill is_new and pending [R] uint8
    and add the straggler count to npend (int32 [1])."""
    _table_geom(table)
    R = keys.shape[0]
    _need(keys, "keys", torch.int64, (R,))
    _need(slot, "slot", torch.int32, (R,))
    _need(is_new, "is_new", torch.uint8, (R,))
    _need(pending, "pending", torch.uint8, (R,))
    _need(npend, "npend", torch.int32, (1,))
    cum = None
    if C < R:  # claims beyond the first C fitting ones wait for the walk
        cum = torch.cumsum((slot >= 0).to(torch.int64), 0)
    _launched("fpset_claim", lib().tt_fpset_claim(
        _ptr(table), _ptr(keys), R, _ptr(slot),
        None if cum is None else _ptr(cum), C, _ptr(is_new), _ptr(pending),
        _ptr(npend), _stream()))


def _walk_stats(stats):
    """The walk's optional int32 [3] counters (slices, rounds, slices in
    the general order), added to on the device."""
    if stats is None:
        return None
    _need(stats, "stats", torch.int32, (3,))
    return _ptr(stats)


def fpset_walk(table: torch.Tensor, keys: torch.Tensor, pending: torch.Tensor,
               is_new: torch.Tensor, npend: torch.Tensor,
               stats=None) -> None:
    """Settle the npend pending stragglers (one block, no host round
    trip); updates table, pending and is_new in place, and adds to stats
    (int32 [3], optional) its slices, rounds and general-order slices."""
    nb, lognb = _table_geom(table)
    R = keys.shape[0]
    _need(keys, "keys", torch.int64, (R,))
    _need(pending, "pending", torch.uint8, (R,))
    _need(is_new, "is_new", torch.uint8, (R,))
    _need(npend, "npend", torch.int32, (1,))
    _launched("fpset_walk", lib().tt_fpset_walk(
        _ptr(table), lognb, nb - 1, _ptr(keys), R, _ptr(pending),
        _ptr(is_new), _ptr(npend), _walk_stats(stats), _stream()))


def fpset_probe_segment(table, keys, nreps, off: int, C: int,
                        is_new_out: torch.Tensor, npend: torch.Tensor,
                        active=None) -> None:
    """Insert-or-find one probe segment: fpset_probe, fpset_claim,
    fpset_walk.  npend: a zeroed int32 [1] counter."""
    slot = fpset_probe(table, keys, nreps, off, active)
    pending = torch.empty_like(is_new_out)
    fpset_claim(table, keys, slot, C, is_new_out, pending, npend)
    fpset_walk(table, keys, pending, is_new_out, npend)


def fpset_member(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 mask: torch.Tensor, max_rounds: int = 0) -> torch.Tensor:
    """Kernel K9: membership of each masked raw fingerprint, [N] bool; see
    engine.fpset.fpset_member_plain.  The table is only read."""
    nb, lognb = _table_geom(table)
    N = lo.shape[0]
    _need(lo, "lo", torch.int32, (N,))
    _need(hi, "hi", torch.int32, (N,))
    _need(mask, "mask", torch.bool, (N,))
    if max_rounds < 0:
        raise ValueError("max_rounds must be >= 0")
    found = torch.empty(N, dtype=torch.bool, device=lo.device)
    _launched("fpset_member", lib().tt_fpset_member(
        _ptr(table), lognb, nb - 1, _ptr(lo), _ptr(hi), _ptr(mask), N,
        max_rounds, _ptr(found), _stream()))
    return found


# ---------------------------------------------------------------------------
# K4 commit
# ---------------------------------------------------------------------------


def commit(queue, dst: int, next_n: int, qcap: int, e_idx, n_new, packed,
           action, n_pop: int, act_dist, outdeg_hist, A: int, L: int,
           n_labels: int) -> None:
    """See engine.bfs.commit_block_plain; n_new is read on the device."""
    ncand, W = packed.shape
    _need(queue, "queue", torch.int32)
    if queue.dim() != 3 or queue.shape[2] != W:
        raise ValueError("queue must be [2, rows, W]")
    if qcap + A > queue.shape[1]:
        raise ValueError("queue rows must cover qcap + A")
    _need(e_idx, "e_idx", torch.int64, (ncand,))
    _need(n_new, "n_new", torch.int64, ())
    _need(packed, "packed", torch.int32)
    _need(action, "action", torch.int32, (ncand,))
    _need(act_dist, "act_dist", torch.int64)
    _need(outdeg_hist, "outdeg_hist", torch.int64, (L + 2,))
    rc = lib().tt_commit(_ptr(queue[dst]), W, next_n, qcap, _ptr(e_idx),
                         ncand, _ptr(n_new), _ptr(packed), _ptr(action), n_pop,
                         _ptr(act_dist), _ptr(outdeg_hist), A, L, n_labels,
                         _stream())
    _launched("commit", rc)


# ---------------------------------------------------------------------------
# K5 slab, K6 slab order
# ---------------------------------------------------------------------------


def slab_scatter(keys: torch.Tensor, p: int, mmask: int, unres: torch.Tensor,
                 slab: torch.Tensor) -> None:
    """Pass p's scatter-max of lane + 1; see fpset.slab_scatter_plain."""
    N = keys.shape[0]
    _need(keys, "keys", torch.int64, (N,))
    _need(unres, "unres", torch.uint8, (N,))
    _need(slab, "slab", torch.int32, (mmask + 1,))
    if N >= 1 << 31:
        raise ValueError("slab lanes must fit 31 bits")
    _launched("slab_scatter", lib().tt_slab_scatter(
        _ptr(keys), N, p, mmask, _ptr(unres), _ptr(slab), _stream()))


def slab_resolve(keys: torch.Tensor, p: int, mmask: int, slab: torch.Tensor,
                 unres: torch.Tensor, rep: torch.Tensor, cand=None) -> None:
    """Pass p's winner resolve; see fpset.slab_resolve_plain."""
    N = keys.shape[0]
    _need(keys, "keys", torch.int64, (N,))
    _need(slab, "slab", torch.int32, (mmask + 1,))
    for name, t in (("unres", unres), ("rep", rep)) + (
            (("cand", cand),) if cand is not None else ()):
        _need(t, name, torch.uint8, (N,))
    _launched("slab_resolve", lib().tt_slab_resolve(
        _ptr(keys), N, p, mmask, _ptr(slab), _ptr(unres), _ptr(rep),
        None if cand is None else _ptr(cand), _stream()))


def slab_compact(cand: torch.Tensor, pos: torch.Tensor, R: int,
                 c_lane: torch.Tensor) -> None:
    """Claimant lanes into their prefix positions < R."""
    N = cand.shape[0]
    _need(cand, "cand", torch.uint8, (N,))
    _need(pos, "pos", torch.int64, (N,))
    _need(c_lane, "c_lane", torch.int32, (R,))
    _launched("slab_compact", lib().tt_slab_compact(
        _ptr(cand), _ptr(pos), N, R, _ptr(c_lane), _stream()))


def slab_order(keys: torch.Tensor, c_lane: torch.Tensor,
               n_cand: torch.Tensor) -> torch.Tensor:
    """The R-wide ordering keys [R] int64 (n_cand read on the device)."""
    R = c_lane.shape[0]
    _need(keys, "keys", torch.int64)
    _need(c_lane, "c_lane", torch.int32, (R,))
    _need(n_cand, "n_cand", torch.int64, ())
    ord_key = torch.empty(R, dtype=torch.int64, device=keys.device)
    _launched("slab_order", lib().tt_slab_order(
        _ptr(keys), _ptr(c_lane), R, _ptr(n_cand), _ptr(ord_key), _stream()))
    return ord_key


def slab_mark(s_key: torch.Tensor, perm: torch.Tensor, c_lane: torch.Tensor,
              n_cand: torch.Tensor, n: int):
    """-> (c_idx [R] int64, active [R] uint8); see fpset.slab_mark_plain."""
    R = s_key.shape[0]
    _need(s_key, "s_key", torch.int64, (R,))
    _need(perm, "perm", torch.int64, (R,))
    _need(c_lane, "c_lane", torch.int32, (R,))
    _need(n_cand, "n_cand", torch.int64, ())
    c_idx = torch.empty(R, dtype=torch.int64, device=s_key.device)
    active = torch.empty(R, dtype=torch.uint8, device=s_key.device)
    _launched("slab_mark", lib().tt_slab_mark(
        _ptr(s_key), _ptr(perm), _ptr(c_lane), R, _ptr(n_cand), n,
        _ptr(c_idx), _ptr(active), _stream()))
    return c_idx, active


# ---------------------------------------------------------------------------
# K7 deferred check
# ---------------------------------------------------------------------------


def deferred_check(cfg, block: torch.Tensor, fresh: torch.Tensor,
                   c_idx: torch.Tensor, action: torch.Tensor, rows: int):
    """-> (viol 0-dim int64, state [F] int32, action 0-dim int64); see
    engine.backend.deferred_check_plain."""
    lay = _layout(cfg)
    ck, W = block.shape
    L, F = int(lay[28]), int(lay[24])
    _need(block, "block", torch.int32, (ck, int(lay[25])))
    n = fresh.shape[0]
    if not 0 < rows <= n:
        raise ValueError(f"rows {rows} outside (0, {n}]")
    _need(fresh, "fresh", torch.bool, (n,))
    _need(c_idx, "c_idx", torch.int64, (n,))
    _need(action, "action", torch.int32, (ck * L,))
    dev = block.device
    scratch = torch.full((3,), -1, dtype=torch.int32, device=dev)
    viol = torch.empty((), dtype=torch.int64, device=dev)
    state = torch.empty(F, dtype=torch.int32, device=dev)
    vaction = torch.empty((), dtype=torch.int64, device=dev)
    _launched("deferred_check", lib().tt_deferred_check(
        lay.ctypes.data_as(_P), _ptr(block), rows, _ptr(fresh), _ptr(c_idx),
        _ptr(action), _ptr(scratch), _ptr(viol), _ptr(state), _ptr(vaction),
        _stream()))
    return viol, state, vaction


def deferred_check_rows(cfg, rows_in: torch.Tensor, fresh: torch.Tensor,
                        c_idx: torch.Tensor, rows: int):
    """K7 over received rows [N, F] int32 -> (viol 0-dim int64, state [F]
    int32); see engine.sharded.deferred_check_rows_plain."""
    lay = _layout(cfg)
    F = int(lay[24])
    n = fresh.shape[0]
    _need(rows_in, "rows_in", torch.int32, (n, F))
    if not 0 < rows <= n:
        raise ValueError(f"rows {rows} outside (0, {n}]")
    _need(fresh, "fresh", torch.bool, (n,))
    _need(c_idx, "c_idx", torch.int64, (n,))
    dev = rows_in.device
    scratch = torch.full((3,), -1, dtype=torch.int32, device=dev)
    viol = torch.empty((), dtype=torch.int64, device=dev)
    state = torch.empty(F, dtype=torch.int32, device=dev)
    _launched("deferred_check", lib().tt_deferred_check_rows(
        lay.ctypes.data_as(_P), _ptr(rows_in), rows, _ptr(fresh),
        _ptr(c_idx), _ptr(scratch), _ptr(viol), _ptr(state), _stream()))
    return viol, state


# ---------------------------------------------------------------------------
# K8 ring row
# ---------------------------------------------------------------------------


def ring_row(ring, head, bodies, expanded, n_pop: int, flip: bool, level,
             gen_new, gen_old, dist_new, dist_old, queue_n, act_gen,
             act_dist, acts_old, n_labels: int, spill_new=None,
             spill_old=None, cov_new=None, cov_old=None,
             entry: bool = False, cert=None, sym=None) -> None:
    """One ring row; see obs.counters.ring_row_plain (spill_new and
    spill_old, cov_new and cov_old: both or neither; entry writes the
    counters as they were before the body; cert, the carry's 0-dim bool
    certificate flag, fills COL_CERT, sym, its orbit-certificate flag,
    COL_SYM)."""
    slots, cols = ring.shape[0] - 1, ring.shape[1]
    _need(ring, "ring", torch.int32)
    if slots < 1 or cols != 10 + 2 * n_labels:
        raise ValueError(f"ring shape {tuple(ring.shape)} for {n_labels} "
                         "labels")
    for name, t in (("head", head), ("bodies", bodies),
                    ("expanded", expanded), ("level", level),
                    ("gen_new", gen_new), ("gen_old", gen_old),
                    ("dist_new", dist_new), ("dist_old", dist_old),
                    ("queue_n", queue_n)):
        _need(t, name, torch.int64, ())
    if (spill_new is None) != (spill_old is None):
        raise ValueError("spill_new and spill_old go together")
    if spill_new is not None:
        _need(spill_new, "spill_new", torch.int64, ())
        _need(spill_old, "spill_old", torch.int64, ())
    if (cov_new is None) != (cov_old is None):
        raise ValueError("cov_new and cov_old go together")
    n_cov = 0
    if cov_new is not None:
        n_cov = cov_new.shape[0]
        _need(cov_new, "cov_new", torch.int64, (n_cov,))
        _need(cov_old, "cov_old", torch.int64, (n_cov,))
    n_acts = act_gen.shape[0]
    if n_acts < n_labels:
        raise ValueError("act_gen holds fewer counters than labels")
    _need(act_gen, "act_gen", torch.int64, (n_acts,))
    _need(act_dist, "act_dist", torch.int64, (n_acts,))
    _need(acts_old, "acts_old", torch.int64, (2 * n_acts,))
    for name, flag in (("cert", cert), ("sym", sym)):
        if flag is not None:
            _need(flag, name, torch.bool, ())
    _launched("ring_row", lib().tt_ring_row(
        _ptr(ring), slots, cols, _ptr(head), _ptr(bodies), _ptr(expanded),
        n_pop, int(flip), _ptr(level), _ptr(gen_new), _ptr(gen_old),
        _ptr(dist_new), _ptr(dist_old), _ptr(queue_n), _ptr(act_gen),
        _ptr(act_dist), _ptr(acts_old),
        None if spill_new is None else _ptr(spill_new),
        None if spill_old is None else _ptr(spill_old), n_acts, n_labels,
        None if cov_new is None else _ptr(cov_new),
        None if cov_old is None else _ptr(cov_old), n_cov, int(entry),
        None if cert is None else _ptr(cert),
        None if sym is None else _ptr(sym), _stream()))


# ---------------------------------------------------------------------------
# K10 coverage count
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cov_params(cfg) -> np.ndarray:
    from ..spec.coverage_device import kernel_params

    words = kernel_params(cfg)
    n = lib().tt_coverage_words()
    if n != words.shape[0]:
        raise RuntimeError(f"CovParams mismatch: kernel has {n} words, "
                           f"kernel_params gives {words.shape[0]}")
    return words


def coverage_count(cfg, block: torch.Tensor, n: int,
                   valid: torch.Tensor) -> torch.Tensor:
    """-> [311] int32 (uint32 words): the site increments of the first n
    rows of a popped block; see spec.coverage_device.count_plain.  valid:
    the expand stage's [ck * L] uint8 lane flags."""
    params = _cov_params(cfg)
    lay = _layout(cfg)
    ck = block.shape[0]
    L = int(lay[28])
    _need(block, "block", torch.int32, (ck, int(lay[25])))
    _need(valid, "valid", torch.uint8, (ck * L,))
    out = torch.zeros(311, dtype=torch.int32, device=block.device)
    _launched("coverage_count", lib().tt_coverage_count(
        params.ctypes.data_as(_P), _ptr(block), ck, n, _ptr(valid),
        _ptr(out), _stream()))
    return out


# ---------------------------------------------------------------------------
# K11 route, K12 verdict fold, K13 shard enqueue
# ---------------------------------------------------------------------------


def route_scatter(hi, lo, valid, fields, D: int, B: int, out) -> None:
    """K11 over every source shard of this process (its two grid launches,
    route_count and route_scatter, count as one): S = out.order.shape[0]
    sources (D in one process, D / H in a pod), D owners; hi, lo [S*ncand]
    int32, valid [S*ncand] uint8, fields [S*ncand, F] int32; `out`
    (engine.sharded.RouteOut, planes [D, S, B, .]) receives the
    sorted-order words and the exchange planes - xvalid and route_ovf are
    zeroed here first.  See engine.sharded.route_plain."""
    N = hi.shape[0]
    S = out.order.shape[0]
    if N % S:
        raise ValueError("lanes must split evenly over the shards")
    ncand = N // S
    F = fields.shape[1]
    _need(hi, "hi", torch.int32, (N,))
    _need(lo, "lo", torch.int32, (N,))
    _need(valid, "valid", torch.uint8, (N,))
    _need(fields, "fields", torch.int32, (N, F))
    for name, dt, shape in (
            ("order", torch.int32, (S, ncand)),
            ("s_own", torch.int32, (S, ncand)),
            ("s_pos", torch.int32, (S, ncand)),
            ("s_valid", torch.bool, (S, ncand)),
            ("xrows", torch.int32, (D, S, B, F)),
            ("xlo", torch.int32, (D, S, B)), ("xhi", torch.int32, (D, S, B)),
            ("xvalid", torch.bool, (D, S, B)),
            ("route_ovf", torch.bool, (S,))):
        _need(getattr(out, name), name, dt, shape)
    out.xvalid.zero_()
    out.route_ovf.zero_()
    ntiles = -(-ncand // 1024)
    counts = torch.empty(S, ntiles, D + 1, dtype=torch.int32,
                         device=hi.device)
    rc = lib().tt_route_scatter(
        _ptr(hi), _ptr(lo), _ptr(valid), _ptr(fields), ncand, D, S, B, F,
        _ptr(counts), _ptr(out.order), _ptr(out.s_own), _ptr(out.s_pos),
        _ptr(out.s_valid), _ptr(out.xrows), _ptr(out.xlo), _ptr(out.xhi),
        _ptr(out.xvalid), _ptr(out.route_ovf), _stream())
    _launched("route_scatter", rc)


def verdict_fold(verd, s_own, s_pos, s_valid, order, faction, npop, chunk: int,
                 L: int, n_labels: int, outdeg, act_dist) -> None:
    """K12: fold the verdicts of this process's S source shards (verd [D,
    S, B] uint8, the owners' is_new buckets; S = D in one process) into
    outdeg [S, L+2] and act_dist [S, n_labels+1] (int64, in place); see
    engine.sharded.verdict_fold_plain."""
    D, S, B = verd.shape
    ncand = s_own.shape[1]
    _need(verd, "verd", torch.uint8, (D, S, B))
    for name, t, dt in (("s_own", s_own, torch.int32),
                        ("s_pos", s_pos, torch.int32),
                        ("s_valid", s_valid, torch.bool),
                        ("order", order, torch.int32),
                        ("faction", faction, torch.int32)):
        _need(t, name, dt, (S, ncand))
    _need(npop, "npop", torch.int64, (S,))
    _need(outdeg, "outdeg", torch.int64, (S, L + 2))
    _need(act_dist, "act_dist", torch.int64, (S, n_labels + 1))
    rowdeg = torch.zeros(S * chunk + 1, dtype=torch.int32, device=verd.device)
    _launched("verdict_fold", lib().tt_verdict_fold(
        _ptr(verd), _ptr(s_own), _ptr(s_pos), _ptr(s_valid), _ptr(order),
        _ptr(faction), _ptr(npop), ncand, D, S, B, chunk, L, n_labels,
        _ptr(rowdeg), _ptr(outdeg), _ptr(act_dist), _stream()))


def shard_enqueue(queue, is_new, cum, qtail, q_full, xrows, xvalid) -> None:
    """K13: every owner's fresh received rows into its circular queue
    ([D, qcap + 1, F] int32, in place); is_new [D, n] bool, cum [D, n]
    int64 inclusive counts, qtail [D] int64, q_full [D] bool, xrows [D, n,
    F] int32, xvalid [D, n] bool.  See engine.sharded.shard_enqueue_plain."""
    D, qrows, F = queue.shape
    n = is_new.shape[1]
    _need(queue, "queue", torch.int32)
    _need(is_new, "is_new", torch.bool, (D, n))
    _need(cum, "cum", torch.int64, (D, n))
    _need(qtail, "qtail", torch.int64, (D,))
    _need(q_full, "q_full", torch.bool, (D,))
    _need(xrows, "xrows", torch.int32, (D, n, F))
    _need(xvalid, "xvalid", torch.bool, (D, n))
    _launched("shard_enqueue", lib().tt_shard_enqueue(
        _ptr(queue), qrows, qrows - 1, _ptr(is_new), _ptr(cum), _ptr(qtail),
        _ptr(q_full), _ptr(xrows), _ptr(xvalid), n, D, F, _stream()))


# ---------------------------------------------------------------------------
# K36-K38 the pod's exchange and stats buffers
# ---------------------------------------------------------------------------


def pod_exchange_pack(xrows, xlo, xhi, xvalid) -> torch.Tensor:
    """K36: K11's planes of this process's S sources (xrows [D, S, B, F],
    xlo, xhi [D, S, B] int32, xvalid [D, S, B] bool) -> the [D, S, B, F+3]
    int32 send buffer (fields, lo, hi, valid a lane; grouped by destination
    process along D).  See engine.sharded.pod_pack_plain."""
    D, S, B, F = xrows.shape
    _need(xrows, "xrows", torch.int32)
    for name, t, dt in (("xlo", xlo, torch.int32), ("xhi", xhi, torch.int32),
                        ("xvalid", xvalid, torch.bool)):
        _need(t, name, dt, (D, S, B))
    out = torch.empty(D, S, B, F + 3, dtype=torch.int32, device=xrows.device)
    _launched("pod_exchange_pack", lib().tt_pod_exchange_pack(
        _ptr(xrows), _ptr(xlo), _ptr(xhi), _ptr(xvalid), D * S * B, F,
        _ptr(out), _stream()))
    return out


def pod_exchange_unpack(recv: torch.Tensor):
    """K37: the received [H, S owner, S source, B, F+3] int32 buffer ->
    this process's owner planes (xrows [S, H*S, B, F], xlo, xhi [S, H*S, B]
    int32, xvalid [S, H*S, B] bool), global source p*S + s.  See
    engine.sharded.pod_unpack_plain."""
    H, S, S2, B, W = recv.shape
    if S2 != S:
        raise ValueError("recv: expected [H, S, S, B, F+3]")
    _need(recv, "recv", torch.int32)
    F = W - 3
    dev = recv.device
    xrows = torch.empty(S, H * S, B, F, dtype=torch.int32, device=dev)
    xlo = torch.empty(S, H * S, B, dtype=torch.int32, device=dev)
    xhi = torch.empty_like(xlo)
    xvalid = torch.empty(S, H * S, B, dtype=torch.bool, device=dev)
    _launched("pod_exchange_unpack", lib().tt_pod_exchange_unpack(
        _ptr(recv), H, S, B, F, _ptr(xrows), _ptr(xlo), _ptr(xhi),
        _ptr(xvalid), _stream()))
    return xrows, xlo, xhi, xvalid


POD_PACK_KINDS = {torch.int64: 0, torch.int32: 1, torch.bool: 2,
                  torch.uint8: 2}


def pod_stats_pack(leaves) -> torch.Tensor:
    """K38: leaves of S rows each (int64, int32, bool or uint8, any row
    width; at most 24) -> one [S, W] int64 word row a shard, the leaves'
    words in order.  See engine.sharded.pod_stats_plain."""
    S = leaves[0].shape[0]
    if not 1 <= len(leaves) <= 24:
        raise ValueError("pod_stats_pack takes 1 to 24 leaves")
    widths, kinds = [], []
    for k, t in enumerate(leaves):
        _need(t, f"leaf {k}", t.dtype)
        if t.shape[0] != S or t.dtype not in POD_PACK_KINDS:
            raise ValueError(f"leaf {k}: expected {S} rows of a packable "
                             f"dtype, got {tuple(t.shape)} {t.dtype}")
        widths.append(t[0].numel() if t.dim() > 1 else 1)
        kinds.append(POD_PACK_KINDS[t.dtype])
    n = len(leaves)
    ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in leaves))
    w = (ctypes.c_int * n)(*widths)
    kd = (ctypes.c_int * n)(*kinds)
    out = torch.empty(S, sum(widths), dtype=torch.int64,
                      device=leaves[0].device)
    _launched("pod_stats_pack", lib().tt_pod_stats_pack(
        ptrs, w, kd, n, S, _ptr(out), _stream()))
    return out


# ---------------------------------------------------------------------------
# K14 edge capture, K15 state masks, K16 survive sweep
# ---------------------------------------------------------------------------


def edge_search(s_hi, s_lo, perm, q_hi, q_lo, valid, offset: int, L: int):
    """K14's first launch: each lane's id dst [N] int32 and changed flag
    [N] uint8, and the `missing` flag [1] int32.  s_hi, s_lo [V] int32
    fingerprint words sorted as unsigned (hi, lo) pairs, perm [V] int32
    their ids; q_hi, q_lo [N] int32, valid [N] uint8.  Counted with
    edge_compact, the launch that completes K14."""
    V = s_hi.shape[0]
    N = q_hi.shape[0]
    if not 0 < V < 1 << 31:
        raise ValueError(f"{V} states do not fit the int32 ids")
    for name, t, dt, n in (("s_hi", s_hi, torch.int32, V),
                           ("s_lo", s_lo, torch.int32, V),
                           ("perm", perm, torch.int32, V),
                           ("q_hi", q_hi, torch.int32, N),
                           ("q_lo", q_lo, torch.int32, N),
                           ("valid", valid, torch.uint8, N)):
        _need(t, name, dt, (n,))
    dev = q_hi.device
    dst = torch.empty(N, dtype=torch.int32, device=dev)
    chg = torch.empty(N, dtype=torch.uint8, device=dev)
    missing = torch.zeros(1, dtype=torch.int32, device=dev)
    rc = lib().tt_edge_search(_ptr(s_hi), _ptr(s_lo), _ptr(perm), V,
                              max(1, (V - 1).bit_length()), _ptr(q_hi),
                              _ptr(q_lo), _ptr(valid), N, L, offset,
                              _ptr(dst), _ptr(chg), _ptr(missing), _stream())
    if rc != 0:
        raise RuntimeError(f"kernel edge_capture: launch failed, CUDA error "
                           f"{rc}")
    return dst, chg, missing


def edge_compact(valid, cum, offset: int, L: int, dst, chg, action,
                 edges) -> None:
    """K14's second launch: the valid lanes' (src, dst, action, changed)
    rows into edges [nv, 4] int32 in lane order, each at its inclusive
    count cum [N] int64 of valid; dst, chg from edge_search, action [N]
    int32."""
    N = valid.shape[0]
    _need(valid, "valid", torch.uint8, (N,))
    _need(cum, "cum", torch.int64, (N,))
    _need(dst, "dst", torch.int32, (N,))
    _need(chg, "chg", torch.uint8, (N,))
    _need(action, "action", torch.int32, (N,))
    _need(edges, "edges", torch.int32)
    if edges.dim() != 2 or edges.shape[1] != 4:
        raise ValueError(f"edges: expected shape [nv, 4], got "
                         f"{tuple(edges.shape)}")
    _launched("edge_capture", lib().tt_edge_compact(
        _ptr(valid), _ptr(cum), N, L, offset, _ptr(dst), _ptr(chg),
        _ptr(action), _ptr(edges), _stream()))


def edge_capture(s_hi, s_lo, perm, q_hi, q_lo, valid, action, offset: int,
                 L: int):
    """K14 (its two launches, edge_search and edge_compact, count as one):
    the valid lanes' edges [nv, 4] int32 (src, dst, action, changed) in
    lane order and the `missing` flag (0-dim bool); see
    live.capture.edge_capture_plain.  The edge count nv is read to the
    host between the launches."""
    dst, chg, missing = edge_search(s_hi, s_lo, perm, q_hi, q_lo, valid,
                                    offset, L)
    cum = torch.cumsum(valid, 0, dtype=torch.int64)
    nv = int(cum[-1]) if valid.shape[0] else 0
    edges = torch.empty(nv, 4, dtype=torch.int32, device=valid.device)
    edge_compact(valid, cum, offset, L, dst, chg, action, edges)
    return edges, missing[0] != 0


def state_masks(params: np.ndarray, states: torch.Tensor) -> torch.Tensor:
    """K15: the predicate rows [nr + n_sec, V] uint8 of packed states [V, W]
    int32; params: live.capture.mask_params.  See
    live.capture.state_masks_plain."""
    n = lib().tt_mask_words()
    if params.shape != (n,) or params.dtype != np.int32:
        raise ValueError(f"MaskParams: expected {n} int32 words")
    V, W = states.shape
    if W != int(params[0]):
        raise ValueError(f"states hold {W} words, params say {params[0]}")
    _need(states, "states", torch.int32)
    out = torch.empty(int(params[6]) + int(params[7]), V, dtype=torch.uint8,
                      device=states.device)
    _launched("state_masks", lib().tt_state_masks(
        params.ctypes.data_as(_P), _ptr(states), V, _ptr(out), _stream()))
    return out


def survive_sweep(src: torch.Tensor, dst: torch.Tensor, D: int,
                  alive: torch.Tensor, term: torch.Tensor):
    """K16: one Jacobi sweep over E edges in D equal slices -> (alive2 [V]
    uint8, changed 0-dim bool); see live.fixpoint.survive_sweep_plain."""
    E = src.shape[0]
    V = alive.shape[0]
    if E % D:
        raise ValueError("edges must split evenly over the slices")
    _need(src, "src", torch.int32, (E,))
    _need(dst, "dst", torch.int32, (E,))
    _need(alive, "alive", torch.uint8, (V,))
    _need(term, "term", torch.uint8, (V,))
    dev = alive.device
    support = torch.empty(D, V, dtype=torch.uint8, device=dev)
    alive2 = torch.empty(V, dtype=torch.uint8, device=dev)
    changed = torch.empty(1, dtype=torch.int32, device=dev)
    _launched("survive_sweep", lib().tt_survive_sweep(
        _ptr(src), _ptr(dst), E, max(E // D, 1), D, _ptr(alive), _ptr(term),
        V, _ptr(support), _ptr(alive2), _ptr(changed), _stream()))
    return alive2, changed[0] != 0


# ---------------------------------------------------------------------------
# emitted kernels, one library per text: K17 struct_expand of a struct
# spec (with the random walk's K27 struct_sim_step and K28 sim_fold) or K19
# gen_expand of a generic spec, each with K18 struct_inv_rows and K21
# emitted_expand_sharded; K20 gen_state_masks of a generic spec's temporal
# operands
# ---------------------------------------------------------------------------

_EMITTED_LIBS = {}


def _emitted_lib(text: str, dims_fn: str, signatures, dims):
    """Load the library built from an emitted text (once per text) and
    check its compiled dimensions against `dims`."""
    lib_ = _EMITTED_LIBS.get(text)
    if lib_ is None:
        dll = ctypes.CDLL(_build.build_struct(text))
        _build.meter("loads")
        for fn, argtypes in ((dims_fn, [_P]),) + tuple(signatures):
            getattr(dll, fn).argtypes = argtypes
            getattr(dll, fn).restype = ctypes.c_int
        got = (ctypes.c_int * 6)()
        getattr(dll, dims_fn)(got)
        if tuple(got[:len(dims)]) != tuple(dims):
            raise RuntimeError(f"emitted library dims {tuple(got)} do not "
                               f"match {tuple(dims)}")
        _EMITTED_LIBS[text] = lib_ = dll
    return lib_


# K18 and K21, which both emitted templates include (and K23, which K18's
# header includes)
_ROWS_SIGNATURES = (
    ("tt_struct_inv_rows", [_P, _P, _LL, _P, _P, _P, _I, _P, _P, _P, _P,
                            _P, _P]),
    ("tt_struct_cert_check", [_P, _P, _LL, _P, _P]),
    ("tt_emitted_expand_sharded", [_P, _P, _LL, _P, _P, _I, _I, _I, _P, _P,
                                   _P, _P, _P, _P, _P]),
    ("tt_struct_canon", [_P, _P, _LL, _P, _P]),
    ("tt_struct_orbit_check", [_P, _P, _P, _LL, _P, _P]),
    ("tt_struct_por_keep", [_P, _LL, _P, _P]),
)


# K32, K34 and K35, in the library of a batched text (ST_BATCHED 1)
_BATCHED_SIGNATURES = (
    ("tt_emitted_expand_batched", [_P, _P, _LL, _P, _I, _I, _I, _P, _P, _P,
                                   _P, _P, _P]),
    ("tt_struct_sim_step_batched", [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                    _P]),
    ("tt_sim_fold_batched", [_I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _I, _I, _P]),
)


def struct_lib(prog):
    """The K17/K18/K21 library of a compiled spec
    (struct.backend.StructProgram; with K23-K28 and K31, and K32, K34 and
    K35 when the program is batched), built from its emitted text at first
    use and loaded once per text."""
    return _emitted_lib(prog.text, "tt_struct_dims", (
        ("tt_struct_expand", [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                              _P, _P]),
        ("tt_struct_sim_step", [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                                _I, _P, _P, _P, _P, _P, _P]),
        ("tt_sim_fold", [_I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P]),
        ("tt_struct_recheck", [_P, _P, _LL, _P, _P, _P]),
        *(_BATCHED_SIGNATURES if getattr(prog, "batched", False) else ()),
        *_ROWS_SIGNATURES),
        (prog.F, prog.W, prog.L, prog.n_inv, prog.n_labels))


def emitted_lib(prog):
    """The library of an emitted program, struct or generic: each exports
    K18 and K21."""
    return gen_lib(prog) if prog.template == "gen_expand.cuh" \
        else struct_lib(prog)


def struct_expand(prog, block: torch.Tensor, n: int, deferred: bool = False,
                  cert: bool = False):
    """K17 -> (packed [ck*L, W] int32, flags [3 + n_inv, ck*L] uint8, action
    [ck*L] int32, gen [n_labels] int64, flat [ck*L, F] int32 in deferred
    mode else None, cert, pruned): cert is the block's 0-dim bool
    certificate with `cert` (immediate mode of a program that carries the
    runtime certificate: the kCert form, K23 inside K17), else None;
    pruned the 0-dim int64 count of the lanes K26 pruned inside K17 when
    the program's text carries the POR flags, else None.  On a text with
    the symmetry plan every candidate comes out canonical (K24 inside
    K17); see struct.backend.StructProgram.expand_plain."""
    if cert and (deferred or prog.cert is None):
        raise ValueError("struct_expand: the certificate runs in the "
                         "immediate mode of a narrowed program")
    ck = block.shape[0]
    _need(block, "block", torch.int32, (ck, prog.W))
    dev = block.device
    ncand = ck * prog.L
    packed = torch.empty(ncand, prog.W, dtype=torch.int32, device=dev)
    flags = torch.empty(3 + prog.n_inv, ncand, dtype=torch.uint8, device=dev)
    action = torch.empty(ncand, dtype=torch.int32, device=dev)
    gen = torch.zeros(prog.n_labels, dtype=torch.int64, device=dev)
    flat = (torch.empty(ncand, prog.F, dtype=torch.int32, device=dev)
            if deferred else None)
    flag = torch.zeros((), dtype=torch.int32, device=dev) if cert else None
    por = prog.por_safe is not None
    pruned = torch.zeros((), dtype=torch.int64, device=dev) if por else None
    K = prog.constants(dev)
    rc = struct_lib(prog).tt_struct_expand(
        _ptr(K), _ptr(block), ck, n, int(deferred), _ptr(packed),
        _ptr(flags), _ptr(action), _ptr(flat) if deferred else None,
        _ptr(gen), _ptr(flag) if cert else None,
        _ptr(pruned) if por else None, _stream())
    _launched("struct_expand", rc)
    _reduce_launched(prog, "struct_expand")
    if cert:
        _cert_launched("struct_expand")
    return (packed, flags, action, gen, flat,
            flag.bool() if cert else None, pruned)


def struct_inv_rows(prog, flat: torch.Tensor, fresh: torch.Tensor,
                    c_idx: torch.Tensor, action, rows: int,
                    cert: bool = False):
    """K18 -> (viol 0-dim int64, state [F] int32, action 0-dim int64); see
    struct.backend.StructProgram.inv_rows_plain.  `prog` is a struct or a
    generic program; action None (received rows) reports -1.  With `cert`
    (a program that carries the runtime certificate: K23 inside K18) a
    fourth output, the fresh claimants' 0-dim bool certificate."""
    if cert and prog.cert is None:
        raise ValueError("struct_inv_rows: the program carries no "
                         "certificate")
    from ..struct.backend import VIOL_INVARIANT_BASE

    ncand = flat.shape[0]
    _need(flat, "flat", torch.int32, (ncand, prog.F))
    n = fresh.shape[0]
    if not 0 < rows <= n:
        raise ValueError(f"rows {rows} outside (0, {n}]")
    _need(fresh, "fresh", torch.bool, (n,))
    _need(c_idx, "c_idx", torch.int64, (n,))
    if action is not None:
        _need(action, "action", torch.int32, (ncand,))
    dev = flat.device
    scratch = torch.full((prog.n_inv + 1,), -1, dtype=torch.int32,
                         device=dev)
    viol = torch.empty((), dtype=torch.int64, device=dev)
    state = torch.empty(prog.F, dtype=torch.int32, device=dev)
    vaction = torch.empty((), dtype=torch.int64, device=dev)
    flag = torch.zeros((), dtype=torch.int32, device=dev) if cert else None
    _launched("struct_inv_rows", emitted_lib(prog).tt_struct_inv_rows(
        _ptr(prog.constants(dev)), _ptr(flat), rows, _ptr(fresh),
        _ptr(c_idx), None if action is None else _ptr(action),
        VIOL_INVARIANT_BASE, _ptr(scratch), _ptr(viol), _ptr(state),
        _ptr(vaction), _ptr(flag) if cert else None, _stream()))
    if not cert:
        return viol, state, vaction
    _cert_launched("struct_inv_rows")
    return viol, state, vaction, flag.bool()


def struct_recheck(prog, words: torch.Tensor):
    """K31 over stored rows words [N, W] int32 (packed under the program's
    codec) -> (bits [N] int32, bit k set where invariant k holds; first
    0-dim int64, the lowest row index whose bits are not all set, N when
    none); see struct.backend.StructProgram.recheck_plain."""
    N = words.shape[0]
    _need(words, "words", torch.int32, (N, prog.W))
    dev = words.device
    bits = torch.empty(N, dtype=torch.int32, device=dev)
    first = torch.full((), N, dtype=torch.int64, device=dev)
    _launched("struct_recheck", struct_lib(prog).tt_struct_recheck(
        _ptr(prog.constants(dev)), _ptr(words), N, _ptr(bits), _ptr(first),
        _stream()))
    return bits, first


def struct_cert_check(prog, rows: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """K23 standalone -> 0-dim bool: some valid row of rows [N, F] int32
    breaks a bound the program's certificate claims; see
    struct.backend.StructProgram.cert_plain.  valid: [N] bool."""
    if prog.cert is None:
        raise ValueError("struct_cert_check: the program carries no "
                         "certificate")
    N = rows.shape[0]
    _need(rows, "rows", torch.int32, (N, prog.F))
    _need(valid, "valid", torch.bool, (N,))
    flag = torch.zeros((), dtype=torch.int32, device=rows.device)
    rc = struct_lib(prog).tt_struct_cert_check(_ptr(rows), _ptr(valid), N,
                                               _ptr(flag), _stream())
    _launched("struct_cert_check", rc)
    CERT_LAUNCHES["struct_cert_check"] += 1
    return flag.bool()


def emitted_expand_sharded(prog, queue: torch.Tensor, qhead: torch.Tensor,
                           npop: torch.Tensor, ck: int,
                           deferred: bool = False, with_block: bool = False):
    """K21 over the pops of all D shards -> (packed [D*ck*L, W] int32,
    flags [3 + n_inv, D*ck*L] uint8, action [D*ck*L] int32, gen [D,
    n_labels] int64, fields [D*ck*L, F] int32, block [D*ck, W] int32 or
    None); see struct.backend.StructProgram.expand_sharded_plain."""
    D, qrows = queue.shape[0], queue.shape[1]
    L, F, W = prog.L, prog.F, prog.W
    _need(queue, "queue", torch.int32, (D, qrows, F))
    _need(qhead, "qhead", torch.int64, (D,))
    _need(npop, "npop", torch.int64, (D,))
    dev = queue.device
    ncand = D * ck * L
    packed = torch.empty(ncand, W, dtype=torch.int32, device=dev)
    flags = torch.empty(3 + prog.n_inv, ncand, dtype=torch.uint8,
                        device=dev)
    action = torch.empty(ncand, dtype=torch.int32, device=dev)
    fields = torch.empty(ncand, F, dtype=torch.int32, device=dev)
    block = (torch.empty(D * ck, W, dtype=torch.int32, device=dev)
             if with_block else None)
    gen = torch.zeros(D, prog.n_labels, dtype=torch.int64, device=dev)
    _launched("emitted_expand_sharded",
              emitted_lib(prog).tt_emitted_expand_sharded(
                  _ptr(prog.constants(dev)), _ptr(queue), qrows, _ptr(qhead),
                  _ptr(npop), D, ck, int(deferred), _ptr(packed),
                  _ptr(flags), _ptr(action), _ptr(fields),
                  None if block is None else _ptr(block), _ptr(gen),
                  _stream()))
    _reduce_launched(prog, "emitted_expand_sharded")
    return packed, flags, action, gen, fields, block


def struct_canon(prog, rows: torch.Tensor) -> torch.Tensor:
    """K24 standalone -> [N, F] int32: the orbit-canonical form of each row
    of rows [N, F] int32; see engine.reduce.ReducePlan.canon."""
    if not prog.sym_programs:
        raise ValueError("struct_canon: the program carries no symmetry "
                         "plan")
    N = rows.shape[0]
    _need(rows, "rows", torch.int32, (N, prog.F))
    out = torch.empty_like(rows)
    _launched("struct_canon", struct_lib(prog).tt_struct_canon(
        _ptr(prog.constants(rows.device)), _ptr(rows), N, _ptr(out),
        _stream()))
    REDUCE_LAUNCHES["struct_canon"]["struct_canon"] += 1
    return out


def struct_orbit_check(prog, block: torch.Tensor,
                       valid: torch.Tensor) -> torch.Tensor:
    """K25 -> 0-dim bool: the first valid candidate of the popped rows
    block [ck, W] int32 (valid: K17's [ck*L] uint8 valid flags), recomputed
    and canonicalized, fails the orbit check; see engine.reduce.
    ReducePlan.orbit_check."""
    if not prog.sym_programs:
        raise ValueError("struct_orbit_check: the program carries no "
                         "symmetry plan")
    ck = block.shape[0]
    _need(block, "block", torch.int32, (ck, prog.W))
    _need(valid, "valid", torch.uint8, (ck * prog.L,))
    flag = torch.zeros((), dtype=torch.int32, device=block.device)
    _launched("struct_orbit_check", struct_lib(prog).tt_struct_orbit_check(
        _ptr(prog.constants(block.device)), _ptr(block), _ptr(valid),
        ck * prog.L, _ptr(flag), _stream()))
    return flag.bool()


def struct_por_keep(prog, valid: torch.Tensor) -> torch.Tensor:
    """K26 standalone -> [B, L] bool: the valid mask [B, L] (bool) after
    the singleton ample-set pruning; see engine.reduce.por_keep."""
    if prog.por_safe is None:
        raise ValueError("struct_por_keep: the program carries no POR "
                         "flags")
    B = valid.shape[0]
    _need(valid, "valid", torch.bool, (B, prog.L))
    keep = torch.empty(B, prog.L, dtype=torch.uint8, device=valid.device)
    _launched("struct_por_keep", struct_lib(prog).tt_struct_por_keep(
        _ptr(valid), B, _ptr(keep), _stream()))
    REDUCE_LAUNCHES["struct_por_keep"]["struct_por_keep"] += 1
    return keep.bool()


def _sim_buffers(prog, buf, W: int) -> None:
    """Check the walk's scratch buffers (sim.engine.SimBuffers) of W
    walkers."""
    from ..sim.engine import scratch_words

    _need(buf.go, "go", torch.int32, (1,))
    _need(buf.scratch, "scratch", torch.int32,
          (scratch_words(prog.n_inv, prog.n_labels),))
    _need(buf.vold, "vold", torch.int32, (W, prog.F))
    _need(buf.vact, "vact", torch.int32, (W,))
    if buf.packed is not None:
        _need(buf.packed, "packed", torch.int32, (W, prog.W))
        _need(buf.take, "take", torch.bool, (W,))


def _opt(t):
    return None if t is None else _ptr(t)


def gen_sim_lib(prog):
    """The walk library of a compiled generic spec (K27 / K28 around its
    emitted step, gen.program.GenProgram.sim_text), built at the first
    walk on the card and loaded once per text."""
    return _emitted_lib(prog.sim_text, "tt_gen_sim_dims", (
        ("tt_struct_sim_step", [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                                _I, _P, _P, _P, _P, _P, _P]),
        ("tt_sim_fold", [_I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P])),
        (prog.F, prog.W, prog.L, prog.n_inv, prog.n_labels))


def _sim_lib(prog):
    """(library, K27's count name, K28's) of a walk program: a generic
    spec's walk library, counted as gen_sim_step / gen_sim_fold, or a
    struct spec's own library."""
    if prog.template == "gen_expand.cuh":
        return gen_sim_lib(prog), "gen_sim_step", "gen_sim_fold"
    return struct_lib(prog), "struct_sim_step", "sim_fold"


def struct_sim_init(prog, buf, key: torch.Tensor, inits: torch.Tensor,
                    states: torch.Tensor) -> None:
    """K27's kInit form, round 0 of the walk: each of the W rows of states
    [W, F] int32 becomes Init vector bits % n0 of inits [n0, F] int32
    (bits the threefry draw of (lane, 0) under key [2] uint32); its
    invariant classes go to buf.scratch, its packed row and a set take flag
    to buf.packed / buf.take when the buffers carry them; see
    struct.backend.StructProgram.sim_init_plain."""
    W, n0 = states.shape[0], inits.shape[0]
    _need(states, "states", torch.int32, (W, prog.F))
    _need(inits, "inits", torch.int32, (n0, prog.F))
    _need(key, "key", torch.uint32, (2,))
    if n0 < 1:
        raise ValueError("struct_sim_init: no Init vector")
    _sim_buffers(prog, buf, W)
    dev = states.device
    lib_, step, _ = _sim_lib(prog)
    _launched(step, lib_.tt_struct_sim_step(
        _ptr(prog.constants(dev)), _ptr(buf.go), _ptr(key), None,
        _ptr(inits), n0, _ptr(states), None, None, W, 1, 0,
        _opt(buf.packed), _opt(buf.take), _ptr(buf.vold), _ptr(buf.vact),
        _ptr(buf.scratch), _stream()))


def struct_sim_step(prog, buf, key: torch.Tensor, step_i: torch.Tensor,
                    states: torch.Tensor, alive: torch.Tensor,
                    steps_taken: torch.Tensor, check_deadlock: bool) -> None:
    """K27, one transition round of the W walkers (a no-op while buf.go is
    0): states [W, F] int32, alive [W] bool and steps_taken [W] int32 are
    updated in place; the block partials go to buf.scratch, the old rows
    and actions of the violating lanes to buf.vold / buf.vact, the packed
    chosen rows and take flags to buf.packed / buf.take when the buffers
    carry them.  key [2] uint32, step_i 0-dim int32 (the round is step_i +
    1).  See struct.backend.StructProgram.sim_step_plain."""
    W = states.shape[0]
    _need(states, "states", torch.int32, (W, prog.F))
    _need(alive, "alive", torch.bool, (W,))
    _need(steps_taken, "steps_taken", torch.int32, (W,))
    _need(key, "key", torch.uint32, (2,))
    _need(step_i, "step_i", torch.int32, ())
    _sim_buffers(prog, buf, W)
    dev = states.device
    lib_, step, _ = _sim_lib(prog)
    _launched(step, lib_.tt_struct_sim_step(
        _ptr(prog.constants(dev)), _ptr(buf.go), _ptr(key), _ptr(step_i),
        None, 0, _ptr(states), _ptr(alive), _ptr(steps_taken), W, 0,
        int(bool(check_deadlock)), _opt(buf.packed), _opt(buf.take),
        _ptr(buf.vold), _ptr(buf.vact), _ptr(buf.scratch), _stream()))


def sim_fold(prog, buf, carry, depth: int, init: bool = False) -> None:
    """K28, one block: fold K27's partials in buf.scratch into the walk
    carry (sim.engine.SimCarry) in place - the first-wins violation, the
    uint32 counters (generated, transitions 0-dim, act_taken [n_labels]),
    step_i - reset the scratch and write buf.go; a no-op while buf.go is 0
    unless `init` (round 0: no counters, step_i stays 0, no action).  See
    struct.backend.StructProgram.sim_fold_plain."""
    from ..struct.backend import VIOL_INVARIANT_BASE

    W = carry.states.shape[0]
    _need(carry.states, "states", torch.int32, (W, prog.F))
    for name in ("step_i", "viol", "viol_lane", "viol_step", "viol_action"):
        _need(getattr(carry, name), name, torch.int32, ())
    _need(carry.viol_state, "viol_state", torch.int32, (prog.F,))
    _need(carry.generated, "generated", torch.uint32, ())
    _need(carry.transitions, "transitions", torch.uint32, ())
    _need(carry.act_taken, "act_taken", torch.uint32, (prog.n_labels,))
    _sim_buffers(prog, buf, W)
    lib_, _, fold = _sim_lib(prog)
    _launched(fold, lib_.tt_sim_fold(
        int(bool(init)), _ptr(buf.go), _ptr(buf.scratch), int(depth),
        VIOL_INVARIANT_BASE, _ptr(carry.step_i), _ptr(carry.viol),
        _ptr(carry.viol_lane), _ptr(carry.viol_step),
        _ptr(carry.viol_state), _ptr(carry.viol_action),
        _ptr(carry.generated), _ptr(carry.transitions),
        _ptr(carry.act_taken), _ptr(carry.states), _ptr(buf.vold),
        _ptr(buf.vact), _stream()))


def gen_lib(prog):
    """The K19/K18/K21 library of a compiled generic spec
    (gen.program.GenProgram), built from its emitted text at first use."""
    return _emitted_lib(prog.text, "tt_gen_dims", (
        ("tt_gen_expand", [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]),
        *_ROWS_SIGNATURES),
        (prog.F, prog.W, prog.L, prog.n_inv, prog.n_labels))


def gen_expand(prog, block: torch.Tensor, n: int, inv: bool = True,
               deadlock: bool = True):
    """K19 -> (packed [ck*L, W] int32, flags [3 + n_inv, ck*L] uint8,
    action [ck*L] int32, gen [n_labels] int64, first [n_inv + 2] int32);
    see gen.program.GenProgram.expand_plain."""
    from ..gen.program import GEN_NONE

    ck = block.shape[0]
    _need(block, "block", torch.int32, (ck, prog.W))
    ncand = ck * prog.L
    if ncand >= GEN_NONE:
        raise ValueError("gen_expand: chunk * lanes must fit 31 bits")
    dev = block.device
    packed = torch.empty(ncand, prog.W, dtype=torch.int32, device=dev)
    flags = torch.empty(3 + prog.n_inv, ncand, dtype=torch.uint8, device=dev)
    action = torch.empty(ncand, dtype=torch.int32, device=dev)
    gen = torch.zeros(prog.n_labels, dtype=torch.int64, device=dev)
    first = torch.full((prog.n_inv + 2,), GEN_NONE, dtype=torch.int32,
                       device=dev)
    _launched("gen_expand", gen_lib(prog).tt_gen_expand(
        _ptr(prog.constants(dev)), _ptr(block), ck, n, int(inv),
        int(deadlock), _ptr(packed), _ptr(flags), _ptr(action), _ptr(gen),
        _ptr(first), _stream()))
    return packed, flags, action, gen, first


def gen_masks_lib(masks):
    """The K20 library of a predicate list (gen.program.GenMasks)."""
    return _emitted_lib(masks.text, "tt_gen_masks_dims", (
        ("tt_gen_state_masks", [_P, _P, _LL, _P, _P]),),
        (masks.F, masks.W, masks.n_pred))


def gen_state_masks(masks, states: torch.Tensor) -> torch.Tensor:
    """K20: the predicate planes [n_pred, V] uint8 of packed states [V, W]
    int32; see gen.program.GenMasks.masks_plain."""
    V = states.shape[0]
    _need(states, "states", torch.int32, (V, masks.W))
    out = torch.empty(masks.n_pred, V, dtype=torch.uint8,
                      device=states.device)
    _launched("gen_state_masks", gen_masks_lib(masks).tt_gen_state_masks(
        _ptr(masks.constants(states.device)), _ptr(states), V, _ptr(out),
        _stream()))
    return out


def struct_cov_lib(cov):
    """The K22 library of a struct spec's coverage conditions
    (struct.backend.StructCoverage)."""
    return _emitted_lib(cov.text, "tt_struct_cov_dims", (
        ("tt_struct_cov_count", [_P, _P, _I, _I, _P, _P, _P]),),
        (cov.F, cov.W, cov.L, cov.M, cov.n_sites, cov.n_labels))


def struct_cov_count(cov, block: torch.Tensor, n: int,
                     valid: torch.Tensor) -> torch.Tensor:
    """K22 -> [n_sites] int32 (uint32 words): the site increments of the
    first n rows of a popped block; see
    struct.backend.StructCoverage.count_plain.  valid: the expand stage's
    [ck * L] uint8 lane flags."""
    ck = block.shape[0]
    _need(block, "block", torch.int32, (ck, cov.W))
    _need(valid, "valid", torch.uint8, (ck * cov.L,))
    out = torch.zeros(cov.n_sites, dtype=torch.int32, device=block.device)
    _launched("struct_cov_count", struct_cov_lib(cov).tt_struct_cov_count(
        _ptr(cov.constants(block.device)), _ptr(block), ck, n, _ptr(valid),
        _ptr(out), _stream()))
    return out


# K29 struct_pred_matrix (its matrix and fold forms) and K30 struct_certify:
# one library per inference program (infer.program.InferProgram), the
# spec's step and the candidate predicates
# ---------------------------------------------------------------------------


def infer_lib(prog):
    """The K29/K30 library of an inference program, built from its emitted
    text at first use and loaded once per text."""
    return _emitted_lib(prog.text, "tt_struct_infer_dims", (
        ("tt_struct_pred_matrix", [_P, _P, _LL, _P, _P]),
        ("tt_struct_pred_alive", [_P, _P, _LL, _P, _P]),
        ("tt_struct_certify", [_P, _P, _LL, _P, _P])),
        (prog.F, prog.L, prog.P))


def _infer_rows(prog, fields: torch.Tensor) -> int:
    if prog.P == 0:
        raise ValueError("an inference program of no candidate launches "
                         "nothing")
    S = fields.shape[0]
    _need(fields, "fields", torch.int32, (S, prog.F))
    return S


def struct_pred_matrix(prog, fields: torch.Tensor) -> torch.Tensor:
    """K29, matrix form -> [P, S] uint8: predicate k on row i of the
    decoded evidence fields [S, F] int32; see
    infer.program.InferProgram.matrix_plain."""
    S = _infer_rows(prog, fields)
    out = torch.empty(prog.P, S, dtype=torch.uint8, device=fields.device)
    _launched("struct_pred_matrix", infer_lib(prog).tt_struct_pred_matrix(
        _ptr(prog.constants(fields.device)), _ptr(fields), S, _ptr(out),
        _stream()))
    return out


def struct_pred_alive(prog, fields: torch.Tensor) -> torch.Tensor:
    """K29, fold form -> [NPW] int32 (uint32 words): bit k % 32 of word
    k // 32 set when predicate k holds on every row of fields [S, F] int32
    (the matrix's all over the rows, never written out); see
    infer.program.InferProgram.alive_plain."""
    S = _infer_rows(prog, fields)
    words = torch.full((prog.NPW,), -1, dtype=torch.int32,
                       device=fields.device)
    _launched("struct_pred_alive", infer_lib(prog).tt_struct_pred_alive(
        _ptr(prog.constants(fields.device)), _ptr(fields), S, _ptr(words),
        _stream()))
    return words


def struct_certify(prog, fields: torch.Tensor) -> torch.Tensor:
    """K30 -> [NPW] int32 (uint32 words): bit k set when some row of
    fields [S, F] int32 satisfies predicate k and has a valid successor
    that does not; see infer.program.InferProgram.certify_plain."""
    S = _infer_rows(prog, fields)
    words = torch.zeros(prog.NPW, dtype=torch.int32, device=fields.device)
    _launched("struct_certify", infer_lib(prog).tt_struct_certify(
        _ptr(prog.constants(fields.device)), _ptr(fields), S, _ptr(words),
        _stream()))
    return words


# ---------------------------------------------------------------------------
# the serving plane's batched kernels: K33 over K stacked tables, K32, K34
# and K35 from each struct spec's library
# ---------------------------------------------------------------------------


def _need_batched(prog) -> None:
    if not prog.batched:
        raise ValueError("a batched kernel needs a batched program (its "
                         "text prints ST_BATCHED 1: serve.sweep."
                         "sweep_backend)")


def fpset_bkey(lo: torch.Tensor, hi: torch.Tensor, mask: torch.Tensor):
    """K33's key stage: mixed, remapped, masked sort keys of any shape
    (int64), elementwise as K3's."""
    _need(lo, "lo", torch.int32, mask.shape)
    _need(hi, "hi", torch.int32, mask.shape)
    _need(mask, "mask", torch.bool)
    key = torch.empty(mask.shape, dtype=torch.int64, device=lo.device)
    _launched("fpset_insert_batched", lib().tt_fpset_bkey(
        _ptr(lo), _ptr(hi), _ptr(mask), mask.numel(), _ptr(key), _stream()))
    return key


def fpset_probe_segment_batched(table: torch.Tensor, keys: torch.Tensor,
                                nreps, off: int, C: int,
                                is_new_out: torch.Tensor, active=None,
                                lanes=None, walk_stats=None) -> None:
    """K33's probe segment over stacked tables ([T, nb, 16] int32): row k's
    ascending keys [K, R] against table lanes[k] ([K] int32; row k's own
    table when None), active where active[k, i] ([K, R] uint8) when given,
    else where off + i < nreps[k] ([K] int64, read on the device).  Writes
    is_new_out [K, R] uint8 and the tables in place: bprobe, bclaim, bwalk
    (one block a row; walk_stats as fpset_walk's stats, summed over the
    rows)."""
    T, nb = table.shape[0], table.shape[1]
    if nb & (nb - 1):
        raise ValueError("table rows must be a power of two")
    _need(table, "table", torch.int32, (T, nb, 16))
    Kl, R = keys.shape
    if lanes is None:
        if Kl != T:
            raise ValueError("without lanes, one key row per table")
    else:
        _need(lanes, "lanes", torch.int32, (Kl,))
    _need(keys, "keys", torch.int64, (Kl, R))
    _need(is_new_out, "is_new", torch.uint8, (Kl, R))
    if active is None:
        _need(nreps, "nreps", torch.int64, (Kl,))
    else:
        _need(active, "active", torch.uint8, (Kl, R))
    lognb = nb.bit_length() - 1
    dev = keys.device
    slot = torch.empty(Kl, R, dtype=torch.int32, device=dev)
    _launched("fpset_insert_batched", lib().tt_fpset_bprobe(
        _ptr(table), lognb, _ptr(keys), Kl, R, _opt(lanes),
        None if active is not None else _ptr(nreps),
        None if active is None else _ptr(active), off, _ptr(slot),
        _stream()))
    cum = None
    if C < R:  # each lane's claims beyond its first C wait for the walk
        cum = torch.cumsum((slot >= 0).to(torch.int64), 1)
    pending = torch.empty_like(is_new_out)
    npend = torch.zeros(Kl, dtype=torch.int32, device=dev)
    _launched("fpset_insert_batched", lib().tt_fpset_bclaim(
        _ptr(table), lognb, _ptr(keys), Kl, R, _opt(lanes), _ptr(slot),
        None if cum is None else _ptr(cum), C, _ptr(is_new_out),
        _ptr(pending), _ptr(npend), _stream()))
    _launched("fpset_insert_batched", lib().tt_fpset_bwalk(
        _ptr(table), lognb, nb - 1, _ptr(keys), Kl, R, _opt(lanes),
        _ptr(pending), _ptr(is_new_out), _ptr(npend), _walk_stats(walk_stats),
        _stream()))


def emitted_expand_batched(prog, queue: torch.Tensor, pop: torch.Tensor,
                           C: int, deferred: bool = False):
    """K32 over the stacked queue [K, 2, qrows, W] int32 at each lane's pop
    (pop [K, 4] int64: parity, qhead, n, ck; ck = 0 freezes the lane):
    (packed [K, C*L, W] int32, flags [K, (3 + n_inv) * C*L] uint8, action
    [K, C*L] int32, gen [K, n_labels] int64, flat [K, C*L, F] int32 in the
    deferred mode else None).  Lane k's slab holds K17's outputs at width
    ck (batched.lane_view cuts them); see
    struct.backend.StructProgram.expand_batched_plain."""
    _need_batched(prog)
    if prog.cert is not None or prog.plan is not None or \
            prog.por_safe is not None:
        raise ValueError("emitted_expand_batched: a batched class carries "
                         "no certificate and no reduction")
    Kl, _, qrows, W = queue.shape
    _need(queue, "queue", torch.int32, (Kl, 2, qrows, prog.W))
    _need(pop, "pop", torch.int64, (Kl, 4))
    dev = queue.device
    n = C * prog.L
    packed = torch.empty(Kl, n, prog.W, dtype=torch.int32, device=dev)
    flags = torch.empty(Kl, (3 + prog.n_inv) * n, dtype=torch.uint8,
                        device=dev)
    action = torch.empty(Kl, n, dtype=torch.int32, device=dev)
    gen = torch.zeros(Kl, prog.n_labels, dtype=torch.int64, device=dev)
    flat = (torch.empty(Kl, n, prog.F, dtype=torch.int32, device=dev)
            if deferred else None)
    _launched("emitted_expand_batched",
              struct_lib(prog).tt_emitted_expand_batched(
                  _ptr(prog.constants(dev)), _ptr(queue), qrows, _ptr(pop),
                  Kl, C, int(deferred), _ptr(packed), _ptr(flags),
                  _ptr(action), _opt(flat), _ptr(gen), _stream()))
    return packed, flags, action, gen, flat


def struct_sim_step_batched(prog, buf, carry, check_deadlock: bool,
                            init: bool = False, inits=None, n0=None) -> None:
    """K34, one round of every batch lane's W walkers (the identity on a
    lane whose buf.go is 0), or with `init` round 0 over each lane's Init
    vectors (inits [K, n0max, F] int32, n0 [K] int32).  `carry` and `buf`
    are sim.engine's stacked BatchSimCarry and batched SimBuffers; see
    struct.backend.StructProgram.sim_step_batched_plain."""
    _need_batched(prog)
    Kl, W = carry.states.shape[:2]
    _need(carry.states, "states", torch.int32, (Kl, W, prog.F))
    _need(carry.key, "key", torch.uint32, (Kl, 2))
    _need(carry.step_i, "step_i", torch.int32, (Kl,))
    _need(carry.alive, "alive", torch.bool, (Kl, W))
    _need(carry.steps_taken, "steps_taken", torch.int32, (Kl, W))
    _need(buf.go, "go", torch.int32, (Kl,))
    _need(buf.vold, "vold", torch.int32, (Kl, W, prog.F))
    _need(buf.vact, "vact", torch.int32, (Kl, W))
    if buf.packed is not None:
        _need(buf.packed, "packed", torch.int32, (Kl, W, prog.W))
        _need(buf.take, "take", torch.bool, (Kl, W))
    n0max = 0
    if init:
        n0max = inits.shape[1]
        _need(inits, "inits", torch.int32, (Kl, n0max, prog.F))
        _need(n0, "n0", torch.int32, (Kl,))
    dev = carry.states.device
    _launched("struct_sim_step_batched",
              struct_lib(prog).tt_struct_sim_step_batched(
                  _ptr(prog.constants(dev)), _ptr(buf.go), _ptr(carry.key),
                  _ptr(carry.step_i), _opt(inits), n0max, _opt(n0),
                  _ptr(carry.states), _ptr(carry.alive),
                  _ptr(carry.steps_taken), W, Kl, int(bool(init)),
                  int(bool(check_deadlock)), _opt(buf.packed),
                  _opt(buf.take), _ptr(buf.vold), _ptr(buf.vact),
                  _ptr(buf.scratch), _stream()))


def sim_fold_batched(prog, buf, carry, depth: int,
                     init: bool = False) -> None:
    """K35, one block a batch lane: K28's fold of each lane's scratch into
    its slice of the stacked carry, in place; see
    struct.backend.StructProgram.sim_fold_batched_plain."""
    from ..struct.backend import VIOL_INVARIANT_BASE

    _need_batched(prog)
    Kl, W = carry.states.shape[:2]
    for name in ("step_i", "viol", "viol_lane", "viol_step", "viol_action"):
        _need(getattr(carry, name), name, torch.int32, (Kl,))
    _need(carry.viol_state, "viol_state", torch.int32, (Kl, prog.F))
    _need(carry.generated, "generated", torch.uint32, (Kl,))
    _need(carry.transitions, "transitions", torch.uint32, (Kl,))
    _need(carry.act_taken, "act_taken", torch.uint32, (Kl, prog.n_labels))
    _launched("sim_fold_batched", struct_lib(prog).tt_sim_fold_batched(
        int(bool(init)), _ptr(buf.go), _ptr(buf.scratch), int(depth),
        VIOL_INVARIANT_BASE, _ptr(carry.step_i), _ptr(carry.viol),
        _ptr(carry.viol_lane), _ptr(carry.viol_step),
        _ptr(carry.viol_state), _ptr(carry.viol_action),
        _ptr(carry.generated), _ptr(carry.transitions),
        _ptr(carry.act_taken), _ptr(carry.states), _ptr(buf.vold),
        _ptr(buf.vact), W, Kl, _stream()))


# ---------------------------------------------------------------------------
# K39 kube_sim_step, K40 kube_sim_fold: the random walk over the KubeAPI
# spec (kube_sim.cu)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kube_sim_dims() -> tuple:
    got = (ctypes.c_int * 3)()
    lib().tt_kube_sim_dims(got)
    return tuple(got)


def _kube_walk(walk, buf, W: int) -> np.ndarray:
    """The layout words of a KubeAPI walk program (sim.kube.KubeWalk),
    its buffers of W walkers checked against the library's scratch."""
    from ..sim.engine import scratch_words

    words, n_cls, n_labels = _kube_sim_dims()
    if (words, n_cls, n_labels) != (
            scratch_words(walk.n_inv, walk.n_labels), walk.n_inv + 3,
            walk.n_labels):
        raise RuntimeError(f"kube_sim library dims {(words, n_cls, n_labels)}"
                           f" do not match the walk's")
    _sim_buffers(walk, buf, W)
    return _layout(walk.cfg)


def kube_sim_init(walk, buf, key: torch.Tensor, inits: torch.Tensor,
                  states: torch.Tensor) -> None:
    """K39's kInit form, round 0 of a KubeAPI walk: each of the W rows of
    states [W, F] int32 becomes Init vector bits % n0 of inits [n0, F]
    int32 (bits the threefry draw of (lane, 0) under key [2] uint32); its
    invariant classes go to buf.scratch, its packed row and a set take flag
    to buf.packed / buf.take when the buffers carry them; see
    sim.plain.WalkPlain.sim_init_plain."""
    W, n0 = states.shape[0], inits.shape[0]
    _need(states, "states", torch.int32, (W, walk.F))
    _need(inits, "inits", torch.int32, (n0, walk.F))
    _need(key, "key", torch.uint32, (2,))
    if n0 < 1:
        raise ValueError("kube_sim_init: no Init vector")
    lay = _kube_walk(walk, buf, W)
    _launched("kube_sim_step", lib().tt_kube_sim_step(
        lay.ctypes.data_as(_P), _ptr(buf.go), _ptr(key), None, _ptr(inits),
        n0, _ptr(states), None, None, W, 1, 0, _opt(buf.packed),
        _opt(buf.take), _ptr(buf.vold), _ptr(buf.vact), _ptr(buf.scratch),
        _stream()))


def kube_sim_step(walk, buf, key: torch.Tensor, step_i: torch.Tensor,
                  states: torch.Tensor, alive: torch.Tensor,
                  steps_taken: torch.Tensor, check_deadlock: bool) -> None:
    """K39, one transition round of the W walkers of a KubeAPI walk (a
    no-op while buf.go is 0): states [W, F] int32, alive [W] bool and
    steps_taken [W] int32 are updated in place; the block partials go to
    buf.scratch, the old rows and actions of the violating walkers to
    buf.vold / buf.vact, the packed chosen rows and take flags to
    buf.packed / buf.take when the buffers carry them.  key [2] uint32,
    step_i 0-dim int32 (the round is step_i + 1).  See
    sim.plain.WalkPlain.sim_step_plain."""
    W = states.shape[0]
    _need(states, "states", torch.int32, (W, walk.F))
    _need(alive, "alive", torch.bool, (W,))
    _need(steps_taken, "steps_taken", torch.int32, (W,))
    _need(key, "key", torch.uint32, (2,))
    _need(step_i, "step_i", torch.int32, ())
    lay = _kube_walk(walk, buf, W)
    _launched("kube_sim_step", lib().tt_kube_sim_step(
        lay.ctypes.data_as(_P), _ptr(buf.go), _ptr(key), _ptr(step_i), None,
        0, _ptr(states), _ptr(alive), _ptr(steps_taken), W, 0,
        int(bool(check_deadlock)), _opt(buf.packed), _opt(buf.take),
        _ptr(buf.vold), _ptr(buf.vact), _ptr(buf.scratch), _stream()))


def kube_sim_fold(walk, buf, carry, depth: int, init: bool = False) -> None:
    """K40, one block: fold K39's partials in buf.scratch into the walk
    carry (sim.engine.SimCarry) in place - the first-wins violation
    (TypeOK, OnlyOneVersion, the assertion, deadlock, the slot overflow),
    the uint32 counters, step_i - reset the scratch and write buf.go; a
    no-op while buf.go is 0 unless `init`.  See
    sim.plain.WalkPlain.sim_fold_plain."""
    W = carry.states.shape[0]
    _need(carry.states, "states", torch.int32, (W, walk.F))
    for name in ("step_i", "viol", "viol_lane", "viol_step", "viol_action"):
        _need(getattr(carry, name), name, torch.int32, ())
    _need(carry.viol_state, "viol_state", torch.int32, (walk.F,))
    _need(carry.generated, "generated", torch.uint32, ())
    _need(carry.transitions, "transitions", torch.uint32, ())
    _need(carry.act_taken, "act_taken", torch.uint32, (walk.n_labels,))
    _kube_walk(walk, buf, W)
    _launched("kube_sim_fold", lib().tt_kube_sim_fold(
        int(bool(init)), walk.F, _ptr(buf.go), _ptr(buf.scratch), int(depth),
        _ptr(carry.step_i), _ptr(carry.viol), _ptr(carry.viol_lane),
        _ptr(carry.viol_step), _ptr(carry.viol_state),
        _ptr(carry.viol_action), _ptr(carry.generated),
        _ptr(carry.transitions), _ptr(carry.act_taken), _ptr(carry.states),
        _ptr(buf.vold), _ptr(buf.vact), _stream()))
