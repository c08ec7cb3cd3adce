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
           "verdict_fold", "shard_enqueue")
LAUNCHES = {name: 0 for name in KERNELS}

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
                                _P]),
    "tt_fpset_member": ("fpset", [_P, _I, ctypes.c_uint, _P, _P, _P, _LL,
                                  _LL, _P, _P]),
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
                             _I, _P]),
    "tt_route_scatter": ("route", [_P, _P, _P, _P, _LL, _I, _I, _I, _P, _P,
                                   _P, _P, _P, _P, _P, _P, _P, _P, _P]),
    "tt_verdict_fold": ("route", [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I,
                                  _I, _I, _P, _P, _P, _P]),
    "tt_shard_enqueue": ("route", [_P, _LL, _I, _P, _P, _P, _P, _P, _P, _LL,
                                   _I, _I, _P]),
}


class _Lib:
    def __init__(self, info: _build.BuildInfo):
        self.info = info
        dlls = {stem: ctypes.CDLL(path) for stem, path in info.libs.items()}
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
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def fpset_walk(table: torch.Tensor, keys: torch.Tensor, pending: torch.Tensor,
               is_new: torch.Tensor, npend: torch.Tensor) -> None:
    """Settle the npend pending stragglers (one block, no host round
    trip); updates table, pending and is_new in place."""
    nb, lognb = _table_geom(table)
    R = keys.shape[0]
    _need(keys, "keys", torch.int64, (R,))
    _need(pending, "pending", torch.uint8, (R,))
    _need(is_new, "is_new", torch.uint8, (R,))
    _need(npend, "npend", torch.int32, (1,))
    _launched("fpset_walk", lib().tt_fpset_walk(
        _ptr(table), lognb, nb - 1, _ptr(keys), R, _ptr(pending),
        _ptr(is_new), _ptr(npend), _stream()))


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
             entry: bool = False) -> None:
    """One ring row; see obs.counters.ring_row_plain (spill_new and
    spill_old, cov_new and cov_old: both or neither; entry writes the
    counters as they were before the body)."""
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
    _launched("ring_row", lib().tt_ring_row(
        _ptr(ring), slots, cols, _ptr(head), _ptr(bodies), _ptr(expanded),
        n_pop, int(flip), _ptr(level), _ptr(gen_new), _ptr(gen_old),
        _ptr(dist_new), _ptr(dist_old), _ptr(queue_n), _ptr(act_gen),
        _ptr(act_dist), _ptr(acts_old),
        None if spill_new is None else _ptr(spill_new),
        None if spill_old is None else _ptr(spill_old), n_acts, n_labels,
        None if cov_new is None else _ptr(cov_new),
        None if cov_old is None else _ptr(cov_old), n_cov, int(entry),
        _stream()))


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
    """K11 over every source shard (its two grid launches, route_count and
    route_scatter, count as one): hi, lo [D*ncand] int32, valid [D*ncand]
    uint8, fields [D*ncand, F] int32; `out` (engine.sharded.RouteOut)
    receives the sorted-order words and the exchange planes - xvalid and
    route_ovf are zeroed here first.  See engine.sharded.route_plain."""
    N = hi.shape[0]
    if N % D:
        raise ValueError("lanes must split evenly over the shards")
    ncand = N // D
    F = fields.shape[1]
    _need(hi, "hi", torch.int32, (N,))
    _need(lo, "lo", torch.int32, (N,))
    _need(valid, "valid", torch.uint8, (N,))
    _need(fields, "fields", torch.int32, (N, F))
    for name, dt, shape in (
            ("order", torch.int32, (D, ncand)),
            ("s_own", torch.int32, (D, ncand)),
            ("s_pos", torch.int32, (D, ncand)),
            ("s_valid", torch.bool, (D, ncand)),
            ("xrows", torch.int32, (D, D, B, F)),
            ("xlo", torch.int32, (D, D, B)), ("xhi", torch.int32, (D, D, B)),
            ("xvalid", torch.bool, (D, D, B)),
            ("route_ovf", torch.bool, (D,))):
        _need(getattr(out, name), name, dt, shape)
    out.xvalid.zero_()
    out.route_ovf.zero_()
    ntiles = -(-ncand // 1024)
    counts = torch.empty(D, ntiles, D + 1, dtype=torch.int32,
                         device=hi.device)
    rc = lib().tt_route_scatter(
        _ptr(hi), _ptr(lo), _ptr(valid), _ptr(fields), ncand, D, B, F,
        _ptr(counts), _ptr(out.order), _ptr(out.s_own), _ptr(out.s_pos),
        _ptr(out.s_valid), _ptr(out.xrows), _ptr(out.xlo), _ptr(out.xhi),
        _ptr(out.xvalid), _ptr(out.route_ovf), _stream())
    _launched("route_scatter", rc)


def verdict_fold(verd, s_own, s_pos, s_valid, order, faction, npop, chunk: int,
                 L: int, n_labels: int, outdeg, act_dist) -> None:
    """K12: fold every source shard's verdicts (verd [D, D, B] uint8, the
    owners' is_new buckets) into outdeg [D, L+2] and act_dist [D, n_labels+1]
    (int64, in place); see engine.sharded.verdict_fold_plain."""
    D, _, B = verd.shape
    ncand = s_own.shape[1]
    _need(verd, "verd", torch.uint8, (D, D, B))
    for name, t, dt in (("s_own", s_own, torch.int32),
                        ("s_pos", s_pos, torch.int32),
                        ("s_valid", s_valid, torch.bool),
                        ("order", order, torch.int32),
                        ("faction", faction, torch.int32)):
        _need(t, name, dt, (D, ncand))
    _need(npop, "npop", torch.int64, (D,))
    _need(outdeg, "outdeg", torch.int64, (D, L + 2))
    _need(act_dist, "act_dist", torch.int64, (D, n_labels + 1))
    rowdeg = torch.zeros(D * chunk + 1, dtype=torch.int32, device=verd.device)
    _launched("verdict_fold", lib().tt_verdict_fold(
        _ptr(verd), _ptr(s_own), _ptr(s_pos), _ptr(s_valid), _ptr(order),
        _ptr(faction), _ptr(npop), ncand, D, B, chunk, L, n_labels,
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
