"""KubeAPI backend, the expand stage of a BFS step and the deferred
invariant checker (port of jaxtlc/engine/backend.py:135-477).

``expand_block`` is the wrapper of kernel K1 (torchtlc/kernels/csrc/
expand.cu): one launch replaces the reference's unpack -> next-state
kernel -> canonicalize -> invariants -> pack chain plus the per-action
generated counters.  For a popped block of ``ck`` packed rows it returns,
per candidate lane (``ck * L`` of them, lane-major within a row):

* ``packed [ck*L, W]`` int32 - the canonical successor, packed;
* ``flags [5, ck*L]`` uint8 - rows FLAG_VALID, FLAG_AFAIL, FLAG_OVF,
  FLAG_BAD_TYPEOK, FLAG_BAD_ONLYONE (each already masked by validity,
  and validity by the pop mask);
* ``action [ck*L]`` int32 - the acting label id;
* ``gen [n_labels]`` int64 - generated successors per action.

``expand_plain`` is the same function in torch (the CPU path, and the
yardstick the kernel is held against on the card).  ``deferred=True`` (the
reference's mode at chunk >= 2048) skips the invariants there: the flag
rows FLAG_BAD_TYPEOK and FLAG_BAD_ONLYONE stay zero, and the commit stage
runs ``deferred_check`` (kernel K7, torchtlc/kernels/csrc/deferred.cu) on
the fresh-insert claimants instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelConfig
from ..spec.codec import get_codec
from ..spec.invariants import make_invariant_kernel
from ..spec.kernel import initial_vectors, lane_layout, make_kernel
from ..spec.labels import LABEL_ID, LABELS
from .fingerprint import DEFAULT_FP_INDEX, fp64_words

# violation codes (jaxtlc/engine/bfs.py:53-61)
OK = 0
VIOL_TYPEOK = 1
VIOL_ONLYONEVERSION = 2
VIOL_ASSERT = 3
VIOL_DEADLOCK = 4
VIOL_SLOT_OVERFLOW = 5
VIOL_FPSET_FULL = 6
VIOL_QUEUE_FULL = 7

FLAG_VALID, FLAG_AFAIL, FLAG_OVF, FLAG_BAD_TYPEOK, FLAG_BAD_ONLYONE = range(5)


class SpecBackend(NamedTuple):
    """What the engine needs from the KubeAPI frontend (the fields of the
    reference SpecBackend that KubeAPI uses)."""

    cfg: ModelConfig
    cdc: object  # Codec
    n_lanes: int
    inv_codes: tuple  # invariant bit k failing reports this code
    initial_vectors: object  # () -> [n0, F] numpy int32
    labels: tuple  # action id -> display name


def kubeapi_backend(cfg: ModelConfig) -> SpecBackend:
    cdc = get_codec(cfg)
    return SpecBackend(
        cfg=cfg,
        cdc=cdc,
        n_lanes=lane_layout(cfg)[1],
        inv_codes=(VIOL_TYPEOK, VIOL_ONLYONEVERSION),
        initial_vectors=lambda: initial_vectors(cfg),
        labels=LABELS,
    )


def gen_counts(cfg: ModelConfig, batch: torch.Tensor, valid: torch.Tensor):
    """Per-action generated counters through the dispatch structure: every
    lane of client ci fires ci's current pc label; server lanes are
    APIStart.  batch [ck, F] fields, valid [ck, L] -> [n_labels] int64."""
    cdc = get_codec(cfg)
    CL, _ = lane_layout(cfg)
    nc = cdc.nc
    pc_off = cdc.offsets["pc"]
    counts = torch.zeros(len(LABELS), dtype=torch.int64, device=batch.device)
    for ci in range(nc):
        vc = valid[:, ci * CL:(ci + 1) * CL].sum(1)
        pc = batch[:, pc_off + ci].to(torch.int64)
        inside = pc < len(LABELS)
        counts.index_add_(0, torch.where(inside, pc, 0), vc * inside)
    counts[LABEL_ID["APIStart"]] += valid[:, nc * CL:].sum()
    return counts


def expand_plain(cfg: ModelConfig, block: torch.Tensor, n: int,
                 deferred: bool = False):
    """Torch version of kernel K1: (packed, flags, action, gen)."""
    cdc = get_codec(cfg)
    ck = block.shape[0]
    batch = cdc.unpack(block)
    succ, valid, action, afail, ovf = make_kernel(cfg)(batch)
    mask = torch.arange(ck, device=block.device) < n
    valid = valid & mask[:, None]
    afail = afail & valid
    ovf = ovf & valid
    flat = succ.reshape(-1, cdc.n_fields)
    fvalid = valid.reshape(-1)
    if deferred:  # every invariant holds until the deferred check
        bits = torch.full_like(fvalid, 3, dtype=torch.int32)
    else:
        bits = make_invariant_kernel(cfg)(flat)
    flags = torch.stack([
        fvalid, afail.reshape(-1), ovf.reshape(-1),
        fvalid & ((bits & 1) == 0), fvalid & ((bits & 2) == 0),
    ]).to(torch.uint8)
    return (cdc.pack(flat), flags, action.reshape(-1),
            gen_counts(cfg, batch, valid))


def expand_block(cfg: ModelConfig, block: torch.Tensor, n: int,
                 deferred: bool = False):
    """Expand the first n rows of a popped block ([ck, W] int32): kernel
    K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if not block.is_cuda:
        return expand_plain(cfg, block, n, deferred)
    from ..kernels import ops

    return ops.expand(cfg, block, n, deferred)


class ExpandOut(NamedTuple):
    """Output of the expand stage: what the commit stage needs."""

    packed: torch.Tensor  # [ck*L, W] int32
    lo: torch.Tensor  # [ck*L] int32 fingerprint low words
    hi: torch.Tensor  # [ck*L] int32
    valid: torch.Tensor  # [ck*L] bool
    action: torch.Tensor  # [ck*L] int32
    gen: torch.Tensor  # [n_labels] int64
    viol: torch.Tensor  # 0-dim int64: first-wins expand-stage violation
    viol_words: torch.Tensor  # [W] int32: its state, packed
    viol_action: torch.Tensor  # 0-dim int64
    block: torch.Tensor  # [chunk, W] int32: the popped rows (deferred check)


def make_expand_stage(backend: SpecBackend, chunk: int,
                      deferred: bool = False,
                      fp_index: int = DEFAULT_FP_INDEX):
    """expand(block [chunk, W] int32, n) -> ExpandOut: kernel K1, the
    deadlock mask, fingerprints (kernel K2) and the first-wins violation
    (TypeOK > OnlyOneVersion > assert > deadlock > slot overflow; with
    deferred=True the invariants are not evaluated here, so the reduce
    covers assert > deadlock > slot overflow).

    The violating state is carried packed (viol_words); the engine unpacks
    it on the host once a violation is read back."""
    cfg = backend.cfg
    cdc = backend.cdc
    L = backend.n_lanes
    nbits = cdc.nbits
    # the reduce below stacks its candidates in code order
    assert (VIOL_TYPEOK, VIOL_ONLYONEVERSION, VIOL_ASSERT, VIOL_DEADLOCK,
            VIOL_SLOT_OVERFLOW) == (1, 2, 3, 4, 5)

    def expand(block: torch.Tensor, n: int) -> ExpandOut:
        dev = block.device
        packed, flags, action, gen = expand_block(cfg, block, n, deferred)
        valid = flags[FLAG_VALID].bool()
        # deadlock: a popped state with no valid successor (TLC's
        # -deadlock check, always on for KubeAPI)
        dead = ~valid.view(chunk, L).any(1)
        dead[n:] = False
        # first hit per mask, in priority order
        lane_masks = flags[[FLAG_BAD_TYPEOK, FLAG_BAD_ONLYONE, FLAG_AFAIL,
                            FLAG_OVF]]
        lane_first = lane_masks.argmax(1)
        lane_any = lane_masks.amax(1) > 0
        d_first = dead.to(torch.uint8).argmax()
        hits = torch.stack([lane_any[0], lane_any[1], lane_any[2],
                            dead.any(), lane_any[3]])
        # gathers with 1-D device indices: indexing with a 0-dim CUDA
        # tensor would read it back to the host
        words = torch.cat([
            packed.index_select(0, lane_first[:2]),
            block.index_select(0, torch.stack([
                lane_first[2] // L, d_first, lane_first[3] // L])),
        ])
        acts = torch.cat([
            action.index_select(0, lane_first[:3]),
            torch.full((1,), -1, dtype=torch.int32, device=dev),
            action.index_select(0, lane_first[3:]),
        ]).to(torch.int64)
        k = hits.to(torch.uint8).argmax().view(1)
        hit = hits.any()
        lo, hi = fp64_words(packed, nbits, fp_index)
        return ExpandOut(
            packed=packed, lo=lo, hi=hi, valid=valid, action=action, gen=gen,
            viol=torch.where(hit, k[0] + 1, OK),
            viol_words=words.index_select(0, k)[0],
            viol_action=torch.where(hit, acts.index_select(0, k)[0], -1),
            block=block,
        )

    return expand


# ---------------------------------------------------------------------------
# deferred invariants on the fresh-insert claimants (kernel K7)
# ---------------------------------------------------------------------------


def deferred_check_plain(cfg: ModelConfig, block: torch.Tensor,
                         fresh: torch.Tensor, c_idx: torch.Tensor,
                         action: torch.Tensor, rows: int):
    """Torch version of kernel K7: the invariants of the fresh claimants
    among the first `rows` rows of an insert's (is_new_c, c_idx), each
    candidate's raw successor derived again from its popped source row
    (lane // L) and lane (lane % L).  First wins across TypeOK,
    OnlyOneVersion; within a code the highest violating lane.  Returns
    (viol 0-dim int64, state [F] int32 raw successor fields, action 0-dim
    int64); (OK, zeros, -1) when every fresh claimant passes."""
    cdc = get_codec(cfg)
    _, L = lane_layout(cfg)
    dev = block.device
    lanes = c_idx[:rows][fresh[:rows].bool()]
    viol, state, vaction = OK, torch.zeros(cdc.n_fields, dtype=torch.int32,
                                            device=dev), -1
    if lanes.numel():
        succ = make_kernel(cfg)(cdc.unpack(block[lanes // L]))[0]
        flat = succ[torch.arange(lanes.numel(), device=dev), lanes % L]
        bits = make_invariant_kernel(cfg)(flat)
        for k, code in enumerate((VIOL_TYPEOK, VIOL_ONLYONEVERSION)):
            bad = (bits & (1 << k)) == 0
            if bad.any():
                j = int(torch.argmax(torch.where(bad, lanes, -1)))
                viol, state = code, flat[j].to(torch.int32)
                vaction = int(action[lanes[j]])
                break

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    return i64(viol), state, i64(vaction)


def deferred_check(cfg: ModelConfig, block, fresh, c_idx, action,
                   rows: int):
    """Kernel K7 on CUDA tensors, the plain version on CPU tensors."""
    if not block.is_cuda:
        return deferred_check_plain(cfg, block, fresh, c_idx, action, rows)
    from ..kernels import ops

    return ops.deferred_check(cfg, block, fresh, c_idx, action, rows)


def make_deferred_checker(backend: SpecBackend):
    """The commit-stage invariant check over the fresh-insert claimants
    (jaxtlc/engine/backend.py:325).  TLC checks a state when it is first
    generated, and first generation is the fresh insert, so the verdict is
    the immediate mode's; the reported state is the violating fresh
    claimant with the HIGHEST candidate lane (the reference's pinned
    attribution rule).  KubeAPI has no certificate check.

    Returns check(block [ck, W], action [ck*L], is_new_c, c_idx, rows) ->
    (viol, viol_state [F], viol_action); `rows` bounds the rows that can
    be fresh (R on the slab path, the whole batch on the sorted one)."""
    cfg = backend.cfg
    assert backend.inv_codes == (VIOL_TYPEOK, VIOL_ONLYONEVERSION)

    def check(block, action, is_new_c, c_idx, rows: int):
        return deferred_check(cfg, block, is_new_c, c_idx, action, rows)

    return check


def kernel_layout(cfg: ModelConfig) -> np.ndarray:
    """The Layout struct K1 takes (kubeapi.cuh), as int32 words in the
    header's field order."""
    from ..config import RECONCILER

    cdc = get_codec(cfg)
    CL, L = lane_layout(cfg)
    MAXC, MAXI, MAXF = 8, 16, 96
    assert cdc.nc <= MAXC and cdc.ni <= MAXI and cdc.n_fields <= MAXF, (
        "config exceeds the expand kernel's compiled bounds")
    O = cdc.offsets
    mut = {"": 0, "delete_noop": 1, "sticky_reconcile": 2}[cfg.mutation]

    def obj_word(i):
        return (1 << cdc.o_present) | (i << cdc.o_ident)

    role, secret_w, pvc_w, secret_kind, sr_idx = [], [], [], [], []
    for ci in range(cdc.nc):
        if cfg.roles[ci] == RECONCILER:
            si, pi = cfg.targets[ci]
            role.append(0)
            secret_w.append(obj_word(si))
            pvc_w.append(obj_word(pi))
            secret_kind.append(cdc.kind_id[cfg.identities[si][0]])
            sr_idx.append(cfg.sr_index(ci))
        else:
            role.append(1)
            secret_w.append(0)
            pvc_w.append(0)
            secret_kind.append(0)
            sr_idx.append(0)

    def pad(xs, n):
        return list(xs) + [0] * (n - len(xs))

    words = [
        cdc.ni, cdc.nc, cdc.ls, cdc.nr, cdc.ib, cdc.kb, cdc.lb, len(cfg.kinds),
        cdc.o_spec, cdc.o_vv, cdc.o_hasvv, cdc.o_ident, cdc.o_present,
        cdc.obj_bits,
        cdc.r_obj, cdc.r_status, cdc.r_op, cdc.r_present,
        cdc.lm_status, cdc.lm_kind, cdc.lm_present,
        cdc.s_retpc, cdc.s_proc, cdc.s_present,
        cdc.n_fields, cdc.n_words, cdc.nbits, CL, L,
        int(cfg.requests_can_fail), int(cfg.requests_can_timeout), mut,
        cdc.kind_id.get("PVC", -1),
        O["api"], O["req"], O["lreq_meta"], O["lreq_obj"], O["pc"],
        O["stack"], O["p_op"], O["p_obj"], O["p_kind"], O["sr"],
        *pad(cdc.lane_widths, MAXF),
        *pad(role, MAXC), *pad(secret_w, MAXC), *pad(pvc_w, MAXC),
        *pad(secret_kind, MAXC), *pad(sr_idx, MAXC),
        *pad([cdc.kind_id[k] for k, _ in cfg.identities], MAXI),
    ]
    return np.asarray(words, dtype=np.int32)
