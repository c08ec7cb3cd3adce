"""KubeAPI backend and the expand stage of a BFS step (port of
jaxtlc/engine/backend.py:135-322 and :432-477, immediate mode).

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
yardstick the kernel is held against on the card).
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
from .fingerprint import fp64_words

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


def expand_plain(cfg: ModelConfig, block: torch.Tensor, n: int):
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
    bits = make_invariant_kernel(cfg)(flat)
    flags = torch.stack([
        fvalid, afail.reshape(-1), ovf.reshape(-1),
        fvalid & ((bits & 1) == 0), fvalid & ((bits & 2) == 0),
    ]).to(torch.uint8)
    return (cdc.pack(flat), flags, action.reshape(-1),
            gen_counts(cfg, batch, valid))


def expand_block(cfg: ModelConfig, block: torch.Tensor, n: int):
    """Expand the first n rows of a popped block ([ck, W] int32): kernel
    K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if not block.is_cuda:
        return expand_plain(cfg, block, n)
    from ..kernels import ops

    return ops.expand(cfg, block, n)


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


def make_expand_stage(backend: SpecBackend, chunk: int):
    """expand(block [chunk, W] int32, n) -> ExpandOut: kernel K1, the
    deadlock mask, fingerprints (kernel K2) and the first-wins violation
    (TypeOK > OnlyOneVersion > assert > deadlock > slot overflow).

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
        packed, flags, action, gen = expand_block(cfg, block, n)
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
        words = torch.stack([
            packed[lane_first[0]], packed[lane_first[1]],
            block[lane_first[2] // L], block[d_first], block[lane_first[3] // L],
        ])
        acts = torch.stack([
            action[lane_first[0]], action[lane_first[1]], action[lane_first[2]],
            torch.full((), -1, dtype=torch.int32, device=dev),
            action[lane_first[3]],
        ]).to(torch.int64)
        k = hits.to(torch.uint8).argmax()
        hit = hits.any()
        lo, hi = fp64_words(packed, nbits)
        return ExpandOut(
            packed=packed, lo=lo, hi=hi, valid=valid, action=action, gen=gen,
            viol=torch.where(hit, k + 1, OK),
            viol_words=words[k],
            viol_action=torch.where(hit, acts[k], -1),
        )

    return expand


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
