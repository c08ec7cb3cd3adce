"""Plain batched invariant bits: TypeOK + OnlyOneVersion (port of
jaxtlc/spec/invariants.py:31-88).

``check(vecs [B, F] int32) -> ok_bits [B] int32``: bit 0 is TypeOK
(KubeAPI.tla:776-781), bit 1 OnlyOneVersion (KubeAPI.tla:787-789); a set
bit means the invariant HOLDS.  The expand kernel (K1) evaluates the same
predicates per successor lane (kubeapi.cuh: kube_invariants).
"""

from __future__ import annotations

import functools

import torch

from ..config import ModelConfig
from .codec import get_codec

INT32_MIN = -(1 << 31)


@functools.lru_cache(maxsize=None)
def make_invariant_kernel(cfg: ModelConfig):
    cdc = get_codec(cfg)
    ni = cdc.ni
    n_kinds = len(cfg.kinds)
    ident_kind_list = [cdc.kind_id[k] for k, _ in cfg.identities]

    def present(w):
        return (w >> cdc.o_present) & 1

    def ident(w):
        return (w >> cdc.o_ident) & ((1 << cdc.ib) - 1)

    def obj_ok(w):
        """IsValidAPIObject (KubeAPI.tla:378-384) over an object word."""
        return torch.where(present(w) == 1, ident(w) < ni, w == 0)

    def check(vecs: torch.Tensor) -> torch.Tensor:
        sd = cdc.to_sdict(vecs.to(torch.int32))
        api, req, lm, lo = sd["api"], sd["req"], sd["lreq_meta"], sd["lreq_obj"]

        ok = obj_ok(api).all(-1)
        rp = ((req >> cdc.r_present) & 1) == 1
        r_op = (req >> cdc.r_op) & 7
        r_st = (req >> cdc.r_status) & 3
        r_obj = (req >> cdc.r_obj) & ((1 << cdc.obj_bits) - 1)
        req_ok = (~rp) | ((r_op <= 4) & (r_st <= 2) & (present(r_obj) == 1)
                          & obj_ok(r_obj))
        ok = ok & req_ok.all(-1)
        lp = ((lm >> cdc.lm_present) & 1) == 1
        l_kind = (lm >> cdc.lm_kind) & ((1 << cdc.kb) - 1)
        l_st = (lm >> cdc.lm_status) & 3
        lo_pres = present(lo) == 1  # [B, nc, ls]
        table = torch.tensor(ident_kind_list + [INT32_MIN], dtype=torch.int32,
                             device=vecs.device)
        idx = ident(lo).to(torch.int64)
        lo_kind = table[torch.where(idx < ni, idx, ni)]
        objs_ok = (~lo_pres | (obj_ok(lo) & (lo_kind == l_kind[..., None]))).all(-1)
        objs_zero = (lo == 0).all(-1)
        lreq_ok = torch.where(lp, (l_kind < n_kinds) & (l_st <= 2) & objs_ok,
                              objs_zero)
        type_ok = ok & lreq_ok.all(-1)

        pres = present(api) == 1
        ids = ident(api)
        pair = (pres[..., :, None] & pres[..., None, :]
                & (ids[..., :, None] == ids[..., None, :]))
        pair = pair & ~torch.eye(ni, dtype=torch.bool, device=vecs.device)
        only_one = ~pair.flatten(-2).any(-1)
        return type_ok.to(torch.int32) | (only_one.to(torch.int32) << 1)

    return check
