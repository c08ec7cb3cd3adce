"""Plain batched next-state function for the KubeAPI action system (port of
jaxtlc/spec/kernel.py:73-574).

``step(batch [B, F] int32) -> (succ [B, L, F] int32, valid [B, L] bool,
action [B, L] int32, assert_fail [B, L] bool, overflow [B, L] bool)``
enumerates every satisfying assignment of Next (KubeAPI.tla:760-763) as a
statically placed lane, with the batch axis written out:

* lanes [i*CL, (i+1)*CL)   - client i, dispatched on its pc label
* lanes nc*CL + c          - the APIServer serving client c's request
* lanes nc*CL + nc + c     - the APIServer serving client c's list request

This is the readable specification of the expand kernel (K1,
torchtlc/kernels/csrc/kubeapi.cuh), which computes the same lanes one
thread per (state, lane).  Lane contents are the reference's exactly,
including lanes whose guard is false (they carry the handler's successor
and the label id) and lanes no handler emits (the unchanged state, action
0).  Fields are int32 throughout, as in the reference.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..config import RECONCILER, ModelConfig
from .codec import get_codec
from .labels import LABEL_ID, VERB_ID

I32 = torch.int32
INT32_MIN = -(1 << 31)
PENDING, OK, ERROR = 0, 1, 2  # RESPONSE_ID order


def lane_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(CL, L): client lane-block width and total lane count.  CL is the
    widest per-label fan-out reachable under the fault switches:
    DoRequest/DoListRequest need 1 + fail + timeout lanes, CStart needs 2,
    the `with` fan-out labels need ls (KubeAPI.tla:471-483, 529-531,
    618-629, 673-688)."""
    cdc = get_codec(cfg)
    CL = max(2, 1 + int(cfg.requests_can_fail) + int(cfg.requests_can_timeout),
             cdc.ls)
    return CL, cdc.nc * CL + 2 * cdc.nc


def initial_vectors(cfg: ModelConfig) -> np.ndarray:
    """Init (KubeAPI.tla:455-469) as encoded field vectors."""
    return get_codec(cfg).initial_vectors()


@functools.lru_cache(maxsize=None)
def make_kernel(cfg: ModelConfig):
    """Build the batched ``step`` for one config."""
    cdc = get_codec(cfg)
    ni, nc, ls = cdc.ni, cdc.nc, cdc.ls
    CL, L = lane_layout(cfg)
    O = cdc.offsets
    fail = bool(cfg.requests_can_fail)
    timeout = bool(cfg.requests_can_timeout)
    ident_kind_list = [cdc.kind_id[k] for k, _ in cfg.identities]
    pvc_kind = cdc.kind_id.get("PVC", -1)
    obj_mask = (1 << cdc.obj_bits) - 1
    vv_field_mask = ((1 << nc) - 1) << cdc.o_vv
    lb_mask = (1 << cdc.lb) - 1

    def obj_word(kind: str, name: str) -> int:
        return (1 << cdc.o_present) | (cfg.identity_id(kind, name) << cdc.o_ident)

    # -- object word ops ------------------------------------------------

    def present(w):
        return (w >> cdc.o_present) & 1

    def ident(w):
        return (w >> cdc.o_ident) & ((1 << cdc.ib) - 1)

    def kind_of(w):
        """ident -> kind id; an out-of-range ident gives INT32_MIN, the
        reference's jnp.take fill value."""
        table = torch.tensor(ident_kind_list + [INT32_MIN], dtype=I32,
                             device=w.device)
        idx = ident(w).to(torch.int64)
        return table[torch.where(idx < ni, idx, ni)]

    def has_spec(w):
        return (w >> cdc.o_spec) & 1

    def write_w(w):
        """Write (KubeAPI.tla:395): vv := {}."""
        return (w & ~vv_field_mask) | (1 << cdc.o_hasvv)

    def read_w(w, ci: int):
        """Read (KubeAPI.tla:399): add client ci to vv."""
        return w | (1 << (cdc.o_vv + ci))

    def unbound_pvc(w):
        """IsUnboundPVC (KubeAPI.tla:444-446)."""
        return (present(w) == 1) & (kind_of(w) == pvc_kind) & (has_spec(w) == 0)

    def req_word(op_id, obj_w, status_id: int):
        return ((1 << cdc.r_present) | (op_id << cdc.r_op)
                | (status_id << cdc.r_status) | (obj_w << cdc.r_obj))

    def req_status(w):
        return (w >> cdc.r_status) & 3

    def req_op(w):
        return (w >> cdc.r_op) & 7

    def req_obj(w):
        return (w >> cdc.r_obj) & obj_mask

    def req_with_status(w, status_id):
        return (w & ~(3 << cdc.r_status)) | (status_id << cdc.r_status)

    def req_with_obj(w, obj_w):
        return (w & ~(obj_mask << cdc.r_obj)) | (obj_w << cdc.r_obj)

    def lm_word(kind_id, status_id: int):
        return ((1 << cdc.lm_present) | (kind_id << cdc.lm_kind)
                | (status_id << cdc.lm_status))

    def lm_status(w):
        return (w >> cdc.lm_status) & 3

    def lm_kind(w):
        return (w >> cdc.lm_kind) & ((1 << cdc.kb) - 1)

    def lm_with(w, status_id: int):
        return (w & ~(3 << cdc.lm_status)) | (status_id << cdc.lm_status)

    # -- state helpers (v: [B, F] int32; every helper returns a copy) ----

    def col(v, name, i=0):
        return v[:, O[name] + i]

    def put(v, name, i, value):
        out = v.clone()
        out[:, O[name] + i] = value
        return out

    def api_of(v):
        return v[:, O["api"]:O["api"] + ni]

    def lo_of(v, i):
        s = O["lreq_obj"] + i * ls
        return v[:, s:s + ls]

    def set_pc(v, i, label):
        return put(v, "pc", i, LABEL_ID[label])

    def call_api(v, i, ret, verb, obj_w):
        """call API(op, obj): push a frame saving dIV params and assign
        op/obj (KubeAPI.tla:535-539)."""
        frame = (1 << cdc.s_present) | (LABEL_ID[ret] << cdc.s_retpc)
        out = put(v, "stack", i, frame)
        out[:, O["p_op"] + i] = 1 + VERB_ID[verb]
        out[:, O["p_obj"] + i] = obj_w
        out[:, O["pc"] + i] = LABEL_ID["DoRequest"]
        return out

    def call_listapi(v, i, ret, kind_name):
        frame = ((1 << cdc.s_present) | (1 << cdc.s_proc)
                 | (LABEL_ID[ret] << cdc.s_retpc))
        out = put(v, "stack", i, frame)
        out[:, O["p_kind"] + i] = 1 + cdc.kind_id[kind_name]
        out[:, O["pc"] + i] = LABEL_ID["DoListRequest"]
        return out

    def api_found(v, obj_w: int):
        """ObjectExists (KubeAPI.tla:410)."""
        api = api_of(v)
        return ((present(api) == 1) & (ident(api) == ident(obj_w))).any(1)

    def true(v):
        return torch.ones(v.shape[0], dtype=torch.bool, device=v.device)

    def false(v):
        return torch.zeros(v.shape[0], dtype=torch.bool, device=v.device)

    # -- per-label handlers: list of (valid, succ, afail) or None --------

    def statuses():
        return [s for s, on in ((PENDING, True), (ERROR, fail), (ERROR, timeout))
                if on]

    def h_do_request(v, i):
        obj_w = col(v, "p_obj", i)
        op_id = col(v, "p_op", i) - 1
        return [(true(v),
                 set_pc(put(v, "req", i, req_word(op_id, obj_w, st)), i,
                        "DoReply"),
                 false(v)) for st in statuses()]

    def popped(v, i, params):
        frame = col(v, "stack", i)
        out = put(v, "pc", i, (frame >> cdc.s_retpc) & lb_mask)
        out[:, O["stack"] + i] = 0
        for p in params:
            out[:, O[p] + i] = 0
        return out

    def h_do_reply(v, i):
        rw = col(v, "req", i)
        guard = req_status(rw) != PENDING
        p = popped(v, i, ("p_op", "p_obj"))
        lanes = [(guard, p, false(v))]
        if timeout:
            lanes.append((guard, put(p, "req", i, req_with_status(rw, ERROR)),
                          false(v)))
        return lanes

    def h_do_list_request(v, i):
        kind_id = col(v, "p_kind", i) - 1
        lanes = []
        for st in statuses():
            nxt = put(v, "lreq_meta", i, lm_word(kind_id, st))
            s = O["lreq_obj"] + i * ls
            nxt[:, s:s + ls] = 0
            lanes.append((true(v), set_pc(nxt, i, "DoListReply"), false(v)))
        return lanes

    def h_do_list_reply(v, i):
        lw = col(v, "lreq_meta", i)
        guard = lm_status(lw) != PENDING
        p = popped(v, i, ("p_kind",))
        lanes = [(guard, p, false(v))]
        if timeout:
            erred = put(p, "lreq_meta", i, lm_with(lw, ERROR))
            s = O["lreq_obj"] + i * ls
            erred[:, s:s + ls] = 0
            lanes.append((guard, erred, false(v)))
        return lanes

    def branch(v, i, cond, then_lbl, else_lbl):
        nxt = put(v, "pc", i, torch.where(
            cond, LABEL_ID[then_lbl], LABEL_ID[else_lbl]).to(I32))
        return [(true(v), nxt, false(v))]

    def h_c1(v, i):
        return branch(v, i, req_status(col(v, "req", i)) == OK, "C10", "CStart")

    def h_c11(v, i):
        return branch(v, i, req_status(col(v, "req", i)) == OK, "c12", "CStart")

    def h_c13(v, i):
        rw = col(v, "req", i)
        ok = (req_status(rw) == OK) & ~unbound_pvc(req_obj(rw))
        return branch(v, i, ok, "C2", "CStart")

    def h_c3(v, i):
        return branch(v, i, lm_status(col(v, "lreq_meta", i)) == OK, "C8",
                      "CStart")

    def h_c8(v, i):
        empty = (present(lo_of(v, i)) == 0).all(1)
        return branch(v, i, empty, "C4", "C6")

    def h_c6(v, i):
        # with s \in listRequests[self].objs: Delete a BARE [k, n] record
        # (KubeAPI.tla:618-629)
        lanes = []
        for j in range(ls):
            s = lo_of(v, i)[:, j]
            bare = (1 << cdc.o_present) | (ident(s) << cdc.o_ident)
            lanes.append((present(s) == 1, call_api(v, i, "C7", "Delete", bare),
                          false(v)))
        return lanes + [None] * (CL - len(lanes))

    def h_c7(v, i):
        ok = ((req_status(col(v, "req", i)) == OK)
              & (present(lo_of(v, i)).sum(1) <= 1))
        return branch(v, i, ok, "C4", "CStart")

    def h_c5(v, i):
        return [(true(v), set_pc(v, i, "CStart"), false(v))]

    def make_reconciler_extras(ci: int):
        si, pi = cfg.targets[ci]
        sk, sn = cfg.identities[si]
        pk, pn = cfg.identities[pi]
        secret_w = obj_word(sk, sn)
        pvc_w = obj_word(pk, pn)
        ri = cfg.sr_index(ci)

        def h_cstart(v, i):
            # KubeAPI.tla:528-549: lane 0 is the either-branch sr' := TRUE;
            # lane 1 the skip branch, dispatched on the OLD sr value
            recon = call_api(put(v, "sr", ri, 1), i, "C1", "Force", secret_w)
            cleanup = call_listapi(put(v, "sr", ri, 0), i, "C3", sk)
            skip = torch.where((col(v, "sr", ri) == 1)[:, None], recon, cleanup)
            return [(true(v), recon, false(v)), (true(v), skip, false(v)), None]

        def h_c10(v, i):
            return [(true(v), call_api(v, i, "C11", "Force", pvc_w), false(v))]

        def h_c12(v, i):
            return [(true(v), call_api(v, i, "C13", "Get", pvc_w), false(v))]

        def h_c2(v, i):
            # assert ObjectExists(own secret) (KubeAPI.tla:196)
            found = api_found(v, secret_w)
            base = v if cfg.mutation == "sticky_reconcile" else put(v, "sr", ri, 0)
            return [(true(v), set_pc(base, i, "C5"), ~found)]

        def h_c4(v, i):
            found = api_found(v, secret_w)
            return [(true(v), set_pc(v, i, "C5"), found)]

        return {"CStart": h_cstart, "C10": h_c10, "c12": h_c12,
                "C2": h_c2, "C4": h_c4}

    def h_pvc_start(v, i):
        return [(true(v), call_listapi(v, i, "PVCListedPVCs", "PVC"), false(v))]

    def h_pvc_listed(v, i):
        lw = col(v, "lreq_meta", i)
        ok = (lm_status(lw) == OK) & unbound_pvc(lo_of(v, i)).any(1)
        return branch(v, i, ok, "PVCHavePVCs", "PVCStart")

    def h_pvc_have(v, i):
        # one lane per unbound listed PVC; binding sets the has_spec bit
        # (KubeAPI.tla:673-688)
        lanes = []
        for j in range(ls):
            unb = lo_of(v, i)[:, j]
            bound = unb | (1 << cdc.o_spec)
            lanes.append((unbound_pvc(unb),
                          call_api(v, i, "PVCDone", "Update", bound), false(v)))
        return lanes + [None] * (CL - len(lanes))

    def h_pvc_done(v, i):
        return [(true(v), set_pc(v, i, "PVCStart"), false(v))]

    proc = {"DoRequest": h_do_request, "DoReply": h_do_reply,
            "DoListRequest": h_do_list_request, "DoListReply": h_do_list_reply}
    reconciler_base = {"C1": h_c1, "C11": h_c11, "C13": h_c13, "C3": h_c3,
                       "C8": h_c8, "C6": h_c6, "C7": h_c7, "C5": h_c5}
    binder = {**proc, "PVCStart": h_pvc_start, "PVCListedPVCs": h_pvc_listed,
              "PVCHavePVCs": h_pvc_have, "PVCDone": h_pvc_done}
    handlers_by_client = [
        {**proc, **reconciler_base, **make_reconciler_extras(ci)}
        if cfg.roles[ci] == RECONCILER else binder
        for ci in range(nc)
    ]

    # -- APIServer lanes (KubeAPI.tla:698-756) ---------------------------

    def server_req_lane(v, c: int):
        """Serve client c's pending single-object request (:699-743)."""
        B = v.shape[0]
        rw = col(v, "req", c)
        valid = (((rw >> cdc.r_present) & 1) == 1) & (req_status(rw) == PENDING)
        op = req_op(rw)
        robj = req_obj(rw)
        api = api_of(v)
        match = (present(api) == 1) & (ident(api) == ident(robj)[:, None])
        found = match.any(1)
        free = present(api) == 0
        free_idx = torch.argmax(free.to(torch.uint8), dim=1)
        can_insert = free.any(1)
        written = write_w(robj)
        inserted = api.clone()
        inserted[torch.arange(B, device=v.device), free_idx] = written
        fo, ci_ = found[:, None], can_insert[:, None]
        create_api = torch.where(fo, api, torch.where(ci_, inserted, api))
        create_st = torch.where(found, ERROR, OK)
        create_ovf = ~found & ~can_insert
        force_api = torch.where(
            fo, torch.where(match, written[:, None], api),
            torch.where(ci_, inserted, api))
        force_ovf = ~found & ~can_insert
        chosen = torch.where(match, api, 0).max(1).values
        get_api = torch.where(fo & match, read_w(api, c), api)
        get_st = torch.where(found, OK, ERROR)
        del_api = api if cfg.mutation == "delete_noop" else torch.where(match, 0, api)
        hasread = (match & (((api >> (cdc.o_vv + c)) & 1) == 1)).any(1)
        upd_api = torch.where(hasread[:, None] & match, written[:, None], api)
        upd_st = torch.where(hasread, OK, ERROR)

        is_create = op == VERB_ID["Create"]
        is_force = op == VERB_ID["Force"]
        is_get = op == VERB_ID["Get"]
        is_delete = op == VERB_ID["Delete"]
        is_update = op == VERB_ID["Update"]
        afail = valid & ~(is_create | is_force | is_get | is_delete | is_update)

        def sel(m, a, b):
            return torch.where(m[:, None] if a.dim() == 2 else m, a, b)

        new_api = sel(is_create, create_api, sel(is_force, force_api, sel(
            is_get, get_api, sel(is_delete, del_api, upd_api))))
        new_st = torch.where(is_create, create_st, torch.where(
            is_force, OK, torch.where(is_get, get_st, torch.where(
                is_delete, OK, upd_st))))
        new_rw = req_with_status(rw, new_st)
        new_rw = torch.where(is_get & found, req_with_obj(new_rw, chosen), new_rw)
        overflow = valid & torch.where(is_create, create_ovf, is_force & force_ovf)
        nxt = v.clone()
        nxt[:, O["api"]:O["api"] + ni] = new_api
        nxt[:, O["req"] + c] = new_rw
        return valid, nxt, afail, overflow

    def server_list_lane(v, c: int):
        """Serve client c's pending list request (:745-753)."""
        lw = col(v, "lreq_meta", c)
        valid = (((lw >> cdc.lm_present) & 1) == 1) & (lm_status(lw) == PENDING)
        kind = lm_kind(lw)
        api = api_of(v)
        match = (present(api) == 1) & (kind_of(api) == kind[:, None])
        matched = torch.where(match, api, 0)
        compacted = (-torch.sort(-matched, dim=1).values)[:, :ls]
        overflow = valid & (match.sum(1) > ls)
        nxt = v.clone()
        nxt[:, O["api"]:O["api"] + ni] = torch.where(match, read_w(api, c), api)
        nxt[:, O["lreq_meta"] + c] = lm_with(lw, OK)
        s = O["lreq_obj"] + c * ls
        nxt[:, s:s + ls] = compacted
        return valid, nxt, false(v), overflow

    apistart = LABEL_ID["APIStart"]

    def step(batch: torch.Tensor):
        v = batch.to(I32)
        B = v.shape[0]
        dev = v.device
        succ = v[:, None, :].repeat(1, L, 1)
        valid = torch.zeros(B, L, dtype=torch.bool, device=dev)
        action = torch.zeros(B, L, dtype=I32, device=dev)
        afail = torch.zeros(B, L, dtype=torch.bool, device=dev)
        ovf = torch.zeros(B, L, dtype=torch.bool, device=dev)
        for i in range(nc):
            lbl = col(v, "pc", i)
            for name, handler in handlers_by_client[i].items():
                mask = lbl == LABEL_ID[name]
                for k, lane in enumerate(handler(v, i)):
                    if lane is None:
                        continue
                    assert k < CL, f"label {name} emits lane {k} >= CL={CL}"
                    lv, s2, af = lane
                    j = i * CL + k
                    valid[:, j] = torch.where(mask, lv, valid[:, j])
                    succ[:, j] = torch.where(mask[:, None], s2, succ[:, j])
                    action[:, j] = torch.where(mask, LABEL_ID[name], action[:, j])
                    afail[:, j] = torch.where(mask, af, afail[:, j])
        for c in range(nc):
            for j, lane_fn in ((nc * CL + c, server_req_lane),
                               (nc * CL + nc + c, server_list_lane)):
                lv, s2, af, ov = lane_fn(v, c)
                valid[:, j] = lv
                succ[:, j] = s2
                action[:, j] = apistart
                afail[:, j] = lv & af
                ovf[:, j] = ov
        return cdc.canonicalize(succ), valid, action, afail, ovf

    return step
