"""KubeAPI device coverage plane: TLC's span counters on the card (port of
jaxtlc/spec/coverage_device.py:70-815).

The host coverage walker (spec.coverage) reproduces the MC.out per-
expression dump by re-walking the whole state space with an instrumented
evaluator.  This plane moves the deterministic part of that accounting
into the engine: every span whose visit count is a pure function of
per-state facts the codec holds - label occupancy, request and list
statuses, apiState membership, version-vector bits, shouldReconcile - is
a site whose per-block increment the expand stage computes and the commit
folds into the carry's cumulative ``cov_counts``.

Spans inside short-circuiting enumerations whose visit count depends on
TLC's element order mid-scan (``\\E o \\in apiState`` existence probes,
the PVCListedPVCs ``\\A`` body, the Update ``\\E`` body) are not sites:
the host walker keeps them (coverage_device.py:16-22 of the reference).

``kubeapi_coverage_plane(cfg)`` gives the site table - 22 per-action
sites, 9 Init sites, 280 span sites, the reference's keys, kinds, actions,
locations and order - with:

* ``count(block, n, valid)``: kernel K10 (torchtlc/kernels/csrc/
  coverage.cu) on a CUDA block, ``count_plain`` on a CPU one;
* ``init_count``: the Init-site visits of the seed states (host).

``count_plain`` is the readable torch version: each span site a per-state
int column built from the decoded fields, summed over the popped rows.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from ..config import RECONCILER, ModelConfig
from ..obs.coverage import CoveragePlane, Site, action_site_table
from .codec import get_codec
from .kernel import lane_layout
from .labels import LABEL_ID, LABELS, VERB_ID

MODEL1_IDENTITIES = (("Secret", "foo"), ("PVC", "mypvc"))
INIT_KEYS = ("I.api", "I.req", "I.lreq", "I.stk", "I.opobj", "I.kind",
             "I.sr", "I.pc", "I.rest")
MAXI = 16  # coverage.cuh / kubeapi.cuh KUBE_MAXI


def _span_locs() -> Dict[str, str]:
    """span key -> source loc from the span table."""
    from .coverage_spans import SPANS

    out: Dict[str, str] = {}
    for _name, _code, _loc, lines in SPANS:
        for _dep, loc, key, _lcode, _hc, _ce in lines:
            out.setdefault(key, loc)
    return out


def identity_tables(cfg: ModelConfig) -> dict:
    """The identity tables the span formulas index (reference :104-117):
    name / kind equality, their conjunction, the (name, kind) strict order
    of the host walker's apiState scan, PVC-kind flags, kind ids."""
    cdc = get_codec(cfg)
    names = [n for _, n in cfg.identities]
    kinds = [k for k, _ in cfg.identities]
    neq = np.asarray([[a == b for b in names] for a in names])
    keq = np.asarray([[a == b for b in kinds] for a in kinds])
    lt = np.asarray([[(na, ka) < (nb, kb) for nb, kb in zip(names, kinds)]
                     for na, ka in zip(names, kinds)])
    return dict(NEQ=neq, KEQ=keq, NKEQ=neq & keq, LT=lt,
                IS_PVC=np.asarray([k == "PVC" for k in kinds]),
                KIND_ID=np.asarray([cdc.kind_id[k] for k in kinds], np.int32))


def kernel_params(cfg: ModelConfig) -> np.ndarray:
    """The CovParams struct K10 takes (coverage.cuh), as int32 words:
    the expand kernel's layout, then NEQ, KEQ, LT [16, 16], IS_PVC and
    KIND_ID [16], zero-padded."""
    from ..engine.backend import kernel_layout

    t = identity_tables(cfg)
    ni = len(cfg.identities)
    assert ni <= MAXI, "config exceeds the coverage kernel's compiled bounds"

    def square(a):
        out = np.zeros((MAXI, MAXI), np.int32)
        out[:ni, :ni] = a
        return out.reshape(-1)

    def row(a):
        out = np.zeros(MAXI, np.int32)
        out[:ni] = a
        return out

    return np.concatenate([
        kernel_layout(cfg), square(t["NEQ"]), square(t["KEQ"]),
        square(t["LT"]), row(t["IS_PVC"]), row(t["KIND_ID"]),
    ]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _registry(cfg: ModelConfig):
    """(entries, context builder) of the span sites: entries are (key,
    action, fn) in the reference's registration order, fn(ctx) a per-state
    [ck] int64 column or an int constant per state."""
    cdc = get_codec(cfg)
    nc, ni, ls, nr = cdc.nc, cdc.ni, cdc.ls, cdc.nr
    np_procs = nc + 1
    n_bind = nc - nr
    api_off = cdc.offsets["api"]
    req_off = cdc.offsets["req"]
    lm_off = cdc.offsets["lreq_meta"]
    lo_off = cdc.offsets["lreq_obj"]
    pc_off = cdc.offsets["pc"]
    sr_off = cdc.offsets["sr"]
    imask = (1 << cdc.ib) - 1
    tables = identity_tables(cfg)
    fail_t = int(cfg.requests_can_fail) + int(cfg.requests_can_timeout)
    timeout = int(cfg.requests_can_timeout)

    entries: List[tuple] = []

    def site(key, action, fn):
        entries.append((key, action, fn))

    def i64(b):
        return b.to(torch.int64)

    def ident_idx(v):
        # an out-of-range identity clamps, as the reference's gathers do
        return torch.clamp(v, max=ni - 1)

    def build_ctx(batch):
        b = batch.to(torch.int64) & 0xFFFFFFFF
        aw = b[:, api_off:api_off + ni]
        dev = batch.device
        ctx = {"T": {k: torch.from_numpy(np.asarray(v)).to(dev)
                     for k, v in tables.items()}}
        ctx["api_present"] = ((aw >> cdc.o_present) & 1).bool()
        ctx["api_ident"] = ident_idx((aw >> cdc.o_ident) & imask)
        ctx["api_vv"] = aw
        ctx["api_n"] = i64(ctx["api_present"]).sum(1)
        ctx["req_w"] = b[:, req_off:req_off + nc]
        ctx["lm_w"] = b[:, lm_off:lm_off + nc]
        ctx["pc"] = b[:, pc_off:pc_off + nc + 1]
        ctx["sr"] = b[:, sr_off:sr_off + nr]
        ctx["lo_w"] = b[:, lo_off:lo_off + nc * ls]
        return ctx

    def memo(ctx, key, fn):
        v = ctx.get(key)
        if v is None:
            v = fn()
            ctx[key] = v
        return v

    def req_present(c, i):
        return memo(c, ("rp", i),
                    lambda: ((c["req_w"][:, i] >> cdc.r_present) & 1).bool())

    def req_status(c, i):
        return memo(c, ("rs", i),
                    lambda: (c["req_w"][:, i] >> cdc.r_status) & 3)

    def req_op(c, i):
        return memo(c, ("ro", i), lambda: (c["req_w"][:, i] >> cdc.r_op) & 7)

    def req_obj_ident(c, i):
        return memo(c, ("roi", i), lambda: ident_idx(
            ((c["req_w"][:, i] >> cdc.r_obj) >> cdc.o_ident) & imask))

    def req_obj_has_spec(c, i):
        return memo(c, ("rospec", i), lambda: (
            ((c["req_w"][:, i] >> cdc.r_obj) >> cdc.o_spec) & 1).bool())

    def lm_present(c, i):
        return memo(c, ("lmp", i),
                    lambda: ((c["lm_w"][:, i] >> cdc.lm_present) & 1).bool())

    def lm_status(c, i):
        return memo(c, ("lms", i),
                    lambda: (c["lm_w"][:, i] >> cdc.lm_status) & 3)

    def lm_kind(c, i):
        return memo(c, ("lmk", i), lambda: (
            c["lm_w"][:, i] >> cdc.lm_kind) & ((1 << cdc.kb) - 1))

    def lobj_present(c, i, s):
        return memo(c, ("lop", i, s), lambda: (
            (c["lo_w"][:, i * ls + s] >> cdc.o_present) & 1).bool())

    def lobj_has_spec(c, i, s):
        return memo(c, ("lospec", i, s), lambda: (
            (c["lo_w"][:, i * ls + s] >> cdc.o_spec) & 1).bool())

    def occ(c, i, label):
        return memo(c, ("occ", i, label),
                    lambda: i64(c["pc"][:, i] == LABEL_ID[label]))

    def api_count(c, table, ident, key=None):
        """Sum over api slots of present & T[table][slot ident, ident]."""
        def build():
            t = c["T"][table]
            per = t[c["api_ident"], ident[:, None].expand_as(c["api_ident"])]
            return i64(per & c["api_present"]).sum(1)
        if key is None:
            return build()
        return memo(c, ("apic",) + key, build)

    # ---- procedure labels (DR/DRp/DLR/DLRp) ---------------------------------

    def proc_occ(c, label):
        return memo(c, ("proc_occ", label),
                    lambda: sum(occ(c, i, label) for i in range(nc)))

    def ready_count(c, label, status_fn):
        return memo(c, ("ready", label), lambda: sum(
            occ(c, i, label) * i64(status_fn(c, i) != 0) for i in range(nc)))

    for label, key in (("DoRequest", "DR"), ("DoListRequest", "DLR")):
        fire = (lambda c, lb=label: proc_occ(c, lb))
        site(f"{key}.g", label, lambda c, f=fire: np_procs + f(c))
        site(f"{key}.gs", label, np_procs)
        site(f"{key}.b1", label, fire)
        site(f"{key}.b2g", label, fire)
        site(f"{key}.b2b", label, lambda c, f=fire: f(c) * fail_t)
        paths = (lambda c, f=fire: f(c) * (1 + fail_t))
        site(f"{key}.pc", label, paths)
        site(f"{key}.un", label, paths)
    for label, key, st_fn, subs in (
            ("DoReply", "DRp", req_status, ("pc", "op", "obj", "st", "un")),
            ("DoListReply", "DLRp", lm_status, ("pc", "kind", "st", "un"))):
        o = (lambda c, lb=label: proc_occ(c, lb))
        fire = (lambda c, lb=label, sf=st_fn: ready_count(c, lb, sf))
        site(f"{key}.g", label, lambda c, f=fire: np_procs + f(c))
        site(f"{key}.gs", label, np_procs)
        site(f"{key}.aw", label, lambda c, oc=o, f=fire: oc(c) + f(c))
        site(f"{key}.aws", label, o)
        site(f"{key}.b1g", label, fire)
        site(f"{key}.b1b", label, fire)
        site(f"{key}.b2", label, fire)
        for sub in subs:
            site(f"{key}.{sub}", label,
                 lambda c, f=fire: f(c) * (1 + timeout))

    # ---- reconciler client machine ------------------------------------------

    recon = [(i, cfg.sr_index(i), cfg.targets[i])
             for i, r in enumerate(cfg.roles) if r == RECONCILER]
    n_sums = [0]

    def rsum(fn):
        """Sum fn(c, i, ri, target) over reconcilers, memoized per closure."""
        n_sums[0] += 1
        key = ("rsum", n_sums[0])
        return lambda c: memo(c, key, lambda: sum(
            fn(c, i, ri, tg) for i, ri, tg in recon))

    def attempt(key, label, fire_fn):
        site(f"{key}.g", label, lambda c, f=fire_fn: nr + f(c))
        site(f"{key}.gs", label, nr)

    o_cs = rsum(lambda c, i, ri, tg: occ(c, i, "CStart"))
    attempt("CS", "CStart", o_cs)
    for sub in ("b1", "b2g", "b2b"):
        site(f"CS.{sub}", "CStart", o_cs)
    site("CS.if", "CStart", lambda c: 2 * o_cs(c))
    site("CS.un", "CStart", lambda c: 2 * o_cs(c))
    site("CS.then", "CStart", rsum(
        lambda c, i, ri, tg: occ(c, i, "CStart") * (1 + c["sr"][:, ri])))
    cs_else = rsum(
        lambda c, i, ri, tg: occ(c, i, "CStart") * (1 - c["sr"][:, ri]))
    for sub in ("else", "epc", "eun"):
        site(f"CS.{sub}", "CStart", cs_else)

    for label, st_fn in (("C1", req_status), ("C11", req_status),
                         ("C3", lm_status)):
        o = rsum(lambda c, i, ri, tg, lb=label: occ(c, i, lb))
        ok = rsum(lambda c, i, ri, tg, lb=label, sf=st_fn:
                  occ(c, i, lb) * i64(sf(c, i) == 1))
        attempt(label, label, o)
        site(f"{label}.if", label, o)
        site(f"{label}.then", label, lambda c, oc=o, okc=ok: oc(c) - okc(c))
        site(f"{label}.else", label, ok)
        site(f"{label}.un", label, o)

    for label, subs in (("C10", ("asg", "pc", "un")),
                        ("c12", ("asg", "pc", "un")),
                        ("C2", ("sr", "as", "pc", "un")),
                        ("C5", ("pc", "un"))):
        o = rsum(lambda c, i, ri, tg, lb=label: occ(c, i, lb))
        attempt(label, label, o)
        for sub in subs:
            site(f"{label}.{sub}", label, o)

    # C13: the Get reply triage through IsUnboundPVC
    def ok13(c, i):
        return occ(c, i, "C13") * i64(req_status(c, i) == 1)

    def is_pvc(c, i):
        return c["T"]["IS_PVC"][req_obj_ident(c, i)]

    o13 = rsum(lambda c, i, ri, tg: occ(c, i, "C13"))
    k13 = rsum(lambda c, i, ri, tg: ok13(c, i))
    attempt("C13", "C13", o13)
    site("C13.if", "C13", o13)
    site("C13.o1", "C13", o13)
    for sub in ("o2", "ubarg", "ub.w", "ub.k"):
        site(f"C13.{sub}", "C13", k13)
    ub_or = rsum(lambda c, i, ri, tg: ok13(c, i) * i64(is_pvc(c, i)))
    site("C13.ub.or", "C13", ub_or)
    site("C13.ub.o1", "C13", ub_or)
    site("C13.ub.o2", "C13", rsum(lambda c, i, ri, tg: ok13(c, i) * i64(
        is_pvc(c, i) & req_obj_has_spec(c, i))))
    bad13 = rsum(lambda c, i, ri, tg: occ(c, i, "C13") * torch.where(
        req_status(c, i) == 1,
        i64(is_pvc(c, i) & ~req_obj_has_spec(c, i)), 1))
    site("C13.then", "C13", bad13)
    site("C13.else", "C13", lambda c: o13(c) - bad13(c))
    site("C13.un", "C13", o13)

    def nobjs(c, i):
        return memo(c, ("nobjs", i), lambda: sum(
            i64(lobj_present(c, i, s)) for s in range(ls)))

    # C8: branch on whether the listed object set is empty
    o8 = rsum(lambda c, i, ri, tg: occ(c, i, "C8"))
    empty8 = rsum(lambda c, i, ri, tg: occ(c, i, "C8") * i64(nobjs(c, i) == 0))
    attempt("C8", "C8", o8)
    site("C8.if", "C8", o8)
    site("C8.then", "C8", empty8)
    site("C8.else", "C8", lambda c: o8(c) - empty8(c))
    site("C8.un", "C8", o8)

    # C6: one `with` path per listed object
    o6ne = rsum(lambda c, i, ri, tg: occ(c, i, "C6") * i64(nobjs(c, i) > 0))
    site("C6.g", "C6", lambda c: nr + o6ne(c))
    site("C6.gs", "C6", nr)
    paths6 = rsum(lambda c, i, ri, tg: occ(c, i, "C6") * nobjs(c, i))
    site("C6.with", "C6", paths6)
    site("C6.un", "C6", paths6)

    # C7: retry unless the delete succeeded and one object remains
    o7 = rsum(lambda c, i, ri, tg: occ(c, i, "C7"))
    ok7 = rsum(lambda c, i, ri, tg:
               occ(c, i, "C7") * i64(req_status(c, i) == 1))
    attempt("C7", "C7", o7)
    site("C7.if", "C7", o7)
    site("C7.o1", "C7", o7)
    site("C7.o2", "C7", ok7)
    retry7 = rsum(lambda c, i, ri, tg: occ(c, i, "C7") * torch.where(
        req_status(c, i) == 1, i64(nobjs(c, i) > 1), 1))
    site("C7.then", "C7", retry7)
    site("C7.else", "C7", lambda c: o7(c) - retry7(c))
    site("C7.un", "C7", o7)

    # C4: the ObjectExists scan - position of the first (n, k) match in
    # the walker's sorted enumeration, or |api| when none
    o4 = rsum(lambda c, i, ri, tg: occ(c, i, "C4"))
    attempt("C4", "C4", o4)
    for sub in ("as", "neg", "oe", "pc", "un", "oed.w", "oed.dom"):
        site(f"C4.{sub}", "C4", o4)

    def oed_iters(c, si):
        tgt = torch.full_like(c["api_n"], si)
        match = api_count(c, "NKEQ", tgt)
        less = api_count(c, "LT", tgt)
        return torch.where(match > 0, less + 1, c["api_n"])

    oed = rsum(lambda c, i, ri, tg: occ(c, i, "C4") * oed_iters(c, tg[0]))
    site("C4.oed.body", "C4", oed)
    site("C4.oed.arg", "C4", oed)

    # ---- binder machine -----------------------------------------------------

    binders = [i for i, r in enumerate(cfg.roles) if r != RECONCILER]

    def bsum(fn):
        n_sums[0] += 1
        key = ("bsum", n_sums[0])
        return lambda c: memo(c, key, lambda: sum(fn(c, i) for i in binders))

    def battempt(key, label, fire_fn):
        site(f"{key}.g", label, lambda c, f=fire_fn: n_bind + f(c))
        site(f"{key}.gs", label, n_bind)

    for label, key, subs in (("PVCStart", "PS", ("asg", "pc", "un")),
                             ("PVCDone", "PD", ("pc", "un"))):
        o = bsum(lambda c, i, lb=label: occ(c, i, lb))
        battempt(key, label, o)
        for sub in subs:
            site(f"{key}.{sub}", label, o)

    def n_unbound(c, i):
        return sum(i64(lobj_present(c, i, s) & ~lobj_has_spec(c, i, s))
                   for s in range(ls))

    # PVCListedPVCs: retry on list failure or when everything is bound
    opl = bsum(lambda c, i: occ(c, i, "PVCListedPVCs"))
    okpl = bsum(lambda c, i:
                occ(c, i, "PVCListedPVCs") * i64(lm_status(c, i) == 1))
    battempt("PL", "PVCListedPVCs", opl)
    site("PL.if", "PVCListedPVCs", opl)
    site("PL.o1", "PVCListedPVCs", opl)
    for sub in ("all", "all2", "dom", "var"):
        site(f"PL.{sub}", "PVCListedPVCs", okpl)
    retry_pl = bsum(lambda c, i: occ(c, i, "PVCListedPVCs") * torch.where(
        lm_status(c, i) == 1, i64(n_unbound(c, i) == 0), 1))
    site("PL.then", "PVCListedPVCs", retry_pl)
    site("PL.else", "PVCListedPVCs", lambda c: opl(c) - retry_pl(c))
    site("PL.un", "PVCListedPVCs", opl)

    # PVCHavePVCs: one \E path per unbound listed PVC
    ph_ne = bsum(lambda c, i:
                 occ(c, i, "PVCHavePVCs") * i64(n_unbound(c, i) > 0))
    site("PH.g", "PVCHavePVCs", lambda c: n_bind + ph_ne(c))
    site("PH.gs", "PVCHavePVCs", n_bind)
    ph_paths = bsum(lambda c, i: occ(c, i, "PVCHavePVCs") * n_unbound(c, i))
    site("PH.ex", "PVCHavePVCs", ph_paths)
    site("PH.un", "PVCHavePVCs", ph_paths)

    # ---- the API server -----------------------------------------------------

    def pending(c, i):
        return i64(req_present(c, i) & (req_status(c, i) == 0))

    def lpending(c, i):
        return i64(lm_present(c, i) & (lm_status(c, i) == 0))

    def op_is(c, i, verb):
        return pending(c, i) * i64(req_op(c, i) == VERB_ID[verb])

    def csum(fn):
        n_sums[0] += 1
        key = ("csum", n_sums[0])
        return lambda c: memo(c, key, lambda: sum(fn(c, i) for i in range(nc)))

    pend = csum(pending)
    lpend = csum(lpending)
    paths = (lambda c: pend(c) + lpend(c))
    site("AS.g", "APIStart", lambda c: 1 + i64(paths(c) > 0))
    site("AS.gs", "APIStart", 1)
    for sub in ("pcref", "pcdef", "pcdom"):
        site(f"AS.{sub}", "APIStart", 1)
    site("AS.pcpred", "APIStart", csum(lambda c, i: i64(req_present(c, i))))
    for sub in ("plref", "pldef", "pldom"):
        site(f"AS.{sub}", "APIStart", 1)
    site("AS.plpred", "APIStart", csum(lambda c, i: i64(lm_present(c, i))))
    site("AS.bind", "APIStart", pend)
    site("AS.unl", "APIStart", pend)
    site("AS.unr", "APIStart", lpend)
    site("AS.pc", "APIStart", paths)
    site("AS.un", "APIStart", paths)

    # op dispatch: Create is never issued by this family's processes, so
    # the Force/Get/Delete/Update ladder is exact
    def exists(c, i):
        return memo(c, ("exists", i), lambda: i64(api_count(
            c, "NKEQ", req_obj_ident(c, i), key=("nkeq", i)) > 0))

    def n_match(c, i):
        return api_count(c, "NEQ", req_obj_ident(c, i), key=("neq", i))

    def nk_match(c, i):
        return api_count(c, "NKEQ", req_obj_ident(c, i), key=("nkeq", i))

    site("AS.fif", "APIStart", pend)
    force = csum(lambda c, i: op_is(c, i, "Force"))
    site("AS.f.if", "APIStart", force)
    f_ex = csum(lambda c, i: op_is(c, i, "Force") * exists(c, i))
    site("AS.f.add", "APIStart", lambda c: force(c) - f_ex(c))
    site("AS.f.ok", "APIStart", force)
    for sub in ("set", "setc", "dom"):
        site(f"AS.f.{sub}", "APIStart", f_ex)
    f_elems = csum(lambda c, i:
                   op_is(c, i, "Force") * exists(c, i) * c["api_n"])
    for sub in ("elif", "cond", "co", "cr", "civo.w", "civo.1"):
        site(f"AS.f.{sub}", "APIStart", f_elems)
    site("AS.f.civo.2", "APIStart", csum(
        lambda c, i: op_is(c, i, "Force") * exists(c, i) * n_match(c, i)))
    f_match = csum(lambda c, i:
                   op_is(c, i, "Force") * exists(c, i) * nk_match(c, i))
    site("AS.f.wr", "APIStart", f_match)
    site("AS.f.o", "APIStart", lambda c: f_elems(c) - f_match(c))

    get = csum(lambda c, i: op_is(c, i, "Get"))
    site("AS.gif", "APIStart", lambda c: pend(c) - force(c))
    site("AS.g.if", "APIStart", get)
    g_ex = csum(lambda c, i: op_is(c, i, "Get") * exists(c, i))
    site("AS.g.err", "APIStart", lambda c: get(c) - g_ex(c))
    site("AS.g.unch", "APIStart", lambda c: get(c) - g_ex(c))
    for sub in ("req", "req2", "api1", "cho", "cho2", "chod", "st", "set",
                "setc", "dom"):
        site(f"AS.g.{sub}", "APIStart", g_ex)
    g_elems = csum(lambda c, i:
                   op_is(c, i, "Get") * exists(c, i) * c["api_n"])
    for sub in ("chob", "choo", "chor", "elif", "cond", "co"):
        site(f"AS.g.{sub}", "APIStart", g_elems)
    # the primed requests'[c].obj deref logs one extra visit per
    # comprehension evaluation (spec.coverage's AS.g.cr note)
    site("AS.g.cr", "APIStart", lambda c: g_elems(c) + g_ex(c))
    g_nmatch = csum(lambda c, i:
                    op_is(c, i, "Get") * exists(c, i) * n_match(c, i))
    for sub in ("chivo", "civo"):
        site(f"AS.g.{sub}.w", "APIStart", g_elems)
        site(f"AS.g.{sub}.1", "APIStart", g_elems)
        site(f"AS.g.{sub}.2", "APIStart", g_nmatch)
    g_match = csum(lambda c, i:
                   op_is(c, i, "Get") * exists(c, i) * nk_match(c, i))
    site("AS.g.rd", "APIStart", g_match)
    site("AS.g.o", "APIStart", lambda c: g_elems(c) - g_match(c))

    delete = csum(lambda c, i: op_is(c, i, "Delete"))
    site("AS.dif", "APIStart", lambda c: pend(c) - force(c) - get(c))
    for sub in ("set", "setc", "dom", "ok"):
        site(f"AS.d.{sub}", "APIStart", delete)
    d_elems = csum(lambda c, i: op_is(c, i, "Delete") * c["api_n"])
    for sub in ("neg", "negi", "co", "cr", "ivo.w", "ivo.1"):
        site(f"AS.d.{sub}", "APIStart", d_elems)
    site("AS.d.ivo.2", "APIStart",
         csum(lambda c, i: op_is(c, i, "Delete") * n_match(c, i)))

    upd = csum(lambda c, i: op_is(c, i, "Update"))
    site("AS.uif", "APIStart",
         lambda c: pend(c) - force(c) - get(c) - delete(c))
    site("AS.u.if", "APIStart", upd)
    site("AS.u.dom", "APIStart", upd)

    def found(c, i):
        """Some api object matches the request object AND lists client i
        in its version vector (the Update success condition)."""
        t = c["T"]["NKEQ"]
        roi = req_obj_ident(c, i)
        per = t[c["api_ident"], roi[:, None].expand_as(c["api_ident"])]
        vv = ((c["api_vv"] >> (cdc.o_vv + i)) & 1).bool()
        return i64((per & c["api_present"] & vv).any(1))

    u_found = csum(lambda c, i: op_is(c, i, "Update") * found(c, i))
    for sub in ("set", "set2", "filt", "fdom", "wr", "ok"):
        site(f"AS.u.{sub}", "APIStart", u_found)
    site("AS.u.err", "APIStart", lambda c: upd(c) - u_found(c))
    site("AS.u.unch", "APIStart", lambda c: upd(c) - u_found(c))
    u_elems = csum(lambda c, i:
                   op_is(c, i, "Update") * found(c, i) * c["api_n"])
    for sub in ("fneg", "fnegi", "fo", "fr", "fivo.w", "fivo.1"):
        site(f"AS.u.{sub}", "APIStart", u_elems)
    site("AS.u.fivo.2", "APIStart", csum(
        lambda c, i: op_is(c, i, "Update") * found(c, i) * n_match(c, i)))

    # list serving: every site on the list path iterates the full apiState
    for sub in ("l.req", "l.req2", "l.exc", "l.objs", "l.filt", "l.fdom",
                "l.st", "l.set", "l.setc", "l.dom"):
        site(f"AS.{sub}", "APIStart", lpend)
    l_elems = csum(lambda c, i: lpending(c, i) * c["api_n"])
    for sub in ("pred", "elif", "cond"):
        site(f"AS.l.{sub}", "APIStart", l_elems)

    def kind_matches(c, i):
        kid = c["T"]["KIND_ID"][c["api_ident"]]
        per = kid == lm_kind(c, i)[:, None]
        return i64(per & c["api_present"]).sum(1)

    l_rd = csum(lambda c, i: lpending(c, i) * kind_matches(c, i))
    site("AS.l.rd", "APIStart", l_rd)
    site("AS.l.o", "APIStart", lambda c: l_elems(c) - l_rd(c))

    # ---- invariants (one evaluation per expanded = distinct state) ----------
    for sub in ("w", "c1", "c1dom", "c2", "c2dom", "c3", "c3dom"):
        site(f"TY.{sub}", "TypeOK", 1)
    site("TY.c1body", "TypeOK", lambda c: c["api_n"])
    site("TY.c2body", "TypeOK", csum(lambda c, i: i64(req_present(c, i))))
    lm_n = csum(lambda c, i: i64(lm_present(c, i)))
    for sub in ("c3body", "vlr", "vlr1", "vlr2", "vlr2q", "vlr3", "vlrarg"):
        site(f"TY.{sub}", "TypeOK", lm_n)
    site("TY.vlr2b", "TypeOK",
         lambda c: sum(nobjs(c, i) for i in range(nc)))
    site("OV.w", "OnlyOneVersion", 1)
    site("OV.dom", "OnlyOneVersion", 1)
    site("OV.body", "OnlyOneVersion", lambda c: c["api_n"] * c["api_n"])
    site("OV.o1", "OnlyOneVersion", lambda c: c["api_n"] * c["api_n"])
    site("OV.o2", "OnlyOneVersion",
         lambda c: c["api_n"] * (c["api_n"] - 1))
    return entries, build_ctx


def site_table(cfg: ModelConfig) -> tuple:
    """The plane's ordered sites: actions, Init, spans."""
    entries, _ = _registry(cfg)
    locs = _span_locs() if cfg.identities == MODEL1_IDENTITIES else {}
    return (tuple(action_site_table("KubeAPI", LABELS))
            + tuple(Site(key=k, kind="init", action="Init")
                    for k in INIT_KEYS)
            + tuple(Site(key=k, kind="span", action=a, loc=locs.get(k, ""))
                    for k, a, _ in entries))


def count_plain(cfg: ModelConfig, block: torch.Tensor, n: int,
                valid: torch.Tensor) -> torch.Tensor:
    """Torch version of kernel K10: the [n_sites] uint32 site increments
    (int32 words) of the first n rows of a popped block ([ck, W] packed),
    with valid the expand stage's [ck * L] lane flags."""
    cdc = get_codec(cfg)
    CL, L = lane_layout(cfg)
    nc = cdc.nc
    entries, build_ctx = _registry(cfg)
    ck = block.shape[0]
    dev = block.device
    batch = cdc.unpack(block)
    v = valid.reshape(ck, L).to(torch.int64)
    # per-action generated prefix: the fold of backend.gen_counts
    pcs = batch[:, cdc.offsets["pc"]:cdc.offsets["pc"] + nc].to(torch.int64)
    ids = torch.arange(len(LABELS), device=dev)
    act = torch.zeros(len(LABELS), dtype=torch.int64, device=dev)
    for ci in range(nc):
        vc = v[:, ci * CL:(ci + 1) * CL].sum(1)
        act += ((pcs[:, ci, None] == ids) * vc[:, None]).sum(0)
    act[LABEL_ID["APIStart"]] += v[:, nc * CL:].sum()
    ctx = build_ctx(batch)
    m = (torch.arange(ck, device=dev) < n).to(torch.int64)
    n_rows = min(max(int(n), 0), ck)
    span = torch.zeros(len(entries), dtype=torch.int64, device=dev)
    for j, (_k, _a, fn) in enumerate(entries):
        col = fn(ctx) if callable(fn) else fn
        span[j] = (col * m).sum() if torch.is_tensor(col) else col * n_rows
    out = torch.cat([act, torch.zeros(len(INIT_KEYS), dtype=torch.int64,
                                      device=dev), span]) & 0xFFFFFFFF
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def coverage_count(cfg: ModelConfig, block: torch.Tensor, n: int,
                   valid: torch.Tensor) -> torch.Tensor:
    """Kernel K10 on a CUDA block, the plain version on a CPU block."""
    if not block.is_cuda:
        return count_plain(cfg, block, n, valid)
    from ..kernels import ops

    return ops.coverage_count(cfg, block, n, valid)


def kubeapi_coverage_plane(cfg: ModelConfig) -> CoveragePlane:
    """The device coverage plane of one KubeAPI configuration."""
    sites = site_table(cfg)
    n_actions = len(LABELS)

    def init_count(inits: np.ndarray) -> np.ndarray:
        out = np.zeros(len(sites), np.uint32)
        n0 = inits.shape[0]
        for j, k in enumerate(INIT_KEYS):
            out[n_actions + j] = n0 if k in ("I.pc", "I.rest") else 1
        return out

    return CoveragePlane(sites=sites,
                         count=functools.partial(coverage_count, cfg),
                         init_count=init_count, module="KubeAPI")
