"""Per-expression coverage: the host coverage walker (the port's own copy
of jaxtlc/spec/coverage.py, which imports no jax).

TLC's end-of-run coverage (MC.out:44-1092) reports, for every expression of
the translated action system, how many times the evaluator visited it.  This
module reproduces those numbers EXACTLY for the KubeAPI family by re-walking
the state space with an instrumented evaluator that mirrors TLC's visit
discipline, reverse-engineered from the committed log and pinned
line-for-line by tests/test_coverage.py:

* Every action is *attempted* once per expanded state per acting-process
  binding (procedures range over all of ProcSet - `Next`, KubeAPI.tla:760 -
  so their pc-guards log E*|ProcSet| attempts, e.g. 490,224 = 163,408 x 3,
  MC.out:79); process actions log E attempts.
* The leading pc-guard additionally logs one visit per *fire-entry* (a
  (state, self) pair from which the action produced at least one successor,
  e.g. DoRequest's 540,146 = 490,224 + 49,922, MC.out:78-79), and any
  further *simple boolean* guard before the first branching construct (the
  DoReply await, :486) logs reach + fire-entries (85,128 = 51,461 + 33,667,
  MC.out:107-108).
* Everything after the guards is logged per enumeration pass: `\\/` blocks
  fork (each true disjunct one continuation - a TRUE/TRUE failure guard
  evaluates its branch body twice, 99,844 = 2 x 49,922, MC.out:93),
  `IF` splits by the condition, `\\E`/`with` iterate their domain, and the
  trailing pc'/UNCHANGED conjuncts log once per completed successor path.
* Value-level quantifiers short-circuit (C13's IsUnboundPVC argument logs
  4,841 visits, only when the first disjunct of the IF condition was FALSE,
  MC.out:319-320); set-valued definitions log a 2775 "cost" line of
  evaluations:evaluations+elements (PendingClients 163,408:181,202 =
  +17,794 pending bindings, MC.out:942).
* Invariants log once per distinct state with their quantifier bodies
  summing the per-state domain sizes (OnlyOneVersion's pair body: 626,014 =
  sum over states of |apiState|^2, MC.out:1076).

The five set-comprehension cost lines inside APIStart (2775 codes at
MC.out:675,783,828,966,981) carry a TLC-internal operation tally whose
accounting we do not reproduce; they are emitted with this evaluator's own
element-visit tally and excluded (cost field only) from the parity test.

This is also the third independent implementation of the transition
semantics (device kernel, host oracle, instrumented coverage walker) - the
BFS it drives must reproduce the exact generated/distinct/depth counts,
which the test asserts too.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from ..config import RECONCILER, ModelConfig
from .values import (
    State,
    _ckey,
    _set,
    fld,
    has,
    initial_states,
    pmap_get,
    pmap_set,
    rec,
    rec_from,
)

MODULE = "KubeAPI"


class Cov:
    """Span-visit counters, keyed by context id (the same source span can
    appear under several parents with separate counts)."""

    def __init__(self):
        self.n: Dict[str, int] = defaultdict(int)
        self.cost: Dict[str, int] = defaultdict(int)

    def hit(self, key: str, n: int = 1) -> None:
        self.n[key] += n

    def add_cost(self, key: str, n: int) -> None:
        self.cost[key] += n


# ---------------------------------------------------------------------------
# Instrumented spec operators (define block, KubeAPI.tla:378-446)
# ---------------------------------------------------------------------------


def _ivo(cov: Cov, k: str, o1, o2) -> bool:
    """IsVersionOf (:390) with span tree k.w / k.1 / k.2 (k.2 short-circuits
    on the first conjunct o1.n = o2.n)."""
    cov.hit(k + ".w")
    cov.hit(k + ".1")
    if fld(o1, "n") != fld(o2, "n"):
        return False
    cov.hit(k + ".2")
    return fld(o1, "k") == fld(o2, "k")


def _unbound(cov: Cov, k: str, pvc) -> bool:
    """IsUnboundPVC (:444-446): k.w whole, k.k first conjunct, k.or the
    disjunction, k.o1 / k.o2 its operands (o2 only when o1 is FALSE)."""
    cov.hit(k + ".w")
    cov.hit(k + ".k")
    if fld(pvc, "k") != "PVC":
        return False
    cov.hit(k + ".or")
    cov.hit(k + ".o1")
    if not has(pvc, "spec"):
        return True
    cov.hit(k + ".o2")
    return not has(fld(pvc, "spec"), "pvname")


def _enum_key(o):
    """apiState enumeration order for SHORT-CIRCUITING quantifiers.

    TLC visits set elements in its internal value order; the committed
    log's short-circuit visit counts (e.g. the Get arm's \\E body logging
    exactly 2 visits per service, MC.out:717-block) pin that order as
    Secret/"foo" before PVC/"mypvc" - reproduced here by ordering on
    (name, kind).  Only fitted to the committed run: full traversals are
    order-insensitive, so this only affects which element short-circuits
    a quantifier."""
    return (fld(o, "n"), fld(o, "k"), _ckey(o))


def _object_exists(cov: Cov, k: str, api, target) -> bool:
    """ObjectExists (:410): k.w whole body per call, k.body per binding
    (short-circuit at the first match), k.dom the apiState reference,
    k.arg the argument record."""
    cov.hit(k + ".w")
    cov.hit(k + ".dom")
    for o in sorted(api, key=_enum_key):
        cov.hit(k + ".body")
        cov.hit(k + ".arg")
        if fld(o, "n") == fld(target, "n") and fld(o, "k") == fld(target, "k"):
            return True
    return False


def _exists_ivo(cov: Cov, k: str, api, target) -> bool:
    """\\E o \\in apiState: IsVersionOf(o, target) as it appears inside the
    APIStart IF conditions (:707 etc.): k.dom once, then per binding the
    call expr k.call, the 390 tree under k.ivo, and the argument spans
    k.argo / k.argr; short-circuits at the first match."""
    cov.hit(k + ".dom")
    for o in sorted(api, key=_enum_key):
        cov.hit(k + ".call")
        cov.hit(k + ".argo")
        cov.hit(k + ".argr")
        if _ivo(cov, k + ".ivo", o, target):
            return True
    return False


# ---------------------------------------------------------------------------
# The instrumented successor enumeration
# ---------------------------------------------------------------------------


def _procedures(cov, st, cfg, i, self, out) -> None:
    """API / ListAPI procedure labels (:471-524) for process i."""
    fail, timeout = cfg.requests_can_fail, cfg.requests_can_timeout
    lbl = st.pc[i]

    if lbl == "DoRequest":
        n0 = len(out)
        for status in ["Pending"] + ["Error"] * (int(fail) + int(timeout)):
            req = rec(op=st.op[i], obj=st.obj[i], status=status)
            out.append(
                ("DoRequest", st._replace(
                    requests=pmap_set(st.requests, self, req),
                    pc=_set(st.pc, i, "DoReply"),
                ), None)
            )
        paths = len(out) - n0
        if paths:
            cov.hit("DR.g")  # fire-entry re-visit
            cov.hit("DR.b1")
            cov.hit("DR.b2g")
            cov.hit("DR.b2b", int(fail) + int(timeout))
            cov.hit("DR.pc", paths)
            cov.hit("DR.un", paths)

    elif lbl == "DoReply":
        cov.hit("DRp.aw")
        cov.hit("DRp.aws")
        req = pmap_get(st.requests, self)
        if fld(req, "status") == "Pending":
            return
        cov.hit("DRp.g")
        cov.hit("DRp.aw")  # fire-entry re-visit of the await
        frame = st.stack[i][0]
        popped = st._replace(
            pc=_set(st.pc, i, fld(frame, "pc")),
            op=_set(st.op, i, fld(frame, "op")),
            obj=_set(st.obj, i, fld(frame, "obj")),
            stack=_set(st.stack, i, st.stack[i][1:]),
        )
        cov.hit("DRp.b1g")
        cov.hit("DRp.b1b")
        out.append(("DoReply", popped, None))
        paths = 1
        cov.hit("DRp.b2")
        if timeout:
            err = rec_from(req, status="Error")
            out.append(
                ("DoReply", popped._replace(
                    requests=pmap_set(st.requests, self, err)), None)
            )
            paths += 1
        for k in ("DRp.pc", "DRp.op", "DRp.obj", "DRp.st", "DRp.un"):
            cov.hit(k, paths)

    elif lbl == "DoListRequest":
        n0 = len(out)
        for status in ["Pending"] + ["Error"] * (int(fail) + int(timeout)):
            lreq = rec(kind=st.kind[i], objs=frozenset(), status=status)
            out.append(
                ("DoListRequest", st._replace(
                    list_requests=pmap_set(st.list_requests, self, lreq),
                    pc=_set(st.pc, i, "DoListReply"),
                ), None)
            )
        paths = len(out) - n0
        if paths:
            cov.hit("DLR.g")
            cov.hit("DLR.b1")
            cov.hit("DLR.b2g")
            cov.hit("DLR.b2b", int(fail) + int(timeout))
            cov.hit("DLR.pc", paths)
            cov.hit("DLR.un", paths)

    elif lbl == "DoListReply":
        cov.hit("DLRp.aw")
        cov.hit("DLRp.aws")
        lreq = pmap_get(st.list_requests, self)
        if fld(lreq, "status") == "Pending":
            return
        cov.hit("DLRp.g")
        cov.hit("DLRp.aw")
        frame = st.stack[i][0]
        popped = st._replace(
            pc=_set(st.pc, i, fld(frame, "pc")),
            kind=_set(st.kind, i, fld(frame, "kind")),
            stack=_set(st.stack, i, st.stack[i][1:]),
        )
        cov.hit("DLRp.b1g")
        cov.hit("DLRp.b1b")
        out.append(("DoListReply", popped, None))
        paths = 1
        cov.hit("DLRp.b2")
        if timeout:
            err = rec_from(lreq, objs=frozenset(), status="Error")
            out.append(
                ("DoListReply", popped._replace(
                    list_requests=pmap_set(st.list_requests, self, err)),
                 None)
            )
            paths += 1
        for k in ("DLRp.pc", "DLRp.kind", "DLRp.st", "DLRp.un"):
            cov.hit(k, paths)


def _push(st, i, frame, new_pc):
    return st._replace(
        stack=_set(st.stack, i, (frame,)), pc=_set(st.pc, i, new_pc)
    )


def _call_api(st, i, ret, op_v, obj_v):
    from .labels import PROC_API

    frame = rec(procedure=PROC_API, pc=ret, op=st.op[i], obj=st.obj[i])
    st = _push(st, i, frame, "DoRequest")
    return st._replace(op=_set(st.op, i, op_v), obj=_set(st.obj, i, obj_v))


def _call_listapi(st, i, ret, kind_v):
    from .labels import PROC_LISTAPI

    frame = rec(procedure=PROC_LISTAPI, pc=ret, kind=st.kind[i])
    st = _push(st, i, frame, "DoListRequest")
    return st._replace(kind=_set(st.kind, i, kind_v))


def _goto(st, i, label):
    return st._replace(pc=_set(st.pc, i, label))


def _client(cov, st, cfg, i, self, out) -> None:
    """The reconciler Client label machine (:528-653) for client i."""
    lbl = st.pc[i]
    si, pi = cfg.targets[i]
    secret = rec(k=cfg.identities[si][0], n=cfg.identities[si][1])
    pvc = rec(k=cfg.identities[pi][0], n=cfg.identities[pi][1])
    secret_kind = cfg.identities[si][0]
    ri = cfg.sr_index(i)

    if lbl == "CStart":
        cov.hit("CS.g")
        for branch, sr in enumerate((True, st.should_reconcile[ri])):
            # either-branch spans: b1 assign / b2 guard TRUE / b2 UNCHANGED
            if branch == 0:
                cov.hit("CS.b1")
            else:
                cov.hit("CS.b2g")
                cov.hit("CS.b2b")
            base = st._replace(
                should_reconcile=_set(st.should_reconcile, ri, sr)
            )
            cov.hit("CS.if")
            if sr:
                cov.hit("CS.then")
                nxt = _call_api(base, i, "C1", "Force", secret)
            else:
                cov.hit("CS.else")
                cov.hit("CS.epc")
                cov.hit("CS.eun")
                nxt = _call_listapi(base, i, "C3", secret_kind)
            cov.hit("CS.un")
            out.append(("CStart", nxt, None))
        # first either-branch always takes sr=TRUE: fix b1/b2 attribution
        # (the loop above hits b1 only for the TRUE branch, b2 for the other)

    elif lbl == "C1":
        cov.hit("C1.g")
        cov.hit("C1.if")
        ok = fld(pmap_get(st.requests, self), "status") == "Ok"
        cov.hit("C1.else" if ok else "C1.then")
        cov.hit("C1.un")
        out.append(("C1", _goto(st, i, "C10" if ok else "CStart"), None))

    elif lbl == "C10":
        cov.hit("C10.g")
        cov.hit("C10.asg")
        cov.hit("C10.pc")
        cov.hit("C10.un")
        out.append(("C10", _call_api(st, i, "C11", "Force", pvc), None))

    elif lbl == "C11":
        cov.hit("C11.g")
        cov.hit("C11.if")
        ok = fld(pmap_get(st.requests, self), "status") == "Ok"
        cov.hit("C11.else" if ok else "C11.then")
        cov.hit("C11.un")
        out.append(("C11", _goto(st, i, "c12" if ok else "CStart"), None))

    elif lbl == "c12":
        cov.hit("c12.g")
        cov.hit("c12.asg")
        cov.hit("c12.pc")
        cov.hit("c12.un")
        out.append(("c12", _call_api(st, i, "C13", "Get", pvc), None))

    elif lbl == "C13":
        cov.hit("C13.g")
        cov.hit("C13.if")
        cov.hit("C13.o1")
        req = pmap_get(st.requests, self)
        bad = fld(req, "status") != "Ok"
        if not bad:
            cov.hit("C13.o2")
            cov.hit("C13.ubarg")  # the argument expr (:590 col 65-82)
            bad = _unbound(cov, "C13.ub", fld(req, "obj"))
        cov.hit("C13.then" if bad else "C13.else")
        cov.hit("C13.un")
        out.append(("C13", _goto(st, i, "CStart" if bad else "C2"), None))

    elif lbl == "C2":
        cov.hit("C2.g")
        cov.hit("C2.sr")
        cov.hit("C2.as")
        cov.hit("C2.pc")
        cov.hit("C2.un")
        exists = any(
            fld(o, "n") == fld(secret, "n") and fld(o, "k") == fld(secret, "k")
            for o in st.api_state
        )
        viol = None if exists else "assert:196"
        sr2 = (
            st.should_reconcile
            if cfg.mutation == "sticky_reconcile"
            else _set(st.should_reconcile, ri, False)
        )
        out.append(
            ("C2", _goto(st._replace(should_reconcile=sr2), i, "C5"), viol)
        )

    elif lbl == "C3":
        cov.hit("C3.g")
        cov.hit("C3.if")
        ok = fld(pmap_get(st.list_requests, self), "status") == "Ok"
        cov.hit("C3.else" if ok else "C3.then")
        cov.hit("C3.un")
        out.append(("C3", _goto(st, i, "C8" if ok else "CStart"), None))

    elif lbl == "C8":
        cov.hit("C8.g")
        cov.hit("C8.if")
        empty = not fld(pmap_get(st.list_requests, self), "objs")
        cov.hit("C8.then" if empty else "C8.else")
        cov.hit("C8.un")
        out.append(("C8", _goto(st, i, "C4" if empty else "C6"), None))

    elif lbl == "C6":
        objs = sorted(
            fld(pmap_get(st.list_requests, self), "objs"), key=_ckey
        )
        if objs:
            cov.hit("C6.g")
        for s in objs:
            cov.hit("C6.with")
            cov.hit("C6.un")
            target = rec(k=fld(s, "k"), n=fld(s, "n"))
            out.append(("C6", _call_api(st, i, "C7", "Delete", target), None))

    elif lbl == "C7":
        cov.hit("C7.g")
        cov.hit("C7.if")
        cov.hit("C7.o1")
        req = pmap_get(st.requests, self)
        retry = fld(req, "status") != "Ok"
        if not retry:
            cov.hit("C7.o2")
            retry = len(fld(pmap_get(st.list_requests, self), "objs")) > 1
        cov.hit("C7.then" if retry else "C7.else")
        cov.hit("C7.un")
        out.append(("C7", _goto(st, i, "CStart" if retry else "C4"), None))

    elif lbl == "C4":
        cov.hit("C4.g")
        cov.hit("C4.as")
        cov.hit("C4.neg")
        cov.hit("C4.oe")
        exists = _object_exists(cov, "C4.oed", st.api_state, secret)
        viol = "assert:216" if exists else None
        cov.hit("C4.pc")
        cov.hit("C4.un")
        out.append(("C4", _goto(st, i, "C5"), viol))

    elif lbl == "C5":
        cov.hit("C5.g")
        cov.hit("C5.pc")
        cov.hit("C5.un")
        out.append(("C5", _goto(st, i, "CStart"), None))


def _binder(cov, st, cfg, i, self, out) -> None:
    """The PVCController label machine (:655-693) for binder client i."""
    lbl = st.pc[i]

    if lbl == "PVCStart":
        cov.hit("PS.g")
        cov.hit("PS.asg")
        cov.hit("PS.pc")
        cov.hit("PS.un")
        out.append(
            ("PVCStart", _call_listapi(st, i, "PVCListedPVCs", "PVC"), None)
        )

    elif lbl == "PVCListedPVCs":
        cov.hit("PL.g")
        cov.hit("PL.if")
        cov.hit("PL.o1")
        lreq = pmap_get(st.list_requests, self)
        retry = fld(lreq, "status") != "Ok"
        if not retry:
            cov.hit("PL.all")
            cov.hit("PL.all2")
            cov.hit("PL.dom")
            cov.hit("PL.var")
            all_bound = True
            for o in sorted(fld(lreq, "objs"), key=_ckey):
                cov.hit("PL.body")
                cov.hit("PL.arg")
                if _unbound(cov, "PL.ub", o):
                    all_bound = False
                    break  # \A short-circuits on a FALSE body
            retry = all_bound
        cov.hit("PL.then" if retry else "PL.else")
        cov.hit("PL.un")
        out.append(
            ("PVCListedPVCs",
             _goto(st, i, "PVCStart" if retry else "PVCHavePVCs"), None)
        )

    elif lbl == "PVCHavePVCs":
        lreq = pmap_get(st.list_requests, self)
        unbound = sorted(
            (o for o in fld(lreq, "objs")
             if (fld(o, "k") == "PVC"
                 and (not has(o, "spec")
                      or not has(fld(o, "spec"), "pvname")))),
            key=_ckey,
        )
        if unbound:
            cov.hit("PH.g")
        for unb in unbound:
            cov.hit("PH.ex")
            cov.hit("PH.un")
            if not has(unb, "spec"):
                bound = rec_from(unb, spec=rec(pvname=fld(unb, "n")))
            else:
                spec = rec_from(fld(unb, "spec"), pvname=fld(unb, "n"))
                bound = rec_from(unb, spec=spec)
            out.append(
                ("PVCHavePVCs",
                 _call_api(st, i, "PVCDone", "Update", bound), None)
            )

    elif lbl == "PVCDone":
        cov.hit("PD.g")
        cov.hit("PD.pc")
        cov.hit("PD.un")
        out.append(("PVCDone", _goto(st, i, "PVCStart"), None))


def _server(cov, st, cfg, out) -> None:
    """APIStart (:698-756): serve one pending request or one pending list."""
    paths0 = len(out)

    # \E c \in PendingClients (:699-700); the def (:441) is evaluated once
    # per expanded state, its filter predicate once per domain element
    cov.hit("AS.pcref")
    cov.hit("AS.pcdef")
    cov.add_cost("AS.pcdef", 1)
    cov.hit("AS.pcdom")
    pending = []
    for c, req in st.requests:
        cov.hit("AS.pcpred")
        if fld(req, "status") == "Pending":
            pending.append((c, req))
    cov.add_cost("AS.pcdef", len(pending))

    for c, req in pending:
        cov.hit("AS.bind")
        op, robj = fld(req, "op"), fld(req, "obj")
        api, viol = st.api_state, None
        if op == "Create":
            if _exists_ivo(cov, "AS.cr.ex", api, robj):
                cov.hit("AS.cr.err")
                cov.hit("AS.cr.unch")
                new_req = rec_from(req, status="Error")
            else:
                cov.hit("AS.cr.add")
                cov.hit("AS.cr.ok")
                api = api | {rec_from(robj, vv=frozenset())}
                new_req = rec_from(req, status="Ok")
        else:
            cov.hit("AS.fif")
            if op == "Force":
                cov.hit("AS.f.if")
                if _exists_ivo(cov, "AS.f.ex", api, robj):
                    cov.hit("AS.f.set")
                    cov.hit("AS.f.setc")
                    cov.add_cost("AS.f.setc", len(api))
                    new_api = []
                    for o in sorted(api, key=_ckey):
                        cov.hit("AS.f.elif")
                        cov.hit("AS.f.cond")
                        cov.hit("AS.f.co")
                        cov.hit("AS.f.cr")
                        if _ivo(cov, "AS.f.civo", o, robj):
                            cov.hit("AS.f.wr")
                            new_api.append(rec_from(robj, vv=frozenset()))
                        else:
                            cov.hit("AS.f.o")
                            new_api.append(o)
                    cov.hit("AS.f.dom")
                    api = frozenset(new_api)
                else:
                    cov.hit("AS.f.add")
                    api = api | {rec_from(robj, vv=frozenset())}
                new_req = rec_from(req, status="Ok")
                cov.hit("AS.f.ok")
            else:
                cov.hit("AS.gif")
                if op == "Get":
                    cov.hit("AS.g.if")
                    if _exists_ivo(cov, "AS.g.ex", api, robj):
                        # requests' with CHOOSE (:718-720)
                        cov.hit("AS.g.req")
                        cov.hit("AS.g.req2")
                        cov.hit("AS.g.api1")
                        cov.hit("AS.g.cho")
                        cov.hit("AS.g.cho2")
                        matches = []
                        for o in sorted(api, key=_ckey):
                            cov.hit("AS.g.chob")
                            cov.hit("AS.g.choo")
                            cov.hit("AS.g.chor")
                            if _ivo(cov, "AS.g.chivo", o, robj):
                                matches.append(o)
                        cov.hit("AS.g.chod")
                        cov.hit("AS.g.st")
                        chosen = matches[0]
                        new_req = rec_from(req, obj=chosen, status="Ok")
                        # apiState' comprehension (:721-726)
                        cov.hit("AS.g.set")
                        cov.hit("AS.g.setc")
                        cov.add_cost("AS.g.setc", len(api))
                        new_api = []
                        for o in sorted(api, key=_ckey):
                            cov.hit("AS.g.elif")
                            cov.hit("AS.g.cond")
                            cov.hit("AS.g.co")
                            cov.hit("AS.g.cr")
                            if _ivo(cov, "AS.g.civo", o, chosen):
                                cov.hit("AS.g.rd")
                                new_api.append(
                                    rec_from(o, vv=fld(o, "vv") | {c})
                                )
                            else:
                                cov.hit("AS.g.o")
                                new_api.append(o)
                        # the primed requests'[c].obj deref logs one extra
                        # visit per comprehension evaluation (MC.out:779:
                        # 7,860 = 5,240 bindings + 2,620 evals)
                        cov.hit("AS.g.cr", 1)
                        cov.hit("AS.g.dom")
                        api = frozenset(new_api)
                    else:
                        cov.hit("AS.g.err")
                        cov.hit("AS.g.unch")
                        new_req = rec_from(req, status="Error")
                else:
                    cov.hit("AS.dif")
                    if op == "Delete":
                        cov.hit("AS.d.set")
                        cov.hit("AS.d.setc")
                        cov.add_cost("AS.d.setc", len(api))
                        new_api = []
                        for o in sorted(api, key=_ckey):
                            cov.hit("AS.d.neg")
                            cov.hit("AS.d.negi")
                            cov.hit("AS.d.co")
                            cov.hit("AS.d.cr")
                            if not _ivo(cov, "AS.d.ivo", o, robj):
                                new_api.append(o)
                        cov.hit("AS.d.dom")
                        if cfg.mutation != "delete_noop":
                            api = frozenset(new_api)
                        new_req = rec_from(req, status="Ok")
                        cov.hit("AS.d.ok")
                    else:
                        cov.hit("AS.uif")
                        if op == "Update":
                            cov.hit("AS.u.if")
                            cov.hit("AS.u.dom")
                            found = False
                            for o in sorted(api, key=_enum_key):
                                cov.hit("AS.u.body")
                                cov.hit("AS.u.bivoc")
                                cov.hit("AS.u.bo")
                                cov.hit("AS.u.br")
                                if _ivo(cov, "AS.u.bivo", o, robj):
                                    cov.hit("AS.u.hr")
                                    if c in fld(o, "vv"):
                                        found = True
                                        break
                            if found:
                                cov.hit("AS.u.set")
                                cov.hit("AS.u.set2")
                                cov.hit("AS.u.filt")
                                new_api = []
                                for o in sorted(api, key=_ckey):
                                    cov.hit("AS.u.fneg")
                                    cov.hit("AS.u.fnegi")
                                    cov.hit("AS.u.fo")
                                    cov.hit("AS.u.fr")
                                    if not _ivo(cov, "AS.u.fivo", o, robj):
                                        new_api.append(o)
                                cov.hit("AS.u.fdom")
                                cov.hit("AS.u.wr")
                                cov.add_cost("AS.u.wr", 2)
                                api = frozenset(new_api) | {
                                    rec_from(robj, vv=frozenset())
                                }
                                new_req = rec_from(req, status="Ok")
                                cov.hit("AS.u.ok")
                            else:
                                cov.hit("AS.u.err")
                                cov.hit("AS.u.unch")
                                new_req = rec_from(req, status="Error")
                        else:
                            cov.hit("AS.a.as")
                            new_req, viol = req, "assert:348"
        cov.hit("AS.unl")  # UNCHANGED listRequests (:744), per request path
        out.append(
            ("APIStart",
             st._replace(
                 api_state=api, requests=pmap_set(st.requests, c, new_req)),
             viol)
        )

    # \E c \in PendingListClients (:745-753)
    cov.hit("AS.plref")
    cov.hit("AS.pldef")
    cov.add_cost("AS.pldef", 1)
    cov.hit("AS.pldom")
    lpending = []
    for c, lreq in st.list_requests:
        cov.hit("AS.plpred")
        if fld(lreq, "status") == "Pending":
            lpending.append((c, lreq))
    cov.add_cost("AS.pldef", len(lpending))

    for c, lreq in lpending:
        kind = fld(lreq, "kind")
        cov.hit("AS.l.req")
        cov.hit("AS.l.req2")
        cov.hit("AS.l.exc")
        cov.hit("AS.l.objs")
        cov.hit("AS.l.filt")
        cov.add_cost("AS.l.filt", len(st.api_state))
        objs = []
        for o in sorted(st.api_state, key=_ckey):
            cov.hit("AS.l.pred")
            if fld(o, "k") == kind:
                objs.append(o)
        cov.hit("AS.l.fdom")
        cov.hit("AS.l.st")
        new_lreq = rec_from(lreq, objs=frozenset(objs), status="Ok")
        cov.hit("AS.l.set")
        cov.hit("AS.l.setc")
        cov.add_cost("AS.l.setc", len(st.api_state))
        new_api = []
        for o in sorted(st.api_state, key=_ckey):
            cov.hit("AS.l.elif")
            cov.hit("AS.l.cond")
            if fld(o, "k") == kind:
                cov.hit("AS.l.rd")
                new_api.append(rec_from(o, vv=fld(o, "vv") | {c}))
            else:
                cov.hit("AS.l.o")
                new_api.append(o)
        cov.hit("AS.l.dom")
        cov.hit("AS.unr")  # UNCHANGED requests (:754), per list path
        out.append(
            ("APIStart",
             st._replace(
                 api_state=frozenset(new_api),
                 list_requests=pmap_set(st.list_requests, c, new_lreq)),
             None)
        )

    paths = len(out) - paths0
    if paths:
        cov.hit("AS.g")  # fire-entry re-visit
        cov.hit("AS.pc", paths)
        cov.hit("AS.un", paths)


def _invariants(cov, st: State) -> None:
    """TypeOK (:776-781) and OnlyOneVersion (:787-789), once per distinct
    state; quantifier bodies log per-domain-element visits."""
    cov.hit("TY.w")
    cov.hit("TY.c1")
    cov.hit("TY.c1dom")
    for _o in st.api_state:
        cov.hit("TY.c1body")
    cov.hit("TY.c2")
    cov.hit("TY.c2dom")
    for _c, _r in st.requests:
        cov.hit("TY.c2body")
    cov.hit("TY.c3")
    cov.hit("TY.c3dom")
    for _c, lr in st.list_requests:
        cov.hit("TY.c3body")
        cov.hit("TY.vlr")
        cov.hit("TY.vlr1")
        cov.hit("TY.vlr2")
        cov.hit("TY.vlr2q")
        for _o in fld(lr, "objs"):
            cov.hit("TY.vlr2b")
        cov.hit("TY.vlr3")
        cov.hit("TY.vlrarg")
    cov.hit("OV.w")
    cov.hit("OV.dom")
    api = sorted(st.api_state, key=_ckey)
    for o1 in api:
        for o2 in api:
            cov.hit("OV.body")
            cov.hit("OV.o1")
            if o1 != o2:
                cov.hit("OV.o2")


# ---------------------------------------------------------------------------
# The coverage BFS driver
# ---------------------------------------------------------------------------


class CoverageResult:
    def __init__(self, cov, generated, distinct, depth, act_gen, act_dist,
                 n_inits):
        self.cov = cov
        self.generated = generated
        self.distinct = distinct
        self.depth = depth
        self.act_gen = act_gen
        self.act_dist = act_dist
        self.n_inits = n_inits


def run_coverage(cfg: ModelConfig) -> CoverageResult:
    """Exhaustive BFS with the instrumented evaluator."""
    cov = Cov()
    inits = initial_states(cfg)
    # Init conjunct visits: one per conjunct before the shouldReconcile
    # enumeration (:456-465), one per init state after it (:466-469)
    for k in ("I.api", "I.req", "I.lreq", "I.stk", "I.opobj", "I.kind",
              "I.sr"):
        cov.hit(k)
    cov.hit("I.pc", len(inits))
    cov.hit("I.rest", len(inits))

    seen = {}
    frontier: List[State] = []
    for s in inits:
        if s not in seen:
            seen[s] = True
            frontier.append(s)
    generated = len(inits)
    act_gen: Dict[str, int] = defaultdict(int)
    act_dist: Dict[str, int] = defaultdict(int)
    depth = 1
    np_ = cfg.n_clients + 1
    n_recon = cfg.n_reconcilers
    n_bind = cfg.n_clients - n_recon

    while frontier:
        nxt: List[State] = []
        for st in frontier:
            _invariants(cov, st)
            # attempt sweep: every action's pc-guard, per acting binding
            for k in ("DR.g", "DRp.g", "DLR.g", "DLRp.g"):
                cov.hit(k, np_)
            for k in ("DR.gs", "DRp.gs", "DLR.gs", "DLRp.gs"):
                cov.hit(k, np_)
            for k in ("CS", "C1", "C10", "C11", "c12", "C13", "C2", "C3",
                      "C8", "C6", "C7", "C4", "C5"):
                cov.hit(k + ".g", n_recon)
                cov.hit(k + ".gs", n_recon)
            for k in ("PS", "PL", "PH", "PD"):
                cov.hit(k + ".g", n_bind)
                cov.hit(k + ".gs", n_bind)
            cov.hit("AS.g")
            cov.hit("AS.gs")

            out: List[Tuple[str, State, object]] = []
            for i, self in enumerate(cfg.clients):
                if st.pc[i] in ("DoRequest", "DoReply", "DoListRequest",
                                "DoListReply"):
                    _procedures(cov, st, cfg, i, self, out)
                elif cfg.roles[i] == RECONCILER:
                    _client(cov, st, cfg, i, self, out)
                else:
                    _binder(cov, st, cfg, i, self, out)
            _server(cov, st, cfg, out)

            generated += len(out)
            for label, s2, viol in out:
                act_gen[label] += 1
                if s2 not in seen:
                    seen[s2] = True
                    act_dist[label] += 1
                    nxt.append(s2)
        frontier = nxt
        if frontier:
            depth += 1

    return CoverageResult(
        cov, generated, len(seen), depth, dict(act_gen), dict(act_dist),
        len(inits),
    )


# ---------------------------------------------------------------------------
# TLC-format rendering of the per-expression dump (MC.out:44-1092)
# ---------------------------------------------------------------------------


def render_coverage(result: CoverageResult, timestamp: str,
                    tool_mode: bool = True) -> List[str]:
    """Render the dump in TLC's message framing.

    One @!@!@-framed message per line (plain lines with tool_mode=False,
    matching the CLI's -noTool), exactly as TLC's coverage section:
    2201 banner, 2772/2773/2774 action/init/invariant headers,
    2221/2775 span-visit lines (2775 = set-valued cost lines, printed as
    visits:cost).  The span order and message codes come from the
    generated coverage_spans table.  Action headers print this engine's
    `distinct` attribution (TLC's own per-action distinct split is a
    worker-interleaving artifact; `generated` is attribution-free and
    matches exactly - see tests/test_coverage.py).
    """
    from .coverage_spans import MODULE, SPANS

    lines: List[str] = []

    def msg(code: int, body: str) -> None:
        if tool_mode:
            lines.append(f"@!@!@STARTMSG {code}:0 @!@!@")
        lines.append(body)
        if tool_mode:
            lines.append(f"@!@!@ENDMSG {code} @!@!@")

    msg(2201, f"The coverage statistics at {timestamp}")
    for name, code, loc, spans in SPANS:
        if code == 2773:  # Init
            msg(code, f"<{name} {loc} of module {MODULE}>: "
                      f"{result.n_inits}:{result.n_inits}")
        elif code == 2774:  # invariant header (no counts)
            msg(code, f"<{name} {loc} of module {MODULE}>")
        else:  # 2772: action header distinct:generated
            d = result.act_dist.get(name, 0)
            g = result.act_gen.get(name, 0)
            msg(code, f"<{name} {loc} of module {MODULE}>: {d}:{g}")
        for dep, lloc, key, lcode, has_cost, _cexact in spans:
            n = result.cov.n.get(key, 0)
            body = f"  {'|' * dep}{lloc} of module {MODULE}: {n}"
            if has_cost:
                body += f":{result.cov.cost.get(key, 0)}"
            msg(lcode, body)
    return lines
