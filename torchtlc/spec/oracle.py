"""Host-side reference interpreter ("oracle") for the KubeAPI action system
(the port's copy of jaxtlc/spec/oracle.py, which imports no jax).

An explicit-state implementation of the semantics of the generated TLA+
translation KubeAPI.tla:455-763 (Init :455-469, one function per action
label :471-756, Next :760-763).  The port uses it to replay every liveness
lasso before it is shown (live.check): each step of a counterexample must
be one of `successors`, and its first state one of `initial_states`.

Process structure is config-driven (torchtlc.config): each RECONCILER
client runs the `process Client` label machine (KubeAPI.tla:161-220) over
its own target secret/PVC identities, each BINDER runs `process
PVCController` (KubeAPI.tla:225-260); Model_1 is the 1x1 instance.
`shouldReconcile` is a tuple of per-reconciler booleans (the spec's
`[{"Client"} -> BOOLEAN]`, KubeAPI.tla:465).

States are immutable nested tuples so they hash; records are represented as
tuples of sorted (field, value) pairs; TLA sets as frozensets.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from ..config import RECONCILER, ModelConfig
from .labels import DEFAULT_INIT, PROC_API, PROC_LISTAPI

# ---------------------------------------------------------------------------
# Value helpers: records are tuples of sorted (key, value) pairs.
# ---------------------------------------------------------------------------


def rec(**fields):
    return tuple(sorted(fields.items()))


def rec_from(pairs: Iterable[Tuple[str, object]], **updates):
    d = dict(pairs)
    d.update(updates)
    return tuple(sorted(d.items()))


def fld(r, name, default=None):
    for k, v in r:
        if k == name:
            return v
    return default


def has(r, name) -> bool:
    return any(k == name for k, _ in r)


# --- spec operators (KubeAPI.tla define block :378-446) --------------------


def is_version_of(o1, o2) -> bool:
    """IsVersionOf (KubeAPI.tla:390): name and kind match."""
    return fld(o1, "n") == fld(o2, "n") and fld(o1, "k") == fld(o2, "k")


def write(o):
    """Write (KubeAPI.tla:395): left-biased merge sets vv := {}."""
    return rec_from(o, vv=frozenset())


def read(o, c):
    """Read (KubeAPI.tla:399): add client c to the version vector."""
    return rec_from(o, vv=fld(o, "vv") | {c})


def has_read(o, c) -> bool:
    """HasRead (KubeAPI.tla:404)."""
    return c in fld(o, "vv")


def is_unbound_pvc(pvc) -> bool:
    """IsUnboundPVC (KubeAPI.tla:444-446)."""
    if fld(pvc, "k") != "PVC":
        return False
    if not has(pvc, "spec"):
        return True
    return not has(fld(pvc, "spec"), "pvname")


def object_exists(api_state, obj) -> bool:
    """ObjectExists (KubeAPI.tla:410)."""
    return any(is_version_of(o, obj) for o in api_state)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


class State(NamedTuple):
    """Full variable vector (vars, KubeAPI.tla:450-451)."""

    api_state: frozenset  # set of object records
    requests: tuple  # sorted ((client, request-record), ...) - partial fn
    list_requests: tuple  # sorted ((client, listreq-record), ...)
    pc: tuple  # per-process label, processes = clients + Server
    stack: tuple  # per-process tuple of frames (records)
    op: tuple  # per-process procedure param
    obj: tuple
    kind: tuple
    should_reconcile: tuple  # per-reconciler booleans


def pmap_get(m: tuple, c: str):
    for k, v in m:
        if k == c:
            return v
    return None


def pmap_set(m: tuple, c: str, v) -> tuple:
    d = dict(m)
    d[c] = v
    return tuple(sorted(d.items()))


def _set(t: tuple, i: int, v) -> tuple:
    return t[:i] + (v,) + t[i + 1 :]


def initial_states(cfg: ModelConfig) -> List[State]:
    """Init (KubeAPI.tla:455-469): shouldReconcile ranges over
    [reconcilers -> BOOLEAN] => 2^R states (2 in Model_1, MC.out:32)."""
    np_ = cfg.n_clients + 1
    base = dict(
        api_state=frozenset(),
        requests=(),
        list_requests=(),
        pc=tuple(
            "CStart" if r == RECONCILER else "PVCStart" for r in cfg.roles
        )
        + ("APIStart",),
        stack=((),) * np_,
        op=(DEFAULT_INIT,) * np_,
        obj=(DEFAULT_INIT,) * np_,
        kind=(DEFAULT_INIT,) * np_,
    )
    return [
        State(should_reconcile=bits, **base)
        for bits in itertools.product(
            (False, True), repeat=cfg.n_reconcilers
        )
    ]


# ---------------------------------------------------------------------------
# Successor relation
# ---------------------------------------------------------------------------


class Succ(NamedTuple):
    label: str  # action label that produced this successor
    state: State
    violation: Optional[str]  # assert-failure id, else None
    proc: int = -1  # acting process index (n_clients = the server)


def _ckey(v):
    """Total-order sort key for spec values (frozensets lack a total order)."""
    if isinstance(v, frozenset):
        return (1, tuple(sorted((_ckey(x) for x in v))))
    if isinstance(v, tuple):
        return (2, tuple(_ckey(x) for x in v))
    return (0, v)


def _push(st: State, i: int, frame, new_pc: str) -> State:
    """Common call-site shape (e.g. CStart :535-540): push one frame."""
    assert len(st.stack[i]) == 0, "procedures never nest in this spec"
    return st._replace(stack=_set(st.stack, i, (frame,)), pc=_set(st.pc, i, new_pc))


def _call_api(st: State, i: int, ret: str, op_v: str, obj_v) -> State:
    """call API(op, obj): frame stores the *old* op/obj (KubeAPI.tla:535-539)."""
    frame = rec(procedure=PROC_API, pc=ret, op=st.op[i], obj=st.obj[i])
    st = _push(st, i, frame, "DoRequest")
    return st._replace(op=_set(st.op, i, op_v), obj=_set(st.obj, i, obj_v))


def _call_listapi(st: State, i: int, ret: str, kind_v: str) -> State:
    frame = rec(procedure=PROC_LISTAPI, pc=ret, kind=st.kind[i])
    st = _push(st, i, frame, "DoListRequest")
    return st._replace(kind=_set(st.kind, i, kind_v))


def _goto(st: State, i: int, label: str) -> State:
    return st._replace(pc=_set(st.pc, i, label))


def successors(st: State, cfg: ModelConfig) -> List[Succ]:
    """Enumerate every satisfying assignment of Next (KubeAPI.tla:760-763).

    Each (action, nondeterministic-choice) combination yields one entry -
    matching TLC's generated-states accounting (MC.out:1098).
    """
    out: List[Succ] = []
    fail, timeout = cfg.requests_can_fail, cfg.requests_can_timeout
    proc_bounds: List[int] = []  # len(out) after each client's block

    for i, self in enumerate(cfg.clients):
        proc_bounds.append(len(out))
        lbl = st.pc[i]
        is_recon = cfg.roles[i] == RECONCILER
        if is_recon:
            si, pi = cfg.targets[i]
            secret = rec(k=cfg.identities[si][0], n=cfg.identities[si][1])
            pvc = rec(k=cfg.identities[pi][0], n=cfg.identities[pi][1])
            secret_kind = cfg.identities[si][0]
            ri = cfg.sr_index(i)

        if lbl == "DoRequest":
            # KubeAPI.tla:471-483 - either deliver Pending or (FAIL \/ TIMEOUT)
            # Error.  TLC enumerates each true disjunct of the guard
            # REQUESTS_CAN_FAIL \/ REQUESTS_CAN_TIMEOUT as its own branch, so
            # with both constants TRUE the Error successor is generated twice
            # (confirmed by MC.out:78 - 149,766 = 3 x 49,922 firings).
            lanes = ["Pending"] + ["Error"] * (int(fail) + int(timeout))
            for status in lanes:
                req = rec(op=st.op[i], obj=st.obj[i], status=status)
                nxt = st._replace(
                    requests=pmap_set(st.requests, self, req),
                    pc=_set(st.pc, i, "DoReply"),
                )
                out.append(Succ("DoRequest", nxt, None))

        elif lbl == "DoReply":
            # KubeAPI.tla:485-495 - guarded await, then skip or timeout-Error
            req = pmap_get(st.requests, self)
            if fld(req, "status") == "Pending":
                continue
            frame = st.stack[i][0]
            popped = st._replace(
                pc=_set(st.pc, i, fld(frame, "pc")),
                op=_set(st.op, i, fld(frame, "op")),
                obj=_set(st.obj, i, fld(frame, "obj")),
                stack=_set(st.stack, i, st.stack[i][1:]),
            )
            out.append(Succ("DoReply", popped, None))
            if timeout:
                err = rec_from(req, status="Error")
                nxt = popped._replace(requests=pmap_set(st.requests, self, err))
                out.append(Succ("DoReply", nxt, None))

        elif lbl == "DoListRequest":
            # KubeAPI.tla:499-511 - same per-disjunct enumeration of the
            # failure guard as DoRequest (MC.out:141 - 82,416 = 3 x 27,472).
            for status in ["Pending"] + ["Error"] * (int(fail) + int(timeout)):
                lreq = rec(kind=st.kind[i], objs=frozenset(), status=status)
                nxt = st._replace(
                    list_requests=pmap_set(st.list_requests, self, lreq),
                    pc=_set(st.pc, i, "DoListReply"),
                )
                out.append(Succ("DoListRequest", nxt, None))

        elif lbl == "DoListReply":
            # KubeAPI.tla:513-524
            lreq = pmap_get(st.list_requests, self)
            if fld(lreq, "status") == "Pending":
                continue
            frame = st.stack[i][0]
            popped = st._replace(
                pc=_set(st.pc, i, fld(frame, "pc")),
                kind=_set(st.kind, i, fld(frame, "kind")),
                stack=_set(st.stack, i, st.stack[i][1:]),
            )
            out.append(Succ("DoListReply", popped, None))
            if timeout:
                err = rec_from(lreq, objs=frozenset(), status="Error")
                nxt = popped._replace(list_requests=pmap_set(st.list_requests, self, err))
                out.append(Succ("DoListReply", nxt, None))

        elif lbl == "CStart":
            # KubeAPI.tla:528-549: either set TRUE or skip; the IF branches on
            # the NEW value (shouldReconcile').  Both either-branches are
            # always enumerated - when shouldReconcile is already TRUE they
            # coincide, and TLC still counts two generated states.
            for sr in (True, st.should_reconcile[ri]):
                base = st._replace(
                    should_reconcile=_set(st.should_reconcile, ri, sr)
                )
                if sr:
                    nxt = _call_api(base, i, "C1", "Force", secret)
                else:
                    nxt = _call_listapi(base, i, "C3", secret_kind)
                out.append(Succ("CStart", nxt, None))

        elif lbl == "C1":
            ok = fld(pmap_get(st.requests, self), "status") == "Ok"
            out.append(Succ("C1", _goto(st, i, "C10" if ok else "CStart"), None))

        elif lbl == "C10":
            out.append(Succ("C10", _call_api(st, i, "C11", "Force", pvc), None))

        elif lbl == "C11":
            ok = fld(pmap_get(st.requests, self), "status") == "Ok"
            out.append(Succ("C11", _goto(st, i, "c12" if ok else "CStart"), None))

        elif lbl == "c12":
            out.append(Succ("c12", _call_api(st, i, "C13", "Get", pvc), None))

        elif lbl == "C13":
            req = pmap_get(st.requests, self)
            ok = fld(req, "status") == "Ok" and not is_unbound_pvc(fld(req, "obj"))
            out.append(Succ("C13", _goto(st, i, "C2" if ok else "CStart"), None))

        elif lbl == "C2":
            # KubeAPI.tla:596-602 + assert at :196 (translated :598-599)
            viol = None if object_exists(st.api_state, secret) else "assert:196"
            sr2 = (
                st.should_reconcile
                if cfg.mutation == "sticky_reconcile"
                else _set(st.should_reconcile, ri, False)
            )
            nxt = _goto(st._replace(should_reconcile=sr2), i, "C5")
            out.append(Succ("C2", nxt, viol))

        elif lbl == "C3":
            ok = fld(pmap_get(st.list_requests, self), "status") == "Ok"
            out.append(Succ("C3", _goto(st, i, "C8" if ok else "CStart"), None))

        elif lbl == "C8":
            empty = not fld(pmap_get(st.list_requests, self), "objs")
            out.append(Succ("C8", _goto(st, i, "C4" if empty else "C6"), None))

        elif lbl == "C6":
            # KubeAPI.tla:618-629: with s \in listRequests[self].objs - one
            # lane per listed object
            for s in sorted(fld(pmap_get(st.list_requests, self), "objs"), key=_ckey):
                target = rec(k=fld(s, "k"), n=fld(s, "n"))
                out.append(Succ("C6", _call_api(st, i, "C7", "Delete", target), None))

        elif lbl == "C7":
            req = pmap_get(st.requests, self)
            lreq = pmap_get(st.list_requests, self)
            ok = fld(req, "status") == "Ok" and len(fld(lreq, "objs")) <= 1
            out.append(Succ("C7", _goto(st, i, "C4" if ok else "CStart"), None))

        elif lbl == "C4":
            viol = "assert:216" if object_exists(st.api_state, secret) else None
            out.append(Succ("C4", _goto(st, i, "C5"), viol))

        elif lbl == "C5":
            out.append(Succ("C5", _goto(st, i, "CStart"), None))

        elif lbl == "PVCStart":
            out.append(
                Succ("PVCStart", _call_listapi(st, i, "PVCListedPVCs", "PVC"), None)
            )

        elif lbl == "PVCListedPVCs":
            lreq = pmap_get(st.list_requests, self)
            unbound = [o for o in fld(lreq, "objs") if is_unbound_pvc(o)]
            ok = fld(lreq, "status") == "Ok" and unbound
            out.append(
                Succ(
                    "PVCListedPVCs",
                    _goto(st, i, "PVCHavePVCs" if ok else "PVCStart"),
                    None,
                )
            )

        elif lbl == "PVCHavePVCs":
            # KubeAPI.tla:673-688: one lane per unbound listed PVC; bound adds
            # spec.pvname := unb.n (LET at :675-678)
            lreq = pmap_get(st.list_requests, self)
            for unb in sorted(
                (o for o in fld(lreq, "objs") if is_unbound_pvc(o)), key=_ckey
            ):
                if not has(unb, "spec"):
                    bound = rec_from(unb, spec=rec(pvname=fld(unb, "n")))
                else:
                    spec = rec_from(fld(unb, "spec"), pvname=fld(unb, "n"))
                    bound = rec_from(unb, spec=spec)
                out.append(
                    Succ("PVCHavePVCs", _call_api(st, i, "PVCDone", "Update", bound), None)
                )

        elif lbl == "PVCDone":
            out.append(Succ("PVCDone", _goto(st, i, "PVCStart"), None))

        else:  # pragma: no cover
            raise AssertionError(f"unknown label {lbl!r}")

    proc_bounds.append(len(out))  # start of the server block
    out.extend(_server_lanes(st, cfg))
    # tag each successor with its acting process (client index or server):
    # client i's block is [proc_bounds[i], proc_bounds[i+1])
    tagged: List[Succ] = []
    for p in range(len(cfg.clients)):
        tagged.extend(
            s._replace(proc=p) for s in out[proc_bounds[p] : proc_bounds[p + 1]]
        )
    tagged.extend(
        s._replace(proc=cfg.n_clients) for s in out[proc_bounds[-1] :]
    )
    return tagged


def _server_lanes(st: State, cfg: ModelConfig) -> List[Succ]:
    """APIStart (KubeAPI.tla:698-756): one lane per pending (list-)client."""
    out: List[Succ] = []
    # \E c \in PendingClients (KubeAPI.tla:441, :699)
    for c, req in st.requests:
        if fld(req, "status") != "Pending":
            continue
        op, robj = fld(req, "op"), fld(req, "obj")
        api, viol = st.api_state, None
        if op == "Create":  # :700-705
            if object_exists(api, robj):
                new_req = rec_from(req, status="Error")
            else:
                api = api | {write(robj)}
                new_req = rec_from(req, status="Ok")
        elif op == "Force":  # :706-715
            if object_exists(api, robj):
                api = frozenset(
                    write(robj) if is_version_of(o, robj) else o for o in api
                )
            else:
                api = api | {write(robj)}
            new_req = rec_from(req, status="Ok")
        elif op == "Get":  # :716-728; CHOOSE is deterministic - exactly one match
            matches = sorted((o for o in api if is_version_of(o, robj)), key=_ckey)
            if matches:
                chosen = matches[0]
                new_req = rec_from(req, obj=chosen, status="Ok")
                api = frozenset(
                    read(o, c) if is_version_of(o, chosen) else o for o in api
                )
            else:
                new_req = rec_from(req, status="Error")
        elif op == "Delete":  # :729-731
            if cfg.mutation != "delete_noop":
                api = frozenset(o for o in api if not is_version_of(o, robj))
            new_req = rec_from(req, status="Ok")
        elif op == "Update":  # :732-739 - optimistic concurrency via HasRead
            if any(is_version_of(o, robj) and has_read(o, c) for o in api):
                api = frozenset(
                    o for o in api if not is_version_of(o, robj)
                ) | {write(robj)}
                new_req = rec_from(req, status="Ok")
            else:
                new_req = rec_from(req, status="Error")
        else:  # :740-741 assert FALSE
            new_req, viol = req, "assert:348"
        out.append(
            Succ(
                "APIStart",
                st._replace(api_state=api, requests=pmap_set(st.requests, c, new_req)),
                viol,
            )
        )
    # \E c \in PendingListClients (KubeAPI.tla:442, :745-753)
    for c, lreq in st.list_requests:
        if fld(lreq, "status") != "Pending":
            continue
        kind = fld(lreq, "kind")
        objs = frozenset(o for o in st.api_state if fld(o, "k") == kind)
        new_lreq = rec_from(lreq, objs=objs, status="Ok")
        api = frozenset(
            read(o, c) if fld(o, "k") == kind else o for o in st.api_state
        )
        out.append(
            Succ(
                "APIStart",
                st._replace(
                    api_state=api, list_requests=pmap_set(st.list_requests, c, new_lreq)
                ),
                None,
            )
        )
    return out


# ---------------------------------------------------------------------------
# Invariants (KubeAPI.tla:776-789)
# ---------------------------------------------------------------------------


def _is_valid_api_object(o) -> bool:
    """IsValidAPIObject (KubeAPI.tla:378-384)."""
    dom = {k for k, _ in o}
    return (
        {"n", "k"} <= dom
        and dom <= {"n", "k", "vv", "spec", "status"}
        and isinstance(fld(o, "n"), str)
        and isinstance(fld(o, "k"), str)
    )


def type_ok(st: State) -> bool:
    """TypeOK (KubeAPI.tla:776-781)."""
    if not all(_is_valid_api_object(o) for o in st.api_state):
        return False
    for _, r in st.requests:
        if {k for k, _ in r} != {"op", "obj", "status"}:
            return False
        if fld(r, "op") not in ("Create", "Get", "Update", "Delete", "Force"):
            return False
        if not _is_valid_api_object(fld(r, "obj")):
            return False
        if fld(r, "status") not in ("Pending", "Ok", "Error"):
            return False
    for _, r in st.list_requests:
        if {k for k, _ in r} != {"kind", "objs", "status"}:
            return False
        if not all(
            _is_valid_api_object(o) and fld(o, "k") == fld(r, "kind")
            for o in fld(r, "objs")
        ):
            return False
        if fld(r, "status") not in ("Pending", "Ok", "Error"):
            return False
    return True


def only_one_version(st: State) -> bool:
    """OnlyOneVersion (KubeAPI.tla:787-789)."""
    objs = list(st.api_state)
    for a in range(len(objs)):
        for b in range(a + 1, len(objs)):
            if is_version_of(objs[a], objs[b]):
                return False
    return True


# ---------------------------------------------------------------------------
# BFS driver (explicit-state; the TLC-equivalent host checker)
# ---------------------------------------------------------------------------


class BFSResult(NamedTuple):
    generated: int
    distinct: int
    depth: int
    max_outdegree: int
    min_outdegree: int
    violations: List[Tuple[str, State]]
    levels: List[int]  # distinct states per BFS level (level 1 = Init)


def bfs(
    cfg: ModelConfig,
    check_invariants: bool = True,
    max_states: int = 10_000_000,
    collect_levels: bool = False,
    on_level=None,
) -> BFSResult:
    """Level-synchronous BFS over the reachable state graph.

    Mirrors TLC's accounting: initial states count toward both generated and
    distinct (MC.out:29-32); every enumerated successor counts as generated;
    distinct = unique states; depth = number of BFS levels with Init at
    level 1 (MC.out:1101).
    """
    inits = initial_states(cfg)
    seen: Dict[State, int] = {}
    generated = 0
    violations: List[Tuple[str, State]] = []
    frontier: List[State] = []
    for s in inits:
        generated += 1
        if s not in seen:
            seen[s] = 1
            frontier.append(s)
    depth = 1
    levels = [len(frontier)]
    max_out, min_out = 0, 1 << 30
    while frontier:
        if on_level is not None:
            on_level(depth, frontier)
        nxt: List[State] = []
        for s in frontier:
            succs = successors(s, cfg)
            generated += len(succs)
            outdeg = len({x.state for x in succs})
            max_out = max(max_out, outdeg)
            min_out = min(min_out, outdeg)
            if outdeg == 0:
                violations.append(("deadlock", s))
            for x in succs:
                if x.violation:
                    violations.append((x.violation, s))
                if x.state not in seen:
                    seen[x.state] = depth + 1
                    nxt.append(x.state)
                    if check_invariants:
                        if not type_ok(x.state):
                            violations.append(("TypeOK", x.state))
                        if not only_one_version(x.state):
                            violations.append(("OnlyOneVersion", x.state))
        if len(seen) > max_states:
            raise RuntimeError("state-space bound exceeded")
        frontier = nxt
        if frontier:
            depth += 1
            levels.append(len(frontier))
    return BFSResult(
        generated, len(seen), depth, max_out, min_out, violations, levels
    )
