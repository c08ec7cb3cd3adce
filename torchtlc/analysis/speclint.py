"""Spec-layer lints over the struct frontend's IR (a copy of
jaxtlc/analysis/speclint.py, over the port's copies of the struct IR).

Works on exactly what the LaneCompiler consumes - the parsed module
ASTs (struct.parser), the MC.cfg-resolved constants (struct.loader),
the inferred shapes (struct.shapes) and the codec layout
(struct.codec) - WITHOUT building a step function or touching XLA, so
the whole pass is milliseconds of host Python:

* **Action decomposition** mirrors the lane walker's label attribution
  (struct/compile.py `_walk_seq` / struct/actions.py `_enum`): the
  innermost expanded non-disjunction definition names the action, `\\/`
  and action-position `\\E` fork branches, `var' = e` / `var' \\in S`
  are writes, everything else is a guard.
* **Read/write sets** per action: a variable is READ when its
  pre-state value is mentioned (through any definition expansion),
  WRITTEN when primed-assigned.  UNCHANGED vars are identity updates -
  neither (identity commutes with everything).  These sets are the
  groundwork for the ROADMAP #5 invariant-inference direction: two
  actions are *independent* when neither writes what the other touches
  (the classic partial-order-reduction condition).
* **Unreachable actions**: a guard conjunct that mentions no state
  variable and no binder evaluates at preflight under the MC.cfg
  constant overrides (TLC's level-0 constant evaluation); FALSE on
  every branch means the action can never fire.
* **Invariant vacuity**: an INVARIANT that reads no state variable is
  checking nothing about the run.
* **Slot/trap budget**: an action-position `\\E x \\in S` over a
  STATE-DEPENDENT set compiles to SLOT_CAP k-th-set-bit lanes when the
  element universe exceeds UNROLL_LIMIT; a reachable state whose set
  grows past SLOT_CAP then halts the device run with
  VIOL_SLOT_OVERFLOW.  The audit bounds the universe statically and
  names the action up front.  Dynamic sequence reads (`s[expr]`) are
  reported as trap sites, with their IF/CASE branch gating noted - the
  RaftReplication false-trap class (PERF.md round 7) as a line in a
  report instead of a dead device run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from ..struct.codec import StructCodec
from ..struct.parser import Definition
from ..struct.shapes import (
    SSeq,
    SUnion,
    ShapeError,
    ShapeInference,
    infer_shapes,
    typeok_hints,
    universe,
)
from . import SEV_WARNING, Finding

# the LaneCompiler's fan-out constants (struct/compile.py); imported
# rather than duplicated so the audit can never drift from the compiler
from ..struct.compile import SLOT_CAP, UNROLL_LIMIT


@dataclasses.dataclass
class ActionInfo:
    """Static summary of one named action across all its branches."""

    name: str
    reads: Set[str] = dataclasses.field(default_factory=set)
    writes: Set[str] = dataclasses.field(default_factory=set)
    unchanged: Set[str] = dataclasses.field(default_factory=set)
    n_branches: int = 0
    n_disabled: int = 0  # branches with a statically-FALSE guard
    slot_binders: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list
    )  # (binder name, element-universe size) on the mask/slot path
    seq_reads: int = 0  # dynamic sequence index sites
    gated_seq_reads: int = 0  # of those, inside an IF/CASE branch


@dataclasses.dataclass
class SpecAnalysis:
    root: str
    variables: Tuple[str, ...]
    n_fields: int  # codec lanes per state vector
    actions: Dict[str, ActionInfo]
    invariant_reads: Dict[str, Set[str]]
    independent_pairs: List[Tuple[str, str]]
    findings: List[Finding]


# ---------------------------------------------------------------------------
# Free state-variable reads (with definition expansion)
# ---------------------------------------------------------------------------


def _state_reads(ast, variables, defs, bound, out: Set[str],
                 seen: Optional[Set[str]] = None) -> None:
    """Collect state variables whose PRE-state value `ast` mentions.
    Primed mentions are not pre-state reads (ordered processing: a
    primed read follows its own assignment, struct/actions.py docstring);
    UNCHANGED contributes nothing (identity)."""
    if seen is None:
        seen = set()
    stack = [(ast, frozenset(bound))]
    while stack:
        node, bnd = stack.pop()
        if isinstance(node, list):
            stack.extend((x, bnd) for x in node)
            continue
        if not isinstance(node, tuple) or not node:
            continue
        op = node[0]
        if op in ("prime", "unchanged"):
            continue
        if op == "name" and len(node) == 2 and isinstance(node[1], str):
            nm = node[1]
            if nm in bnd:
                continue
            if nm in variables:
                out.add(nm)
                continue
            d = defs.get(nm)
            if d is not None and not d.params and nm not in seen:
                seen.add(nm)
                stack.append((d.body, bnd))
            continue
        if op == "call" and len(node) == 3 and isinstance(node[1], str):
            nm = node[1]
            d = defs.get(nm)
            stack.extend((a, bnd) for a in node[2])
            if d is not None and nm not in seen:
                seen.add(nm)
                stack.append((d.body, bnd | frozenset(d.params)))
            continue
        if op in ("exists", "forall") and len(node) == 4:
            _, names, dom_ast, body = node
            stack.append((dom_ast, bnd))
            stack.append((body, bnd | frozenset(names)))
            continue
        if op in ("setfilter", "choose") and len(node) == 4:
            _, var, dom_ast, body = node
            stack.append((dom_ast, bnd))
            stack.append((body, bnd | {var}))
            continue
        if op == "setmap" and len(node) == 4:
            _, expr, var, dom_ast = node
            stack.append((dom_ast, bnd))
            stack.append((expr, bnd | {var}))
            continue
        if op == "fnlit" and len(node) == 4:
            _, var, dom_ast, body = node
            stack.append((dom_ast, bnd))
            stack.append((body, bnd | {var}))
            continue
        if op == "let" and len(node) == 3 and isinstance(node[1], list):
            b2 = bnd
            for name, params, body in node[1]:
                stack.append((body, b2 | frozenset(params)))
                b2 = b2 | {name}
            stack.append((node[2], b2))
            continue
        # generic node; when the head is not an op string (record
        # fields, EXCEPT path groups), the first element is data too
        start = 1 if isinstance(op, str) else 0
        stack.extend((x, bnd) for x in node[start:]
                     if isinstance(x, (tuple, list)))


def _mentions_any(ast, names: Set[str], defs, seen=None) -> bool:
    """True when `ast` mentions any of `names` as a bare name (through
    definition expansion), or mentions a prime/UNCHANGED - used to
    classify guards as binder- or state-dependent."""
    if seen is None:
        seen = set()
    stack = [ast]
    while stack:
        node = stack.pop()
        if isinstance(node, list):
            stack.extend(node)
            continue
        if not isinstance(node, tuple) or not node:
            continue
        op = node[0]
        if op in ("prime", "unchanged"):
            return True  # primed mention: not constant-evaluable
        if op in ("name", "call") and len(node) >= 2 \
                and isinstance(node[1], str):
            nm = node[1]
            if nm in names:
                return True
            d = defs.get(nm)
            if d is not None and nm not in seen:
                seen.add(nm)
                stack.append(d.body)
            if op == "call":
                stack.extend(x for x in node[2]
                             if isinstance(x, (tuple, list)))
            continue
        start = 1 if isinstance(op, str) else 0
        stack.extend(x for x in node[start:]
                     if isinstance(x, (tuple, list)))
    return False


# ---------------------------------------------------------------------------
# Action decomposition (syntactic mirror of the lane walker)
# ---------------------------------------------------------------------------


class _Branch:
    __slots__ = ("bound", "guards", "writes", "unchanged", "reads",
                 "slot_binders", "seq_reads", "gated_seq_reads",
                 "disabled", "senv")

    def __init__(self):
        self.bound: Set[str] = set()
        self.guards: List[tuple] = []
        self.writes: Set[str] = set()
        self.unchanged: Set[str] = set()
        self.reads: Set[str] = set()
        self.slot_binders: List[Tuple[str, int]] = []
        self.seq_reads = 0
        self.gated_seq_reads = 0
        self.disabled = False
        # binder/param name -> inferred Shape (or Definition), so the
        # shape oracle can classify expressions UNDER the binders (the
        # RaftReplication trap sits inside LastTerm(log[i]))
        self.senv: dict = {}

    def fork(self) -> "_Branch":
        b = _Branch()
        b.bound = set(self.bound)
        b.guards = list(self.guards)
        b.writes = set(self.writes)
        b.unchanged = set(self.unchanged)
        b.reads = set(self.reads)
        b.slot_binders = list(self.slot_binders)
        b.seq_reads = self.seq_reads
        b.gated_seq_reads = self.gated_seq_reads
        b.disabled = self.disabled
        b.senv = dict(self.senv)
        return b


class _SpecWalker:
    def __init__(self, model, var_shapes,
                 dynamic_consts=frozenset(), const_hints=None):
        self.model = model
        self.system = model.system
        self.ev = self.system.ev
        self.variables = set(self.system.variables)
        self.defs = self.ev.defs
        self.var_shapes = var_shapes
        # constants swept over a range (jaxtlc.analysis --sweep): not
        # constant-evaluable - guards mentioning them are classified
        # like state-dependent ones, so the class audit never calls an
        # action unreachable on the strength of ONE configuration
        self.dynamic_consts = frozenset(dynamic_consts)
        # shape oracle for quantifier-domain classification: reuse the
        # compiler's own abstract interpreter over the final shapes
        self._inf = ShapeInference.__new__(ShapeInference)
        self._inf.ev = self.ev
        self._inf.variables = self.system.variables
        self._inf.var_shapes = dict(var_shapes)
        if const_hints:
            self._inf.const_hints = dict(const_hints)
        self.branches: Dict[str, List[_Branch]] = {}

    # -- helpers -----------------------------------------------------------

    def _reads(self, ast, br: _Branch) -> None:
        _state_reads(ast, self.variables, self.defs, br.bound, br.reads)

    def _shape_env(self, br: _Branch) -> dict:
        env = {v: s for v, s in self.var_shapes.items()}
        env.update(br.senv)
        return env

    def _abs(self, ast, env):
        """Best-effort shape of `ast` under `env` via the compiler's
        abstract interpreter; None when it cannot be bounded."""
        try:
            return self._inf._abstract(ast, env)
        except (ShapeError, KeyError, TypeError, ValueError,
                RecursionError):
            return None

    def _dom_universe(self, dom_ast, br: _Branch) -> Optional[int]:
        """Element-universe size of a quantifier domain, or None when
        the shape oracle cannot bound it."""
        sh = self._abs(dom_ast, self._shape_env(br))
        if sh is None:
            return None
        elem = self._inf._elem_shape(sh)
        if elem is None:
            return None
        try:
            return len(universe(elem, 1 << 16))
        except ShapeError:
            return None

    def _audit_traps(self, ast, br: _Branch, gated: bool, env,
                     seen: Optional[frozenset] = None) -> None:
        """Count dynamic sequence reads (`s[expr]`, expr non-literal)
        and whether they sit inside an IF/CASE branch - where the
        compiler gates their trap effect by the branch condition, the
        RaftReplication false-trap fix (PERF.md round 7).  Definitions
        expand with their parameter shapes bound (LastTerm(log[i])'s
        `s[Len(s)]` is a seq read only once `s`'s shape is known), once
        per path (cycle-guarded)."""
        if seen is None:
            seen = frozenset()
        if isinstance(ast, list):
            for x in ast:
                self._audit_traps(x, br, gated, env, seen)
            return
        if not isinstance(ast, tuple) or not ast:
            return
        op = ast[0]
        if op == "apply" and len(ast) == 3 and isinstance(ast[2], tuple) \
                and ast[2][0] not in ("str", "num"):
            sh = self._abs(ast[1], env)
            if isinstance(sh, SSeq) or (
                isinstance(sh, SUnion)
                and any(isinstance(a, SSeq) for a in sh.alts)
            ):
                br.seq_reads += 1
                if gated:
                    br.gated_seq_reads += 1
        if op in ("name", "call") and len(ast) >= 2 \
                and isinstance(ast[1], str):
            d = env.get(ast[1])
            if not isinstance(d, Definition):
                d = self.defs.get(ast[1])
            if isinstance(d, Definition) and ast[1] not in seen:
                env2 = dict(env)
                if op == "call" and len(ast) == 3:
                    for p, a in zip(d.params, ast[2]):
                        env2[p] = self._abs(a, env)
                self._audit_traps(d.body, br, gated, env2,
                                  seen | {ast[1]})
            if op == "call" and len(ast) == 3:
                for a in ast[2]:
                    self._audit_traps(a, br, gated, env, seen)
            return
        if op in ("exists", "forall", "setfilter", "choose") \
                and len(ast) == 4:
            names = ast[1] if op in ("exists", "forall") else (ast[1],)
            if isinstance(names, str):
                names = (names,)
            dom_ast, body = ast[2], ast[3]
            self._audit_traps(dom_ast, br, gated, env, seen)
            elem = self._inf._elem_shape(self._abs(dom_ast, env))
            env2 = dict(env)
            for nm in names:
                env2[nm] = elem
            self._audit_traps(body, br, gated, env2, seen)
            return
        if op == "let" and len(ast) == 3 and isinstance(ast[1], list):
            env2 = dict(env)
            for name, params, body in ast[1]:
                self._audit_traps(body, br, gated, env2, seen)
                env2[name] = (Definition(name, params, body) if params
                              else self._abs(body, env2))
            self._audit_traps(ast[2], br, gated, env2, seen)
            return
        if op == "if" and len(ast) == 4:
            self._audit_traps(ast[1], br, gated, env, seen)
            self._audit_traps(ast[2], br, True, env, seen)
            self._audit_traps(ast[3], br, True, env, seen)
            return
        inner_gated = gated or op == "case"
        start = 1 if isinstance(op, str) else 0
        for x in ast[start:]:
            if isinstance(x, (tuple, list)):
                self._audit_traps(x, br, inner_gated, env, seen)

    def _guard_static_false(self, g, br: _Branch) -> bool:
        """True when guard `g` is constant-evaluable (no state vars, no
        binders, no primes, no swept constants) and evaluates FALSE
        under the resolved constants - TLC's level-0 constant
        evaluation."""
        if _mentions_any(g, self.variables | br.bound
                         | self.dynamic_consts, self.defs):
            return False
        try:
            v = self.ev.eval(g, dict(self.ev.constants))
        except Exception:
            return False
        return v is False

    # -- walk --------------------------------------------------------------

    def walk(self) -> None:
        self._seq([self.system.next_ast], 0, _Branch(), None)

    def _done(self, br: _Branch, label: Optional[str]) -> None:
        self.branches.setdefault(label or "?", []).append(br)

    def _seq(self, items, i, br: _Branch, label) -> None:
        if i == len(items):
            self._done(br, label)
            return
        ast = items[i]
        rest = items[i + 1:]
        op = ast[0]
        if op == "and":
            self._seq(list(ast[1]) + rest, 0, br, label)
            return
        if op == "or":
            for branch in ast[1]:
                self._seq([branch] + rest, 0, br.fork(), label)
            return
        if op == "exists":
            _, names, dom_ast, body = ast
            self._reads(dom_ast, br)
            b2 = br.fork()
            b2.bound |= set(names)
            elem = self._inf._elem_shape(
                self._abs(dom_ast, self._shape_env(br))
            )
            for nm in names:
                b2.senv[nm] = elem
            state_dep = _mentions_any(
                dom_ast, self.variables | br.bound, self.defs
            )
            if state_dep:
                u = self._dom_universe(dom_ast, br)
                if u is not None and u > UNROLL_LIMIT:
                    # the mask path: SLOT_CAP k-th-set-bit slot lanes
                    for nm in names:
                        b2.slot_binders.append((nm, u))
            self._seq([body] + rest, 0, b2, label)
            return
        if op == "if":
            self._reads(ast[1], br)
            self._audit_traps(ast[1], br, False, self._shape_env(br))
            for arm in (ast[2], ast[3]):
                self._seq([arm] + rest, 0, br.fork(), label)
            return
        if op == "let":
            b2 = br.fork()
            for name, params, body in ast[1]:
                self._reads(body, br)
                b2.bound.add(name)
                b2.senv[name] = (
                    Definition(name, params, body) if params
                    else self._abs(body, self._shape_env(b2))
                )
            self._seq([ast[2]] + rest, 0, b2, label)
            return
        if op in ("call", "name"):
            dname = ast[1]
            d = self.defs.get(dname)
            if d is not None and self.system._mentions_prime(d.body):
                args = ast[2] if op == "call" else []
                for a in args:
                    self._reads(a, br)
                b2 = br.fork()
                b2.bound |= set(d.params)
                env = self._shape_env(br)
                for p, a in zip(d.params, args):
                    b2.senv[p] = self._abs(a, env)
                inner = label if d.body[0] == "or" else dname
                self._seq([d.body] + rest, 0, b2, inner)
                return
        if op == "unchanged":
            b2 = br.fork()
            b2.unchanged |= set(ast[1])
            self._seq(rest, 0, b2, label)
            return
        if op == "cmp" and ast[1] in ("=", r"\in") \
                and ast[2][0] == "prime":
            b2 = br.fork()
            b2.writes.add(ast[2][1])
            self._reads(ast[3], b2)
            self._audit_traps(ast[3], b2, False, self._shape_env(b2))
            self._seq(rest, 0, b2, label)
            return
        # plain guard conjunct
        b2 = br.fork()
        b2.guards.append(ast)
        self._reads(ast, b2)
        self._audit_traps(ast, b2, False, self._shape_env(b2))
        if self._guard_static_false(ast, b2):
            b2.disabled = True
        self._seq(rest, 0, b2, label)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def analyze_spec(model, var_shapes: Optional[dict] = None,
                 dynamic_consts=frozenset(),
                 const_hints=None) -> SpecAnalysis:
    """Run the spec-layer lints on a loaded StructModel.  `var_shapes`
    reuses already-inferred shapes (the struct backend memo computes
    them anyway); omitted, the same pure-Python inference runs here.
    `dynamic_consts` names CONSTANTs swept over a range and
    `const_hints` widens them to abstract values, so one pass audits a
    whole sweep constants class instead of its anchor configuration."""
    system = model.system
    if var_shapes is None:
        hints = typeok_hints(system.ev, model.invariants,
                             system.variables)
        var_shapes = infer_shapes(system.ev, system.variables,
                                  system.init_ast, system.next_ast,
                                  hints=hints, const_hints=const_hints)
    cdc = StructCodec(system.variables, var_shapes)

    w = _SpecWalker(model, var_shapes, dynamic_consts=dynamic_consts,
                    const_hints=const_hints)
    w.walk()

    actions: Dict[str, ActionInfo] = {}
    for label in sorted(w.branches):
        info = ActionInfo(name=label)
        for br in w.branches[label]:
            info.n_branches += 1
            if br.disabled:
                info.n_disabled += 1
            info.reads |= br.reads
            info.writes |= br.writes
            info.unchanged |= br.unchanged
            info.slot_binders.extend(
                b for b in br.slot_binders
                if b not in info.slot_binders
            )
            info.seq_reads = max(info.seq_reads, br.seq_reads)
            info.gated_seq_reads = max(info.gated_seq_reads,
                                       br.gated_seq_reads)
        actions[label] = info

    findings: List[Finding] = []
    for label, info in actions.items():
        if info.n_branches and info.n_disabled == info.n_branches:
            findings.append(Finding(
                layer="spec", check="unreachable-action",
                severity=SEV_WARNING, subject=label,
                detail=(f"every branch of {label} has a guard that is "
                        "statically FALSE under the resolved constants; "
                        "the action can never fire"),
            ))
        for nm, u in info.slot_binders:
            findings.append(Finding(
                layer="spec", check="slot-budget",
                severity=SEV_WARNING, subject=label,
                detail=(f"\\E {nm} picks from a state-dependent set of "
                        f"up to {u} elements through {SLOT_CAP} slot "
                        f"lanes (universe {u} > unroll limit "
                        f"{UNROLL_LIMIT}); a reachable state whose set "
                        f"exceeds {SLOT_CAP} halts with "
                        "VIOL_SLOT_OVERFLOW"),
            ))

    inv_reads: Dict[str, Set[str]] = {}
    for name, ast in model.invariants.items():
        reads: Set[str] = set()
        _state_reads(ast, w.variables, w.defs, set(), reads)
        inv_reads[name] = reads
        if not reads:
            findings.append(Finding(
                layer="spec", check="invariant-vacuity",
                severity=SEV_WARNING, subject=name,
                detail=(f"invariant {name} reads no state variable; it "
                        "constrains nothing about the run"),
            ))

    names = sorted(actions)
    pairs: List[Tuple[str, str]] = []
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            ia, ib = actions[a], actions[b]
            if not (ia.writes & (ib.reads | ib.writes)) and \
                    not (ib.writes & (ia.reads | ia.writes)):
                pairs.append((a, b))

    return SpecAnalysis(
        root=model.root_name,
        variables=system.variables,
        n_fields=cdc.n_fields,
        actions=actions,
        invariant_reads=inv_reads,
        independent_pairs=pairs,
        findings=findings,
    )
