"""Symmetry-set detection + POR ample-action analysis (a copy of
jaxtlc/analysis/symfind.py; the preflight reads its
``unreduced_symmetry_findings``).

Static, engine-free verification of the two state-space reductions
`engine.reduce` applies at expand time:

* **Symmetric constant sets** - the TLC ``SYMMETRY`` condition: a
  CONSTANT resolved to a set of model values (atoms) whose elements the
  spec only ever compares for equality.  In this IR that is checkable
  syntactically: atoms are plain strings, and the only way a spec can
  distinguish two atoms of a set S is (a) naming one as a string
  literal, (b) pinning one through ANOTHER constant whose value embeds
  it, or (c) ``CHOOSE`` (whose deterministic pick is not
  permutation-equivariant).  A candidate passing all three checks is
  permutation-symmetric: for every permutation pi of S and reachable
  state s, pi(s) is reachable, and every invariant/property satisfies
  Inv(pi(s)) = Inv(s) - the soundness basis for fingerprinting only
  orbit representatives.

* **POR-safe actions** - singleton ample sets.  An action A may be the
  sole expansion of a state where it is enabled when (1) A is
  *independent* of every other action (speclint's read/write condition,
  `SpecAnalysis.independent_pairs` - so executing others neither
  disables A nor changes what A does, and vice versa), (2) A is
  *invisible* - writes(A) touches no variable any INVARIANT reads, so
  commuting A across other actions never changes an invariant verdict,
  and (3) the *cycle condition* holds: A strictly increments a counter
  variable (``v' = v + c``, c >= 1, in every branch) that, by (1), no
  other action writes - so no cycle of the reduced graph consists of
  ample steps only, and nothing is postponed forever.  Deadlocks are
  preserved separately by the engine: the deadlock test runs on the
  pre-pruning successor mask.

Everything here is host Python over the parsed ASTs and resolved
constants - the same surface speclint audits - so
the reference's ``--por-report`` can print the whole
reduction story without building a step function.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set, Tuple

from . import SEV_WARNING, Finding
from .speclint import SpecAnalysis, analyze_spec

# orbit-group budget: the canonicalization kernel unrolls one field
# program per non-identity permutation, so the product of |S|! over the
# kept sets is capped (TLC warns past small symmetry groups for the
# same reason - canonicalization cost grows factorially)
PERM_LIMIT = 24


# ---------------------------------------------------------------------------
# Symmetric constant sets
# ---------------------------------------------------------------------------


def _spec_atom_surface(model) -> Tuple[Set[str], bool]:
    """(string literals, CHOOSE reachable?) over the reachable-def
    closure of init/next/invariants/properties - the full surface a
    permutation of constant atoms must commute with."""
    system = model.system
    defs = system.ev.defs
    strs: Set[str] = set()
    has_choose = False
    stack: List[object] = [system.init_ast, system.next_ast]
    stack.extend(model.invariants.values())
    props = getattr(model, "properties", None) or {}
    if isinstance(props, dict):
        stack.extend(props.values())
    seen: Set[str] = set()
    while stack:
        node = stack.pop()
        if isinstance(node, list):
            stack.extend(node)
            continue
        if not isinstance(node, tuple) or not node:
            continue
        op = node[0]
        if op == "str" and len(node) == 2 and isinstance(node[1], str):
            strs.add(node[1])
            continue
        if op == "choose":
            has_choose = True
        if op in ("name", "call") and len(node) >= 2 \
                and isinstance(node[1], str):
            d = defs.get(node[1])
            if d is not None and node[1] not in seen:
                seen.add(node[1])
                stack.append(d.body)
            if op == "call" and len(node) == 3:
                stack.extend(x for x in node[2]
                             if isinstance(x, (tuple, list)))
            continue
        start = 1 if isinstance(op, str) else 0
        stack.extend(x for x in node[start:]
                     if isinstance(x, (tuple, list)))
    return strs, has_choose


def _atoms_in(value, out: Set[str]) -> None:
    if isinstance(value, str):
        out.add(value)
    elif isinstance(value, frozenset):
        for x in value:
            _atoms_in(x, out)
    elif isinstance(value, tuple):
        for x in value:
            _atoms_in(x, out)


def find_symmetric_sets(model) -> Tuple[
        Dict[str, Tuple[str, ...]], Dict[str, str]]:
    """(kept, rejected): candidate symmetric sets are CONSTANTs resolved
    to frozensets of >= 2 atoms; `kept` maps constant name -> sorted
    atom tuple for the sets that pass static verification, `rejected`
    maps the rest to a human-readable reason."""
    candidates = {
        name: v for name, v in sorted(model.constants.items())
        if isinstance(v, frozenset) and len(v) >= 2
        and all(isinstance(x, str) for x in v)
    }
    kept: Dict[str, Tuple[str, ...]] = {}
    rejected: Dict[str, str] = {}
    if not candidates:
        return kept, rejected
    strs, has_choose = _spec_atom_surface(model)
    budget = 1
    for name, val in candidates.items():
        atoms = tuple(sorted(val))
        why: Optional[str] = None
        if has_choose:
            why = ("spec reaches a CHOOSE; its deterministic pick is "
                   "not permutation-equivariant")
        if why is None:
            hit = sorted(set(atoms) & strs)
            if hit:
                why = (f"element(s) {', '.join(hit)} appear as string "
                       "literals in the spec")
        if why is None:
            for other, oval in sorted(model.constants.items()):
                if other == name or oval == val:
                    continue
                used: Set[str] = set()
                _atoms_in(oval, used)
                pin = sorted(set(atoms) & used)
                if pin:
                    why = (f"element(s) {', '.join(pin)} are pinned "
                           f"through constant {other}")
                    break
        if why is None:
            fact = math.factorial(len(atoms))
            if budget * fact > PERM_LIMIT:
                why = (f"orbit-group budget: |{name}|! = {fact} would "
                       f"push the group past {PERM_LIMIT} permutations")
            else:
                budget *= fact
                kept[name] = atoms
                continue
        rejected[name] = why
    return kept, rejected


def unreduced_symmetry_findings(model) -> List[Finding]:
    """One SEV_WARNING per SYMMETRY-eligible set: the spec qualifies
    for orbit dedup but the run is not taking it (preflight journals
    these; a `-symmetry` run drops the reduced sets from the list the
    struct backend leaves over)."""
    kept, _rejected = find_symmetric_sets(model)
    out: List[Finding] = []
    for name, atoms in kept.items():
        out.append(Finding(
            layer="spec", check="unreduced-symmetry",
            severity=SEV_WARNING, subject=name,
            detail=(f"constant {name} = {{{', '.join(atoms)}}} is "
                    "SYMMETRY-eligible (elements only ever "
                    "equality-compared); -symmetry dedups its "
                    f"{math.factorial(len(atoms))}-way orbits"),
        ))
    return out


# ---------------------------------------------------------------------------
# POR-safe actions (singleton ample sets)
# ---------------------------------------------------------------------------


def _is_increment(rhs, v: str) -> bool:
    """rhs is syntactically `v + c` or `c + v` with literal c >= 1."""
    if not (isinstance(rhs, tuple) and len(rhs) == 4
            and rhs[0] == "binop" and rhs[1] == "+"):
        return False
    for x, y in ((rhs[2], rhs[3]), (rhs[3], rhs[2])):
        if x == ("name", v) and isinstance(y, tuple) and len(y) == 2 \
                and y[0] == "num" and isinstance(y[1], int) and y[1] >= 1:
            return True
    return False


def _monotone_every_branch(ast, v: str, defs,
                           seen: frozenset = frozenset()) -> bool:
    """True when EVERY disjunctive branch of `ast` carries a conjunct
    `v' = v + c` (c >= 1 literal) - the strictly-monotone counter that
    discharges the POR cycle condition for the action owning `ast`."""
    if not isinstance(ast, tuple) or not ast:
        return False
    op = ast[0]
    if op == "and":
        return any(_monotone_every_branch(x, v, defs, seen)
                   for x in ast[1])
    if op == "or":
        return bool(ast[1]) and all(
            _monotone_every_branch(x, v, defs, seen) for x in ast[1]
        )
    if op == "exists" and len(ast) == 4:
        return _monotone_every_branch(ast[3], v, defs, seen)
    if op == "if" and len(ast) == 4:
        return (_monotone_every_branch(ast[2], v, defs, seen)
                and _monotone_every_branch(ast[3], v, defs, seen))
    if op == "let" and len(ast) == 3:
        return _monotone_every_branch(ast[2], v, defs, seen)
    if op in ("name", "call") and len(ast) >= 2 \
            and isinstance(ast[1], str):
        d = defs.get(ast[1])
        if d is not None and ast[1] not in seen:
            return _monotone_every_branch(d.body, v, defs,
                                          seen | {ast[1]})
        return False
    if op == "cmp" and len(ast) == 4 and ast[1] == "=" \
            and ast[2] == ("prime", v):
        return _is_increment(ast[3], v)
    return False


def safe_por_actions(spec: SpecAnalysis, model) -> Tuple[
        Tuple[str, ...], Dict[str, str]]:
    """(safe, reasons): actions eligible as singleton ample sets, and
    why the rest are not.  `safe` is sorted by action name - the engine
    picks the LOWEST-id safe enabled action, and label ids are the
    sorted-name order, so the choice is deterministic across runs."""
    defs = model.system.ev.defs
    inv_reads: Set[str] = set()
    for reads in spec.invariant_reads.values():
        inv_reads |= reads
    indep = set(spec.independent_pairs)
    names = sorted(spec.actions)
    safe: List[str] = []
    reasons: Dict[str, str] = {}
    for a in names:
        info = spec.actions[a]
        deps = [b for b in names if b != a
                and (a, b) not in indep and (b, a) not in indep]
        if deps:
            shown = ", ".join(deps[:4]) + ("..." if len(deps) > 4 else "")
            reasons[a] = f"dependent on {shown}"
            continue
        vis = sorted(info.writes & inv_reads)
        if vis:
            reasons[a] = ("visible: writes invariant-read "
                          f"variable(s) {', '.join(vis)}")
            continue
        d = defs.get(a)
        mono = [v for v in sorted(info.writes)
                if d is not None
                and _monotone_every_branch(d.body, v, defs)]
        if not mono:
            reasons[a] = ("no strictly-monotone counter write "
                          "(v' = v + c, c >= 1, in every branch) to "
                          "discharge the cycle condition")
            continue
        safe.append(a)
    return tuple(safe), reasons


# ---------------------------------------------------------------------------
# Combined report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SymReport:
    """Everything the struct backend, the `--por-report` renderer and
    preflight need about one model's reduction opportunities."""

    symmetric_sets: Dict[str, Tuple[str, ...]]
    rejected_sets: Dict[str, str]
    safe_actions: Tuple[str, ...]
    unsafe_actions: Dict[str, str]
    spec: SpecAnalysis

    @property
    def orbit_factor(self) -> int:
        f = 1
        for atoms in self.symmetric_sets.values():
            f *= math.factorial(len(atoms))
        return f


def analyze_reduction(model,
                      spec: Optional[SpecAnalysis] = None) -> SymReport:
    if spec is None:
        spec = analyze_spec(model)
    kept, rejected = find_symmetric_sets(model)
    safe, unsafe = safe_por_actions(spec, model)
    return SymReport(
        symmetric_sets=kept, rejected_sets=rejected,
        safe_actions=safe, unsafe_actions=unsafe, spec=spec,
    )


def render_por_report(model,
                      spec: Optional[SpecAnalysis] = None) -> str:
    """Engine-free text report: the independence graph, per-action
    ample eligibility with reasons, and the detected symmetric sets."""
    rep = analyze_reduction(model, spec)
    spec = rep.spec
    lines: List[str] = []
    lines.append(f"reduction report: {spec.root} "
                 f"({len(spec.actions)} actions, "
                 f"{spec.n_fields} codec fields)")
    lines.append("")
    lines.append("symmetric constant sets:")
    if not rep.symmetric_sets and not rep.rejected_sets:
        lines.append("  (no constant resolves to a set of >= 2 atoms)")
    for name, atoms in rep.symmetric_sets.items():
        lines.append(
            f"  {name} = {{{', '.join(atoms)}}}  SYMMETRY-eligible "
            f"({math.factorial(len(atoms))} orbit permutations)"
        )
    for name, why in rep.rejected_sets.items():
        lines.append(f"  {name}: not eligible - {why}")
    lines.append("")
    lines.append(f"independent action pairs "
                 f"({len(spec.independent_pairs)}):")
    if not spec.independent_pairs:
        lines.append("  (none)")
    for a, b in spec.independent_pairs:
        lines.append(f"  {a} || {b}")
    lines.append("")
    lines.append("ample-set eligibility (singleton ample):")
    for a in sorted(spec.actions):
        if a in rep.safe_actions:
            lines.append(f"  {a}: SAFE (independent of all, invisible, "
                         "monotone counter)")
        else:
            lines.append(f"  {a}: {rep.unsafe_actions.get(a, '?')}")
    return "\n".join(lines)
