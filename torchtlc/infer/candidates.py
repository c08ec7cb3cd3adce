"""Candidate conjecture: bounded predicate enumeration over the struct IR.

The candidate pool the evidence filter prunes is built from three
sources, in priority order under the budget:

* **cfg seeds**: the model's own named invariants - inference doubles
  as a "which of my stated invariants is reachable-inductive" report,
  and a certified cfg seed trivially implies the named invariant the
  acceptance bar asks for.
* **bound atoms** from the absint lattice (analysis.absint): integer
  range bounds, `Cardinality` bounds on mask-layout set variables and
  `Len` caps on sequences.  When the bound report is CERTIFIED these
  candidates are born certified - the absint fixpoint is already a
  machine-checked `Init => cand /\\ cand /\\ Next => cand'` proof for
  exactly this predicate family.
* **2-clause implications** `A => B` between atomic equalities/literals
  of RELATED variables - related meaning some action reads or writes
  both (analysis.speclint's read/write sets), which is what keeps the
  quadratic atom-pair space protocol-shaped instead of combinatorial.

Everything is an ordinary struct-IR predicate AST, so the filter
compiles candidates through the same LaneCompiler.build_invariant path
cfg invariants use, and the host oracle evaluates them with the same
`ev.eval` - no second expression language.

The port's copy of jaxtlc/infer/candidates.py, line for line over the
port's struct/shapes.py and analysis/speclint.py: the same pool, in the
same order, for the same model.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

from ..struct.shapes import (
    SAtoms,
    SBool,
    SFun,
    SInt,
    SRec,
    SSeq,
    SSet,
    Shape,
)

DEFAULT_BUDGET = 64


class Candidate(NamedTuple):
    """One conjectured predicate: AST + its TLA+ text rendering."""

    name: str
    ast: tuple
    text: str
    source: str  # "cfg" | "bound" | "card" | "len" | "impl"
    implies: Tuple[str, ...]  # named cfg invariants this one implies
    absint: bool  # certified by the absint fixpoint alone


def _lit(v) -> tuple:
    if isinstance(v, bool):
        return ("bool", v)
    if isinstance(v, str):
        return ("str", v)
    return ("num", int(v))


def ast_to_tla(ast) -> str:
    """TLA+ text of a candidate AST (the paste-into-your-spec form;
    covers exactly the node shapes conjecture emits)."""
    op = ast[0]
    if op == "name":
        return ast[1]
    if op == "num":
        return str(ast[1])
    if op == "str":
        return f'"{ast[1]}"'
    if op == "bool":
        return "TRUE" if ast[1] else "FALSE"
    if op == "not":
        return f"~({ast_to_tla(ast[1])})"
    if op == "cmp":
        return (f"{ast_to_tla(ast[2])} {ast[1]} "
                f"{ast_to_tla(ast[3])}")
    if op == "implies":
        return (f"({ast_to_tla(ast[1])}) => "
                f"({ast_to_tla(ast[2])})")
    if op == "call":
        args = ", ".join(ast_to_tla(a) for a in ast[2])
        return f"{ast[1]}({args})"
    if op == "apply":
        return f"{ast_to_tla(ast[1])}[{ast_to_tla(ast[2])}]"
    raise ValueError(f"cannot render candidate node {op!r}")


class _Atom(NamedTuple):
    """An atomic boolean predicate usable as an implication clause."""

    ast: tuple
    vars: frozenset


def _leaf_atoms(base_ast: tuple, shape: Optional[Shape],
                var: str, depth: int = 0) -> List[_Atom]:
    """Equality/literal atoms of one IR leaf (recursing one level into
    function values - the two-level `view[s][e]` shape)."""
    out: List[_Atom] = []
    vs = frozenset([var])
    if isinstance(shape, SAtoms):
        for a in sorted(shape.atoms):
            out.append(_Atom(("cmp", "=", base_ast, _lit(a)), vs))
    elif isinstance(shape, SBool):
        out.append(_Atom(base_ast, vs))
        out.append(_Atom(("not", base_ast), vs))
    elif isinstance(shape, SInt):
        for v in {shape.lo, shape.hi}:
            out.append(_Atom(("cmp", "=", base_ast, _lit(v)), vs))
    elif isinstance(shape, SFun) and depth < 2:
        for k in shape.keys:
            out.extend(_leaf_atoms(("apply", base_ast, _lit(k)),
                                   shape.val, var, depth + 1))
    elif isinstance(shape, SRec) and depth < 2:
        # fixed-domain functions land as SRec in the IR; optional
        # fields are skipped (applying a partial function can trap)
        for fname, fshape, optional in shape.fields:
            if optional:
                continue
            out.extend(_leaf_atoms(("apply", base_ast, _lit(fname)),
                                   fshape, var, depth + 1))
    return out


def _bound_candidates(var: str, shape: Optional[Shape],
                      card_bound: Optional[int], certified: bool,
                      base_ast: Optional[tuple] = None,
                      depth: int = 0) -> List[Tuple[tuple, str, bool]]:
    """(ast, source, absint) bound predicates of one variable."""
    base = base_ast if base_ast is not None else ("name", var)
    out: List[Tuple[tuple, str, bool]] = []
    if isinstance(shape, SInt):
        out.append((("cmp", "<=", base, _lit(shape.hi)), "bound",
                    certified))
        if shape.lo != 0:
            out.append((("cmp", ">=", base, _lit(shape.lo)), "bound",
                        certified))
    elif isinstance(shape, SSet) and card_bound is not None:
        card = ("call", "Cardinality", [base])
        out.append((("cmp", "<=", card, _lit(card_bound)), "card",
                    certified))
    elif isinstance(shape, SSeq):
        ln = ("call", "Len", [base])
        out.append((("cmp", "<=", ln, _lit(shape.cap)), "len",
                    certified))
    elif isinstance(shape, SFun) and depth < 2:
        for k in shape.keys:
            out.extend(_bound_candidates(
                var, shape.val, None, certified,
                base_ast=("apply", base, _lit(k)), depth=depth + 1,
            ))
    elif isinstance(shape, SRec) and depth < 2:
        for fname, fshape, optional in shape.fields:
            if optional:
                continue
            out.extend(_bound_candidates(
                var, fshape, None, certified,
                base_ast=("apply", base, _lit(fname)),
                depth=depth + 1,
            ))
    return out


def _related_pairs(model) -> Optional[set]:
    """Unordered variable pairs some action reads or writes together
    (speclint's read/write sets) - the implication seeding relation.
    None = the lint failed; the caller falls back to all pairs."""
    try:
        from ..analysis.speclint import analyze_spec

        an = analyze_spec(model)
    except Exception:
        return None
    pairs = set()
    for info in an.actions.values():
        rw = sorted(info.reads | info.writes)
        for i, u in enumerate(rw):
            for v in rw[i + 1:]:
                pairs.add(frozenset((u, v)))
    return pairs


def conjecture(model, bounds=None,
               budget: int = DEFAULT_BUDGET
               ) -> Tuple[List[Candidate], int]:
    """Enumerate candidate invariants for a struct model.

    `bounds` is the (memoized) analysis.absint.BoundReport; certified
    bounds yield born-certified candidates.  Returns (candidates,
    dropped) - `dropped` counts conjectures beyond the budget, so the
    caller can journal that coverage honestly instead of implying the
    pool was exhaustive."""
    system = model.system
    variables = tuple(system.variables)
    certified = bool(bounds is not None
                     and getattr(bounds, "certified", False))
    shapes: Dict[str, Optional[Shape]] = {}
    if bounds is not None:
        shapes = dict(bounds.bounds)
    else:
        from ..struct.shapes import infer_shapes, typeok_hints

        hints = typeok_hints(system.ev, model.invariants, variables)
        shapes = infer_shapes(system.ev, variables, system.init_ast,
                              system.next_ast, hints=hints)
    card_bounds = dict(getattr(bounds, "card_bounds", {}) or {})

    pool: List[Candidate] = []
    seen_asts = set()

    def push(c: Candidate) -> None:
        key = repr(c.ast)  # call-node args are lists: hash the repr
        if key in seen_asts:
            return
        seen_asts.add(key)
        pool.append(c)

    # 1) cfg seeds: the model's own named invariants
    for name, ast in model.invariants.items():
        push(Candidate(name=name, ast=ast, text=name, source="cfg",
                       implies=(name,), absint=False))

    # 2) absint bound atoms
    k = 0
    for v in variables:
        for ast, source, ai in _bound_candidates(
                v, shapes.get(v), card_bounds.get(v), certified):
            push(Candidate(name=f"B{k}", ast=ast, text=ast_to_tla(ast),
                           source=source, implies=(), absint=ai))
            k += 1

    # 3) 2-clause implications between atoms of related variables
    atoms: List[_Atom] = []
    for v in variables:
        atoms.extend(_leaf_atoms(("name", v), shapes.get(v), v))
    related = _related_pairs(model)
    k = 0
    for i, a in enumerate(atoms):
        for b in atoms[i + 1:]:
            if a.vars == b.vars:
                continue
            if related is not None and frozenset(
                    a.vars | b.vars) not in related:
                continue
            for lhs, rhs in ((a, b), (b, a)):
                ast = ("implies", lhs.ast, rhs.ast)
                push(Candidate(name=f"I{k}", ast=ast,
                               text=ast_to_tla(ast), source="impl",
                               implies=(), absint=False))
                k += 1

    dropped = max(0, len(pool) - budget)
    return pool[:budget], dropped
