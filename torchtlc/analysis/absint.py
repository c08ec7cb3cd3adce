"""Certified whole-spec abstract interpretation over the struct IR.

The shape-inference pass (struct.shapes) answers "what layout can hold
every reachable value" by ASCENDING iteration with threshold widening
and TypeOK-hint clamping - over-approximate by design, because the
codec only needs an upper bound.  COSTMODEL.json says commit is
sort-dominated and sort cost scales with the packed word count the
codec emits, so those over-approximations are paid for on every chunk
of every run.  This module is the DESCENDING half of the classic
abstract-interpretation recipe (widen up, narrow down, verify):

* **Interval domain** for integer leaves, **length domain** for
  sequences (the SSeq cap), **cardinality domain** for mask-layout
  sets - all expressed as the same Shape lattice the codec consumes,
  so a narrowed bound IS a narrowed layout.
* **Guard refinement**: within one action branch, prime-free guard
  conjuncts (`x < N`, `x = v`, `x \\in S`, `Len(s) = k`) refine the
  pre-state environment before the primed writes are interpreted -
  the precision the ascending pass deliberately skips (it never needs
  it; we do, because `x' = x + 1` under `x < N` must not re-widen).
* **Narrowing fixpoint**: from the widened baseline B0, iterate
  R <- meet(InitShapes ∪ step#(R), R) until stable.
* **Certification**: the result is accepted only when it is verified
  to be a post-fixpoint - `Init ⊑ R` and `step#(R) ⊑ R` under
  shape_leq - so every consumer (codec narrowing, trap elision, the
  runtime certificate column) stands on a machine-checked bound, not
  on the narrowing loop having been bug-free.

Consumers: struct.backend builds the narrowed codec + the on-device
certificate check from a certified report; struct.compile elides
range traps and shrinks slot-lane fans the bounds prove safe; the
preflight report renders the per-variable bound lines.  Pure host
Python over parsed ASTs - no jax, milliseconds per spec.

The port's copy of jaxtlc/analysis/absint.py, line for line over the
port's struct/shapes.py: the port imports nothing of the reference
package.  ``BoundReport.digest`` equals the reference's byte for byte, so
a checkpoint meta's ``bound_digest`` reads the same in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Tuple

from ..struct.shapes import (
    SAtoms,
    SBool,
    SInt,
    SRec,
    SSeq,
    SSet,
    SUnion,
    Shape,
    ShapeError,
    ShapeInference,
    _clamp,
    infer_shapes,
    shape_leq,
    shape_of_value,
    typeok_hints,
    universe,
)
from . import SEV_INFO, SEV_WARNING, Finding

MAX_NARROW_ITERS = 64
# ascending-from-bottom budget: guard-refined exact iteration converges
# for guarded counters within their range size; anything slower falls
# back to the descending-narrowing result (never diverges)
MAX_ASCEND_ITERS = 48


# ---------------------------------------------------------------------------
# The abstract transformer: one step# pass with guard refinement
# ---------------------------------------------------------------------------


class _Stepper(ShapeInference):
    """step#: abstract post-state shapes of one Next application from a
    FIXED pre-state environment.  Unlike the ascending parent, writes
    accumulate into `self.writes` (never back into the read
    environment), and prime-free guard conjuncts of a branch refine
    the environment its writes are interpreted under."""

    def __init__(self, ev, variables, init_ast, next_ast, env,
                 const_hints=None):
        super().__init__(ev, variables, init_ast, next_ast)
        self.var_shapes = dict(env)  # read side (pre-state + primes)
        self.writes: Dict[str, Optional[Shape]] = {}
        # field-level guard constraints active for the EXCEPT being
        # abstracted (the `term[n] < MaxTerm` -> `[term EXCEPT ![n] =
        # @ + 1]` pattern: the guard constrains exactly the field the
        # dynamic EXCEPT rewrites, so `@` may be met with it)
        self._cur_fieldguard = None
        if const_hints:
            self.const_hints = dict(const_hints)

    def _record_write(self, name, sh):
        from ..struct.shapes import join

        self.writes[name] = join(self.writes.get(name), sh)
        # primed reads after the assignment see the written shape
        self.var_shapes[name] = join(self.var_shapes.get(name), sh)

    # -- guard refinement --------------------------------------------------

    def _refine_env(self, items, env) -> dict:
        """Refine `env` with every prime-free guard conjunct in `items`
        (refinement is order-free: guards constrain the SAME pre-state
        regardless of where PlusCal emitted them in the conjunction)."""
        out = dict(env)
        for g in items:
            if not isinstance(g, tuple) or not g:
                continue
            if g[0] == "and":
                out = self._refine_env(list(g[1]), out)
                continue
            if g[0] != "cmp":
                continue
            self._refine_cmp(g, out)
        return out

    def _refine_cmp(self, g, env) -> None:
        _, sym, la, ra = g
        if la[0] == "prime" or ra[0] == "prime":
            return
        # normalize: variable (or Len(var) / var[dyn] / Len(var[dyn]))
        # on the left
        for lhs, rhs, s in ((la, ra, sym), (ra, la, _flip(sym))):
            if lhs[0] == "name" and lhs[1] in env:
                self._refine_var(lhs[1], s, rhs, env)
            elif (lhs[0] == "call" and lhs[1] == "Len"
                  and len(lhs[2]) == 1 and lhs[2][0][0] == "name"
                  and lhs[2][0][1] in env):
                self._refine_len(lhs[2][0][1], s, rhs, env)
            else:
                self._refine_field(lhs, s, rhs, env)

    def _refine_field(self, lhs, sym, rhs, env) -> None:
        """Record a field-level guard: `v[i] cmp rhs` or
        `Len(v[i]) cmp rhs` with a DYNAMIC index constrains exactly the
        field a dynamic EXCEPT on `v` rewrites (`@`)."""
        kind = "int"
        if lhs[0] == "call" and lhs[1] == "Len" and len(lhs[2]) == 1:
            kind = "len"
            lhs = lhs[2][0]
        if lhs[0] != "apply" or lhs[1][0] != "name" \
                or lhs[1][1] not in self.variables:
            return
        idx = lhs[2]
        if not (isinstance(idx, tuple) and idx[0] == "name"):
            return  # only binder-indexed reads are matchable
        sh = self._rhs_shape(rhs, env)
        if not isinstance(sh, SInt):
            return
        # keyed by (variable, binder): the guard refines ONLY an EXCEPT
        # whose dynamic index is the same binder occurrence
        key = ("#fieldguard", lhs[1][1])
        env[key] = env.get(key, ()) + ((idx[1], kind, sym, sh),)

    @staticmethod
    def _apply_fieldguard(sh, guards):
        """Meet a field shape with its collected guards (used for `@`
        in a dynamic EXCEPT; the retained, unrewritten fields keep
        their unrefined shapes)."""
        for kind, sym, g in guards or ():
            if kind == "int" and isinstance(sh, SInt):
                lo, hi = sh.lo, sh.hi
                if sym == "<":
                    hi = min(hi, g.hi - 1)
                elif sym == "<=":
                    hi = min(hi, g.hi)
                elif sym == ">":
                    lo = max(lo, g.lo + 1)
                elif sym == ">=":
                    lo = max(lo, g.lo)
                elif sym == "=":
                    lo, hi = max(lo, g.lo), min(hi, g.hi)
                else:
                    continue
                if lo <= hi:
                    sh = SInt(lo, hi)
            elif kind == "len" and isinstance(sh, SSeq):
                cap = sh.cap
                if sym == "<":
                    cap = min(cap, g.hi - 1)
                elif sym in ("<=", "="):
                    cap = min(cap, g.hi)
                else:
                    continue
                if cap >= 0:
                    sh = SSeq(sh.elem, cap)
        return sh

    def _call_shape(self, ast, env):
        """Sharpen Len/Cardinality over the parent's blanket 0..64:
        a bounded sequence's length is 0..cap, a mask set's size is
        0..|element universe| - the bounds guard refinement feeds on."""
        name = ast[1]
        if name == "Len" and len(ast[2]) == 1:
            sh = self._rhs_shape(ast[2][0], env)
            caps = [a.cap for a in
                    (sh.alts if isinstance(sh, SUnion) else (sh,))
                    if isinstance(a, SSeq)]
            if caps and not isinstance(sh, SUnion):
                return SInt(0, max(caps))
        if name == "Cardinality" and len(ast[2]) == 1:
            sh = self._rhs_shape(ast[2][0], env)
            elem = self._elem_shape(sh)
            if isinstance(sh, SSet):
                try:
                    return SInt(0, len(universe(elem, 256)))
                except ShapeError:
                    pass
        return super()._call_shape(ast, env)

    # the dynamic-EXCEPT hook: _abstract("except") on a guarded
    # variable stashes its field guards; _except_one's dynamic-index
    # case then meets `@` with them before abstracting the new value
    def _abstract(self, ast, env):
        if isinstance(ast, tuple) and ast and ast[0] == "except" \
                and isinstance(ast[1], tuple) and ast[1][0] == "name":
            fg = env.get(("#fieldguard", ast[1][1]))
            if fg:
                saved = self._cur_fieldguard
                self._cur_fieldguard = fg
                try:
                    return super()._abstract(ast, env)
                finally:
                    self._cur_fieldguard = saved
        return super()._abstract(ast, env)

    def _except_one(self, sh, path_asts, val_ast, env):
        fg = self._cur_fieldguard
        if fg and isinstance(path_asts[0], tuple) \
                and path_asts[0][0] == "name":
            # only guards on the SAME binder occurrence apply
            fg = tuple(
                (k, s, g) for b, k, s, g in fg
                if b == path_asts[0][1]
            )
        else:
            fg = ()
        if fg and isinstance(sh, SRec) \
                and path_asts[0][0] != "str":
            saved = self._cur_fieldguard
            self._cur_fieldguard = None  # first dynamic level only
            try:
                fields = []
                for fn, s, o in sh.fields:
                    at = self._apply_fieldguard(s, fg)
                    if len(path_asts) > 1:
                        new = self._except_one(at, path_asts[1:],
                                               val_ast, env)
                    else:
                        env2 = dict(env)
                        env2["@"] = at
                        new = self._abstract(val_ast, env2)
                    from ..struct.shapes import join

                    fields.append((fn, join(s, new), o))
                return SRec(tuple(fields))
            finally:
                self._cur_fieldguard = saved
        return super()._except_one(sh, path_asts, val_ast, env)

    def _rhs_shape(self, rhs, env):
        try:
            return self._abstract(rhs, env)
        except (ShapeError, KeyError, TypeError, ValueError,
                RecursionError):
            return None

    def _refine_var(self, name, sym, rhs, env) -> None:
        cur = env.get(name)
        sh = self._rhs_shape(rhs, env)
        if sym == r"\in":
            elem = self._elem_shape(sh)
            if elem is not None:
                env[name] = _meet(cur, elem)
            return
        if sym == "=":
            if sh is not None:
                env[name] = _meet(cur, sh)
            return
        if not isinstance(cur, SInt) or not isinstance(sh, SInt):
            return
        lo, hi = cur.lo, cur.hi
        if sym == "<":
            hi = min(hi, sh.hi - 1)
        elif sym == "<=":
            hi = min(hi, sh.hi)
        elif sym == ">":
            lo = max(lo, sh.lo + 1)
        elif sym == ">=":
            lo = max(lo, sh.lo)
        else:
            return
        if lo <= hi:
            env[name] = SInt(lo, hi)

    def _refine_len(self, name, sym, rhs, env) -> None:
        cur = env.get(name)
        if not isinstance(cur, SSeq):
            return
        sh = self._rhs_shape(rhs, env)
        if not isinstance(sh, SInt):
            return
        cap = cur.cap
        if sym == "<":
            cap = min(cap, sh.hi - 1)
        elif sym == "<=":
            cap = min(cap, sh.hi)
        elif sym == "=":
            cap = min(cap, sh.hi)
        else:
            return
        if cap >= 0:
            env[name] = SSeq(cur.elem, cap)

    @staticmethod
    def _drop_rebound_guards(env, names) -> None:
        """A nested binder that REBINDS a guarded index name invalidates
        the field guards keyed on it (the two occurrences no longer
        denote the same value)."""
        rebound = set(names)
        for key in [k for k in env
                    if isinstance(k, tuple) and k[0] == "#fieldguard"]:
            kept = tuple(g for g in env[key] if g[0] not in rebound)
            if kept:
                env[key] = kept
            else:
                del env[key]

    # -- the walk (guard-refining variant of the parent's) -----------------

    def run_step(self) -> Dict[str, Optional[Shape]]:
        env = dict(self.var_shapes)
        self._walk_refined(self.next_ast, env)
        return self.writes

    def _walk_refined(self, ast, env):
        op = ast[0]
        if op == "and":
            items = list(ast[1])
            env2 = self._refine_env(items, env)
            # sync refined pre-state into prime reads too
            for x in items:
                self._walk_refined(x, env2)
            return
        if op == "or":
            for x in ast[1]:
                self._walk_refined(x, dict(env))
            return
        if op == "exists":
            _, names, dom_ast, body = ast
            dom_sh = self._rhs_shape(dom_ast, env)
            elem = self._elem_shape(dom_sh)
            env2 = dict(env)
            for nm in names:
                env2[nm] = elem
            self._drop_rebound_guards(env2, names)
            return self._walk_refined(body, env2)
        if op == "if":
            self._walk_refined(ast[2], dict(env))
            self._walk_refined(ast[3], dict(env))
            return
        if op == "let":
            from ..struct.parser import Definition

            env2 = dict(env)
            for name, params, body in ast[1]:
                if params:
                    env2[name] = Definition(name, params, body)
                else:
                    env2[name] = self._rhs_shape(body, env2)
            self._drop_rebound_guards(env2, [n for n, _, _ in ast[1]])
            self._walk_refined(ast[2], env2)
            return
        if op in ("call", "name"):
            from ..struct.parser import Definition
            from ..struct.shapes import _mentions_prime_static

            d = env.get(ast[1])
            if not isinstance(d, Definition):
                d = self.ev.defs.get(ast[1])
            if isinstance(d, Definition) and _mentions_prime_static(
                d.body, self.ev.defs
            ):
                args = ast[2] if op == "call" else []
                env2 = dict(env)
                for p, a in zip(d.params, args):
                    env2[p] = self._rhs_shape(a, env)
                self._drop_rebound_guards(env2, d.params)
                self._walk_refined(d.body, env2)
            return
        if op == "cmp" and ast[1] in ("=", r"\in") \
                and ast[2][0] == "prime":
            name = ast[2][1]
            saved = self.var_shapes
            self.var_shapes = env  # _abstract's prime/name reads
            try:
                rhs = self._rhs_shape(ast[3], env)
                if ast[1] == r"\in":
                    rhs = self._elem_shape(rhs)
            finally:
                self.var_shapes = saved
            from ..struct.shapes import join

            self.writes[name] = join(self.writes.get(name), rhs)
            env[name] = join(env.get(name), rhs)  # later primed reads
            return
        # guards handled by _refine_env; everything else is inert


def _flip(sym: str) -> str:
    return {"<": ">", ">": "<", "<=": ">=", ">=": "<="}.get(sym, sym)


def _meet(a: Optional[Shape], b: Optional[Shape]) -> Optional[Shape]:
    """Best-effort meet via the TypeOK clamp (exact for intervals,
    conservative - returns `a` - where the lattice meet is not
    implemented).  `None` (bottom) absorbs."""
    if a is None:
        return b
    if b is None:
        return a
    if isinstance(a, SAtoms) and isinstance(b, SAtoms):
        inter = a.atoms & b.atoms
        return SAtoms(inter) if inter else a
    return _clamp(a, b)


# ---------------------------------------------------------------------------
# Cardinality domain (mask-layout set variables)
# ---------------------------------------------------------------------------


def _card_of(ast, cards: Dict[str, int], ev, env_binders, default: int,
             _depth: int = 0) -> int:
    """Upper bound on |ast| given per-variable cardinality bounds.
    `default` (the element-universe size) is the sound fallback for
    anything unmodeled."""
    if _depth > 24 or not isinstance(ast, tuple):
        return default
    op = ast[0]
    if op == "name":
        nm = ast[1]
        if nm in cards:
            return cards[nm]
        if nm in env_binders:
            return default
        if nm in ev.constants and isinstance(ev.constants[nm],
                                             frozenset):
            return min(len(ev.constants[nm]), default)
        d = ev.defs.get(nm)
        if d is not None and not d.params:
            return _card_of(d.body, cards, ev, env_binders, default,
                            _depth + 1)
        return default
    if op == "setlit":
        return min(len(ast[1]), default)
    if op == "binop":
        sym = ast[1]
        ca = _card_of(ast[2], cards, ev, env_binders, default,
                      _depth + 1)
        cb = _card_of(ast[3], cards, ev, env_binders, default,
                      _depth + 1)
        if sym == r"\cup":
            return min(ca + cb, default)
        if sym == r"\cap":
            return min(ca, cb)
        if sym == "\\":
            return ca
        return default
    if op == "setfilter":
        return _card_of(ast[2], cards, ev, env_binders, default,
                        _depth + 1)
    if op == "setmap":
        return _card_of(ast[3], cards, ev, env_binders, default,
                        _depth + 1)
    if op == "if":
        return max(
            _card_of(ast[2], cards, ev, env_binders, default,
                     _depth + 1),
            _card_of(ast[3], cards, ev, env_binders, default,
                     _depth + 1),
        )
    return default


def _card_writes(ast, cards, ev, out: Dict[str, int], binders,
                 set_vars, defaults) -> None:
    """Collect v' = rhs cardinality bounds across all branches."""
    if not isinstance(ast, tuple) or not ast:
        return
    op = ast[0]
    if op in ("and", "or"):
        for x in ast[1]:
            _card_writes(x, cards, ev, out, binders, set_vars, defaults)
        return
    if op == "exists":
        _card_writes(ast[3], cards, ev, out, binders | set(ast[1]),
                     set_vars, defaults)
        return
    if op == "if":
        _card_writes(ast[2], cards, ev, out, binders, set_vars, defaults)
        _card_writes(ast[3], cards, ev, out, binders, set_vars, defaults)
        return
    if op == "let":
        _card_writes(ast[2], cards, ev, out, binders, set_vars, defaults)
        return
    if op in ("call", "name"):
        from ..struct.parser import Definition
        from ..struct.shapes import _mentions_prime_static

        d = ev.defs.get(ast[1])
        if isinstance(d, Definition) and _mentions_prime_static(
            d.body, ev.defs
        ):
            _card_writes(d.body, cards, ev, out,
                         binders | set(d.params), set_vars, defaults)
        return
    if op == "cmp" and ast[1] == "=" and ast[2][0] == "prime" \
            and ast[2][1] in set_vars:
        name = ast[2][1]
        c = _card_of(ast[3], cards, ev, binders, defaults[name])
        out[name] = max(out.get(name, 0), c)
        return
    if op == "cmp" and ast[1] == r"\in" and ast[2][0] == "prime" \
            and ast[2][1] in set_vars:
        # v' \in S picks an ELEMENT of S; its cardinality is unmodeled
        name = ast[2][1]
        out[name] = defaults[name]


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BoundReport:
    """The certified result of the whole-spec abstract interpretation:
    per-variable narrowed shapes (the codec consumes these verbatim),
    per-set-variable cardinality bounds (slot-lane budgets), and the
    machine-checked certification verdict."""

    root: str
    variables: Tuple[str, ...]
    baseline: Dict[str, Shape]  # the widened ascending fixpoint
    bounds: Dict[str, Shape]  # the certified narrowed shapes
    card_bounds: Dict[str, int]  # mask-layout vars: certified max |v|
    card_universe: Dict[str, int]  # same vars: element-universe size
    certified: bool
    iters: int
    wall_s: float
    baseline_nbits: int = 0
    narrowed_nbits: int = 0
    baseline_words: int = 0
    narrowed_words: int = 0

    def digest(self) -> str:
        """Stable identity of the bound environment - the engine-memo /
        checkpoint-meta key component (a narrowed engine is a different
        compile than an un-narrowed one)."""
        h = hashlib.sha256()
        for v in self.variables:
            h.update(f"{v}={self.bounds.get(v)!r};".encode())
        for v in sorted(self.card_bounds):
            h.update(f"|{v}|<={self.card_bounds[v]};".encode())
        h.update(b"certified" if self.certified else b"uncertified")
        return h.hexdigest()[:16]

    def narrowed(self) -> bool:
        return self.certified and (
            self.narrowed_nbits < self.baseline_nbits
            or any(self.card_bounds[v] < self.card_universe[v]
                   for v in self.card_bounds)
        )

    def render_lines(self) -> List[str]:
        """The byte-stable bound-report section (the -analyze view)."""
        lines = [
            "certified reachable bounds"
            + ("" if self.certified else " (NOT certified - narrowing "
               "disabled, baseline layout kept)")
            + f": {self.baseline_nbits} -> {self.narrowed_nbits} bits "
            f"({self.baseline_words} -> {self.narrowed_words} words)"
        ]
        for v in self.variables:
            base, cur = self.baseline.get(v), self.bounds.get(v)
            tag = "" if base == cur else "  NARROWED"
            card = ""
            if v in self.card_bounds:
                card = (f"  |{v}| <= {self.card_bounds[v]}"
                        f"/{self.card_universe[v]}")
            lines.append(f"  {v}: {_shape_str(cur)}{card}{tag}")
        return lines

    def findings(self) -> List[Finding]:
        out = []
        if not self.certified:
            out.append(Finding(
                layer="spec", check="bound-certification",
                severity=SEV_WARNING, subject=self.root,
                detail=("the narrowed bound environment could not be "
                        "verified as a post-fixpoint of the abstract "
                        "transformer; narrowing is disabled and the "
                        "baseline codec layout is kept"),
            ))
        elif self.narrowed_nbits < self.baseline_nbits:
            out.append(Finding(
                layer="spec", check="bound-narrowing",
                severity=SEV_INFO, subject=self.root,
                detail=(f"certified reachable bounds narrow the packed "
                        f"state from {self.baseline_nbits} to "
                        f"{self.narrowed_nbits} bits "
                        f"({self.baseline_words} -> "
                        f"{self.narrowed_words} uint32 words); run "
                        "with -narrow to use the narrowed codec"),
            ))
        return out


def _shape_str(sh: Optional[Shape]) -> str:
    if sh is None:
        return "bottom"
    if isinstance(sh, SInt):
        return f"int {sh.lo}..{sh.hi}"
    if isinstance(sh, SBool):
        return "bool"
    if isinstance(sh, SAtoms):
        return "{" + ", ".join(sorted(sh.atoms)) + "}"
    if isinstance(sh, SSet):
        return f"subset-of[{_shape_str(sh.elem)}]"
    if isinstance(sh, SSeq):
        return f"seq[{_shape_str(sh.elem)}] len<={sh.cap}"
    if isinstance(sh, SRec):
        inner = ", ".join(
            f"{f}{'?' if o else ''}: {_shape_str(s)}"
            for f, s, o in sh.fields
        )
        return "[" + inner + "]"
    if isinstance(sh, SUnion):
        return " | ".join(_shape_str(a) for a in sh.alts)
    return type(sh).__name__


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def _init_shapes(system, const_hints=None,
                 extra_systems=()) -> Dict[str, Optional[Shape]]:
    """Join of shape_of_value over every initial state (of the anchor
    system plus any extra per-configuration systems - the sweep-class
    audit enumerates each config's Init host-side)."""
    from ..struct.shapes import join

    out: Dict[str, Optional[Shape]] = {v: None for v in system.variables}
    for sys_ in (system, *extra_systems):
        for st in sys_.initial_states():
            for v, val in zip(sys_.variables, st):
                out[v] = join(out[v], shape_of_value(val))
    return out


def _step_writes(system, env, const_hints=None) -> Dict[str, Shape]:
    st = _Stepper(system.ev, system.variables, system.init_ast,
                  system.next_ast, env, const_hints=const_hints)
    return st.run_step()


def _certify(system, bounds, init, const_hints=None) -> bool:
    """Machine-check that `bounds` is a post-fixpoint: Init ⊑ bounds
    and step#(bounds) ⊑ bounds."""
    for v in system.variables:
        if not shape_leq(init.get(v), bounds.get(v)):
            return False
    try:
        writes = _step_writes(system, dict(bounds),
                              const_hints=const_hints)
    except (ShapeError, RecursionError):
        return False
    for v, sh in writes.items():
        if not shape_leq(sh, bounds.get(v)):
            return False
    return True


def _mask_universe(sh) -> Optional[int]:
    """Element-universe size of a top-level mask-layout set shape, or
    None when the variable is not mask-layout."""
    if not isinstance(sh, SSet):
        return None
    try:
        return len(universe(sh.elem, 1 << 16))
    except ShapeError:
        return None


def analyze_bounds(model, const_hints: Optional[Dict[str, Shape]] = None,
                   extra_init_systems=()) -> BoundReport:
    """Run the certified abstract interpretation on a loaded
    StructModel.  `const_hints` widens CONSTANT names to abstract
    values (the sweep-class audit); `extra_init_systems` contributes
    additional per-configuration Init sets to the seed."""
    from ..struct.codec import StructCodec

    t0 = time.time()
    system = model.system
    hints = typeok_hints(system.ev, model.invariants, system.variables)
    baseline = infer_shapes(system.ev, system.variables,
                            system.init_ast, system.next_ast,
                            hints=hints, const_hints=const_hints)

    init = _init_shapes(system, const_hints=const_hints,
                        extra_systems=extra_init_systems)

    # descending narrowing from the widened baseline (joined with every
    # configuration's Init seed: the anchor's ascending run only saw its
    # own initial states)
    from ..struct.shapes import join

    baseline = {
        v: join(baseline.get(v), init.get(v))
        for v in system.variables
    }

    iters = 0

    def _iterate(start, combine):
        """Fixpoint loop over F(R) = Init ∪ step#(R), post-processed by
        `combine(candidate, previous)`.  Returns the stable env or None
        when the budget runs out / the transformer fails."""
        nonlocal iters
        cur = dict(start)
        for _ in range(MAX_NARROW_ITERS):
            iters += 1
            try:
                writes = _step_writes(system, dict(cur),
                                      const_hints=const_hints)
            except (ShapeError, RecursionError):
                return None
            nxt = {}
            for v in system.variables:
                cand = join(init.get(v), writes.get(v))
                nxt[v] = combine(cand, cur.get(v))
            if nxt == cur:
                return cur
            cur = nxt
        return None

    # candidate 1: exact ascending iteration from bottom (guard-refined,
    # no widening) - the least-fixpoint chase; converges for guarded
    # counters, diverges (budget exhausted -> skipped) for unguarded
    # growth
    ascend = None
    asc_budget = iters + MAX_ASCEND_ITERS
    cur_a = dict(init)
    while iters < asc_budget:
        iters += 1
        try:
            writes = _step_writes(system, dict(cur_a),
                                  const_hints=const_hints)
        except (ShapeError, RecursionError):
            break
        nxt = {
            v: join(init.get(v), writes.get(v))
            for v in system.variables
        }
        if nxt == cur_a:
            ascend = cur_a
            break
        cur_a = nxt

    # candidate 2: descending narrowing from the widened baseline
    descend = _iterate(baseline, lambda cand, prev: _meet(cand, prev))

    certified = False
    cur = dict(baseline)
    for cand in (ascend, descend, baseline):
        if cand is None:
            continue
        if _certify(system, cand, init, const_hints=const_hints):
            cur = dict(cand)
            certified = True
            break

    # cardinality bounds for mask-layout set variables
    card_bounds: Dict[str, int] = {}
    card_universe: Dict[str, int] = {}
    set_vars = {}
    for v in system.variables:
        u = _mask_universe(cur.get(v))
        if u is not None:
            set_vars[v] = u
    if set_vars and certified:
        cards = {v: 0 for v in set_vars}
        for sys_ in (system, *extra_init_systems):
            for st in sys_.initial_states():
                for v, val in zip(sys_.variables, st):
                    if v in cards and isinstance(val, frozenset):
                        cards[v] = max(cards[v], len(val))
        for _ in range(MAX_NARROW_ITERS):
            writes: Dict[str, int] = {}
            _card_writes(system.next_ast, cards, system.ev, writes,
                         frozenset(), set(set_vars), set_vars)
            nxt = {
                v: min(max(cards[v], writes.get(v, 0)), set_vars[v])
                for v in cards
            }
            if nxt == cards:
                break
            cards = nxt
        # certify: one more transfer application must not grow any bound
        writes = {}
        _card_writes(system.next_ast, cards, system.ev, writes,
                     frozenset(), set(set_vars), set_vars)
        for v in set_vars:
            bound = min(max(cards[v], writes.get(v, 0)), set_vars[v])
            card_bounds[v] = bound if bound == cards[v] else set_vars[v]
            card_universe[v] = set_vars[v]

    rep = BoundReport(
        root=model.root_name,
        variables=system.variables,
        baseline=baseline,
        bounds={v: cur.get(v) for v in system.variables},
        card_bounds=card_bounds,
        card_universe=card_universe,
        certified=certified,
        iters=iters,
        wall_s=time.time() - t0,
    )
    try:
        base_cdc = StructCodec(system.variables, baseline)
        rep.baseline_nbits = base_cdc.nbits
        rep.baseline_words = base_cdc.n_words
        narrow_cdc = StructCodec(system.variables, rep.bounds)
        rep.narrowed_nbits = narrow_cdc.nbits
        rep.narrowed_words = narrow_cdc.n_words
    except (ShapeError, ValueError):
        # a layout the codec cannot build disables narrowing loudly
        rep.certified = False
        rep.bounds = dict(baseline)
        rep.narrowed_nbits = rep.baseline_nbits
        rep.narrowed_words = rep.baseline_words
    return rep
