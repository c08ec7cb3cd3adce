"""Finite-shape inference for structural specs (E1 device compilation).

TLC executes unbounded TLA+ values on a JVM heap; a tensor kernel needs
every variable laid out in fixed integer lanes.  This pass infers, by
abstract interpretation of Init and every action's primed updates, a
finite *shape* per variable - the tensor-lane replacement for TLC's
dynamic value representations:

  SBool | SInt(lo,hi) | SAtoms(strings/model values) |
  SRec(field -> (shape, optional)) | SSet(elem) |
  SFun(keys, val, partial) | SSeq(elem, cap) | SUnion(alts)

Records with optional fields become presence-tagged products; sets of
records become bitmasks over the record universe (KubeAPI's apiState,
KubeAPI.tla:14); partial functions (requests :16) get
per-key presence bits; procedure frames/stacks (:466) become bounded
sequences.  The abstract domains over-approximate reachable values -
over-approximation costs lanes, never soundness, because the codec can
then represent every reachable value.  Fixpoint iteration with range
hulls for ints and a configurable cap for sequence growth (the kernel
flags overflow at runtime if a run exceeds it, like the hand kernel's
slot-overflow code).

The port's copy of jaxtlc/struct/shapes.py, which imports no jax: the port imports
nothing of the reference package and keeps its own.
"""

from __future__ import annotations

import dataclasses
from itertools import product as _product
from typing import Dict, FrozenSet, List, Optional, Tuple

from ..spec.labels import DEFAULT_INIT
from .eval import BUILTIN_SETS, Evaluator, is_fn
from .parser import Definition


class ShapeError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Shape classes (immutable, hashable)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Shape:
    pass


@dataclasses.dataclass(frozen=True)
class SBool(Shape):
    pass


@dataclasses.dataclass(frozen=True)
class SInt(Shape):
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class SAtoms(Shape):
    atoms: FrozenSet[str]


@dataclasses.dataclass(frozen=True)
class SRec(Shape):
    # (field, shape, optional) triples, field-sorted
    fields: Tuple[Tuple[str, Shape, bool], ...]

    def field(self, name: str) -> Optional[Tuple[Shape, bool]]:
        for f, s, o in self.fields:
            if f == name:
                return s, o
        return None


@dataclasses.dataclass(frozen=True)
class SSet(Shape):
    elem: Optional[Shape]  # None = always-empty set


@dataclasses.dataclass(frozen=True)
class SFun(Shape):
    keys: Tuple[str, ...]
    val: Optional[Shape]  # None = always-empty function
    partial: bool


@dataclasses.dataclass(frozen=True)
class SSeq(Shape):
    elem: Optional[Shape]
    cap: int


@dataclasses.dataclass(frozen=True)
class SUnion(Shape):
    alts: Tuple[Shape, ...]  # at most one alt per shape class


SEQ_CAP_LIMIT = 2  # widening clamp; kernel checks overflow at runtime


# ---------------------------------------------------------------------------
# Join
# ---------------------------------------------------------------------------


def join(a: Optional[Shape], b: Optional[Shape]) -> Optional[Shape]:
    if a is None:
        return b
    if b is None:
        return a
    # the empty tuple value is both the empty function and the empty
    # sequence (eval._pairs_to_fn); its shape SSeq(None, 0) coerces to
    # whatever container it joins with
    if a == SSeq(None, 0) and not isinstance(b, SSeq):
        a = _empty_as(b)
    if b == SSeq(None, 0) and not isinstance(a, SSeq):
        b = _empty_as(a)
    if isinstance(a, SUnion) or isinstance(b, SUnion):
        alts = list(a.alts if isinstance(a, SUnion) else (a,))
        for x in (b.alts if isinstance(b, SUnion) else (b,)):
            alts = _merge_alt(alts, x)
        return alts[0] if len(alts) == 1 else SUnion(tuple(alts))
    if type(a) is not type(b):
        return SUnion(tuple(_merge_alt([a], b)))
    if isinstance(a, SBool):
        return a
    if isinstance(a, SInt):
        return SInt(min(a.lo, b.lo), max(a.hi, b.hi))
    if isinstance(a, SAtoms):
        return SAtoms(a.atoms | b.atoms)
    if isinstance(a, SRec):
        names = sorted({f for f, _, _ in a.fields}
                       | {f for f, _, _ in b.fields})
        out = []
        for n in names:
            fa, fb = a.field(n), b.field(n)
            if fa is None:
                out.append((n, fb[0], True))
            elif fb is None:
                out.append((n, fa[0], True))
            else:
                out.append((n, join(fa[0], fb[0]), fa[1] or fb[1]))
        return SRec(tuple(out))
    if isinstance(a, SSet):
        return SSet(join(a.elem, b.elem))
    if isinstance(a, SFun):
        keys = tuple(sorted(set(a.keys) | set(b.keys)))
        partial = a.partial or b.partial or set(a.keys) != set(b.keys)
        return SFun(keys, join(a.val, b.val), partial)
    if isinstance(a, SSeq):
        return SSeq(join(a.elem, b.elem), min(max(a.cap, b.cap),
                                              SEQ_CAP_LIMIT))
    raise ShapeError(f"cannot join {a} and {b}")


def _empty_as(like: Shape) -> Shape:
    """The empty-container shape coerced to `like`'s container class."""
    if isinstance(like, SFun):
        return SFun((), None, True)
    if isinstance(like, SRec):
        return SRec(())
    if isinstance(like, SUnion):
        for alt in like.alts:
            if isinstance(alt, (SFun, SRec)):
                return _empty_as(alt)
    return SSeq(None, 0)


def _merge_alt(alts: List[Shape], x: Shape) -> List[Shape]:
    out = []
    merged = False
    for alt in alts:
        if type(alt) is type(x):
            out.append(join(alt, x))
            merged = True
        else:
            out.append(alt)
    if not merged:
        out.append(x)
    return sorted(out, key=lambda s: type(s).__name__)


# ---------------------------------------------------------------------------
# Shape of a concrete value
# ---------------------------------------------------------------------------


def shape_of_value(v) -> Shape:
    if isinstance(v, bool):
        return SBool()
    if isinstance(v, int):
        return SInt(v, v)
    if isinstance(v, str):
        return SAtoms(frozenset({v}))
    if isinstance(v, frozenset):
        elem = None
        for x in v:
            elem = join(elem, shape_of_value(x))
        return SSet(elem)
    if isinstance(v, tuple):
        if v and is_fn(v):
            # records AND string-keyed functions both become SRec: per-key
            # field shapes with presence bits (partial functions get
            # optional fields); one shape class covers TLA's record/
            # function unification
            return SRec(tuple(
                (k, shape_of_value(x), False) for k, x in v
            ))
        elem = None
        for x in v:
            elem = join(elem, shape_of_value(x))
        return SSeq(elem, len(v))
    raise ShapeError(f"cannot shape value {v!r}")


# ---------------------------------------------------------------------------
# Universe enumeration
# ---------------------------------------------------------------------------

ENUM_LIMIT = 1 << 21


def universe(shape: Optional[Shape], limit: int = ENUM_LIMIT) -> List:
    """All canonical values of `shape`, deterministic order.  Raises
    ShapeError when the universe exceeds `limit` (caller then decomposes
    the shape structurally instead of enumerating it)."""
    if shape is None:
        return []
    if isinstance(shape, SBool):
        return [False, True]
    if isinstance(shape, SInt):
        n = shape.hi - shape.lo + 1
        if n > limit:
            raise ShapeError(f"int range too large: {shape}")
        return list(range(shape.lo, shape.hi + 1))
    if isinstance(shape, SAtoms):
        return sorted(shape.atoms)
    if isinstance(shape, SRec):
        per_field = []
        total = 1
        for f, s, opt in shape.fields:
            u = universe(s, limit)
            opts = ([None] if opt else []) + u
            total *= max(len(opts), 1)
            if total > limit:
                raise ShapeError(f"record universe too large at {f}")
            per_field.append((f, opts))
        out = []
        for combo in _product(*(opts for _, opts in per_field)):
            out.append(tuple(
                (f, v) for (f, _), v in zip(per_field, combo)
                if v is not None
            ))
        return out
    if isinstance(shape, SSet):
        eu = universe(shape.elem, 20)  # subsets only of tiny universes
        if len(eu) > 20:
            raise ShapeError("set universe too large to enumerate")
        out = []
        for bits in range(1 << len(eu)):
            out.append(frozenset(
                eu[i] for i in range(len(eu)) if bits >> i & 1
            ))
        return out
    if isinstance(shape, SSeq):
        eu = universe(shape.elem, limit)
        total = sum(len(eu) ** k for k in range(shape.cap + 1))
        if total > limit:
            raise ShapeError("sequence universe too large")
        out = [()]
        layer = [()]
        for _ in range(shape.cap):
            layer = [t + (e,) for t in layer for e in eu]
            out.extend(layer)
        return out
    if isinstance(shape, SFun):
        per_key = []
        total = 1
        for k in shape.keys:
            u = universe(shape.val, limit)
            opts = ([None] if shape.partial else []) + u
            total *= max(len(opts), 1)
            if total > limit:
                raise ShapeError("function universe too large")
            per_key.append((k, opts))
        out = []
        for combo in _product(*(opts for _, opts in per_key)):
            out.append(tuple(
                (k, v) for (k, _), v in zip(per_key, combo)
                if v is not None
            ))
        return out
    if isinstance(shape, SUnion):
        out = []
        for alt in shape.alts:
            out.extend(universe(alt, limit - len(out)))
        return out
    raise ShapeError(f"cannot enumerate {shape}")


def enumerable(shape: Optional[Shape], limit: int = ENUM_LIMIT) -> bool:
    try:
        universe(shape, limit)
        return True
    except ShapeError:
        return False


# ---------------------------------------------------------------------------
# Abstract interpretation of expressions
# ---------------------------------------------------------------------------


class ShapeInference:
    """Infers per-variable shapes from Init + all primed updates."""

    # abstract values for CONSTANT names, consulted before the concrete
    # ev.constants: the sweep-class audit (jaxtlc.analysis) widens a
    # swept constant to its whole lo..hi interval here, so one abstract
    # pass covers every configuration of the class
    const_hints: Dict[str, Shape] = {}

    def __init__(self, ev: Evaluator, variables: Tuple[str, ...],
                 init_ast, next_ast):
        self.ev = ev
        self.variables = variables
        self.init_ast = init_ast
        self.next_ast = next_ast
        self.var_shapes: Dict[str, Optional[Shape]] = {
            v: None for v in variables
        }

    # -- fixpoint ----------------------------------------------------------

    def run(self, max_iters: int = 30) -> Dict[str, Shape]:
        # seed from concrete initial states (uses the exact evaluator)
        from .actions import ActionSystem

        system = ActionSystem.__new__(ActionSystem)
        system.ev = self.ev
        system.variables = self.variables
        system.init_ast = self.init_ast
        system.next_ast = self.next_ast
        system._mentions_cache = {}
        for st in system.initial_states():
            for v, val in zip(self.variables, st):
                self.var_shapes[v] = join(
                    self.var_shapes[v], shape_of_value(val)
                )
        hints = getattr(self, "hints", {})
        for it in range(max_iters):
            before = dict(self.var_shapes)
            self._pass_next()
            if it >= 2:
                # widen growing int ranges up a threshold ladder so
                # counter-style specs (x' = x + 1 under a guard the
                # abstract pass cannot see) converge; the kernel traps
                # at runtime if a real value escapes the widened range
                for v in self.variables:
                    self.var_shapes[v] = _widen(before.get(v),
                                                self.var_shapes[v])
            for v, hint in hints.items():
                # TypeOK-declared bounds keep universes tight (one value
                # of slack, see typeok_hints); clamping LAST keeps the
                # widen/clamp pair convergent
                self.var_shapes[v] = _clamp(self.var_shapes[v], hint)
            if self.var_shapes == before:
                return {v: s for v, s in self.var_shapes.items()}
        raise ShapeError("shape inference did not converge")

    def _pass_next(self):
        env = {v: s for v, s in self.var_shapes.items()}
        self._walk_action(self.next_ast, dict(env))

    # -- action walk: collect var' = rhs joins -----------------------------

    def _walk_action(self, ast, env):
        op = ast[0]
        if op in ("and", "or"):
            for x in ast[1]:
                self._walk_action(x, env)
            return
        if op == "exists":
            _, names, dom_ast, body = ast
            dom_sh = self._abstract(dom_ast, env)
            elem = self._elem_shape(dom_sh)
            env2 = dict(env)
            for nm in names:
                env2[nm] = elem
            self._walk_action(body, env2)
            return
        if op == "if":
            self._walk_action(ast[2], env)
            self._walk_action(ast[3], env)
            return
        if op == "let":
            env2 = dict(env)
            for name, params, body in ast[1]:
                if params:
                    env2[name] = Definition(name, params, body)
                else:
                    env2[name] = self._abstract(body, env2)
            self._walk_action(ast[2], env2)
            return
        if op in ("call", "name"):
            dname = ast[1]
            d = env.get(dname)
            if not isinstance(d, Definition):
                d = self.ev.defs.get(dname)
            if isinstance(d, Definition) and _mentions_prime_static(
                d.body, self.ev.defs
            ):
                args = ast[2] if op == "call" else []
                env2 = dict(env)
                for p, a in zip(d.params, args):
                    env2[p] = self._abstract(a, env)
                self._walk_action(d.body, env2)
            return
        if op == "cmp" and ast[1] in ("=", r"\in") and ast[2][0] == "prime":
            name = ast[2][1]
            rhs = self._abstract(ast[3], env)
            if ast[1] == r"\in":
                rhs = self._elem_shape(rhs)
            self._record_write(name, rhs)
            return
        # guards / UNCHANGED contribute nothing

    def _record_write(self, name: str, sh: Optional[Shape]) -> None:
        """One primed assignment observed; the abstract-interpretation
        subclass (analysis.absint) collects writes separately to run
        descending (narrowing) iterations."""
        self.var_shapes[name] = join(self.var_shapes[name], sh)

    # -- abstract expression evaluation ------------------------------------

    def _elem_shape(self, sh: Optional[Shape]) -> Optional[Shape]:
        if isinstance(sh, SSet):
            return sh.elem
        if isinstance(sh, SUnion):
            out = None
            for a in sh.alts:
                if isinstance(a, SSet):
                    out = join(out, a.elem)
            return out
        return None

    def _abstract(self, ast, env) -> Optional[Shape]:
        op = ast[0]
        if op == "bool":
            return SBool()
        if op == "num":
            return SInt(ast[1], ast[1])
        if op == "str":
            return SAtoms(frozenset({ast[1]}))
        if op == "name":
            nm = ast[1]
            if nm in env and not isinstance(env[nm], Definition):
                return env[nm]
            if nm in self.const_hints:
                return self.const_hints[nm]
            if nm in self.ev.constants:
                return shape_of_value(self.ev.constants[nm])
            if nm in BUILTIN_SETS:
                v = BUILTIN_SETS[nm]
                if isinstance(v, frozenset):
                    return shape_of_value(v)
                raise ShapeError(f"cannot shape builtin set {nm}")
            d = self.ev.defs.get(nm)
            if d is not None and not d.params:
                return self._abstract(d.body, env)
            raise ShapeError(f"unknown name {nm!r} in shape inference")
        if op == "prime":
            return self.var_shapes[ast[1]]
        if op == "setlit":
            elem = None
            for x in ast[1]:
                elem = join(elem, self._abstract(x, env))
            return SSet(elem)
        if op == "tuple":
            elem = None
            for x in ast[1]:
                elem = join(elem, self._abstract(x, env))
            return SSeq(elem, len(ast[1]))
        if op == "record":
            return SRec(tuple(sorted(
                (f, self._abstract(x, env), False) for f, x in ast[1]
            )))
        if op == "apply":
            base = self._abstract(ast[1], env)
            arg_ast = ast[2]
            return self._apply_shape(base, arg_ast, env)
        if op == "domain":
            base = self._abstract(ast[1], env)
            keys = self._domain_atoms(base)
            if keys is not None:
                return SSet(SAtoms(frozenset(keys)))
            return SSet(SInt(1, SEQ_CAP_LIMIT))
        if op in ("not", "and", "or", "implies", "forall", "exists"):
            return SBool()
        if op == "cmp":
            return SBool()
        if op == "binop":
            return self._binop_shape(ast, env)
        if op == "if":
            return join(self._abstract(ast[2], env),
                        self._abstract(ast[3], env))
        if op == "case":
            out = None
            for _, e in ast[1]:
                out = join(out, self._abstract(e, env))
            if ast[2] is not None:
                out = join(out, self._abstract(ast[2], env))
            return out
        if op == "let":
            env2 = dict(env)
            for name, params, body in ast[1]:
                if params:
                    env2[name] = Definition(name, params, body)
                else:
                    env2[name] = self._abstract(body, env2)
            return self._abstract(ast[2], env2)
        if op == "choose":
            _, var, dom_ast, _ = ast
            return self._elem_shape(self._abstract(dom_ast, env))
        if op == "setfilter":
            _, var, dom_ast, _ = ast
            dom = self._abstract(dom_ast, env)
            if isinstance(dom, SSet):
                return dom
            return SSet(self._elem_shape(dom))
        if op == "setmap":
            _, expr, var, dom_ast = ast
            dom = self._abstract(dom_ast, env)
            env2 = dict(env)
            env2[var] = self._elem_shape(dom)
            return SSet(self._abstract(expr, env2))
        if op == "fnlit":
            _, var, dom_ast, body = ast
            dom = self._abstract(dom_ast, env)
            elem = self._elem_shape(dom)
            env2 = dict(env)
            env2[var] = elem
            val = self._abstract(body, env2)
            keys = self._atoms_of(elem)
            if keys is None:
                if elem is None:
                    return SRec(())
                raise ShapeError("fnlit over non-atom domain")
            return SRec(tuple(
                (k, val, False) for k in sorted(keys)
            ))
        if op == "funcset":
            dom = self._abstract(ast[1], env)
            rng = self._elem_shape(self._abstract(ast[2], env))
            keys = self._atoms_of(self._elem_shape(dom))
            if keys is None:
                raise ShapeError("function set over non-atom domain")
            return SSet(SRec(tuple(
                (k, rng, False) for k in sorted(keys)
            )))
        if op == "except":
            base = self._abstract(ast[1], env)
            for path_asts, val_ast in ast[2]:
                base = self._except_shape(base, path_asts, val_ast, env)
            return base
        if op == "atref":
            if "@" not in env:
                raise ShapeError("@ outside EXCEPT in shape inference")
            return env["@"]  # may be None (bottom) early in the fixpoint
        if op == "call":
            return self._call_shape(ast, env)
        if op == "unchanged":
            return SBool()
        raise ShapeError(f"cannot abstract {op!r}")

    def _atoms_of(self, sh) -> Optional[FrozenSet[str]]:
        if isinstance(sh, SAtoms):
            return sh.atoms
        if isinstance(sh, SUnion):
            out = frozenset()
            for a in sh.alts:
                if isinstance(a, SAtoms):
                    out |= a.atoms
                else:
                    return None
            return out
        return None

    def _domain_atoms(self, sh) -> Optional[FrozenSet[str]]:
        if isinstance(sh, SFun):
            return frozenset(sh.keys)
        if isinstance(sh, SRec):
            return frozenset(f for f, _, _ in sh.fields)
        if sh is None or sh == SSeq(None, 0):
            return frozenset()  # DOMAIN of the empty function is {}
        if isinstance(sh, SUnion):
            # alternatives with no DOMAIN (atoms flowing through guards)
            # are runtime-unreachable in DOMAIN position - skip them
            out = frozenset()
            any_dom = False
            for a in sh.alts:
                d = self._domain_atoms(a)
                if d is not None:
                    any_dom = True
                    out |= d
            return out if any_dom else None
        return None

    def _apply_shape(self, base, arg_ast, env) -> Optional[Shape]:
        shapes = base.alts if isinstance(base, SUnion) else (base,)
        out = None
        for sh in shapes:
            if isinstance(sh, SRec):
                if arg_ast[0] == "str":
                    f = sh.field(arg_ast[1])
                    if f is not None:
                        out = join(out, f[0])
                else:
                    for _, s, _ in sh.fields:
                        out = join(out, s)
            elif isinstance(sh, SFun):
                out = join(out, sh.val)
            elif isinstance(sh, SSeq):
                out = join(out, sh.elem)
        return out

    def _binop_shape(self, ast, env) -> Optional[Shape]:
        _, sym, la, ra = ast
        a = self._abstract(la, env)
        b = self._abstract(ra, env)
        if sym in (r"\cup", r"\cap", "\\"):
            ea = self._elem_shape(a)
            eb = self._elem_shape(b)
            if sym == r"\cup":
                return SSet(join(ea, eb))
            return SSet(ea)
        if sym in ("+", "-", "*"):
            if isinstance(a, SInt) and isinstance(b, SInt):
                if sym == "+":
                    return SInt(a.lo + b.lo, a.hi + b.hi)
                if sym == "-":
                    return SInt(a.lo - b.hi, a.hi - b.lo)
                corners = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo,
                           a.hi * b.hi]
                return SInt(min(corners), max(corners))
            return SInt(-(1 << 30), 1 << 30)
        if sym == "..":
            if isinstance(a, SInt) and isinstance(b, SInt):
                return SSet(SInt(a.lo, b.hi))
            raise ShapeError(".. over non-ints")
        if sym == r"\o":
            sa = a if isinstance(a, SSeq) else SSeq(None, 0)
            sb = b if isinstance(b, SSeq) else SSeq(None, 0)
            return SSeq(join(sa.elem, sb.elem),
                        min(sa.cap + sb.cap, SEQ_CAP_LIMIT))
        if sym == ":>":
            keys = self._atoms_of(a)
            if keys is None:
                raise ShapeError(":> with non-atom key")
            # single-key function; with several possible keys each is
            # optional (exactly one will be present at runtime)
            opt = len(keys) > 1
            return SRec(tuple(
                (k, b, opt) for k in sorted(keys)
            ))
        if sym == "@@":
            return self._merge_fun_shapes(a, b)
        raise ShapeError(f"cannot abstract binop {sym}")

    def _merge_fun_shapes(self, a, b) -> Shape:
        def as_fun(sh):
            """Function-like view of sh, or None.  Non-function
            alternatives (e.g. the defaultInitValue atom flowing through
            Write's argument) are guard-unreachable at runtime - TLC
            would error on them too - so they contribute nothing."""
            if isinstance(sh, SRec):
                return sh
            if isinstance(sh, SFun):
                return SRec(tuple(
                    (k, sh.val, sh.partial) for k in sh.keys
                ))
            if sh == SSeq(None, 0):
                return SRec(())
            if isinstance(sh, SUnion):
                out = None
                for alt in sh.alts:
                    f = as_fun(alt)
                    if f is not None:
                        out = join(out, f)
                return out
            return None

        fa, fb = as_fun(a), as_fun(b)
        if fa is None and fb is None:
            raise ShapeError(f"@@ over {a} and {b}")
        if fa is None:
            return fb
        if fb is None:
            return fa
        if isinstance(fa, SRec) or isinstance(fb, SRec):
            # record-style merge: union fields; a's fields win (present),
            # b-only fields keep b's optionality
            fields: Dict[str, Tuple[Shape, bool]] = {}
            if isinstance(fb, SRec):
                for f, s, o in fb.fields:
                    fields[f] = (s, o)
            else:
                for k in fb.keys:
                    fields[k] = (fb.val, fb.partial)
            if isinstance(fa, SRec):
                for f, s, o in fa.fields:
                    if f in fields:
                        fields[f] = (join(fields[f][0], s),
                                     fields[f][1] and o)
                    else:
                        fields[f] = (s, o)
            else:
                for k in fa.keys:
                    old = fields.get(k)
                    if old:
                        fields[k] = (join(old[0], fa.val),
                                     old[1] and fa.partial)
                    else:
                        fields[k] = (fa.val, fa.partial)
            return SRec(tuple(sorted(
                (f, s, o) for f, (s, o) in fields.items()
            )))
        keys = tuple(sorted(set(fa.keys) | set(fb.keys)))
        partial = fa.partial and fb.partial
        return SFun(keys, join(fa.val, fb.val), partial)

    def _except_shape(self, base, path_asts, val_ast, env):
        shapes = base.alts if isinstance(base, SUnion) else (base,)
        out = None
        for sh in shapes:
            out = join(out, self._except_one(sh, path_asts, val_ast, env))
        return out

    def _except_one(self, sh, path_asts, val_ast, env):
        idx_ast = path_asts[0]
        if sh is None or sh == SSeq(None, 0):
            # bottom / empty container: early fixpoint iterations see
            # EXCEPT before any assignment populated the base shape
            if idx_ast[0] == "str":
                sh = SRec(((idx_ast[1], None, True),))
            else:
                return None
        if isinstance(sh, SRec) and idx_ast[0] != "str":
            # dynamic index ![self]: the update may land on any key -
            # join the new value into every field (sound over-approx)
            fields = []
            for fn, s, o in sh.fields:
                if len(path_asts) > 1:
                    new = self._except_one(s, path_asts[1:], val_ast, env)
                else:
                    env2 = dict(env)
                    env2["@"] = s
                    new = self._abstract(val_ast, env2)
                fields.append((fn, join(s, new), o))
            return SRec(tuple(fields))
        if isinstance(sh, SRec) and idx_ast[0] == "str":
            f = sh.field(idx_ast[1])
            old = f[0] if f else None
            if len(path_asts) > 1:
                new = self._except_one(old, path_asts[1:], val_ast, env)
            else:
                env2 = dict(env)
                env2["@"] = old
                new = self._abstract(val_ast, env2)
            fields = []
            seen = False
            for fn, s, o in sh.fields:
                if fn == idx_ast[1]:
                    fields.append((fn, join(s, new), o))
                    seen = True
                else:
                    fields.append((fn, s, o))
            if not seen:
                fields.append((idx_ast[1], new, True))
            return SRec(tuple(sorted(fields)))
        if isinstance(sh, SFun):
            old = sh.val
            if len(path_asts) > 1:
                new = self._except_one(old, path_asts[1:], val_ast, env)
            else:
                env2 = dict(env)
                env2["@"] = old
                new = self._abstract(val_ast, env2)
            return SFun(sh.keys, join(sh.val, new), sh.partial)
        if isinstance(sh, SSeq):
            old = sh.elem
            if len(path_asts) > 1:
                new = self._except_one(old, path_asts[1:], val_ast, env)
            else:
                env2 = dict(env)
                env2["@"] = old
                new = self._abstract(val_ast, env2)
            return SSeq(join(sh.elem, new), sh.cap)
        raise ShapeError(f"EXCEPT on shape {sh}")

    def _call_shape(self, ast, env) -> Optional[Shape]:
        _, name, args = ast
        d = env.get(name)
        if not isinstance(d, Definition):
            d = self.ev.defs.get(name)
        if isinstance(d, Definition):
            env2 = dict(env)
            for p, a in zip(d.params, args):
                env2[p] = self._abstract(a, env)
            return self._abstract(d.body, env2)
        if name in ("Cardinality", "Len"):
            return SInt(0, 64)
        if name == "Head":
            sh = self._abstract(args[0], env)
            if isinstance(sh, SSeq):
                return sh.elem
            return None
        if name == "Tail":
            sh = self._abstract(args[0], env)
            if isinstance(sh, SSeq):
                return SSeq(sh.elem, max(sh.cap - 1, 0))
            return sh
        if name == "Append":
            sh = self._abstract(args[0], env)
            el = self._abstract(args[1], env)
            cap = sh.cap if isinstance(sh, SSeq) else 0
            elem = sh.elem if isinstance(sh, SSeq) else None
            return SSeq(join(elem, el), min(cap + 1, SEQ_CAP_LIMIT))
        if name == "Assert":
            return SBool()
        raise ShapeError(f"cannot abstract call {name}")


_INT_THRESHOLDS = (1, 3, 7, 15, 31, 63, 127, 255, 511, 1023, 4095,
                   16383, 65535)


def _widen(old: Optional[Shape], new: Optional[Shape]) -> Optional[Shape]:
    """Accelerate int-range growth to the next threshold (sticky at the
    top) so the fixpoint terminates; recurses through containers."""
    if new is None or old is None or old == new:
        return new
    if isinstance(new, SInt) and isinstance(old, SInt):
        hi = new.hi
        if hi > old.hi:
            hi = next((t for t in _INT_THRESHOLDS if t >= hi),
                      _INT_THRESHOLDS[-1])
        lo = new.lo
        if lo < old.lo:
            lo = -next((t for t in _INT_THRESHOLDS if t >= -lo),
                       _INT_THRESHOLDS[-1]) - 1
        return SInt(min(lo, hi), hi)
    if isinstance(new, SRec) and isinstance(old, SRec):
        return SRec(tuple(
            (f, _widen(old.field(f)[0] if old.field(f) else None, s), o)
            for f, s, o in new.fields
        ))
    if isinstance(new, SSet) and isinstance(old, SSet):
        return SSet(_widen(old.elem, new.elem))
    if isinstance(new, SSeq) and isinstance(old, SSeq):
        return SSeq(_widen(old.elem, new.elem), new.cap)
    if isinstance(new, SUnion) and isinstance(old, SUnion):
        olds = {type(a): a for a in old.alts}
        return SUnion(tuple(
            _widen(olds.get(type(a)), a) for a in new.alts
        ))
    return new


def _mentions_prime_static(ast, defs, _seen=None) -> bool:
    if _seen is None:
        _seen = set()
    stack = [ast]
    while stack:
        node = stack.pop()
        if isinstance(node, tuple):
            if node and node[0] in ("prime", "unchanged"):
                return True
            if node and node[0] in ("call", "name"):
                d = defs.get(node[1])
                if d is not None and node[1] not in _seen:
                    _seen.add(node[1])
                    stack.append(d.body)
            stack.extend(x for x in node if isinstance(x, (tuple, list)))
        elif isinstance(node, list):
            stack.extend(x for x in node if isinstance(x, (tuple, list)))
    return False


def typeok_hints(ev: Evaluator, invariants: Dict[str, tuple],
                 variables) -> Dict[str, Shape]:
    """Extract per-variable bounds from TypeOK-style conjuncts: the same
    place TLC users document type bounds (`x \\in 0..N`,
    `f \\in [S -> D]`).  Ints get one value of slack beyond the declared
    bound so an off-by-one violation still encodes faithfully and is
    reported as the invariant violation it is (values beyond the slack
    hit the runtime range trap instead)."""
    hints: Dict[str, Shape] = {}

    def dom_shape(ast) -> Optional[Shape]:
        """ELEMENT shape of a constant set expression, with int slack."""
        try:
            v = ev.eval(ast, {})
        except Exception:
            return None
        if not isinstance(v, frozenset):
            return None
        sh = None
        for x in v:
            sh = join(sh, shape_of_value(x))
        return _slack(sh)

    def visit(ast):
        if not isinstance(ast, tuple):
            return
        if ast[0] == "and":
            for x in ast[1]:
                visit(x)
            return
        if ast[0] == "cmp" and ast[1] == r"\in" and ast[2][0] == "name" \
                and ast[2][1] in variables:
            var = ast[2][1]
            rhs = ast[3]
            if rhs[0] == "funcset":
                keys_sh = dom_shape(rhs[1])
                val_sh = dom_shape(rhs[2])
                if val_sh is not None and isinstance(keys_sh, SAtoms):
                    hints[var] = SRec(tuple(
                        (k, val_sh, False)
                        for k in sorted(keys_sh.atoms)
                    ))
            else:
                sh = dom_shape(rhs)
                if sh is not None:
                    hints[var] = sh

    for ast in invariants.values():
        visit(ast)
    return hints


def _slack(sh: Optional[Shape]) -> Optional[Shape]:
    if isinstance(sh, SInt):
        return SInt(sh.lo - 1, sh.hi + 1)
    return sh


def _clamp(sh: Optional[Shape], hint: Optional[Shape]) -> Optional[Shape]:
    """Meet `sh` with a TypeOK hint (ints narrowed; containers
    recursed); anything the hint does not constrain stays as inferred."""
    if sh is None or hint is None:
        return sh
    if isinstance(sh, SInt) and isinstance(hint, SInt):
        lo = max(sh.lo, hint.lo)
        hi = min(sh.hi, hint.hi)
        return SInt(lo, max(lo, hi))
    if isinstance(sh, SRec) and isinstance(hint, SRec):
        return SRec(tuple(
            (f, _clamp(s, hint.field(f)[0] if hint.field(f) else None),
             o)
            for f, s, o in sh.fields
        ))
    if isinstance(sh, SSet) and isinstance(hint, SSet):
        return SSet(_clamp(sh.elem, hint.elem))
    if isinstance(sh, SSeq):
        elem_hint = hint.elem if isinstance(hint, SSeq) else (
            hint if isinstance(hint, SInt) else None)
        return SSeq(_clamp(sh.elem, elem_hint), sh.cap)
    if isinstance(sh, SUnion):
        return SUnion(tuple(_clamp(a, hint) if isinstance(a, type(hint))
                            else a for a in sh.alts))
    return sh


def shape_leq(a: Optional[Shape], b: Optional[Shape]) -> bool:
    """Abstract-domain containment: every concrete value of `a` is a
    value of `b`.  Conservative (False on anything unproven) - this is
    the check that CERTIFIES a narrowed bound environment as a
    post-fixpoint (analysis.absint), so an unprovable containment must
    fail closed."""
    if a is None:
        return True  # bottom
    if b is None:
        return False
    if a == b:
        return True
    # the empty container coerces across container classes (see join)
    if a == SSeq(None, 0) and isinstance(b, (SFun, SRec, SSeq)):
        return True
    if isinstance(b, SUnion):
        alts = a.alts if isinstance(a, SUnion) else (a,)
        return all(any(shape_leq(x, alt) for alt in b.alts)
                   for x in alts)
    if isinstance(a, SUnion):
        return all(shape_leq(x, b) for x in a.alts)
    if type(a) is not type(b):
        return False
    if isinstance(a, SBool):
        return True
    if isinstance(a, SInt):
        return b.lo <= a.lo and a.hi <= b.hi
    if isinstance(a, SAtoms):
        return a.atoms <= b.atoms
    if isinstance(a, SRec):
        bf = {f: (s, o) for f, s, o in b.fields}
        for f, s, o in a.fields:
            if f not in bf:
                return False
            bs, bo = bf[f]
            if o and not bo:
                return False  # a may omit the field; b cannot
            if not shape_leq(s, bs):
                return False
        # fields of b absent from a must be omittable in b
        anames = {f for f, _, _ in a.fields}
        return all(o for f, _, o in b.fields if f not in anames)
    if isinstance(a, SSet):
        return shape_leq(a.elem, b.elem)
    if isinstance(a, SSeq):
        return a.cap <= b.cap and shape_leq(a.elem, b.elem)
    if isinstance(a, SFun):
        if not set(a.keys) <= set(b.keys):
            return False
        if not b.partial and (a.partial or set(a.keys) != set(b.keys)):
            return False
        return shape_leq(a.val, b.val)
    return False


def infer_shapes(ev: Evaluator, variables, init_ast, next_ast,
                 hints: Optional[Dict[str, Shape]] = None,
                 const_hints: Optional[Dict[str, Shape]] = None
                 ) -> Dict[str, Shape]:
    inf = ShapeInference(ev, variables, init_ast, next_ast)
    inf.hints = hints or {}
    if const_hints:
        inf.const_hints = dict(const_hints)
    return inf.run()
