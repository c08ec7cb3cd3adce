"""TLA+ value semantics for the structural frontend (E1).

Evaluates the parser's ASTs over the oracle's canonical value model
(spec.oracle State docstring): sets are frozensets, records/functions
are key-sorted tuples of (key, value) pairs, sequences are tuples -
so states produced here compare equal to hand-oracle states directly.

Covers the full expression language of the reference's committed
translation (KubeAPI.tla:373-768) plus its invariants
and define-block operators (:376-446,776-789): DOMAIN, :> and @@, IF /
CASE / LET / CHOOSE, set filter/map, sequence ops (Head/Tail/Append/
\\o/Len), function sets [S -> T], EXCEPT paths, user operator
application, Assert.  CHOOSE picks the canonically-least witness
(deterministic; TLC's pick is also deterministic but order-internal -
for specs whose CHOOSE is semantically unique, e.g. KubeAPI's Get
:311 under the OnlyOneVersion invariant, the values agree).

Original implementation; TLC's evaluator is Java and none of it is
translated here.

The port's copy of jaxtlc/struct/eval.py, which imports no jax: the port imports
nothing of the reference package and keeps its own.
"""

from __future__ import annotations

from itertools import product as _product
from typing import Dict, Optional

from ..spec.labels import DEFAULT_INIT
from .parser import Definition

_SORT_KEY = repr  # deterministic iteration order over set elements


class StructEvalError(ValueError):
    pass


class TlaAssertionError(ValueError):
    """A TLA+ Assert(...) fired during action evaluation."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.tla_msg = msg


class UnboundPrime(StructEvalError):
    """A primed variable was read before the action assigned it."""


class _Sentinel:
    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return self.name


STRING = _Sentinel("STRING")
NAT = _Sentinel("Nat")
INT = _Sentinel("Int")

BUILTIN_SETS = {
    "STRING": STRING,
    "Nat": NAT,
    "Int": INT,
    "BOOLEAN": frozenset({False, True}),
}


def canon(v):
    """Canonicalize nested containers to the oracle value model.

    A tuple of (string, value) pairs reads as a string-keyed function -
    the only tuple shape the model cannot disambiguate from a sequence
    of string-first 2-tuples.  Genuine functions are always constructed
    key-sorted with distinct keys (record literal, _pairs_to_fn, EXCEPT,
    @@), so a duplicate or out-of-order key proves the value is really a
    SEQUENCE about to be silently reordered/misrouted: raise loudly
    instead (ADVICE.md eval.py:75)."""
    if isinstance(v, tuple) and v and all(
        isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)
        for x in v
    ):
        keys = [k for k, _ in v]
        if len(set(keys)) != len(keys) or keys != sorted(keys):
            raise StructEvalError(
                "ambiguous value: a tuple of (string, value) pairs with "
                "duplicate or unsorted keys is a sequence that would be "
                f"misread as a string-keyed function: {v!r}"
            )
        return tuple(sorted((k, canon(x)) for k, x in v))
    if isinstance(v, tuple):
        return tuple(canon(x) for x in v)
    if isinstance(v, frozenset):
        return frozenset(canon(x) for x in v)
    return v


def is_fn(v) -> bool:
    """Function/record: non-empty tuple of (str, value) pairs.  The empty
    tuple is both the empty function and the empty sequence - all its
    uses below are consistent for either reading."""
    return isinstance(v, tuple) and all(
        isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)
        for x in v
    )


def fn_apply(f, arg):
    if isinstance(f, tuple):
        if f and is_fn(f):
            for k, v in f:
                if k == arg:
                    return v
            raise StructEvalError(f"{arg!r} not in DOMAIN")
        if isinstance(arg, int) and 1 <= arg <= len(f):
            return f[arg - 1]
        raise StructEvalError(f"index {arg!r} outside sequence/function")
    raise StructEvalError(f"cannot apply non-function {f!r}")


def fn_domain(f):
    if isinstance(f, tuple):
        if f and is_fn(f):
            return frozenset(k for k, _ in f)
        return frozenset(range(1, len(f) + 1))
    raise StructEvalError(f"DOMAIN of non-function {f!r}")


def fn_merge(left, right):
    """left @@ right: domain union, left-biased (TLC's TLC.tla @@)."""
    if not (is_fn(left) and is_fn(right)):
        raise StructEvalError("@@ expects functions")
    d = dict(right)
    d.update(dict(left))
    return tuple(sorted(d.items()))


class Evaluator:
    """Expression evaluator over a module's definitions + constants."""

    def __init__(self, defs: Dict[str, Definition],
                 constants: Dict[str, object]):
        self.defs = defs
        self.constants = constants

    # -- name resolution ---------------------------------------------------

    def _resolve_name(self, name: str, env: dict, primed: Optional[dict]):
        if env is not None and name in env:
            v = env[name]
            if isinstance(v, Definition):
                if v.params:
                    raise StructEvalError(
                        f"operator {name} needs {len(v.params)} arguments"
                    )
                return self.eval(v.body, env, primed)
            return v
        if name in self.constants:
            return self.constants[name]
        if name in BUILTIN_SETS:
            return BUILTIN_SETS[name]
        d = self.defs.get(name)
        if d is not None:
            if d.params:
                raise StructEvalError(
                    f"operator {name} needs {len(d.params)} arguments"
                )
            return self.eval(d.body, env, primed)
        raise StructEvalError(f"unknown name {name!r}")

    # -- evaluation --------------------------------------------------------

    def eval(self, ast, env: dict, primed: Optional[dict] = None):
        op = ast[0]
        if op in ("num", "str", "bool"):
            return ast[1]
        if op == "name":
            return self._resolve_name(ast[1], env, primed)
        if op == "prime":
            if primed is None or ast[1] not in primed:
                raise UnboundPrime(f"{ast[1]}' read before assignment")
            return primed[ast[1]]
        if op == "setlit":
            return frozenset(self.eval(x, env, primed) for x in ast[1])
        if op == "tuple":
            return tuple(self.eval(x, env, primed) for x in ast[1])
        if op == "record":
            return tuple(sorted(
                (k, self.eval(x, env, primed)) for k, x in ast[1]
            ))
        if op == "apply":
            return fn_apply(
                self.eval(ast[1], env, primed), self.eval(ast[2], env, primed)
            )
        if op == "domain":
            return fn_domain(self.eval(ast[1], env, primed))
        if op == "not":
            return not self._bool(ast[1], env, primed)
        if op == "and":
            return all(self._bool(x, env, primed) for x in ast[1])
        if op == "or":
            return any(self._bool(x, env, primed) for x in ast[1])
        if op == "implies":
            return (not self._bool(ast[1], env, primed)) or self._bool(
                ast[2], env, primed
            )
        if op == "cmp":
            return self._cmp(ast, env, primed)
        if op == "binop":
            return self._binop(ast, env, primed)
        if op == "if":
            c = self._bool(ast[1], env, primed)
            return self.eval(ast[2] if c else ast[3], env, primed)
        if op == "case":
            for g, e in ast[1]:
                if self._bool(g, env, primed):
                    return self.eval(e, env, primed)
            if ast[2] is not None:
                return self.eval(ast[2], env, primed)
            raise StructEvalError("CASE: no arm matched and no OTHER")
        if op == "let":
            env2 = dict(env)
            for name, params, body in ast[1]:
                if params:
                    env2[name] = Definition(name, params, body)
                else:
                    # non-parameterized LET bindings are evaluated eagerly
                    # (their value cannot depend on later bindings)
                    env2[name] = self.eval(body, env2, primed)
            return self.eval(ast[2], env2, primed)
        if op == "choose":
            _, var, dom_ast, pred = ast
            dom = self._set(dom_ast, env, primed)
            for x in sorted(dom, key=_SORT_KEY):
                env2 = dict(env)
                env2[var] = x
                if self._bool(pred, env2, primed):
                    return x
            raise StructEvalError("CHOOSE: no witness")
        if op in ("forall", "exists"):
            _, names, dom_ast, body = ast
            dom = sorted(self._set(dom_ast, env, primed), key=_SORT_KEY)

            def results():
                # short-circuit like TLC: a witness/falsifier stops
                # enumeration before later combos can raise
                for combo in _product(dom, repeat=len(names)):
                    env2 = dict(env)
                    env2.update(zip(names, combo))
                    yield self._bool(body, env2, primed)

            return all(results()) if op == "forall" else any(results())
        if op == "setfilter":
            _, var, dom_ast, pred = ast
            dom = self._set(dom_ast, env, primed)
            out = []
            for x in sorted(dom, key=_SORT_KEY):
                env2 = dict(env)
                env2[var] = x
                if self._bool(pred, env2, primed):
                    out.append(x)
            return frozenset(out)
        if op == "setmap":
            _, expr, var, dom_ast = ast
            dom = self._set(dom_ast, env, primed)
            out = []
            for x in sorted(dom, key=_SORT_KEY):
                env2 = dict(env)
                env2[var] = x
                out.append(self.eval(expr, env2, primed))
            return frozenset(out)
        if op == "fnlit":
            _, var, dom_ast, body = ast
            dom = self._set(dom_ast, env, primed)
            pairs = []
            for x in sorted(dom, key=_SORT_KEY):
                env2 = dict(env)
                env2[var] = x
                pairs.append((x, self.eval(body, env2, primed)))
            return _pairs_to_fn(pairs)
        if op == "funcset":
            dom = sorted(self._set(ast[1], env, primed), key=_SORT_KEY)
            rng = sorted(self._set(ast[2], env, primed), key=_SORT_KEY)
            fns = []
            for values in _product(rng, repeat=len(dom)):
                fns.append(_pairs_to_fn(list(zip(dom, values))))
            return frozenset(fns)
        if op == "except":
            f = self.eval(ast[1], env, primed)
            for path_asts, val_ast in ast[2]:
                path = [self.eval(p, env, primed) for p in path_asts]
                f = self._except(f, path, val_ast, env, primed)
            return f
        if op == "atref":
            if "@" not in env:
                raise StructEvalError("@ outside EXCEPT")
            return env["@"]
        if op == "call":
            return self._call(ast, env, primed)
        if op == "unchanged":
            raise StructEvalError(
                "UNCHANGED outside an action conjunction"
            )
        if op in ("box", "leadsto", "spec"):
            raise StructEvalError(
                f"temporal operator {op} has no state-level value"
            )
        raise StructEvalError(f"unhandled AST node {op!r}")

    # -- helpers -----------------------------------------------------------

    def _bool(self, ast, env, primed) -> bool:
        v = self.eval(ast, env, primed)
        if not isinstance(v, bool):
            raise StructEvalError(f"expected BOOLEAN, got {v!r}")
        return v

    def _set(self, ast, env, primed) -> frozenset:
        v = self.eval(ast, env, primed)
        if not isinstance(v, frozenset):
            raise StructEvalError(f"expected a set, got {v!r}")
        return v

    def _cmp(self, ast, env, primed):
        _, sym, la, ra = ast
        a = self.eval(la, env, primed)
        b = self.eval(ra, env, primed)
        if sym == "=":
            return a == b
        if sym == "#":
            return a != b
        if sym in (r"\in", r"\notin"):
            inn = self._member(a, b)
            return inn if sym == r"\in" else not inn
        if sym == r"\subseteq":
            if not (isinstance(a, frozenset) and isinstance(b, frozenset)):
                raise StructEvalError("\\subseteq expects sets")
            return a <= b
        try:
            return {"<": a < b, ">": a > b, "<=": a <= b, ">=": a >= b}[sym]
        except TypeError:
            raise StructEvalError(f"cannot order {a!r} {sym} {b!r}")

    @staticmethod
    def _member(a, b) -> bool:
        if isinstance(b, frozenset):
            return a in b
        if b is STRING:
            # model values (defaultInitValue) are not strings in TLC
            return isinstance(a, str) and a != DEFAULT_INIT
        if b is NAT:
            return isinstance(a, int) and not isinstance(a, bool) and a >= 0
        if b is INT:
            return isinstance(a, int) and not isinstance(a, bool)
        raise StructEvalError(f"\\in over non-set {b!r}")

    def _binop(self, ast, env, primed):
        _, sym, la, ra = ast
        a = self.eval(la, env, primed)
        b = self.eval(ra, env, primed)
        if sym in (r"\cup", r"\cap", "\\"):
            if not (isinstance(a, frozenset) and isinstance(b, frozenset)):
                raise StructEvalError(f"{sym} expects sets")
            return {r"\cup": a | b, r"\cap": a & b, "\\": a - b}[sym]
        if sym in ("+", "-", "*"):
            if not (isinstance(a, int) and isinstance(b, int)):
                raise StructEvalError(f"{sym} expects integers")
            return {"+": a + b, "-": a - b, "*": a * b}[sym]
        if sym == "..":
            return frozenset(range(a, b + 1))
        if sym == r"\o":
            if not (isinstance(a, tuple) and isinstance(b, tuple)):
                raise StructEvalError("\\o expects sequences")
            return a + b
        if sym == "@@":
            return fn_merge(a, b)
        if sym == ":>":
            if not isinstance(a, str):
                raise StructEvalError(":> key must be a string here")
            return ((a, b),)
        raise StructEvalError(f"unhandled binop {sym!r}")

    def _except(self, f, path, val_ast, env, primed):
        idx = path[0]
        old = fn_apply(f, idx)
        if len(path) > 1:
            val = self._except(old, path[1:], val_ast, env, primed)
        else:
            env2 = dict(env)
            env2["@"] = old
            val = self.eval(val_ast, env2, primed)
        if isinstance(f, tuple) and f and is_fn(f):
            return tuple(sorted(
                (k, val if k == idx else v) for k, v in f
            ))
        if isinstance(f, tuple) and isinstance(idx, int):
            return f[: idx - 1] + (val,) + f[idx:]
        raise StructEvalError("EXCEPT on a non-function")

    def _call(self, ast, env, primed):
        _, name, args = ast
        target = None
        if env is not None and isinstance(env.get(name), Definition):
            target = env[name]
        elif name in self.defs:
            target = self.defs[name]
        if target is not None:
            if len(target.params) != len(args):
                raise StructEvalError(
                    f"{name} expects {len(target.params)} args, "
                    f"got {len(args)}"
                )
            env2 = dict(env)
            for p, a in zip(target.params, args):
                env2[p] = self.eval(a, env, primed)
            return self.eval(target.body, env2, primed)
        vals = [self.eval(a, env, primed) for a in args]
        if name == "Cardinality":
            (s,) = vals
            if not isinstance(s, frozenset):
                raise StructEvalError("Cardinality expects a set")
            return len(s)
        if name == "Len":
            (s,) = vals
            if not isinstance(s, tuple) or is_fn(s) and s:
                raise StructEvalError("Len expects a sequence")
            return len(s)
        if name == "Head":
            (s,) = vals
            if not isinstance(s, tuple) or not s:
                raise StructEvalError("Head of empty/non-sequence")
            return s[0]
        if name == "Tail":
            (s,) = vals
            if not isinstance(s, tuple) or not s:
                raise StructEvalError("Tail of empty/non-sequence")
            return s[1:]
        if name == "Append":
            s, e = vals
            if not isinstance(s, tuple):
                raise StructEvalError("Append expects a sequence")
            return s + (e,)
        if name == "Assert":
            cond, msg = vals
            if cond is not True:
                raise TlaAssertionError(str(msg))
            return True
        raise StructEvalError(f"unknown operator {name!r}")


def _pairs_to_fn(pairs):
    """Key-typed function literal: string keys -> sorted pairs; 1..n ->
    sequence; empty -> () (empty function == empty sequence)."""
    if not pairs:
        return ()
    if all(isinstance(k, str) for k, _ in pairs):
        return tuple(sorted(pairs))
    keys = {k for k, _ in pairs}
    if keys == set(range(1, len(pairs) + 1)):
        return tuple(v for _, v in sorted(pairs))
    raise StructEvalError(
        "function domains must be strings or 1..n here"
    )
