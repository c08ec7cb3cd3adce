"""Next-state enumeration for the structural frontend (E1).

Reads a translation action as a constraint program, the way TLC's
next-state generator does: conjuncts are processed in order; `var' = e`
binds the primed variable (or checks it, if already bound), `var' \\in S`
enumerates, UNCHANGED binds identities, disjunctions and \\E binders
branch, IF branches on an evaluated condition, and every other conjunct
is a guard.  PlusCal translations are emitted in an order where every
primed read follows its assignment (e.g. the `requests'[c].obj` read
inside Get's apiState' update, KubeAPI.tla:722), so
ordered processing is complete for them.

Operator applications expand into their definition body when the body
mentions primes or UNCHANGED (action operators: API(self), Client(self),
...); otherwise they are state predicates and evaluate as guards.  The
innermost expanded non-disjunction definition names the fired action -
exactly the PlusCal label attribution TLC's coverage output uses
(MC.out:44-1092 lists DoRequest/DoReply/... as the action names).

The port's copy of jaxtlc/struct/actions.py, which imports no jax: the port imports
nothing of the reference package and keeps its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .eval import Evaluator, canon
from .parser import Definition


class StructActionError(ValueError):
    pass


def expand_unchanged(names, defs, variables) -> List[str]:
    """UNCHANGED accepts state variables AND tuple-of-variables
    definitions (the universal `vars == <<...>>` convention TLC
    honors: `UNCHANGED vars`): expand definition names into the
    variables they bundle, recursively.  Names that are neither a
    variable nor such a definition pass through unchanged so the
    caller's own unknown-variable error still fires."""
    out: List[str] = []
    for v in names:
        if v in variables:
            out.append(v)
            continue
        d = defs.get(v)
        body = getattr(d, "body", None)
        if body is not None and body[0] == "tuple" and all(
            x[0] == "name" for x in body[1]
        ):
            out.extend(expand_unchanged(
                [x[1] for x in body[1]], defs, variables
            ))
            continue
        if body is not None and body[0] == "name":
            out.extend(expand_unchanged([body[1]], defs, variables))
            continue
        out.append(v)
    return out


class ActionSystem:
    """Enumerates initial states and successors of a parsed module."""

    def __init__(self, ev: Evaluator, variables: Tuple[str, ...],
                 init_name: str, next_name: str):
        self.ev = ev
        self.variables = variables
        self.init_ast = ev.defs[init_name].body
        self.next_ast = ev.defs[next_name].body
        self._mentions_cache: Dict[int, bool] = {}

    def with_constants(self, constants: Dict[str, object]) -> "ActionSystem":
        """The same Init/Next under different CONSTANT values - the
        constant-config sweep engine (jaxtlc.serve.sweep) enumerates
        each configuration's Init set host-side through this, against
        the one already-parsed module."""
        clone = ActionSystem.__new__(ActionSystem)
        clone.ev = Evaluator(self.ev.defs, dict(constants))
        clone.variables = self.variables
        clone.init_ast = self.init_ast
        clone.next_ast = self.next_ast
        clone._mentions_cache = {}
        return clone

    # -- prime detection ---------------------------------------------------

    def _mentions_prime(self, ast) -> bool:
        key = id(ast)
        hit = self._mentions_cache.get(key)
        if hit is None:
            from .shapes import _mentions_prime_static

            hit = _mentions_prime_static(ast, self.ev.defs)
            self._mentions_cache[key] = hit
        return hit

    # -- initial states ----------------------------------------------------

    def initial_states(self) -> List[tuple]:
        """All Init-satisfying assignments, as state tuples in variable
        declaration order."""
        outs: List[Dict[str, object]] = []
        self._enum_init(self.init_ast, {}, outs)
        states = []
        for a in outs:
            missing = [v for v in self.variables if v not in a]
            if missing:
                raise StructActionError(
                    f"Init leaves {missing} unassigned"
                )
            states.append(tuple(canon(a[v]) for v in self.variables))
        return states

    def _enum_init(self, ast, bound: Dict[str, object], outs: list):
        op = ast[0]
        if op == "and":
            self._enum_init_seq(ast[1], 0, bound, outs)
            return
        self._enum_init_seq([ast], 0, bound, outs)

    def _enum_init_seq(self, items, i, bound, outs):
        if i == len(items):
            outs.append(bound)
            return
        ast = items[i]
        op = ast[0]
        env = dict(self.ev.constants)
        env.update(bound)
        if op == "and":
            self._enum_init_seq(
                list(ast[1]) + items[i + 1:], 0, bound, outs
            )
            return
        if op == "cmp" and ast[1] == "=" and ast[2][0] == "name" \
                and ast[2][1] in self.variables:
            name = ast[2][1]
            val = canon(self.ev.eval(ast[3], env))
            if name in bound:
                if bound[name] != val:
                    return
                self._enum_init_seq(items, i + 1, bound, outs)
                return
            b2 = dict(bound)
            b2[name] = val
            self._enum_init_seq(items, i + 1, b2, outs)
            return
        if op == "cmp" and ast[1] == r"\in" and ast[2][0] == "name" \
                and ast[2][1] in self.variables:
            name = ast[2][1]
            dom = self.ev.eval(ast[3], env)
            if not isinstance(dom, frozenset):
                raise StructActionError("Init: var \\in non-set")
            for val in sorted(dom, key=repr):
                b2 = dict(bound)
                b2[name] = canon(val)
                self._enum_init_seq(items, i + 1, b2, outs)
            return
        # plain guard
        v = self.ev.eval(ast, env)
        if v is True:
            self._enum_init_seq(items, i + 1, bound, outs)
        elif v is not False:
            raise StructActionError(f"Init conjunct not BOOLEAN: {ast!r}")

    # -- successors --------------------------------------------------------

    def successors(self, state: tuple) -> List[Tuple[str, tuple]]:
        """[(action_label, next_state)] - all Next successors, including
        self-loops (TLC counts them as generated successors)."""
        env = dict(self.ev.constants)
        env.update(zip(self.variables, state))
        outs: List[Tuple[str, Dict[str, object]]] = []
        self._enum(self.next_ast, env, {}, None, outs)
        result = []
        for label, primed in outs:
            missing = [v for v in self.variables if v not in primed]
            if missing:
                raise StructActionError(
                    f"action {label}: primed vars {missing} unassigned"
                )
            result.append((
                label or "?",
                tuple(canon(primed[v]) for v in self.variables),
            ))
        return result

    def _enum(self, ast, env, primed, label: Optional[str], outs):
        """Yield completed (label, primed) into outs; `primed` is never
        mutated (copied at every bind/branch)."""
        op = ast[0]
        if op == "and":
            self._enum_seq(ast[1], 0, env, primed, label, outs)
            return
        if op == "or":
            for branch in ast[1]:
                self._enum(branch, env, primed, label, outs)
            return
        if op == "exists":
            _, names, dom_ast, body = ast
            dom = self.ev.eval(dom_ast, env, primed)
            if not isinstance(dom, frozenset):
                raise StructActionError("\\E over non-set in action")
            from itertools import product as _product
            for combo in _product(sorted(dom, key=repr),
                                  repeat=len(names)):
                env2 = dict(env)
                env2.update(zip(names, combo))
                self._enum(body, env2, primed, label, outs)
            return
        if op == "if":
            c = self.ev.eval(ast[1], env, primed)
            if not isinstance(c, bool):
                raise StructActionError("IF condition not BOOLEAN")
            self._enum(ast[2] if c else ast[3], env, primed, label, outs)
            return
        if op == "let":
            env2 = dict(env)
            for name, params, body in ast[1]:
                if params:
                    env2[name] = Definition(name, params, body)
                else:
                    env2[name] = self.ev.eval(body, env2, primed)
            self._enum(ast[2], env2, primed, label, outs)
            return
        if op in ("call", "name"):
            dname = ast[1]
            d = env.get(dname)
            if not isinstance(d, Definition):
                d = self.ev.defs.get(dname)
            if isinstance(d, Definition) and self._mentions_prime(d.body):
                args = ast[2] if op == "call" else []
                if len(d.params) != len(args):
                    raise StructActionError(
                        f"{dname}: arity mismatch in action position"
                    )
                env2 = dict(env)
                for p, a in zip(d.params, args):
                    env2[p] = self.ev.eval(a, env, primed)
                inner_label = label
                if d.body[0] != "or":
                    inner_label = dname
                self._enum(d.body, env2, primed, inner_label, outs)
                return
            # falls through to guard evaluation
        if op == "unchanged":
            p2 = dict(primed)
            for v in expand_unchanged(ast[1], self.ev.defs,
                                      self.variables):
                old = env.get(v)
                if v not in env:
                    raise StructActionError(f"UNCHANGED unknown var {v}")
                if v in p2 and p2[v] != old:
                    return
                p2[v] = old
            self._enum_done(env, p2, label, outs)
            return
        if op == "cmp" and ast[1] == "=" and ast[2][0] == "prime":
            name = ast[2][1]
            val = canon(self.ev.eval(ast[3], env, primed))
            if name in primed:
                if primed[name] != val:
                    return
                self._enum_done(env, primed, label, outs)
                return
            p2 = dict(primed)
            p2[name] = val
            self._enum_done(env, p2, label, outs)
            return
        if op == "cmp" and ast[1] == r"\in" and ast[2][0] == "prime":
            name = ast[2][1]
            dom = self.ev.eval(ast[3], env, primed)
            if not isinstance(dom, frozenset):
                raise StructActionError("var' \\in non-set")
            for val in sorted(dom, key=repr):
                p2 = dict(primed)
                p2[name] = canon(val)
                self._enum_done(env, p2, label, outs)
            return
        # guard
        v = self.ev.eval(ast, env, primed)
        if v is True:
            self._enum_done(env, primed, label, outs)
        elif v is not False:
            raise StructActionError(
                f"action conjunct not BOOLEAN: {ast[:2]!r}"
            )

    def _enum_seq(self, items, i, env, primed, label, outs):
        """Process conjunct i; the continuation collects into a local list
        and forwards the rest."""
        if i == len(items):
            outs.append((label, primed))
            return
        here: List[Tuple[Optional[str], dict]] = []
        self._enum(items[i], env, primed, label, here)
        for lab, p in here:
            self._enum_seq(items, i + 1, env, p, lab or label, outs)

    def _enum_done(self, env, primed, label, outs):
        outs.append((label, primed))
