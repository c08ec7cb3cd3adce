"""Finite-domain IR for the generic spec frontend (E1).

The reference engine (TLC) interprets arbitrary TLA+ semantic graphs
(SANY output, KubeAPI.toolbox/Model_1/MC.out:8-24).  This
IR covers the PlusCal-translation subset the generic path executes:

* every VARIABLE is either a scalar or a one-level function over a finite
  index set (process ids / model values); every component value ranges
  over a finite domain (ints a..b, string enumerants, booleans) declared
  by the spec's TypeOK conjuncts - the same place TLC's users document
  type bounds;
* every action is a guard + per-variable updates (primed assignments /
  EXCEPT / UNCHANGED) with at most one bound process parameter (the
  `\\E self \\in S : act(self)` shape every PlusCal translation has);
* Init is a conjunction of `var = expr` assignments.

Values at the IR boundary are the texpr value model (ints, strings,
bools, key-sorted pair tuples for functions); the codec (gen.codec) maps
each component to a dense integer code for the tensor kernel.

The port's copy of jaxtlc/gen/ir.py, which imports no jax: the port imports
nothing of the reference package and keeps its own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Domain:
    """Finite component domain: explicit value list, code = list index."""

    values: Tuple  # ints, strings, or bools (mixed not allowed)

    @property
    def size(self) -> int:
        return len(self.values)

    def code(self, v) -> int:
        try:
            return self.values.index(v)
        except ValueError:
            raise ValueError(f"value {v!r} outside domain {self.values!r}")


@dataclasses.dataclass(frozen=True)
class VarDecl:
    """One VARIABLE: scalar (index_set None), a one-level function over
    index_set, or a two-level function [index_set -> [index_set2 -> D]]
    (e.g. Raft's per-pair voteGranted matrix)."""

    name: str
    domain: Domain
    index_set: Optional[Tuple[str, ...]] = None  # function domain (strings)
    index_set2: Optional[Tuple[str, ...]] = None  # second level, if any

    @property
    def n_components(self) -> int:
        if self.index_set is None:
            return 1
        n = len(self.index_set)
        if self.index_set2 is not None:
            n *= len(self.index_set2)
        return n


@dataclasses.dataclass(frozen=True)
class Action:
    """One disjunct of Next: guard + updates, with 0..2 bound parameters.

    `params` are the bound variable names (e.g. ("self",) or
    ("self", "voter") for pairwise actions like Raft vote handling) and
    `param_values` the finite sets they range over (parallel tuples); a
    lane exists per binding in their product.  `updates` maps var name ->
    update AST; a var absent from updates is UNCHANGED.  The update AST
    is the full primed RHS (so EXCEPT updates keep their frame
    implicitly).
    """

    name: str
    params: Tuple[str, ...]
    param_values: Tuple[Tuple[str, ...], ...]
    guard: tuple  # texpr AST, boolean
    updates: Dict[str, tuple]  # var -> texpr AST for the new value

    def bindings(self):
        """All parameter-binding dicts (the lane enumeration)."""
        if not self.params:
            return [{}]
        out = [{}]
        for name, values in zip(self.params, self.param_values):
            out = [{**b, name: v} for b in out for v in values]
        return out


@dataclasses.dataclass(frozen=True)
class GenSpec:
    name: str
    variables: Tuple[VarDecl, ...]
    constants: Dict[str, object]  # resolved constant values
    init: Dict[str, tuple]  # var -> texpr AST (evaluated in constant env)
    actions: Tuple[Action, ...]
    invariants: Dict[str, tuple]  # name -> texpr AST (state predicate)
    properties: Dict[str, tuple]  # name -> (P_ast, Q_ast) for P ~> Q

    def var(self, name: str) -> VarDecl:
        for v in self.variables:
            if v.name == name:
                return v
        raise KeyError(name)

    @property
    def n_fields(self) -> int:
        return sum(v.n_components for v in self.variables)
