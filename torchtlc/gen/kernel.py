"""AST -> lane-IR compiler and lane kernel for generic specs (port of
jaxtlc/gen/kernel.py).

Where the KubeAPI kernel is a hand-written action system, this module
COMPILES one: each (action x process-binding) pair becomes one lane;
guards and primed updates compile from their texpr ASTs to branchless
expressions over one state's ``[F]`` int32 code vector.

The reference's walk is kept line for line; its arrays are lane-IR nodes
(struct.lanes, behind the ``jnp`` facade below) instead of jnp arrays.  A
compiled fn called on a ``[F]`` row node (``lanes.input_node(F)[0]``, the
one row the reference traces under vmap) returns its graph:
struct.lanes.evaluate runs it with torch (the plain version), and
struct.emit prints it as the C++ body of kernels K19 ``gen_expand`` and
K20 ``gen_state_masks`` (gen.program).

Compile-time-static requirements (the PlusCal-translation subset):
function indices must be statically resolvable (the bound process
parameter, literals, or constants), quantifier domains must be constant
sets, and expression values are scalars (ints / enumerants / booleans).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..spec import texpr
from ..struct import lanes
from .codec import GenCodec
from .ir import Action, GenSpec


class _Dtype(str):
    """A lane-IR dtype name that, called, makes a 0-d constant: the
    ``jnp.int32(v)`` / ``jnp.bool_(b)`` of the reference's walk."""

    def __call__(self, v):
        return lanes.const(v, str(self))


class _Facade:
    """The jax.numpy names the walk calls, on the lane IR."""

    int32 = _Dtype(lanes.int32)
    bool_ = _Dtype(lanes.bool_)
    asarray = staticmethod(lanes.asarray)
    where = staticmethod(lanes.where)
    stack = staticmethod(lanes.stack)


jnp = _Facade()


class CompileError(ValueError):
    pass


class _Ctx(NamedTuple):
    codec: GenCodec
    consts: dict  # concrete constant values (for static evaluation)
    binding: dict  # bound vars -> concrete values (param, quantifiers)
    at: Optional[Callable]  # the @ closure inside EXCEPT


def _static_value(ast, ctx: _Ctx):
    """Evaluate a compile-time-static expression to a concrete value."""
    env = dict(ctx.consts)
    env.update(ctx.binding)
    return texpr.evaluate(ast, env)


def _try_static(ast, ctx: _Ctx):
    try:
        return True, _static_value(ast, ctx)
    except (texpr.TexprError, KeyError):
        return False, None


def _kind_of_value(v) -> str:
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, str):
        return "str"
    raise CompileError(f"no kernel kind for {v!r}")


def domain_kind(decl) -> str:
    kinds = {_kind_of_value(v) for v in decl.domain.values}
    if len(kinds) != 1:
        raise CompileError(f"{decl.name}: mixed-type domain {kinds}")
    return kinds.pop()


def compile_expr(ast, ctx: _Ctx):
    """Returns (kind, fn), kind in {"int", "str", "bool"}; fn: fields->jnp.

    Kinds are tracked so `=`/`#` never compare a string's intern id with a
    genuine integer (TLC likewise rejects equality across those types);
    string order comparisons are rejected outright."""
    op = ast[0]
    cdc = ctx.codec
    if op == "num":
        v = jnp.int32(ast[1])
        return "int", lambda f: v
    if op == "str":
        v = jnp.int32(cdc.abstract(ast[1]))
        return "str", lambda f: v
    if op == "bool":
        b = bool(ast[1])
        return "bool", lambda f: jnp.bool_(b)
    if op == "atref":
        if ctx.at is None:
            raise CompileError("@ outside EXCEPT")
        return ctx.at  # (kind, fn) pair stored by _compile_update
    if op == "var":
        name = ast[1]
        if name in ctx.binding:
            v = ctx.binding[name]
            if isinstance(v, bool):
                return "bool", (lambda f, b=jnp.bool_(v): b)
            a = jnp.int32(cdc.abstract(v))
            return _kind_of_value(v), lambda f, a=a: a
        if name in ctx.consts:
            v = ctx.consts[name]
            if isinstance(v, frozenset):
                raise CompileError(f"set constant {name} in value position")
            if isinstance(v, bool):
                return "bool", (lambda f, b=jnp.bool_(v): b)
            a = jnp.int32(cdc.abstract(v))
            return _kind_of_value(v), lambda f, a=a: a
        decl = _find_var(cdc.spec, name)
        if decl is None:
            raise CompileError(f"unknown name {name!r}")
        if decl.index_set is not None:
            raise CompileError(
                f"function variable {name} used without application"
            )
        return _load_component(cdc, decl, cdc.comp_index(name, None))
    if op == "apply":
        # collect an application chain f[i] / f[i][j] down to the variable
        idx_asts = []
        base = ast
        while isinstance(base, tuple) and base[0] == "apply":
            idx_asts.insert(0, base[2])
            base = base[1]
        if base[0] != "var":
            raise CompileError("only variable application is compilable")
        name = base[1]
        decl = _find_var(cdc.spec, name)
        if decl is None or decl.index_set is None:
            raise CompileError(f"{name} is not a function variable")
        want = 2 if decl.index_set2 is not None else 1
        if len(idx_asts) != want:
            raise CompileError(
                f"{name}: expected {want} application level(s), "
                f"got {len(idx_asts)}"
            )
        idxs = []
        for ia in idx_asts:
            ok, idx = _try_static(ia, ctx)
            if not ok:
                raise CompileError(
                    f"{name}[...]: index must be compile-time static"
                )
            idxs.append(idx)
        return _load_component(cdc, decl, cdc.comp_index(name, *idxs))
    if op in ("and", "or", "implies"):
        ka, fa = compile_expr(ast[1], ctx)
        kb, fb = compile_expr(ast[2], ctx)
        if ka != "bool" or kb != "bool":
            raise CompileError(f"{op} expects booleans")
        if op == "and":
            return "bool", lambda f: fa(f) & fb(f)
        if op == "or":
            return "bool", lambda f: fa(f) | fb(f)
        return "bool", lambda f: (~fa(f)) | fb(f)
    if op == "not":
        k, fn = compile_expr(ast[1], ctx)
        if k != "bool":
            raise CompileError("~ expects a boolean")
        return "bool", lambda f: ~fn(f)
    if op in ("+", "-"):
        ka, fa = compile_expr(ast[1], ctx)
        kb, fb = compile_expr(ast[2], ctx)
        if ka != "int" or kb != "int":
            raise CompileError(f"{op} expects integers")
        if op == "+":
            return "int", lambda f: fa(f) + fb(f)
        return "int", lambda f: fa(f) - fb(f)
    if op == "cmp":
        sym = ast[1]
        if sym in (r"\in", r"\notin"):
            ok, dom = _try_static(ast[3], ctx)
            if not ok or not isinstance(dom, frozenset):
                raise CompileError(f"{sym}: rhs must be a static finite set")
            ka, fa = compile_expr(ast[2], ctx)
            ekinds = {_kind_of_value(v) for v in dom}
            if dom and ekinds != {ka}:
                raise CompileError(
                    f"{sym}: element kinds {ekinds} vs value kind {ka}"
                )
            if ka == "bool":
                fa0 = fa
                fa = lambda f: fa0(f).astype(jnp.int32)
            codes = [jnp.int32(cdc.abstract(v)) for v in sorted(
                dom, key=repr)]
            def member(f, fa=fa, codes=codes):
                x = fa(f)
                hit = jnp.bool_(False)
                for c in codes:
                    hit = hit | (x == c)
                return hit
            if sym == r"\in":
                return "bool", member
            return "bool", lambda f: ~member(f)
        ka, fa = compile_expr(ast[2], ctx)
        kb, fb = compile_expr(ast[3], ctx)
        if sym in ("=", "#"):
            if ka != kb:
                raise CompileError(
                    f"{sym}: cannot compare {ka} with {kb} (TLC rejects "
                    "cross-type equality too)"
                )
            if sym == "=":
                return "bool", lambda f: fa(f) == fb(f)
            return "bool", lambda f: fa(f) != fb(f)
        if ka != "int" or kb != "int":
            raise CompileError(f"{sym} expects integers")
        fns = {"<": lambda f: fa(f) < fb(f), ">": lambda f: fa(f) > fb(f),
               "<=": lambda f: fa(f) <= fb(f), ">=": lambda f: fa(f) >= fb(f)}
        return "bool", fns[sym]
    if op in ("forall", "exists"):
        _, var, dom_ast, body = ast
        ok, dom = _try_static(dom_ast, ctx)
        if not ok or not isinstance(dom, frozenset):
            raise CompileError("quantifier domain must be a static set")
        fns = []
        for v in sorted(dom, key=repr):
            b2 = dict(ctx.binding)
            b2[var] = v
            k, fn = compile_expr(body, ctx._replace(binding=b2))
            if k != "bool":
                raise CompileError("quantifier body must be boolean")
            fns.append(fn)
        if not fns:
            const = op == "forall"
            return "bool", lambda f, c=jnp.bool_(const): c
        if op == "forall":
            def allfn(f, fns=fns):
                r = fns[0](f)
                for fn in fns[1:]:
                    r = r & fn(f)
                return r
            return "bool", allfn
        def anyfn(f, fns=fns):
            r = fns[0](f)
            for fn in fns[1:]:
                r = r | fn(f)
            return r
        return "bool", anyfn
    raise CompileError(f"expression {op!r} is not kernel-compilable")


def _find_var(spec: GenSpec, name: str):
    for v in spec.variables:
        if v.name == name:
            return v
    return None


def _load_component(cdc: GenCodec, decl, comp: int):
    """(kind, fn) loading one component's abstract value."""
    table = jnp.asarray(cdc.value_tables[decl.name])
    kind = domain_kind(decl)
    if kind == "bool":
        return "bool", (
            lambda f, c=comp, t=table: t[f[c]].astype(jnp.bool_)
        )
    return kind, lambda f, c=comp, t=table: t[f[c]]


class GenKernel(NamedTuple):
    n_lanes: int
    lane_labels: Tuple[str, ...]
    lane_action: Tuple[int, ...]  # lane -> action index in spec.actions
    step: Callable  # [F] int32 -> (succs [L,F], valid [L], ovf [L])
    invariants: Tuple[Tuple[str, Callable], ...]  # name, fields -> bool


def make_gen_kernel(spec: GenSpec, codec: GenCodec) -> GenKernel:
    from .oracle import binding_label

    consts = dict(spec.constants)
    lanes = []  # (label, action_idx, guard_fn, [per-comp code fn or None])
    for ai, act in enumerate(spec.actions):
        for binding in act.bindings():
            ctx = _Ctx(codec, consts, binding, None)
            k, guard_fn = compile_expr(act.guard, ctx)
            if k != "bool":
                raise CompileError(f"{act.name}: guard is not boolean")
            comp_fns: List[Optional[Tuple[Callable, Callable]]] = (
                [None] * codec.n_fields
            )
            for var, upd_ast in act.updates.items():
                for entry in _compile_update(var, upd_ast, ctx):
                    comp, code_fn, ok_fn = entry
                    comp_fns[comp] = (code_fn, ok_fn)
            lanes.append(
                (binding_label(act, binding), ai, guard_fn, comp_fns)
            )

    L = len(lanes)
    F = codec.n_fields

    def step(f):
        succ_rows, valids, ovfs = [], [], []
        for label, ai, guard_fn, comp_fns in lanes:
            g = guard_fn(f)
            vals, bad = [], jnp.bool_(False)
            for j in range(F):
                if comp_fns[j] is None:
                    vals.append(f[j])
                else:
                    code_fn, ok_fn = comp_fns[j]
                    vals.append(code_fn(f))
                    bad = bad | ~ok_fn(f)
            succ_rows.append(jnp.stack(vals))
            valids.append(g & ~bad)
            ovfs.append(g & bad)
        return (
            jnp.stack(succ_rows),
            jnp.stack(valids),
            jnp.stack(ovfs),
        )

    invs = []
    for name, ast in spec.invariants.items():
        k, fn = compile_expr(ast, _Ctx(codec, consts, {}, None))
        if k != "bool":
            raise CompileError(f"invariant {name} is not boolean")
        invs.append((name, fn))

    return GenKernel(
        n_lanes=L,
        lane_labels=tuple(lbl for lbl, *_ in lanes),
        lane_action=tuple(ai for _, ai, *_ in lanes),
        step=step,
        invariants=tuple(invs),
    )


def _coder(decl, codec: GenCodec):
    """(kind, abstract-value closure) -> (code closure, in-domain closure);
    rejects kind/domain mismatches at compile time."""
    table = jnp.asarray(codec.value_tables[decl.name])  # code -> abstract
    d = len(decl.domain.values)
    dkind = domain_kind(decl)

    def make(kind, val_fn):
        if kind != dkind:
            raise CompileError(
                f"{decl.name}': assigned a {kind} value to a {dkind} domain"
            )
        if kind == "bool":
            inner = val_fn
            val_fn = lambda f: inner(f).astype(jnp.int32)

        def code_fn(f):
            x = val_fn(f)
            code = jnp.int32(0)
            for i in range(d):
                code = jnp.where(x == table[i], jnp.int32(i), code)
            return code

        def ok_fn(f):
            x = val_fn(f)
            hit = jnp.bool_(False)
            for i in range(d):
                hit = hit | (x == table[i])
            return hit

        return code_fn, ok_fn

    return make


def _static_idx(ia, ctx: _Ctx, var: str):
    ok, idx = _try_static(ia, ctx)
    if not ok:
        raise CompileError(
            f"{var}' EXCEPT index must be compile-time static"
        )
    return idx


def _compile_fnlit_body(var, decl, make, ctx, bound, body, row=None):
    """Components for [x \\in S |-> body] over one function level (row
    pins the first index for two-level variables)."""
    cdc = ctx.codec
    out = []
    if row is None and decl.index_set2 is not None:
        raise CompileError(
            f"{var}': two-level variable needs a nested function literal"
        )
    index = decl.index_set if row is None else decl.index_set2
    for idx in index:
        b2 = dict(ctx.binding)
        b2[bound] = idx
        inner = ctx._replace(binding=b2)
        comp = (cdc.comp_index(var, idx) if row is None
                else cdc.comp_index(var, row, idx))
        k, val_fn = compile_expr(body, inner)
        code_fn, ok_fn = make(k, val_fn)
        out.append((comp, code_fn, ok_fn))
    return out


def _compile_update(var: str, upd_ast, ctx: _Ctx):
    """Yields (component, code_fn, ok_fn) triples for one `var' = rhs`."""
    cdc = ctx.codec
    decl = _find_var(cdc.spec, var)
    if decl is None:
        raise CompileError(f"update of unknown variable {var}")
    make = _coder(decl, cdc)
    out = []
    if decl.index_set is None:
        k, val_fn = compile_expr(upd_ast, ctx)
        code_fn, ok_fn = make(k, val_fn)
        out.append((cdc.comp_index(var, None), code_fn, ok_fn))
        return out
    two_level = decl.index_set2 is not None
    # function variable: EXCEPT, fnlit, or whole-copy of another function
    if upd_ast[0] == "except" and upd_ast[1][0] == "var":
        src = upd_ast[1][1]
        sdecl = _find_var(cdc.spec, src)
        if src != var:
            out.extend(_copy_fn(var, src, ctx))
        for idxs_ast, val_ast in upd_ast[2]:
            idxs = [_static_idx(ia, ctx, var) for ia in idxs_ast]
            if len(idxs) == 1 and two_level:
                # row update: ![i] = [j \in T |-> e]
                if val_ast[0] != "fnlit":
                    raise CompileError(
                        f"{var}' EXCEPT ![i] on a two-level variable "
                        "needs a function-literal row"
                    )
                _, bound, dom_ast, body = val_ast
                ok, dom = _try_static(dom_ast, ctx)
                if not ok or set(dom) != set(decl.index_set2):
                    raise CompileError(f"{var}' row domain mismatch")
                row_entries = _compile_fnlit_body(
                    var, decl, make, ctx, bound, body, row=idxs[0]
                )
                touched = {e[0] for e in row_entries}
                out = [e for e in out if e[0] not in touched]
                out.extend(row_entries)
                continue
            if len(idxs) != (2 if two_level else 1):
                raise CompileError(
                    f"{var}' EXCEPT: wrong number of indices"
                )
            comp = cdc.comp_index(var, *idxs)
            at = _load_component(cdc, sdecl, cdc.comp_index(src, *idxs))
            k, val_fn = compile_expr(val_ast, ctx._replace(at=at))
            code_fn, ok_fn = make(k, val_fn)
            out = [e for e in out if e[0] != comp]
            out.append((comp, code_fn, ok_fn))
        return out
    if upd_ast[0] == "fnlit":
        _, bound, dom_ast, body = upd_ast
        ok, dom = _try_static(dom_ast, ctx)
        if not ok or not isinstance(dom, frozenset):
            raise CompileError(f"{var}' function domain must be static")
        if set(dom) != set(decl.index_set):
            raise CompileError(f"{var}' domain mismatch with TypeOK")
        if not two_level:
            return _compile_fnlit_body(var, decl, make, ctx, bound, body)
        # [i \in S |-> [j \in T |-> e]]
        if body[0] != "fnlit":
            raise CompileError(
                f"{var}': two-level variable needs a nested function "
                "literal"
            )
        _, bound2, dom2_ast, body2 = body
        for i in decl.index_set:
            b2 = dict(ctx.binding)
            b2[bound] = i
            inner = ctx._replace(binding=b2)
            ok, dom2 = _try_static(dom2_ast, inner)
            if not ok or set(dom2) != set(decl.index_set2):
                raise CompileError(f"{var}' inner domain mismatch")
            out.extend(_compile_fnlit_body(
                var, decl, make, inner, bound2, body2, row=i
            ))
        return out
    if upd_ast[0] == "var":
        return _copy_fn(var, upd_ast[1], ctx)
    raise CompileError(f"unsupported update shape for {var}'")


def _copy_fn(dst: str, src: str, ctx: _Ctx):
    cdc = ctx.codec
    ddecl = _find_var(cdc.spec, dst)
    sdecl = _find_var(cdc.spec, src)
    if (sdecl is None or sdecl.index_set != ddecl.index_set
            or sdecl.index_set2 != ddecl.index_set2):
        raise CompileError(f"{dst}' = {src}: index sets differ")
    make = _coder(ddecl, cdc)
    out = []
    if ddecl.index_set2 is None:
        pairs = [(idx, None) for idx in ddecl.index_set]
    else:
        pairs = [(i, j) for i in ddecl.index_set
                 for j in ddecl.index_set2]
    for i, j in pairs:
        if j is None:
            scomp, dcomp = cdc.comp_index(src, i), cdc.comp_index(dst, i)
        else:
            scomp = cdc.comp_index(src, i, j)
            dcomp = cdc.comp_index(dst, i, j)
        k, val_fn = _load_component(cdc, sdecl, scomp)
        code_fn, ok_fn = make(k, val_fn)
        out.append((dcomp, code_fn, ok_fn))
    return out


def initial_field_vectors(spec: GenSpec, codec: GenCodec) -> np.ndarray:
    """[n_init, F] encoded initial states (generic Init is deterministic
    today: one state; kept 2-D for engine symmetry)."""
    from . import oracle as go

    return np.stack([codec.encode(go.initial_state(spec))])
