"""TLA+ module parser for the PlusCal-translation subset (E1 generality).

The reference toolchain runs SANY over the full TLA+ grammar
(KubeAPI.toolbox/Model_1/MC.out:8-24) and TLC interprets
the semantic graph.  This parser covers the structured subset every
PlusCal translation (and idiomatic hand-written action system) lands in:

* top-level definitions ``Name == body`` / ``Name(param) == body``;
* ``VARIABLES``, ``CONSTANTS``, ``EXTENDS`` headers;
* ``TypeOK`` as a conjunction of ``var \\in D`` / ``var \\in [S -> D]``
  conjuncts - the finite-domain declarations the codec sizes from;
* ``Init`` as a conjunction of ``var = expr``;
* actions as conjunctions of guards, primed assignments ``var' = rhs``
  and ``UNCHANGED << ... >>`` frames;
* grouping disjunctions ``a(self) == A(self) \\/ B(self)`` and
  ``Next == A \\/ (\\E self \\in S : a(self)) \\/ ...``;
* invariant definitions (any cfg-listed INVARIANT) as texpr predicates;
* properties ``[\\A x \\in S :] P ~> Q`` (leads-to, expanded per binding).

Expression bodies parse with torchtlc.spec.texpr (the same evaluator that
powers trace expressions), so the value model is shared end-to-end.

The port's copy of jaxtlc/gen/tla_parse.py, which imports no jax: the port imports
nothing of the reference package and keeps its own.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..spec import texpr
from ..spec.texpr import TexprError
from .ir import Action, Domain, GenSpec, VarDecl

_DEF_RE = re.compile(
    r"^(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*(?:\((?P<params>[^)]*)\))?\s*==",
    re.M,
)


class SpecParseError(ValueError):
    pass


def _strip_comments(text: str) -> str:
    text = re.sub(r"\(\*.*?\*\)", "", text, flags=re.S)
    return re.sub(r"\\\*[^\n]*", "", text)


def split_definitions(text: str) -> Dict[str, Tuple[Optional[tuple], str]]:
    """{name: (params or None, RAW body)} for every top-level definition.

    Bodies keep their line structure: TLA bullet lists (`/\\` items at a
    common column) are line-delimited, and collapsing them early loses
    the boundary between `... \\/ ...` INSIDE one item and the next item
    (the round-4 Raft quantifier bug)."""
    out: Dict[str, Tuple[Optional[tuple], str]] = {}
    matches = list(_DEF_RE.finditer(text))
    for i, m in enumerate(matches):
        end = matches[i + 1].start() if i + 1 < len(matches) else len(text)
        # pad the header with spaces so a bullet on the definition line
        # keeps its true file column (bullet lists align by column)
        line_start = text.rfind("\n", 0, m.start()) + 1
        body = " " * (m.end() - line_start) + text[m.end():end]
        body = body.split("====")[0].rstrip()
        params = m.group("params")
        if params is not None:
            names = [p.strip() for p in params.split(",") if p.strip()]
            if len(names) > 2:
                raise SpecParseError(
                    f"{m.group('name')}: at most two action parameters "
                    "are supported"
                )
            params = tuple(names) or None
        out[m.group("name")] = (params, body)
    return out


def _line_depth_delta(ln: str) -> int:
    """Bracket-nesting delta of one line ((), [], {}, << >>)."""
    d, i, n = 0, 0, len(ln)
    while i < n:
        two = ln[i:i + 2]
        if two in ("<<", ">>"):
            d += 1 if two == "<<" else -1
            i += 2
            continue
        c = ln[i]
        if c in "([{":
            d += 1
        elif c in ")]}":
            d -= 1
        i += 1
    return d


def split_bullets(raw: str, op: str):
    """Split a RAW (multi-line) body on its outermost bullet list of `op`
    (`/\\` or `\\/`): items start at lines whose first token is `op` at
    the minimal such column AND at bracket depth 0 (a continuation line
    inside an open bracket is never an item boundary); remaining lines
    attach to their item.  Returns collapsed item strings, or None if the
    body has no leading bullet list of that operator."""
    lines = raw.splitlines()
    starts = []
    depth = 0
    for i, ln in enumerate(lines):
        s = ln.lstrip()
        if depth == 0 and s.startswith(op):
            starts.append((i, len(ln) - len(s)))
        depth += _line_depth_delta(ln)
    if not starts:
        return None
    mincol = min(c for _, c in starts)
    idxs = [i for i, c in starts if c == mincol]
    # a bullet LIST: nothing but whitespace before the first item
    if any(lines[i].strip() for i in range(idxs[0])):
        return None
    items = []
    for k, i in enumerate(idxs):
        end = idxs[k + 1] if k + 1 < len(idxs) else len(lines)
        chunk = [lines[i].lstrip()[len(op):]] + lines[i + 1:end]
        items.append(" ".join(" ".join(chunk).split()))
    return items


def _flat(body: str) -> str:
    """Whitespace-collapsed single-line view of a raw body."""
    return " ".join(body.split())


def split_conjuncts(raw: str) -> List[str]:
    """Top-level conjuncts of a definition body, bullet-list-aware.
    Bullet items are re-split flat so one-line `/\\ a /\\ b` bodies keep
    their conjunct boundaries (split_top is quantifier-aware, so an
    item's trailing quantifier body is never cut)."""
    items = split_bullets(raw, "/\\")
    if items is None:
        items = [_flat(raw)]
    return [p for it in items for p in split_top(it, "/\\")]


def split_disjuncts(raw: str) -> List[str]:
    items = split_bullets(raw, "\\/")
    if items is None:
        items = [_flat(raw)]
    return [p for it in items for p in split_top(it, "\\/")]


def split_top(body: str, op: str) -> List[str]:
    """Split on a top-level binary operator (`/\\` or `\\/`), respecting
    (), [], {}, << >> nesting.  A leading operator (TLA bullet-list style)
    is allowed.  A top-level quantifier ends the splitting: its body is
    maximal, so every later operator on the line belongs to it."""
    parts, depth, i, cur = [], 0, 0, []
    n = len(body)
    while i < n:
        c = body[i]
        two = body[i:i + 2]
        if depth == 0 and two in ("\\A", "\\E") and (
            i + 2 >= n or not (body[i + 2].isalnum() or body[i + 2] == "_")
        ):
            cur.append(body[i:])
            break
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        elif two == "<<":
            depth += 1
            cur.append(two)
            i += 2
            continue
        elif two == ">>":
            depth -= 1
            cur.append(two)
            i += 2
            continue
        if depth == 0 and two == op:
            parts.append("".join(cur))
            cur = []
            i += 2
            continue
        cur.append(c)
        i += 1
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def _const_value(text: str):
    """Interpret an MC.cfg constant value: int, boolean, model value, or
    a {set, of, model, values} (model values become strings)."""
    t = text.strip()
    if re.fullmatch(r"-?\d+", t):
        return int(t)
    if t == "TRUE":
        return True
    if t == "FALSE":
        return False
    if t.startswith("{") and t.endswith("}"):
        inner = t[1:-1].strip()
        if not inner:
            return frozenset()
        return frozenset(x.strip() for x in inner.split(","))
    return t  # single model value


_UNCHANGED_RE = re.compile(
    r"^UNCHANGED\s+(?:<<\s*(?P<list>[^>]*)\s*>>|(?P<name>[A-Za-z_]\w*))$"
)
_ASSIGN_RE = re.compile(r"^(?P<var>[A-Za-z_]\w*)'\s*=\s*(?P<rhs>.+)$", re.S)
_EXISTS_RE = re.compile(
    r"^\(\s*\\E\s+(?P<var>\w+)\s+\\in\s+(?P<dom>[^:]+):\s*"
    r"(?P<body>.+)\)$",
    re.S,
)
# nested two-parameter form: (\E i \in S : (\E j \in T : act(i, j)))
_EXISTS2_RE = re.compile(
    r"^\(\s*\\E\s+(?P<v1>\w+)\s+\\in\s+(?P<d1>[^:]+):\s*"
    r"\(\s*\\E\s+(?P<v2>\w+)\s+\\in\s+(?P<d2>[^:]+):\s*"
    r"(?P<call>[A-Za-z_]\w*)\s*\(\s*(?P=v1)\s*,\s*(?P=v2)\s*\)\s*\)\s*\)$"
)
_CALL_RE = re.compile(
    r"^(?P<name>[A-Za-z_]\w*)\s*"
    r"(?:\(\s*(?P<arg>\w+)\s*(?:,\s*(?P<arg2>\w+)\s*)?\))?$"
)


def _balanced(s: str) -> bool:
    depth = 0
    for c in s:
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
            if depth < 0:
                return False
    return depth == 0


def _strip_outer(p: str) -> str:
    """Strip surrounding parens only when they wrap the WHOLE string."""
    p = p.strip()
    while p.startswith("(") and p.endswith(")") and _balanced(p[1:-1]):
        p = p[1:-1].strip()
    return p


def subst(ast: tuple, bindings: Dict[str, object]) -> tuple:
    """Substitute literal values for free variable references in an AST."""
    if not isinstance(ast, tuple):
        return ast
    if ast[0] == "var" and ast[1] in bindings:
        v = bindings[ast[1]]
        if isinstance(v, bool):
            return ("bool", v)
        if isinstance(v, int):
            return ("num", v)
        if isinstance(v, str):
            return ("str", v)
        raise SpecParseError(f"cannot substitute {v!r}")
    return tuple(
        subst(x, bindings) if isinstance(x, tuple)
        else ([subst(e, bindings) for e in x] if isinstance(x, list) else x)
        for x in ast
    )


class ModuleParser:
    """Parses one module + resolved constants into a GenSpec."""

    def __init__(self, text: str, constants: Dict[str, object],
                 invariant_names: List[str], property_names: List[str]):
        text = _strip_comments(text)
        m = re.search(r"-{4,}\s*MODULE\s+(\w+)\s*-{4,}", text)
        if not m:
            raise SpecParseError("no MODULE header")
        self.module_name = m.group(1)
        body = text[m.end():]
        self.defs = split_definitions(body)
        self.constants = dict(constants)
        vm = re.search(r"^VARIABLES?\s+([^\n]+)", body, re.M)
        if not vm:
            raise SpecParseError("no VARIABLES declaration")
        self.var_names = [v.strip() for v in vm.group(1).split(",")]
        self.invariant_names = invariant_names
        self.property_names = property_names
        self.const_env = dict(self.constants)

    # -- expression helper ------------------------------------------------

    def expr(self, src: str, extra: Dict[str, object] = None) -> tuple:
        # multi-line bullet lists split line-aware (each item keeps its
        # own internal \/ and quantifier bodies intact)
        if "\n" in src:
            for op, node in (("/\\", "and"), ("\\/", "or")):
                items = split_bullets(src, op)
                if items is not None and len(items) >= 1:
                    ast = self.expr(items[0], extra)
                    for p in items[1:]:
                        ast = (node, ast, self.expr(p, extra))
                    return ast
        src = _flat(src)
        # a leading quantifier owns the whole rest of the expression
        # (maximal body) - no top-level operator splitting inside it
        if not (src.startswith("\\A") or src.startswith("\\E")):
            # \/ splits FIRST: it binds looser than /\, so `a \/ b /\ c`
            # must become or(a, and(b, c)), not and(or(a, b), c)
            for op, node in (("\\/", "or"), ("/\\", "and")):
                parts = split_top(src, op)
                if len(parts) > 1:
                    ast = self.expr(parts[0], extra)
                    for p in parts[1:]:
                        ast = (node, ast, self.expr(p, extra))
                    return ast
        ast = texpr.parse(src)
        env = dict(self.const_env)
        if extra:
            env.update(extra)
        return subst(ast, {k: v for k, v in env.items()
                           if isinstance(v, (int, str, bool))})

    def eval_const(self, src: str):
        """Evaluate a constant-only expression (domains etc.)."""
        ast = texpr.parse(src)
        return texpr.evaluate(ast, dict(self.const_env))

    # -- TypeOK -> domains ------------------------------------------------

    def parse_domains(self) -> Dict[str, VarDecl]:
        if "TypeOK" not in self.defs:
            raise SpecParseError(
                "TypeOK definition required (finite domains are sized "
                "from its `var \\in D` conjuncts)"
            )
        _, body = self.defs["TypeOK"]
        decls: Dict[str, VarDecl] = {}
        for conj in split_conjuncts(body):
            m = re.match(r"^(\w+)\s+\\in\s+(.+)$", conj, re.S)
            if not m:
                raise SpecParseError(f"unsupported TypeOK conjunct: {conj}")
            var, dom_src = m.group(1), m.group(2).strip()
            if var not in self.var_names:
                raise SpecParseError(f"TypeOK names unknown variable {var}")
            fm = re.match(r"^\[(.+?)\s*->\s*(.+)\]$", dom_src, re.S)
            index_set = index_set2 = None
            if fm:
                idx = self.eval_const(fm.group(1))
                if not isinstance(idx, frozenset):
                    raise SpecParseError(f"{var}: function index not a set")
                index_set = tuple(sorted(idx))
                inner = fm.group(2).strip()
                fm2 = re.match(r"^\[(.+?)\s*->\s*(.+)\]$", inner, re.S)
                if fm2:
                    # two-level function [S -> [T -> D]]
                    idx2 = self.eval_const(fm2.group(1))
                    if not isinstance(idx2, frozenset):
                        raise SpecParseError(
                            f"{var}: inner function index not a set"
                        )
                    index_set2 = tuple(sorted(idx2))
                    dom = self.eval_const(fm2.group(2))
                else:
                    dom = self.eval_const(inner)
            else:
                dom = self.eval_const(dom_src)
            if isinstance(dom, frozenset):
                vals = tuple(sorted(dom, key=lambda x: (str(type(x)), x)))
            else:
                raise SpecParseError(f"{var}: domain is not a finite set")
            decls[var] = VarDecl(var, Domain(vals), index_set, index_set2)
        missing = [v for v in self.var_names if v not in decls]
        if missing:
            raise SpecParseError(f"TypeOK missing domains for {missing}")
        return decls

    # -- Init -------------------------------------------------------------

    def parse_init(self) -> Dict[str, tuple]:
        if "Init" not in self.defs:
            raise SpecParseError("no Init definition")
        _, body = self.defs["Init"]
        out: Dict[str, tuple] = {}
        for conj in split_conjuncts(body):
            m = re.match(r"^(\w+)\s*=\s*(.+)$", conj, re.S)
            if not m or m.group(1) not in self.var_names:
                raise SpecParseError(f"unsupported Init conjunct: {conj}")
            out[m.group(1)] = self.expr(m.group(2))
        missing = [v for v in self.var_names if v not in out]
        if missing:
            raise SpecParseError(f"Init missing assignments for {missing}")
        return out

    # -- actions ----------------------------------------------------------

    def parse_action_body(self, name: str, params: Optional[Tuple[str, ...]],
                          body: str) -> Action:
        guards: List[tuple] = []
        updates: Dict[str, tuple] = {}
        explicit_unchanged: List[str] = []
        for conj in split_conjuncts(body):
            um = _UNCHANGED_RE.match(conj)
            if um:
                if um.group("name"):
                    ref = um.group("name")
                    if ref == "vars" or ref in self.defs:
                        # UNCHANGED vars (stutter action): nothing updates
                        explicit_unchanged.extend(self.var_names)
                        continue
                    raise SpecParseError(f"UNCHANGED {ref}: unknown tuple")
                explicit_unchanged.extend(
                    v.strip() for v in um.group("list").split(",") if v.strip()
                )
                continue
            am = _ASSIGN_RE.match(conj)
            if am and am.group("var") in self.var_names:
                updates[am.group("var")] = self.expr(am.group("rhs"))
                continue
            guards.append(self.expr(conj))
        # every variable must be accounted for (assigned or unchanged)
        unacc = [v for v in self.var_names
                 if v not in updates and v not in explicit_unchanged]
        if unacc:
            raise SpecParseError(
                f"action {name}: variables neither assigned nor "
                f"UNCHANGED: {unacc}"
            )
        guard = guards[0] if guards else ("bool", True)
        for g in guards[1:]:
            guard = ("and", guard, g)
        return Action(name, params or (), (), guard, updates)

    def parse_next(self) -> List[Action]:
        if "Next" not in self.defs:
            raise SpecParseError("no Next definition")
        _, body = self.defs["Next"]
        actions: List[Action] = []
        for disj in split_disjuncts(body):
            actions.extend(self._expand_disjunct(disj, (), ()))
        return actions

    def _exists_domain(self, src: str) -> Tuple[str, ...]:
        dom = self.eval_const(src.strip())
        if not isinstance(dom, frozenset):
            raise SpecParseError("\\E domain is not a finite set")
        return tuple(sorted(dom))

    def _expand_disjunct(self, disj: str, params: Tuple[str, ...],
                         param_values: Tuple[Tuple[str, ...], ...]
                         ) -> List[Action]:
        disj = disj.strip()
        if disj.startswith("\\E"):
            # accept the unparenthesized form too: the translation
            # emits parens, hand-written specs often do not
            disj = f"({disj})"
        em2 = _EXISTS2_RE.match(disj)
        if em2:
            return self._expand_call(
                em2.group("call"),
                (em2.group("v1"), em2.group("v2")),
                (self._exists_domain(em2.group("d1")),
                 self._exists_domain(em2.group("d2"))),
            )
        em = _EXISTS_RE.match(disj)
        if em:
            # body: a call, or a (dis)junction group of calls over the
            # bound variable - e.g. (\E e \in E : (Fail(e) \/ Recover(e)))
            var = em.group("var")
            values = (self._exists_domain(em.group("dom")),)
            body = _strip_outer(em.group("body"))
            out = []
            for part in split_top(body, "\\/"):
                part = _strip_outer(part)
                cm = _CALL_RE.match(part)
                if not cm or cm.group("name") not in self.defs:
                    raise SpecParseError(
                        f"unsupported \\E body disjunct: {part}"
                    )
                args = tuple(a for a in (cm.group("arg"), cm.group("arg2"))
                             if a)
                if args != (var,):
                    raise SpecParseError(
                        f"{cm.group('name')}{args}: \\E binds only "
                        f"{var!r}"
                    )
                out.extend(
                    self._expand_call(cm.group("name"), (var,), values)
                )
            return out
        if disj.startswith("(") and disj.endswith(")"):
            # parenthesized group: recurse on the inner disjunction
            inner = disj[1:-1].strip()
            out = []
            for p in split_disjuncts(inner):
                out.extend(self._expand_disjunct(p, params, param_values))
            return out
        cm = _CALL_RE.match(disj)
        if cm:
            name = cm.group("name")
            if name not in self.defs:
                raise SpecParseError(f"Next references unknown {name}")
            args = tuple(a for a in (cm.group("arg"), cm.group("arg2")) if a)
            if any(a not in params for a in args):
                raise SpecParseError(f"{name}{args}: unbound parameter")
            return self._expand_call(name, params, param_values)
        raise SpecParseError(f"unsupported Next disjunct: {disj}")

    def _expand_call(self, name: str, params: Tuple[str, ...],
                     param_values: Tuple[Tuple[str, ...], ...]
                     ) -> List[Action]:
        dparams, body = self.defs[name]
        dparams = dparams or ()
        # a definition that is itself a disjunction of calls (action group)
        parts = [_strip_outer(p) for p in split_disjuncts(body)]
        if len(parts) > 1 and all(_CALL_RE.match(p) for p in parts):
            out = []
            for p in parts:
                callee = _CALL_RE.match(p).group("name")
                if callee not in self.defs:
                    raise SpecParseError(f"{name} references unknown {callee}")
                out.extend(self._expand_call(callee, params, param_values))
            return out
        if len(dparams) > len(param_values):
            raise SpecParseError(
                f"{name}({', '.join(dparams)}): unbound parameter"
            )
        act = self.parse_action_body(name, dparams, body)
        return [Action(act.name, dparams, param_values[: len(dparams)],
                       act.guard, act.updates)]

    # -- invariants + properties -----------------------------------------

    def parse_invariants(self) -> Dict[str, tuple]:
        out = {}
        for name in self.invariant_names:
            if name not in self.defs:
                raise SpecParseError(f"INVARIANT {name} not defined")
            p, body = self.defs[name]
            if p:
                raise SpecParseError(f"invariant {name} cannot take params")
            if name == "TypeOK":
                # synthesized from the parsed domain declarations (texpr
                # has no [S -> D] function-space syntax; the semantic
                # content is identical)
                out[name] = self._typeok_ast()
            else:
                out[name] = self.expr(body)
        return out

    def _typeok_ast(self) -> tuple:
        def lit(v):
            if isinstance(v, bool):
                return ("bool", v)
            if isinstance(v, int):
                return ("num", v)
            return ("str", v)

        conjs = []
        for decl in self._decls.values():
            domset = ("set", [lit(v) for v in decl.domain.values])
            if decl.index_set is None:
                conjs.append(("cmp", r"\in", ("var", decl.name), domset))
            elif decl.index_set2 is None:
                idxset = ("set", [lit(i) for i in decl.index_set])
                conjs.append(
                    ("forall", "__i", idxset,
                     ("cmp", r"\in",
                      ("apply", ("var", decl.name), ("var", "__i")),
                      domset))
                )
            else:
                idxset = ("set", [lit(i) for i in decl.index_set])
                idxset2 = ("set", [lit(i) for i in decl.index_set2])
                conjs.append(
                    ("forall", "__i", idxset,
                     ("forall", "__j", idxset2,
                      ("cmp", r"\in",
                       ("apply",
                        ("apply", ("var", decl.name), ("var", "__i")),
                        ("var", "__j")),
                       domset)))
                )
        ast = conjs[0]
        for c in conjs[1:]:
            ast = ("and", ast, c)
        return ast

    def parse_properties(self) -> Dict[str, tuple]:
        """Each property: [\\A x \\in S :] P ~> Q, expanded per binding."""
        out = {}
        for name in self.property_names:
            if name not in self.defs:
                raise SpecParseError(f"PROPERTY {name} not defined")
            _, body = self.defs[name]
            body = _flat(body)
            qm = re.match(
                r"^\\A\s+(\w+)\s+\\in\s+([^:]+):\s*(.+)$", body, re.S
            )
            bindings: List[Dict[str, object]] = [{}]
            rest = body
            if qm:
                dom = self.eval_const(qm.group(2).strip())
                bindings = [{qm.group(1): v} for v in sorted(dom)]
                rest = qm.group(3).strip()
            halves = rest.split("~>")
            if len(halves) != 2:
                raise SpecParseError(
                    f"PROPERTY {name}: only P ~> Q shapes are supported"
                )
            p_src = _strip_outer(halves[0])
            q_src = _strip_outer(halves[1])
            for b in bindings:
                key = name if not b else (
                    name + "[" + ",".join(str(v) for v in b.values()) + "]"
                )
                out[key] = (
                    subst(self.expr(p_src), b),
                    subst(self.expr(q_src), b),
                )
        return out

    def parse(self) -> GenSpec:
        decls = self.parse_domains()
        self._decls = decls
        init = self.parse_init()
        actions = self.parse_next()
        return GenSpec(
            name=self.module_name,
            variables=tuple(decls[v] for v in self.var_names),
            constants=dict(self.constants),
            init=init,
            actions=tuple(actions),
            invariants=self.parse_invariants(),
            properties=self.parse_properties(),
        )


def load_genspec(tla_path: str, cfg_constants: Dict[str, object],
                 invariants: List[str], properties: List[str]) -> GenSpec:
    """Parse a .tla module with MC.cfg-style constant values: strings
    are interpreted as cfg literals; anything else (a resolve-level
    const override, say) is already evaluated and passes through."""
    consts = {k: _const_value(v) if isinstance(v, str) else v
              for k, v in cfg_constants.items()}
    with open(tla_path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        return ModuleParser(text, consts, invariants, properties).parse()
    except TexprError as e:
        # expression-level failures surface as subset errors too, so the
        # caller's diagnostic names the module and the supported subset
        raise SpecParseError(f"expression not in subset: {e}")
