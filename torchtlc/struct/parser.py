"""Full-module TLA+ parser for the structural frontend (E1).

Parses real TLA+ modules - the reference's own committed translation
included (KubeAPI.tla:373-768) - into expression ASTs:

* junction lists by column alignment (the PlusCal translator's bullet
  style; TLA+'s /\\ and \\/ list grammar),
* IF/THEN/ELSE, CASE [] arms, LET..IN, CHOOSE,
* EXCEPT with multi-update paths (![c].status = ...),
* set literals / filters {x \\in S : P} / maps {e : x \\in S},
* sequences <<...>>, \\o, Head/Tail/Append/Len,
* records [f |-> e], singleton functions k :> v, left-biased merge @@,
* DOMAIN, function sets [S -> T], function literals [x \\in S |-> e],
* quantifiers with multiple binders (\\A o1, o2 \\in S : P),
* temporal property shapes: P ~> Q and []P ~> Q (MC.out's checked
  property forms), WF_vars(Next)-style Spec conjunctions.

The parse obligations mirror what SANY reports for the reference model
(MC.out:8-24).  Original hand-rolled design - no code from TLC/SANY
(which are Java) is or could be reused.

AST nodes are plain tuples (texpr-compatible where the form overlaps):
  ("num", n) ("str", s) ("bool", b) ("name", x) ("prime", x)
  ("and", [..]) ("or", [..]) ("not", e) ("implies", a, b)
  ("box", e) ("leadsto", a, b)
  ("cmp", op, a, b)            op in = # < > <= >= \\in \\notin \\subseteq
  ("binop", op, a, b)          op in \\cup \\cap \\ + - .. \\o @@ :>
  ("apply", f, arg)            f[arg] and r.field (field as ("str", f))
  ("call", name, [args])       operator application Foo(a, b)
  ("setlit", [..]) ("setfilter", var, dom, pred) ("setmap", e, var, dom)
  ("tuple", [..]) ("record", [(f, e), ..])
  ("fnlit", var, dom, body) ("funcset", dom, rng)
  ("except", f, [([path..], val), ..])   path elements are value ASTs
  ("if", c, t, e) ("case", [(g, e), ..], other|None)
  ("let", [(name, params, body), ..], e)
  ("choose", var, dom, pred)
  ("forall", [vars], dom, body) ("exists", [vars], dom, body)
  ("unchanged", [names]) ("domain", e) ("atref",)

The port's copy of jaxtlc/struct/parser.py, which imports no jax: the port imports
nothing of the reference package and keeps its own.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Tuple


class StructParseError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Comment stripping (position-preserving) and module header handling
# ---------------------------------------------------------------------------


def strip_comments(src: str) -> str:
    """Blank out (* .. *) blocks (nested), \\* line comments, module
    header/separator lines - preserving every character position."""
    out = list(src)
    i, n = 0, len(src)
    depth = 0
    in_str = False
    while i < n:
        c = src[i]
        if depth == 0 and not in_str and c == '"':
            in_str = True
            i += 1
            continue
        if in_str:
            if c == '"':
                in_str = False
            i += 1
            continue
        if src.startswith("(*", i):
            depth += 1
            out[i] = out[i + 1] = " "
            i += 2
            continue
        if depth > 0:
            if src.startswith("*)", i):
                depth -= 1
                out[i] = out[i + 1] = " "
                i += 2
                continue
            if c != "\n":
                out[i] = " "
            i += 1
            continue
        if src.startswith("\\*", i):
            j = src.find("\n", i)
            j = n if j < 0 else j
            for k in range(i, j):
                out[k] = " "
            i = j
            continue
        i += 1
    text = "".join(out)
    # blank module header / separator / terminator lines
    lines = text.split("\n")
    for li, ln in enumerate(lines):
        if re.match(r"^\s*----+\s*MODULE\s+\w+\s*----+\s*$", ln):
            lines[li] = " " * len(ln)
        elif re.match(r"^\s*(----+|====+)\s*$", ln):
            lines[li] = " " * len(ln)
    return "\n".join(lines)


def module_name(src: str) -> Optional[str]:
    m = re.search(r"^\s*----+\s*MODULE\s+(\w+)\s*----+\s*$", src, re.M)
    return m.group(1) if m else None


# ---------------------------------------------------------------------------
# Tokenizer (line/column aware)
# ---------------------------------------------------------------------------


class Tok(NamedTuple):
    kind: str
    val: str
    line: int
    col: int


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r\f]+)
  | (?P<land>/\\)
  | (?P<lor>\\/)
  | (?P<forall>\\A\b)
  | (?P<exists>\\E\b)
  | (?P<op>\\(?:in|notin|subseteq|cup|cap|o)\b)
  | (?P<setminus>\\)
  | (?P<leadsto>~>)
  | (?P<implies>=>)
  | (?P<mapsto>\|->)
  | (?P<arrow>->)
  | (?P<defeq>==)
  | (?P<range>\.\.)
  | (?P<le><=)
  | (?P<ge>>=)
  | (?P<ltup><<)
  | (?P<rtup>>>)
  | (?P<box>\[\])
  | (?P<colongt>:>)
  | (?P<atat>@@)
  | (?P<eq>=)
  | (?P<ne>\#|/=)
  | (?P<lt><)
  | (?P<gt>>)
  | (?P<num>\d+)
  | (?P<str>"[^"]*")
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<sym>[()\[\]{},.~'+\-!@:*])
    """,
    re.VERBOSE,
)


def tokenize(text: str) -> List[Tok]:
    toks: List[Tok] = []
    for line_no, line in enumerate(text.split("\n"), start=1):
        pos = 0
        while pos < len(line):
            m = _TOKEN_RE.match(line, pos)
            if not m:
                raise StructParseError(
                    f"line {line_no}: cannot tokenize {line[pos:pos+20]!r}"
                )
            if m.lastgroup != "ws":
                toks.append(Tok(m.lastgroup, m.group(), line_no, pos))
            pos = m.end()
    return toks


# ---------------------------------------------------------------------------
# Module structure
# ---------------------------------------------------------------------------


class Definition(NamedTuple):
    name: str
    params: Tuple[str, ...]
    body: tuple  # AST


class Module(NamedTuple):
    name: str
    extends: Tuple[str, ...]
    constants: Tuple[str, ...]
    variables: Tuple[str, ...]  # declaration order
    defs: Dict[str, Definition]
    def_order: Tuple[str, ...]


_DECL_KEYWORDS = {
    "CONSTANT", "CONSTANTS", "VARIABLE", "VARIABLES", "EXTENDS",
    "ASSUME", "ASSUMPTION", "THEOREM", "LOCAL", "INSTANCE",
}


def parse_module(src: str) -> Module:
    name = module_name(src) or ""
    toks = tokenize(strip_comments(src))
    extends: List[str] = []
    constants: List[str] = []
    variables: List[str] = []
    defs: Dict[str, Definition] = {}
    def_order: List[str] = []

    i, n = 0, len(toks)

    def is_def_start(j: int) -> bool:
        """name at column 0 followed by `==` or `(p, ..) ==`."""
        if toks[j].kind != "name" or toks[j].col != 0:
            return False
        if toks[j].val in _DECL_KEYWORDS:
            return False
        k = j + 1
        if k < n and toks[k].kind == "sym" and toks[k].val == "(":
            depth = 0
            while k < n:
                t = toks[k]
                if t.kind == "sym" and t.val == "(":
                    depth += 1
                elif t.kind == "sym" and t.val == ")":
                    depth -= 1
                    if depth == 0:
                        k += 1
                        break
                k += 1
        return k < n and toks[k].kind == "defeq"

    def unit_end(j: int) -> int:
        """First index >= j that starts a new top-level unit."""
        while j < n:
            t = toks[j]
            if t.col == 0 and t.kind == "name" and (
                t.val in _DECL_KEYWORDS or is_def_start(j)
            ):
                return j
            j += 1
        return n

    while i < n:
        t = toks[i]
        if t.kind == "name" and t.val == "EXTENDS" and t.col == 0:
            i += 1
            while i < n and toks[i].kind == "name":
                extends.append(toks[i].val)
                i += 1
                if i < n and toks[i].kind == "sym" and toks[i].val == ",":
                    i += 1
                else:
                    break
        elif t.kind == "name" and t.val in ("CONSTANT", "CONSTANTS") \
                and t.col == 0:
            i += 1
            while i < n and toks[i].kind == "name" \
                    and not (toks[i].col == 0 and (
                        toks[i].val in _DECL_KEYWORDS or is_def_start(i))):
                constants.append(toks[i].val)
                i += 1
                if i < n and toks[i].kind == "sym" and toks[i].val == ",":
                    i += 1
                else:
                    break
        elif t.kind == "name" and t.val in ("VARIABLE", "VARIABLES") \
                and t.col == 0:
            i += 1
            while i < n and toks[i].kind == "name" \
                    and not (toks[i].col == 0 and (
                        toks[i].val in _DECL_KEYWORDS or is_def_start(i))):
                variables.append(toks[i].val)
                i += 1
                if i < n and toks[i].kind == "sym" and toks[i].val == ",":
                    i += 1
                else:
                    break
        elif t.kind == "name" and t.val in ("ASSUME", "ASSUMPTION") \
                and t.col == 0:
            i = unit_end(i + 1)  # assumptions are not checked here
        elif is_def_start(i):
            dname = t.val
            j = i + 1
            params: List[str] = []
            if toks[j].kind == "sym" and toks[j].val == "(":
                j += 1
                while toks[j].kind == "name":
                    params.append(toks[j].val)
                    j += 1
                    if toks[j].kind == "sym" and toks[j].val == ",":
                        j += 1
                if not (toks[j].kind == "sym" and toks[j].val == ")"):
                    raise StructParseError(
                        f"{dname}: malformed parameter list"
                    )
                j += 1
            assert toks[j].kind == "defeq"
            j += 1
            end = unit_end(j)
            body_toks = toks[j:end]
            if dname == "Spec":
                body = _parse_spec_body(body_toks)
            else:
                body = _ExprParser(body_toks).parse_full()
            if dname not in defs:
                def_order.append(dname)
            defs[dname] = Definition(dname, tuple(params), body)
            i = end
        else:
            raise StructParseError(
                f"unexpected top-level token {t.val!r} at line {t.line}"
            )

    return Module(
        name=name,
        extends=tuple(extends),
        constants=tuple(constants),
        variables=tuple(variables),
        defs=defs,
        def_order=tuple(def_order),
    )


def _parse_spec_body(toks: List[Tok]) -> tuple:
    """Spec == /\\ Init /\\ [][Next]_vars /\\ WF_vars(Next): extract the
    temporal normal form structurally (("spec", init, next, fairness));
    fairness is "wf_next" | None."""
    text = " ".join(t.val for t in toks)
    init = next_ = None
    fairness = None
    m = re.search(r"\[\]\s*\[\s*(\w+)\s*\]\s*_", text)
    if m:
        next_ = m.group(1)
    m = re.search(r"WF_\w*\s*\(\s*(\w+)\s*\)", text)
    if m and next_ and m.group(1) == next_:
        fairness = "wf_next"
    for t in toks:
        if t.kind == "name" and t.val not in ("WF_vars", "SF_vars") \
                and t.val != next_:
            init = t.val
            break
    return ("spec", init, next_, fairness)


# ---------------------------------------------------------------------------
# Expression parser (precedence climbing + junction-boundary stack)
# ---------------------------------------------------------------------------

_KEYWORDS_STOP = {"THEN", "ELSE", "IN", "OTHER", "EXCEPT", "LET", "CASE",
                  "IF", "CHOOSE", "UNCHANGED", "DOMAIN", "SUBSET", "UNION"}

_EOF = Tok("eof", "", 1 << 30, -1)


class _ExprParser:
    def __init__(self, toks: List[Tok]):
        self.toks = toks
        self.i = 0
        # junction boundaries: (line, col) of the current bullet; tokens
        # at line > bullet line with col <= bullet col end the item
        self.bounds: List[Tuple[int, int]] = []

    # -- token access ------------------------------------------------------

    def _blocked(self, t: Tok) -> bool:
        if not self.bounds:
            return False
        bl, bc = self.bounds[-1]
        return t.line > bl and t.col <= bc

    def peek(self) -> Tok:
        if self.i >= len(self.toks):
            return _EOF
        t = self.toks[self.i]
        return _EOF if self._blocked(t) else t

    def peek_raw(self) -> Tok:
        return self.toks[self.i] if self.i < len(self.toks) else _EOF

    def next(self) -> Tok:
        t = self.peek()
        if t.kind != "eof":
            self.i += 1
        return t

    def expect(self, kind: str, what: str = "") -> Tok:
        t = self.next()
        if t.kind != kind and t.val != kind:
            raise StructParseError(
                f"expected {what or kind}, got {t.val!r} (line {t.line})"
            )
        return t

    def expect_kw(self, kw: str):
        t = self.next()
        if t.kind != "name" or t.val != kw:
            raise StructParseError(
                f"expected {kw}, got {t.val!r} (line {t.line})"
            )

    # -- entry points ------------------------------------------------------

    def parse_full(self) -> tuple:
        e = self.parse_expr()
        t = self.peek()
        if t.kind != "eof":
            raise StructParseError(
                f"trailing input {t.val!r} at line {t.line}"
            )
        return e

    def parse_expr(self) -> tuple:
        return self.parse_leadsto()

    # -- precedence levels -------------------------------------------------

    def parse_leadsto(self) -> tuple:
        left = self.parse_implies()
        if self.peek().kind == "leadsto":
            self.next()
            return ("leadsto", left, self.parse_leadsto())
        return left

    def parse_implies(self) -> tuple:
        left = self.parse_or()
        if self.peek().kind == "implies":
            self.next()
            return ("implies", left, self.parse_implies())
        return left

    def parse_or(self) -> tuple:
        left = self.parse_and()
        items = [left]
        while self.peek().kind == "lor":
            self.next()
            items.append(self.parse_and())
        return items[0] if len(items) == 1 else ("or", items)

    def parse_and(self) -> tuple:
        left = self.parse_not()
        items = [left]
        while self.peek().kind == "land":
            self.next()
            items.append(self.parse_not())
        return items[0] if len(items) == 1 else ("and", items)

    def parse_not(self) -> tuple:
        t = self.peek()
        if t.kind == "sym" and t.val == "~":
            self.next()
            return ("not", self.parse_not())
        if t.kind == "box":
            self.next()
            return ("box", self.parse_not())
        if t.kind in ("land", "lor"):
            return self.parse_junction(t)
        if t.kind in ("forall", "exists"):
            return self.parse_quantifier(t)
        return self.parse_cmp()

    def parse_junction(self, bullet: Tok) -> tuple:
        kind = bullet.kind
        col = bullet.col
        items: List[tuple] = []
        while True:
            t = self.peek()
            if t.kind != kind or t.col != col:
                break
            self.next()
            self.bounds.append((t.line, col))
            try:
                items.append(self.parse_expr())
            finally:
                self.bounds.pop()
        if not items:
            raise StructParseError(
                f"empty junction list at line {bullet.line}"
            )
        node = "and" if kind == "land" else "or"
        return items[0] if len(items) == 1 else (node, items)

    def parse_quantifier(self, t: Tok) -> tuple:
        self.next()
        names = [self.expect("name").val]
        while self.peek().kind == "sym" and self.peek().val == ",":
            self.next()
            names.append(self.expect("name").val)
        op = self.next()
        if (op.kind, op.val) != ("op", r"\in"):
            raise StructParseError(
                f"expected \\in in quantifier (line {t.line})"
            )
        dom = self.parse_cmp_operand()
        self.expect(":", "':' in quantifier")
        body = self.parse_expr()
        node = "forall" if t.kind == "forall" else "exists"
        return (node, names, dom, body)

    _CMP_KINDS = {"eq": "=", "ne": "#", "lt": "<", "gt": ">", "le": "<=",
                  "ge": ">="}

    def parse_cmp(self) -> tuple:
        left = self.parse_cmp_operand()
        t = self.peek()
        if t.kind in self._CMP_KINDS:
            self.next()
            return ("cmp", self._CMP_KINDS[t.kind], left,
                    self.parse_cmp_operand())
        if t.kind == "op" and t.val in (r"\in", r"\notin", r"\subseteq"):
            self.next()
            return ("cmp", t.val, left, self.parse_cmp_operand())
        return left

    def parse_cmp_operand(self) -> tuple:
        return self.parse_setop()

    def parse_setop(self) -> tuple:
        # @@ (left, loosest here) < \cup/\cap/\ < :> ; then .. + - \o
        left = self.parse_setop2()
        while self.peek().kind == "atat":
            self.next()
            left = ("binop", "@@", left, self.parse_setop2())
        return left

    def parse_setop2(self) -> tuple:
        left = self.parse_colongt()
        while True:
            t = self.peek()
            if t.kind == "op" and t.val in (r"\cup", r"\cap"):
                self.next()
                left = ("binop", t.val, left, self.parse_colongt())
            elif t.kind == "setminus":
                self.next()
                left = ("binop", "\\", left, self.parse_colongt())
            else:
                return left

    def parse_colongt(self) -> tuple:
        left = self.parse_range()
        if self.peek().kind == "colongt":
            self.next()
            return ("binop", ":>", left, self.parse_range())
        return left

    def parse_range(self) -> tuple:
        left = self.parse_add()
        if self.peek().kind == "range":
            self.next()
            return ("binop", "..", left, self.parse_add())
        return left

    def parse_add(self) -> tuple:
        left = self.parse_mul()
        while True:
            t = self.peek()
            if t.kind == "sym" and t.val in ("+", "-"):
                self.next()
                left = ("binop", t.val, left, self.parse_mul())
            else:
                return left

    def parse_mul(self) -> tuple:
        left = self.parse_concat()
        while True:
            t = self.peek()
            if t.kind == "sym" and t.val == "*":
                self.next()
                left = ("binop", "*", left, self.parse_concat())
            else:
                return left

    def parse_concat(self) -> tuple:
        left = self.parse_postfix()
        while self.peek().kind == "op" and self.peek().val == r"\o":
            self.next()
            left = ("binop", r"\o", left, self.parse_postfix())
        return left

    def parse_postfix(self) -> tuple:
        e = self.parse_atom()
        while True:
            t = self.peek()
            if t.kind == "sym" and t.val == "[":
                self.next()
                arg = self.parse_expr()
                args = [arg]
                while self.peek().kind == "sym" and self.peek().val == ",":
                    self.next()
                    args.append(self.parse_expr())
                self.expect("]")
                for a in args:
                    e = ("apply", e, a)
            elif t.kind == "sym" and t.val == ".":
                # field access - but only when followed by a name (guards
                # against tokenizer surprises)
                nxt = self.toks[self.i + 1] if self.i + 1 < len(self.toks) \
                    else _EOF
                if nxt.kind != "name":
                    return e
                self.next()
                f = self.next()
                e = ("apply", e, ("str", f.val))
            elif t.kind == "sym" and t.val == "'":
                self.next()
                if e[0] != "name":
                    raise StructParseError(
                        f"prime on non-variable (line {t.line})"
                    )
                e = ("prime", e[1])
            else:
                return e

    # -- atoms -------------------------------------------------------------

    def parse_atom(self) -> tuple:
        t = self.next()
        if t.kind == "num":
            return ("num", int(t.val))
        if t.kind == "str":
            return ("str", t.val[1:-1])
        if t.kind == "name":
            return self.parse_name_atom(t)
        if t.kind == "sym" and t.val == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if t.kind == "sym" and t.val == "{":
            return self.parse_braces()
        if t.kind == "ltup":
            items = []
            if self.peek().kind != "rtup":
                items.append(self.parse_expr())
                while self.peek().kind == "sym" and self.peek().val == ",":
                    self.next()
                    items.append(self.parse_expr())
            self.expect("rtup", ">>")
            return ("tuple", items)
        if t.kind == "sym" and t.val == "[":
            return self.parse_brackets()
        if t.kind == "sym" and t.val == "@":
            return ("atref",)
        if t.kind == "sym" and t.val == "-":
            inner = self.parse_postfix()
            return ("binop", "-", ("num", 0), inner)
        raise StructParseError(
            f"unexpected token {t.val!r} (line {t.line})"
        )

    def parse_name_atom(self, t: Tok) -> tuple:
        v = t.val
        if v == "TRUE":
            return ("bool", True)
        if v == "FALSE":
            return ("bool", False)
        if v == "IF":
            c = self.parse_expr()
            self.expect_kw("THEN")
            a = self.parse_expr()
            self.expect_kw("ELSE")
            b = self.parse_expr()
            return ("if", c, a, b)
        if v == "CASE":
            arms = []
            other = None
            while True:
                if self.peek().kind == "name" and self.peek().val == "OTHER":
                    self.next()
                    self.expect("arrow", "->")
                    other = self.parse_expr()
                else:
                    g = self.parse_expr()
                    self.expect("arrow", "->")
                    arms.append((g, self.parse_expr()))
                if self.peek().kind == "box":
                    self.next()
                    continue
                break
            return ("case", arms, other)
        if v == "LET":
            binds = []
            while True:
                dname = self.expect("name").val
                params: List[str] = []
                if self.peek().kind == "sym" and self.peek().val == "(":
                    self.next()
                    while self.peek().kind == "name":
                        params.append(self.next().val)
                        if self.peek().kind == "sym" \
                                and self.peek().val == ",":
                            self.next()
                    self.expect(")")
                self.expect("defeq", "==")
                body = self.parse_expr()
                binds.append((dname, tuple(params), body))
                nt = self.peek()
                if nt.kind == "name" and nt.val == "IN":
                    self.next()
                    break
                if nt.kind == "name" and nt.val not in _KEYWORDS_STOP \
                        and self._looks_like_let_def():
                    continue
                self.expect_kw("IN")
            return ("let", binds, self.parse_expr())
        if v == "CHOOSE":
            var = self.expect("name").val
            op = self.next()
            if (op.kind, op.val) != ("op", r"\in"):
                raise StructParseError("expected \\in in CHOOSE")
            dom = self.parse_cmp_operand()
            self.expect(":", "':' in CHOOSE")
            pred = self.parse_expr()
            return ("choose", var, dom, pred)
        if v == "UNCHANGED":
            t2 = self.peek()
            if t2.kind == "ltup":
                self.next()
                names = [self.expect("name").val]
                while self.peek().kind == "sym" and self.peek().val == ",":
                    self.next()
                    names.append(self.expect("name").val)
                self.expect("rtup", ">>")
                return ("unchanged", names)
            return ("unchanged", [self.expect("name").val])
        if v == "DOMAIN":
            return ("domain", self.parse_postfix())
        if self.peek().kind == "sym" and self.peek().val == "(":
            self.next()
            args = [self.parse_expr()]
            while self.peek().kind == "sym" and self.peek().val == ",":
                self.next()
                args.append(self.parse_expr())
            self.expect(")")
            return ("call", v, args)
        return ("name", v)

    def _looks_like_let_def(self) -> bool:
        """After one LET binding, is the next token run another
        `name [(params)] ==` binding?"""
        j = self.i
        toks = self.toks
        if j >= len(toks) or toks[j].kind != "name":
            return False
        j += 1
        if j < len(toks) and toks[j].kind == "sym" and toks[j].val == "(":
            depth = 0
            while j < len(toks):
                if toks[j].val == "(":
                    depth += 1
                elif toks[j].val == ")":
                    depth -= 1
                    if depth == 0:
                        j += 1
                        break
                j += 1
        return j < len(toks) and toks[j].kind == "defeq"

    def parse_braces(self) -> tuple:
        """{ } | {a, b} | {x \\in S : P} | {e : x \\in S}"""
        if self.peek().kind == "sym" and self.peek().val == "}":
            self.next()
            return ("setlit", [])
        save = self.i
        t = self.peek()
        if t.kind == "name":
            self.next()
            t2 = self.peek()
            if t2.kind == "op" and t2.val == r"\in":
                self.next()
                dom = self.parse_cmp_operand()
                t3 = self.peek()
                if t3.kind == "sym" and t3.val == ":":
                    self.next()
                    pred = self.parse_expr()
                    self.expect("}")
                    return ("setfilter", t.val, dom, pred)
            self.i = save
        first = self.parse_expr()
        t2 = self.peek()
        if t2.kind == "sym" and t2.val == ":":
            self.next()
            var = self.expect("name").val
            op = self.next()
            if (op.kind, op.val) != ("op", r"\in"):
                raise StructParseError("expected \\in in set map")
            dom = self.parse_cmp_operand()
            self.expect("}")
            return ("setmap", first, var, dom)
        items = [first]
        while self.peek().kind == "sym" and self.peek().val == ",":
            self.next()
            items.append(self.parse_expr())
        self.expect("}")
        return ("setlit", items)

    def parse_brackets(self) -> tuple:
        """[f |-> e, ..] | [x \\in S |-> e] | [f EXCEPT !..] | [S -> T]"""
        save = self.i
        t = self.peek()
        if t.kind == "name":
            self.next()
            t2 = self.peek()
            if t2.kind == "mapsto":
                self.i = save
                return self.parse_record_literal()
            if t2.kind == "op" and t2.val == r"\in":
                self.next()
                dom = self.parse_expr()
                self.expect("mapsto", "|->")
                body = self.parse_expr()
                self.expect("]")
                return ("fnlit", t.val, dom, body)
            self.i = save
        fexpr = self.parse_expr()
        t2 = self.peek()
        if t2.kind == "name" and t2.val == "EXCEPT":
            self.next()
            updates = []
            while True:
                self.expect("!", "'!' in EXCEPT")
                path = []
                while True:
                    t3 = self.peek()
                    if t3.kind == "sym" and t3.val == "[":
                        self.next()
                        path.append(self.parse_expr())
                        self.expect("]")
                    elif t3.kind == "sym" and t3.val == ".":
                        self.next()
                        path.append(("str", self.expect("name").val))
                    else:
                        break
                if not path:
                    raise StructParseError("empty EXCEPT path")
                self.expect("eq", "=")
                val = self.parse_expr()
                updates.append((path, val))
                t3 = self.next()
                if t3.kind == "sym" and t3.val == "]":
                    break
                if not (t3.kind == "sym" and t3.val == ","):
                    raise StructParseError(
                        f"expected , or ] in EXCEPT (line {t3.line})"
                    )
            return ("except", fexpr, updates)
        if t2.kind == "arrow":
            self.next()
            rng = self.parse_expr()
            self.expect("]")
            return ("funcset", fexpr, rng)
        raise StructParseError(
            f"unsupported bracket expression (line {t.line})"
        )

    def parse_record_literal(self) -> tuple:
        fields = []
        while True:
            f = self.expect("name").val
            self.expect("mapsto", "|->")
            fields.append((f, self.parse_expr()))
            t = self.next()
            if t.kind == "sym" and t.val == "]":
                break
            if not (t.kind == "sym" and t.val == ","):
                raise StructParseError("expected , or ] in record literal")
        return ("record", fields)


def parse_expression(src: str) -> tuple:
    """Parse a standalone expression (tests / trace expressions)."""
    return _ExprParser(tokenize(strip_comments(src))).parse_full()
