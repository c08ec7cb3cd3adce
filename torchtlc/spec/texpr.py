"""Trace-expression evaluation (the Toolbox trace-explorer capability).

TLC's trace explorer re-runs a counterexample trace with user-supplied TLA+
expressions evaluated in every state and prints them as extra variables
(the MC_TE.out slot in the reference toolbox,
KubeAPI.toolbox/Model_1/MC_TE.out - the committed instance
is an error-free run, so it carries no expression blocks; the capability is
the per-state re-evaluation itself).  Equivalent here: `torchtlc check
-traceExpressions FILE` parses one expression per line and the CLI appends
an `/\\ name = value` conjunct per expression to every reconstructed trace
state.

Expression language: the TLA+ subset the spec's state values need -
  * variables (apiState, requests, listRequests, pc, stack, op, obj, kind,
    shouldReconcile), primed variants (`pc'` = value in the NEXT trace
    state; in the final state a prime reads the same state, i.e. the
    trailing stuttering step)
  * literals: integers, strings, TRUE/FALSE, {set, ...}, <<tuple, ...>>,
    [field |-> value, ...] records
  * operators: = # < <= > >= + - .. \\in \\notin \\subseteq \\cup \\cap
    \\ (set difference), /\\ \\/ ~ =>, function application f[x], record
    access r.f, Cardinality(S), Len(t)
  * bounded quantifiers \\A / \\E x \\in S : P, function literals
    [x \\in S |-> e], updates [f EXCEPT ![i] = e, ...] with @, integer
    ranges a..b  (the PlusCal-translation subset - the generic spec
    frontend, torchtlc.gen, evaluates action bodies with this module)
Not supported (documented scope): CHOOSE, LET, unbounded quantifiers,
recursive operators - finite-state specs can rewrite these by enumeration.

Values use the oracle's canonical Python model (oracle.State docstring):
sets are frozensets, records/functions are key-sorted tuples of pairs,
sequences are tuples - so equality against trace states is exact.

The port's copy of jaxtlc/spec/texpr.py, which imports no jax: the port imports
nothing of the reference package and keeps its own.
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Tuple

from ..config import ModelConfig
from .labels import DEFAULT_INIT
from .oracle import State

# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>\\\*.*)
  | (?P<land>/\\)
  | (?P<lor>\\/)
  | (?P<forall>\\A\b)
  | (?P<exists>\\E\b)
  | (?P<op>\\(?:in|notin|subseteq|cup|cap)\b)
  | (?P<setminus>\\)
  | (?P<implies>=>)
  | (?P<mapsto>\|->)
  | (?P<range>\.\.)
  | (?P<le><=)
  | (?P<ge>>=)
  | (?P<ltup><<)
  | (?P<rtup>>>)
  | (?P<eq>=)
  | (?P<ne>\#|/=)
  | (?P<lt><)
  | (?P<gt>>)
  | (?P<num>\d+)
  | (?P<str>"[^"]*")
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<sym>[()\[\]{},.~'+\-!@:])
    """,
    re.VERBOSE,
)


def _tokenize(src: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise TexprError(f"cannot tokenize at: {src[pos:pos + 20]!r}")
        kind = m.lastgroup
        if kind not in ("ws", "comment"):
            out.append((kind, m.group()))
        pos = m.end()
    out.append(("eof", ""))
    return out


class TexprError(ValueError):
    pass


# ---------------------------------------------------------------------------
# AST + parser (precedence climbing; => loosest, then \/, then /\)
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind):
        k, v = self.next()
        if k != kind and v != kind:
            raise TexprError(f"expected {kind}, got {v!r}")
        return v

    def parse(self):
        e = self.parse_implies()
        if self.peek()[0] != "eof":
            raise TexprError(f"trailing input at {self.peek()[1]!r}")
        return e

    def parse_implies(self):
        k, _ = self.peek()
        if k in ("forall", "exists"):
            self.next()
            _, var = self.next()
            kk, vv = self.next()
            if (kk, vv) != ("op", r"\in"):
                raise TexprError("expected \\in in quantifier")
            dom = self.parse_setop()
            if self.next() != ("sym", ":"):
                raise TexprError("expected : in quantifier")
            body = self.parse_implies()
            return ("forall" if k == "forall" else "exists", var, dom, body)
        left = self.parse_or()
        if self.peek()[0] == "implies":
            self.next()
            right = self.parse_implies()
            return ("implies", left, right)
        return left

    def parse_or(self):
        left = self.parse_and()
        while self.peek()[0] == "lor":
            self.next()
            left = ("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.peek()[0] == "land":
            self.next()
            left = ("and", left, self.parse_not())
        return left

    def parse_not(self):
        if self.peek() == ("sym", "~"):
            self.next()
            return ("not", self.parse_not())
        return self.parse_cmp()

    _CMP = {"eq": "=", "ne": "#", "lt": "<", "gt": ">", "le": "<=",
            "ge": ">="}

    def parse_cmp(self):
        left = self.parse_setop()
        k, v = self.peek()
        if k in self._CMP:
            self.next()
            return ("cmp", self._CMP[k], left, self.parse_setop())
        if k == "op" and v in (r"\in", r"\notin", r"\subseteq"):
            self.next()
            return ("cmp", v, left, self.parse_setop())
        return left

    def parse_setop(self):
        left = self.parse_range()
        while True:
            k, v = self.peek()
            if k == "op" and v in (r"\cup", r"\cap"):
                self.next()
                left = (v, left, self.parse_range())
            elif k == "setminus":
                self.next()
                left = ("\\", left, self.parse_range())
            else:
                return left

    def parse_range(self):
        # TLA's .. binds looser than +/- (0..N-1 is 0..(N-1))
        left = self.parse_add()
        if self.peek()[0] == "range":
            self.next()
            return ("..", left, self.parse_add())
        return left

    def parse_add(self):
        left = self.parse_postfix()
        while self.peek() in (("sym", "+"), ("sym", "-")):
            _, v = self.next()
            left = (v, left, self.parse_postfix())
        return left

    def parse_postfix(self):
        e = self.parse_atom()
        while True:
            t = self.peek()
            if t == ("sym", "["):
                self.next()
                arg = self.parse_implies()
                self.expect("]")
                e = ("apply", e, arg)
            elif t == ("sym", "."):
                self.next()
                _, fname = self.next()
                e = ("apply", e, ("str", fname))
            elif t == ("sym", "'"):
                self.next()
                if e[0] != "var":
                    raise TexprError("prime (') only applies to variables")
                e = ("var'", e[1])
            else:
                return e

    def parse_atom(self):
        k, v = self.next()
        if k == "num":
            return ("num", int(v))
        if k == "str":
            return ("str", v[1:-1])
        if k == "name":
            if v == "TRUE":
                return ("bool", True)
            if v == "FALSE":
                return ("bool", False)
            if v == "BOOLEAN":
                return ("set", [("bool", False), ("bool", True)])
            if v in ("Cardinality", "Len") and self.peek() == ("sym", "("):
                self.next()
                arg = self.parse_implies()
                self.expect(")")
                return ("call", v, arg)
            return ("var", v)
        if (k, v) == ("sym", "("):
            e = self.parse_implies()
            self.expect(")")
            return e
        if (k, v) == ("sym", "{"):
            items = []
            if self.peek() != ("sym", "}"):
                items.append(self.parse_implies())
                while self.peek() == ("sym", ","):
                    self.next()
                    items.append(self.parse_implies())
            self.expect("}")
            return ("set", items)
        if k == "ltup":
            items = []
            if self.peek()[0] != "rtup":
                items.append(self.parse_implies())
                while self.peek() == ("sym", ","):
                    self.next()
                    items.append(self.parse_implies())
            if self.next()[0] != "rtup":
                raise TexprError("expected >>")
            return ("tuple", items)
        if (k, v) == ("sym", "["):
            # three bracket forms: record [f |-> e, ...], function literal
            # [x \in S |-> e], and update [f EXCEPT ![i] = e, ...]
            save = self.i
            nk, nv = self.next()
            if nk == "name" and self.peek()[0] == "mapsto":
                self.i = save
                return self.parse_record_literal()
            if nk == "name" and self.peek() == ("op", r"\in"):
                self.next()
                dom = self.parse_setop()
                if self.next()[0] != "mapsto":
                    raise TexprError("expected |-> in function literal")
                body = self.parse_implies()
                self.expect("]")
                return ("fnlit", nv, dom, body)
            self.i = save
            fexpr = self.parse_postfix()
            nk, nv = self.next()
            if (nk, nv) != ("name", "EXCEPT"):
                raise TexprError("expected EXCEPT in bracket expression")
            updates = []
            while True:
                if self.next() != ("sym", "!"):
                    raise TexprError("expected ! in EXCEPT")
                idxs = []
                while self.peek() == ("sym", "["):
                    self.next()
                    idxs.append(self.parse_implies())
                    self.expect("]")
                if not idxs:
                    raise TexprError("expected [index] in EXCEPT")
                if self.next()[0] != "eq":
                    raise TexprError("expected = in EXCEPT")
                val = self.parse_implies()
                # multi-index ![i][j] = nested single-index updates
                updates.append((idxs, val))
                nk, nv = self.next()
                if (nk, nv) == ("sym", "]"):
                    break
                if (nk, nv) != ("sym", ","):
                    raise TexprError("expected , or ] in EXCEPT")
            return ("except", fexpr, updates)
        if (k, v) == ("sym", "@"):
            return ("atref",)
        raise TexprError(f"unexpected token {v!r}")

    def parse_record_literal(self):
        fields = []
        while True:
            _, fname = self.next()
            if self.next()[0] != "mapsto":
                raise TexprError("expected |-> in record literal")
            fields.append((fname, self.parse_implies()))
            nk, nv = self.next()
            if (nk, nv) == ("sym", "]"):
                break
            if (nk, nv) != ("sym", ","):
                raise TexprError("expected , or ] in record literal")
        return ("record", fields)


def parse(src: str):
    return _Parser(_tokenize(src)).parse()


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def canon(v):
    """Canonicalize to the oracle's value model (pair-records key-sorted)."""
    if isinstance(v, tuple) and v and all(
        isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)
        for x in v
    ):
        return tuple(sorted((k, canon(x)) for k, x in v))
    if isinstance(v, tuple):
        return tuple(canon(x) for x in v)
    if isinstance(v, frozenset):
        return frozenset(canon(x) for x in v)
    return v


def state_env(st: State, cfg: ModelConfig) -> dict:
    """Variable environment of a decoded oracle state (TLA names)."""
    procs = cfg.processes
    reconcilers = [cfg.clients[i] for i in cfg.reconciler_indices]

    def fn(values):
        return tuple(sorted(zip(procs, (canon(x) for x in values))))

    return {
        "apiState": canon(st.api_state),
        "requests": canon(st.requests),
        "listRequests": canon(st.list_requests),
        "pc": fn(st.pc),
        "stack": fn(tuple(tuple(fr for fr in s) for s in st.stack)),
        "op": fn(st.op),
        "obj": fn(st.obj),
        "kind": fn(st.kind),
        "shouldReconcile": tuple(
            sorted(zip(reconcilers, st.should_reconcile))
        ),
        "defaultInitValue": DEFAULT_INIT,
    }


def _apply(f, arg):
    if isinstance(f, tuple):
        # string keys distinguish records/functions from sequences of
        # pairs (same convention as canon; a 2-field record inside a
        # sequence must NOT make the sequence look like a function)
        if f and all(
            isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)
            for x in f
        ):
            for k, val in f:
                if k == arg:
                    return val
            raise TexprError(f"{arg!r} not in function domain")
        if isinstance(arg, int) and 1 <= arg <= len(f):
            return f[arg - 1]  # sequences are 1-indexed
        raise TexprError(f"index {arg!r} out of sequence range")
    raise TexprError(f"cannot apply non-function {f!r}")


def evaluate(ast, env: dict, env_next: Optional[dict] = None):
    """Evaluate over a state env (and the next state's, for primes)."""
    op = ast[0]
    if op in ("num", "str", "bool"):
        return ast[1]
    if op == "var":
        if ast[1] not in env:
            raise TexprError(f"unknown variable {ast[1]!r}")
        return env[ast[1]]
    if op == "var'":
        e2 = env_next if env_next is not None else env
        if ast[1] not in e2:
            raise TexprError(f"unknown variable {ast[1]!r}")
        return e2[ast[1]]
    if op == "set":
        return frozenset(evaluate(x, env, env_next) for x in ast[1])
    if op == "tuple":
        return tuple(evaluate(x, env, env_next) for x in ast[1])
    if op == "record":
        return canon(
            tuple((k, evaluate(x, env, env_next)) for k, x in ast[1])
        )
    if op == "apply":
        return _apply(
            evaluate(ast[1], env, env_next), evaluate(ast[2], env, env_next)
        )
    if op == "call":
        v = evaluate(ast[2], env, env_next)
        if ast[1] == "Cardinality":
            if not isinstance(v, frozenset):
                raise TexprError("Cardinality expects a set")
            return len(v)
        if not isinstance(v, tuple):
            raise TexprError("Len expects a sequence")
        return len(v)
    if op == "not":
        return not _as_bool(evaluate(ast[1], env, env_next))
    if op == "and":
        return _as_bool(evaluate(ast[1], env, env_next)) and _as_bool(
            evaluate(ast[2], env, env_next)
        )
    if op == "or":
        return _as_bool(evaluate(ast[1], env, env_next)) or _as_bool(
            evaluate(ast[2], env, env_next)
        )
    if op == "implies":
        return (not _as_bool(evaluate(ast[1], env, env_next))) or _as_bool(
            evaluate(ast[2], env, env_next)
        )
    if op in ("+", "-"):
        a = evaluate(ast[1], env, env_next)
        b = evaluate(ast[2], env, env_next)
        return a + b if op == "+" else a - b
    if op in (r"\cup", r"\cap", "\\"):
        a = evaluate(ast[1], env, env_next)
        b = evaluate(ast[2], env, env_next)
        if not (isinstance(a, frozenset) and isinstance(b, frozenset)):
            raise TexprError(f"{op} expects sets")
        return {r"\cup": a | b, r"\cap": a & b, "\\": a - b}[op]
    if op in ("forall", "exists"):
        _, var, dom_ast, body = ast
        dom = evaluate(dom_ast, env, env_next)
        if not isinstance(dom, frozenset):
            raise TexprError("quantifier domain must be a set")
        vals = []
        for x in sorted(dom, key=repr):
            e2 = dict(env)
            e2[var] = x
            en2 = dict(env_next, **{var: x}) if env_next is not None else None
            vals.append(_as_bool(evaluate(body, e2, en2)))
        return all(vals) if op == "forall" else any(vals)
    if op == "..":
        a = evaluate(ast[1], env, env_next)
        b = evaluate(ast[2], env, env_next)
        if not (isinstance(a, int) and isinstance(b, int)):
            raise TexprError(".. expects integers")
        return frozenset(range(a, b + 1))
    if op == "fnlit":
        _, var, dom_ast, body = ast
        dom = evaluate(dom_ast, env, env_next)
        if not isinstance(dom, frozenset):
            raise TexprError("function domain must be a set")
        pairs = []
        for x in sorted(dom, key=repr):
            e2 = dict(env)
            e2[var] = x
            en2 = dict(env_next, **{var: x}) if env_next is not None else None
            pairs.append((x, evaluate(body, e2, en2)))
        if all(isinstance(x, str) for x, _ in pairs):
            return tuple(sorted(pairs))
        if set(x for x, _ in pairs) == set(range(1, len(pairs) + 1)):
            return tuple(v for _, v in sorted(pairs))  # 1..n -> sequence
        raise TexprError("function domain must be strings or 1..n")
    if op == "except":
        f = evaluate(ast[1], env, env_next)
        for idxs_ast, val_ast in ast[2]:
            idxs = [evaluate(i, env, env_next) for i in idxs_ast]
            f = _except_update(f, idxs, val_ast, env, env_next)
        return f
    if op == "atref":
        if "@" not in env:
            raise TexprError("@ outside EXCEPT")
        return env["@"]
    if op == "cmp":
        sym = ast[1]
        a = evaluate(ast[2], env, env_next)
        b = evaluate(ast[3], env, env_next)
        if sym == "=":
            return a == b
        if sym == "#":
            return a != b
        if sym == r"\in":
            return a in b
        if sym == r"\notin":
            return a not in b
        if sym == r"\subseteq":
            return a <= b
        return {"<": a < b, ">": a > b, "<=": a <= b, ">=": a >= b}[sym]
    raise TexprError(f"unhandled AST node {op!r}")


def _except_update(f, idxs, val_ast, env, env_next):
    """[f EXCEPT ![i1][i2]... = val]: nested single-level updates; @ in
    val reads the innermost old value."""
    idx = idxs[0]
    old = _apply(f, idx)
    if len(idxs) > 1:
        val = _except_update(old, idxs[1:], val_ast, env, env_next)
    else:
        e2 = dict(env)
        e2["@"] = old
        en2 = (dict(env_next, **{"@": old})
               if env_next is not None else None)
        val = evaluate(val_ast, e2, en2)
    if isinstance(f, tuple) and f and all(
        isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)
        for x in f
    ):
        return tuple(sorted(((k, val if k == idx else v) for k, v in f)))
    if isinstance(f, tuple) and isinstance(idx, int):
        return f[: idx - 1] + (val,) + f[idx:]
    raise TexprError("EXCEPT on a non-function")


def _as_bool(v):
    if not isinstance(v, bool):
        raise TexprError(f"expected BOOLEAN, got {v!r}")
    return v


# ---------------------------------------------------------------------------
# Expression files + trace evaluation
# ---------------------------------------------------------------------------


class TraceExpression(NamedTuple):
    name: str  # display name (Toolbox uses the expression text itself)
    ast: tuple


def parse_expressions(text: str) -> List[TraceExpression]:
    """One expression per line; `Name == Expr` names it, `\\* ...` comments
    and blank lines are skipped (the Toolbox trace-expression pane model)."""
    out = []
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("\\*"):
            continue
        m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*)\s*==\s*(.+)$", ln)
        name, src = (m.group(1), m.group(2)) if m else (ln, ln)
        out.append(TraceExpression(name, parse(src)))
    return out


class ExprResult(NamedTuple):
    name: str
    value: object  # evaluated value, or the error message when failed
    failed: bool


def eval_over_envs(
    exprs: List[TraceExpression],
    envs: List[dict],
) -> List[List[ExprResult]]:
    """Per trace state env: [ExprResult(name, value, failed), ...].

    Primed variables in state i read state i+1; the final state reads
    itself (the trailing stuttering step, TLC's convention for the last
    state of a finite trace).  Evaluation failures (including Python-level
    type errors from mis-typed expressions, e.g. `pc["Client"] < 3`)
    degrade to a failed ExprResult carrying the message - one bad
    expression never loses the trace.  Spec-agnostic: the KubeAPI path
    builds envs with state_env, the generic frontend with
    gen.oracle.state_env."""
    rows = []
    for i, env in enumerate(envs):
        env_next = envs[i + 1] if i + 1 < len(envs) else env
        row = []
        for ex in exprs:
            try:
                row.append(
                    ExprResult(ex.name, evaluate(ex.ast, env, env_next), False)
                )
            except (TexprError, TypeError, KeyError, IndexError) as e:
                row.append(ExprResult(ex.name, str(e) or type(e).__name__,
                                      True))
        rows.append(row)
    return rows


def eval_over_trace(
    exprs: List[TraceExpression],
    trace: List[Tuple[State, Optional[str]]],
    cfg: ModelConfig,
) -> List[List[ExprResult]]:
    """eval_over_envs over a KubeAPI-oracle trace."""
    return eval_over_envs(exprs, [state_env(st, cfg) for st, _ in trace])
