"""Print lane IR (struct.lanes) as ``__host__ __device__`` C++.

The emitted text is the per-spec body of kernels K17 ``struct_expand``
and K18 ``struct_inv_rows``: one function for the step, one per
invariant, the spec's constants as macros, and the constant tables as one
int32 array ``K`` the caller uploads once (device memory on the card, a
host array for the g++ build).  torchtlc/kernels/csrc/struct_expand.cuh is
the hand-written kernel template around it; struct.build compiles the
pair with nvcc for the card and with g++ for the host tests.

Every node is fully unrolled into per-element scalar statements (the
graphs are small: a few thousand elements per row for the shipped specs),
so nothing lands in local memory: data-movement nodes (reshape,
broadcast, stack, index, slice, take) cost no code at all, they only
rename elements.  Constants of up to ``INLINE_CONST`` elements are
literals; larger ones, and every gather table, live in ``K``.  The
semantics are struct.lanes.evaluate's: wrapping int32 arithmetic (through
uint32), floor division and modulo, first-index argmax/argmin, gathers
that wrap a negative index once and clamp.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..kernels.build import meter
from . import lanes
from .lanes import Node, bool_, row_size

INLINE_CONST = 64

_BIN = {
    "add": "tt_add({}, {})", "sub": "tt_sub({}, {})",
    "mul": "tt_mul({}, {})", "floordiv": "tt_floordiv({}, {})",
    "mod": "tt_mod({}, {})", "shr": "({} >> {})", "shl": "tt_shl({}, {})",
    "max": "tt_max({}, {})", "min": "tt_min({}, {})",
    "eq": "({} == {})", "ne": "({} != {})", "lt": "({} < {})",
    "le": "({} <= {})", "gt": "({} > {})", "ge": "({} >= {})",
    "and": "({} & {})", "or": "({} | {})", "xor": "({} ^ {})",
}


class EmitError(ValueError):
    pass


def _lit(v, dtype) -> str:
    if dtype == bool_:
        return "true" if v else "false"
    v = int(v)
    if v == -(1 << 31):
        return "(-2147483647 - 1)"
    return f"({v})" if v < 0 else str(v)


def _bmap(src_shape, out_shape) -> np.ndarray:
    """For each element of out_shape, the flat index of the element of
    src_shape that numpy broadcasting reads."""
    nd = len(out_shape)
    src = (1,) * (nd - len(src_shape)) + tuple(src_shape)
    idx = np.arange(row_size(src_shape), dtype=np.int64).reshape(src)
    return np.broadcast_to(idx, tuple(out_shape)).ravel()


class Program:
    """The constant table ``K`` shared by every function of one spec,
    and the emitted functions."""

    def __init__(self):
        meter("builds")  # one emitted text (serve.pool.CompileMeter)
        self._chunks: List[np.ndarray] = []
        self._offsets: Dict[int, int] = {}
        self._keep: List[Node] = []
        self.size = 0
        self.functions: List[str] = []

    def table(self, n: Node) -> int:
        """Offset of constant n's values in K (added at first use)."""
        off = self._offsets.get(id(n))
        if off is None:
            off = self.size
            vals = np.asarray(n.value).astype(np.int32).ravel()
            self._chunks.append(vals)
            self._offsets[id(n)] = off
            self._keep.append(n)
            self.size += vals.size
        return off

    def words(self, vals) -> int:
        """Offset in K of an int32 table that is no lane-IR constant (a
        symmetry program's remap table); equal tables share one copy."""
        vals = np.asarray(vals, np.int32).ravel()
        key = ("words", vals.tobytes())
        off = self._offsets.get(key)
        if off is None:
            off = self._offsets[key] = self.size
            self._chunks.append(vals)
            self.size += vals.size
        return off

    def constants(self) -> np.ndarray:
        """K: every table, int32 (bools as 0/1); one element at least."""
        if not self._chunks:
            return np.zeros(1, np.int32)
        return np.concatenate(self._chunks).astype(np.int32)

    # -- functions --------------------------------------------------------

    def function(self, head: str, outputs: Sequence[Node], tail) -> None:
        """Emit ``head { <graph of outputs> <tail(exprs)> }``; tail gets
        each output's per-element C expressions and returns the lines
        that store them."""
        body = _Body(self)
        exprs = body.run(outputs)
        lines = [head + " {"] + ["  " + s for s in body.lines]
        lines += ["  " + s for s in tail(exprs)]
        lines.append("}")
        self.functions.append("\n".join(lines))


class _Body:
    def __init__(self, prog: Program):
        self.prog = prog
        self.lines: List[str] = []
        self.n = 0

    def var(self, dtype, expr: str) -> str:
        name = f"v{self.n}"
        self.n += 1
        ctype = "bool" if dtype == bool_ else "int32_t"
        self.lines.append(f"const {ctype} {name} = {expr};")
        return name

    def run(self, outputs: Sequence[Node]) -> List[List[str]]:
        E: Dict[int, List[str]] = {}
        for n in lanes.topo(outputs):
            E[id(n)] = self.node(n, E)
        return [E[id(n)] for n in outputs]

    def node(self, n: Node, E) -> List[str]:
        op, size = n.op, row_size(n.shape)
        if op == "input":
            return [f"f[{j}]" for j in range(n.attr[0])]
        if op == "const":
            vals = np.asarray(n.value).ravel()
            if vals.size <= INLINE_CONST:
                return [_lit(v, n.dtype) for v in vals]
            off = self.prog.table(n)
            cast = "(K[{}] != 0)" if n.dtype == bool_ else "K[{}]"
            return [cast.format(off + i) for i in range(vals.size)]
        a = [E[id(x)] for x in n.args]
        if op in _BIN:
            ma = _bmap(n.args[0].shape, n.shape)
            mb = _bmap(n.args[1].shape, n.shape)
            return [self.var(n.dtype, _BIN[op].format(a[0][ma[i]],
                                                      a[1][mb[i]]))
                    for i in range(size)]
        if op == "not":
            return [self.var(n.dtype, f"!{x}") for x in a[0]]
        if op == "bnot":
            return [self.var(n.dtype, f"~{x}") for x in a[0]]
        if op == "cast":
            fmt = "({} != 0)" if n.dtype == bool_ else "(int32_t){}"
            return [self.var(n.dtype, fmt.format(x)) for x in a[0]]
        if op == "where":
            ms = [_bmap(x.shape, n.shape) for x in n.args]
            return [self.var(n.dtype, "({} ? {} : {})".format(
                *(a[k][ms[k][i]] for k in range(3)))) for i in range(size)]
        if op == "gather":
            tab, idx = n.args
            off = self.prog.table(tab)
            fmt = ("(K[{} + tt_clampidx({}, {})] != 0)" if n.dtype == bool_
                   else "K[{} + tt_clampidx({}, {})]")
            return [self.var(n.dtype, fmt.format(off, x, tab.value.size))
                    for x in a[1]]
        if op in ("sum", "any", "all", "argmax", "argmin", "cumsum"):
            return self.reduce(n, a[0])
        if op == "remask":
            t = np.asarray(n.args[1].value)
            U, V = t.size, n.attr[0]
            rows = size // V if V else 0
            out = []
            for r in range(rows):
                for v in range(V):
                    terms = [a[0][r * U + u] for u in range(U) if t[u] == v]
                    out.append(self.var(n.dtype, _sum(terms)))
            return out
        # data movement: each output element names one input element
        src = n.args[0]
        if op == "reshape":
            return list(a[0])
        if op == "broadcast":
            m = _bmap(src.shape, n.shape)
            return [a[0][i] for i in m]
        if op == "stack":
            ax = n.attr[0]
            common = n.shape[:ax] + n.shape[ax + 1:]
            cols = [[a[k][i] for i in _bmap(x.shape, common)]
                    for k, x in enumerate(n.args)]
            grid = np.stack([np.arange(row_size(common)).reshape(common)
                             + k * row_size(common)
                             for k in range(len(cols))], axis=ax).ravel()
            flat = [e for col in cols for e in col]
            return [flat[i] for i in grid]
        idx = np.arange(row_size(src.shape)).reshape(src.shape)
        if op == "index":
            ax, i = n.attr
            sel = np.take(idx, i, axis=ax)
        elif op == "slice":
            ax, s0, e0 = n.attr
            sel = np.take(idx, np.arange(s0, e0), axis=ax)
        elif op == "take":
            ax, ids = n.attr
            sel = np.take(idx, np.asarray(ids, np.int64), axis=ax)
        else:
            raise EmitError(f"no C++ for lane op {op}")
        return [a[0][i] for i in np.asarray(sel).ravel()]

    def reduce(self, n: Node, x: List[str]) -> List[str]:
        src = n.args[0]
        ax = n.attr[0]
        idx = np.moveaxis(np.arange(row_size(src.shape)).reshape(src.shape),
                          ax, -1)
        k = src.shape[ax]
        groups = idx.reshape(-1, k) if k else np.zeros((row_size(n.shape), 0),
                                                        np.int64)
        op = n.op
        if op == "cumsum":
            out = np.empty(idx.shape, object)
            flat_out = out.reshape(-1, k)
            for g, grp in enumerate(groups):
                acc = None
                for j, e in enumerate(grp):
                    acc = self.var(n.dtype, f"(int32_t){x[e]}" if acc is None
                                   else f"tt_add({acc}, {x[e]})")
                    flat_out[g, j] = acc
            return list(np.moveaxis(out, -1, ax).ravel())
        out = []
        for grp in groups:
            terms = [x[e] for e in grp]
            if op == "sum":
                out.append(self.var(n.dtype, _sum(terms)))
            elif op == "any":
                out.append(self.var(n.dtype, " | ".join(terms) or "false"))
            elif op == "all":
                out.append(self.var(n.dtype, " & ".join(terms) or "true"))
            else:
                if not terms:
                    out.append("0")
                    continue
                best = self.var_mut("int32_t", terms[0])
                arg = self.var_mut("int32_t", "0")
                cmp = ">" if op == "argmax" else "<"
                for j in range(1, len(terms)):
                    self.lines.append(
                        f"if ({terms[j]} {cmp} {best}) {{ {best} = "
                        f"{terms[j]}; {arg} = {j}; }}")
                out.append(self.var(n.dtype, arg))
        return out

    def var_mut(self, ctype: str, expr: str) -> str:
        name = f"v{self.n}"
        self.n += 1
        self.lines.append(f"{ctype} {name} = {expr};")
        return name


def _sum(terms: List[str]) -> str:
    if not terms:
        return "0"
    return "(int32_t)(" + " + ".join(f"(uint32_t){t}" for t in terms) + ")"


# ---------------------------------------------------------------------------
# the symmetry group's field programs (kernel K24)
# ---------------------------------------------------------------------------


def _sym_program(prog: Program, p, n_fields: int,
                 mask_bits: int) -> List[str]:
    """The statements of one field program (engine.reduce._PermProgram,
    applied as engine.reduce._apply_program applies it): c = f gathered
    through src, then each remap table in order - a guarded one reads its
    guard columns as they stand at that point -, then each mask's bit
    permutation.  Tables live in K, read at the code clipped to the
    table."""
    src = p.src
    out = [f"c[{j}] = f[{j if src is None else int(src[j])}];"
           for j in range(n_fields)]
    for field, tbl, guards in p.tables:
        look = f"K[{prog.words(tbl)} + tt_clip(c[{field}], {len(tbl) - 1})]"
        if guards:
            cond = " && ".join(
                f"(c[{g[1]}] > {int(g[2])})" if g[0] == "len"
                else f"(c[{g[1]}] != 0)" for g in guards)
            out.append(f"c[{field}] = ({cond}) ? {look} : c[{field}];")
        else:
            out.append(f"c[{field}] = {look};")
    for off, widths, sigma in p.masks:
        out.append("{")
        out += [f"  int32_t m{fi} = 0;" for fi in range(len(widths))]
        for i, d in enumerate(sigma):
            out.append(
                f"  m{d // mask_bits} |= ((c[{off + i // mask_bits}] >> "
                f"{i % mask_bits}) & 1) << {d % mask_bits};")
        out += [f"  c[{off + fi}] = m{fi};" for fi in range(len(widths))]
        out.append("}")
    return out


def sym_function(prog: Program, programs, n_fields: int) -> str:
    """``st_sym_prog(p, f, K, c)``: field program p of the group applied
    to the row f, into c (kernel K24's permutations, struct_reduce.cuh)."""
    from .codec import MASK_BITS_PER_FIELD

    lines = ["HD void st_sym_prog(int p, const int32_t* __restrict__ f, "
             "const int32_t* __restrict__ K, int32_t* __restrict__ c) {",
             "  switch (p) {"]
    for k, p in enumerate(programs):
        lines.append(f"  case {k}: {{")
        lines += ["    " + x for x in _sym_program(prog, p, n_fields,
                                                   MASK_BITS_PER_FIELD)]
        lines.append("  } break;")
    lines += ["  default: break;", "  }", "}"]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the spec's translation unit
# ---------------------------------------------------------------------------


def _step_function(prog: Program, step_outputs, n_fields: int) -> int:
    """Emit ``st_step`` from build_step's (succs [1, L, F], valid, ovf,
    afail [1, L]) on ``lanes.input_node(F)``; returns L."""
    succs, valid, ovf, afail = step_outputs
    L = succs.shape[1]
    if succs.shape != (1, L, n_fields) or any(x.shape != (1, L)
                                              for x in (valid, ovf, afail)):
        raise EmitError(f"step shapes {[x.shape for x in step_outputs]}")

    def store_step(ex):
        out = [f"succ[{i}] = {e};" for i, e in enumerate(ex[0])]
        for name, col in (("valid", ex[1]), ("ovf", ex[2]),
                          ("afail", ex[3])):
            out += [f"{name}[{i}] = {e};" for i, e in enumerate(col)]
        return out

    prog.function(
        "HD void st_step(const int32_t* __restrict__ f, "
        "const int32_t* __restrict__ K, int32_t* succ, bool* valid, "
        "bool* ovf, bool* afail)",
        [succs, valid, ovf, afail], store_step)
    return L


def spec_source(step_outputs, inv_outputs, *, n_fields: int,
                widths: Sequence[int], n_words: int, lane_action,
                n_labels: int, title: str,
                template: str = "struct_expand.cuh", cert=None,
                sym=None, por=None, batched: bool = False):
    """(source text, K constants) of one spec: the macros and functions
    the kernel template builds its kernels around -
    torchtlc/kernels/csrc/struct_expand.cuh (K17 and K18) for a struct
    spec, gen_expand.cuh (K19) for a generic one.

    step_outputs are build_step's (succs [1, L, F], valid, ovf, afail
    [1, L]) on ``lanes.input_node(F)``, inv_outputs one ok [1] node per
    invariant.  `cert` - (the [F] maximum codes, the (offset, fields,
    bound) mask triples) of a narrowed backend's runtime certificate -
    prints the tables of kernel K23 (struct_cert.cuh): ST_CERT 1,
    ST_MAX_CODE, ST_NCARD and ST_CARD_SPECS; None prints ST_CERT 0.
    `sym` - the field programs of a symmetry plan (engine.reduce.
    ReducePlan.programs, at least one) - prints ST_SYM 1, ST_SYM_NPROG and
    ``st_sym_prog`` with its remap tables in K (kernels K24 and K25,
    struct_reduce.cuh); `por` - one bool per label, the actions POR may
    take as singleton ample sets - prints ST_POR 1 and ST_POR_SAFE (kernel
    K26).  None prints ST_SYM 0 / ST_POR 0.  `batched` prints ST_BATCHED
    1: struct_expand.cuh then adds the serving plane's batched kernels
    K32, K34 and K35 (emitted_batched.cuh) to the library, which only the
    sweep and smoke classes build, so every other spec's nvcc compiles
    K17's row body fewer times."""
    F = n_fields
    prog = Program()
    L = _step_function(prog, step_outputs, F)
    for k, ok in enumerate(inv_outputs):
        if ok.shape != (1,):
            raise EmitError(f"invariant {k} of shape {ok.shape}")
        prog.function(
            f"HD bool st_inv_{k}(const int32_t* __restrict__ f, "
            "const int32_t* __restrict__ K)", [ok],
            lambda ex: [f"return {ex[0][0]};"])
    bits = " | ".join(f"((uint32_t)st_inv_{k}(f, K) << {k})"
                      for k in range(len(inv_outputs))) or "0u"
    prog.function("HD uint32_t st_inv_bits(const int32_t* __restrict__ f, "
                  "const int32_t* __restrict__ K)", [],
                  lambda ex: [f"return {bits};"])
    if sym:
        prog.functions.append(sym_function(prog, sym, F))
    K = prog.constants()
    head = [
        f"// {title}",
        "// Emitted by torchtlc.struct.emit from the spec's lane IR: the",
        f"// per-spec body of torchtlc/kernels/csrc/{template}.",
        "#include \"struct_prelude.cuh\"",
        "",
        f"#define ST_F {F}",
        f"#define ST_W {n_words}",
        f"#define ST_L {L}",
        f"#define ST_NINV {len(inv_outputs)}",
        f"#define ST_NLABELS {n_labels}",
        f"#define ST_NK {K.size}",
        "#define ST_WIDTHS " + ", ".join(str(int(w)) for w in widths),
        "#define ST_LANE_ACTION " + ", ".join(str(int(a))
                                              for a in lane_action),
    ]
    if cert is None:
        head.append("#define ST_CERT 0")
    else:
        max_code, card_specs = cert
        if len(max_code) != F:
            raise EmitError(f"{len(max_code)} maximum codes for {F} fields")
        head += ["#define ST_CERT 1",
                 "#define ST_MAX_CODE " + ", ".join(str(int(c))
                                                    for c in max_code),
                 f"#define ST_NCARD {len(card_specs)}"]
        if card_specs:
            head.append("#define ST_CARD_SPECS " + ", ".join(
                str(int(x)) for spec in card_specs for x in spec))
    head += (["#define ST_SYM 1", f"#define ST_SYM_NPROG {len(sym)}"]
             if sym else ["#define ST_SYM 0"])
    if por is not None:
        if len(por) != n_labels:
            raise EmitError(f"{len(por)} POR flags for {n_labels} labels")
        head += ["#define ST_POR 1", "#define ST_POR_SAFE " + ", ".join(
            "1" if x else "0" for x in por)]
    else:
        head.append("#define ST_POR 0")
    if batched:
        head.append("#define ST_BATCHED 1")
    head.append("")
    text = "\n".join(head) + "\n\n".join(prog.functions) + (
        f"\n\n#include \"{template}\"\n")
    return text, K


def masks_source(preds, *, n_fields: int, widths: Sequence[int],
                 n_words: int, title: str):
    """(source text, K constants) of kernel K20 gen_state_masks
    (torchtlc/kernels/csrc/gen_masks.cuh): ``st_preds`` evaluates every
    predicate of `preds` (ok [1] nodes on ``lanes.input_node(F)``) on one
    state's fields."""
    for k, p in enumerate(preds):
        if p.shape != (1,) or p.dtype != bool_:
            raise EmitError(f"predicate {k} of shape {p.shape}, {p.dtype}")
    prog = Program()
    prog.function(
        "HD void st_preds(const int32_t* __restrict__ f, "
        "const int32_t* __restrict__ K, bool* out)", list(preds),
        lambda ex: [f"out[{k}] = {e[0]};" for k, e in enumerate(ex)])
    K = prog.constants()
    head = [
        f"// {title}",
        "// Emitted by torchtlc.struct.emit from the predicates' lane IR:",
        "// the per-spec body of torchtlc/kernels/csrc/gen_masks.cuh.",
        "#include \"struct_prelude.cuh\"",
        "",
        f"#define ST_F {n_fields}",
        f"#define ST_W {n_words}",
        f"#define ST_NPRED {len(preds)}",
        f"#define ST_NK {K.size}",
        "#define ST_WIDTHS " + ", ".join(str(int(w)) for w in widths),
        "",
    ]
    text = "\n".join(head) + "\n\n".join(prog.functions) + (
        "\n\n#include \"gen_masks.cuh\"\n")
    return text, K


def cov_source(conds, sites, *, n_sites: int, n_fields: int,
               widths: Sequence[int], n_words: int, lane_action,
               n_labels: int, title: str):
    """(source text, K constants) of kernel K22 struct_cov_count
    (torchtlc/kernels/csrc/struct_cov.cuh): ``st_cov_conds`` evaluates the
    M visit conditions of struct.compile's build_cov (bool [1] nodes on
    ``lanes.input_node(F)``) on one state's fields; ST_COND_SITE holds each
    condition's site index, ST_LANE_ACTION each lane's action site."""
    for k, c in enumerate(conds):
        if c.shape != (1,) or c.dtype != bool_:
            raise EmitError(f"condition {k} of shape {c.shape}, {c.dtype}")
    if len(sites) != len(conds):
        raise EmitError(f"{len(sites)} sites for {len(conds)} conditions")
    prog = Program()
    prog.function(
        "HD void st_cov_conds(const int32_t* __restrict__ f, "
        "const int32_t* __restrict__ K, bool* out)", list(conds),
        lambda ex: [f"out[{k}] = {e[0]};" for k, e in enumerate(ex)])
    K = prog.constants()
    head = [
        f"// {title}",
        "// Emitted by torchtlc.struct.emit from the coverage conditions'",
        "// lane IR: the per-spec body of torchtlc/kernels/csrc/",
        "// struct_cov.cuh.",
        "#include \"struct_prelude.cuh\"",
        "",
        f"#define ST_F {n_fields}",
        f"#define ST_W {n_words}",
        f"#define ST_L {len(lane_action)}",
        f"#define ST_NLABELS {n_labels}",
        f"#define ST_NCOND {len(conds)}",
        f"#define ST_NSITES {n_sites}",
        f"#define ST_NK {K.size}",
        "#define ST_WIDTHS " + ", ".join(str(int(w)) for w in widths),
        "#define ST_LANE_ACTION " + ", ".join(str(int(a))
                                              for a in lane_action),
        # one padding entry keeps the array nonempty when M is 0
        "#define ST_COND_SITE " + ", ".join(
            [str(int(s)) for s in sites] + ["0"]),
        "",
    ]
    text = "\n".join(head) + "\n\n".join(prog.functions) + (
        "\n\n#include \"struct_cov.cuh\"\n")
    return text, K


def infer_source(step_outputs, preds, *, n_fields: int,
                 widths: Sequence[int], n_words: int, title: str):
    """(source text, K constants) of the inference kernels K29
    struct_pred_matrix and K30 struct_certify
    (torchtlc/kernels/csrc/struct_infer.cuh): the spec's ``st_step`` as
    spec_source prints it, one ``st_pred_k`` a candidate predicate (ok [1]
    nodes on ``lanes.input_node(F)``; a constant one prints as a literal),
    and ``st_preds(f, K, out)``, which writes the P predicates of one row
    as bits into ``ST_NPW`` uint32 words, bit k % 32 of word k / 32.  Each
    word is one ``st_pred_word_g`` that nvcc keeps out of line (HDN), so
    no function grows with P and the kernels call one body each."""
    for k, p in enumerate(preds):
        if p.shape != (1,) or p.dtype != bool_:
            raise EmitError(f"predicate {k} of shape {p.shape}, {p.dtype}")
    prog = Program()
    L = _step_function(prog, step_outputs, n_fields)
    for k, p in enumerate(preds):
        prog.function(
            f"HD bool st_pred_{k}(const int32_t* __restrict__ f, "
            "const int32_t* __restrict__ K)", [p],
            lambda ex: [f"return {ex[0][0]};"])
    n_words_p = (len(preds) + 31) // 32
    for g in range(n_words_p):
        ks = range(32 * g, min(32 * g + 32, len(preds)))
        bits = " | ".join(f"((uint32_t)st_pred_{k}(f, K) << {k % 32})"
                          for k in ks)
        prog.function(f"HDN uint32_t st_pred_word_{g}(const int32_t* "
                      "__restrict__ f, const int32_t* __restrict__ K)", [],
                      lambda ex, bits=bits: [f"return {bits};"])
    prog.function(
        "HD void st_preds(const int32_t* __restrict__ f, "
        "const int32_t* __restrict__ K, uint32_t* out)", [],
        lambda ex: [f"out[{g}] = st_pred_word_{g}(f, K);"
                    for g in range(n_words_p)])
    K = prog.constants()
    head = [
        f"// {title}",
        "// Emitted by torchtlc.struct.emit from the spec's step and the",
        "// candidate predicates' lane IR: the per-spec body of",
        "// torchtlc/kernels/csrc/struct_infer.cuh.",
        "#include \"struct_prelude.cuh\"",
        "",
        f"#define ST_F {n_fields}",
        f"#define ST_W {n_words}",
        f"#define ST_L {L}",
        f"#define ST_NPRED {len(preds)}",
        f"#define ST_NPW {n_words_p}",
        f"#define ST_NK {K.size}",
        "#define ST_WIDTHS " + ", ".join(str(int(w)) for w in widths),
        "",
    ]
    text = "\n".join(head) + "\n\n".join(prog.functions) + (
        "\n\n#include \"struct_infer.cuh\"\n")
    return text, K
