"""AST -> tensor-lane compiler for structural specs (E1 device path).

Compiles the parsed translation (struct.parser ASTs) against the
inferred shapes (struct.shapes) and codec layouts (struct.codec) into a
branchless batched step function for the fused device engine - the same
compilation target the hand-written KubeAPI kernel and the gen-subset
compiler feed, now derived from the module text alone.

Design decisions (vs TLC's heap interpreter):

* Enumerated universes become integer lanes; record field access is a
  precomputed table gather ([U] int32 per (record-universe, field)).
* Sets over record universes are bitmask planes; set algebra is
  bitwise; quantifiers/filters/maps/CHOOSE over them LIFT the bound
  variable onto a fresh trailing tensor axis (the binder becomes the
  arange of the universe) so the body compiles ONCE, vectorized -
  no per-element Python unrolling, no data-dependent control flow.
* Nested two-set quantifiers whose predicate is state-independent
  (constant [U,U] plane, e.g. OnlyOneVersion's IsVersionOf) reduce via
  a constant-matrix contraction (in the lane IR, the translation table
  it encodes: struct.lanes.einsum).
* Nondeterminism fans into static lanes: disjuncts, bound parameters
  over constant sets, per-key unrolls for quantifiers over partial-
  function domains (PendingClients), and k-th-set-bit slot lanes for
  `with x \\in <set-valued expr>` picks, with an overflow flag when a
  state's set exceeds the slot budget (the hand kernel's convention).

Reference semantics: KubeAPI.tla:455-768; every path is
differentially pinned against the structural oracle (tests/test_struct
_engine.py).

The port's LaneCompiler: the reference's walk (jaxtlc/struct/compile.py)
kept line for line, with its arrays built as lane-IR nodes (struct.lanes,
imported here under the reference's ``jnp`` name) instead of jnp arrays.
A step or invariant function called on ``lanes.input_node(F)`` returns the
graph; struct.lanes.evaluate runs it with torch (the plain version) and
struct.emit prints it as the C++ body of kernels K17 and K18.  The device
coverage plane keeps the reference's ``CovCollector`` site table and the
walk's site hooks; ``build_cov`` returns the visit conditions as lane-IR
nodes, which struct.emit prints as the body of kernel K22.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..kernels.build import meter
from ..spec.labels import DEFAULT_INIT
from . import lanes as jnp
from .codec import EnumLeaf, MaskLeaf, RecNode, SeqNode, StructCodec, layout_of
from .eval import _SORT_KEY, BUILTIN_SETS, Evaluator, is_fn
from .parser import Definition
from .shapes import (
    SAtoms,
    SBool,
    SInt,
    SRec,
    SSeq,
    SSet,
    SUnion,
    Shape,
    ShapeError,
    _mentions_prime_static,
)

UNROLL_LIMIT = 12  # quantifier domains up to this size unroll in Python
SLOT_CAP = 4  # lanes per set-valued nondeterministic pick


class TrapPolicy:
    """What the certified bound report (analysis.absint) lets the
    compiler drop: range traps whose value interval is PROVEN inside
    the destination universe, and slot lanes / slot-overflow traps on
    set binders whose certified cardinality bound fits.  Built only
    from a CERTIFIED BoundReport; the runtime certificate column
    re-verifies every claim on device, so an unsound bound turns the
    verdict loud instead of silently narrowing states away."""

    def __init__(self, elide_range: bool = False,
                 card_bounds: Optional[Dict[str, int]] = None):
        self.elide_range = bool(elide_range)
        self.card_bounds = dict(card_bounds or {})


class CompileError(ValueError):
    pass


class CovCollector:
    """Site table + per-trace visit conditions for the device coverage
    plane (obs.coverage).

    The lane walker already visits every guard conjunct, IF/CASE arm,
    action-position binder and update conjunct while fanning the
    nondeterminism into lanes; with a collector attached it REGISTERS a
    stable site for each (action label, construct) pair on first
    encounter - keyed by the AST node's identity, which is stable for
    the lifetime of the parsed module, so repeated walks resolve to the
    same table - and records, per walk, the lane condition under which
    that site is visited.  build_cov returns the conditions; the
    coverage plane stacks them into one ``[n_sites] uint32``
    visit-increment vector per block (kernel K22), and the engines
    accumulate it exactly like the obs ring (pure telemetry, no control
    flow).

    Visit semantics (the device analogue of TLC's evaluation counts):
    a guard conjunct is visited once per state whose enumeration path
    reaches it (the guard-so-far at that point - TLC's short-circuit),
    a branch arm once per state selecting it, a binder body once per
    (state, binding) with the binding live, and an update conjunct once
    per state in which its lane fires (the completed successor path)."""

    def __init__(self):
        self.sites: List[tuple] = []  # (key, kind, action, desc)
        self._index: Dict = {}  # (label, kind, id(ast)) -> site idx
        self._ordinals: Dict = {}  # (label, kind) -> next ordinal
        self._kept = []  # keep registered AST nodes alive (id() keys)
        self.active = False
        self._contribs = None  # per-walk [(idx, cond LB/LC)]

    _TAG = {"guard": "g", "branch": "b", "quant": "e", "effect": "w",
            "unchanged": "u"}

    def site(self, label, kind, ast, desc="") -> int:
        label = label or "?"
        key3 = (label, kind, id(ast))
        idx = self._index.get(key3)
        if idx is None:
            n = self._ordinals.get((label, kind), 0)
            self._ordinals[(label, kind)] = n + 1
            key = f"{label}.{self._TAG[kind]}{n}"
            idx = len(self.sites)
            self.sites.append((key, kind, label, desc))
            self._index[key3] = idx
            self._kept.append(ast)
        return idx

    def hit(self, idx: int, cond) -> None:
        if self._contribs is not None:
            self._contribs.append((idx, cond))

    def begin(self):
        self.active = True
        self._contribs = []

    def end(self):
        out = self._contribs
        self.active = False
        self._contribs = None
        return out


# ---------------------------------------------------------------------------
# Lane values
# ---------------------------------------------------------------------------


class LV:
    """Base lane value; arr shapes are [B, d1..d_depth] (B=batch or 1)."""

    depth = 0


class LC(LV):
    """Static host value (bindings, literals, folded subexpressions)."""

    def __init__(self, value):
        self.value = value

    def __repr__(self):
        return f"LC({self.value!r})"


class LB(LV):
    def __init__(self, arr, depth=0):
        self.arr = arr
        self.depth = depth


class LI(LV):
    """Integer lanes, optionally carrying a CERTIFIED (lo, hi) interval.

    Bounds originate only where they are unconditionally true of the
    lanes: committed-state decodes (state fields hold legal codes - the
    encode traps enforce it, and certificate mode re-verifies it on
    device), literals, and interval arithmetic over bounded operands.
    Derived reads that can yield the absent code (-1) - field gathers,
    dynamic sequence indexing - carry no bounds, so the range-trap
    elision (analysis.absint TrapPolicy) can never fire on them."""

    def __init__(self, arr, depth=0, bounds=None):
        self.arr = arr
        self.depth = depth
        self.bounds = bounds  # Optional[(lo, hi)]


def _int_bounds(lv) -> Optional[Tuple[int, int]]:
    if isinstance(lv, LC):
        v = int(lv.value)
        return (v, v)
    if isinstance(lv, LI):
        return lv.bounds
    return None


class LE(LV):
    """Enum-coded value: arr holds indices into leaf.values; -1 = absent
    / invalid (guard-unreachable paths)."""

    def __init__(self, arr, leaf: EnumLeaf, depth=0):
        self.arr = arr
        self.leaf = leaf
        self.depth = depth


class LM(LV):
    """Set as bool plane over elem leaf universe.

    `depth` counts the PREFIX lift axes the mask varies over; bits has
    shape [B, l1..l_depth, U] - the universe axis is always last and is
    NOT a lift axis (until a quantifier lifts over this very mask)."""

    def __init__(self, bits, elem_leaf: EnumLeaf, depth=0):
        self.bits = bits
        self.elem_leaf = elem_leaf
        self.depth = depth


class LRec(LV):
    """Structural record/function: ordered (field, present, value)."""

    def __init__(self, entries):
        # entries: list[(fname, LB|LC(bool) present, LV value)]
        self.entries = list(entries)

    def get(self, fname):
        for f, p, v in self.entries:
            if f == fname:
                return p, v
        return None, None


class LSeq(LV):
    def __init__(self, length, slots, leaf: EnumLeaf, cap: int):
        self.length = length  # LI
        self.slots = slots  # list[LE] (leaf), padded with index 0
        self.leaf = leaf
        self.cap = cap


def _align(arr, from_depth: int, to_depth: int):
    for _ in range(to_depth - from_depth):
        arr = arr[..., None]
    return arr


def _binop_arrs(a_arr, a_d, b_arr, b_d):
    d = max(a_d, b_d)
    return _align(a_arr, a_d, d), _align(b_arr, b_d, d), d


# ---------------------------------------------------------------------------
# Compiler
# ---------------------------------------------------------------------------


class LaneCompiler:
    def __init__(self, ev: Evaluator, variables: Tuple[str, ...],
                 var_shapes: Dict[str, Shape], codec: StructCodec,
                 sweep_vars: frozenset = frozenset(),
                 trap_policy: Optional[TrapPolicy] = None):
        meter("builds")  # one lane compile (serve.pool.CompileMeter)
        self.ev = ev
        self.variables = variables
        self.var_shapes = var_shapes
        self.codec = codec
        # certified-bound trap policy (None = every trap stays); the
        # counters below feed the preflight trap-audit report
        self.trap_policy = trap_policy
        self.trap_sites = 0
        self.elided_traps = 0
        self.reduced_slot_lanes = 0
        # swept constants (jaxtlc.serve.sweep): CONSTANT names promoted
        # to read-only codec fields so their value is RUNTIME data - one
        # compiled step serves every configuration of the constants
        # class.  decode_state hands them to expressions like any state
        # variable (env wins over ev.constants in _comp_name); the spec
        # never primes them, so build_step passes them through verbatim
        self.sweep_vars = frozenset(sweep_vars)
        self._field_tables: Dict = {}
        self._trans_tables: Dict = {}
        self._pred_tables: Dict = {}
        self.trap = None  # LB set when a guard-unreachable encode happens
        # device coverage plane (obs.coverage): a CovCollector while a
        # build_cov walk is running, None otherwise - build_step's own
        # walks never record (self.cov.active gates every hook)
        self.cov: Optional[CovCollector] = None

    # -- tables ------------------------------------------------------------

    def _leaf_of_shape(self, shape) -> EnumLeaf:
        lay = layout_of(shape)
        if isinstance(lay, EnumLeaf):
            return lay
        if isinstance(lay, (MaskLeaf, SeqNode)):
            # a set stored as a mask still has a (tiny) subset-enum leaf
            # when nested inside an enumerated record (KubeAPI's vv);
            # likewise a bounded sequence whose universe is small enough
            # that the NARROWED record containing it enum-encodes
            # (certified bounds can shrink a RecNode variable into one
            # EnumLeaf - its sequence fields then gather through this)
            key = ("enum", shape)
            hit = self._field_tables.get(key)
            if hit is None:
                hit = EnumLeaf(shape)
                self._field_tables[key] = hit
            return hit
        raise CompileError(f"shape not enum-layout: {shape}")

    def field_table(self, leaf: EnumLeaf, fname: str,
                    tgt: EnumLeaf) -> np.ndarray:
        """[U] int32: index of value.fname in tgt's universe; -1 absent."""
        key = (id(leaf), fname, id(tgt))
        t = self._field_tables.get(key)
        if t is None:
            rows = []
            for v in leaf.values:
                if isinstance(v, tuple) and is_fn(v):
                    d = dict(v)
                    if fname in d:
                        rows.append(tgt.index.get(d[fname], -1))
                    else:
                        rows.append(-1)
                else:
                    rows.append(-1)
            t = np.asarray(rows, np.int32)
            self._field_tables[key] = t
        return t

    def presence_table(self, leaf: EnumLeaf, fname: str) -> np.ndarray:
        key = (id(leaf), fname, "present")
        t = self._field_tables.get(key)
        if t is None:
            t = np.asarray([
                isinstance(v, tuple) and is_fn(v) and fname in dict(v)
                for v in leaf.values
            ], bool)
            self._field_tables[key] = t
        return t

    def trans_table(self, src: EnumLeaf, dst: EnumLeaf) -> np.ndarray:
        key = (id(src), id(dst))
        t = self._trans_tables.get(key)
        if t is None:
            t = np.asarray(
                [dst.index.get(v, -1) for v in src.values], np.int32
            )
            self._trans_tables[key] = t
        return t

    def choose_rank_table(self, leaf: EnumLeaf) -> np.ndarray:
        """rank[i] = position of leaf.values[i] under the evaluator's
        CHOOSE iteration order (sorted by _SORT_KEY): the device witness
        pick minimizes this rank so both engines agree."""
        key = (id(leaf), "#choose_rank")
        t = self._pred_tables.get(key)
        if t is None:
            order = sorted(range(len(leaf.values)),
                           key=lambda i: _SORT_KEY(leaf.values[i]))
            t = np.zeros(len(leaf.values), np.int32)
            for r, i in enumerate(order):
                t[i] = r
            self._pred_tables[key] = t
        return t

    def value_pred_table(self, leaf: EnumLeaf, fn) -> np.ndarray:
        key = (id(leaf), fn.__name__, getattr(fn, "_key", None))
        t = self._pred_tables.get(key)
        if t is None:
            t = np.asarray([bool(fn(v)) for v in leaf.values], bool)
            self._pred_tables[key] = t
        return t

    # -- conversions -------------------------------------------------------

    def to_leaf(self, lv: LV, leaf: EnumLeaf) -> LE:
        """Any lane value -> enum index in `leaf` (arr; -1 = absent)."""
        if isinstance(lv, LE):
            if lv.leaf is leaf:
                return lv
            t = self.trans_table(lv.leaf, leaf)
            idx = jnp.where(
                lv.arr >= 0, jnp.asarray(t)[jnp.maximum(lv.arr, 0)], -1
            )
            return LE(idx, leaf, lv.depth)
        if isinstance(lv, LC):
            return LE(jnp.full((1,), leaf.index.get(lv.value, -1),
                               jnp.int32), leaf, 0)
        if isinstance(lv, LB):
            if isinstance(leaf.shape, SBool):
                return LE(lv.arr.astype(jnp.int32), leaf, lv.depth)
            return self.to_leaf(
                LE(lv.arr.astype(jnp.int32),
                   self._leaf_of_shape(SBool()), lv.depth), leaf)
        if isinstance(lv, LI):
            sh = leaf.shape
            if isinstance(sh, SInt):
                self.trap_sites += 1
                b = lv.bounds
                if (self.trap_policy is not None
                        and self.trap_policy.elide_range
                        and b is not None
                        and b[0] >= sh.lo and b[1] <= sh.hi):
                    # the certified interval proves the range trap
                    # unreachable: compile it out (the runtime
                    # certificate column re-verifies the claim)
                    self.elided_traps += 1
                    return LE(lv.arr - sh.lo, leaf, lv.depth)
                # range trap: a value outside the (widened) inferred
                # range encodes as -1 and halts the engine loudly
                ok = (lv.arr >= sh.lo) & (lv.arr <= sh.hi)
                return LE(jnp.where(ok, lv.arr - sh.lo, -1), leaf,
                          lv.depth)
            raise CompileError("int value into non-int leaf")
        if isinstance(lv, LRec):
            return self._rec_to_leaf(lv, leaf)
        if isinstance(lv, LM):
            return self._mask_to_leaf(lv, leaf)
        if isinstance(lv, LSeq):
            return self._seq_to_leaf(lv, leaf)
        raise CompileError(f"cannot convert {type(lv).__name__} to leaf")

    def _resolve_alt(self, leaf: EnumLeaf, klass):
        """(offset, alt EnumLeaf) of the `klass` alternative inside a
        union leaf (universe concatenation order = alts order)."""
        sh = leaf.shape
        if isinstance(sh, klass):
            return 0, leaf
        if isinstance(sh, SUnion):
            off = 0
            for alt in sh.alts:
                alt_leaf = self._leaf_of_shape(alt)
                if isinstance(alt, klass):
                    return off, alt_leaf
                off += len(alt_leaf.values)
        raise CompileError(f"no {klass.__name__} alternative in {sh}")

    def _rec_to_leaf(self, lv: LRec, leaf: EnumLeaf) -> LE:
        off, rec_leaf = self._resolve_alt(leaf, SRec)
        sh: SRec = rec_leaf.shape
        # mixed-radix index, first field most significant (codec
        # universe order: itertools.product over field-sorted options)
        radices = []
        for f, s, opt in sh.fields:
            n = len(self._leaf_of_shape(s).values)
            radices.append(n + 1 if opt else n)
        idx = None
        depth = 0
        for (f, s, opt), radix in zip(sh.fields, radices):
            p, v = lv.get(f)
            fleaf = self._leaf_of_shape(s)
            if v is None:
                if not opt:
                    raise CompileError(f"required field {f} missing")
                code = jnp.zeros((1,), jnp.int32)
                pd = 0
            else:
                fe = self.to_leaf(v, fleaf)
                code = fe.arr + (1 if opt else 0)
                pd = fe.depth
                if opt and not (isinstance(p, LC) and p.value is True):
                    # dynamic presence
                    parr = p.arr if isinstance(p, LB) else jnp.full(
                        (1,), bool(p.value))
                    code, parr2, pd = _binop_arrs(code, pd, parr,
                                                  p.depth if isinstance(
                                                      p, LB) else 0)
                    code = jnp.where(parr2, code, 0)
            if idx is None:
                idx, depth = code, pd
            else:
                ia, ca, depth = _binop_arrs(idx, depth, code, pd)
                idx = ia * radix + ca
        if idx is None:
            idx = jnp.zeros((1,), jnp.int32)
        return LE(idx + off, leaf, depth)

    def _mask_to_leaf(self, lv: LM, leaf: EnumLeaf) -> LE:
        off, set_leaf = self._resolve_alt(leaf, SSet)
        sh: SSet = set_leaf.shape
        elem_leaf = self._leaf_of_shape(sh.elem)
        src = lv
        if lv.elem_leaf is not elem_leaf:
            src = self.remask(lv, elem_leaf)
        n = len(elem_leaf.values)
        weights = jnp.asarray([1 << i for i in range(n)], jnp.int32)
        idx = (src.bits.astype(jnp.int32) * weights).sum(axis=-1)
        return LE(idx + off, leaf, src.depth)

    def _seq_to_leaf(self, lv: LSeq, leaf: EnumLeaf) -> LE:
        off, seq_leaf = self._resolve_alt(leaf, SSeq)
        sh: SSeq = seq_leaf.shape
        n = len(self._leaf_of_shape(sh.elem).values)
        # universe order: length-0 block, then length-1, ... ; within a
        # block, position 0 most significant
        idx = None
        depth = 0
        for k in range(sh.cap + 1):
            block_off = sum(n ** j for j in range(k))
            code = jnp.zeros((1,), jnp.int32)
            cd = 0
            for i in range(k):
                se = self.to_leaf(lv.slots[i], self._leaf_of_shape(sh.elem))
                ca, sa, cd = _binop_arrs(code, cd, se.arr, se.depth)
                code = ca * n + sa
            code = code + block_off
            la, ca2, d2 = _binop_arrs(lv.length.arr, lv.length.depth,
                                      code, cd)
            here = jnp.where(la == k, ca2, 0)
            if idx is None:
                idx, depth = here, d2
            else:
                ia, ha, depth = _binop_arrs(idx, depth, here, d2)
                idx = ia + ha
        return LE(idx + off, leaf, depth)

    def remask(self, lv: LM, elem_leaf: EnumLeaf) -> LM:
        """Re-express a mask over a different element universe."""
        t = self.trans_table(lv.elem_leaf, elem_leaf)
        n = len(elem_leaf.values)
        onehot = np.zeros((len(lv.elem_leaf.values), n), bool)
        for i, j in enumerate(t):
            if j >= 0:
                onehot[i, j] = True
        m = jnp.asarray(onehot)
        bits = jnp.einsum("...u,uv->...v", lv.bits.astype(jnp.int32),
                          m.astype(jnp.int32)) > 0
        return LM(bits, elem_leaf, lv.depth)

    def remask_tracked(self, lv: LM, elem_leaf: EnumLeaf):
        """remask + lane-wise LB flag: a set bit had no image in the new
        universe (it was DROPPED - membership of it is False by
        construction, but equality through the reduced planes would lie)."""
        t = self.trans_table(lv.elem_leaf, elem_leaf)
        lost = jnp.asarray(t < 0)
        dropped = LB((lv.bits & lost).any(axis=-1), lv.depth)
        return self.remask(lv, elem_leaf), dropped

    def _setlit_dropped(self, lit: "LSetLit", elem_leaf: EnumLeaf) -> LV:
        """Lane-wise LB: some literal item has no index in elem_leaf
        (to_leaf returned -1), i.e. _setlit_mask dropped it."""
        dropped = LC(False)
        for item in lit.items:
            ie = self.to_leaf(item, elem_leaf)
            dropped = self._lor(dropped, LB(ie.arr < 0, ie.depth))
        return dropped

    def explode(self, lv: LE) -> LRec:
        """Enum record -> structural record (field gathers)."""
        sh = lv.leaf.shape
        rec_sh = None
        if isinstance(sh, SRec):
            rec_sh = sh
        elif isinstance(sh, SUnion):
            for alt in sh.alts:
                if isinstance(alt, SRec):
                    rec_sh = alt
        if rec_sh is None:
            raise CompileError(f"cannot explode non-record leaf {sh}")
        entries = []
        safe = jnp.maximum(lv.arr, 0)
        for f, s, opt in rec_sh.fields:
            fleaf = self._leaf_of_shape(s)
            tab = jnp.asarray(self.field_table(lv.leaf, f, fleaf))
            val = LE(tab[safe], fleaf, lv.depth)
            pres = jnp.asarray(self.presence_table(lv.leaf, f))[safe]
            entries.append((f, LB(pres, lv.depth), self._from_leaf(val, s)))
        return LRec(entries)

    def _from_leaf(self, lv: LE, shape, trusted: bool = False) -> LV:
        """Enum-decoded values regain their native lane type: ints/bools
        become arithmetic/boolean lanes, sets become masks so set
        algebra stays bitwise after an explode.  `trusted` marks codes
        that CANNOT be the absent sentinel (-1) - committed-state
        decodes - whose int view therefore carries certified bounds."""
        if isinstance(shape, SInt):
            return LI(lv.arr + shape.lo, lv.depth,
                      bounds=(shape.lo, shape.hi) if trusted else None)
        if isinstance(shape, SBool):
            return LB(lv.arr == 1, lv.depth)
        if isinstance(shape, SSet):
            elem_leaf = self._leaf_of_shape(shape.elem)
            n = len(elem_leaf.values)
            weights = jnp.asarray([1 << i for i in range(n)], jnp.int32)
            safe = jnp.maximum(lv.arr, 0)
            # the value's index IS the subset bit pattern (codec order)
            bits = (safe[..., None] // weights) % 2 == 1
            return LM(bits, elem_leaf, lv.depth)
        if isinstance(shape, SSeq) and isinstance(lv.leaf.shape, SSeq):
            # enum-coded bounded sequence (a seq field gathered out of
            # an enum-encoded record) -> structural LSeq via length /
            # slot gather tables, so Len/Head/Tail/indexing keep
            # working after the narrowed layout enum-encodes the parent
            elem_leaf = self._leaf_of_shape(shape.elem)
            key = (id(lv.leaf), "#seq", id(elem_leaf))
            tabs = self._pred_tables.get(key)
            if tabs is None:
                lens, slots = [], [[] for _ in range(shape.cap)]
                for v in lv.leaf.values:
                    t = v if isinstance(v, tuple) else ()
                    lens.append(len(t))
                    for k in range(shape.cap):
                        slots[k].append(
                            elem_leaf.index.get(t[k], 0)
                            if k < len(t) else 0
                        )
                tabs = (np.asarray(lens, np.int32),
                        [np.asarray(s, np.int32) for s in slots])
                self._pred_tables[key] = tabs
            safe = jnp.maximum(lv.arr, 0)
            length = LI(jnp.asarray(tabs[0])[safe], lv.depth,
                        bounds=(0, shape.cap))
            slot_lvs = [LE(jnp.asarray(t)[safe], elem_leaf, lv.depth)
                        for t in tabs[1]]
            return LSeq(length, slot_lvs, elem_leaf, shape.cap)
        return lv

    # -- equality ----------------------------------------------------------

    def eq(self, a: LV, b: LV) -> LB:
        if isinstance(a, LC) and isinstance(b, LC):
            return LC(a.value == b.value)
        if isinstance(a, LC) and not isinstance(b, LC):
            return self.eq(b, a)
        if isinstance(a, LB) and isinstance(b, (LB, LC)):
            barr = b.arr if isinstance(b, LB) else jnp.asarray(
                bool(b.value))[None]
            x, y, d = _binop_arrs(a.arr, a.depth,
                                  barr, b.depth if isinstance(b, LB) else 0)
            return LB(x == y, d)
        if isinstance(a, LI) and isinstance(b, (LI, LC)):
            barr = b.arr if isinstance(b, LI) else jnp.asarray(
                int(b.value))[None]
            x, y, d = _binop_arrs(a.arr, a.depth,
                                  barr, b.depth if isinstance(b, LI) else 0)
            return LB(x == y, d)
        if isinstance(a, LM) or isinstance(b, LM):
            am = self.as_mask(a)
            # a's elements all live in am's universe, so any element of b
            # DROPPED while expressing it there makes equality impossible:
            # dropping silently would compare a against b-intersect-universe
            # and let `s = K` / `s # K` corrupt exploration (ADVICE.md)
            dropped = LC(False)
            if isinstance(b, LC):
                if not isinstance(b.value, frozenset):
                    raise CompileError(f"not a set constant: {b.value!r}")
                if any(x not in am.elem_leaf.index for x in b.value):
                    return LC(False)
            if isinstance(b, LSetLit):
                dropped = self._setlit_dropped(b, am.elem_leaf)
            bm = self.as_mask(b, like=am)
            if bm.elem_leaf is not am.elem_leaf:
                bm, rdrop = self.remask_tracked(bm, am.elem_leaf)
                dropped = self._lor(dropped, rdrop)
            x, y, d = _mask_align(am.bits, am.depth, bm.bits, bm.depth)
            return self._land(LB((x == y).all(axis=-1), d),
                              self._lnot(dropped))
        if isinstance(a, LE):
            be = self.to_leaf(b, a.leaf)
            x, y, d = _binop_arrs(a.arr, a.depth, be.arr, be.depth)
            return LB((x == y) & (x >= 0), d)
        if isinstance(b, LE):
            return self.eq(b, a)
        if isinstance(a, LSeq) and isinstance(b, LSeq):
            # slots beyond the live length may hold garbage in derived
            # sequences (Append/Tail), so compare only live positions
            la, lad = self._int_arr(a.length)
            lb, lbd = self._int_arr(b.length)
            x, y, d = _binop_arrs(la, lad, lb, lbd)
            out = LB(x == y, d)
            for i in range(min(a.cap, b.cap)):
                sa = self.to_leaf(a.slots[i], a.leaf)
                sb = self.to_leaf(b.slots[i], a.leaf)
                same = self.eq(sa, sb)
                dead = LB(x <= i, d)
                out = self._land(out, self._lor(dead, same))
            return out
        if isinstance(a, (LRec, LSeq)) or isinstance(b, (LRec, LSeq)):
            # compare through a common enum leaf
            leaf = self._leaf_for_value(a) or self._leaf_for_value(b)
            if leaf is None:
                raise CompileError("cannot compare structural values")
            ae = self.to_leaf(a, leaf)
            return self.eq(ae, b)
        raise CompileError(
            f"cannot compare {type(a).__name__} and {type(b).__name__}"
        )

    def _leaf_for_value(self, lv) -> Optional[EnumLeaf]:
        if isinstance(lv, LE):
            return lv.leaf
        return None

    def as_mask(self, lv: LV, like: Optional[LM] = None) -> LM:
        if isinstance(lv, LM):
            return lv
        if isinstance(lv, LSetLit):
            if like is None:
                raise CompileError("set literal needs an element leaf")
            return self._setlit_mask(lv, like.elem_leaf)
        if isinstance(lv, LC):
            if not isinstance(lv.value, frozenset):
                raise CompileError(f"not a set constant: {lv.value!r}")
            if like is None:
                raise CompileError("constant set needs an element leaf")
            bits = np.zeros(len(like.elem_leaf.values), bool)
            for x in lv.value:
                i = like.elem_leaf.index.get(x)
                if i is not None:
                    bits[i] = True
                # elements outside the universe are unreachable values;
                # membership of them is False by construction
            return LM(jnp.asarray(bits)[None, :], like.elem_leaf, 0)
        if isinstance(lv, LE):
            sh = lv.leaf.shape
            if isinstance(sh, SSet) or (
                isinstance(sh, SUnion)
                and any(isinstance(a, SSet) for a in sh.alts)
            ):
                target = None
                if isinstance(sh, SSet):
                    target = sh
                else:
                    for alt in sh.alts:
                        if isinstance(alt, SSet):
                            target = alt
                off, set_leaf = self._resolve_alt(lv.leaf, SSet)
                elem_leaf = self._leaf_of_shape(target.elem)
                n = len(elem_leaf.values)
                weights = jnp.asarray([1 << i for i in range(n)], jnp.int32)
                safe = jnp.maximum(lv.arr - off, 0)
                bits = (safe[..., None] // weights) % 2 == 1
                return LM(bits, elem_leaf, lv.depth)
        raise CompileError(f"cannot view {type(lv).__name__} as mask")


    # ======================================================================
    # Expression compilation
    # ======================================================================

    def comp(self, ast, env, ctx) -> LV:
        """Compile an expression AST to a lane value.  `env` maps names
        to LVs / Definitions; primed variables live under ("'", name);
        `ctx` is the LaneCtx accumulating afail/trap."""
        op = ast[0]
        if op in ("num",):
            return LC(ast[1])
        if op in ("str", "bool"):
            return LC(ast[1])
        if op == "name":
            return self._comp_name(ast[1], env, ctx)
        if op == "prime":
            key = ("'", ast[1])
            if key not in env:
                raise CompileError(f"{ast[1]}' read before assignment")
            v = env[key]
            if v == "passthrough":
                return env[ast[1]]
            return v
        if op == "setlit":
            items = [self.comp(x, env, ctx) for x in ast[1]]
            if all(isinstance(x, LC) for x in items):
                return LC(frozenset(x.value for x in items))
            return LSetLit(items)
        if op == "tuple":
            return LTuple([self.comp(x, env, ctx) for x in ast[1]])
        if op == "record":
            return LRec([
                (f, LC(True), self.comp(x, env, ctx)) for f, x in ast[1]
            ])
        if op == "apply":
            return self._comp_apply(ast, env, ctx)
        if op == "domain":
            return self._comp_domain(self.comp(ast[1], env, ctx))
        if op == "not":
            v = self.comp(ast[1], env, ctx)
            if isinstance(v, LC):
                return LC(not v.value)
            return LB(~v.arr, v.depth)
        if op in ("and", "or"):
            return self._comp_junction(op, ast[1], env, ctx)
        if op == "implies":
            a = self.comp(ast[1], env, ctx)
            b = self.comp(ast[2], env, ctx)
            return self._lor(self._lnot(a), b)
        if op == "cmp":
            return self._comp_cmp(ast, env, ctx)
        if op == "binop":
            return self._comp_binop(ast, env, ctx)
        if op == "if":
            c = self.comp(ast[1], env, ctx)
            if isinstance(c, LC):
                return self.comp(ast[2] if c.value else ast[3], env, ctx)
            # effects (trap/ovf/afail) raised inside a branch only count
            # when that branch is SELECTED: the host evaluator never
            # looks at the untaken branch, so e.g. LastTerm's
            # `IF Len(s) = 0 THEN 0 ELSE s[Len(s)]` must not trap on the
            # ELSE read when Len(s) = 0 (the RaftReplication device break)
            t, t_fx = self._comp_branch(ast[2], env, ctx)
            e, e_fx = self._comp_branch(ast[3], env, ctx)
            self._merge_branch_fx(ctx, c, t_fx, e_fx)
            return self.select(c, t, e)
        if op == "case":
            arms = []
            for g_ast, e_ast in ast[1]:
                g = self.comp(g_ast, env, ctx)
                e, fx = self._comp_branch(e_ast, env, ctx)
                # arm effects gated by the arm's own guard (a sound
                # over-approximation when several guards hold; TLA CASE
                # is nondeterministic among them anyway)
                self._merge_branch_fx(ctx, g, fx, None)
                arms.append((g, e))
            if ast[2] is not None:
                any_g = LC(False)
                for g, _ in arms:
                    any_g = self._lor(any_g, g)
                o, fx = self._comp_branch(ast[2], env, ctx)
                self._merge_branch_fx(ctx, self._lnot(any_g), fx, None)
                out = o
            else:
                out = arms[-1][1]
            for g, e in reversed(arms):
                if isinstance(g, LC):
                    out = e if g.value else out
                else:
                    out = self.select(g, e, out)
            return out
        if op == "let":
            env2 = dict(env)
            for name, params, body in ast[1]:
                if params:
                    env2[name] = Definition(name, params, body)
                else:
                    env2[name] = self.comp(body, env2, ctx)
            return self.comp(ast[2], env2, ctx)
        if op == "choose":
            return self._comp_choose(ast, env, ctx)
        if op in ("forall", "exists"):
            return self._comp_quant(ast, env, ctx)
        if op == "setfilter":
            return self._comp_setfilter(ast, env, ctx)
        if op == "setmap":
            return self._comp_setmap(ast, env, ctx)
        if op == "except":
            return self._comp_except(ast, env, ctx)
        if op == "atref":
            if "@" not in env:
                raise CompileError("@ outside EXCEPT")
            return env["@"]
        if op == "call":
            return self._comp_call(ast, env, ctx)
        if op == "fnlit":
            return self._comp_fnlit(ast, env, ctx)
        raise CompileError(f"cannot compile node {op!r}")

    def _comp_name(self, name, env, ctx) -> LV:
        if name in env:
            v = env[name]
            if isinstance(v, Definition):
                if v.params:
                    raise CompileError(f"{name} needs arguments")
                return self.comp(v.body, env, ctx)
            return v
        if name in self.ev.constants:
            return LC(self.ev.constants[name])
        if name in BUILTIN_SETS:
            return LC(BUILTIN_SETS[name])
        d = self.ev.defs.get(name)
        if d is not None:
            if d.params:
                raise CompileError(f"{name} needs arguments")
            return self.comp(d.body, env, ctx)
        raise CompileError(f"unknown name {name!r}")

    def _comp_junction(self, op, items, env, ctx) -> LV:
        acc = None
        for x in items:
            v = self.comp(x, env, ctx)
            acc = v if acc is None else (
                self._land(acc, v) if op == "and" else self._lor(acc, v)
            )
        return acc

    def _lnot(self, a):
        if isinstance(a, LC):
            return LC(not a.value)
        return LB(~a.arr, a.depth)

    def _land(self, a, b):
        if isinstance(a, LC):
            return b if a.value else LC(False)
        if isinstance(b, LC):
            return a if b.value else LC(False)
        x, y, d = _binop_arrs(a.arr, a.depth, b.arr, b.depth)
        return LB(x & y, d)

    def _lor(self, a, b):
        if isinstance(a, LC):
            return LC(True) if a.value else b
        if isinstance(b, LC):
            return LC(True) if b.value else a
        x, y, d = _binop_arrs(a.arr, a.depth, b.arr, b.depth)
        return LB(x | y, d)

    _FX = ("trap", "ovf", "afail")

    def _comp_branch(self, ast, env, ctx):
        """Compile `ast` with the effect accumulators (trap/ovf/afail)
        swapped out, returning (value, {effect: LB}) so the caller can
        re-apply them gated by the branch condition.  The guard is NOT
        swapped: it belongs to the lane, not the expression."""
        saved = {f: getattr(ctx, f) for f in self._FX}
        for f in self._FX:
            setattr(ctx, f, LC(False))
        v = self.comp(ast, env, ctx)
        fx = {f: getattr(ctx, f) for f in self._FX}
        for f in self._FX:
            setattr(ctx, f, saved[f])
        return v, fx

    def _merge_branch_fx(self, ctx, cond, t_fx, e_fx):
        """Fold branch effects into ctx, each gated by its branch being
        the one selected.  A non-boolean condition degrades to the old
        ungated behavior (sound: traps at worst too eagerly)."""
        gateable = isinstance(cond, (LB, LC))
        for f in self._FX:
            for fx, gate in ((t_fx, cond),
                             (e_fx, self._lnot(cond) if gateable
                              else None)):
                if fx is None:
                    continue
                eff = fx[f]
                if isinstance(eff, LC) and not eff.value:
                    continue
                if gateable:
                    eff = self._land(gate, eff)
                setattr(ctx, f, self._lor(getattr(ctx, f), eff))

    def _comp_apply(self, ast, env, ctx) -> LV:
        base = self.comp(ast[1], env, ctx)
        arg = self.comp(ast[2], env, ctx)
        if isinstance(base, LSeq) and isinstance(arg, LI):
            # dynamic sequence index (s[Len(s)]): a where-chain over the
            # bounded cap - still branchless
            out = base.slots[base.cap - 1]
            for i in range(base.cap - 2, -1, -1):
                here = self.eq(arg, LC(i + 1))
                out = self.select(here, base.slots[i], out)
            # an index outside 1..Len(s) must emit the -1 trap (to_leaf's
            # range-trap discipline) - never the where-chain default slot,
            # which would be a silently wrong value for a reachable
            # out-of-bounds read (host evaluator raises here).  The slot
            # -1 alone is not loud enough: _from_leaf re-bases enum codes
            # into the ELEM value range, which can land back inside the
            # destination universe - so the read also registers in
            # ctx.trap directly (reduced over lift axes; a trap on any
            # branch of a lifted binder halts, loud beats silent)
            oe = self.to_leaf(out, base.leaf)
            av, ad = self._int_arr(arg)
            lnv, lnd = self._int_arr(base.length)
            x, y, d0 = _binop_arrs(av, ad, lnv, lnd)
            okb = (x >= 1) & (x <= y)
            bad = ~okb
            for _ in range(d0):
                bad = bad.any(axis=-1)
            ctx.trap = self._lor(ctx.trap, LB(bad, 0))
            oka, oa, d = _binop_arrs(okb.astype(jnp.int32), d0,
                                     oe.arr, oe.depth)
            oe = LE(jnp.where(oka == 1, oa, -1), base.leaf, d)
            return self._from_leaf(oe, base.leaf.shape)
        if not isinstance(arg, LC):
            raise CompileError("dynamic function application index")
        key = arg.value
        if isinstance(base, LC):
            from .eval import fn_apply

            return LC(fn_apply(base.value, key))
        if isinstance(base, LRec):
            p, v = base.get(key)
            if v is None:
                raise CompileError(f"field {key!r} not in record layout")
            return v
        if isinstance(base, LE):
            sh = base.leaf.shape
            fs = None
            if isinstance(sh, SRec):
                fs = sh.field(key)
            elif isinstance(sh, SUnion):
                for alt in sh.alts:
                    if isinstance(alt, SRec) and alt.field(key):
                        fs = alt.field(key)
            if fs is None:
                raise CompileError(f"no field {key!r} on {sh}")
            fleaf = self._leaf_of_shape(fs[0])
            tab = jnp.asarray(self.field_table(base.leaf, key, fleaf))
            safe = jnp.maximum(base.arr, 0)
            return self._from_leaf(LE(tab[safe], fleaf, base.depth), fs[0])
        if isinstance(base, LSeq) and isinstance(key, int):
            if 1 <= key <= base.cap:
                return self._from_leaf(base.slots[key - 1],
                                       base.leaf.shape)
            raise CompileError("sequence index out of cap")
        raise CompileError(
            f"cannot apply {type(base).__name__}[{key!r}]"
        )

    def _comp_domain(self, base) -> LV:
        if isinstance(base, LC):
            from .eval import fn_domain

            return LC(fn_domain(base.value))
        if isinstance(base, LRec):
            names = [f for f, _, _ in base.entries]
            leaf = self._leaf_of_shape(SAtoms(frozenset(names)))
            cols = []
            depth = 0
            for f, p, _ in base.entries:
                if isinstance(p, LC):
                    cols.append((f, None, bool(p.value)))
                else:
                    cols.append((f, p, None))
                    depth = max(depth, p.depth)
            order = {v: i for i, v in enumerate(leaf.values)}
            arrs = [None] * len(leaf.values)
            for f, p, const in cols:
                i = order[f]
                if p is None:
                    arrs[i] = jnp.full((1,) + (1,) * depth, const)
                else:
                    arrs[i] = _align(p.arr, p.depth, depth)
            bits = jnp.stack(jnp.broadcast_arrays(*arrs), axis=-1)
            return LM(bits, leaf, depth)
        if isinstance(base, LE):
            sh = base.leaf.shape
            rec_sh = sh if isinstance(sh, SRec) else None
            if rec_sh is None and isinstance(sh, SUnion):
                for alt in sh.alts:
                    if isinstance(alt, SRec):
                        rec_sh = alt
            if rec_sh is None:
                raise CompileError(f"DOMAIN of {sh}")
            names = [f for f, _, _ in rec_sh.fields]
            leaf = self._leaf_of_shape(SAtoms(frozenset(names)))
            safe = jnp.maximum(base.arr, 0)
            cols = []
            for v in leaf.values:
                cols.append(jnp.asarray(self.presence_table(
                    base.leaf, v))[safe])
            bits = jnp.stack(cols, axis=-1)
            return LM(bits, leaf, base.depth)
        raise CompileError(f"DOMAIN of {type(base).__name__}")

    # -- comparisons -------------------------------------------------------

    def _comp_cmp(self, ast, env, ctx) -> LV:
        _, sym, la, ra = ast
        if sym == r"\in" and ra[0] == "funcset":
            return self._member_funcset(la, ra, env, ctx)
        if sym == r"\notin" and ra[0] == "funcset":
            return self._lnot(self._member_funcset(la, ra, env, ctx))
        a = self.comp(la, env, ctx)
        b = self.comp(ra, env, ctx)
        if sym == "=":
            return self._eq_lv(a, b)
        if sym == "#":
            return self._lnot(self._eq_lv(a, b))
        if sym in (r"\in", r"\notin"):
            m = self._member_lv(a, b)
            return self._lnot(m) if sym == r"\notin" else m
        if sym == r"\subseteq":
            return self._subseteq_lv(a, b)
        if sym in ("<", ">", "<=", ">="):
            if isinstance(a, LC) and isinstance(b, LC):
                return LC({"<": a.value < b.value, ">": a.value > b.value,
                           "<=": a.value <= b.value,
                           ">=": a.value >= b.value}[sym])
            av, ad = self._int_arr(a)
            bv, bd = self._int_arr(b)
            x, y, d = _binop_arrs(av, ad, bv, bd)
            return LB({"<": x < y, ">": x > y, "<=": x <= y,
                       ">=": x >= y}[sym], d)
        raise CompileError(f"cannot compile cmp {sym}")

    def _int_arr(self, lv):
        """(arr, depth) int view of a lane value (LI, int LC, or an
        enum-coded SInt)."""
        if isinstance(lv, LI):
            return lv.arr, lv.depth
        if isinstance(lv, LC):
            return jnp.asarray(int(lv.value))[None], 0
        if isinstance(lv, LE) and isinstance(lv.leaf.shape, SInt):
            return lv.arr + lv.leaf.shape.lo, lv.depth
        raise CompileError(
            f"cannot order {type(lv).__name__} values"
        )

    def _member_funcset(self, la, ra, env, ctx) -> LV:
        f = self.comp(la, env, ctx)
        return self._member_funcset_lv(f, ra, env, ctx)

    def _member_funcset_lv(self, f, ra, env, ctx) -> LV:
        """f \\in [S -> T] without enumerating the function space: the
        domain is exactly S and every value lands in T (TypeOK's usual
        function-typing conjunct).  A funcset codomain recurses per key
        instead of compiling [S2 -> T2] as a value (two-level functions
        like `view \\in [Sidecars -> [Endpoints -> {"ok","down"}]]`)."""
        _, s_ast, t_ast = ra
        s = self.comp(s_ast, env, ctx)
        if not isinstance(s, LC) or not isinstance(s.value, frozenset):
            raise CompileError("[S -> T] with dynamic domain")
        nested = isinstance(t_ast, tuple) and t_ast and t_ast[0] == "funcset"
        t = None if nested else self.comp(t_ast, env, ctx)
        if isinstance(f, LE):
            f = self.explode(f)
        if not isinstance(f, LRec):
            raise CompileError("\\in [S -> T] on a non-function value")
        out = LC(True)
        names = {fn for fn, _, _ in f.entries}
        if names != s.value:
            # layout fields outside S must be absent; S-fields present
            for extra in names - s.value:
                p, _ = f.get(extra)
                out = self._land(out, self._lnot(p))
        for key in sorted(s.value):
            p, v = f.get(key)
            if v is None:
                return LC(False)
            out = self._land(out, p)
            if nested:
                if isinstance(v, LE):
                    v = self.explode(v)
                out = self._land(out,
                                 self._member_funcset_lv(v, t_ast, env, ctx))
            else:
                out = self._land(out, self._member_lv(v, t))
        return out

    def _eq_lv(self, a, b) -> LV:
        if isinstance(a, (LSetLit, LTuple)) or isinstance(b, (LSetLit,
                                                              LTuple)):
            raise CompileError("structural literal equality unsupported")
        v = self.eq(a, b)
        return v

    def _member_lv(self, a, b) -> LV:
        if isinstance(b, LC):
            bv = b.value
            if isinstance(bv, frozenset):
                if isinstance(a, LC):
                    return LC(a.value in bv)
                if isinstance(a, LE):
                    tab = self.value_pred_table(
                        a.leaf, _named(lambda v: v in bv,
                                       ("inset", tuple(sorted(map(repr,
                                                                  bv))))))
                    safe = jnp.maximum(a.arr, 0)
                    return LB(jnp.asarray(tab)[safe] & (a.arr >= 0),
                              a.depth)
                if isinstance(a, LB):
                    ok_t = True in bv
                    ok_f = False in bv
                    return LB(jnp.where(a.arr, ok_t, ok_f), a.depth)
                if isinstance(a, LI) and all(
                    isinstance(x, int) for x in bv
                ):
                    ints = sorted(bv)
                    if ints and ints == list(range(ints[0],
                                                   ints[-1] + 1)):
                        return LB((a.arr >= ints[0])
                                  & (a.arr <= ints[-1]), a.depth)
                    out = jnp.zeros_like(a.arr, bool)
                    for x in ints:
                        out = out | (a.arr == x)
                    return LB(out, a.depth)
                raise CompileError("\\in constant set: unsupported lhs")
            if bv is BUILTIN_SETS["STRING"]:
                if isinstance(a, LC):
                    return LC(isinstance(a.value, str)
                              and a.value != DEFAULT_INIT)
                if isinstance(a, LE):
                    tab = self.value_pred_table(
                        a.leaf, _named(
                            lambda v: isinstance(v, str)
                            and v != DEFAULT_INIT, ("isstr",)))
                    safe = jnp.maximum(a.arr, 0)
                    return LB(jnp.asarray(tab)[safe] & (a.arr >= 0),
                              a.depth)
            raise CompileError(f"\\in over constant {bv!r}")
        if isinstance(b, LM):
            if isinstance(a, LC):
                i = b.elem_leaf.index.get(a.value)
                if i is None:
                    return LC(False)
                return LB(b.bits[..., i], b.depth)
            ae = self.to_leaf(a, b.elem_leaf)
            d = max(ae.depth, b.depth)
            idx = _align(ae.arr, ae.depth, d)
            bits = b.bits
            for _ in range(d - b.depth):
                bits = bits[..., None, :]
            onehot = jnp.arange(len(b.elem_leaf.values)) == idx[..., None]
            return LB((onehot & bits).any(axis=-1) & (idx >= 0), d)
        raise CompileError(f"\\in over {type(b).__name__}")

    def _subseteq_lv(self, a, b) -> LV:
        if isinstance(b, LM):
            if isinstance(a, LC):
                out = LC(True)
                for x in a.value:
                    out = self._land(out, self._member_lv(LC(x), b))
                return out
            am = self.as_mask(a, like=b)
            if am.elem_leaf is not b.elem_leaf:
                am = self.remask(am, b.elem_leaf)
            x, y, d = _mask_align(am.bits, am.depth, b.bits, b.depth)
            return LB((~x | y).all(axis=-1), d)
        if isinstance(b, LC) and isinstance(b.value, frozenset):
            if isinstance(a, LC):
                return LC(a.value <= b.value)
            if isinstance(a, LM):
                miss = [
                    i for i, v in enumerate(a.elem_leaf.values)
                    if v not in b.value
                ]
                if not miss:
                    return LC(True)
                bad = a.bits[..., jnp.asarray(miss)].any(axis=-1)
                return LB(~bad, a.depth)
        raise CompileError("unsupported \\subseteq operands")

    # -- set algebra -------------------------------------------------------

    def _comp_binop(self, ast, env, ctx) -> LV:
        _, sym, la, ra = ast
        a = self.comp(la, env, ctx)
        b = self.comp(ra, env, ctx)
        if sym in (r"\cup", r"\cap", "\\"):
            am, bm = self._two_masks(a, b)
            if am is None:  # both constant
                from .eval import Evaluator as _E

                return LC({
                    r"\cup": a.value | b.value,
                    r"\cap": a.value & b.value,
                    "\\": a.value - b.value,
                }[sym])
            x, y, d = _mask_align(am.bits, am.depth, bm.bits, bm.depth)
            bits = {r"\cup": x | y, r"\cap": x & y, "\\": x & ~y}[sym]
            return LM(bits, am.elem_leaf, d)
        if sym in ("+", "-", "*"):
            if isinstance(a, LC) and isinstance(b, LC):
                return LC({"+": a.value + b.value,
                           "-": a.value - b.value,
                           "*": a.value * b.value}[sym])
            av = a.arr if isinstance(a, LI) else jnp.asarray(
                int(a.value))[None]
            bv = b.arr if isinstance(b, LI) else jnp.asarray(
                int(b.value))[None]
            x, y, d = _binop_arrs(av, getattr(a, "depth", 0),
                                  bv, getattr(b, "depth", 0))
            ba, bb = _int_bounds(a), _int_bounds(b)
            nb = None
            if ba is not None and bb is not None:
                if sym == "+":
                    nb = (ba[0] + bb[0], ba[1] + bb[1])
                elif sym == "-":
                    nb = (ba[0] - bb[1], ba[1] - bb[0])
                else:
                    cs = [ba[0] * bb[0], ba[0] * bb[1],
                          ba[1] * bb[0], ba[1] * bb[1]]
                    nb = (min(cs), max(cs))
            return LI({"+": x + y, "-": x - y, "*": x * y}[sym], d,
                      bounds=nb)
        if sym == "..":
            if isinstance(a, LC) and isinstance(b, LC):
                return LC(frozenset(range(a.value, b.value + 1)))
            raise CompileError("dynamic .. range")
        if sym == r"\o":
            return self._concat(a, b, ctx)
        if sym == ":>":
            if not isinstance(a, LC):
                raise CompileError(":> with dynamic key")
            return LRec([(a.value, LC(True), b)])
        if sym == "@@":
            return self._merge(a, b)
        raise CompileError(f"cannot compile binop {sym}")

    def _two_masks(self, a, b):
        if isinstance(a, LM):
            bm = b if isinstance(b, LM) else self.as_mask(b, like=a)
            if bm.elem_leaf is not a.elem_leaf:
                bm = self.remask(bm, a.elem_leaf)
            return a, bm
        if isinstance(b, LM):
            am = self.as_mask(a, like=b)
            if am.elem_leaf is not b.elem_leaf:
                am = self.remask(am, b.elem_leaf)
            return am, b
        if isinstance(a, LC) and isinstance(b, LC):
            return None, None
        if isinstance(a, (LSetLit,)) or isinstance(b, (LSetLit,)):
            # resolve the literal against the other side
            if isinstance(a, LSetLit) and isinstance(b, LM):
                return self._setlit_mask(a, b.elem_leaf), b
            if isinstance(b, LSetLit) and isinstance(a, LM):
                return a, self._setlit_mask(b, a.elem_leaf)
        raise CompileError("set operation without a mask operand")

    def _setlit_mask(self, lit: "LSetLit", elem_leaf: EnumLeaf) -> LM:
        bits = None
        depth = 0
        n = len(elem_leaf.values)
        for item in lit.items:
            ie = self.to_leaf(item, elem_leaf)
            oh = (jnp.arange(n) ==
                  _align(ie.arr, ie.depth, ie.depth)[..., None])
            oh = oh & (ie.arr >= 0)[..., None]
            if bits is None:
                bits, depth = oh, ie.depth
            else:
                x, y, depth = _mask_align(bits, depth, oh, ie.depth)
                bits = x | y
        if bits is None:
            bits = jnp.zeros((1, n), bool)
        return LM(bits, elem_leaf, depth)

    def _concat(self, a, b, ctx) -> LSeq:
        if not isinstance(b, LSeq):
            raise CompileError("\\o rhs must be a sequence value")
        if not isinstance(a, LTuple):
            raise CompileError("\\o lhs must be a tuple literal here")
        k = len(a.items)
        new_len = LI(b.length.arr + k, b.length.depth)
        ctx.ovf = self._lor(ctx.ovf, LB(b.length.arr + k > b.cap,
                                        b.length.depth))
        slots = [self.to_leaf(x, b.leaf) for x in a.items]
        slots = slots + b.slots[: b.cap - k] if k < b.cap else \
            slots[: b.cap]
        # zero out beyond new length happens at encode
        return LSeq(new_len, slots, b.leaf, b.cap)

    def _merge(self, a, b) -> LRec:
        """a @@ b, left-biased, over structural records."""
        def as_rec(v):
            if isinstance(v, LRec):
                return v
            if isinstance(v, LE):
                return self.explode(v)
            if isinstance(v, LC):
                if isinstance(v.value, tuple) and (v.value == () or
                                                   is_fn(v.value)):
                    return LRec([
                        (f, LC(True), LC(x)) for f, x in v.value
                    ])
            raise CompileError(f"@@ over {type(v).__name__}")

        ra = as_rec(a)
        rb = as_rec(b)
        entries = []
        names = [f for f, _, _ in ra.entries] + [
            f for f, _, _ in rb.entries
            if all(f != g for g, _, _ in ra.entries)
        ]
        for f in names:
            pa, va = ra.get(f)
            pb, vb = rb.get(f)
            if va is None:
                entries.append((f, pb, vb))
            elif vb is None:
                entries.append((f, pa, va))
            else:
                # present in a wins; where a absent, b's entry shows
                if isinstance(pa, LC) and pa.value is True:
                    entries.append((f, LC(True), va))
                else:
                    pres = self._lor(pa, pb)
                    entries.append((f, pres, self.select(pa, va, vb)))
        return LRec(entries)

    # -- selection ---------------------------------------------------------

    def select(self, c, a, b) -> LV:
        """IF c THEN a ELSE b over lane values."""
        if isinstance(c, LC):
            return a if c.value else b
        if isinstance(a, LC) and isinstance(b, LC) and a.value == b.value:
            return a
        if isinstance(a, LM) or isinstance(b, LM):
            am = a if isinstance(a, LM) else self.as_mask(
                a, like=b if isinstance(b, LM) else None)
            bm = b if isinstance(b, LM) else self.as_mask(b, like=am)
            if bm.elem_leaf is not am.elem_leaf:
                bm = self.remask(bm, am.elem_leaf)
            x, y, d = _mask_align(am.bits, am.depth, bm.bits, bm.depth)
            carr = _align(c.arr, c.depth, d)[..., None]
            return LM(jnp.where(carr, x, y), am.elem_leaf, d)
        if isinstance(a, LRec) and isinstance(b, LRec):
            entries = []
            names = [f for f, _, _ in a.entries]
            for f in names:
                pa, va = a.get(f)
                pb, vb = b.get(f)
                if vb is None:
                    pb, vb = LC(False), va
                entries.append((
                    f,
                    self.select(c, pa, pb) if not (
                        isinstance(pa, LC) and isinstance(pb, LC)
                        and pa.value == pb.value) else pa,
                    self.select(c, va, vb),
                ))
            for f, pb, vb in b.entries:
                if a.get(f)[1] is None:
                    entries.append((f, self.select(c, LC(False), pb), vb))
            return LRec(entries)
        if isinstance(a, LSeq) or isinstance(b, LSeq):
            if not (isinstance(a, LSeq) and isinstance(b, LSeq)):
                raise CompileError("IF mixes sequence and non-sequence")
            ln = self.select(c, a.length, b.length)
            slots = [self.select(c, x, self.to_leaf(y, a.leaf))
                     for x, y in zip(a.slots, b.slots)]
            return LSeq(ln, slots, a.leaf, max(a.cap, b.cap))
        if isinstance(a, LB) or isinstance(b, LB) or (
            isinstance(a, LC) and isinstance(a.value, bool)
        ):
            aa = a.arr if isinstance(a, LB) else jnp.asarray(
                bool(a.value))[None]
            bb = b.arr if isinstance(b, LB) else jnp.asarray(
                bool(b.value))[None]
            x, y, d0 = _binop_arrs(aa, getattr(a, "depth", 0),
                                   bb, getattr(b, "depth", 0))
            carr, x2, d = _binop_arrs(_align(c.arr, c.depth, c.depth),
                                      c.depth, x, d0)
            _, y2, _ = _binop_arrs(carr, d, y, d0)
            return LB(jnp.where(carr, x2, y2), d)
        if isinstance(a, LI) or isinstance(b, LI):
            aa = a.arr if isinstance(a, LI) else jnp.asarray(
                int(a.value))[None]
            bb = b.arr if isinstance(b, LI) else jnp.asarray(
                int(b.value))[None]
            x, y, d0 = _binop_arrs(aa, getattr(a, "depth", 0),
                                   bb, getattr(b, "depth", 0))
            carr, x2, d = _binop_arrs(c.arr, c.depth, x, d0)
            _, y2, _ = _binop_arrs(carr, d, y, d0)
            ba, bb2 = _int_bounds(a), _int_bounds(b)
            hull = (min(ba[0], bb2[0]), max(ba[1], bb2[1])) \
                if ba is not None and bb2 is not None else None
            return LI(jnp.where(carr, x2, y2), d, bounds=hull)
        # enum path: unify through a leaf
        leaf = None
        if isinstance(a, LE):
            leaf = a.leaf
        elif isinstance(b, LE):
            leaf = b.leaf
        if leaf is None:
            raise CompileError(
                f"cannot select between {type(a).__name__} and "
                f"{type(b).__name__}"
            )
        ae = self.to_leaf(a, leaf)
        be = self.to_leaf(b, leaf)
        x, y, d0 = _binop_arrs(ae.arr, ae.depth, be.arr, be.depth)
        carr, x2, d = _binop_arrs(c.arr, c.depth, x, d0)
        _, y2, _ = _binop_arrs(carr, d, y, d0)
        return LE(jnp.where(carr, x2, y2), leaf, d)

    # -- quantifiers / comprehensions / CHOOSE -----------------------------

    def _dom_descriptor(self, dom_ast, env, ctx):
        """Compile a quantifier domain: ("const", values) |
        ("atoms", LM small) | ("mask", LM big)."""
        dom = self.comp(dom_ast, env, ctx)
        if isinstance(dom, LC):
            if not isinstance(dom.value, frozenset):
                raise CompileError("quantifier over non-set constant")
            return ("const", sorted(dom.value, key=repr))
        if isinstance(dom, LM):
            if len(dom.elem_leaf.values) <= UNROLL_LIMIT:
                return ("atoms", dom)
            return ("mask", dom)
        raise CompileError(
            f"quantifier domain {type(dom).__name__} unsupported"
        )

    def _comp_quant(self, ast, env, ctx) -> LV:
        _, names, dom_ast, body = ast
        return self._quant_rec(names, dom_ast, body, env, ctx, "forall"
                               if ast[0] == "forall" else "exists",
                               ast[0])

    def _quant_rec(self, names, dom_ast, body, env, ctx, _ignored, kind):
        if not names:
            return self.comp(body, env, ctx)
        name, rest = names[0], names[1:]
        desc = self._dom_descriptor(dom_ast, env, ctx)
        if desc[0] == "const":
            acc = None
            for v in desc[1]:
                env2 = dict(env)
                env2[name] = LC(v)
                r = self._quant_rec(rest, dom_ast, body, env2, ctx,
                                    None, kind)
                acc = r if acc is None else (
                    self._land(acc, r) if kind == "forall"
                    else self._lor(acc, r))
            return acc if acc is not None else LC(kind == "forall")
        if desc[0] == "atoms":
            m = desc[1]
            acc = None
            for i, v in enumerate(m.elem_leaf.values):
                env2 = dict(env)
                env2[name] = LC(v)
                member = LB(m.bits[..., i], m.depth)
                r = self._quant_rec(rest, dom_ast, body, env2, ctx,
                                    None, kind)
                r = self._lor(self._lnot(member), r) if kind == "forall" \
                    else self._land(member, r)
                acc = r if acc is None else (
                    self._land(acc, r) if kind == "forall"
                    else self._lor(acc, r))
            return acc if acc is not None else LC(kind == "forall")
        # big mask: lift
        m: LM = desc[1]
        lifted, level = self._lift_binder(m)
        env2 = dict(env)
        env2[name] = lifted
        r = self._quant_rec(rest, dom_ast, body, env2, ctx, None, kind)
        return self._quant_reduce(m, r, level, kind)

    def _lift_binder(self, m: LM):
        """New lift axis over m's universe; binder = arange as LE with
        depth = m.depth + 1 (its own axis is the last)."""
        n = len(m.elem_leaf.values)
        level = m.depth + 1
        arange = jnp.arange(n, dtype=jnp.int32).reshape(
            (1,) + (1,) * (level - 1) + (n,)
        )
        return LE(arange, m.elem_leaf, level), level

    def _quant_reduce(self, m: LM, body, level, kind) -> LB:
        if isinstance(body, LC):
            if kind == "forall" and body.value:
                return LC(True)
            if kind == "exists" and not body.value:
                return LC(False)
            # constant-FALSE forall / constant-TRUE exists: reduces to
            # the set's (non-)emptiness
            ne = m.bits.any(axis=-1)
            return LB(ne if kind == "exists" else ~ne, m.depth)
        barr = _align(body.arr, body.depth, level)
        mbits = m.bits  # prefix == level-1, so ranks already agree
        if kind == "forall":
            return LB((~mbits | barr).all(axis=-1), level - 1)
        return LB((mbits & barr).any(axis=-1), level - 1)

    def _comp_setfilter(self, ast, env, ctx) -> LV:
        _, var, dom_ast, pred = ast
        desc = self._dom_descriptor(dom_ast, env, ctx)
        if desc[0] == "const":
            results = []
            for v in desc[1]:
                env2 = dict(env)
                env2[var] = LC(v)
                results.append((v, self.comp(pred, env2, ctx)))
            if all(isinstance(r, LC) for _, r in results):
                return LC(frozenset(v for v, r in results if r.value))
            # state-dependent filter over a constant set (quorum
            # counting: {n \\in Nodes : Len(log[n]) >= k}): a mask over
            # the atom universe with per-element predicate bits
            if not all(isinstance(v, str) for v, _ in results):
                raise CompileError(
                    "state-dependent filter over non-atom constant set"
                )
            leaf = self._leaf_of_shape(
                SAtoms(frozenset(v for v, _ in results))
            )
            depth = max((r.depth for _, r in results
                         if isinstance(r, LB)), default=0)
            cols = [None] * len(leaf.values)
            for v, r in results:
                i = leaf.index[v]
                if isinstance(r, LC):
                    cols[i] = jnp.full((1,) + (1,) * depth, bool(r.value))
                else:
                    cols[i] = _align(r.arr, r.depth, depth)
            bits = jnp.stack(jnp.broadcast_arrays(*cols), axis=-1)
            return LM(bits, leaf, depth)
        m: LM = desc[1]
        if desc[0] == "atoms":
            cols = []
            depth = m.depth
            for i, v in enumerate(m.elem_leaf.values):
                env2 = dict(env)
                env2[var] = LC(v)
                r = self.comp(pred, env2, ctx)
                if isinstance(r, LC):
                    col = m.bits[..., i] if r.value else (
                        m.bits[..., i] & False)
                    cols.append((col, m.depth))
                else:
                    x, y, d = _binop_arrs(m.bits[..., i], m.depth,
                                          r.arr, r.depth)
                    cols.append((x & y, d))
                    depth = max(depth, d)
            arrs = [_align(c, d, depth) for c, d in cols]
            bits = jnp.stack(jnp.broadcast_arrays(*arrs), axis=-1)
            return LM(bits, m.elem_leaf, depth)
        lifted, level = self._lift_binder(m)
        env2 = dict(env)
        env2[var] = lifted
        r = self.comp(pred, env2, ctx)
        if isinstance(r, LC):
            return m if r.value else LM(m.bits & False, m.elem_leaf,
                                        m.depth)
        barr = _align(r.arr, r.depth, level)
        mbits = _mask_align(m.bits, m.depth, barr, level - 1)[0]
        return LM(mbits & barr, m.elem_leaf, level - 1)

    def _comp_setmap(self, ast, env, ctx) -> LV:
        _, expr, var, dom_ast = ast
        desc = self._dom_descriptor(dom_ast, env, ctx)
        if desc[0] != "mask":
            raise CompileError("set map over non-mask domain")
        m: LM = desc[1]
        lifted, level = self._lift_binder(m)
        env2 = dict(env)
        env2[var] = lifted
        r = self.comp(expr, env2, ctx)
        re = self.to_leaf(r, m.elem_leaf)
        idx = _align(re.arr, re.depth, level)
        mbits = _mask_align(m.bits, m.depth, idx, level - 1)[0]
        n = len(m.elem_leaf.values)
        # scatter: out[t] = any_u (bits[u] & idx[u] == t)
        onehot = idx[..., None] == jnp.arange(n)
        bits = (onehot & mbits[..., None]).any(axis=-2)
        return LM(bits, m.elem_leaf, level - 1)

    def _comp_choose(self, ast, env, ctx) -> LV:
        _, var, dom_ast, pred = ast
        desc = self._dom_descriptor(dom_ast, env, ctx)
        if desc[0] != "mask":
            raise CompileError("CHOOSE over non-mask domain")
        m: LM = desc[1]
        lifted, level = self._lift_binder(m)
        env2 = dict(env)
        env2[var] = lifted
        r = self.comp(pred, env2, ctx)
        if isinstance(r, LC):
            sel = m.bits if r.value else m.bits & False
            depth = m.depth
        else:
            barr = _align(r.arr, r.depth, level)
            mbits = _mask_align(m.bits, m.depth, barr, level - 1)[0]
            sel = mbits & barr
            depth = level - 1
        # pick the witness the HOST evaluator picks (eval.py choose: the
        # _SORT_KEY-least satisfying element), not the first set bit in
        # universe enumeration order - with a non-unique predicate the two
        # orders diverge and the engines' state spaces drift apart
        n = len(m.elem_leaf.values)
        rank = jnp.asarray(self.choose_rank_table(m.elem_leaf))
        idx = jnp.argmin(jnp.where(sel, rank, n), axis=-1).astype(jnp.int32)
        ok = sel.any(axis=-1)
        return LE(jnp.where(ok, idx, -1), m.elem_leaf, depth)

    def _comp_except(self, ast, env, ctx) -> LV:
        base = self.comp(ast[1], env, ctx)
        for path_asts, val_ast in ast[2]:
            path = [self.comp(p, env, ctx) for p in path_asts]
            base = self._except_apply(base, path, val_ast, env, ctx)
        return base

    def _except_apply(self, base, path, val_ast, env, ctx):
        idx = path[0]
        if not isinstance(idx, LC):
            raise CompileError("dynamic EXCEPT index")
        key = idx.value
        if isinstance(base, LE):
            base = self.explode(base)
        if isinstance(base, LRec):
            p, old = base.get(key)
            if old is None:
                raise CompileError(f"EXCEPT unknown field {key!r}")
            if len(path) > 1:
                new = self._except_apply(old, path[1:], val_ast, env, ctx)
            else:
                env2 = dict(env)
                env2["@"] = old
                new = self.comp(val_ast, env2, ctx)
            entries = [
                (f, pp, new if f == key else vv)
                for f, pp, vv in base.entries
            ]
            return LRec(entries)
        raise CompileError(
            f"EXCEPT on {type(base).__name__}"
        )

    def _comp_call(self, ast, env, ctx) -> LV:
        _, name, args = ast
        d = env.get(name)
        if not isinstance(d, Definition):
            d = self.ev.defs.get(name)
        if isinstance(d, Definition):
            env2 = dict(env)
            for p, a in zip(d.params, args):
                env2[p] = self.comp(a, env, ctx)
            return self.comp(d.body, env2, ctx)
        vals = [self.comp(a, env, ctx) for a in args]
        if name == "Cardinality":
            (s,) = vals
            if isinstance(s, LC):
                return LC(len(s.value))
            m = self.as_mask(s)
            return LI(m.bits.sum(axis=-1).astype(jnp.int32), m.depth,
                      bounds=(0, len(m.elem_leaf.values)))
        if name == "Len":
            (s,) = vals
            if isinstance(s, LSeq):
                return s.length
            raise CompileError("Len of non-sequence")
        if name == "Head":
            (s,) = vals
            if isinstance(s, LSeq):
                return s.slots[0]
            raise CompileError("Head of non-sequence")
        if name == "Tail":
            (s,) = vals
            if isinstance(s, LSeq):
                lb = s.length.bounds
                ln = LI(jnp.maximum(s.length.arr - 1, 0),
                        s.length.depth,
                        bounds=(max(lb[0] - 1, 0), max(lb[1] - 1, 0))
                        if lb is not None else None)
                zero = LE(jnp.zeros((1,), jnp.int32), s.leaf, 0)
                return LSeq(ln, s.slots[1:] + [zero], s.leaf, s.cap)
            raise CompileError("Tail of non-sequence")
        if name == "Append":
            s, e = vals
            if not isinstance(s, LSeq):
                raise CompileError("Append to non-sequence")
            ee = self.to_leaf(e, s.leaf)
            ctx.ovf = self._lor(ctx.ovf, LB(s.length.arr + 1 > s.cap,
                                            s.length.depth))
            slots = []
            for i in range(s.cap):
                at_i = LB(s.length.arr == i, s.length.depth)
                slots.append(self.select(at_i, ee, s.slots[i]))
            lb = s.length.bounds
            return LSeq(LI(s.length.arr + 1, s.length.depth,
                           bounds=(lb[0] + 1, lb[1] + 1)
                           if lb is not None else None), slots,
                        s.leaf, s.cap)
        if name == "Assert":
            cond, _msg = vals
            if isinstance(cond, LC):
                if cond.value is not True:
                    ctx.afail = LC(True)
            else:
                ctx.afail = self._lor(ctx.afail, self._lnot(cond))
            return LC(True)
        raise CompileError(f"unknown operator {name!r}")

    def _comp_fnlit(self, ast, env, ctx) -> LV:
        _, var, dom_ast, body = ast
        dom = self.comp(dom_ast, env, ctx)
        if isinstance(dom, LC) and isinstance(dom.value, frozenset):
            entries = []
            for v in sorted(dom.value, key=repr):
                env2 = dict(env)
                env2[var] = LC(v)
                entries.append((v, LC(True), self.comp(body, env2, ctx)))
            return LRec(entries)
        raise CompileError("function literal over dynamic domain")


    # ======================================================================
    # State decode / encode
    # ======================================================================

    def decode_state(self, fields) -> Dict[str, LV]:
        """fields [B, F] int32 -> {var: LV} (batch-resident values)."""
        out: Dict[str, LV] = {}
        pos = 0
        for v, lay in zip(self.variables, self.codec.layouts):
            lv, pos = self._decode_layout(lay, fields, pos,
                                          self.var_shapes[v])
            out[v] = lv
        return out

    def _decode_layout(self, lay, fields, pos, shape):
        if isinstance(lay, EnumLeaf):
            lv = LE(fields[:, pos], lay, 0)
            # committed-state fields hold legal codes (encode traps
            # enforce it; certificate mode re-verifies on device), so
            # the decoded int view carries certified bounds
            return self._from_leaf(lv, shape, trusted=True), pos + 1
        if isinstance(lay, MaskLeaf):
            cols = []
            for gi, w in enumerate(lay.widths):
                word = fields[:, pos + gi]
                for b in range(w):
                    cols.append((word >> b) & 1)
            bits = jnp.stack(cols, axis=-1) == 1
            return LM(bits, lay.elem, 0), pos + lay.n_fields
        if isinstance(lay, RecNode):
            entries = []
            for (f, opt, child), (fs, fsh, fopt) in zip(
                lay.entries, lay.shape.fields
            ):
                if opt:
                    pres = LB(fields[:, pos] == 1, 0)
                    pos += 1
                else:
                    pres = LC(True)
                val, pos = self._decode_layout(child, fields, pos, fsh)
                entries.append((f, pres, val))
            return LRec(entries), pos
        if isinstance(lay, SeqNode):
            length = LI(fields[:, pos], 0, bounds=(0, lay.cap))
            pos += 1
            slots = []
            for _ in range(lay.cap):
                slots.append(LE(fields[:, pos], lay.elem, 0))
                pos += 1
            return LSeq(length, slots, lay.elem, lay.cap), pos
        raise CompileError(f"cannot decode layout {type(lay).__name__}")

    def encode_var(self, lv, lay, shape, B, ctx) -> List:
        """LV -> list of [B] int32 field arrays matching the layout."""
        if lv == "passthrough":
            raise CompileError("passthrough handled by caller")
        if isinstance(lay, EnumLeaf):
            le = self.to_leaf(lv, lay)
            arr = jnp.broadcast_to(_to_b(le.arr, B), (B,))
            ctx.trap = self._lor(ctx.trap, LB(arr < 0, 0))
            return [jnp.maximum(arr, 0)]
        if isinstance(lay, MaskLeaf):
            m = self.as_mask(lv, like=LM(jnp.zeros(
                (1, len(lay.elem.values)), bool), lay.elem, 0))
            if m.elem_leaf is not lay.elem:
                m = self.remask(m, lay.elem)
            if m.depth != 0:
                raise CompileError("lifted mask at encode")
            bits = jnp.broadcast_to(m.bits, (B, len(lay.elem.values)))
            out = []
            off = 0
            for w in lay.widths:
                weights = jnp.asarray([1 << i for i in range(w)],
                                      jnp.int32)
                out.append(
                    (bits[:, off:off + w].astype(jnp.int32) * weights)
                    .sum(axis=-1)
                )
                off += w
            return out
        if isinstance(lay, RecNode):
            rec = lv
            if isinstance(rec, LE):
                rec = self.explode(rec)
            if isinstance(rec, LC):
                rec = LRec([
                    (f, LC(True), LC(x)) for f, x in rec.value
                ])
            if not isinstance(rec, LRec):
                raise CompileError(
                    f"cannot encode {type(lv).__name__} as record"
                )
            out = []
            for f, opt, child in lay.entries:
                fsh = lay.shape.field(f)[0]
                p, v = rec.get(f)
                if v is None:
                    p = LC(False)
                if opt:
                    parr = (jnp.broadcast_to(_to_b(p.arr, B), (B,))
                            if isinstance(p, LB)
                            else jnp.full((B,), bool(p.value)))
                    out.append(parr.astype(jnp.int32))
                else:
                    if isinstance(p, LC) and p.value is False:
                        raise CompileError(f"required field {f} absent")
                    parr = None
                if v is None:
                    out.extend([jnp.zeros((B,), jnp.int32)]
                               * child.n_fields)
                else:
                    sub = self.encode_var(v, child, fsh, B, ctx)
                    if opt:
                        mask = parr == 1
                        sub = [jnp.where(mask, s, 0) for s in sub]
                    out.extend(sub)
            return out
        if isinstance(lay, SeqNode):
            if not isinstance(lv, LSeq):
                raise CompileError("cannot encode non-sequence")
            ln = jnp.broadcast_to(_to_b(lv.length.arr, B), (B,))
            ln = jnp.clip(ln, 0, lay.cap)
            out = [ln.astype(jnp.int32)]
            for i in range(lay.cap):
                se = self.to_leaf(lv.slots[i], lay.elem) \
                    if i < len(lv.slots) else LE(
                        jnp.zeros((1,), jnp.int32), lay.elem, 0)
                arr = jnp.broadcast_to(_to_b(se.arr, B), (B,))
                live = i < ln
                ctx.trap = self._lor(ctx.trap, LB(live & (arr < 0), 0))
                out.append(jnp.where(live, jnp.maximum(arr, 0), 0))
            return out
        raise CompileError(f"cannot encode layout {type(lay).__name__}")

    # ======================================================================
    # Lane walker (compile-time nondeterminism fan-out)
    # ======================================================================

    def walk_lanes(self, next_ast, env0) -> List["Lane"]:
        lanes: List[Lane] = []
        ctx = LaneCtx()
        self._walk(next_ast, dict(env0), ctx, None, lanes)
        return lanes

    def _walk(self, ast, env, ctx, label, out):
        op = ast[0]
        if op == "and":
            self._walk_seq(list(ast[1]), 0, env, ctx, label, out)
            return
        self._walk_seq([ast], 0, env, ctx, label, out)

    def _cov_on(self) -> bool:
        return self.cov is not None and self.cov.active

    def _walk_seq(self, items, i, env, ctx, label, out):
        if i == len(items):
            if self._cov_on():
                # update-conjunct sites log once per completed
                # successor path: the lane's full guard is exactly
                # "this path fires for this state"
                for idx in ctx.cov_effects:
                    self.cov.hit(idx, ctx.guard)
            out.append(Lane(label or "?", env, ctx))
            return
        ast = items[i]
        rest = items[i + 1:]
        op = ast[0]
        if op == "and":
            self._walk_seq(list(ast[1]) + rest, 0, env, ctx, label, out)
            return
        if op == "or":
            for branch in ast[1]:
                self._walk_seq([branch] + rest, 0, dict(env),
                               ctx.fork(), label, out)
            return
        if op == "exists":
            self._walk_exists(ast, rest, env, ctx, label, out)
            return
        if op == "if":
            cond = self.comp(ast[1], env, ctx)
            if isinstance(cond, LC):
                self._walk_seq([ast[2] if cond.value else ast[3]] + rest,
                               0, env, ctx, label, out)
                return
            for guard, branch, arm in ((cond, ast[2], "THEN"),
                                       (self._lnot(cond), ast[3],
                                        "ELSE")):
                c2 = ctx.fork()
                c2.guard = self._land(c2.guard, guard)
                if self._cov_on():
                    # branch-arm site: visited once per state whose
                    # path selects this arm (reach AND the arm guard)
                    self.cov.hit(
                        self.cov.site(label, "branch", branch, arm),
                        c2.guard,
                    )
                self._walk_seq([branch] + rest, 0, dict(env), c2, label,
                               out)
            return
        if op == "let":
            env2 = dict(env)
            for name, params, body in ast[1]:
                if params:
                    env2[name] = Definition(name, params, body)
                else:
                    env2[name] = self.comp(body, env2, ctx)
            self._walk_seq([ast[2]] + rest, 0, env2, ctx, label, out)
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
                    env2[p] = self.comp(a, env, ctx)
                inner = label if d.body[0] == "or" else dname
                self._walk_seq([d.body] + rest, 0, env2, ctx, inner, out)
                return
        if op == "unchanged":
            from .actions import expand_unchanged

            env2 = dict(env)
            for v in expand_unchanged(ast[1], self.ev.defs,
                                      set(self.variables)):
                env2[("'", v)] = "passthrough"
            if self._cov_on():
                ctx.cov_effects.append(self.cov.site(
                    label, "unchanged", ast,
                    "UNCHANGED " + ", ".join(ast[1])))
            self._walk_seq(rest, 0, env2, ctx, label, out)
            return
        if op == "cmp" and ast[1] == "=" and ast[2][0] == "prime":
            name = ast[2][1]
            val = self.comp(ast[3], env, ctx)
            key = ("'", name)
            env2 = dict(env)
            if key in env:
                prev = env[key]
                prev_lv = env[name] if prev == "passthrough" else prev
                ctx.guard = self._land(ctx.guard, self.eq(prev_lv, val))
            else:
                env2[key] = val
            if self._cov_on():
                ctx.cov_effects.append(self.cov.site(
                    label, "effect", ast, f"{name}' :="))
            self._walk_seq(rest, 0, env2, ctx, label, out)
            return
        # plain guard conjunct: the site logs at the reach of THIS
        # conjunct (the guard-so-far, TLC's short-circuit discipline)
        if self._cov_on():
            self.cov.hit(self.cov.site(label, "guard", ast), ctx.guard)
        g = self.comp(ast, env, ctx)
        if isinstance(g, LC):
            if g.value is True:
                self._walk_seq(rest, 0, env, ctx, label, out)
            elif g.value is not False:
                raise CompileError("guard is not BOOLEAN")
            return
        ctx.guard = self._land(ctx.guard, g)
        self._walk_seq(rest, 0, self._refine_guard_env(ast, env), ctx,
                       label, out)

    def _refine_guard_env(self, ast, env):
        """Bare-variable interval refinement under a lane guard: after
        `x < N` joins the lane guard, x's certified interval within
        THIS lane meets the comparison (sound for trap elision: the
        elided trap is ANDed with the lane's validity, which includes
        exactly this guard - build_step's `ovf & valid`)."""
        if not (isinstance(ast, tuple) and len(ast) == 4
                and ast[0] == "cmp"):
            return env
        _, sym, la, ra = ast
        for lhs, rhs, s in ((la, ra, sym),
                            (ra, la, {"<": ">", ">": "<", "<=": ">=",
                                      ">=": "<="}.get(sym, sym))):
            if not (isinstance(lhs, tuple) and lhs[0] == "name"):
                continue
            lv = env.get(lhs[1])
            if not isinstance(lv, LI) or lv.bounds is None:
                continue
            try:
                rb = _int_bounds(self.comp(rhs, env, LaneCtx()))
            except (ValueError, KeyError, TypeError):
                continue
            if rb is None:
                continue
            lo, hi = lv.bounds
            if s == "<":
                hi = min(hi, rb[1] - 1)
            elif s == "<=":
                hi = min(hi, rb[1])
            elif s == ">":
                lo = max(lo, rb[0] + 1)
            elif s == ">=":
                lo = max(lo, rb[0])
            elif s == "=":
                lo, hi = max(lo, rb[0]), min(hi, rb[1])
            else:
                continue
            if lo <= hi:
                env = dict(env)
                env[lhs[1]] = LI(lv.arr, lv.depth, bounds=(lo, hi))
        return env

    def _walk_exists(self, ast, rest, env, ctx, label, out):
        _, names, dom_ast, body = ast
        if len(names) != 1:
            raise CompileError("multi-binder \\E in action position")
        name = names[0]
        desc = self._dom_descriptor(dom_ast, env, ctx)
        cov_idx = None
        if self._cov_on():
            # binder-body site: one visit per (state, live binding) -
            # the quantifier-body count of TLC's dump
            cov_idx = self.cov.site(label, "quant", ast, f"\\E {name}")
        if desc[0] == "const":
            for v in desc[1]:
                env2 = dict(env)
                env2[name] = LC(v)
                c2 = ctx.fork()
                if cov_idx is not None:
                    self.cov.hit(cov_idx, c2.guard)
                self._walk_seq([body] + rest, 0, env2, c2,
                               label, out)
            return
        m: LM = desc[1]
        if m.depth != 0:
            raise CompileError("lifted set in action-position \\E")
        if desc[0] == "atoms":
            for i, v in enumerate(m.elem_leaf.values):
                env2 = dict(env)
                env2[name] = LC(v)
                c2 = ctx.fork()
                c2.guard = self._land(c2.guard, LB(m.bits[..., i], 0))
                if cov_idx is not None:
                    self.cov.hit(cov_idx, c2.guard)
                self._walk_seq([body] + rest, 0, env2, c2, label, out)
            return
        # record-universe set: k-th set-bit slot lanes.  A certified
        # cardinality bound on a bare-variable domain (analysis.absint
        # TrapPolicy) shrinks the lane fan to the bound and - when the
        # bound fits the slot budget - elides the overflow trap: lanes
        # k >= |set| are never valid, so dropping them is count-exact,
        # and the runtime certificate column re-verifies the bound
        # (popcount of the committed mask) on device
        slot_cap = SLOT_CAP
        card = None
        if self.trap_policy is not None and dom_ast[0] == "name":
            card = self.trap_policy.card_bounds.get(dom_ast[1])
        if card is not None and card < SLOT_CAP:
            self.reduced_slot_lanes += SLOT_CAP - card
            slot_cap = max(card, 1)
        counts = m.bits.astype(jnp.int32).cumsum(axis=-1)
        total = counts[..., -1]
        self.trap_sites += 1
        proven = card is not None and card <= slot_cap
        if proven:
            self.elided_traps += 1
        for k in range(slot_cap):
            sel = m.bits & (counts == k + 1)
            idx = jnp.argmax(sel, axis=-1).astype(jnp.int32)
            has = sel.any(axis=-1)
            env2 = dict(env)
            env2[name] = self._from_leaf(
                LE(jnp.where(has, idx, -1), m.elem_leaf, 0),
                m.elem_leaf.shape,
            )
            c2 = ctx.fork()
            c2.guard = self._land(c2.guard, LB(has, 0))
            if cov_idx is not None:
                self.cov.hit(cov_idx, c2.guard)
            if not proven:
                c2.ovf = self._lor(c2.ovf, LB(total > slot_cap, 0))
            self._walk_seq([body] + rest, 0, env2, c2, label, out)

    # ======================================================================
    # Step function
    # ======================================================================

    def build_step(self, next_ast):
        """step(fields [B,F] int32) ->
        (succs [B,L,F], valid [B,L], ovf [B,L], afail [B,L]); also sets
        self.labels (per-lane action names) on first run."""
        self.labels: Optional[List[str]] = None

        def step(fields):
            B = fields.shape[0]
            # trap accounting restarts per trace so retraces (eval_shape
            # then jit) report one compile's numbers, not a running sum
            self.trap_sites = 0
            self.elided_traps = 0
            self.reduced_slot_lanes = 0
            env0 = dict(self.decode_state(fields))
            lanes = self.walk_lanes(next_ast, env0)
            labels = []
            succ_cols, valids, ovfs, afails = [], [], [], []
            for lane in lanes:
                labels.append(lane.label)
                cols = []
                for v, lay in zip(self.variables, self.codec.layouts):
                    lv = lane.env.get(("'", v))
                    if lv is None and v in self.sweep_vars:
                        # a swept constant is unchanged by construction
                        lv = "passthrough"
                    if lv is None:
                        raise CompileError(
                            f"lane {lane.label}: {v}' unassigned"
                        )
                    if lv == "passthrough":
                        off = self.codec.offsets[v]
                        for j in range(lay.n_fields):
                            cols.append(fields[:, off + j])
                    else:
                        cols.extend(self.encode_var(
                            lv, lay, self.var_shapes[v], B, lane.ctx))
                succ_cols.append(jnp.stack(cols, axis=-1))
                valids.append(self._guard_arr(lane.ctx.guard, B))
                # overflow/trap only matter when the lane actually
                # fires (a guard-disabled Append past cap is harmless);
                # trap = semantic escape (a value fell outside the
                # inferred universe) - both halt the run loudly
                ovfs.append(
                    (self._guard_arr(lane.ctx.ovf, B)
                     | self._guard_arr(lane.ctx.trap, B)) & valids[-1]
                )
                afails.append(self._guard_arr(lane.ctx.afail, B)
                              & valids[-1])
            if self.labels is None:
                self.labels = labels
            succs = jnp.stack(succ_cols, axis=1)
            valid = jnp.stack(valids, axis=1)
            ovf = jnp.stack(ovfs, axis=1)
            afail = jnp.stack(afails, axis=1)
            return succs, valid, ovf, afail

        return step

    def _guard_arr(self, g, B):
        if isinstance(g, LC):
            return jnp.full((B,), bool(g.value))
        if g.depth != 0:
            raise CompileError("lane guard kept a lift axis")
        return jnp.broadcast_to(_to_b(g.arr, B), (B,))

    def build_cov(self, next_ast):
        """The device coverage plane's visit conditions:
        ``cov_fn(fields [B,F]) -> (idxs, conds)``, one bool [B] node per
        contribution and its site index (the reference's cov_fn,
        jaxtlc/struct/compile.py:2224, before its stack, masked matvec and
        scatter-add, which the coverage plane and kernel K22 do).

        The instrumented walk re-derives only the lane GUARD structure
        (no successor encode), from the same pure functions of the state
        fields the step evaluates (the hash-consed lane IR shares their
        nodes); the site table is discovered on the first walk
        (self.cov.sites) and stable across walks."""
        self.cov = CovCollector()

        def cov_fn(fields):
            B = fields.shape[0]
            saved = (self.trap_sites, self.elided_traps,
                     self.reduced_slot_lanes)
            self.cov.begin()
            try:
                env0 = dict(self.decode_state(fields))
                self.walk_lanes(next_ast, env0)
            finally:
                contribs = self.cov.end()
                (self.trap_sites, self.elided_traps,
                 self.reduced_slot_lanes) = saved
            idxs, conds = [], []
            for idx, cond in contribs:
                if isinstance(cond, LC):
                    if not cond.value:
                        continue
                    arr = jnp.full((B,), True)
                else:
                    if cond.depth != 0:
                        raise CompileError(
                            "coverage condition kept a lift axis"
                        )
                    arr = jnp.broadcast_to(_to_b(cond.arr, B), (B,))
                idxs.append(idx)
                conds.append(arr)
            return idxs, conds

        return cov_fn

    def build_invariant(self, ast):
        """inv(fields [B,F]) -> ok [B] bool."""

        def inv(fields):
            B = fields.shape[0]
            env = dict(self.decode_state(fields))
            ctx = LaneCtx()
            r = self.comp(ast, env, ctx)
            return self._guard_arr(r, B)

        return inv


class LaneCtx:
    def __init__(self):
        self.guard = LC(True)
        self.ovf = LC(False)
        self.afail = LC(False)
        self.trap = LC(False)
        # coverage: update-conjunct site ids pending this path's
        # completion (resolved against the final lane guard)
        self.cov_effects: List[int] = []

    def fork(self) -> "LaneCtx":
        c = LaneCtx()
        c.guard = self.guard
        c.ovf = self.ovf
        c.afail = self.afail
        c.trap = self.trap
        c.cov_effects = list(self.cov_effects)
        return c


class Lane:
    def __init__(self, label, env, ctx):
        self.label = label
        self.env = env
        self.ctx = ctx


def _to_b(arr, B):
    """[1]- or [B]-shaped array -> broadcastable to [B]."""
    if arr.ndim == 0:
        return arr[None]
    return arr


class LSetLit(LV):
    """Unresolved set literal with dynamic elements ({Write(...)})."""

    def __init__(self, items):
        self.items = items


class LTuple(LV):
    """Unresolved tuple literal (<<frame>> before \\o)."""

    def __init__(self, items):
        self.items = items


def _named(fn, key):
    fn._key = key
    fn.__name__ = "pred"
    return fn


def _mask_align(a_bits, a_pre, b_bits, b_pre):
    """Align two mask bit planes: insert lift axes BEFORE the trailing
    universe axis so both reach the same prefix depth."""
    pre = max(a_pre, b_pre)

    def fix(bits, p):
        for _ in range(pre - p):
            bits = bits[..., None, :]
        return bits

    return fix(a_bits, a_pre), fix(b_bits, b_pre), pre
