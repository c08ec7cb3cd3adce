"""State-space reduction: symmetry canonicalization and singleton
ample-set pruning (port of jaxtlc/engine/reduce.py).

Two sound prunings, both applied inside the expand stage, so every
engine that goes through it (fused, pipelined, spill, phase-timed,
covered, narrowed, deferred, sharded) inherits them:

* **Symmetry reduction** - every successor is replaced by the
  lexicographically least member of its orbit under the verified
  symmetric constant sets (analysis.symfind) BEFORE it is checked,
  packed and fingerprinted, so the fingerprint set dedups orbit
  representatives.  Each non-identity permutation of the group compiles
  to a static *field program* over the codec's flat [N, F] int32 fields
  (an optional whole-field gather, per-field remap tables with
  canonical-zero guards, mask bit permutations), and the canonical form
  is a running lexicographic minimum over the programs applied to the
  ORIGINAL fields.  On the card this is kernel K24 ``struct_canon``
  (torchtlc/kernels/csrc/struct_reduce.cuh: its row function inside K17
  and K21, and a standalone launch); ``ReducePlan.canon`` is its plain
  version (torch), ``ReducePlan.canon_host`` the numpy one that seeds the
  sharded frontier.

* **POR (singleton ample sets)** - where a state enables an action the
  static analysis proved independent of everything, invisible and
  cycle-safe (symfind.safe_por_actions), only that action's lanes are
  kept.  Kernel K26 ``struct_por_keep`` (a row function inside K17 and
  K21, and a standalone launch); ``por_keep`` is its plain version.  The
  deadlock test, afail and ovf read the pre-pruning lanes.

A wrong permutation table would silently corrupt the dedup, so symmetry
runs certify themselves: every single-device body takes its first valid
canonical candidate, applies every group element to it, re-canonicalizes
each image and latches a mismatch into a sticky flag (the carry's
``sym_viol``, the ring's COL_SYM) - kernel K25 ``struct_orbit_check``,
whose plain version is ``ReducePlan.orbit_check``.
``TORCHTLC_DEBUG_SYM_LIE=1`` corrupts one remap table at plan build so
the trip wire itself is testable (the reference reads
``JAXTLC_DEBUG_SYM_LIE``).

Field-program invariants (as in the reference):

* Programs always apply to the ORIGINAL fields; the group property makes
  min over {pi(s) : pi in G} the orbit's canonical form, so no
  composition of programs is needed.
* Canonical zeros stay zero: SeqNode slots past the length and absent
  optional RecNode children are zero-filled by the codec, so their remap
  tables are guarded (``len > k`` / presence field nonzero); a mask bit
  permutation needs no guard.  A guard reads its column as it stands
  when its table is applied (after the gather and the earlier tables).
* A permutation of record FIELD NAMES (a function over a symmetric domain
  that fell back to RecNode) moves whole field blocks; that is only
  realisable when the moved siblings share one layout object, otherwise
  the set is rejected at plan build.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..struct.codec import (
    MASK_BITS_PER_FIELD,
    EnumLeaf,
    MaskLeaf,
    RecNode,
    SeqNode,
)
from ..struct.eval import is_fn


class RejectSet(Exception):
    """A candidate symmetric set's permutation cannot be realised as a
    codec field program (permuted value outside an enumerated universe,
    unequal sibling layouts under permuted field names); the caller
    drops the set and reports why."""


def permute_value(v, pmap: Dict[str, str]):
    """Apply an atom permutation to an evaluator value, mirroring the
    evaluator's own conventions (struct.eval): atoms are strings,
    records/functions are key-sorted tuples of (str, value) pairs
    (is_fn), sets are frozensets, sequences plain tuples."""
    if isinstance(v, str):
        return pmap.get(v, v)
    if isinstance(v, frozenset):
        return frozenset(permute_value(x, pmap) for x in v)
    if isinstance(v, tuple):
        if v and is_fn(v):
            return tuple(sorted(
                (permute_value(k, pmap), permute_value(x, pmap))
                for k, x in v
            ))
        return tuple(permute_value(x, pmap) for x in v)
    return v


class _PermProgram(NamedTuple):
    """One permutation as a static transform of the flat [N, F] fields:
    an optional whole-field gather (record field-name moves), per-field
    remap tables with canonical-zero guards, and per-mask bit
    permutations."""

    src: Optional[np.ndarray]  # [F] int32 dest<-src gather, None=identity
    tables: tuple  # ((field, np table, guards), ...) post-gather fields
    masks: tuple  # ((offset, widths, sigma), ...) bit i -> bit sigma[i]


def _enum_table(leaf: EnumLeaf,
                pmap: Dict[str, str]) -> Optional[np.ndarray]:
    tbl = np.arange(len(leaf.values), dtype=np.int32)
    changed = False
    for i, v in enumerate(leaf.values):
        pv = permute_value(v, pmap)
        if pv == v:
            continue
        j = leaf.index.get(pv)
        if j is None:
            raise RejectSet(
                f"permuted value {pv!r} falls outside the enumerated "
                "universe (shape not closed under the permutation)"
            )
        tbl[i] = j
        changed = True
    return tbl if changed else None


def _mask_sigma(leaf: MaskLeaf,
                pmap: Dict[str, str]) -> Optional[Tuple[int, ...]]:
    elem = leaf.elem
    sigma = list(range(leaf.n_bits))
    changed = False
    for i, v in enumerate(elem.values):
        pv = permute_value(v, pmap)
        if pv == v:
            continue
        j = elem.index.get(pv)
        if j is None:
            raise RejectSet(
                f"permuted set element {pv!r} outside the mask universe"
            )
        sigma[i] = j
        changed = True
    return tuple(sigma) if changed else None


def _emit(lay, off: int, pmap, prog: dict, guards: tuple) -> int:
    """Walk one layout at flat offset `off`, appending transform pieces
    for `pmap` to `prog`; returns the offset past the layout."""
    if isinstance(lay, EnumLeaf):
        tbl = _enum_table(lay, pmap)
        if tbl is not None:
            prog["tables"].append((off, tbl, guards))
        return off + 1
    if isinstance(lay, MaskLeaf):
        sigma = _mask_sigma(lay, pmap)
        if sigma is not None:
            prog["masks"].append((off, tuple(lay.widths), sigma))
        return off + lay.n_fields
    if isinstance(lay, SeqNode):
        tbl = _enum_table(lay.elem, pmap)
        if tbl is not None:
            for k in range(lay.cap):
                # padding slots past the length are canonical zeros
                prog["tables"].append(
                    (off + 1 + k, tbl, guards + (("len", off, k),))
                )
        return off + lay.n_fields
    if isinstance(lay, RecNode):
        spans = []  # (name, opt, child, start offset incl presence bit)
        o = off
        for name, opt, child in lay.entries:
            spans.append((name, opt, child, o))
            o += (1 if opt else 0) + child.n_fields
        by_name = {name: (opt, child, s) for name, opt, child, s in spans}
        for name, opt, child, start in spans:
            dst = pmap.get(name, name)
            if dst != name:
                # function over a symmetric domain in RecNode fallback:
                # move the whole field block entry `name` -> entry `dst`
                if dst not in by_name:
                    raise RejectSet(
                        f"record field {dst} missing (domain not "
                        "closed under the permutation)"
                    )
                d_opt, d_child, d_start = by_name[dst]
                if d_opt != opt or d_child is not child:
                    raise RejectSet(
                        f"record fields {name}/{dst} have different "
                        "layouts; block move not realisable"
                    )
                n = (1 if opt else 0) + child.n_fields
                for t in range(n):
                    prog["src"][d_start + t] = start + t
        for name, opt, child, start in spans:
            # recurse at the DESTINATION span: after the gather these
            # fields hold the source entry's codes, and content remaps
            # (atoms inside the child) apply post-gather
            g = guards + ((("opt", start),) if opt else ())
            o2 = _emit(child, start + (1 if opt else 0), pmap, prog, g)
            assert o2 == start + (1 if opt else 0) + child.n_fields
        return o
    raise RejectSet(f"no field program for layout {type(lay).__name__}")


class _NumpyXP:
    """The array operations the programs use, on numpy arrays."""

    asarray = staticmethod(np.asarray)
    clip = staticmethod(np.clip)
    where = staticmethod(np.where)
    zeros_like = staticmethod(np.zeros_like)
    take = staticmethod(np.take)

    @staticmethod
    def zeros(shape, dtype):
        return np.zeros(shape, dtype)

    @staticmethod
    def ones(shape, dtype):
        return np.ones(shape, dtype)

    @staticmethod
    def stack(xs, axis):
        return np.stack(xs, axis=axis)


class _TorchXP:
    """The same operations on torch tensors on one device."""

    def __init__(self, device):
        self.device = device

    def asarray(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    clip = staticmethod(torch.clip)
    where = staticmethod(torch.where)
    zeros_like = staticmethod(torch.zeros_like)

    @staticmethod
    def take(t, idx):
        return t[idx.long()]

    def zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=torch.bool, device=self.device)

    def ones(self, shape, dtype):
        return torch.ones(shape, dtype=torch.bool, device=self.device)

    @staticmethod
    def stack(xs, axis):
        return torch.stack(xs, dim=axis)


def _xp(flat):
    return _TorchXP(flat.device) if isinstance(flat, torch.Tensor) \
        else _NumpyXP


def _apply_program(prog: _PermProgram, flat, xp) -> list:
    """Apply one permutation program to flat [N, F]; returns the F
    per-field columns (xp: _TorchXP for the plain version of K24 on a
    device, _NumpyXP for the host twin)."""
    F = flat.shape[-1]
    cols = [flat[..., j] for j in range(F)]
    if prog.src is not None:
        cols = [cols[int(prog.src[j])] for j in range(F)]
    for field, tbl, guards in prog.tables:
        t = xp.asarray(tbl)
        nv = xp.take(t, xp.clip(cols[field], 0, len(tbl) - 1))
        if guards:
            cond = None
            for g in guards:
                c = (cols[g[1]] > g[2]) if g[0] == "len" \
                    else (cols[g[1]] != 0)
                cond = c if cond is None else (cond & c)
            nv = xp.where(cond, nv, cols[field])
        cols[field] = nv
    for off, widths, sigma in prog.masks:
        newf = [xp.zeros_like(cols[off]) for _ in widths]
        for i, d in enumerate(sigma):
            bit = (cols[off + i // MASK_BITS_PER_FIELD]
                   >> (i % MASK_BITS_PER_FIELD)) & 1
            fi, bo = d // MASK_BITS_PER_FIELD, d % MASK_BITS_PER_FIELD
            newf[fi] = newf[fi] | (bit << bo)
        for fi in range(len(widths)):
            cols[off + fi] = newf[fi]
    return cols


class ReducePlan:
    """Compiled symmetry group over one codec: a field program per
    non-identity permutation plus the tournament canonicalizer."""

    def __init__(self, cdc, sym_sets: Dict[str, Tuple[str, ...]],
                 lie: Optional[bool] = None):
        self.cdc = cdc
        self.sym_sets = {k: tuple(v) for k, v in sym_sets.items()}
        bases = [tuple(sorted(a)) for a in self.sym_sets.values()]
        pmaps: List[Dict[str, str]] = []
        for combo in itertools.product(
                *[list(itertools.permutations(b)) for b in bases]):
            pmap = {}
            for base, perm in zip(bases, combo):
                pmap.update(
                    {a: p for a, p in zip(base, perm) if a != p}
                )
            if pmap:
                pmaps.append(pmap)
        self.n_perms = len(pmaps) + 1  # group order incl identity
        self.programs = [self._build(p) for p in pmaps]
        if lie is None:
            lie = os.environ.get("TORCHTLC_DEBUG_SYM_LIE", "") == "1"
        if lie:
            self._inject_lie()

    def _build(self, pmap: Dict[str, str]) -> _PermProgram:
        prog = {
            "src": np.arange(self.cdc.n_fields, dtype=np.int32),
            "tables": [],
            "masks": [],
        }
        off = 0
        for lay in self.cdc.layouts:
            off = _emit(lay, off, pmap, prog, ())
        assert off == self.cdc.n_fields
        moved = not np.array_equal(
            prog["src"], np.arange(self.cdc.n_fields, dtype=np.int32)
        )
        return _PermProgram(
            src=prog["src"] if moved else None,
            tables=tuple(prog["tables"]),
            masks=tuple(prog["masks"]),
        )

    def _inject_lie(self) -> None:
        """Debug hook: swap two entries of the first remap table so the
        plan is no longer a group action - the orbit check must trip."""
        for i, p in enumerate(self.programs):
            for j, (field, tbl, guards) in enumerate(p.tables):
                if len(tbl) >= 2:
                    bad = tbl.copy()
                    bad[[0, 1]] = bad[[1, 0]]
                    tables = list(p.tables)
                    tables[j] = (field, bad, guards)
                    self.programs[i] = p._replace(tables=tuple(tables))
                    return

    # -- canonicalization --------------------------------------------------

    def _canon(self, flat, xp):
        F = self.cdc.n_fields
        best = [flat[..., j] for j in range(F)]
        for prog in self.programs:
            cand = _apply_program(prog, flat, xp)
            lt = xp.zeros(flat.shape[:-1], bool)
            eq = xp.ones(flat.shape[:-1], bool)
            for j in range(F):
                lt = lt | (eq & (cand[j] < best[j]))
                eq = eq & (cand[j] == best[j])
            best = [xp.where(lt, c, b) for c, b in zip(cand, best)]
        return xp.stack(best, axis=-1)

    def canon(self, flat: torch.Tensor) -> torch.Tensor:
        """The plain version of kernel K24: the orbit-canonical form of
        flat [N, F] int32 (on its device) - a running lexicographic
        minimum over every group element applied to the ORIGINAL
        fields (group property - no composition needed)."""
        if not self.programs:
            return flat
        return self._canon(flat, _xp(flat))

    def canon_host(self, flat: np.ndarray) -> np.ndarray:
        """Numpy twin of `canon` - seeds the sharded frontier and backs
        the oracle tests."""
        arr = np.asarray(flat, np.int32)
        if not self.programs:
            return arr
        return np.asarray(self._canon(arr, _NumpyXP), np.int32)

    # -- runtime orbit certification ---------------------------------------

    def orbit_check(self, flat: torch.Tensor,
                    fvalid: torch.Tensor) -> torch.Tensor:
        """The plain version of kernel K25: take the first valid
        canonical row of flat [N, F], apply EVERY group element to it,
        re-canonicalize each image and flag any mismatch - if the
        programs are a true group action the canonical form is
        orbit-invariant, so a trip means the plan (or the kernel under
        it) is lying.  Returns a 0-dim bool: some row is valid and the
        check failed."""
        if not self.programs:
            return torch.zeros((), dtype=torch.bool, device=flat.device)
        xp = _xp(flat)
        i = fvalid.to(torch.uint8).argmax()
        row = flat[i][None, :]  # [1, F]
        variants = torch.cat([
            xp.stack(_apply_program(p, row, xp), axis=-1)
            for p in self.programs
        ], dim=0)  # [P, F]
        recanon = self._canon(variants, xp)  # [P, F]
        ok = (recanon == row).all()
        return fvalid.any() & ~ok


def build_plan(cdc, sym_sets: Dict[str, Tuple[str, ...]]) -> Tuple[
        Optional["ReducePlan"], Dict[str, str]]:
    """Build a ReducePlan over `cdc` for the statically-verified sets,
    dropping (with reasons) any set whose permutations cannot be
    realised as field programs.  Greedy per-set so one unrealisable
    set does not lose the others."""
    kept: Dict[str, Tuple[str, ...]] = {}
    dropped: Dict[str, str] = {}
    for name, atoms in sym_sets.items():
        try:
            ReducePlan(cdc, {name: atoms}, lie=False)
        except RejectSet as e:
            dropped[name] = str(e)
            continue
        kept[name] = tuple(atoms)
    if not kept:
        return None, dropped
    return ReducePlan(cdc, kept), dropped


# ---------------------------------------------------------------------------
# POR expand-time mask
# ---------------------------------------------------------------------------


def por_keep(valid: torch.Tensor, lane_action: torch.Tensor,
             safe_vec: torch.Tensor, n_labels: int) -> torch.Tensor:
    """The plain version of kernel K26 - singleton-ample pruning of one
    popped block: valid [B, L] bool, lane_action [L] int32 (static lane
    -> action id), safe_vec [n_labels] bool.  Where a safe action is
    enabled, keep only the lanes of the LOWEST-id safe enabled action
    (all its bindings - the ample set is the whole action); otherwise
    keep everything."""
    dev = valid.device
    ids = torch.arange(n_labels, dtype=torch.int32, device=dev)
    lane_action = lane_action.to(dev, torch.int32)
    onehot = lane_action[:, None] == ids[None, :]  # [L, A]
    enabled = (valid[:, :, None] & onehot[None, :, :]).any(dim=1)
    safe_enabled = enabled & safe_vec.to(dev)[None, :]
    has_safe = safe_enabled.any(dim=1)
    chosen = torch.where(safe_enabled, ids[None, :],
                         torch.full_like(ids, n_labels)[None, :]).amin(1)
    lane_keep = lane_action[None, :] == chosen[:, None]  # [B, L]
    return torch.where(has_safe[:, None], valid & lane_keep, valid)


class ReduceOps(NamedTuple):
    """The reduction capability a backend hands the expand stage:
    `plan` canonicalizes successors (None = symmetry off), `safe_ids`
    are the action ids POR may use as singleton ample sets (empty = POR
    off), `sym_sets`/`dropped_sets` feed the journal and report."""

    plan: object = None  # ReducePlan or None
    safe_ids: Tuple[int, ...] = ()
    por: bool = False
    sym_sets: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    dropped_sets: Tuple[Tuple[str, str], ...] = ()

    @property
    def orbit_factor(self) -> int:
        return self.plan.n_perms if self.plan is not None else 1

    @property
    def por_on(self) -> bool:
        """Whether the expand stage prunes (the reference's gating:
        POR asked for and some action proved safe)."""
        return bool(self.por and self.safe_ids)


def reduce_flags(backend) -> Tuple[bool, bool]:
    """(symmetry, por) as a backend's engines run them - the checkpoint
    meta keys: a symmetry plan survived, POR prunes (jaxtlc/resil/
    supervisor.py:326-331).  A -symmetry run whose every set was dropped
    records symmetry False, as the reference does."""
    red = getattr(backend, "reduce", None)
    return (bool(red is not None and red.plan is not None),
            bool(red is not None and red.por_on))
