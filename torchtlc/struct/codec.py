"""Tensor codec for structurally-inferred shapes (E1 device path).

Maps each variable's inferred Shape (struct.shapes) to a fixed layout of
int32 fields, composing four layout forms:

* EnumLeaf  - the whole (sub)value indexes into its enumerated universe:
              one field.  Records, unions with atoms, frames - anything
              whose universe fits ENUM_LEAF_LIMIT.
* MaskLeaf  - a set over an enumerable element universe becomes a
              bitmask: 16 universe elements per field (KubeAPI's
              apiState and per-client list results).
* RecNode   - structural product: optional fields get a presence bit
              field; absent children are zeroed so states compare equal
              field-wise (canonical zero).
* SeqNode   - bounded sequence: a length field + cap slot fields, each
              slot an EnumLeaf of the element universe (procedure call
              stacks, KubeAPI.tla:466).

Packing to uint32 words reuses the bit-concatenation scheme of the
KubeAPI codec, so the fingerprint kernels and the fingerprint set run
unchanged on struct-compiled states.

The port's copy of jaxtlc/struct/codec.py: the layouts, encode and decode
are the reference's; ``pack`` and ``unpack`` are torch, holding the 32-bit
words as int32 bit patterns and doing their word arithmetic in int64
masked to 32 bits (CPU torch has no shifts or adds for ``torch.uint32``).
Kernel K17 packs and unpacks on the card with the same widths
(torchtlc/kernels/csrc/struct_codec.cuh).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .shapes import (
    Shape,
    SRec,
    SSeq,
    SSet,
    ShapeError,
    universe,
)

ENUM_LEAF_LIMIT = 1 << 17
MASK_BITS_PER_FIELD = 16


def _bits_for(n: int) -> int:
    return max(1, (n - 1).bit_length())


class EnumLeaf:
    def __init__(self, shape: Optional[Shape]):
        self.shape = shape
        self.values: List = universe(shape, ENUM_LEAF_LIMIT)
        if not self.values:
            self.values = [None]  # degenerate: a single dummy value
        self.index: Dict = {v: i for i, v in enumerate(self.values)}
        self.widths = [_bits_for(len(self.values))]
        self.n_fields = 1

    def encode(self, v, out: List[int]):
        try:
            out.append(self.index[v])
        except (KeyError, TypeError):
            raise ValueError(f"value {v!r} outside enumerated universe")

    def decode(self, fields, pos: int) -> Tuple[object, int]:
        return self.values[int(fields[pos])], pos + 1


class MaskLeaf:
    def __init__(self, shape: SSet):
        self.shape = shape
        self.elem = EnumLeaf(shape.elem)
        self.n_bits = len(self.elem.values)
        self.n_fields = (self.n_bits + MASK_BITS_PER_FIELD - 1) \
            // MASK_BITS_PER_FIELD
        self.widths = []
        left = self.n_bits
        for _ in range(self.n_fields):
            take = min(left, MASK_BITS_PER_FIELD)
            self.widths.append(take)
            left -= take

    def encode(self, v, out: List[int]):
        if not isinstance(v, frozenset):
            raise ValueError(f"expected a set, got {v!r}")
        bits = 0
        for x in v:
            bits |= 1 << self.elem.index[x]
        for w in self.widths:
            out.append(bits & ((1 << w) - 1))
            bits >>= w

    def decode(self, fields, pos: int) -> Tuple[object, int]:
        bits = 0
        shift = 0
        for w in self.widths:
            bits |= int(fields[pos]) << shift
            shift += w
            pos += 1
        return frozenset(
            self.elem.values[i] for i in range(self.n_bits)
            if bits >> i & 1
        ), pos


class RecNode:
    def __init__(self, shape: SRec):
        self.shape = shape
        self.entries: List[Tuple[str, bool, object]] = []
        self.widths: List[int] = []
        for f, s, opt in shape.fields:
            child = layout_of(s)
            self.entries.append((f, opt, child))
            if opt:
                self.widths.append(1)
            self.widths.extend(child.widths)
        self.n_fields = len(self.widths)

    def encode(self, v, out: List[int]):
        d = dict(v) if isinstance(v, tuple) else None
        if d is None:
            raise ValueError(f"expected record/function, got {v!r}")
        for f, opt, child in self.entries:
            present = f in d
            if opt:
                out.append(int(present))
            elif not present:
                raise ValueError(f"required field {f} absent in {v!r}")
            if present:
                child.encode(d[f], out)
            else:
                out.extend([0] * child.n_fields)

    def decode(self, fields, pos: int) -> Tuple[object, int]:
        pairs = []
        for f, opt, child in self.entries:
            present = True
            if opt:
                present = bool(int(fields[pos]))
                pos += 1
            val, pos2 = child.decode(fields, pos)
            pos = pos2
            if present:
                pairs.append((f, val))
        return tuple(sorted(pairs)), pos


class SeqNode:
    def __init__(self, shape: SSeq):
        self.shape = shape
        self.cap = shape.cap
        self.elem = EnumLeaf(shape.elem)
        self.widths = [_bits_for(self.cap + 1)] + \
            self.elem.widths * self.cap
        self.n_fields = len(self.widths)

    def encode(self, v, out: List[int]):
        if not isinstance(v, tuple):
            raise ValueError(f"expected sequence, got {v!r}")
        if len(v) > self.cap:
            raise ValueError(
                f"sequence longer than inferred cap {self.cap}: {v!r}"
            )
        out.append(len(v))
        for x in v:
            self.elem.encode(x, out)
        out.extend([0] * ((self.cap - len(v)) * self.elem.n_fields))

    def decode(self, fields, pos: int) -> Tuple[object, int]:
        n = int(fields[pos])
        pos += 1
        items = []
        for k in range(self.cap):
            val, pos2 = self.elem.decode(fields, pos)
            pos = pos2
            if k < n:
                items.append(val)
        return tuple(items), pos


def _layout_max_codes(lay, out: List[int]) -> None:
    """Append `lay`'s per-field max legal codes to `out` (layout-walk
    mirror of the widths concatenation in StructCodec.__init__)."""
    if isinstance(lay, EnumLeaf):
        out.append(len(lay.values) - 1)
        return
    if isinstance(lay, MaskLeaf):
        for w in lay.widths:
            out.append((1 << w) - 1)
        return
    if isinstance(lay, RecNode):
        for _f, opt, child in lay.entries:
            if opt:
                out.append(1)
            _layout_max_codes(child, out)
        return
    if isinstance(lay, SeqNode):
        out.append(lay.cap)
        for _ in range(lay.cap):
            out.append(len(lay.elem.values) - 1)
        return
    raise ShapeError(f"no max codes for layout {type(lay).__name__}")


_LAYOUT_CACHE: Dict[Shape, object] = {}


def layout_of(shape: Optional[Shape]):
    """Layout for a shape: EnumLeaf when the universe is small enough,
    else a structural decomposition."""
    key = shape
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit
    lay = _build_layout(shape)
    _LAYOUT_CACHE[key] = lay
    return lay


def _build_layout(shape: Optional[Shape]):
    if isinstance(shape, SSet):
        # prefer the mask form for sets (quantifier compilation wants
        # bits); tiny set universes nested inside records still go
        # through universe() enumeration
        try:
            return MaskLeaf(shape)
        except ShapeError:
            raise ShapeError(
                f"set element universe not enumerable: {shape.elem}"
            )
    if isinstance(shape, SSeq):
        # sequences always take the structural form so the lane
        # compiler's Len/Head/Tail/indexing see an LSeq, however small
        # the universe (nested inside enumerated records they still
        # enum-encode via universe())
        return SeqNode(shape)
    try:
        return EnumLeaf(shape)
    except ShapeError:
        pass
    if isinstance(shape, SRec):
        return RecNode(shape)
    raise ShapeError(f"no layout for shape {shape}")


class StructCodec:
    """Whole-state codec: variable order -> concatenated field layout."""

    def __init__(self, variables: Tuple[str, ...],
                 var_shapes: Dict[str, Shape]):
        self.variables = variables
        self.layouts = [layout_of(var_shapes[v]) for v in variables]
        self.offsets: Dict[str, int] = {}
        self.widths: List[int] = []
        for v, lay in zip(variables, self.layouts):
            self.offsets[v] = len(self.widths)
            self.widths.extend(lay.widths)
        self.n_fields = len(self.widths)
        self.nbits = sum(self.widths)
        self.n_words = (self.nbits + 31) // 32

    def max_codes(self) -> List[int]:
        """Per-field maximum LEGAL code ([F] ints): the universe claim
        the runtime certificate check (analysis.absint) verifies on
        every generated state.  A field can hold up to 2^width - 1
        after packing; codes above max_codes (or below 0 pre-pack) are
        values the certified bounds claim unreachable."""
        out: List[int] = []
        for lay in self.layouts:
            _layout_max_codes(lay, out)
        assert len(out) == self.n_fields
        return out

    def encode(self, st: tuple) -> np.ndarray:
        out: List[int] = []
        for lay, val in zip(self.layouts, st):
            lay.encode(val, out)
        return np.asarray(out, np.int32)

    def decode(self, vec) -> tuple:
        fields = np.asarray(vec)
        vals = []
        pos = 0
        for lay in self.layouts:
            v, pos = lay.decode(fields, pos)
            vals.append(v)
        return tuple(vals)

    # -- packing (the scheme of spec.codec; words as int32 bit patterns) --

    def pack(self, vecs: torch.Tensor) -> torch.Tensor:
        """[..., F] int32 field vectors -> [..., W] int32 packed words."""
        v = to_u64(vecs)
        words, cur, cur_bits = [], None, 0
        for j, width in enumerate(self.widths):
            remaining = v[..., j]
            rbits = width
            while rbits > 0:
                if cur is None:
                    cur = torch.zeros_like(remaining)
                    cur_bits = 0
                take = min(rbits, 32 - cur_bits)
                cur = cur | ((remaining & ((1 << take) - 1)) << cur_bits)
                remaining = remaining >> take
                rbits -= take
                cur_bits += take
                if cur_bits == 32:
                    words.append(cur)
                    cur = None
        if cur is not None:
            words.append(cur)
        return to_i32(torch.stack(words, dim=-1))

    def unpack(self, words: torch.Tensor) -> torch.Tensor:
        """[..., W] int32 packed words -> [..., F] int32 fields."""
        w = to_u64(words)
        out = []
        wi, bitpos = 0, 0
        for width in self.widths:
            val = torch.zeros_like(w[..., 0])
            got = 0
            while got < width:
                take = min(width - got, 32 - bitpos)
                piece = (w[..., wi] >> bitpos) & ((1 << take) - 1)
                val = val | (piece << got)
                got += take
                bitpos += take
                if bitpos == 32:
                    wi += 1
                    bitpos = 0
            out.append(val)
        return to_i32(torch.stack(out, dim=-1))


MASK32 = 0xFFFFFFFF


def to_i32(v64: torch.Tensor) -> torch.Tensor:
    """int64 tensor holding 32-bit words -> int32 bit patterns."""
    v = v64 & MASK32
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def to_u64(v32: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 tensor of the unsigned word values."""
    return v32.to(torch.int64) & MASK32
