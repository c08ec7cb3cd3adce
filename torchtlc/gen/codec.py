"""Generic fixed-width codec for GenSpec states (port of
jaxtlc/gen/codec.py).

Every variable component (scalar, or one function entry per index value)
is one int32 field holding the CODE of its value in the component's
finite domain (codes = positions in the sorted domain tuple).  The packed
wire form concatenates each field's ceil(log2 |domain|) bits LSB first
into 32-bit words, fields spanning word boundaries - the scheme
torchtlc/kernels/csrc/struct_codec.cuh packs and unpacks on the card,
so the fingerprint (kernel K2) and the fingerprint set work unchanged.

Abstract values (the compiled kernel's comparison currency): ints are
themselves, booleans are 0/1, strings are interned ids global to the
spec, so cross-domain `=` comparisons are value-correct.

The layout, value tables, ``encode``, ``decode`` and ``comp_index`` are
the reference's code; ``pack`` and ``unpack`` are torch, holding the
32-bit words in int64 (CPU torch lacks unsigned 32-bit shifts) and
returning int32 bit patterns.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..spec import texpr
from ..struct.codec import to_i32, to_u64
from .ir import GenSpec


def _bits_for(n: int) -> int:
    return max(1, (n - 1).bit_length())


class GenCodec:
    def __init__(self, spec: GenSpec):
        self.spec = spec
        # global string intern table (abstract values for enumerants)
        strings: List[str] = []
        for decl in spec.variables:
            for v in decl.domain.values:
                if isinstance(v, str) and v not in strings:
                    strings.append(v)
            for iset in (decl.index_set, decl.index_set2):
                for s in iset or ():
                    if s not in strings:
                        strings.append(s)
        for c in spec.constants.values():
            if isinstance(c, str) and c not in strings:
                strings.append(c)
            if isinstance(c, frozenset):
                for s in c:
                    if isinstance(s, str) and s not in strings:
                        strings.append(s)
        self.strings = sorted(strings)
        self.sid = {s: i for i, s in enumerate(self.strings)}

        # components: flat field layout (two-level functions flatten
        # row-major: (i, j) for i in index_set for j in index_set2)
        self.components: List[Tuple[str, object]] = []
        self.offsets: Dict[str, int] = {}
        self.widths: List[int] = []
        for decl in spec.variables:
            self.offsets[decl.name] = len(self.components)
            w = _bits_for(decl.domain.size)
            if decl.index_set is None:
                self.components.append((decl.name, None))
                self.widths.append(w)
            elif decl.index_set2 is None:
                for idx in decl.index_set:
                    self.components.append((decl.name, idx))
                    self.widths.append(w)
            else:
                for i in decl.index_set:
                    for j in decl.index_set2:
                        self.components.append((decl.name, (i, j)))
                        self.widths.append(w)
        self.n_fields = len(self.components)
        self.nbits = sum(self.widths)
        self.n_words = (self.nbits + 31) // 32

        # per-variable abstract-value tables (code -> abstract int)
        self.value_tables: Dict[str, np.ndarray] = {}
        for decl in spec.variables:
            self.value_tables[decl.name] = np.array(
                [self.abstract(v) for v in decl.domain.values], np.int32
            )

    # -- value <-> code ---------------------------------------------------

    def abstract(self, v) -> int:
        """Abstract int of a concrete value (int/bool/str)."""
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, int):
            return v
        if isinstance(v, str):
            if v not in self.sid:
                raise ValueError(f"unknown string value {v!r}")
            return self.sid[v]
        raise ValueError(f"no abstract value for {v!r}")

    def comp_index(self, var: str, idx, idx2=None) -> int:
        decl = self.spec.var(var)
        off = self.offsets[var]
        if decl.index_set is None:
            assert idx is None
            return off
        i = decl.index_set.index(idx)
        if decl.index_set2 is None:
            assert idx2 is None
            return off + i
        return off + i * len(decl.index_set2) + decl.index_set2.index(idx2)

    def encode(self, st) -> np.ndarray:
        """Oracle state (tuple of values / pair-tuples) -> [F] int32."""
        out = np.zeros(self.n_fields, np.int32)
        for decl, val in zip(self.spec.variables, st):
            off = self.offsets[decl.name]
            if decl.index_set is None:
                out[off] = decl.domain.code(val)
            elif decl.index_set2 is None:
                d = dict(val)
                for j, idx in enumerate(decl.index_set):
                    out[off + j] = decl.domain.code(d[idx])
            else:
                d = dict(val)
                n2 = len(decl.index_set2)
                for i, idx in enumerate(decl.index_set):
                    row = dict(d[idx])
                    for j, idx2 in enumerate(decl.index_set2):
                        out[off + i * n2 + j] = decl.domain.code(row[idx2])
        return out

    def decode(self, vec) -> tuple:
        v = np.asarray(vec)
        vals = []
        for decl in self.spec.variables:
            off = self.offsets[decl.name]
            if decl.index_set is None:
                vals.append(decl.domain.values[int(v[off])])
            elif decl.index_set2 is None:
                vals.append(tuple(
                    (idx, decl.domain.values[int(v[off + j])])
                    for j, idx in enumerate(decl.index_set)
                ))
            else:
                n2 = len(decl.index_set2)
                vals.append(tuple(
                    (idx, tuple(
                        (idx2, decl.domain.values[int(v[off + i * n2 + j])])
                        for j, idx2 in enumerate(decl.index_set2)
                    ))
                    for i, idx in enumerate(decl.index_set)
                ))
        return texpr.canon(tuple(vals))

    # -- packing (the reference's scheme, in torch) -----------------------

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
