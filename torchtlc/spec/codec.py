"""Fixed-width tensor codec for KubeAPI states (port of jaxtlc/spec/codec.py).

A state is a vector of F int32 *fields*; its canonical wire form is W
32-bit words that hold the fields bit-packed, LSB first, in field order.
Object words, request words and list-request words use the reference's bit
layout exactly (``o_*``, ``r_*``, ``lm_*``, ``s_*`` below), so packed
words and fingerprints equal the reference's word for word.

32-bit words live in ``torch.int32`` tensors as bit patterns.  The torch
functions below do their word arithmetic in int64 masked to 32 bits,
because CPU torch has no shifts or adds for ``torch.uint32``.

Init is built directly (``initial_vectors``): every Init state has an empty
apiState, no requests, default procedure parameters, each client at its
role's start label, and one shouldReconcile bit per reconciler
(KubeAPI.tla:455-469).  ``decode`` turns a field vector back into spec
values (spec.values.State) for counterexample traces.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, List

import numpy as np
import torch

from ..config import RECONCILER, ModelConfig
from . import values
from .labels import (
    DEFAULT_INIT,
    LABEL_ID,
    LABELS,
    PROC_API,
    PROC_LISTAPI,
    RESPONSES,
    VERBS,
)

MASK32 = 0xFFFFFFFF


def _bits_for(n: int) -> int:
    return max(1, (n - 1).bit_length())


def to_i32(v64: torch.Tensor) -> torch.Tensor:
    """int64 tensor holding 32-bit words (any sign) -> int32 bit patterns."""
    v = v64 & MASK32
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def to_u64(v32: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 tensor of the unsigned word values."""
    return v32.to(torch.int64) & MASK32


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    count: int  # number of int32 lanes
    width: int  # bits per lane when packed


class Codec:
    """Field layout + pack/unpack/canonicalize for one ModelConfig."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        ni, nc = cfg.n_identities, cfg.n_clients
        ls = cfg.max_per_kind
        self.ni, self.nc, self.ls = ni, nc, ls
        self.ib = _bits_for(ni)
        self.kb = _bits_for(len(cfg.kinds))
        self.lb = _bits_for(len(LABELS))
        # object word: [has_spec:1][vv:NC][has_vv:1][ident:IB][present:1]
        self.o_spec = 0
        self.o_vv = 1
        self.o_hasvv = 1 + nc
        self.o_ident = 2 + nc
        self.o_present = 2 + nc + self.ib
        self.obj_bits = self.o_present + 1
        # request word: [obj][status:2][op:3][present:1]
        self.r_obj = 0
        self.r_status = self.obj_bits
        self.r_op = self.obj_bits + 2
        self.r_present = self.obj_bits + 5
        self.req_bits = self.r_present + 1
        # list-request meta word: [status:2][kind:kb][present:1]
        self.lm_status = 0
        self.lm_kind = 2
        self.lm_present = 2 + self.kb
        self.lm_bits = self.lm_present + 1
        # stack word: [retpc:lb][proc:1][present:1]
        self.s_retpc = 0
        self.s_proc = self.lb
        self.s_present = self.lb + 1
        self.stk_bits = self.s_present + 1

        self.nr = cfg.n_reconcilers
        self.fields: List[Field] = [
            Field("api", ni, self.obj_bits),
            Field("req", nc, self.req_bits),
            Field("lreq_meta", nc, self.lm_bits),
            Field("lreq_obj", nc * ls, self.obj_bits),
            Field("pc", nc + 1, self.lb),
            Field("stack", nc, self.stk_bits),
            Field("p_op", nc, 3),  # 0 = defaultInitValue, else 1 + verb id
            Field("p_obj", nc, self.obj_bits),  # 0 = dIV
            Field("p_kind", nc, self.kb + 1),  # 0 = dIV, else 1 + kind id
            Field("sr", self.nr, 1),  # shouldReconcile, one bit/reconciler
        ]
        self.offsets: Dict[str, int] = {}
        off = 0
        for f in self.fields:
            self.offsets[f.name] = off
            off += f.count
        self.n_fields = off
        self.nbits = sum(f.count * f.width for f in self.fields)
        self.n_words = (self.nbits + 31) // 32
        self.kind_id = {k: i for i, k in enumerate(cfg.kinds)}
        self.client_id = {c: i for i, c in enumerate(cfg.clients)}
        # per-lane packed widths, in field order
        self.lane_widths = [f.width for f in self.fields for _ in range(f.count)]

    def sl(self, name: str) -> slice:
        off = self.offsets[name]
        cnt = next(f.count for f in self.fields if f.name == name)
        return slice(off, off + cnt)

    def canonicalize(self, vecs: torch.Tensor) -> torch.Tensor:
        """Sort set-valued slot groups descending: [..., F] -> [..., F].

        The apiState slots and each client's list-result slots are TLA
        sets; descending word order is the canonical representative.  The
        sort is the reference's ``-sort(-x)`` on int32 (negation wraps)."""
        out = vecs.clone()
        api = self.sl("api")
        out[..., api] = -torch.sort(-vecs[..., api], dim=-1).values
        lo_off = self.offsets["lreq_obj"]
        if self.ls > 1:
            for ci in range(self.nc):
                s = slice(lo_off + ci * self.ls, lo_off + (ci + 1) * self.ls)
                out[..., s] = -torch.sort(-out[..., s], dim=-1).values
        return out

    def pack(self, vecs: torch.Tensor) -> torch.Tensor:
        """[..., F] int32 field vectors -> [..., W] int32 packed words."""
        v = to_u64(vecs)
        words = []
        cur = None
        cur_bits = 0
        for j, width in enumerate(self.lane_widths):
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
        """[..., W] int32 packed words -> [..., F] int32 field vectors
        (exact inverse of pack on in-range fields)."""
        w = to_u64(words)
        out = []
        wi = 0
        bitpos = 0
        for width in self.lane_widths:
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

    def to_sdict(self, vec: torch.Tensor) -> dict:
        """[..., F] field vectors -> structured dict of views."""
        lo = vec[..., self.sl("lreq_obj")]
        return {
            "api": vec[..., self.sl("api")],
            "req": vec[..., self.sl("req")],
            "lreq_meta": vec[..., self.sl("lreq_meta")],
            "lreq_obj": lo.reshape(*lo.shape[:-1], self.nc, self.ls),
            "pc": vec[..., self.sl("pc")],
            "stack": vec[..., self.sl("stack")],
            "p_op": vec[..., self.sl("p_op")],
            "p_obj": vec[..., self.sl("p_obj")],
            "p_kind": vec[..., self.sl("p_kind")],
            "sr": vec[..., self.sl("sr")],
        }

    def from_sdict(self, sd: dict) -> torch.Tensor:
        """Structured dict -> [..., F] field vectors."""
        lo = sd["lreq_obj"]
        return torch.cat(
            [
                sd["api"],
                sd["req"],
                sd["lreq_meta"],
                lo.reshape(*lo.shape[:-2], self.nc * self.ls),
                sd["pc"],
                sd["stack"],
                sd["p_op"],
                sd["p_obj"],
                sd["p_kind"],
                sd["sr"],
            ],
            dim=-1,
        )

    def pack_host(self, vec) -> int:
        """Host packer (python int): the property-test reference for pack."""
        v = np.asarray(vec, dtype=np.int64)
        out, pos = 0, 0
        for j, width in enumerate(self.lane_widths):
            out |= (int(v[j]) & ((1 << width) - 1)) << pos
            pos += width
        assert pos == self.nbits
        return out

    def decode_obj(self, w: int):
        """Object word -> object record (None if absent)."""
        if not (w >> self.o_present) & 1:
            return None
        ident = (w >> self.o_ident) & ((1 << self.ib) - 1)
        kind, name = self.cfg.identities[ident]
        d = {"k": kind, "n": name}
        if (w >> self.o_hasvv) & 1:
            d["vv"] = frozenset(self.cfg.clients[i] for i in range(self.nc)
                                if (w >> (self.o_vv + i)) & 1)
        if (w >> self.o_spec) & 1:
            d["spec"] = values.rec(pvname=name)
        return tuple(sorted(d.items()))

    def decode(self, vec) -> values.State:
        """Field vector -> spec values (jaxtlc/spec/codec.py:237)."""
        v = np.asarray(vec, dtype=np.int64)
        api = frozenset(o for o in (self.decode_obj(int(w))
                                    for w in v[self.sl("api")])
                        if o is not None)
        requests = ()
        for ci, w in enumerate(v[self.sl("req")]):
            w = int(w)
            if not (w >> self.r_present) & 1:
                continue
            r = values.rec(
                op=VERBS[(w >> self.r_op) & 7],
                obj=self.decode_obj((w >> self.r_obj)
                                    & ((1 << self.obj_bits) - 1)),
                status=RESPONSES[(w >> self.r_status) & 3])
            requests = values.pmap_set(requests, self.cfg.clients[ci], r)
        list_requests = ()
        lo = v[self.sl("lreq_obj")]
        for ci, w in enumerate(v[self.sl("lreq_meta")]):
            w = int(w)
            if not (w >> self.lm_present) & 1:
                continue
            objs = frozenset(
                o for o in (self.decode_obj(int(x))
                            for x in lo[ci * self.ls:(ci + 1) * self.ls])
                if o is not None)
            r = values.rec(
                kind=self.cfg.kinds[(w >> self.lm_kind)
                                    & ((1 << self.kb) - 1)],
                objs=objs, status=RESPONSES[(w >> self.lm_status) & 3])
            list_requests = values.pmap_set(list_requests,
                                            self.cfg.clients[ci], r)
        pc = tuple(LABELS[int(x)] for x in v[self.sl("pc")])
        stack = []
        for ci in range(self.nc):
            w = int(v[self.sl("stack")][ci])
            if (w >> self.s_present) & 1:
                ret = LABELS[(w >> self.s_retpc) & ((1 << self.lb) - 1)]
                if (w >> self.s_proc) & 1:
                    frame = values.rec(procedure=PROC_LISTAPI, pc=ret,
                                       kind=DEFAULT_INIT)
                else:
                    frame = values.rec(procedure=PROC_API, pc=ret,
                                       op=DEFAULT_INIT, obj=DEFAULT_INIT)
                stack.append((frame,))
            else:
                stack.append(())
        stack.append(())  # the server's
        p_op, p_obj, p_kind = [], [], []
        for ci in range(self.nc):
            w = int(v[self.sl("p_op")][ci])
            p_op.append(DEFAULT_INIT if w == 0 else VERBS[w - 1])
            o = self.decode_obj(int(v[self.sl("p_obj")][ci]))
            p_obj.append(DEFAULT_INIT if o is None else o)
            w = int(v[self.sl("p_kind")][ci])
            p_kind.append(DEFAULT_INIT if w == 0 else self.cfg.kinds[w - 1])
        for lst in (p_op, p_obj, p_kind):
            lst.append(DEFAULT_INIT)
        return values.State(
            api_state=api, requests=requests, list_requests=list_requests,
            pc=pc, stack=tuple(stack), op=tuple(p_op), obj=tuple(p_obj),
            kind=tuple(p_kind),
            should_reconcile=tuple(bool(x) for x in v[self.sl("sr")]))

    def initial_vectors(self) -> np.ndarray:
        """Init (KubeAPI.tla:455-469) as field vectors, [2^nr, F] int32, in
        the order of itertools.product((False, True), repeat=nr)."""
        cfg = self.cfg
        base = np.zeros(self.n_fields, dtype=np.int32)
        pc = [LABEL_ID["CStart"] if r == RECONCILER else LABEL_ID["PVCStart"]
              for r in cfg.roles] + [LABEL_ID["APIStart"]]
        base[self.sl("pc")] = pc
        rows = []
        for bits in itertools.product((0, 1), repeat=self.nr):
            v = base.copy()
            v[self.sl("sr")] = bits
            rows.append(v)
        return np.stack(rows)


@functools.lru_cache(maxsize=None)
def get_codec(cfg: ModelConfig) -> Codec:
    return Codec(cfg)
