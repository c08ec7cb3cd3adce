"""The inference kernels' program: the spec's step and the candidate
predicates as one emitted library (kernels K29 and K30).

``InferProgram(step_prog, preds, title)`` holds the lane-IR graphs of a
struct spec's step (struct.backend.StructProgram's) and of the P
candidate predicates (ok [1] nodes on ``lanes.input_node(F)``), their
torch evaluation - the plain versions of the kernels - and the C++ that
struct.emit.infer_source prints around torchtlc/kernels/csrc/
struct_infer.cuh, with its constant table.  The routes take the kernel on
a CUDA tensor and the plain version on a CPU tensor:

* ``matrix(fields)`` - K29 ``struct_pred_matrix``: [P, S] bool, predicate
  k on row i of the decoded evidence fields [S, F] int32 (the reference's
  make_filter_fn, jaxtlc/infer/filter.py:71);
* ``alive(fields)`` - K29's fold form ``struct_pred_alive``: [P] bool,
  the matrix's all over the rows, the planes never written out (the
  driver's ``alive &= matrix.all(axis=1)``, jaxtlc/infer/driver.py:157);
* ``escaped(fields)`` - K30 ``struct_certify``: [P] bool, some row
  satisfies predicate k and has a valid successor that does not (the
  reference's make_certify_fn, jaxtlc/infer/certify.py:38).

A failed build or launch raises; nothing falls back to the plain version
on the card.  The plain versions work through the rows in blocks (the
reference's FILTER_BLOCK / CERT_BLOCK rows by default), so their torch
temporaries stay bounded.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..struct import lanes
from ..struct.backend import StructProgram, _Constants
from ..struct.emit import infer_source

FILTER_BLOCK = 2048
CERT_BLOCK = 1024


def words_to_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """[ceil(n / 32)] int32 (uint32 words) -> [n] bool: bit k % 32 of word
    k // 32 (int32 shifts: CPU torch.uint32 has no arithmetic)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[:, None] >> shifts[None]) & 1
    return bits.reshape(-1)[:n].bool()


class InferProgram(_Constants):
    """A struct spec's step and P candidate predicates: their torch
    evaluation and the emitted C++ of kernels K29 and K30."""

    def __init__(self, step_prog: StructProgram, preds: Sequence,
                 title: str):
        self.step_prog = step_prog
        self.preds = tuple(preds)
        self.cdc = step_prog.cdc
        self.F = step_prog.F
        self.L = step_prog.L
        self.P = len(self.preds)
        self.NPW = (self.P + 31) // 32
        self.title = title
        self._src = None
        self._K_dev: Dict[str, torch.Tensor] = {}

    def _source(self):
        if self._src is None:
            self._src = infer_source(
                self.step_prog.step_outputs, self.preds, n_fields=self.F,
                widths=self.cdc.widths, n_words=self.cdc.n_words,
                title=self.title)
        return self._src

    @property
    def text(self) -> str:
        """The emitted C++ (printed at first use: the CPU path needs
        none)."""
        return self._source()[0]

    @property
    def K(self) -> np.ndarray:
        return self._source()[1]

    def stats(self) -> dict:
        """Size of the predicates' graph (lanes.stats)."""
        return dict(predicates=self.P, **lanes.stats(self.preds))

    # -- the plain versions ----------------------------------------------

    def _matrix_rows(self, fields: torch.Tensor) -> torch.Tensor:
        B = fields.shape[0]
        out = lanes.evaluate(self.preds, fields)
        return torch.stack([p.reshape(-1).expand(B) for p in out])

    def matrix_plain(self, fields: torch.Tensor,
                     rows: int = FILTER_BLOCK) -> torch.Tensor:
        """Torch version of kernel K29: fields [S, F] int32 -> [P, S]
        uint8, the predicates evaluated by torch `rows` rows at a time."""
        S = fields.shape[0]
        out = torch.zeros(self.P, S, dtype=torch.uint8, device=fields.device)
        if self.P:
            for s in range(0, S, rows):
                out[:, s:s + rows] = self._matrix_rows(fields[s:s + rows])
        return out

    def alive_plain(self, fields: torch.Tensor,
                    rows: int = FILTER_BLOCK) -> torch.Tensor:
        """Torch version of K29's fold form: [P] bool, the predicates that
        hold on every row."""
        alive = torch.ones(self.P, dtype=torch.bool, device=fields.device)
        if self.P:
            for s in range(0, fields.shape[0], rows):
                alive &= self._matrix_rows(fields[s:s + rows]).all(1)
        return alive

    def certify_plain(self, fields: torch.Tensor,
                      rows: int = CERT_BLOCK) -> torch.Tensor:
        """Torch version of kernel K30: fields [S, F] int32 -> [P] bool
        escape bits - the step graph (StructProgram.step_plain), then the
        predicates on each row and on each of its successors: bit k where
        some row holds k and a valid successor does not (afail and ovf
        ignored, as the reference ignores them)."""
        esc = torch.zeros(self.P, dtype=torch.bool, device=fields.device)
        if not self.P:
            return esc
        for s in range(0, fields.shape[0], rows):
            blk = fields[s:s + rows]
            B = blk.shape[0]
            succ, valid, _ovf, _afail = self.step_prog.step_plain(blk)
            pre = self._matrix_rows(blk)
            post = self._matrix_rows(succ.reshape(B * self.L, self.F)
                                     .to(torch.int32))
            post = post.view(self.P, B, self.L)
            esc |= (pre[:, :, None] & valid[None] & ~post).any(2).any(1)
        return esc

    # -- the routes: the kernel on a CUDA tensor, the plain version on a
    # CPU tensor -----------------------------------------------------------

    def matrix(self, fields: torch.Tensor) -> torch.Tensor:
        """[P, S] bool: K29's matrix form."""
        if not fields.is_cuda or not self.P:
            return self.matrix_plain(fields).bool()
        from ..kernels import ops

        return ops.struct_pred_matrix(self, fields).bool()

    def alive(self, fields: torch.Tensor) -> torch.Tensor:
        """[P] bool: K29's fold form."""
        if not fields.is_cuda or not self.P or not fields.shape[0]:
            return self.alive_plain(fields)
        from ..kernels import ops

        return words_to_bits(ops.struct_pred_alive(self, fields), self.P)

    def escaped(self, fields: torch.Tensor) -> torch.Tensor:
        """[P] bool: K30's escape bits."""
        if not fields.is_cuda or not self.P or not fields.shape[0]:
            return self.certify_plain(fields)
        from ..kernels import ops

        return words_to_bits(ops.struct_certify(self, fields), self.P)
