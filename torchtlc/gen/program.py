"""A compiled generic spec as the port's kernels K19 and K20.

``GenProgram(spec)`` compiles the spec (gen.kernel.make_gen_kernel) on
the lane IR once: the step's outputs (succs [L, F], valid [L], ovf [L];
afail is all false, the subset has no Assert) and the invariants, as
graphs over one state row.  struct.emit prints them as the C++ body of
kernel K19 ``gen_expand`` (torchtlc/kernels/csrc/gen_expand.cuh), built
by kernels.build.build_struct; their plain versions are
struct.lanes.evaluate over the same graphs.  It is a StructProgram (the
struct path's K17/K18 program) with the generic template and K19's own
plain version.

``GenMasks(cdc, preds)`` does the same for the operands of a temporal
property: kernel K20 ``gen_state_masks`` (gen_masks.cuh) evaluates them
on every captured state.

``GenKernels`` are the kernel routes: ``step`` is the gen engine's (the
verdict fold included), ``expand`` the SpecBackend route the liveness
enumerator and capture take; each runs K19 on a CUDA block and the plain
version on a CPU block.  ``expand_sharded`` and ``deferred_rows`` are the
sharded engine's (kernel K21 over the shards' raw queue rows, kernel K18
on one owner's received rows; both in the emitted text beside K19).
``sim_init``, ``sim_step`` and ``sim_fold`` are the random walk's round
(sim.engine): kernels K27 and K28 of the spec's walk library - a second
text, ``GenProgram.sim_text``, around the same emitted step
(gen_sim.cuh), built at the first walk on the card, so a check builds
none of it - or their plain versions (sim.plain.WalkPlain over the step's
lane IR).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..engine.backend import FLAG_OVF, FLAG_VALID
from ..struct import lanes
from ..struct.backend import EmittedRows, StructProgram
from ..struct.emit import masks_source, spec_source
from .codec import GenCodec
from .ir import GenSpec
from .kernel import make_gen_kernel

# "no candidate" in K19's verdict fold (the int32 maximum)
GEN_NONE = 0x7FFFFFFF


def _first(rows: torch.Tensor) -> torch.Tensor:
    """[k, N] bool -> [k] int32: the lowest set index of each row, or
    GEN_NONE."""
    ar = torch.arange(rows.shape[1], device=rows.device)
    if rows.shape[1] == 0:
        return torch.full((rows.shape[0],), GEN_NONE, dtype=torch.int32,
                          device=rows.device)
    return torch.where(rows, ar, GEN_NONE).amin(1).to(torch.int32)


class GenProgram(StructProgram):
    """A generic spec compiled to the lane IR and emitted as K19; its walk
    library (K27 / K28 around the same step, gen_sim.cuh) is printed at
    the first walk that asks for it (``sim_text``)."""

    def __init__(self, spec: GenSpec):
        cdc = GenCodec(spec)
        ker = make_gen_kernel(spec, cdc)
        F, L = cdc.n_fields, ker.n_lanes
        f = lanes.input_node(F)[0]  # the one [F] row the reference traces
        succs, valid, ovf = ker.step(f)
        step_outputs = (succs.reshape(1, L, F), valid.reshape(1, L),
                        ovf.reshape(1, L), lanes.zeros((1, L), bool))
        inv_outputs = [fn(f).reshape(1) for _, fn in ker.invariants]
        self.spec = spec
        self.ker = ker
        super().__init__(step_outputs, inv_outputs, cdc,
                         np.asarray(ker.lane_action, np.int32),
                         len(spec.actions), title=f"generic spec {spec.name}",
                         template="gen_expand.cuh")
        self._sim_text = None

    @property
    def sim_text(self) -> str:
        """The emitted C++ of the walk's kernels K27 and K28 over this
        spec's step (gen_sim.cuh), printed at first use.  It prints the
        same graphs as K19's text, so its constant table is K."""
        if self._sim_text is None:
            text, K = spec_source(
                self.step_outputs, self.inv_outputs, n_fields=self.F,
                widths=self.cdc.widths, n_words=self.W,
                lane_action=self.lane_action, n_labels=self.n_labels,
                title=f"generic spec {self.spec.name} (walk)",
                template="gen_sim.cuh")
            if not np.array_equal(K, self.K):
                raise RuntimeError("the walk text's constant table differs "
                                   "from K19's")
            self._sim_text = text
        return self._sim_text

    def expand_plain(self, block: torch.Tensor, n: int, inv: bool = True,
                     deadlock: bool = True):
        """Torch version of kernel K19: (packed [ck*L, W] int32, flags
        [3 + n_inv, ck*L] uint8 - valid, afail, overflow & popped, one
        "invariant k fails" row each (zero without `inv`) - , action
        [ck*L] int32, gen [n_labels] int64, first [n_inv + 2] int32: the
        lowest failing candidate per invariant, the lowest overflowing
        candidate, the lowest dead row (only with `deadlock`), GEN_NONE
        where there is none)."""
        ck = block.shape[0]
        dev = block.device
        succ, valid, ovf, afail = self.step_plain(self.cdc.unpack(block))
        mask = torch.arange(ck, device=dev) < n
        valid = valid & mask[:, None]
        ovf = ovf & mask[:, None]
        afail = afail & valid
        flat = succ.reshape(-1, self.F)
        fvalid = valid.reshape(-1)
        rows = [fvalid, afail.reshape(-1), ovf.reshape(-1)]
        if inv:
            bits = self.inv_bits_plain(flat)
            rows += [fvalid & (((bits >> k) & 1) == 0)
                     for k in range(self.n_inv)]
        else:
            rows += [torch.zeros_like(fvalid)] * self.n_inv
        flags = torch.stack(rows)
        dead = mask & ~valid.any(1) if deadlock else torch.zeros_like(mask)
        first = torch.cat([_first(flags[3:]), _first(flags[FLAG_OVF][None]),
                           _first(dead[None])])
        la = torch.from_numpy(self.lane_action).to(dev)
        gen = torch.zeros(self.n_labels, dtype=torch.int64, device=dev)
        gen.index_add_(0, la.to(torch.int64), valid.sum(0))
        return (self.cdc.pack(flat), flags.to(torch.uint8), la.repeat(ck),
                gen, first)


class GenMasks:
    """Predicates of one generic spec's states (each compiled by
    gen.kernel.compile_expr to a bool graph of one [F] row), emitted as
    kernel K20."""

    def __init__(self, cdc: GenCodec, fns: Sequence, title: str):
        f = lanes.input_node(cdc.n_fields)[0]
        self.preds = tuple(fn(f).reshape(1) for fn in fns)
        self.cdc = cdc
        self.F = cdc.n_fields
        self.W = cdc.n_words
        self.n_pred = len(self.preds)
        self.text, self.K = masks_source(
            self.preds, n_fields=self.F, widths=cdc.widths,
            n_words=self.W, title=title)
        self._K_dev: Dict[str, torch.Tensor] = {}

    constants = StructProgram.constants  # K on a device, uploaded once

    def masks_plain(self, states: torch.Tensor) -> torch.Tensor:
        """Torch version of kernel K20: packed states [V, W] int32 ->
        [n_pred, V] uint8, row k predicate k."""
        V = states.shape[0]
        out = lanes.evaluate(self.preds, self.cdc.unpack(states))
        return torch.stack([p.reshape(-1).expand(V) for p in out]).to(
            torch.uint8)

    def masks(self, states: torch.Tensor) -> torch.Tensor:
        """Kernel K20 on a CUDA tensor, the plain version on a CPU one."""
        if not states.is_cuda:
            return self.masks_plain(states)
        from ..kernels import ops

        return ops.gen_state_masks(self, states)


class GenKernels(EmittedRows):
    """The generic backend's kernel routes: K19, and the sharded engine's
    K21 and K18 on received rows and the walk's K27 and K28 (EmittedRows),
    on CUDA tensors, their plain versions on CPU tensors."""

    def _run(self, block: torch.Tensor, n: int, inv: bool, deadlock: bool):
        if not block.is_cuda:
            return self.prog.expand_plain(block, n, inv, deadlock)
        from ..kernels import ops

        return ops.gen_expand(self.prog, block, n, inv, deadlock)

    def step(self, block: torch.Tensor, n: int, deadlock: bool = True):
        """The gen engine's expand: (packed, flags, action, gen, first)."""
        return self._run(block, n, True, deadlock)

    def expand(self, block: torch.Tensor, n: int, deferred: bool = False):
        """The SpecBackend route (the reference's generic expand stage over
        gen_backend's step): (packed, flags, action, gen, flat=None,
        cert=None, sym=None, pruned=None), the invariant rows zero when
        deferred, the overflow row masked by validity as that stage masks
        it."""
        packed, flags, action, gen, _ = self._run(block, n, not deferred,
                                                  False)
        flags[FLAG_OVF] &= flags[FLAG_VALID]
        return packed, flags, action, gen, None, None, None, None
