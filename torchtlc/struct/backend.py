"""Struct-compiled specs as a SpecBackend of the port's engines (port of
jaxtlc/struct/backend.py).

``struct_backend(model)`` runs parse -> shape inference -> lane compile
(struct.compile on the lane IR) once, and returns the backend the engines
consume.  Its kernel routes are ``StructKernels``:

* ``expand(block, n, deferred)`` - kernel K17 ``struct_expand`` on a CUDA
  block, its plain version (the lane IR evaluated by torch, composed as
  the reference composes its expand stage) on a CPU block;
* ``deferred(ex, is_new_c, c_idx, rows)`` - kernel K18 ``struct_inv_rows``
  over the fresh claimants' raw successors (``ExpandOut.flat``), or its
  plain version;
* ``expand_sharded(queue, qhead, npop, ck, deferred, with_block)`` and
  ``deferred_rows(rows_in, fresh, c_idx, rows)`` - the sharded engine's
  routes (``EmittedRows``, shared with the generic backend): kernel K21
  ``emitted_expand_sharded`` over the D shards' raw queue rows and K18 on
  one owner's received rows, or their plain versions;
* ``sim_init``, ``sim_step`` and ``sim_fold`` - the random walk's round
  (sim.engine; ``EmittedRows``'s, shared with the generic backend):
  kernel K27 ``struct_sim_step`` (its kInit form for round 0) and K28
  ``sim_fold`` (torchtlc/kernels/csrc/emitted_sim.cuh), or their plain
  versions ``sim_init_plain``, ``sim_step_plain`` and ``sim_fold_plain``
  (sim.plain.WalkPlain, which StructProgram mixes in, over
  ``StructProgram.sim_lanes``);
* ``recheck(words)`` - the artifact cache's invariant re-check over
  stored packed rows (struct.artifacts.run_recheck): kernel K31
  ``struct_recheck`` (torchtlc/kernels/csrc/struct_recheck.cuh) on CUDA
  rows, ``StructProgram.recheck_plain`` on CPU rows.

With ``coverage=True`` the backend also carries the device coverage plane
(``StructCoverage``): the site table of the reference (the per-action
prefix, then the walk's sites in registration order) and a ``count`` that
runs kernel K22 ``struct_cov_count`` on a CUDA block, its plain version
on a CPU block.

The emitted C++ of the step and the invariants (struct.emit) is built
into a shared library at the first launch on the card (kernels.build,
``_build/struct/<digest>/``); the constant tables are uploaded to the
card once per backend and device.  Lane labels come from one IR build:
no data run.

``struct_backend(model, bounds=...)`` with a certified bound report
(analysis.absint, ``-narrow``) builds the narrowed compile
(jaxtlc/struct/backend.py:74-187): the certified shapes feed the codec,
the compiler drops the range traps and slot lanes the bounds prove safe,
and the backend carries the runtime certificate - kernel K23
``struct_cert_check`` (torchtlc/kernels/csrc/struct_cert.cuh): every
valid generated state's raw fields against the codec's maximum codes,
every cardinality-bounded mask's popcount against its bound.  On the
engine K17 evaluates it on each valid successor before packing it
(immediate mode) and K18 on the fresh claimants (deferred mode); the
plain version is ``StructProgram.cert_plain``.

``struct_backend(model, symmetry=True, por=True)`` attaches the state-space
reduction (engine.reduce, jaxtlc/struct/backend.py:228-257): the program's
emitted text then carries the symmetry plan's field programs and the POR
flags, so K17 and K21 canonicalize every candidate (kernel K24
``struct_canon``) and prune each row to a singleton ample set (kernel K26
``struct_por_keep``), and every single-device body runs the orbit check
(kernel K25 ``struct_orbit_check``, torchtlc/kernels/csrc/
struct_reduce.cuh).  Their plain versions are engine.reduce's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..engine.backend import (OK, VIOL_ASSERT, VIOL_SLOT_OVERFLOW,
                              SpecBackend)
from ..sim.plain import WalkPlain
from . import lanes
from .codec import MaskLeaf, StructCodec
from .compile import LaneCompiler, TrapPolicy
from .emit import cov_source, spec_source
from .loader import StructModel
from .shapes import infer_shapes, typeok_hints

VIOL_INVARIANT_BASE = 100


def struct_viol_names(model: StructModel) -> Dict[int, str]:
    """Violation-code name overrides for a struct model (invariants by
    cfg order + the PlusCal assertion channel)."""
    names = {VIOL_ASSERT: "Failure of PlusCal assertion"}
    for k, name in enumerate(model.invariants):
        names[VIOL_INVARIANT_BASE + k] = f"Invariant {name} is violated"
    return names


def _card_specs(cdc: StructCodec, variables, card_bounds) -> list:
    """(field offset, field count, bound) triples for the mask-layout
    variables whose certified cardinality bound actually constrains
    (jaxtlc/struct/backend.py:74)."""
    out = []
    for v, lay in zip(variables, cdc.layouts):
        bound = (card_bounds or {}).get(v)
        if bound is None or not isinstance(lay, MaskLeaf):
            continue
        if bound < lay.n_bits:
            out.append((cdc.offsets[v], lay.n_fields, bound))
    return out


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of the low 32 bits of each int64 element."""
    x = x & 0xFFFFFFFF
    return sum((x >> b) & 1 for b in range(32))


class _Constants:
    """The constant table K of an emitted text, uploaded once per
    device."""

    def constants(self, device) -> torch.Tensor:
        """K on `device` (uploaded once per device)."""
        key = str(device)
        t = self._K_dev.get(key)
        if t is None:
            t = torch.from_numpy(self.K).to(device)
            self._K_dev[key] = t
        return t


class StructProgram(_Constants, WalkPlain):
    """A compiled spec: the lane-IR graphs of its step and invariants,
    their torch evaluation (the plain versions; the walk's round through
    sim.plain.WalkPlain) and the emitted C++ with its constant table."""

    code_base = VIOL_INVARIANT_BASE  # invariant k reports code 100 + k

    def __init__(self, step_outputs, inv_outputs, cdc: StructCodec,
                 lane_action: np.ndarray, n_labels: int, title: str,
                 template: str = "struct_expand.cuh", card_specs=None,
                 plan=None, safe_ids=None, batched: bool = False):
        """`card_specs` (a list, possibly empty) makes the program carry
        the runtime certificate over the codec's maximum codes and these
        (offset, fields, bound) mask bounds; None carries none.  `plan`
        (an engine.reduce.ReducePlan) makes its text canonicalize every
        candidate (K24) and carry the orbit check (K25); `safe_ids` (the
        action ids POR may take, a nonempty tuple) makes it prune (K26).
        None carries neither.  `batched` adds the serving plane's batched
        kernels (K32, K34, K35) to the text's library."""
        self.cert = None if card_specs is None else (
            tuple(int(c) for c in cdc.max_codes()),
            tuple(tuple(int(x) for x in spec) for spec in card_specs))
        self.plan = plan
        self.sym_programs = tuple(plan.programs) if plan is not None else ()
        self.por_safe = None if not safe_ids else tuple(
            a in safe_ids for a in range(n_labels))
        self.step_outputs = tuple(step_outputs)
        self.inv_outputs = tuple(inv_outputs)
        self.cdc = cdc
        self.F = cdc.n_fields
        self.W = cdc.n_words
        self.L = int(self.step_outputs[0].shape[1])
        self.n_inv = len(self.inv_outputs)
        self.n_labels = n_labels
        self.lane_action = np.asarray(lane_action, np.int32)
        self.template = template
        self.batched = bool(batched)
        self.text, self.K = spec_source(
            self.step_outputs, self.inv_outputs, n_fields=self.F,
            widths=cdc.widths, n_words=self.W, lane_action=self.lane_action,
            n_labels=n_labels, title=title, template=template,
            cert=self.cert, sym=self.sym_programs or None,
            por=self.por_safe, batched=batched)
        self._K_dev: Dict[str, torch.Tensor] = {}

    def stats(self) -> dict:
        """Sizes of the step and invariant graphs (lanes.stats)."""
        return dict(step=lanes.stats(self.step_outputs),
                    invariants=lanes.stats(self.inv_outputs),
                    K=int(self.K.size))

    # -- the plain versions ----------------------------------------------

    def step_plain(self, fields: torch.Tensor):
        """fields [B, F] -> (succ [B, L, F] int32, valid, ovf, afail
        [B, L] bool): the step graph evaluated by torch."""
        B = fields.shape[0]
        out = lanes.evaluate(self.step_outputs, fields)
        return tuple(t.expand((B,) + tuple(t.shape[1:]))
                     .reshape((B,) + tuple(t.shape[2:])) for t in out)

    def inv_bits_plain(self, fields: torch.Tensor) -> torch.Tensor:
        """fields [N, F] -> [N] int32, bit k set when invariant k holds."""
        N = fields.shape[0]
        bits = torch.zeros(N, dtype=torch.int32, device=fields.device)
        if self.n_inv:
            oks = lanes.evaluate(self.inv_outputs, fields)
            for k, ok in enumerate(oks):
                bits |= ok.reshape(-1).expand(N).to(torch.int32) << k
        return bits

    def recheck_plain(self, words: torch.Tensor):
        """Torch version of kernel K31 (the reference's _recheck_fn,
        jaxtlc/struct/artifacts.py:722): stored rows words [N, W] int32 ->
        (bits [N] int32 from cdc.unpack and the lane-IR invariants,
        first 0-dim int64: the lowest row whose bits are not all set, N
        when none)."""
        N = words.shape[0]
        bits = self.inv_bits_plain(self.cdc.unpack(words))
        full = (1 << self.n_inv) - 1
        bad = torch.nonzero((bits & full) != full).reshape(-1)
        first = bad[0] if bad.numel() else torch.tensor(N)
        return bits, first.to(torch.int64)

    def cert_plain(self, rows: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
        """Torch version of kernel K23 (the reference's make_cert_check,
        jaxtlc/struct/backend.py:46-71): rows [N, F] int32 raw fields,
        valid [N] bool -> 0-dim bool, some valid row holds a field outside
        [0, its maximum code] or a cardinality-bounded mask whose popcount
        (its fields as uint32) exceeds the bound."""
        max_code, specs = self.cert
        mc = torch.tensor(max_code, dtype=torch.int32, device=rows.device)
        viol = ((rows < 0) | (rows > mc)).any(1)
        for off, nf, bound in specs:
            pc = _popcount32(rows[:, off:off + nf].to(torch.int64)).sum(1)
            viol = viol | (pc > bound)
        return (viol & valid.bool()).any()

    def _pruned(self, valid: torch.Tensor):
        """K26's plain version on valid [B, L]: (kept lanes, the 0-dim
        int64 count pruned), or (valid, None) without POR flags."""
        if self.por_safe is None:
            return valid, None
        from ..engine.reduce import por_keep

        dev = valid.device
        keep = por_keep(valid, torch.from_numpy(self.lane_action).to(dev),
                        torch.tensor(self.por_safe, device=dev),
                        self.n_labels)
        return keep, (valid & ~keep).sum()

    def _canonical(self, flat: torch.Tensor) -> torch.Tensor:
        """K24's plain version on every candidate (identity without a
        symmetry plan)."""
        return flat if self.plan is None else self.plan.canon(flat)

    def expand_red_plain(self, block: torch.Tensor, n: int,
                         deferred: bool = False, cert: bool = False):
        """Torch version of kernel K17 with K23-K26 around it, composed as
        the reference's expand stage composes them (jaxtlc/engine/
        backend.py:195-268): (packed [ck*L, W] int32, flags [3 + n_inv,
        ck*L] uint8, action [ck*L] int32, gen [n_labels] int64, flat
        [ck*L, F] int32 in deferred mode else None, cert, sym, pruned).
        afail and ovf are taken from the pre-pruning lanes; the valid
        flags, gen, the invariants and the certificate from the lanes K26
        kept; every candidate is canonical (K24).  cert is the 0-dim bool
        certificate of the valid successors with `cert` (K17's kCert
        form), else None; sym the orbit check of the block (K25) with a
        symmetry plan, else None; pruned the 0-dim int64 count of the
        lanes K26 pruned with POR flags, else None."""
        ck = block.shape[0]
        dev = block.device
        succ, valid, ovf, afail = self.step_plain(self.cdc.unpack(block))
        mask = torch.arange(ck, device=dev) < n
        valid = valid & mask[:, None]
        afail = afail & valid
        ovf = ovf & valid
        valid, pruned = self._pruned(valid)
        flat = self._canonical(succ.reshape(-1, self.F))
        fvalid = valid.reshape(-1)
        rows = [fvalid, afail.reshape(-1), ovf.reshape(-1)]
        if deferred:
            rows += [torch.zeros_like(fvalid)] * self.n_inv
        else:
            bits = self.inv_bits_plain(flat)
            rows += [fvalid & (((bits >> k) & 1) == 0)
                     for k in range(self.n_inv)]
        la = torch.from_numpy(self.lane_action).to(dev)
        action = la.repeat(ck)
        gen = torch.zeros(self.n_labels, dtype=torch.int64, device=dev)
        gen.index_add_(0, la.to(torch.int64), valid.sum(0))
        flags = torch.stack(rows).to(torch.uint8)
        sym = (None if self.plan is None
               else self.plan.orbit_check(flat, fvalid))
        return (self.cdc.pack(flat), flags, action, gen,
                flat if deferred else None,
                self.cert_plain(flat, fvalid) if cert else None, sym,
                pruned)

    def expand_plain(self, block: torch.Tensor, n: int,
                     deferred: bool = False, cert: bool = False):
        """Torch version of kernel K17: (packed [ck*L, W] int32, flags
        [3 + n_inv, ck*L] uint8, action [ck*L] int32, gen [n_labels]
        int64, flat [ck*L, F] int32 in deferred mode else None); with
        `cert` (its kCert form) a sixth output, the 0-dim bool certificate
        of the valid successors (cert_plain before packing).  The first
        outputs of expand_red_plain."""
        out = self.expand_red_plain(block, n, deferred, cert)
        return out[:6] if cert else out[:5]

    def expand_sharded_plain(self, queue: torch.Tensor, qhead: torch.Tensor,
                             npop: torch.Tensor, ck: int,
                             deferred: bool = False,
                             with_block: bool = False):
        """Torch version of kernel K21: the pops of all D shards of the
        sharded engine's raw-field queues [D, qrows, F] (row r of shard d
        at (qhead[d] + r) % (qrows - 1), live while r < npop[d]) -> (packed
        [D*ck*L, W] int32, flags [3 + n_inv, D*ck*L] uint8 - valid, afail
        and ovf masked by validity, the invariant rows zero when deferred
        - , action [D*ck*L] int32, gen [D, n_labels] int64, fields
        [D*ck*L, F] int32, the packed popped rows [D*ck, W] or None).  The
        reference's expand half over an emitted backend
        (jaxtlc/engine/sharded.py:510-556): under POR the lanes are pruned
        after afail and ovf are taken, under symmetry every candidate is
        canonicalized, and nothing is counted or orbit-checked."""
        from ..engine.sharded import popped_rows

        D = queue.shape[0]
        dev = queue.device
        rows = popped_rows(queue, qhead, ck).reshape(D * ck, self.F)
        succ, valid, ovf, afail = self.step_plain(rows)
        live = (torch.arange(ck, device=dev)[None]
                < npop[:, None]).reshape(-1)
        valid = valid & live[:, None]
        afail = afail & valid
        ovf = ovf & valid
        # K26 and K24, uncounted (jaxtlc/engine/sharded.py:527-542)
        valid = self._pruned(valid)[0]
        flat = self._canonical(succ.reshape(-1, self.F).to(torch.int32))
        fvalid = valid.reshape(-1)
        out = [fvalid, afail.reshape(-1), ovf.reshape(-1)]
        if deferred:
            out += [torch.zeros_like(fvalid)] * self.n_inv
        else:
            bits = self.inv_bits_plain(flat)
            out += [fvalid & (((bits >> k) & 1) == 0)
                    for k in range(self.n_inv)]
        la = torch.from_numpy(self.lane_action).to(dev)
        gen = torch.zeros(D, self.n_labels, dtype=torch.int64, device=dev)
        gen.index_add_(1, la.to(torch.int64),
                       valid.view(D, ck, self.L).sum(1))
        return (self.cdc.pack(flat), torch.stack(out).to(torch.uint8),
                la.repeat(D * ck), gen, flat,
                self.cdc.pack(rows) if with_block else None)

    def inv_rows_plain(self, flat: torch.Tensor, fresh: torch.Tensor,
                       c_idx: torch.Tensor, action, rows: int,
                       code_base: int = VIOL_INVARIANT_BASE,
                       cert: bool = False):
        """Torch version of kernel K18: the invariants of the fresh
        claimants among the first `rows` rows of an insert's (is_new_c,
        c_idx), read from their raw successors flat[c_idx] (the expand
        stage's, or one owner's received rows on the sharded engine).
        First wins across the invariants; within one the highest violating
        lane.  Returns (viol 0-dim int64, state [F] int32, action 0-dim
        int64 - -1 when `action` is None); (OK, zeros, -1) when every
        fresh claimant passes.  With `cert` a fourth output: the 0-dim
        bool certificate of the fresh claimants' rows (cert_plain)."""
        dev = flat.device
        lanes_ = c_idx[:rows][fresh[:rows].bool()]
        cert_bad = None
        if cert:
            cert_bad = self.cert_plain(
                flat[lanes_], torch.ones(lanes_.numel(), dtype=torch.bool,
                                         device=dev))
        viol, state, vaction = OK, torch.zeros(self.F, dtype=torch.int32,
                                                device=dev), -1
        if lanes_.numel():
            bits = self.inv_bits_plain(flat[lanes_])
            for k in range(self.n_inv):
                bad = ((bits >> k) & 1) == 0
                if bad.any():
                    lane = int(lanes_[bad].max())
                    viol, state = code_base + k, flat[lane].to(torch.int32)
                    vaction = -1 if action is None else int(action[lane])
                    break

        def i64(v):
            return torch.tensor(v, dtype=torch.int64, device=dev)

        out = (i64(viol), state, i64(vaction))
        return out + (cert_bad,) if cert else out

    # -- the random walk: K27 and K28's plain versions are WalkPlain's
    # (sim.plain) over this step

    def sim_lanes(self, states: torch.Tensor):
        """step_plain over the walkers' states [W, F] -> (succ, valid, ovf,
        afail, action [W, L] int32: each lane's action)."""
        succ, valid, ovf, afail = self.step_plain(states)
        la = torch.from_numpy(self.lane_action).to(states.device)
        return succ, valid, ovf, afail, la.expand(states.shape[0], self.L)

    # -- the serving plane's batched forms (K32, K34, K35) ----------------

    def expand_batched_plain(self, queue: torch.Tensor, pop: torch.Tensor,
                             C: int, deferred: bool = False):
        """Torch version of kernel K32: lane k of the stacked queue [K, 2,
        qrows, W] pops pop[k] = (parity, qhead, n, ck) rows (ck = 0: the
        lane is frozen and its slab is left as allocated) and its slab of
        the [K, C*L] outputs holds expand_red_plain's at width ck, the flag
        rows at stride ck*L.  Returns (packed, flags, action, gen, flat)
        as ops.emitted_expand_batched."""
        Kl = queue.shape[0]
        dev = queue.device
        n_all = C * self.L
        packed = torch.zeros(Kl, n_all, self.W, dtype=torch.int32,
                             device=dev)
        flags = torch.zeros(Kl, (3 + self.n_inv) * n_all, dtype=torch.uint8,
                            device=dev)
        action = torch.zeros(Kl, n_all, dtype=torch.int32, device=dev)
        gen = torch.zeros(Kl, self.n_labels, dtype=torch.int64, device=dev)
        flat = (torch.zeros(Kl, n_all, self.F, dtype=torch.int32,
                            device=dev) if deferred else None)
        for k, (parity, qhead, n, ck) in enumerate(pop.tolist()):
            if not ck:
                continue
            block = queue[k, parity, qhead:qhead + ck]
            p, f, a, g, fl = self.expand_red_plain(block, n, deferred)[:5]
            m = ck * self.L
            packed[k, :m] = p
            flags[k, :f.numel()] = f.reshape(-1)
            action[k, :m] = a
            gen[k] = g
            if deferred:
                flat[k, :m] = fl
        return packed, flags, action, gen, flat

    def sim_step_batched_plain(self, buf, carry, check_deadlock: bool,
                               init: bool = False, inits=None,
                               n0=None) -> None:
        """Torch version of kernel K34: sim_step_plain (or, with `init`,
        sim_init_plain over lane k's first n0[k] rows of inits) on every
        batch lane's slice of the stacked carry and buffers, in place."""
        from ..sim.engine import lane_buffers

        for k in range(carry.states.shape[0]):
            b = lane_buffers(buf, k)
            if init:
                self.sim_init_plain(b, carry.key[k],
                                    inits[k, :int(n0[k])], carry.states[k])
            else:
                self.sim_step_plain(b, carry.key[k], carry.step_i[k],
                                    carry.states[k], carry.alive[k],
                                    carry.steps_taken[k], check_deadlock)

    def sim_fold_batched_plain(self, buf, carry, depth: int,
                               init: bool = False) -> None:
        """Torch version of kernel K35: sim_fold_plain on every batch
        lane's slice of the stacked carry, in place."""
        from ..sim.engine import lane_buffers, lane_carry

        for k in range(carry.states.shape[0]):
            self.sim_fold_plain(lane_buffers(buf, k), lane_carry(carry, k),
                                depth, init)



class EmittedRows:
    """The routes every emitted backend shares (struct and generic): the
    sharded engine's expand, kernel K21, the deferred check of received
    rows, kernel K18, and the random walk's round, kernels K27 and K28 - on
    CUDA tensors, their plain versions on CPU tensors."""

    def __init__(self, prog: StructProgram):
        self.prog = prog

    def expand_sharded(self, queue, qhead, npop, ck: int,
                       deferred: bool = False, with_block: bool = False):
        if not queue.is_cuda:
            return self.prog.expand_sharded_plain(queue, qhead, npop, ck,
                                                  deferred, with_block)
        from ..kernels import ops

        return ops.emitted_expand_sharded(self.prog, queue, qhead, npop, ck,
                                          deferred, with_block)

    def deferred_rows(self, rows_in, fresh, c_idx, rows: int):
        """-> (viol, state): the fresh claimants' invariants over received
        rows (no action plane)."""
        if not rows_in.is_cuda:
            viol, state, _ = self.prog.inv_rows_plain(rows_in, fresh, c_idx,
                                                      None, rows)
        else:
            from ..kernels import ops

            viol, state, _ = ops.struct_inv_rows(self.prog, rows_in, fresh,
                                                 c_idx, None, rows)
        return viol, state

    # the random walk's round (sim.engine): kernels K27 and K28 of the
    # spec's text on CUDA tensors (a struct spec's own library, a generic
    # spec's walk library), their plain versions (sim.plain.WalkPlain) on
    # CPU tensors; a failed build or launch raises

    def sim_init(self, buf, key, inits, states) -> None:
        if not states.is_cuda:
            return self.prog.sim_init_plain(buf, key, inits, states)
        from ..kernels import ops

        ops.struct_sim_init(self.prog, buf, key, inits, states)

    def sim_step(self, buf, key, step_i, states, alive, steps_taken,
                 check_deadlock: bool) -> None:
        if not states.is_cuda:
            return self.prog.sim_step_plain(buf, key, step_i, states, alive,
                                            steps_taken, check_deadlock)
        from ..kernels import ops

        ops.struct_sim_step(self.prog, buf, key, step_i, states, alive,
                            steps_taken, check_deadlock)

    def sim_fold(self, buf, carry, depth: int, init: bool = False) -> None:
        if not carry.states.is_cuda:
            return self.prog.sim_fold_plain(buf, carry, depth, init)
        from ..kernels import ops

        ops.sim_fold(self.prog, buf, carry, depth, init)


class StructKernels(EmittedRows):
    """The struct backend's kernel routes (SpecBackend.kernels): K17 and
    K18, and the sharded engine's K21 and K18 on received rows, on CUDA
    tensors, their plain versions on CPU tensors; `cov` is the coverage
    plane's StructCoverage (K22) when the backend carries one."""

    def __init__(self, prog: StructProgram, cov=None):
        super().__init__(prog)
        self.cov = cov

    def expand(self, block: torch.Tensor, n: int, deferred: bool = False):
        """-> (packed, flags, action, gen, flat, cert, sym, pruned): cert
        is the block's certificate (K17's kCert form) in the immediate mode
        of a backend that carries one, else None; sym the block's orbit
        check (K25 after K17) with a symmetry plan, else None; pruned the
        lanes K26 pruned inside K17 under POR, else None."""
        prog = self.prog
        cert = prog.cert is not None and not deferred
        if not block.is_cuda:
            return prog.expand_red_plain(block, n, deferred, cert)
        from ..kernels import ops

        out = ops.struct_expand(prog, block, n, deferred, cert)
        sym = None
        if prog.plan is not None:
            sym = (ops.struct_orbit_check(prog, block, out[1][0])
                   if prog.sym_programs
                   else torch.zeros((), dtype=torch.bool, device=block.device))
        return out[:6] + (sym, out[6])

    def deferred(self, ex, is_new_c, c_idx, rows: int):
        """-> (viol, state, action, cert): cert is the fresh claimants'
        certificate when the backend carries one, else None."""
        cert = self.prog.cert is not None
        if not ex.flat.is_cuda:
            out = self.prog.inv_rows_plain(ex.flat, is_new_c, c_idx,
                                           ex.action, rows, cert=cert)
        else:
            from ..kernels import ops

            out = ops.struct_inv_rows(self.prog, ex.flat, is_new_c, c_idx,
                                      ex.action, rows, cert=cert)
        return out if cert else out + (None,)

    def canon(self, rows: torch.Tensor) -> torch.Tensor:
        """The orbit-canonical form of rows [N, F] int32 (a program with a
        symmetry plan): kernel K24 on CUDA tensors, its plain version on
        CPU tensors."""
        if not rows.is_cuda or not self.prog.sym_programs:
            return self.prog.plan.canon(rows)
        from ..kernels import ops

        return ops.struct_canon(self.prog, rows)

    def por_keep(self, valid: torch.Tensor) -> torch.Tensor:
        """valid [B, L] bool after the singleton ample-set pruning (a
        program with POR flags): kernel K26 on CUDA tensors, its plain
        version on CPU tensors."""
        if not valid.is_cuda:
            return self.prog._pruned(valid)[0]
        from ..kernels import ops

        return ops.struct_por_keep(self.prog, valid)

    def recheck(self, words: torch.Tensor):
        """Kernel K31 on CUDA stored rows, the plain version on CPU ones:
        (bits [N] int32, first 0-dim int64)."""
        if words.is_cuda:
            from ..kernels import ops

            return ops.struct_recheck(self.prog, words)
        return self.prog.recheck_plain(words)

    def cert(self, rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """The certificate of raw rows [N, F] under valid [N]: kernel K23
        on CUDA tensors, its plain version on CPU tensors."""
        if not rows.is_cuda:
            return self.prog.cert_plain(rows, valid)
        from ..kernels import ops

        return ops.struct_cert_check(self.prog, rows, valid)

    # the serving plane's batched routes: kernels K32, K34, K35 on CUDA
    # tensors, their plain versions on CPU tensors

    def expand_batched(self, queue, pop, C: int, deferred: bool = False):
        if not queue.is_cuda:
            return self.prog.expand_batched_plain(queue, pop, C, deferred)
        from ..kernels import ops

        return ops.emitted_expand_batched(self.prog, queue, pop.to(
            queue.device), C, deferred)

    def sim_step_batched(self, buf, carry, check_deadlock: bool,
                         init: bool = False, inits=None, n0=None) -> None:
        if not carry.states.is_cuda:
            return self.prog.sim_step_batched_plain(
                buf, carry, check_deadlock, init, inits, n0)
        from ..kernels import ops

        ops.struct_sim_step_batched(self.prog, buf, carry, check_deadlock,
                                    init, inits, n0)

    def sim_fold_batched(self, buf, carry, depth: int,
                         init: bool = False) -> None:
        if not carry.states.is_cuda:
            return self.prog.sim_fold_batched_plain(buf, carry, depth, init)
        from ..kernels import ops

        ops.sim_fold_batched(self.prog, buf, carry, depth, init)


class StructCoverage(_Constants):
    """The coverage conditions of a compiled struct spec (build_cov's lane
    IR), their torch evaluation (the plain version of kernel K22) and the
    emitted C++ around torchtlc/kernels/csrc/struct_cov.cuh."""

    def __init__(self, conds, cond_sites, cdc: StructCodec,
                 lane_action: np.ndarray, n_labels: int, n_sites: int,
                 title: str):
        self.conds = tuple(conds)
        self.cond_sites = np.asarray(cond_sites, np.int64)
        self.cdc = cdc
        self.F = cdc.n_fields
        self.W = cdc.n_words
        self.lane_action = np.asarray(lane_action, np.int32)
        self.L = len(self.lane_action)
        self.M = len(self.conds)
        self.n_labels = n_labels
        self.n_sites = n_sites
        self.text, self.K = cov_source(
            self.conds, self.cond_sites, n_sites=n_sites, n_fields=self.F,
            widths=cdc.widths, n_words=self.W, lane_action=self.lane_action,
            n_labels=n_labels, title=title)
        self._K_dev: Dict[str, torch.Tensor] = {}

    def stats(self) -> dict:
        """Size of the conditions' graph (lanes.stats)."""
        return dict(conditions=self.M, **lanes.stats(self.conds))

    def count_plain(self, block: torch.Tensor, n: int,
                    valid: torch.Tensor) -> torch.Tensor:
        """Torch version of kernel K22: block [ck, W] packed rows, valid
        [ck*L] uint8 -> [n_sites] int32 (uint32 words).  The action prefix
        is each action's valid lanes over every row; then each condition,
        evaluated by torch, counts the rows below n where it holds (the
        reference's stack, masked matvec and index-add), in int64 masked
        to 32 bits."""
        ck = block.shape[0]
        dev = block.device
        out = torch.zeros(self.n_sites, dtype=torch.int64, device=dev)
        la = torch.from_numpy(self.lane_action).to(dev, torch.int64)
        out.index_add_(0, la, valid.view(ck, self.L).to(torch.int64).sum(0))
        if self.M:
            mask = (torch.arange(ck, device=dev) < n).to(torch.int64)
            cols = lanes.evaluate(self.conds, self.cdc.unpack(block))
            stack = torch.stack([c.reshape(-1).expand(ck) for c in cols])
            sums = (stack.to(torch.int64) * mask).sum(1)
            out.index_add_(0, torch.from_numpy(self.cond_sites).to(dev),
                           sums)
        out &= 0xFFFFFFFF
        return torch.where(out >= 1 << 31, out - (1 << 32),
                           out).to(torch.int32)

    def count(self, block: torch.Tensor, n: int,
              valid: torch.Tensor) -> torch.Tensor:
        """The coverage plane's count: K22 on a CUDA block, the plain
        version on a CPU block."""
        if not block.is_cuda:
            return self.count_plain(block, n, valid)
        from ..kernels import ops

        return ops.struct_cov_count(self, block, n, valid)


def model_shapes(model: StructModel) -> dict:
    """The inferred variable shapes of a model (the TypeOK hints, then
    shape inference)."""
    system = model.system
    hints = typeok_hints(system.ev, model.invariants, system.variables)
    return infer_shapes(system.ev, system.variables, system.init_ast,
                        system.next_ast, hints=hints)


def compile_model(model: StructModel, var_shapes=None,
                  trap_policy: TrapPolicy = None):
    """(codec, LaneCompiler, step outputs, invariant outputs) of a model:
    shape inference with the TypeOK hints (or the given `var_shapes`, a
    certified bound report's), then one build of the step and of each
    invariant on ``lanes.input_node(F)``.  The compiler's ``trap_stats``
    are the step's (range-trap sites, elided traps, reduced slot lanes),
    as the reference reads them after its step trace."""
    system = model.system
    if var_shapes is None:
        var_shapes = model_shapes(model)
    cdc = StructCodec(system.variables, var_shapes)
    compiler = LaneCompiler(system.ev, system.variables, var_shapes, cdc,
                            trap_policy=trap_policy)
    inp = lanes.input_node(cdc.n_fields)
    step_outputs = compiler.build_step(system.next_ast)(inp)
    compiler.trap_stats = (compiler.trap_sites, compiler.elided_traps,
                           compiler.reduced_slot_lanes)
    inv_outputs = [compiler.build_invariant(ast)(inp)
                   for ast in model.invariants.values()]
    return cdc, compiler, step_outputs, inv_outputs


def coverage_plane(model: StructModel, cdc: StructCodec,
                   compiler: LaneCompiler, lane_action: np.ndarray,
                   action_names: Tuple[str, ...]):
    """The device coverage plane (jaxtlc/struct/backend.py:189-226): the
    site table is the per-action prefix, then the walk's sites; count
    returns the action-prefix counts, then the site increments (K22)."""
    from ..obs.coverage import CoveragePlane, Site, action_site_table

    cov_fn = compiler.build_cov(model.system.next_ast)
    idxs, conds = cov_fn(lanes.input_node(cdc.n_fields))
    fine_sites = tuple(Site(key=k, kind=kind, action=a, loc=desc)
                       for k, kind, a, desc in compiler.cov.sites)
    sites = tuple(action_site_table(model.root_name, action_names)
                  ) + fine_sites
    n_act = len(action_names)
    cov = StructCoverage(
        conds, [n_act + i for i in idxs], cdc, lane_action, n_act,
        len(sites), title=f"{model.root_name} ({model.source_digest}) "
        "coverage")
    plane = CoveragePlane(sites=sites, count=cov.count,
                          module=model.root_name)
    return plane, cov


def reduce_ops(model: StructModel, cdc: StructCodec, var_shapes: dict,
               action_names: Tuple[str, ...], symmetry: bool, por: bool):
    """The reduction capability of a backend (jaxtlc/struct/backend.py:
    228-257): the symmetric sets analysis.symfind verifies over the
    (possibly narrowed) shapes, the plan engine.reduce.build_plan realises
    over the codec (dropping, with reasons, sets it cannot), and the action
    ids POR may take; None when neither is asked for."""
    if not (symmetry or por):
        return None
    from ..analysis.speclint import analyze_spec
    from ..analysis.symfind import analyze_reduction
    from ..engine.reduce import ReduceOps, build_plan

    rep = analyze_reduction(model, analyze_spec(model, var_shapes=var_shapes))
    plan, dropped = (None, {})
    if symmetry:
        plan, dropped = build_plan(cdc, rep.symmetric_sets)
    safe_ids: Tuple[int, ...] = ()
    if por:
        safe_ids = tuple(action_names.index(a) for a in rep.safe_actions
                         if a in action_names)
    return ReduceOps(
        plan=plan, safe_ids=safe_ids, por=bool(por),
        sym_sets=(tuple(sorted(plan.sym_sets.items()))
                  if plan is not None else ()),
        dropped_sets=tuple(sorted({**rep.rejected_sets,
                                   **dropped}.items())))


def struct_backend(model: StructModel, check_deadlock: bool = True,
                   bounds=None, elide: bool = True,
                   coverage: bool = False, symmetry: bool = False,
                   por: bool = False) -> SpecBackend:
    """Compile `model` into a SpecBackend (the pipeline struct.cache
    memoizes in-process); `coverage` adds the device coverage plane.

    `bounds` (a CERTIFIED analysis.absint.BoundReport) swaps the widened
    inferred shapes for the certified reachable bounds, so the codec
    packs fewer bits; with `elide` (the default) the compiler drops the
    range traps and slot lanes the bounds prove safe and the backend
    carries the runtime certificate (kernel K23 inside K17 and K18), so an
    unsound bound turns the verdict loud instead of narrowing real states
    away.  `elide=False` narrows the codec, keeps every trap and carries
    no certificate (the sharded engines, which have no certificate
    column).  An uncertified report narrows nothing.

    `symmetry` / `por` (resolved bools) attach the state-space reduction
    (``SpecBackend.reduce``, an engine.reduce.ReduceOps): the program's
    text then canonicalizes every candidate and carries the orbit check
    (K24, K25) when a symmetric set survives, and prunes to singleton
    ample sets (K26) when some action is POR-safe."""
    system = model.system
    trap_policy = card_specs = None
    if bounds is not None and getattr(bounds, "certified", False):
        var_shapes = {v: bounds.bounds[v] for v in system.variables}
        if elide:
            trap_policy = TrapPolicy(elide_range=True,
                                     card_bounds=dict(bounds.card_bounds))
    else:
        bounds = None
        var_shapes = model_shapes(model)
    cdc, compiler, step_outputs, inv_outputs = compile_model(
        model, var_shapes, trap_policy)
    if trap_policy is not None:
        card_specs = _card_specs(cdc, system.variables, bounds.card_bounds)
    labels: List[str] = list(compiler.labels)
    action_names: Tuple[str, ...] = tuple(sorted(set(labels)))
    lane_action = np.asarray([action_names.index(x) for x in labels],
                             np.int32)
    red = reduce_ops(model, cdc, var_shapes, action_names, symmetry, por)
    prog = StructProgram(step_outputs, inv_outputs, cdc, lane_action,
                         len(action_names),
                         title=f"{model.root_name} ({model.source_digest})",
                         card_specs=card_specs,
                         plan=None if red is None else red.plan,
                         safe_ids=(red.safe_ids if red is not None
                                   and red.por_on else None))

    def initial_vectors():
        inits = system.initial_states()
        return np.stack([cdc.encode(st) for st in inits])

    plane = cov = None
    if coverage:
        plane, cov = coverage_plane(model, cdc, compiler, lane_action,
                                    action_names)
    viol_names = struct_viol_names(model)
    if bounds is not None:
        viol_names[VIOL_SLOT_OVERFLOW] = (
            "Codec slot overflow / certified-bound escape (narrowed "
            "codec: a value left the certified reachable range - "
            "re-run with -no-narrow; if that passes, report the spec: "
            "the bound certification is unsound)"
        )
    kernels = StructKernels(prog, cov)
    # trap-audit surface (range-trap sites, elided traps, reduced slot
    # lanes), as the reference's backend.cdc.trap_stats
    cdc.trap_stats = compiler.trap_stats
    return SpecBackend(
        cdc=cdc,
        n_lanes=len(labels),
        inv_check=prog.inv_bits_plain,
        inv_codes=tuple(VIOL_INVARIANT_BASE + k
                        for k in range(len(model.invariants))),
        initial_vectors=initial_vectors,
        labels=action_names,
        viol_names=viol_names,
        check_deadlock=check_deadlock,
        kernels=kernels,
        coverage=plane,
        cert_check=kernels.cert if card_specs is not None else None,
        reduce=red,
    )


def canonical_constants(model: StructModel) -> dict:
    """JSON-stable rendering of the model's resolved constants (the
    checkpoint-meta / cache-key form; frozensets sort, everything else
    goes through repr so model values and numbers stay distinct)."""
    out = {}
    for k in sorted(model.constants):
        v = model.constants[k]
        out[k] = (sorted(map(repr, v)) if isinstance(v, frozenset)
                  else repr(v))
    return out


def struct_meta_config(model: StructModel, bounds=None) -> dict:
    """The checkpoint `config` stanza for struct runs: digest + canonical
    constants + invariant list - everything that shapes the compiled
    step, so a -recover against a different spec text or overrides is a
    loud mismatch, never a silent misrun.  A narrowed run also records
    its bound digest: a narrowed checkpoint resumed without -narrow is a
    different carry layout and mismatches loudly."""
    out = {
        "frontend": "struct",
        "root": model.root_name,
        "digest": model.source_digest,
        "constants": canonical_constants(model),
        "invariants": list(model.invariants),
    }
    if bounds is not None:
        out["bound_digest"] = bounds.digest()
    return out
