"""The plain versions of the random walk's round (sim.engine), shared by
every walk program: a struct or generic spec's (struct.backend.
StructProgram, the plain versions of kernels K27 and K28) and KubeAPI's
(sim.kube.KubeWalk, those of kernels K39 and K40).

``WalkPlain`` works in place on the walk's buffers (sim.engine.SimBuffers)
as the kernels do, so the two compare buffer for buffer.  A program that
mixes it in supplies ``sim_lanes(states) -> (succ [W, L, F], valid, ovf,
afail [W, L] bool, action [W, L])`` - its step over the walkers' current
states, in its lane order, the successors as the reference's step returns
them - ``inv_bits_plain(fields) -> [N] int32`` (bit k set when invariant k
holds), ``cdc.pack``, ``n_inv``, ``n_labels`` and ``code_base``: the code
of invariant 0 (invariant k reports code_base + k).
"""

from __future__ import annotations

import torch

from ..engine.backend import (OK, VIOL_ASSERT, VIOL_DEADLOCK,
                              VIOL_SLOT_OVERFLOW)


class WalkPlain:
    """Torch versions of a walk round's two kernels: the step (K27 / K39)
    and the fold (K28 / K40)."""

    def sim_init_plain(self, buf, key, inits: torch.Tensor,
                       states: torch.Tensor) -> None:
        """The step kernel's kInit form, round 0 (jaxtlc/sim/engine.py:
        186-230): row l of states [W, F] int32 becomes Init vector bits %
        n0 of inits [n0, F] (bits the draw of (l, 0) under key); the
        invariants of the chosen states fold into buf.scratch; every lane
        packs its row and sets its take flag when the buffers carry
        them."""
        from . import engine as se
        from .threefry import lane_bits

        W = states.shape[0]
        bits = lane_bits(key, W, 0, states.device)
        states.copy_(inits[bits % inits.shape[0]])
        inv = self.inv_bits_plain(states)
        se.fold_classes(buf.scratch, [((inv >> k) & 1) == 0
                                      for k in range(self.n_inv)])
        if W:
            buf.scratch[se.SIM_ANY] = 1
        if buf.packed is not None:
            buf.packed.copy_(self.cdc.pack(states))
            buf.take.fill_(True)

    def sim_step_plain(self, buf, key, step_i: torch.Tensor,
                       states: torch.Tensor, alive: torch.Tensor,
                       steps_taken: torch.Tensor,
                       check_deadlock: bool) -> None:
        """The step kernel, one transition round (jaxtlc/sim/engine.py:
        232-315), a no-op while buf.go is 0: sim_lanes over the W current
        states, the enabled lanes of the live walkers, the draw of (lane,
        step_i + 1), the idx-th enabled lane (idx = bits mod the enabled
        count, unsigned), invariants on the chosen states only.  states,
        alive and steps_taken are updated in place; the partials (enabled
        lanes, transitions, the action histogram, any walker alive, the
        lowest lane of each violation class - invariants, assertion,
        deadlock with `check_deadlock`, slot overflow) fold into
        buf.scratch; a lane that trips the assertion or the slot overflow
        saves its old row to buf.vold, one that trips any class its action
        to buf.vact; the packed chosen rows and take flags go to
        buf.packed / buf.take when the buffers carry them."""
        from . import engine as se
        from .threefry import lane_bits

        if not int(buf.go[0]):
            return
        W = states.shape[0]
        dev = states.device
        d = step_i.to(torch.int64) + 1
        succ, valid, ovf, afail, action = self.sim_lanes(states)
        valid = valid & alive[:, None]
        n = valid.sum(1)
        dead = alive & (n == 0)
        bits = lane_bits(key, W, d, dev)
        idx = bits % n.clamp(min=1)
        csum = torch.cumsum(valid.to(torch.int64), 1)
        chosen = ((csum == (idx + 1)[:, None]) & valid).to(
            torch.int32).argmax(1)
        take = alive & (n > 0)
        rows = torch.arange(W, device=dev)
        new = torch.where(take[:, None], succ[rows, chosen].to(torch.int32),
                          states)
        acts = action[rows, chosen].to(torch.int32)
        ch_afail = take & afail[rows, chosen]
        ch_ovf = take & ovf[rows, chosen]
        inv = self.inv_bits_plain(new)
        inv_bad = [take & (((inv >> k) & 1) == 0) for k in range(self.n_inv)]
        old = ch_afail | ch_ovf
        buf.vold[old] = states[old]
        tripped = old.clone()
        for bad in inv_bad:
            tripped |= bad
        buf.vact[tripped] = acts[tripped]
        none = torch.zeros_like(take)
        se.fold_classes(buf.scratch, inv_bad + [
            ch_afail, dead if check_deadlock else none, ch_ovf])
        se.fold_add(buf.scratch, se.SIM_GEN, valid.sum())
        se.fold_add(buf.scratch, se.SIM_TRANS, take.sum())
        buf.scratch[se.SIM_ANY] |= take.any().to(torch.int32)
        hist = torch.zeros(self.n_labels, dtype=torch.int64, device=dev)
        hist.index_add_(0, torch.where(take, acts, 0).to(torch.int64),
                        take.to(torch.int64))
        h0 = se.hist_offset(self.n_inv)
        se.fold_add(buf.scratch[h0:h0 + self.n_labels], slice(None), hist)
        states.copy_(new)
        alive.copy_(take)
        steps_taken.copy_(torch.where(take, d.to(torch.int32), steps_taken))
        if buf.packed is not None:
            buf.packed.copy_(self.cdc.pack(new))
            buf.take.copy_(take)

    def sim_fold_plain(self, buf, carry, depth: int,
                       init: bool = False) -> None:
        """The fold kernel (jaxtlc/sim/engine.py:264-290 and the counters
        of :292-315), a no-op while buf.go is 0 unless `init`: while the
        carry's violation is OK, the first class with a lane in
        buf.scratch (invariants in order, assertion, deadlock, slot
        overflow) sets viol, viol_lane, viol_step, viol_state (the new
        row, or buf.vold's for the assertion and the slot overflow) and
        viol_action (buf.vact's; -1 for a deadlock and on round 0); the
        partials add to the uint32 counters (wrapping), step_i advances,
        buf.go is rewritten and the scratch reset.  In place."""
        from . import engine as se

        if not init and not int(buf.go[0]):
            return
        sc = buf.scratch
        c = carry
        d = 0 if init else int(c.step_i) + 1
        mins = sc[se.SIM_MIN:se.SIM_MIN + self.n_inv + 3].tolist()
        cls = next((k for k, v in enumerate(mins) if v != se.SIM_NONE), -1)
        if int(c.viol) == OK and cls >= 0:
            lane = mins[cls]
            code = (self.code_base + cls if cls < self.n_inv else
                    (VIOL_ASSERT, VIOL_DEADLOCK,
                     VIOL_SLOT_OVERFLOW)[cls - self.n_inv])
            c.viol.fill_(code)
            c.viol_lane.fill_(lane)
            c.viol_step.fill_(d)
            src = buf.vold if cls in (self.n_inv, self.n_inv + 2) \
                else c.states
            c.viol_state.copy_(src[lane])
            c.viol_action.fill_(-1 if init or cls == self.n_inv + 1
                                else int(buf.vact[lane]))
        if not init:
            se.u32_set(c.generated, se.u32_get(c.generated)
                       + se.u32_word(sc[se.SIM_GEN]))
            se.u32_set(c.transitions, se.u32_get(c.transitions)
                       + se.u32_word(sc[se.SIM_TRANS]))
            c.step_i.fill_(d)
        h0 = se.hist_offset(self.n_inv)
        se.u32_set(c.act_taken, se.u32_get(c.act_taken)
                   + se.u32_word(sc[h0:h0 + self.n_labels]))
        buf.go.fill_(int(d < depth and int(c.viol) == OK
                         and int(sc[se.SIM_ANY]) != 0))
        se.scratch_reset(sc, self.n_inv)
