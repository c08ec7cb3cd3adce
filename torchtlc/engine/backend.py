"""KubeAPI backend, the expand stage of a BFS step and the deferred
invariant checker (port of jaxtlc/engine/backend.py:135-477).

``expand_block`` is the wrapper of kernel K1 (torchtlc/kernels/csrc/
expand.cu): one launch replaces the reference's unpack -> next-state
kernel -> canonicalize -> invariants -> pack chain plus the per-action
generated counters.  For a popped block of ``ck`` packed rows it returns,
per candidate lane (``ck * L`` of them, lane-major within a row):

* ``packed [ck*L, W]`` int32 - the canonical successor, packed;
* ``flags [5, ck*L]`` uint8 - rows FLAG_VALID, FLAG_AFAIL, FLAG_OVF,
  FLAG_BAD_TYPEOK, FLAG_BAD_ONLYONE (each already masked by validity,
  and validity by the pop mask);
* ``action [ck*L]`` int32 - the acting label id;
* ``gen [n_labels]`` int64 - generated successors per action.

``expand_plain`` is the same function in torch (the CPU path, and the
yardstick the kernel is held against on the card).  ``deferred=True`` (the
reference's mode at chunk >= 2048) skips the invariants there: the flag
rows FLAG_BAD_TYPEOK and FLAG_BAD_ONLYONE stay zero, and the commit stage
runs ``deferred_check`` (kernel K7, torchtlc/kernels/csrc/deferred.cu) on
the fresh-insert claimants instead.

``kubeapi_backend(cfg, coverage=True)`` adds the device coverage plane
(spec.coverage_device): the expand stage then counts the block's 311 site
increments (kernel K10, torchtlc/kernels/csrc/coverage.cu) on K1's valid
flags, before dedup, in every mode.

``KubeKernels`` also carries the random walk's round (sim.engine): kernel
K39 ``kube_sim_step`` and K40 ``kube_sim_fold`` (torchtlc/kernels/csrc/
kube_sim.cu) on CUDA tensors, their plain versions (sim.kube.KubeWalk,
make_kernel and the invariant kernel under sim.plain.WalkPlain) on CPU
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelConfig
from ..spec.codec import get_codec
from ..spec.invariants import make_invariant_kernel
from ..spec.kernel import initial_vectors, lane_layout, make_kernel
from ..spec.labels import LABEL_ID, LABELS
from .fingerprint import DEFAULT_FP_INDEX, fp64_words

# violation codes (jaxtlc/engine/bfs.py:53-61)
OK = 0
VIOL_TYPEOK = 1
VIOL_ONLYONEVERSION = 2
VIOL_ASSERT = 3
VIOL_DEADLOCK = 4
VIOL_SLOT_OVERFLOW = 5
VIOL_FPSET_FULL = 6
VIOL_QUEUE_FULL = 7
VIOL_ROUTE_OVERFLOW = 8  # the sharded engine's bucket overflow

FLAG_VALID, FLAG_AFAIL, FLAG_OVF, FLAG_BAD_TYPEOK, FLAG_BAD_ONLYONE = range(5)


class SpecBackend(NamedTuple):
    """What the engines need from a spec frontend (the reference's
    SpecBackend, jaxtlc/engine/backend.py:50-91).  kernels holds the
    backend's own kernel routes for the expand stage and the deferred
    check - KubeAPI's K1 and K7 (KubeKernels), a struct spec's K17 and K18
    (struct.backend.StructKernels), a generic spec's K19
    (gen.program.GenKernels) - and for the sharded engine's expand and
    received-rows check (``expand_sharded``, ``deferred_rows``: K1's and
    K7's sharded variants, or K21 and K18 on an emitted backend): the
    port's counterpart of the reference's step, inv_check, lane_action and
    expand override, which those kernels (and their plain versions)
    implement."""

    cdc: object  # pack / unpack / n_fields / n_words / nbits
    n_lanes: int
    inv_check: object  # fields [N, F] -> [N] int32, bit k = invariant k holds
    inv_codes: tuple  # invariant bit k failing reports this code
    initial_vectors: object  # () -> [n0, F] numpy int32
    labels: tuple  # action id -> display name
    viol_names: dict  # code -> name overrides (VIOLATION_NAMES fallback)
    check_deadlock: bool = True  # TLC's -deadlock switch
    # .expand(block, n, deferred), .deferred(...), .expand_sharded(...),
    # .deferred_rows(...)
    kernels: object = None
    # the device coverage plane (obs.coverage.CoveragePlane) or None: pure
    # telemetry, so coverage-on results are coverage-off results
    coverage: object = None
    cfg: ModelConfig = None  # the KubeAPI model (None for other specs)
    # the runtime certificate of a narrowed (certified-bound) struct
    # backend, or None: fn(rows [N, F] int32, valid [N] bool) -> 0-dim
    # bool, some valid row violates a claimed bound (kernel K23, its plain
    # version on CPU tensors).  The engines take it from the expand and
    # deferred routes (K17 and K18 evaluate it); it feeds only the sticky
    # certificate leaf and ring column, no arbitration
    cert_check: object = None
    # the state-space reduction of a struct backend (engine.reduce.
    # ReduceOps: a symmetry plan and/or POR-safe action ids), or None.  The
    # expand route runs it (K24-K26 inside K17 and K21, K25 after K17):
    # ExpandOut.sym and ExpandOut.pruned
    reduce: object = None


def gen_backend(spec, prog=None) -> SpecBackend:
    """Generic-frontend backend (jaxtlc/engine/backend.py:480): the spec's
    compiled program (gen.program.GenProgram, built here unless given)
    and codec behind the SpecBackend seam, its routes kernel K19 (the
    liveness enumerator and capture), K21 and K18 (the sharded engine)
    and K27 and K28 (the random walk, from the spec's walk text)."""
    from ..gen.engine import VIOL_INVARIANT_BASE
    from ..gen.kernel import initial_field_vectors
    from ..gen.program import GenKernels, GenProgram

    prog = prog or GenProgram(spec)
    inv_names = list(spec.invariants.keys())
    return SpecBackend(
        cdc=prog.cdc,
        n_lanes=prog.L,
        inv_check=prog.inv_bits_plain,
        inv_codes=tuple(VIOL_INVARIANT_BASE + k
                        for k in range(len(inv_names))),
        initial_vectors=lambda: np.asarray(
            initial_field_vectors(spec, prog.cdc)),
        labels=tuple(a.name for a in spec.actions),
        viol_names={VIOL_INVARIANT_BASE + k: f"Invariant {n} is violated"
                    for k, n in enumerate(inv_names)},
        kernels=GenKernels(prog),
    )


class KubeKernels(NamedTuple):
    """KubeAPI's kernel routes: K1 (expand_block) and K7 (deferred_check),
    the sharded engine's K1 and K7 variants, and the random walk's round,
    K39 and K40 (kube_sim.cu; ``prog`` is the walk program, sim.kube.
    KubeWalk), each on a CUDA tensor, its plain version on a CPU
    tensor."""

    cfg: ModelConfig

    @property
    def prog(self):
        """The walk program (sim.kube.KubeWalk): the sizes of the walk's
        buffers and the plain versions of K39 and K40."""
        from ..sim.kube import kube_walk

        return kube_walk(self.cfg)

    def expand(self, block, n: int, deferred: bool = False):
        """-> (packed, flags [5, ck*L], action, gen, flat=None,
        cert=None, sym=None, pruned=None)."""
        return (*expand_block(self.cfg, block, n, deferred), None, None,
                None, None)

    def deferred(self, ex, is_new_c, c_idx, rows: int):
        """-> (viol, state, action, cert=None)."""
        return (*deferred_check(self.cfg, ex.block, is_new_c, c_idx,
                                ex.action, rows), None)

    def expand_sharded(self, queue, qhead, npop, ck: int,
                       deferred: bool = False, with_block: bool = False):
        """The sharded engine's expand: K1's sharded variant."""
        from .sharded import expand_sharded

        return expand_sharded(self.cfg, queue, qhead, npop, ck, deferred,
                              with_block)

    def deferred_rows(self, rows_in, fresh, c_idx, rows: int):
        """The sharded engine's received-rows check: K7's variant."""
        from .sharded import deferred_check_rows

        return deferred_check_rows(self.cfg, rows_in, fresh, c_idx, rows)

    # the random walk's round (sim.engine): kernels K39 and K40 on CUDA
    # tensors, their plain versions (sim.plain.WalkPlain over make_kernel
    # and the invariant kernel) on CPU tensors; a failed build or launch
    # raises

    def sim_init(self, buf, key, inits, states) -> None:
        if not states.is_cuda:
            return self.prog.sim_init_plain(buf, key, inits, states)
        from ..kernels import ops

        ops.kube_sim_init(self.prog, buf, key, inits, states)

    def sim_step(self, buf, key, step_i, states, alive, steps_taken,
                 check_deadlock: bool) -> None:
        if not states.is_cuda:
            return self.prog.sim_step_plain(buf, key, step_i, states, alive,
                                            steps_taken, check_deadlock)
        from ..kernels import ops

        ops.kube_sim_step(self.prog, buf, key, step_i, states, alive,
                          steps_taken, check_deadlock)

    def sim_fold(self, buf, carry, depth: int, init: bool = False) -> None:
        if not carry.states.is_cuda:
            return self.prog.sim_fold_plain(buf, carry, depth, init)
        from ..kernels import ops

        ops.kube_sim_fold(self.prog, buf, carry, depth, init)


def kubeapi_backend(cfg: ModelConfig, coverage: bool = False) -> SpecBackend:
    cdc = get_codec(cfg)
    plane = None
    if coverage:
        from ..spec.coverage_device import kubeapi_coverage_plane

        plane = kubeapi_coverage_plane(cfg)
    return SpecBackend(
        cdc=cdc,
        n_lanes=lane_layout(cfg)[1],
        inv_check=make_invariant_kernel(cfg),
        inv_codes=(VIOL_TYPEOK, VIOL_ONLYONEVERSION),
        initial_vectors=lambda: initial_vectors(cfg),
        labels=LABELS,
        viol_names={},
        kernels=KubeKernels(cfg),
        coverage=plane,
        cfg=cfg,
    )


def gen_counts(cfg: ModelConfig, batch: torch.Tensor, valid: torch.Tensor):
    """Per-action generated counters through the dispatch structure: every
    lane of client ci fires ci's current pc label; server lanes are
    APIStart.  batch [ck, F] fields, valid [ck, L] -> [n_labels] int64."""
    cdc = get_codec(cfg)
    CL, _ = lane_layout(cfg)
    nc = cdc.nc
    pc_off = cdc.offsets["pc"]
    counts = torch.zeros(len(LABELS), dtype=torch.int64, device=batch.device)
    for ci in range(nc):
        vc = valid[:, ci * CL:(ci + 1) * CL].sum(1)
        pc = batch[:, pc_off + ci].to(torch.int64)
        inside = pc < len(LABELS)
        counts.index_add_(0, torch.where(inside, pc, 0), vc * inside)
    counts[LABEL_ID["APIStart"]] += valid[:, nc * CL:].sum()
    return counts


def expand_plain(cfg: ModelConfig, block: torch.Tensor, n: int,
                 deferred: bool = False):
    """Torch version of kernel K1: (packed, flags, action, gen)."""
    cdc = get_codec(cfg)
    ck = block.shape[0]
    batch = cdc.unpack(block)
    succ, valid, action, afail, ovf = make_kernel(cfg)(batch)
    mask = torch.arange(ck, device=block.device) < n
    valid = valid & mask[:, None]
    afail = afail & valid
    ovf = ovf & valid
    flat = succ.reshape(-1, cdc.n_fields)
    fvalid = valid.reshape(-1)
    if deferred:  # every invariant holds until the deferred check
        bits = torch.full_like(fvalid, 3, dtype=torch.int32)
    else:
        bits = make_invariant_kernel(cfg)(flat)
    flags = torch.stack([
        fvalid, afail.reshape(-1), ovf.reshape(-1),
        fvalid & ((bits & 1) == 0), fvalid & ((bits & 2) == 0),
    ]).to(torch.uint8)
    return (cdc.pack(flat), flags, action.reshape(-1),
            gen_counts(cfg, batch, valid))


def expand_block(cfg: ModelConfig, block: torch.Tensor, n: int,
                 deferred: bool = False):
    """Expand the first n rows of a popped block ([ck, W] int32): kernel
    K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if not block.is_cuda:
        return expand_plain(cfg, block, n, deferred)
    from ..kernels import ops

    return ops.expand(cfg, block, n, deferred)


class ExpandOut(NamedTuple):
    """Output of the expand stage: what the commit stage needs."""

    packed: torch.Tensor  # [ck*L, W] int32
    lo: torch.Tensor  # [ck*L] int32 fingerprint low words
    hi: torch.Tensor  # [ck*L] int32
    valid: torch.Tensor  # [ck*L] bool
    action: torch.Tensor  # [ck*L] int32
    gen: torch.Tensor  # [n_labels] int64
    viol: torch.Tensor  # 0-dim int64: first-wins expand-stage violation
    viol_words: torch.Tensor  # [W] int32: its state, packed
    viol_action: torch.Tensor  # 0-dim int64
    block: torch.Tensor  # [chunk, W] int32: the popped rows (deferred check)
    # [n_sites] int32 (uint32 words): this block's coverage site increments
    # (None without a coverage plane)
    cov: torch.Tensor = None
    # [ck*L, F] int32 raw successor fields, in deferred mode on backends
    # whose deferred check reads them (struct; the reference's
    # ExpandOut.flat), else None
    flat: torch.Tensor = None
    # 0-dim bool: some valid successor of this block violated a certified
    # bound (immediate mode of a backend with a certificate, else None)
    cert: torch.Tensor = None
    # 0-dim bool: the block's orbit check failed (K25; a backend with a
    # symmetry plan, else None)
    sym: torch.Tensor = None
    # 0-dim int64: candidate lanes the POR ample sets pruned in this block
    # (K26 inside K17; a backend that prunes, else None)
    pruned: torch.Tensor = None


def make_expand_stage(backend: SpecBackend, chunk: int,
                      deferred: bool = False,
                      fp_index: int = DEFAULT_FP_INDEX):
    """expand(block [chunk, W] int32, n) -> ExpandOut: the backend's
    expand kernel (K1 for KubeAPI, K17 for a struct spec), the deadlock
    mask, fingerprints (kernel K2) and the first-wins violation
    (invariants in inv_codes order > assert > deadlock > slot overflow;
    with deferred=True the invariants are not evaluated here, so the
    reduce covers assert > deadlock > slot overflow).

    The violating state is carried packed (viol_words); the engine unpacks
    it on the host once a violation is read back.  With a coverage plane
    the stage also counts the block's site increments (ExpandOut.cov) on
    the valid flags, which already carry the pop mask.  A reduced backend's
    expand route returns the block's orbit check (ExpandOut.sym, K25) and
    pruned count (ExpandOut.pruned, K26 inside K17); its valid flags are
    the lanes K26 kept and its candidates canonical (K24 inside K17).
    expand.finish(block, n, *kernel outputs, lo=, hi=) is the stage after
    the kernel, for a caller that ran the kernel itself (the serving
    plane's batched engine, engine.batched)."""
    cdc = backend.cdc
    L = backend.n_lanes
    nbits = cdc.nbits
    n_inv = len(backend.inv_codes)
    kernels = backend.kernels
    # the candidates of the reduce, in priority order: the invariant rows
    # of the flags (3 + k), assert, deadlock, slot overflow
    codes = torch.tensor(backend.inv_codes + (VIOL_ASSERT, VIOL_DEADLOCK,
                                              VIOL_SLOT_OVERFLOW))
    codes_on = {}  # device -> codes there
    lane_rows = list(range(3, 3 + n_inv)) + [FLAG_AFAIL, FLAG_OVF]

    def finish(block: torch.Tensor, n: int, packed, flags, action, gen,
               flat=None, cert=None, sym=None, pruned=None, lo=None,
               hi=None) -> ExpandOut:
        # the stage after the backend's expand kernel; lo / hi when the
        # caller fingerprinted the candidates already (the batched engine
        # runs K2 once over every lane's block)
        dev = block.device
        valid = flags[FLAG_VALID].bool()
        cov = None
        if backend.coverage is not None:
            cov = backend.coverage.count(block, n, flags[FLAG_VALID])
        # deadlock: a popped state with no valid successor (TLC's
        # -deadlock check).  Under POR the valid flags are the lanes K26
        # kept, and that is still the pre-pruning test: a row with a valid
        # lane always keeps one (the lowest-id safe enabled action is
        # enabled), so pruning never makes or hides a deadlock
        dead = ~valid.view(chunk, L).any(1)
        dead[n:] = False
        if not backend.check_deadlock:
            dead[:] = False
        # first hit per mask, in priority order
        lane_masks = flags[lane_rows]
        lane_first = lane_masks.argmax(1)
        lane_any = lane_masks.amax(1) > 0
        d_first = dead.to(torch.uint8).argmax()
        hits = torch.cat([lane_any[:n_inv + 1], dead.any().view(1),
                          lane_any[n_inv + 1:]])
        # gathers with 1-D device indices: indexing with a 0-dim CUDA
        # tensor would read it back to the host
        words = torch.cat([
            packed.index_select(0, lane_first[:n_inv]),
            block.index_select(0, torch.stack([
                lane_first[n_inv] // L, d_first, lane_first[n_inv + 1] // L])),
        ])
        acts = torch.cat([
            action.index_select(0, lane_first[:n_inv + 1]),
            torch.full((1,), -1, dtype=torch.int32, device=dev),
            action.index_select(0, lane_first[n_inv + 1:]),
        ]).to(torch.int64)
        k = hits.to(torch.uint8).argmax().view(1)
        hit = hits.any()
        if lo is None:
            lo, hi = fp64_words(packed, nbits, fp_index)
        if dev not in codes_on:
            codes_on[dev] = codes.to(dev)
        return ExpandOut(
            packed=packed, lo=lo, hi=hi, valid=valid, action=action, gen=gen,
            viol=torch.where(hit, codes_on[dev].index_select(0, k)[0], OK),
            viol_words=words.index_select(0, k)[0],
            viol_action=torch.where(hit, acts.index_select(0, k)[0], -1),
            block=block, cov=cov, flat=flat, cert=cert, sym=sym,
            pruned=pruned,
        )

    def expand(block: torch.Tensor, n: int) -> ExpandOut:
        return finish(block, n, *kernels.expand(block, n, deferred))

    expand.finish = finish
    return expand


# ---------------------------------------------------------------------------
# deferred invariants on the fresh-insert claimants (kernel K7)
# ---------------------------------------------------------------------------


def deferred_check_plain(cfg: ModelConfig, block: torch.Tensor,
                         fresh: torch.Tensor, c_idx: torch.Tensor,
                         action: torch.Tensor, rows: int):
    """Torch version of kernel K7: the invariants of the fresh claimants
    among the first `rows` rows of an insert's (is_new_c, c_idx), each
    candidate's raw successor derived again from its popped source row
    (lane // L) and lane (lane % L).  First wins across TypeOK,
    OnlyOneVersion; within a code the highest violating lane.  Returns
    (viol 0-dim int64, state [F] int32 raw successor fields, action 0-dim
    int64); (OK, zeros, -1) when every fresh claimant passes."""
    cdc = get_codec(cfg)
    _, L = lane_layout(cfg)
    dev = block.device
    lanes = c_idx[:rows][fresh[:rows].bool()]
    viol, state, vaction = OK, torch.zeros(cdc.n_fields, dtype=torch.int32,
                                            device=dev), -1
    if lanes.numel():
        succ = make_kernel(cfg)(cdc.unpack(block[lanes // L]))[0]
        flat = succ[torch.arange(lanes.numel(), device=dev), lanes % L]
        bits = make_invariant_kernel(cfg)(flat)
        for k, code in enumerate((VIOL_TYPEOK, VIOL_ONLYONEVERSION)):
            bad = (bits & (1 << k)) == 0
            if bad.any():
                j = int(torch.argmax(torch.where(bad, lanes, -1)))
                viol, state = code, flat[j].to(torch.int32)
                vaction = int(action[lanes[j]])
                break

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    return i64(viol), state, i64(vaction)


def deferred_check(cfg: ModelConfig, block, fresh, c_idx, action,
                   rows: int):
    """Kernel K7 on CUDA tensors, the plain version on CPU tensors."""
    if not block.is_cuda:
        return deferred_check_plain(cfg, block, fresh, c_idx, action, rows)
    from ..kernels import ops

    return ops.deferred_check(cfg, block, fresh, c_idx, action, rows)


def make_deferred_checker(backend: SpecBackend):
    """The commit-stage invariant check over the fresh-insert claimants
    (jaxtlc/engine/backend.py:325), through the backend's kernel (K7 for
    KubeAPI, K18 for a struct spec).  TLC checks a state when it is first
    generated, and first generation is the fresh insert, so the verdict is
    the immediate mode's; the reported state is the violating fresh
    claimant with the HIGHEST candidate lane (the reference's pinned
    attribution rule), first wins across the invariants in inv_codes
    order.

    Returns check(ex: ExpandOut, is_new_c, c_idx, rows) -> (viol,
    viol_state [F], viol_action, cert); `rows` bounds the rows that can be
    fresh (R on the slab path, the whole batch on the sorted one).  cert
    is the fresh claimants' certificate (K23 inside K18) on a backend that
    carries one, else None: in the deferred mode only fresh claimants are
    certified (jaxtlc/engine/backend.py:335-341)."""
    kernels = backend.kernels

    def check(ex, is_new_c, c_idx, rows: int):
        return kernels.deferred(ex, is_new_c, c_idx, rows)

    return check


def kernel_layout(cfg: ModelConfig) -> np.ndarray:
    """The Layout struct K1 takes (kubeapi.cuh), as int32 words in the
    header's field order."""
    from ..config import RECONCILER

    cdc = get_codec(cfg)
    CL, L = lane_layout(cfg)
    MAXC, MAXI, MAXF = 8, 16, 96
    assert cdc.nc <= MAXC and cdc.ni <= MAXI and cdc.n_fields <= MAXF, (
        "config exceeds the expand kernel's compiled bounds")
    O = cdc.offsets
    mut = {"": 0, "delete_noop": 1, "sticky_reconcile": 2}[cfg.mutation]

    def obj_word(i):
        return (1 << cdc.o_present) | (i << cdc.o_ident)

    role, secret_w, pvc_w, secret_kind, sr_idx = [], [], [], [], []
    for ci in range(cdc.nc):
        if cfg.roles[ci] == RECONCILER:
            si, pi = cfg.targets[ci]
            role.append(0)
            secret_w.append(obj_word(si))
            pvc_w.append(obj_word(pi))
            secret_kind.append(cdc.kind_id[cfg.identities[si][0]])
            sr_idx.append(cfg.sr_index(ci))
        else:
            role.append(1)
            secret_w.append(0)
            pvc_w.append(0)
            secret_kind.append(0)
            sr_idx.append(0)

    def pad(xs, n):
        return list(xs) + [0] * (n - len(xs))

    words = [
        cdc.ni, cdc.nc, cdc.ls, cdc.nr, cdc.ib, cdc.kb, cdc.lb, len(cfg.kinds),
        cdc.o_spec, cdc.o_vv, cdc.o_hasvv, cdc.o_ident, cdc.o_present,
        cdc.obj_bits,
        cdc.r_obj, cdc.r_status, cdc.r_op, cdc.r_present,
        cdc.lm_status, cdc.lm_kind, cdc.lm_present,
        cdc.s_retpc, cdc.s_proc, cdc.s_present,
        cdc.n_fields, cdc.n_words, cdc.nbits, CL, L,
        int(cfg.requests_can_fail), int(cfg.requests_can_timeout), mut,
        cdc.kind_id.get("PVC", -1),
        O["api"], O["req"], O["lreq_meta"], O["lreq_obj"], O["pc"],
        O["stack"], O["p_op"], O["p_obj"], O["p_kind"], O["sr"],
        *pad(cdc.lane_widths, MAXF),
        *pad(role, MAXC), *pad(secret_w, MAXC), *pad(pvc_w, MAXC),
        *pad(secret_kind, MAXC), *pad(sr_idx, MAXC),
        *pad([cdc.kind_id[k] for k, _ in cfg.identities], MAXI),
    ]
    return np.asarray(words, dtype=np.int32)
