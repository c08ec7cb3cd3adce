"""The KubeAPI spec as a walk program: what the random walk (sim.engine)
needs from it, the plain versions of kernels K39 ``kube_sim_step`` and K40
``kube_sim_fold`` (torchtlc/kernels/csrc/kube_sim.cu) included.

``KubeWalk(cfg)`` is ``KubeKernels.prog`` (engine.backend): its sizes size
the walk's buffers, and through sim.plain.WalkPlain its step is
spec.kernel's ``make_kernel`` - the next-state function the expand stage's
plain version (engine.backend.expand_plain) runs, the canonical
successors with each lane's action - and its invariants
spec.invariants' TypeOK and OnlyOneVersion (codes 1 and 2,
jaxtlc/engine/bfs.py:53-54).
"""

from __future__ import annotations

import functools

import torch

from ..config import ModelConfig
from ..spec.codec import get_codec
from ..spec.invariants import make_invariant_kernel
from ..spec.kernel import lane_layout, make_kernel
from ..spec.labels import LABELS
from .plain import WalkPlain


class KubeWalk(WalkPlain):
    """One KubeAPI model's walk program."""

    n_inv = 2
    n_labels = len(LABELS)
    code_base = 1  # VIOL_TYPEOK; OnlyOneVersion is 2

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.cdc = get_codec(cfg)
        self.F = self.cdc.n_fields
        self.W = self.cdc.n_words
        self.L = lane_layout(cfg)[1]
        self.inv_bits_plain = make_invariant_kernel(cfg)
        self._step = make_kernel(cfg)

    def sim_lanes(self, states: torch.Tensor):
        """make_kernel's step over the walkers' states [W, F] -> (succ
        [W, L, F], valid, ovf, afail [W, L], action [W, L] int32)."""
        succ, valid, action, afail, ovf = self._step(states)
        return succ, valid, ovf, afail, action


@functools.lru_cache(maxsize=None)
def kube_walk(cfg: ModelConfig) -> KubeWalk:
    """The walk program of `cfg` (one a model in a process)."""
    return KubeWalk(cfg)
