"""The inference driver: conjecture -> filter -> certify, warm-servable.

`run_infer(model, ...)` is the library entrypoint the CLI/API path
calls; `InferEngine` is the warm form - the candidate pool, the one
emitted library that holds the [P, S] filter kernel (K29) and the
certify kernel (K30), and the exact evidence are all built ONCE per
(model, budget, walk geometry) class, so `run()` is launches only.

Evidence-mode resolution happens at build time (the reachable set is a
pure function of the model): a stored reachable-set artifact wins
(struct.artifacts), a host-BFS within budget
is the exact fallback, and anything bigger samples walk states - per
run, because sampled evidence is seed-dependent.  Exact evidence is
cached on the engine (and on its device) and the host BFS's rows in
this module, per spec and budget; every run re-filters against it (the
filter IS the cheap part - that is the point of the [P, S] kernel).

The port of jaxtlc/infer/driver.py.  The engine runs on `device` (None:
the card): K29's fold form kills candidates round by round, its matrix
form gives Init => cand, K30 gives the closure bits; on the CPU the plain
versions.  The walls are taken after a ``torch.cuda.synchronize()`` on
the card.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .candidates import Candidate, DEFAULT_BUDGET, conjecture
from .certify import certify_closed, make_certify_fn
from .filter import (
    DEFAULT_MAX_HOST_STATES,
    artifact_fields,
    bfs_fields,
    compile_predicates,
    filter_matrix,
    make_filter_fn,
    predicate_compiler,
    sim_fields,
)

DEFAULT_INFER_WALKERS = 64
DEFAULT_INFER_DEPTH = 64


_HOST_BFS: OrderedDict = OrderedDict()


def _host_bfs_fields(model, backend, check_deadlock: bool,
                     max_states: int) -> Optional[np.ndarray]:
    """bfs_fields' evidence rows (None: the space exceeds `max_states`),
    memoized on the spec's meaning and the budget like struct.cache's
    layers: the reachable set is a pure function of the model, and an
    engine per budget or a command after an engine need not walk it (or
    its first `max_states` states) again."""
    from ..struct.cache import _memo, model_key

    key = (model_key(model), int(max_states))
    return _memo(_HOST_BFS, key, lambda: (bfs_fields(
        model, backend, check_deadlock, max_states=max_states) or (None,)
    )[:1], cap=8)[0]


class InferReport(NamedTuple):
    """What one inference run established."""

    candidates: int
    dropped: int  # conjectures beyond the budget (coverage honesty)
    uncompiled: Tuple[str, ...]  # candidates outside the lane subset
    evidence: str  # "artifact" | "bfs" | "sim"
    exact: bool  # evidence covers the full reachable set
    n_states: int
    rounds: Tuple[dict, ...]  # per-round kill accounting
    killed: int
    survivors: Tuple[Candidate, ...]
    certified: Tuple[Candidate, ...]
    cert_basis: Tuple[str, ...]  # per certified: "reachable-inductive"
    #                              or "absint"
    cfg_killed: Tuple[str, ...]  # named cfg invariants refuted by
    #                              EXACT evidence (a real violation)
    wall_s: float
    filter_wall_s: float
    certify_wall_s: float
    seed: int

    def certified_lines(self) -> List[str]:
        """The paste-into-your-spec rendering."""
        return [
            f"{c.name} == {c.text}" if c.source != "cfg" else c.name
            for c in self.certified
        ]


class InferEngine:
    """Warm inference engine: one entry per (model, budget, walk
    geometry, deadlock, host-BFS budget) class in the serve pool."""

    def __init__(self, model, budget: int = DEFAULT_BUDGET,
                 walkers: int = DEFAULT_INFER_WALKERS,
                 depth: int = DEFAULT_INFER_DEPTH,
                 check_deadlock: bool = True,
                 max_host_states: int = DEFAULT_MAX_HOST_STATES,
                 device=None):
        from ..engine.bfs import resolve_device
        from ..struct.cache import get_backend, get_bounds

        self.model = model
        self.budget = int(budget)
        self.walkers = int(walkers)
        self.depth = int(depth)
        self.check_deadlock = bool(check_deadlock)
        self.max_host_states = int(max_host_states)
        self.device = resolve_device(device)

        self.bounds = get_bounds(model)
        self.candidates, self.dropped = conjecture(
            model, bounds=self.bounds, budget=self.budget
        )
        self.backend = get_backend(model, self.check_deadlock)
        compiler = predicate_compiler(model, self.backend)
        self.inv_fns, unc = compile_predicates(compiler,
                                               self.candidates)
        self.uncompiled = tuple(self.candidates[i].name for i in unc)
        self._uncompiled_ix = np.zeros(len(self.candidates), bool)
        self._uncompiled_ix[list(unc)] = True

        # one library holds K29 and K30, built here on the card (the
        # reference's AOT moment): warm runs are launches
        self.filter_fn = make_filter_fn(self.inv_fns, self.backend,
                                        self.device)
        self.certify_fn = make_certify_fn(self.backend, self.inv_fns,
                                          self.device)
        self.program = self.filter_fn.prog
        if self.device.type == "cuda" and self.program.P:
            from ..kernels import ops

            ops.infer_lib(self.program)

        # evidence-mode resolution (build-time: pure function of the
        # model; exact evidence caches on the engine)
        self.exact_fields: Optional[np.ndarray] = None
        fields = artifact_fields(model, self.backend,
                                 self.check_deadlock)
        if fields is not None:
            self.evidence = "artifact"
            self.exact_fields = fields.astype(np.int32)
        else:
            fields = _host_bfs_fields(model, self.backend,
                                      self.check_deadlock,
                                      self.max_host_states)
            if fields is not None:
                self.evidence = "bfs"
                self.exact_fields = fields
            else:
                self.evidence = "sim"
        self.init_fields = np.asarray(
            self.backend.initial_vectors()).astype(np.int32)
        # the exact evidence on the run's device, uploaded once
        self._exact_rows = (None if self.exact_fields is None
                            else self.filter_fn.rows(self.exact_fields))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wall(self, t0: float) -> float:
        self._sync()
        return time.time() - t0

    # -- one run -----------------------------------------------------------

    def run(self, seed: int = 0, on_round=None) -> InferReport:
        t0 = time.time()
        P = len(self.candidates)
        alive = np.ones(P, bool)
        rounds: List[dict] = []
        filter_wall = 0.0

        if self.exact_fields is not None:
            chunks = [self._exact_rows]
        else:
            chunks = sim_fields(self.model, self.walkers, self.depth,
                                seed, self.check_deadlock,
                                device=self.device)
        n_states = 0
        for i, fields in enumerate(chunks):
            n_states += fields.shape[0]
            self._sync()
            tf = time.time()
            # K29's fold form: the matrix's all over the rows
            holds = self.filter_fn.alive(fields).cpu().numpy()
            filter_wall += time.time() - tf
            before = int(alive.sum())
            alive &= holds
            row = dict(round=i + 1, evidence=self.evidence,
                       n_states=int(fields.shape[0]),
                       killed=before - int(alive.sum()),
                       survivors=int(alive.sum()))
            rounds.append(row)
            if on_round is not None:
                on_round(row)

        # uncompiled candidates cannot be killed on device; drop them
        # from the survivor pool (reported separately)
        alive &= ~self._uncompiled_ix
        survivors = tuple(c for c, a in zip(self.candidates, alive)
                          if a)

        # certification
        self._sync()
        tc = time.time()
        init_ok = filter_matrix(
            self.filter_fn, self.init_fields).all(axis=1)
        if self.exact_fields is not None:
            closed = certify_closed(self.certify_fn, self._exact_rows,
                                    P)
        else:
            closed = np.zeros(P, bool)  # sampled: no inductive basis
        self._sync()
        certify_wall = time.time() - tc

        certified: List[Candidate] = []
        basis: List[str] = []
        for i, c in enumerate(self.candidates):
            if not alive[i]:
                continue
            if (self.exact_fields is not None and init_ok[i]
                    and closed[i]):
                certified.append(c)
                basis.append("reachable-inductive")
            elif c.absint:
                certified.append(c)
                basis.append("absint")

        cfg_killed = tuple(
            c.name for c, a in zip(self.candidates, alive)
            if c.source == "cfg" and not a
        ) if self.exact_fields is not None else ()

        return InferReport(
            candidates=P,
            dropped=self.dropped,
            uncompiled=self.uncompiled,
            evidence=self.evidence,
            exact=self.exact_fields is not None,
            n_states=n_states,
            rounds=tuple(rounds),
            killed=P - int(alive.sum()) - int(
                self._uncompiled_ix.sum()),
            survivors=survivors,
            certified=tuple(certified),
            cert_basis=tuple(basis),
            cfg_killed=cfg_killed,
            wall_s=self._wall(t0),
            filter_wall_s=filter_wall,
            certify_wall_s=certify_wall,
            seed=int(seed),
        )


def run_infer(model, budget: int = DEFAULT_BUDGET,
              walkers: int = DEFAULT_INFER_WALKERS,
              depth: int = DEFAULT_INFER_DEPTH, seed: int = 0,
              check_deadlock: bool = True,
              max_host_states: int = DEFAULT_MAX_HOST_STATES,
              on_round=None, device=None) -> InferReport:
    """Build (or rebuild - struct.cache memoizes the expensive layers)
    an inference engine for `model` on `device` (None: the card) and run
    one inference pass."""
    eng = InferEngine(model, budget=budget, walkers=walkers,
                      depth=depth, check_deadlock=check_deadlock,
                      max_host_states=max_host_states, device=device)
    return eng.run(seed=seed, on_round=on_round)
