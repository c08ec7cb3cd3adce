"""Evidence filtering: the dense [P, S] predicates x states kernel.

Each candidate compiles to a lane function through the SAME
LaneCompiler path cfg invariants use (struct.compile.build_invariant),
then ONE kernel evaluates all P candidates over the evidence states -
the whole counterexample-filter loop is a [P, S] boolean matrix away
from its kill decisions (`alive = matrix.all(axis=states)`).

Evidence comes from three sources, strongest first:

* **artifact**: a reachable-set artifact of a clean exhaustive run
  (struct.artifacts) - exact: any reachable refutation kills the
  candidate.
* **bfs**: a host-oracle BFS when the state space fits a budget -
  exact, and also the reference the device filter is pinned against.
* **sim**: random-walk lane states streamed out of the sim engine's
  step function instead of discarded - SAMPLED evidence for intractable
  configs; kills remain sound (every sampled state is reachable) but
  survival proves consistency only.

The port of jaxtlc/infer/filter.py.  The candidates compile to lane-IR
nodes on ``lanes.input_node(F)``; the kernel is K29
``struct_pred_matrix`` (torchtlc/kernels/csrc/struct_infer.cuh, through
infer.program.InferProgram) on the card, its plain version
(``lanes.evaluate``) on the CPU.  The evidence is torch tensors on the
run's device: the walk's snapshots stay there and each round's dedup is
``torch.unique(dim=0)``, the rows of ``np.unique(axis=0)`` in its order.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from .program import InferProgram

# host-BFS evidence budget: below this many distinct states the exact
# reachable set is computed fresh when no artifact is stored
DEFAULT_MAX_HOST_STATES = 50_000


def predicate_compiler(model, backend):
    """A LaneCompiler sharing the backend's codec: the same
    parse -> shape-infer pipeline the (un-narrowed) struct backend ran,
    so candidate lane functions decode the backend's field vectors
    bit-compatibly."""
    from ..struct.compile import LaneCompiler
    from ..struct.shapes import infer_shapes, typeok_hints

    system = model.system
    hints = typeok_hints(system.ev, model.invariants, system.variables)
    var_shapes = infer_shapes(system.ev, system.variables,
                              system.init_ast, system.next_ast,
                              hints=hints)
    return LaneCompiler(system.ev, system.variables, var_shapes,
                        backend.cdc)


def compile_predicates(compiler, candidates) -> list:
    """Candidate ASTs -> ok [1] lane-IR nodes on ``lanes.input_node(F)``.
    A candidate outside the compiler's subset is replaced by a
    constant-True lane (it can never be killed on device, and the
    driver reports it uncompiled instead of certified)."""
    from ..struct import lanes

    inp = lanes.input_node(compiler.codec.n_fields)
    fns = []
    uncompiled = []
    for i, c in enumerate(candidates):
        try:
            fns.append(compiler.build_invariant(c.ast)(inp))
        except Exception:
            uncompiled.append(i)
            fns.append(lanes.const(np.ones(1, bool)))
    return fns, uncompiled


_PROGRAMS: OrderedDict = OrderedDict()


def infer_program(backend, inv_fns: list) -> InferProgram:
    """The one inference program (the library of K29 and K30) of a struct
    backend's step and these predicates, memoized on both: the filter and
    the certify pass share it."""
    from ..struct.cache import _memo

    prog = backend.kernels.prog
    key = (id(prog), tuple(id(n) for n in inv_fns))
    # the entry keeps the step program and the nodes alive: their ids
    # cannot be reused while it stands
    hit = _memo(_PROGRAMS, key, lambda: (prog, tuple(inv_fns), InferProgram(
        prog, inv_fns, title=f"inference: {len(inv_fns)} candidates")),
        cap=8)
    return hit[2]


class FilterFn:
    """The [P, S] kernel of one inference program on one device:
    ``fn(fields)`` is the matrix (K29), ``fn.alive(fields)`` its fold
    (K29's fold form); fields [S, F] int32, numpy or torch."""

    def __init__(self, prog: InferProgram, device):
        self.prog = prog
        self.device = torch.device(device)

    def rows(self, fields) -> torch.Tensor:
        """The evidence on the program's device, int32 and contiguous."""
        if not isinstance(fields, torch.Tensor):
            fields = torch.from_numpy(np.ascontiguousarray(
                np.asarray(fields, np.int32)))
        return fields.to(self.device, torch.int32).contiguous()

    def __call__(self, fields) -> torch.Tensor:
        return self.prog.matrix(self.rows(fields))

    def alive(self, fields) -> torch.Tensor:
        return self.prog.alive(self.rows(fields))


def make_filter_fn(inv_fns: list, backend, device=None) -> FilterFn:
    """The [P, S] kernel over `backend`'s codec on `device` (None: the
    card): K29 on the card, its plain version on the CPU."""
    from ..engine.bfs import resolve_device

    return FilterFn(infer_program(backend, inv_fns), resolve_device(device))


def filter_matrix(filter_fn, fields) -> np.ndarray:
    """[P, S] candidate-holds matrix over `fields` ([S, F] int32, numpy or
    torch), one launch over the real rows: the reference's replica padding
    cannot change a column it keeps."""
    if not fields.shape[0]:
        return np.zeros((0, 0), bool)
    return filter_fn(fields).cpu().numpy()


def host_filter(system, candidates, states: list) -> np.ndarray:
    """The pure-host reference [P, S] matrix: `ev.eval` of every
    candidate over every decoded state - the oracle the device kernel
    is pinned bit-for-bit against.  An evaluation error counts as a
    refutation (the device lane traps the same way TLC errors)."""
    ev = system.ev
    out = np.zeros((len(candidates), len(states)), bool)
    for s_i, st in enumerate(states):
        env = dict(ev.constants)
        env.update(zip(system.variables, st))
        for c_i, c in enumerate(candidates):
            try:
                out[c_i, s_i] = ev.eval(c.ast, env) is True
            except Exception:
                out[c_i, s_i] = False
    return out


# ---------------------------------------------------------------------------
# Evidence sources
# ---------------------------------------------------------------------------


def artifact_fields(model, backend,
                    check_deadlock: bool = True
                    ) -> Optional[np.ndarray]:
    """Exact reachable evidence from the artifact store (struct.artifacts,
    the process store of ``TORCHTLC_ARTIFACT_CACHE``), as decoded field
    vectors [N, F] int32 - None on miss (no store, no artifact, or a
    codec that does not match this backend's)."""
    from ..struct import artifacts as arts

    store = arts.get_store()
    if store is None:
        return None
    hit = store.lookup_reach(arts.reach_key(model, check_deadlock))
    if hit is None:
        return None
    states, meta = hit
    codec = meta.get("codec_digest")
    if codec != arts.codec_digest(backend.cdc):
        return None  # narrowed-run artifact: packed under another codec
    if states.shape[1] * 32 < backend.cdc.nbits:
        return None
    words = torch.from_numpy(np.ascontiguousarray(states).view(np.int32))
    return backend.cdc.unpack(words).numpy()


def bfs_fields(model, backend, check_deadlock: bool = True,
               max_states: int = DEFAULT_MAX_HOST_STATES
               ) -> Optional[Tuple[np.ndarray, list]]:
    """Exact reachable evidence from a host-oracle BFS: (fields [N, F],
    decoded state tuples) - None when the space exceeds `max_states`
    (the intractable case the sampled tier exists for)."""
    from ..struct import oracle as so

    try:
        r = so.bfs(model.system, {}, check_deadlock=False,
                   max_states=max_states, stop_on_violation=False,
                   collect_states=True)
    except RuntimeError:
        return None
    states = list(r.states)
    fields = np.stack([backend.cdc.encode(st) for st in states])
    return fields.astype(np.int32), states


def sim_fields(model, walkers: int, depth: int, seed: int,
               check_deadlock: bool = True,
               rounds: int = 4, device=None) -> List[torch.Tensor]:
    """Sampled evidence streamed out of the sim tier: the walk advanced
    one step at a time through its (memoized) step function (kernels K27
    and K28 on the card), every round's lane states SNAPSHOTTED into the
    filter stream instead of discarded.  Returns `rounds` deduplicated
    field chunks [N_i, F] int32 on `device` (None: the card), each the
    rows of ``np.unique(seg, axis=0)`` in its order (the per-round kill
    accounting the journal reports)."""
    from ..sim.engine import get_sim_engine

    _b, init_fn, _run_fn, step_fn = get_sim_engine(
        model, walkers, depth, 0, check_deadlock=check_deadlock,
        device=device
    )
    carry = init_fn(seed)
    # the walk updates the carry in place: each snapshot is a copy
    chunks = [carry.states.clone()]
    for _ in range(depth):
        carry = step_fn(carry)
        chunks.append(carry.states.clone())
    per = max(1, math.ceil(len(chunks) / max(rounds, 1)))
    out = []
    for start in range(0, len(chunks), per):
        seg = torch.cat(chunks[start:start + per], dim=0)
        out.append(torch.unique(seg, dim=0).to(torch.int32))
    return out
