"""Device liveness orchestration: capture -> fixpoint -> replayed lasso
(port of jaxtlc/live/check.py).

Two frontend entry points, each giving the same results as its host-path
counterpart under WF_vars(Next), so the command renders both alike:

* ``check_properties_device(cfg, props)`` - the KubeAPI family
  (engine.liveness.LivenessResult), its operands from kernel K15;
* ``check_leads_to_device(genspec, p, q)`` - generic-frontend specs
  (gen.oracle.LivenessResult), its operands compiled from the spec by
  gen.kernel.compile_expr and evaluated by kernel K20.

``wf_process`` stays on the host path.  Every violation is replayed
through the host oracle (spec.oracle, gen.oracle) before it is returned
(live.lasso.replay_lasso).

The device path is taken above HOST_PATH_MAX distinct states, where the
host path's per-state Python dict becomes the bottleneck; -liveness-host
forces the host path.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..engine.bfs import resolve_device
from ..engine.liveness import LivenessResult as KubeLivenessResult
from .capture import CapturedGraph, capture_edges, state_masks
from .fixpoint import has_nonself, surviving_set
from .lasso import build_lasso, replay_lasso

# above this many distinct states the host liveness graph (one Python dict
# entry and adjacency list a state) stops being viable
HOST_PATH_MAX = 1_000_000


def use_device_path(distinct: int, fairness: str = "wf_next",
                    force_host: bool = False) -> bool:
    """The command's dispatch rule: the device path above the host-path
    size threshold; wf_process and -liveness-host stay on the host path."""
    return (not force_host) and fairness == "wf_next" \
        and distinct > HOST_PATH_MAX


def _violation(graph, alive, in_h, trigger, labels, decode, is_initial,
               is_transition, equal=None):
    prefix_ids, cycle_ids, pre_act, cyc_act = build_lasso(
        graph, alive, in_h, trigger)
    prefix = [decode(i) for i in prefix_ids]
    cycle = [decode(i) for i in cycle_ids]
    replay_lasso(prefix, cycle, is_initial, is_transition, equal=equal)
    names = [None if a is None else labels[a] for a in pre_act]
    cnames = [None if a is None else labels[a] for a in cyc_act]
    return prefix_ids, cycle_ids, prefix, cycle, names, cnames


def capture_kube_graph(cfg, chunk: int = 1024,
                       state_capacity: int = 1 << 20,
                       fp_capacity: int = 1 << 20,
                       spill_path: Optional[str] = None,
                       device=None) -> CapturedGraph:
    from ..engine.backend import kubeapi_backend

    return capture_edges(
        kubeapi_backend(cfg), chunk=chunk, state_capacity=state_capacity,
        fp_capacity=fp_capacity, spill_path=spill_path, device=device)


def check_properties_device(
    cfg,
    properties: List[str],
    chunk: int = 1024,
    state_capacity: int = 1 << 20,
    fp_capacity: int = 1 << 20,
    mesh=None,
    graph: Optional[CapturedGraph] = None,
    spill_path: Optional[str] = None,
    device=None,
) -> List[KubeLivenessResult]:
    """Device-path analog of engine.liveness.check_properties (wf_next).
    With a ShardMesh of D > 1 shards each fixpoint runs over D edge
    slices."""
    from ..spec import oracle
    from ..spec.codec import get_codec
    from ..spec.labels import LABELS

    if mesh is not None:
        device = mesh.device
    cdc = get_codec(cfg)
    if graph is None:
        graph = capture_kube_graph(
            cfg, chunk=chunk, state_capacity=state_capacity,
            fp_capacity=fp_capacity, spill_path=spill_path, device=device)
    nonself = has_nonself(graph)

    # every predicate row in one K15 pass: sr[k] for k < nr, then the k-th
    # reconciler's secret present
    masks = state_masks(cfg, torch.from_numpy(graph.states.view(
        np.int32)).to(resolve_device(device))).cpu().numpy().astype(bool)
    nr = cfg.n_reconcilers

    def decode_fields(i):
        row = torch.from_numpy(graph.states[i][None].view(np.int32))
        return cdc.unpack(row)[0].numpy().astype(np.int32)

    inits = set(oracle.initial_states(cfg))

    def is_initial(enc):
        return cdc.decode(np.asarray(enc)) in inits

    def is_transition(ea, eb):
        sa = cdc.decode(np.asarray(ea))
        sb = cdc.decode(np.asarray(eb))
        return sb in {x.state for x in oracle.successors(sa, cfg)}

    out: List[KubeLivenessResult] = []
    for name in properties:
        if nr == 0:
            out.append(KubeLivenessResult(name, True, None, None))
            continue
        if name == "ReconcileCompletes":
            # sr[c] ~> ~sr[c]: H = trigger = {sr[c]}
            zones = [masks[ri] for ri in range(nr)]
        elif name == "CleansUpProperly":
            # []~sr[c] ~> secret absent: H = trigger = {~sr[c] /\ present}
            zones = [~masks[k] & masks[nr + k] for k in range(nr)]
        else:
            raise ValueError(f"unknown temporal property {name!r}")
        res = None
        for in_h in zones:
            trigger = in_h
            alive, _ = surviving_set(graph, in_h, mesh=mesh,
                                     nonself=nonself, device=device)
            bad = trigger & alive
            if not bad.any():
                res = KubeLivenessResult(name, True, None, None)
                continue
            _, _, prefix, cycle, pnames, cnames = _violation(
                graph, alive, in_h, bad, LABELS, decode_fields, is_initial,
                is_transition, equal=np.array_equal)
            res = KubeLivenessResult(name, False, prefix, cycle, pnames,
                                     cnames)
            break
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# Generic frontend
# ---------------------------------------------------------------------------


def capture_gen_graph(spec, chunk: int = 1024,
                      state_capacity: int = 1 << 20,
                      fp_capacity: int = 1 << 20,
                      spill_path: Optional[str] = None, device=None,
                      backend=None) -> CapturedGraph:
    """The captured graph of a generic spec, through its backend's expand
    route (kernel K19)."""
    from ..engine.backend import gen_backend

    return capture_edges(
        backend or gen_backend(spec), chunk=chunk,
        state_capacity=state_capacity, fp_capacity=fp_capacity,
        spill_path=spill_path, device=device)


def gen_operand_masks(spec, cdc, p_ast, q_ast, title: str = ""):
    """Kernel K20's program of a property's operands p and q, each
    compiled by gen.kernel.compile_expr (a non-boolean operand raises)."""
    from ..gen.kernel import _Ctx, compile_expr
    from ..gen.program import GenMasks

    ctx = _Ctx(codec=cdc, consts=dict(spec.constants), binding={}, at=None)
    fns = []
    for ast in (p_ast, q_ast):
        kind, fn = compile_expr(ast, ctx)
        if kind != "bool":
            raise ValueError(f"property operand is not BOOLEAN: {ast!r}")
        fns.append(fn)
    return GenMasks(cdc, fns, title=title or f"operands of {spec.name}")


def check_leads_to_device(
    spec,
    p_ast,
    q_ast,
    name: str = "",
    chunk: int = 1024,
    state_capacity: int = 1 << 20,
    fp_capacity: int = 1 << 20,
    mesh=None,
    graph: Optional[CapturedGraph] = None,
    spill_path: Optional[str] = None,
    device=None,
):
    """Device-path analog of gen.oracle.check_leads_to (wf_next): p ~> q
    holds unless a p-state survives the greatest fixpoint of the ~q zone.
    With a ShardMesh of D > 1 shards the fixpoint runs over D edge
    slices."""
    from ..engine.backend import gen_backend
    from ..gen import oracle as go

    if mesh is not None:
        device = mesh.device
    backend = gen_backend(spec)
    cdc = backend.cdc
    if graph is None:
        graph = capture_gen_graph(
            spec, chunk=chunk, state_capacity=state_capacity,
            fp_capacity=fp_capacity, spill_path=spill_path, device=device,
            backend=backend)
    masks = gen_operand_masks(spec, cdc, p_ast, q_ast, title=name)
    states = torch.from_numpy(graph.states.view(np.int32)).to(
        resolve_device(device))
    p_mask, q_mask = masks.masks(states).cpu().numpy().astype(bool)
    in_h = ~q_mask
    alive, _ = surviving_set(graph, in_h, mesh=mesh, device=device)
    bad = p_mask & alive
    if not bad.any():
        return go.LivenessResult(name, True, None, None)

    init = go.initial_state(spec)

    def decode(i):
        row = torch.from_numpy(graph.states[i][None].view(np.int32))
        return cdc.decode(cdc.unpack(row)[0].numpy())

    def is_transition(sa, sb):
        return any(nxt == sb and changed
                   for _, nxt, changed in go.successors(spec, sa))

    _, _, prefix, cycle, _, _ = _violation(
        graph, alive, in_h, bad, backend.labels, decode,
        lambda s: s == init, is_transition)
    return go.LivenessResult(name, False, prefix, cycle)
