"""Device liveness orchestration: capture -> fixpoint -> replayed lasso
(port of the KubeAPI half of jaxtlc/live/check.py).

``check_properties_device(cfg, props)`` gives the same results as the host
path's engine.liveness.check_properties under WF_vars(Next), so the
command renders both alike.  ``wf_process`` stays on the host path.  Every
violation is replayed through the host oracle (spec.oracle) before it is
returned (live.lasso.replay_lasso).

The device path is taken above HOST_PATH_MAX distinct states, where the
host path's per-state Python dict becomes the bottleneck; -liveness-host
forces the host path.  (The reference's check_leads_to_device, for specs
of the generic frontend, comes with the gen path: ROADMAP Queue A item
12.)
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
