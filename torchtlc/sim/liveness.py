"""Liveness on sampled traces: TLC-simulate-style lasso detection (port of
jaxtlc/sim/liveness.py).

The exhaustive struct path checks plain ``P ~> Q`` properties with a
greatest fixpoint over the full reachable graph; a random walk cannot do
that, but it can falsify: when a lane's depth-D trajectory revisits a
state, the segment between the two visits is a genuine cycle of the state
graph (every consecutive pair in a walk is a taken transition), and an
admissible cycle containing no Q-state answers an unanswered P-state with
a real infinite counterexample behavior - what TLC's ``-simulate``
reports.

Admissibility matches the host oracle's WF_vars(Next) semantics
(struct.oracle.check_leads_to): a cycle through more than one state takes
state-changing transitions forever and is always admissible; a
single-state "cycle" (a self-loop lane or a frozen dead lane) is
admissible only if the state has no state-changing successor.

A clean pass proves nothing (the walk is sampled); only lassos can
falsify.  The caller keeps its skip notice for property shapes this
checker cannot express.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np


class WalkLassoResult(NamedTuple):
    """One property's verdict over all walk lanes."""

    name: str
    holds: bool  # no violating lasso found - NOT a liveness proof
    lanes: int
    lassos: int  # lanes whose trajectory closed a cycle
    violation_lane: int  # -1 when holds
    prefix: List[tuple]  # decoded states before the cycle
    cycle: List[tuple]  # decoded cycle states (first repeats)


def walk_trajectories(model, walkers: int, depth: int, seed: int,
                      check_deadlock: bool = True,
                      device=None) -> np.ndarray:
    """[D+1, W, F] walk states re-derived from the seed through the
    memoized sim engine's step function on `device` (None: the card) -
    kernels K27 and K28 a step, the states copied back after each (the
    step updates them in place) - so this
    replays the exact lanes a prior run of the same geometry walked."""
    from .engine import get_sim_engine

    _b, init_fn, _run_fn, step_fn = get_sim_engine(
        model, walkers, depth, 0, check_deadlock=check_deadlock,
        device=device,
    )
    carry = init_fn(seed)
    snaps = [carry.states.cpu().numpy().copy()]
    for _ in range(depth):
        carry = step_fn(carry)
        snaps.append(carry.states.cpu().numpy().copy())
    return np.stack(snaps)


def check_walk_leads_to(model, p_ast, q_ast, name: str,
                        trajectories: np.ndarray,
                        system=None) -> WalkLassoResult:
    """Check ``P ~> Q`` against [D+1, W, F] walk trajectories.

    Host-side: predicates evaluate through the same ``ev.eval`` the oracle
    uses, memoized per distinct state (walks revisit heavily); lasso
    detection is a first-occurrence scan per lane."""
    system = system or model.system
    ev = system.ev
    D1, W, F = trajectories.shape

    from ..struct.cache import get_backend

    cdc = get_backend(model, True).cdc
    decoded: dict = {}
    pq: dict = {}

    def state_of(vec) -> tuple:
        key = vec.tobytes()
        if key not in decoded:
            decoded[key] = cdc.decode(vec)
        return decoded[key]

    def eval_pq(st: tuple):
        if st not in pq:
            env = dict(ev.constants)
            env.update(zip(system.variables, st))
            try:
                p = ev.eval(p_ast, env) is True
                q = ev.eval(q_ast, env) is True
            except Exception:
                p, q = False, True  # uninterpretable: never falsify
            pq[st] = (p, q)
        return pq[st]

    def stutter_admissible(st: tuple) -> bool:
        # single-state cycle: admissible under WF_vars(Next) only if the
        # state has no state-changing successor
        try:
            return all(nxt == st for _lbl, nxt in
                       system.successors(st))
        except Exception:
            return False

    lassos = 0
    for lane in range(W):
        trace = [state_of(trajectories[t, lane]) for t in range(D1)]
        first: dict = {}
        k = t = -1
        for i, st in enumerate(trace):
            if st in first:
                k, t = first[st], i
                break
            first[st] = i
        if t < 0:
            continue  # no cycle closed within depth: proves nothing
        cycle = trace[k:t]
        lassos += 1
        if len(set(cycle)) == 1 and not stutter_admissible(cycle[0]):
            continue
        if any(eval_pq(st)[1] for st in cycle):
            continue  # the cycle answers every pending P with a Q
        for i in range(t):
            p, _q = eval_pq(trace[i])
            if p and not any(eval_pq(trace[j])[1]
                             for j in range(i, t)):
                return WalkLassoResult(
                    name=name, holds=False, lanes=W, lassos=lassos,
                    violation_lane=lane, prefix=trace[:k],
                    cycle=cycle,
                )
    return WalkLassoResult(name=name, holds=True, lanes=W,
                           lassos=lassos, violation_lane=-1,
                           prefix=[], cycle=[])


def expressible(ast) -> Optional[str]:
    """None when the walk checker can handle this property AST, else the
    skip reason (the same plain ``P ~> Q`` subset the exhaustive struct
    path checks)."""
    if ast[0] != "leadsto" or ast[1][0] == "box":
        return ("only plain P ~> Q is checked on sampled behaviors")
    return None
