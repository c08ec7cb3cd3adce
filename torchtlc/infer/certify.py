"""Certification: are the filter's survivors actually invariants?

Two machine-checked bases, reported distinctly:

* **reachable-inductive** (exact evidence only): a device pass over the
  reachable set's one-step successors through the spec's own step -
  `Init => cand` over the initial vectors plus `cand /\\ Next => cand'`
  over every (reachable state, enabled successor) pair.  Over the EXACT
  reachable set this is precisely the induction that proves cand holds
  on every reachable state, i.e. a machine-certified invariant (it is
  induction over reachability, not a proof of inductiveness over the
  full type universe - the honest wording the driver emits).
* **absint**: the candidate is one of the bound atoms conjectured FROM
  a certified analysis.absint report - the narrowing fixpoint already
  machine-checked `Init ⊑ R` and `step#(R) ⊑ R` for its domains, so
  these candidates certify with no device pass at all (and remain
  certified even under sampled evidence).

Survivors with neither basis are reported honestly as "consistent with
evidence only".

The port of jaxtlc/infer/certify.py: the certify pass is kernel K30
``struct_certify`` (torchtlc/kernels/csrc/struct_infer.cuh, through
infer.program.InferProgram) on the card, on the CPU its plain version -
StructProgram.step_plain, then the predicates by ``lanes.evaluate`` on
the row and on its successors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CertifyOutcome(NamedTuple):
    init_ok: np.ndarray  # [P] bool: Init => cand
    closed: np.ndarray  # [P] bool: cand /\ Next => cand' over evidence


def make_certify_fn(backend, inv_fns: list, device=None):
    """The certify kernel over `backend`'s step on `device` (None: the
    card): per evidence state (fields [S, F] int32, numpy or torch), every
    candidate on the state AND on each enabled one-step successor,
    returning the [P] escaped-bits of the rows - True means some
    pre-state satisfying the candidate has an enabled successor that does
    not.  K30 on the card, its plain version on the CPU; the library is
    the filter's (one per program)."""
    from .filter import make_filter_fn

    ff = make_filter_fn(inv_fns, backend, device)
    return lambda fields: ff.prog.escaped(ff.rows(fields))


def certify_closed(certify_fn, fields, n_preds: int) -> np.ndarray:
    """[P] closed-under-Next bits over the evidence set, one launch over
    the real rows: the reference's replica padding can only duplicate an
    escape the evidence already contains, never fabricate one."""
    escaped = np.zeros(n_preds, bool)
    if fields.shape[0]:
        escaped |= certify_fn(fields).cpu().numpy()
    return ~escaped


def host_inductive_check(system, cand_ast, states: list) -> bool:
    """The host-oracle verification of the reachable-inductive claim:
    `Init => cand` and, for every evidence state satisfying cand,
    every successor satisfies cand too - `ev.eval` + the host
    successor enumerator, no device code (the test pin the acceptance
    bar names)."""
    ev = system.ev

    def holds(st) -> bool:
        env = dict(ev.constants)
        env.update(zip(system.variables, st))
        try:
            return ev.eval(cand_ast, env) is True
        except Exception:
            return False

    for st in system.initial_states():
        if not holds(st):
            return False
    for st in states:
        if not holds(st):
            continue
        for _label, nxt in system.successors(st):
            if not holds(nxt):
                return False
    return True
