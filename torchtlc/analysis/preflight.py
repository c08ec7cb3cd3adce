"""Preflight orchestration, the lite mode (port of
jaxtlc/analysis/preflight.py with ``deep=False``): what the CLI runs
before a check.  It costs milliseconds: the spec-layer lints (struct
specs - host Python over the IR) and the static counter-width
arithmetic.  The deep mode (``-analyze``: the reference's jaxpr trace of
the engine) and the certified bound report (``-narrow``) are not ported
yet (ROADMAP Queue A items 13 and 11).
"""

from __future__ import annotations

import time

from . import AnalysisReport
from .engine_audit import audit_counter_width


def preflight_struct(model, *, fp_capacity: int, chunk: int,
                     queue_capacity: int,
                     check_deadlock: bool = True) -> AnalysisReport:
    """Struct-path preflight: spec lints + engine-layer arithmetic (the
    reference's signature; chunk, queue_capacity and check_deadlock serve
    its deep mode only).  The unreduced-symmetry nudge always runs: the
    port has no -symmetry yet."""
    from .speclint import analyze_spec
    from .symfind import unreduced_symmetry_findings

    t0 = time.time()
    report = AnalysisReport(name=f"struct:{model.root_name}")
    spec = analyze_spec(model, dynamic_consts=frozenset(), const_hints=None)
    report.spec = spec
    report.extend(spec.findings)
    # the spec qualifies for orbit dedup but the run is not taking it: one
    # warning per SYMMETRY-eligible constant set
    report.extend(unreduced_symmetry_findings(model))
    # lite bound without building the backend: every action branch is at
    # least one lane, action-position binders multiply - use the branch
    # count as the static lower bound
    n_lanes = sum(a.n_branches for a in spec.actions.values()) or 1
    report.extend(audit_counter_width(
        f"struct:{model.root_name}", fp_capacity, n_lanes))
    report.wall_s = time.time() - t0
    return report


def preflight_kubeapi(cfg, *, fp_capacity: int, chunk: int,
                      queue_capacity: int) -> AnalysisReport:
    """Hand-kernel (KubeAPI) preflight: the spec layer does not apply
    (no struct IR); the engine layer audits counter widths from the
    static lane layout."""
    from ..spec.kernel import lane_layout

    t0 = time.time()
    _, n_lanes = lane_layout(cfg)
    report = AnalysisReport(name="kubeapi:Model")
    report.extend(audit_counter_width("kubeapi", fp_capacity, n_lanes))
    report.wall_s = time.time() - t0
    return report


def preflight_gen(genspec, *, fp_capacity: int) -> AnalysisReport:
    """Generic-frontend preflight: counter-width arithmetic only (the gen
    IR predates the struct IR the spec lints read)."""
    t0 = time.time()
    report = AnalysisReport(name=f"gen:{getattr(genspec, 'name', '?')}")
    n_lanes = max(len(getattr(genspec, "actions", ())), 1)
    report.extend(audit_counter_width("gen", fp_capacity, n_lanes))
    report.wall_s = time.time() - t0
    return report
