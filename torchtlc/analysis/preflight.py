"""Preflight orchestration, the lite mode (port of
jaxtlc/analysis/preflight.py with ``deep=False``): what the CLI runs
before a check.  It costs milliseconds: the spec-layer lints (struct
specs - host Python over the IR) and the static counter-width
arithmetic - and, with ``-narrow``, the certified bound report's
findings (analysis.absint).  The deep mode (``-analyze``: the reference's
jaxpr trace of the engine) is not ported yet (ROADMAP Queue A item 13).
"""

from __future__ import annotations

import time

from . import AnalysisReport
from .engine_audit import audit_counter_width


def preflight_struct(model, *, fp_capacity: int, chunk: int,
                     queue_capacity: int, check_deadlock: bool = True,
                     bounds=None, narrow: bool = False,
                     symmetry: bool = False) -> AnalysisReport:
    """Struct-path preflight: spec lints + engine-layer arithmetic (the
    reference's signature; chunk, queue_capacity and check_deadlock serve
    its deep mode only).  `bounds` (an absint.BoundReport) adds the bound
    report section and its findings (jaxtlc/analysis/preflight.py:50-72);
    `narrow` marks that the run asked for the narrowed codec, which turns
    an uncertified report into a `narrow-refused` warning; `symmetry`
    marks that the run reduces by symmetry, which silences the
    unreduced-symmetry nudge (:32-34)."""
    from .speclint import analyze_spec
    from .symfind import unreduced_symmetry_findings

    t0 = time.time()
    report = AnalysisReport(name=f"struct:{model.root_name}")
    spec = analyze_spec(model, dynamic_consts=frozenset(), const_hints=None)
    report.spec = spec
    report.extend(spec.findings)
    if not symmetry:
        # the spec qualifies for orbit dedup but the run is not taking
        # it: one warning per SYMMETRY-eligible constant set
        report.extend(unreduced_symmetry_findings(model))
    if bounds is not None:
        report.bound_lines = bounds.render_lines()
        report.extend(bounds.findings())
        if narrow and not bounds.certified:
            # the -narrow request could not be honored; the run proceeds
            # on the baseline layout - say so loudly enough that the user
            # notices the flag did nothing
            from . import SEV_WARNING, Finding

            report.findings.append(Finding(
                layer="spec", check="narrow-refused",
                severity=SEV_WARNING, subject=model.root_name,
                detail=("-narrow requested but the bound report is "
                        "not certified; running with the baseline "
                        "(un-narrowed) codec"),
            ))
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
