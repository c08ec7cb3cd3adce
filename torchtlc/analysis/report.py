"""Render + journal preflight analysis results (a copy of
jaxtlc/analysis/report.py).

One renderer for every consumer: the byte-stable text report (pinned
golden in tier-1), the TLC-style warnings banner the CLI prints, and
the schema-validated `analysis` journal events (obs/schema.py) - so
the report a user reads, the banner the run prints and the events the
dashboard consumes can never disagree.
"""

from __future__ import annotations

from typing import List

from . import AnalysisReport, sorted_findings


def _fmt_set(names) -> str:
    return "{" + ", ".join(sorted(names)) + "}"


def render_spec_section(spec) -> List[str]:
    """The spec-layer section: read/write sets, slot budgets,
    invariant reads, independence pairs - stable order, stable text."""
    lines = [
        f"spec: {spec.root}  variables={_fmt_set(spec.variables)}  "
        f"codec_fields={spec.n_fields}",
        f"actions ({len(spec.actions)}):",
    ]
    for name in sorted(spec.actions):
        a = spec.actions[name]
        extra = ""
        if a.slot_binders:
            extra += "  slots=" + ",".join(
                f"{nm}:{u}/cap4" for nm, u in a.slot_binders
            )
        if a.seq_reads:
            extra += (f"  seq_reads={a.seq_reads}"
                      f" (gated {a.gated_seq_reads})")
        if a.n_disabled == a.n_branches and a.n_branches:
            extra += "  STATICALLY DISABLED"
        lines.append(
            f"  {name}: reads={_fmt_set(a.reads)} "
            f"writes={_fmt_set(a.writes)}"
            f" branches={a.n_branches}{extra}"
        )
    lines.append(f"invariants ({len(spec.invariant_reads)}):")
    for name in sorted(spec.invariant_reads):
        reads = spec.invariant_reads[name]
        tag = "" if reads else "  VACUOUS"
        lines.append(f"  {name}: reads={_fmt_set(reads)}{tag}")
    pairs = spec.independent_pairs
    lines.append(f"independent action pairs ({len(pairs)}):")
    for a, b in pairs:
        lines.append(f"  {a} || {b}")
    return lines


def render_report(report: AnalysisReport) -> str:
    """The full preflight report, byte-stable (golden-pinned)."""
    lines = [f"preflight analysis: {report.name}"]
    if report.spec is not None:
        lines.extend(render_spec_section(report.spec))
    if report.bound_lines:
        lines.extend(report.bound_lines)
    if report.engine_lines:
        lines.append("engine layer:")
        lines.extend(f"  {ln}" for ln in report.engine_lines)
    fs = sorted_findings(report.findings)
    if not fs:
        lines.append("findings: none")
    else:
        lines.append(f"findings ({len(fs)}):")
        for f in fs:
            lines.append(
                f"  [{f.severity}] {f.layer}/{f.check} {f.subject}: "
                f"{f.detail}"
            )
    return "\n".join(lines) + "\n"


def render_banner(log, report: AnalysisReport) -> None:
    """TLC-style warning banner: one line per finding, silent when the
    preflight is clean (pinned CLI transcripts stay byte-identical)."""
    fs = sorted_findings(report.findings)
    if not fs:
        return
    n_err = len(report.errors)
    sev_word = "error(s)" if n_err else "warning(s)"
    n = n_err or len(fs)
    log.msg(1000, f"Preflight analysis: {n} {sev_word} "
                  f"({len(fs)} finding(s) total).", severity=1)
    for f in fs:
        log.msg(
            1000,
            f"Preflight {f.severity} [{f.layer}/{f.check}] "
            f"{f.subject}: {f.detail}",
            severity=1,
        )


def emit_to_journal(journal, report: AnalysisReport,
                    on_event=None) -> None:
    """Stamp one schema-validated `analysis` event per finding plus the
    `analysis_summary` line.  `on_event(kind, info)`-style hooks (the
    supervisor convention) work too, via `on_event`."""

    def _emit(kind: str, **info):
        if journal is not None:
            journal.event(kind, **info)
        if on_event is not None:
            on_event(kind, info)

    for f in sorted_findings(report.findings):
        _emit("analysis", **f.as_event())
    _emit(
        "analysis_summary",
        name=report.name,
        findings=len(report.findings),
        errors=len(report.errors),
        warnings=len(report.warnings),
        wall_s=round(report.wall_s, 6),
    )


def print_report(report: AnalysisReport,
                 out=None) -> None:
    import sys

    (out or sys.stdout).write(render_report(report))
