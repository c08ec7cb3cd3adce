"""The preflight analysis (port of jaxtlc/analysis, its lite mode).

Before a check the reference runs a suite of host-side lints and prints
what it finds as TLC-style warning lines (jaxtlc/api.py:553-597
_preflight_gate).  The port keeps its own copies of the pieces of the
lite mode - no jax, no tracing:

* ``Finding``, ``AnalysisReport``, the severities and ``sorted_findings``
  (this module, a copy of jaxtlc/analysis/__init__.py);
* ``report``: the banner, the byte-stable text report and the journal's
  ``analysis`` events;
* ``speclint``: the spec layer over the struct frontend's IR (per-action
  read/write sets, the independence graph, unreachable-action and
  invariant-vacuity lints, the codec-slot audit);
* ``symfind``: the unreduced-symmetry nudge;
* ``engine_audit``: the counter-width arithmetic (``audit_counter_width``
  alone - the reference's jaxpr audits go with ``-analyze``, ROADMAP
  Queue A item 13);
* ``preflight``: ``preflight_struct``, ``preflight_kubeapi`` and
  ``preflight_gen`` in the lite mode.

Severities: ``error`` (the run would be wrong or die - preflight exits
nonzero), ``warning`` (the run proceeds but something will bite at
scale), ``info`` (report-only context).
"""


from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"
_SEV_RANK = {SEV_INFO: 0, SEV_WARNING: 1, SEV_ERROR: 2}

# exit code of a preflight abort (TLC's EC convention reserves 10-13
# for spec-level verdicts; preflight failures are config/tooling errors)
EXIT_PREFLIGHT = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One preflight diagnostic: which layer/check fired, on what, why."""

    layer: str  # "spec" | "engine"
    check: str  # kebab-case check id, e.g. "invariant-vacuity"
    severity: str  # SEV_ERROR | SEV_WARNING | SEV_INFO
    subject: str  # the action/invariant/engine/counter concerned
    detail: str  # one human-readable sentence

    def as_event(self) -> dict:
        """The journal `analysis` event payload (obs/schema.py)."""
        return dict(layer=self.layer, check=self.check,
                    severity=self.severity, subject=self.subject,
                    detail=self.detail)


@dataclasses.dataclass
class AnalysisReport:
    """The preflight result: findings + the report sections that back
    them (rendered byte-stably by `report.render_report`)."""

    name: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    spec: Optional[object] = None  # speclint.SpecAnalysis
    engine_lines: List[str] = dataclasses.field(default_factory=list)
    # certified-bound report section (absint.BoundReport.render_lines);
    # empty on reports that did not run the abstract interpretation, so
    # pre-existing golden reports render byte-identically
    bound_lines: List[str] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == SEV_ERROR)

    @property
    def warnings(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings
                     if f.severity == SEV_WARNING)

    @property
    def max_severity(self) -> Optional[str]:
        if not self.findings:
            return None
        return max((f.severity for f in self.findings),
                   key=_SEV_RANK.__getitem__)

    @property
    def exit_code(self) -> int:
        """Nonzero iff an error-severity finding survived."""
        return EXIT_PREFLIGHT if self.errors else 0


def sorted_findings(findings) -> List[Finding]:
    """Deterministic order: severity (errors first), layer, check,
    subject - the rendering and journaling order."""
    return sorted(
        findings,
        key=lambda f: (-_SEV_RANK[f.severity], f.layer, f.check,
                       f.subject),
    )


from .report import emit_to_journal, render_banner, render_report  # noqa: E402,F401
