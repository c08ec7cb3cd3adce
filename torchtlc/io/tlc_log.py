"""TLC structured log protocol emitter (a copy of jaxtlc/io/tlc_log.py
with its imports pointed at the port).

Reproduces the `@!@!@STARTMSG <code>:<severity> @!@!@ ... @!@!@ENDMSG <code>
@!@!@` framing the Toolbox parses, with TLC's message codes: 2262 version
banner, 2187 config banner, 2185 start, 2189/2190 initial states, 2200
progress, 2193 success + collision estimates, 2201/2773/2772 coverage,
2199 final counts, 2194 depth, 2268 outdegree, 2186 finish; 2110
invariant, 2108 assertion and 2114 deadlock violations and the 2217
state-trace framing; 2195/2196/2198 checkpoint, recovery and regrow.
Action coverage lines carry the PlusCal label and the KubeAPI module line
of each action.
"""

from __future__ import annotations

import re
import sys
import time
from typing import Dict, Optional, TextIO

from ..engine.fingerprint import collision_probability

# reference translation line of each action (module KubeAPI); the trace/
# coverage rendering uses these to mirror MC.out's "<Action line N ...>"
ACTION_LINES: Dict[str, int] = {
    "Init": 455,
    "DoRequest": 471,
    "DoReply": 485,
    "DoListRequest": 499,
    "DoListReply": 513,
    "CStart": 528,
    "C1": 551,
    "C10": 558,
    "C11": 570,
    "c12": 577,
    "C13": 589,
    "C2": 596,
    "C3": 604,
    "C8": 611,
    "C6": 618,
    "C7": 631,
    "C4": 638,
    "C5": 645,
    "PVCStart": 655,
    "PVCListedPVCs": 665,
    "PVCHavePVCs": 673,
    "PVCDone": 690,
    "APIStart": 698,
}


def action_lines_from_spec(tla_path: str) -> Dict[str, int]:
    """Derive the label -> translation-line table by scanning the spec's
    committed PlusCal translation, so the rendering table tracks the
    actual module instead of a hand-maintained copy (M4).

    A translated ACTION is recognizable without any prior label list: it
    is a definition whose body opens with its own pc guard
    (``Name(self) == /\\ pc[self] = "Name"``) - the shape every PlusCal
    label translates to - plus ``Init``.  New or renamed labels are
    picked up automatically; ACTION_LINES remains the fallback for
    actions the file doesn't define.

    Property-tested against the reference: the derived table equals the
    committed ACTION_LINES for KubeAPI.tla."""
    table: Dict[str, int] = {}
    label_re = re.compile(
        r"^([A-Za-z_][A-Za-z0-9_]*)(?:\(self\))?\s*==\s*"
        r"(?:/\\\s*)?pc\[self\]\s*=\s*\"([A-Za-z0-9_]+)\""
    )
    init_re = re.compile(r"^Init\s*==")
    with open(tla_path, "r", encoding="utf-8") as f:
        for i, ln in enumerate(f, start=1):
            if init_re.match(ln):
                table.setdefault("Init", i)
                continue
            m = label_re.match(ln)
            if m and m.group(1) == m.group(2):
                table.setdefault(m.group(1), i)
    return {**ACTION_LINES, **table}


class TLCLog:
    def __init__(self, out: Optional[TextIO] = None, tool_mode: bool = True,
                 action_lines: Optional[Dict[str, int]] = None,
                 pcal_map=None):
        # resolve sys.stdout at call time (a def-time default would pin the
        # stream before test harnesses / redirections can swap it)
        self.out = sys.stdout if out is None else out
        self.tool = tool_mode
        self.action_lines = (
            ACTION_LINES if action_lines is None else action_lines
        )
        # optional frontend.pmap.TLAtoPCalMapping: trace headers then name
        # the PlusCal source location (the Toolbox jump target) alongside
        # the generated-TLA line
        self.pcal_map = pcal_map

    def raw(self, line: str) -> None:
        """Emit a pre-framed line verbatim (the coverage renderer frames
        its own messages)."""
        self.out.write(line + "\n")
        self.out.flush()

    def msg(self, code: int, text: str, severity: int = 0) -> None:
        if self.tool:
            self.out.write(f"@!@!@STARTMSG {code}:{severity} @!@!@\n")
        self.out.write(text.rstrip("\n") + "\n")
        if self.tool:
            self.out.write(f"@!@!@ENDMSG {code} @!@!@\n")
        self.out.flush()

    # -- run lifecycle ------------------------------------------------------

    def version(self, version: str) -> None:
        self.msg(2262, f"torchtlc {version} (GPU-native TLA+ model checker)")

    def banner(self, fp_index: int, seed: int, workers: str, device: str) -> None:
        self.msg(
            2187,
            f"Running breadth-first search Model-Checking with fp {fp_index} "
            f"and seed {seed} with {workers} workers on {device} "
            "(JaxFPSet, DeviceStateQueue).",
        )

    def sany(self, files, modules) -> None:
        """The SANY parse phase (MC.out:7-24): codes 2220/2219 framing the
        files this run actually read and the modules it resolved."""
        self.msg(2220, "Starting SANY...")
        for f in files:
            self.raw(f"Parsing file {f}")
        for m in modules:
            self.raw(f"Semantic processing of module {m}")
        self.msg(2219, "SANY finished.")

    def starting(self) -> None:
        self.msg(2185, f"Starting... ({time.strftime('%Y-%m-%d %H:%M:%S')})")

    def computing_init(self) -> None:
        self.msg(2189, "Computing initial states...")

    def init_done(self, n: int) -> None:
        self.msg(
            2190,
            f"Finished computing initial states: {n} distinct states "
            f"generated at {time.strftime('%Y-%m-%d %H:%M:%S')}.",
        )

    def progress(
        self, depth: int, generated: int, distinct: int, queue: int
    ) -> None:
        """TLC's 2200 Progress line incl. the per-minute rates computed
        from the stored previous Progress report (MC.out:35,1095).

        The rate arithmetic is obs.views.interval_rates - the SAME
        function the journal views use, so the log
        line and the dashboard cannot disagree.  First report: TLC
        prints the raw interval counts as the "per-minute" rates
        (MC.out:35 shows 538,163 generated in ~4 s reported as
        "538,163 s/min"), and interval_rates does the same."""
        from ..obs.views import interval_rates

        now = time.time()
        prev = getattr(self, "_prev_progress", None)
        self._prev_progress = (now, generated, distinct)
        if prev is None or now > prev[0]:
            self._last_rates = interval_rates(
                prev, now, generated, distinct
            )
        spm, dpm = self._last_rates
        self.msg(
            2200,
            f"Progress({depth}) at {time.strftime('%Y-%m-%d %H:%M:%S')}: "
            f"{generated:,} states generated ({spm:,} s/min), "
            f"{distinct:,} distinct states found ({dpm:,} ds/min), "
            f"{queue:,} states left on queue.",
        )

    @staticmethod
    def _efmt(v: float) -> str:
        """Java-style %.1E: no leading zero in the exponent (3.7E-9)."""
        return re.sub(r"E([+-])0+(\d)", r"E\1\2", f"{v:.1E}")

    def success(self, generated: int, distinct: int,
                actual: float = None, occupancy: float = None) -> None:
        """The full 2193 success text (MC.out:38-42): both collision
        estimates when the engine computed the actual-fingerprint one,
        plus the final fingerprint-table load fraction (the auto-grow
        trigger is a fraction of capacity, so this line is how users see
        how close a run came to regrowing)."""
        p = collision_probability(generated, distinct)
        body = (
            "Model checking completed. No error has been found.\n"
            "  Estimates of the probability that TLC did not check all "
            "reachable states\n"
            "  because two distinct states had the same fingerprint:\n"
            f"  calculated (optimistic):  val = {self._efmt(p)}"
        )
        if actual is not None:
            body += (
                f"\n  based on the actual fingerprints:  "
                f"val = {self._efmt(actual)}"
            )
        if occupancy is not None:
            body += (
                f"\n  fingerprint table occupancy: {occupancy:.1%} of "
                "capacity"
            )
        self.msg(2193, body)

    def coverage(self, init_count: int, act_gen: Dict[str, int],
                 act_dist: Dict[str, int]) -> None:
        self.msg(
            2201,
            f"The coverage statistics at {time.strftime('%Y-%m-%d %H:%M:%S')}",
        )
        self.msg(2773, f"<Init line {self.action_lines['Init']}, col 1 to line "
                       f"{self.action_lines['Init']}, col 4 of module KubeAPI>: "
                       f"{init_count}:{init_count}")
        for name, line in self.action_lines.items():
            if name == "Init":
                continue
            g = act_gen.get(name, 0)
            d = act_dist.get(name, 0)
            # zero-fire actions print 0:0, exactly as TLC does
            # span matches the reference label token (col len+6, cf. the
            # committed MC.out action lines); code 2772 = action coverage
            self.msg(
                2772,
                f"<{name} line {line}, col 1 to line {line}, "
                f"col {len(name) + 6} of module KubeAPI>: {d}:{g}",
            )

    def coverage_generic(self, module: str, init_count: int,
                         act_gen: Dict[str, int],
                         act_dist: Dict[str, int]) -> None:
        """Per-action coverage of a struct-frontend spec: the module's own
        action names with TLC's distinct:generated counts."""
        self.msg(
            2201,
            f"The coverage statistics at {time.strftime('%Y-%m-%d %H:%M:%S')}",
        )
        self.msg(2773, f"<Init of module {module}>: "
                       f"{init_count}:{init_count}")
        for name, g in act_gen.items():
            d = act_dist.get(name, 0)
            self.msg(2772, f"<{name} of module {module}>: {d}:{g}")

    def coverage_gen_dump(self, lines) -> None:
        """Per-expression coverage block for generic specs (the
        gen.coverage renderer's lines, TLC message framing added)."""
        self.msg(2201, lines[0])
        for ln in lines[1:]:
            self.msg(2772, ln)

    def coverage_site_dump(self, lines) -> None:
        """The DEVICE coverage plane's end-of-run dump (obs.coverage.
        render_site_dump lines) in MC.out's message framing: the 2201
        banner, 2772 action-header lines, 2221 indented span lines -
        exactly the codes TLC uses for its own coverage section."""
        self.msg(2201, lines[0])
        for ln in lines[1:]:
            self.msg(2221 if ln.startswith("  ") else 2772, ln)

    def checking_temporal(self, distinct: int, path: str = "host") -> None:
        """TLC's 2192 liveness-phase banner, naming the liveness engine that
        runs: `host` (explicit graph) or `device` (edge capture and the
        survive-set fixpoint)."""
        self.msg(
            2192,
            f"Checking temporal properties for the complete state space "
            f"with {distinct} total distinct states at "
            f"{time.strftime('%Y-%m-%d %H:%M:%S')} "
            f"({path} liveness engine)",
        )

    def final_counts(self, generated: int, distinct: int, queue: int) -> None:
        self.msg(
            2199,
            f"{generated} states generated, {distinct} distinct states "
            f"found, {queue} states left on queue.",
        )

    def depth(self, d: int) -> None:
        self.msg(2194, f"The depth of the complete state graph search is {d}.")

    def outdegree(self, avg: int, mn: int, mx: int, p95: int) -> None:
        # format matches MC.out:1104 byte for byte
        self.msg(
            2268,
            f"The average outdegree of the complete state graph is {avg} "
            f"(minimum is {mn}, the maximum {mx} and the 95th percentile is "
            f"{p95}).",
        )

    def finished(self, ms: int) -> None:
        self.msg(
            2186,
            f"Finished in {ms}ms at ({time.strftime('%Y-%m-%d %H:%M:%S')})",
        )

    # -- resilience (supervisor events) -------------------------------------

    def checkpoint_saved(self, path: str) -> None:
        """TLC's checkpoint banner (code 2195, "Checkpointing of run ...
        completed"), naming the generation file the supervisor wrote."""
        self.msg(2195, f"Checkpointing of run completed: {path}")

    def recovery(self, path: str, distinct: int) -> None:
        """TLC's -recover banner (code 2196): which snapshot the run
        resumed from and how much state it restored."""
        self.msg(
            2196,
            f"Starting recovery from checkpoint {path}: {distinct:,} "
            "distinct states restored.",
        )

    def regrow(self, resource: str, old, new, reason: str) -> None:
        """Auto-regrow event (code 2198, jaxtlc extension): the engine was
        rebuilt with `resource` doubled and the carry migrated - TLC has
        no analog (its disk structures grow implicitly; device tables
        cannot)."""
        self.msg(
            2198,
            f"Capacity exhausted ({reason}); regrowing {resource} "
            f"{old} -> {new} and resuming from the last good carry.",
        )

    def interrupted(self, signum, path, resume_cmd: str) -> None:
        """Preemption drain (severity 1): the run checkpointed and is
        resumable with the printed command."""
        where = (f"final checkpoint written to {path}" if path
                 else "no checkpoint path configured - progress lost")
        self.msg(
            2186,
            f"Run interrupted by signal {signum}; {where}.\n"
            f"Resume with: {resume_cmd}",
            severity=1,
        )

    # -- violations ---------------------------------------------------------

    def invariant_violated(self, name: str) -> None:
        self.msg(2110, f"Invariant {name} is violated.", severity=1)

    def deadlock(self) -> None:
        self.msg(2114, "Deadlock reached.", severity=1)

    def assertion_failed(self, detail: str) -> None:
        self.msg(
            2108,
            f"The first argument of Assert evaluated to FALSE; the second "
            f"argument was: {detail}",
            severity=1,
        )

    def trace_state(self, index: int, action: Optional[str], text: str) -> None:
        if action is None:
            head = f"State {index}: <Initial predicate>"
        else:
            line = self.action_lines.get(action, 0)
            head = (
                f"State {index}: <{action} line {line}, col 1 to line {line}, "
                f"col {len(action)} of module KubeAPI>"
            )
            if self.pcal_map is not None and not self.tool:
                # PlusCal-level rendering (M4): the .pmap maps the
                # generated-TLA action line back to the algorithm source -
                # the Toolbox's jump target, shown inline in plain mode
                loc = self.pcal_map.pcal_location(line)
                if loc is not None:
                    head += f"  [PlusCal line {loc[0]}, col {loc[1] + 1}]"
        self.msg(2217, head + "\n" + text, severity=1)
