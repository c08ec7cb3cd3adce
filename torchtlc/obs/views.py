"""Derived views of journal events (port of the part of
jaxtlc/obs/views.py the `check` command uses).

``render_tlc_event`` renders one supervisor event as its TLC
structured-log banner - the 2200 Progress line, the checkpoint (2195),
recovery (2196) and regrow (2198) banners, the retry, spill, degrade,
interrupt and exhaustion messages, the preflight's finding lines - so the
transcript is a view of the journal and cannot disagree with it.  ``interval_rates`` is the per-minute
rate arithmetic of the Progress line; ``reduce_gauges`` the state-space
reduction's gauges of a run (the reference's ``jaxtlc_reduce_*``,
jaxtlc/obs/views.py:268-278); ``cache_gauges`` its artifact-cache hits
and misses (:207-216), whose hits also render as the "Incremental
re-check" line (:447-460).
"""

from __future__ import annotations

from typing import Optional, Tuple


def interval_rates(prev: Optional[Tuple[float, int, int]],
                   now: float, generated: int,
                   distinct: int) -> Tuple[int, int]:
    """(states/min, distinct-states/min) between two observations; with no
    previous observation the raw counts, as TLC reports its first
    interval."""
    if prev is None or now <= prev[0]:
        return generated, distinct
    dt = now - prev[0]
    return (int((generated - prev[1]) * 60 / dt),
            int((distinct - prev[2]) * 60 / dt))


def reduce_gauges(events) -> dict:
    """The gauges of the newest `reduce` event: the transitions the ample
    sets pruned, their hit rate, the orbit factor and the distinct states
    of the reduced run; {} without one."""
    red = next((e for e in reversed(list(events))
                if e.get("event") == "reduce"), None)
    if red is None:
        return {}
    return {"reduce_states_pruned": red["states_pruned"],
            "reduce_ample_hit_rate": red["ample_hit_rate"],
            "reduce_orbit_factor": red["orbit_factor"],
            "reduce_distinct": red["distinct"]}


def cache_gauges(events) -> dict:
    """A run's artifact-cache decisions as counters (the reference's
    jaxtlc_artifact_cache_*, jaxtlc/obs/views.py:207-216): hits and misses
    of its `cache` events; {} without one."""
    evs = [e for e in events if e.get("event") == "cache"]
    if not evs:
        return {}
    return {"artifact_cache_hit_total": sum(
                1 for e in evs if e.get("outcome") == "hit"),
            "artifact_cache_miss_total": sum(
                1 for e in evs if e.get("outcome") == "miss")}


def render_tlc_event(log, ev: dict, resume_cmd: str = "") -> None:
    """Render one journal event as its TLC banner; kinds without one
    (segments, levels without a flag, flushes, final) render nothing."""
    kind = ev["event"]
    if kind == "progress":
        log.progress(ev["depth"], ev["generated"], ev["distinct"],
                     ev["queue"])
    elif kind == "analysis":
        log.msg(1000, f"Preflight {ev['severity']} "
                      f"[{ev['layer']}/{ev['check']}] {ev['subject']}: "
                      f"{ev['detail']}", severity=1)
    elif kind == "analysis_summary":
        if ev["findings"]:
            log.msg(1000, f"Preflight analysis: {ev['errors']} error(s), "
                          f"{ev['warnings']} warning(s) "
                          f"({ev['findings']} finding(s) total).",
                    severity=1)
    elif kind == "level" and ev.get("sym_violation"):
        # the ring's sticky COL_SYM flag: the runtime orbit check (K25)
        # caught the canonicalization NOT constant on a reachable orbit -
        # loud once per run; the command escalates the verdict to error
        if not getattr(log, "_warned_sym_violation", False):
            log._warned_sym_violation = True
            log.msg(
                1000,
                "ERROR: runtime orbit-certificate violation - the "
                "symmetry canonicalization mapped members of one "
                "reachable orbit to different representatives "
                "(jaxtlc.engine.reduce); the reduced run's results "
                "are NOT trustworthy.  Re-run with -no-symmetry and "
                "report the spec.",
                severity=1,
            )
        if ev.get("cert_violation") or ev.get("counter_overflow"):
            render_tlc_event(log, {**ev, "sym_violation": False})
    elif kind == "level" and ev.get("cert_violation"):
        # the ring's sticky COL_CERT flag: a generated state violated a
        # bound the certified abstract interpretation claimed - loud once
        # per run; the command escalates the verdict to error
        if not getattr(log, "_warned_cert_violation", False):
            log._warned_cert_violation = True
            log.msg(
                1000,
                "ERROR: runtime certificate violation - a reachable "
                "state lies outside the certified bounds the narrowed "
                "codec was built from (jaxtlc.analysis.absint); the "
                "narrowed run's results are NOT trustworthy.  Re-run "
                "with -no-narrow and report the spec.",
                severity=1,
            )
        if ev.get("counter_overflow"):
            render_tlc_event(log, {**ev, "cert_violation": False})
    elif kind == "level" and ev.get("counter_overflow"):
        # the ring's sticky COL_OVERFLOW flag: warn once per run
        if not getattr(log, "_warned_counter_overflow", False):
            log._warned_counter_overflow = True
            log.msg(
                1000,
                "Warning: on-device cumulative uint32 counters "
                "saturated (ring overflow flag set); generated/"
                "distinct totals beyond this level may have wrapped.",
                severity=1,
            )
    elif kind == "cache" and ev.get("outcome") == "hit":
        # loud when a run was answered (or BFS-skipped) from the artifact
        # cache - misses, writes and bypasses stay journal-only
        what = ("verdict replayed from the artifact cache (no engine "
                "was built)" if ev["tier"] == "verdict" else
                "reachable set loaded from the artifact cache; "
                "re-evaluating invariants only (BFS skipped)")
        log.msg(
            1000,
            f"Incremental re-check: {what}  [key "
            f"{ev['key'][:12]}..., -recheck forces a full run]",
            severity=1,
        )
    elif kind == "checkpoint":
        log.checkpoint_saved(ev["path"])
    elif kind == "recovery":
        log.recovery(ev["path"], ev["distinct"])
    elif kind == "regrow":
        log.regrow(ev["resource"], ev["old"], ev["new"], ev["violation"])
    elif kind == "retry":
        log.msg(
            1000,
            f"Transient error (attempt {ev['attempt']}): {ev['error']}; "
            f"retrying in {ev['delay_s']}s from the last good state.",
            severity=1,
        )
    elif kind == "ckpt_write_failed":
        log.msg(
            1000,
            f"Checkpoint write failed: {ev['error']} (run continues; "
            "the next segment boundary retries).",
            severity=1,
        )
    elif kind == "ckpt_fallback":
        log.msg(
            1000,
            f"Checkpoint {ev['path']} failed verification "
            f"({ev['error']}); falling back to the previous generation.",
            severity=1,
        )
    elif kind == "interrupted":
        log.interrupted(ev["signum"], ev["path"], resume_cmd)
    elif kind == "degrade":
        log.msg(
            1000,
            f"Capacity ladder [{ev['rung']}] {ev['resource']}: "
            f"{ev['action']} ({ev['reason']}).",
            severity=1,
        )
    elif kind == "spill" and ev["phase"] == "activate":
        # flushes stay in the journal (one per highwater crossing)
        log.msg(
            1000,
            "Host fingerprint spill tier activated: device table "
            f"stays at {ev['resident']:,} resident fingerprints, "
            "cold fingerprints migrate to host RAM "
            f"(store capacity {ev['capacity']:,}, auto-grows).",
            severity=1,
        )
    elif kind == "infer" and ev.get("phase") == "round":
        # inference filter rounds: one banner per evidence round (the
        # summary row stays journal-only; the API path renders its own
        # verdict lines with the certified invariant texts)
        log.msg(
            1000,
            f"Inference round {ev.get('round', '?')}: "
            f"{ev['killed']} of {ev['candidates']} candidates killed "
            f"against {ev.get('n_states', 0):,} "
            f"{ev.get('evidence', '')} evidence states "
            f"({ev['survivors']} survive).",
        )
    elif kind == "exhausted":
        log.msg(
            1000,
            f"Capacity exhausted ({ev['resource']}): "
            f"{ev['distinct']:,} distinct states checkpointed"
            + (f" at {ev['path']}" if ev.get("path") else
               " (no -checkpoint: progress lost)")
            + (f"; resume with: {resume_cmd}" if resume_cmd else ""),
            severity=1,
        )
