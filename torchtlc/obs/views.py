"""Derived views of journal events (port of jaxtlc/obs/views.py, which
imports no jax: the functions below are its copies, the metric names its
own, so one dashboard reads either package's journals).

``render_tlc_event`` renders one supervisor event as its TLC
structured-log banner - the 2200 Progress line, the checkpoint (2195),
recovery (2196) and regrow (2198) banners, the retry, spill, degrade,
interrupt and exhaustion messages, the preflight's finding lines - so the
transcript is a view of the journal and cannot disagree with it.  ``interval_rates`` is the per-minute
rate arithmetic of the Progress line; ``reduce_gauges`` the state-space
reduction's gauges of a run (the reference's ``jaxtlc_reduce_*``,
jaxtlc/obs/views.py:268-278); ``cache_gauges`` its artifact-cache hits
and misses (:207-216), whose hits also render as the "Incremental
re-check" line (:447-460).  ``merge_journals``, ``pod_sibling_journals``,
``fold_pod_levels`` and ``pod_host_gauges`` present a pod's per-host
journals as one run; ``eta_s`` and ``phase_totals`` are tlcstat's
arithmetic; ``metrics_from_events`` is the run monitor's metric set
(obs.serve /metrics).
"""

from __future__ import annotations

from typing import Optional, Tuple



def merge_journals(*streams):
    """Fold per-host pod journals (the reference's jaxtlc.dist writes one
    ``{base}.h{pid}.journal.jsonl`` per process) into ONE time-ordered
    event stream.  Each journal is append-ordered by its own `t`
    stamps, so this is a k-way sorted merge; ties keep input order
    (host-major), preserving every host's internal event order.  The
    serve plane's /runs registry uses it to present a pod as one
    logical run."""
    import heapq

    return list(heapq.merge(*streams, key=lambda e: e.get("t", 0)))


def pod_sibling_journals(path):
    """All ``{base}.hN.journal.jsonl`` siblings of `path` on disk
    (host-ordered), or ``[path]`` when it is not a per-host pod
    journal - so a CLI pointed at ANY one host's journal (tlcstat,
    covdiff) can render the whole pod merged."""
    import os
    import re

    m = re.match(r"^(?P<base>.+)\.h\d+\.journal\.jsonl$",
                 os.path.basename(path))
    if not m:
        return [path]
    d = os.path.dirname(os.path.abspath(path))
    pat = re.compile(re.escape(m.group("base"))
                     + r"\.h(\d+)\.journal\.jsonl$")
    out = {}
    for name in os.listdir(d):
        mm = pat.fullmatch(name)
        if mm:
            out[int(mm.group(1))] = os.path.join(d, name)
    return [out[k] for k in sorted(out)] or [path]


def fold_pod_levels(events):
    """Fold per-host PARTIAL ``level`` rows (the reference's jaxtlc.dist
    pods tag each with a ``host`` field, decoded from that process's ring rows only)
    into pod-global per-level rows: devices flip levels in lock-step
    (the level fence is a global psum), so the rows of every host at
    one level describe the SAME level with per-host partial cumulative
    counters - sum them, exactly shard_rows_from_ring's arithmetic
    lifted to the journal tier.  fp_load sums too (each host's load is
    its partial over the GLOBAL pod capacity); sticky flags OR; the
    action dicts add; `t` keeps the latest host stamp.  Journals with
    no host-tagged level rows pass through unchanged, so every
    single-process surface is untouched.

    Each host contributes AT MOST ONE row per level: the ring flips
    once per chunk step while the queue stays empty, so the final
    segment of a finished run re-records the last level's row on every
    no-op step - cumulative counters make those rows identical, and
    the LAST one per (host, level) is the authoritative partial."""
    host_levels = [e for e in events
                   if e.get("event") == "level" and "host" in e]
    if not host_levels:
        return events
    last: dict = {}  # (host, level) -> the host's final row for it
    for e in host_levels:
        last[(e["host"], int(e["level"]))] = e
    by_level: dict = {}
    for (_h, lv), e in sorted(last.items(),
                              key=lambda kv: (kv[0][1], kv[0][0])):
        g = by_level.setdefault(lv, {
            "event": "level", "t": e.get("t", 0), "level": lv,
            "generated": 0, "distinct": 0, "queue": 0,
            "bodies": 0, "expanded": 0,
        })
        g["t"] = max(g["t"], e.get("t", 0))
        for k in ("generated", "distinct", "queue", "bodies",
                  "expanded", "spill_hits"):
            if k in e:
                g[k] = g.get(k, 0) + int(e[k])
        if "fp_load" in e:
            g["fp_load"] = round(g.get("fp_load", 0.0)
                                 + float(e["fp_load"]), 6)
        for k in ("counter_overflow", "cert_violation", "sym_violation"):
            if e.get(k):
                g[k] = True
        for k in ("action_generated", "action_distinct"):
            if k in e:
                d = g.setdefault(k, {})
                for a, v in e[k].items():
                    d[a] = d.get(a, 0) + int(v)
    rest = [e for e in events
            if not (e.get("event") == "level" and "host" in e)]
    return sorted(rest + list(by_level.values()),
                  key=lambda e: e.get("t", 0))


def pod_host_gauges(events) -> Optional[dict]:
    """The per-host gauge table from a (merged) journal's ``pod``
    events: {host: {shard_occupancy, spill_bytes, exchange_us}}, each
    host's LATEST stats row winning (the rows arrive at segment fences).
    None when the journal carries no pod plane."""
    hosts = {}
    for e in events:
        if e.get("event") == "pod" and e.get("phase") == "stats":
            hosts[int(e["host"])] = {
                "shard_occupancy": e.get("shard_occupancy", 0),
                "spill_bytes": e.get("spill_bytes", 0),
                "exchange_us": e.get("exchange_us", 0),
            }
    return hosts or None


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


def eta_s(prev: Optional[dict], cur: dict) -> Optional[float]:
    """Seconds until the current queue drains at the current distinct-
    state rate - the rough time-to-exhaustive figure tlcstat prints.
    None when the rate is unknown or zero (first report / stalled)."""
    if prev is None:
        return None
    dt = cur["t"] - prev["t"]
    dd = cur["distinct"] - prev["distinct"]
    if dt <= 0 or dd <= 0:
        return None
    return cur["queue"] / (dd / dt)


def phase_totals(events) -> dict:
    """Cumulative measured wall seconds per phase name from the `phase`
    events (obs.phases) of a journal: {phase: seconds}.  Level- and
    segment-scope rows both accumulate (they attribute different walls:
    expand/commit device halves vs device/readback fence intervals)."""
    out = {}
    for ev in events:
        if ev.get("event") == "phase":
            key = ev["phase"]
            out[key] = out.get(key, 0.0) + float(ev["wall_s"])
    return out


def metrics_from_events(events) -> dict:
    """The run-monitoring metric set (obs.serve /metrics) as one flat
    dict, derived from a journal event list by the SAME arithmetic the
    TLC 2200 line and tlcstat use (interval_rates / eta_s above), so a
    Prometheus scrape can never disagree with the transcript.

    Pod journals (merged ``{base}.hN`` siblings) fold first: the
    headline counters/rates come from the pod-global per-level rows
    (fold_pod_levels), and the RAW per-host rows additionally yield
    `pod_host_rates` so Prometheus can export per-level rates both
    with and without host labels."""
    raw = events
    events = fold_pod_levels(events)
    prog = [e for e in events
            if e["event"] in ("level", "progress", "final",
                              "interrupted", "exhausted", "recovery")]
    cur = prog[-1] if prog else None
    levels = [e for e in events if e["event"] == "level"]
    prev = levels[-2] if len(levels) > 1 else None
    counts = {}
    for e in events:
        counts[e["event"]] = counts.get(e["event"], 0) + 1
    out = {
        "events_total": len(events),
        "segments_total": counts.get("segment", 0),
        "checkpoints_total": counts.get("checkpoint", 0),
        "regrows_total": counts.get("regrow", 0),
        "retries_total": counts.get("retry", 0),
        "degrades_total": counts.get("degrade", 0),
    }
    cache_evs = [e for e in events if e["event"] == "cache"]
    if cache_evs:
        # incremental re-checking: this run's artifact-cache
        # decisions as Prometheus counters (jaxtlc_artifact_cache_*)
        out["artifact_cache_hit_total"] = sum(
            1 for e in cache_evs if e.get("outcome") == "hit"
        )
        out["artifact_cache_miss_total"] = sum(
            1 for e in cache_evs if e.get("outcome") == "miss"
        )
    manifest = next((e for e in events if e["event"] == "run_start"),
                    None)
    fin = next((e for e in reversed(events) if e["event"] == "final"),
               None)
    info = {}
    if manifest is not None:
        info = {"workload": manifest["workload"],
                "engine": manifest["engine"],
                "device": manifest["device"]}
    info["verdict"] = fin["verdict"] if fin is not None else "running"
    out["run_info"] = info
    if cur is not None:
        out["generated_total"] = cur.get("generated", 0)
        out["distinct_total"] = cur.get("distinct", 0)
        out["queue"] = cur.get("queue", 0)
        out["depth"] = cur.get("level", cur.get("depth", 0))
        if prev is not None and cur["event"] == "level":
            spm, dpm = interval_rates(
                (prev["t"], prev["generated"], prev["distinct"]),
                cur["t"], cur["generated"], cur["distinct"],
            )
            out["states_per_second"] = round(spm / 60.0, 3)
            out["distinct_per_second"] = round(dpm / 60.0, 3)
            eta = eta_s(prev, cur)
            if eta is not None:
                out["queue_drain_eta_seconds"] = round(eta, 3)
        if "fp_load" in cur:
            out["fp_load"] = cur["fp_load"]
    sim = next((e for e in reversed(events) if e["event"] == "sim"),
               None)
    if sim is not None:
        # simulation tier: walk progress as Prometheus
        # gauges (jaxtlc_sim_*) - the smoke job class's live surface
        out["sim_walkers"] = sim["walkers"]
        out["sim_depth"] = sim["depth"]
        out["sim_steps"] = sim["steps"]
        out["sim_transitions"] = sim["transitions"]
        if "distinct_est" in sim:
            out["sim_distinct_estimate"] = sim["distinct_est"]
    inf = next((e for e in reversed(events) if e["event"] == "infer"),
               None)
    if inf is not None:
        # inference tier: the candidate-pool funnel as
        # Prometheus gauges (jaxtlc_infer_*) - conjectured, killed by
        # evidence, surviving, certified inductive
        out["infer_candidates"] = inf["candidates"]
        out["infer_killed"] = inf["killed"]
        out["infer_survivors"] = inf["survivors"]
        out["infer_certified"] = inf["certified"]
        if "n_states" in inf:
            out["infer_evidence_states"] = inf["n_states"]
    red = next((e for e in reversed(events) if e["event"] == "reduce"),
               None)
    if red is not None:
        # state-space reduction: what symmetry/POR bought
        # this run, as Prometheus gauges (jaxtlc_reduce_*) - the
        # transitions the ample sets cut, their hit rate, and the
        # orbit factor the canonicalization divides the space by
        out["reduce_states_pruned"] = red["states_pruned"]
        out["reduce_ample_hit_rate"] = red["ample_hit_rate"]
        out["reduce_orbit_factor"] = red["orbit_factor"]
        out["reduce_distinct"] = red["distinct"]
    sched_evs = [e for e in events if e["event"] == "sched"]
    if sched_evs:
        # serve-plane control decisions: the scheduler's
        # own journal as Prometheus counters (jaxtlc_sched_*) - one
        # per admit/reject/expire/preempt/requeue/retry/quarantine/
        # cancel decision, plus the queue depth the latest decision
        # observed
        for action in ("admit", "reject", "expire", "preempt",
                       "requeue", "retry", "quarantine", "cancel",
                       "dispatch"):
            n = sum(1 for e in sched_evs if e.get("action") == action)
            if n:
                out[f"sched_{action}_total"] = n
        depth = next((e["queued"] for e in reversed(sched_evs)
                      if "queued" in e), None)
        if depth is not None:
            out["sched_queue_depth"] = depth
    pod_evs = [e for e in events if e["event"] == "pod"]
    if pod_evs:
        # multi-host pods: membership counters + the
        # per-host shard gauges (Prometheus jaxtlc_host_* with a host
        # label - shard table load, spill-store bytes, and the
        # level-fence exchange/consensus wall in µs)
        out["pod_size"] = max(int(e["hosts"]) for e in pod_evs)
        out["pod_joins_total"] = sum(
            1 for e in pod_evs if e.get("phase") == "join")
        leaves = sum(1 for e in pod_evs if e.get("phase") == "leave")
        reshards = sum(
            1 for e in pod_evs if e.get("phase") == "reshard")
        if leaves:
            out["pod_leaves_total"] = leaves
        if reshards:
            out["pod_reshards_total"] = reshards
        hosts = pod_host_gauges(pod_evs)
        if hosts:
            out["pod_hosts"] = hosts
    host_levels: dict = {}
    for e in raw:
        if e.get("event") == "level" and "host" in e:
            host_levels.setdefault(int(e["host"]), []).append(e)
    if host_levels:
        # per-host per-level rates from each host's RAW partial rows
        # (Prometheus jaxtlc_host_states_per_second{host=...}); the
        # unlabeled rates above come from the folded pod-global rows
        rates = {}
        for h, lv in sorted(host_levels.items()):
            if len(lv) > 1:
                p, c = lv[-2], lv[-1]
                spm, dpm = interval_rates(
                    (p["t"], p["generated"], p["distinct"]),
                    c["t"], c["generated"], c["distinct"],
                )
                rates[h] = {
                    "states_per_second": round(spm / 60.0, 3),
                    "distinct_per_second": round(dpm / 60.0, 3),
                }
        if rates:
            out["pod_host_rates"] = rates
    sp = next((e for e in reversed(events) if e["event"] == "spill"),
              None)
    if sp is not None:
        out["spill_spilled"] = sp["spilled"]
        out["spill_capacity"] = sp["capacity"]
        out["spill_occupancy"] = round(
            sp["spilled"] / max(sp["capacity"], 1), 6
        )
        out["spill_hit_rate"] = round(
            sp.get("hits", 0) / max(sp.get("probes", 0), 1), 6
        )
    phases = phase_totals(events)
    if phases:
        out["phase_wall_seconds"] = {
            k: round(v, 6) for k, v in sorted(phases.items())
        }
    from .coverage import coverage_from_events

    cov = coverage_from_events(events)
    if cov is not None:
        # per-site cumulative counters (Prometheus coverage_site_total)
        # + the visited/total header gauges
        out["coverage_sites"] = cov["sites"]
        out["coverage_visited"] = cov["visited"]
        out["coverage_n_sites"] = cov["n_sites"]
        if cov.get("saturated_at_level") is not None:
            out["coverage_saturated_at_level"] = (
                cov["saturated_at_level"]
            )
    if fin is not None:
        out["wall_seconds"] = fin["wall_s"]
    return out


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
