"""tlcstat: one-screen live dashboard over a run journal (port of
tools/tlcstat.py over torchtlc.obs; it reads either package's journals).

Tails the append-only JSONL journal a run writes (`-journal PATH`, or
`CKPT.journal.jsonl` beside a `-checkpoint`) and renders the numbers an
operator actually wants mid-run: current depth, generated/distinct with
interval rates (the same arithmetic as the TLC 2200 Progress line -
obs.views.interval_rates is shared, so they cannot disagree), queue
depth, fingerprint-table occupancy, a queue-drain ETA, recovery-event
counts, and the last journal event.

    python -m torchtlc.obs.tlcstat RUN.journal.jsonl            # one frame
    python -m torchtlc.obs.tlcstat RUN.journal.jsonl --follow   # live tail
    python -m torchtlc.obs.tlcstat --connect http://HOST:PORT   # remote
    python -m torchtlc.obs.tlcstat --tiny                       # smoke

The dashboard is a pure view of the journal - it opens the file
read-only and never blocks the writer (per-event fsync appends are
atomic at line granularity; a torn trailing line is skipped).
--connect renders the SAME view over a torchtlc.obs.serve monitor's
/journal endpoint (stdlib urllib), so remote runs get the identical
dashboard; --run NAME selects among the server's registered runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import journal as jr
from .schema import SCHEMA_VERSION
from .views import eta_s, interval_rates, phase_totals


def _fmt_eta(s) -> str:
    if s is None:
        return "-"
    if s < 90:
        return f"{s:.0f}s"
    if s < 5400:
        return f"{s / 60:.1f}m"
    return f"{s / 3600:.1f}h"


def _last_two(events, kinds):
    """(previous, latest) events of the given kinds (None-padded)."""
    hits = [e for e in events if e["event"] in kinds]
    if not hits:
        return None, None
    return (hits[-2] if len(hits) > 1 else None), hits[-1]


def render(events) -> str:
    """One dashboard frame from a journal event list.  A merged pod
    stream folds its per-host partial `level` rows into pod-global
    rows first (obs.views.fold_pod_levels), so the headline counters
    and rates describe the whole pod; the pod line below keeps the
    per-host view (shard load, fence wait)."""
    from .views import fold_pod_levels

    events = fold_pod_levels(events)
    if not events:
        return "tlcstat: journal is empty (run not started yet?)"
    manifest = next(
        (e for e in events if e["event"] == "run_start"), None
    )
    lines = []
    if manifest is not None:
        p = manifest.get("params", {})
        lines.append(
            f"torchtlc {manifest['version']}  |  {manifest['workload']} "
            f"({manifest['engine']} engine)  |  {manifest['device']}"
        )
        lines.append(
            f"journal schema v{events[0]['v']} (reader v{SCHEMA_VERSION})"
            f"  chunk={p.get('chunk', '?')}"
            f"  fp_capacity={p.get('fp_capacity', '?')}"
            f"  pipeline={p.get('pipeline', False)}"
            f"  obs_slots={p.get('obs_slots', 0)}"
        )
    # progress source: level events (per-level resolution) when the
    # device ring is on, progress events otherwise
    prev, cur = _last_two(events, ("level",))
    if cur is None:
        prev, cur = _last_two(events, ("progress",))
    if cur is not None:
        spm, dpm = interval_rates(
            (prev["t"], prev["generated"], prev["distinct"])
            if prev is not None else None,
            cur["t"], cur["generated"], cur["distinct"],
        )
        depth = cur.get("level", cur.get("depth", "?"))
        lines.append(
            f"depth {depth}  |  {cur['generated']:,} generated "
            f"({spm:,} s/min)  |  {cur['distinct']:,} distinct "
            f"({dpm:,} ds/min)"
        )
        occ = cur.get("fp_load")
        # with the host spill tier active, distinct states exceed the
        # DEVICE table: the ratio is the logical set vs the hot tier
        spilling = any(e["event"] == "spill" for e in events)
        occ_txt = ""
        if occ is not None:
            occ_txt = (f"  |  fp space {occ:.1%} of device tier "
                       "(spilling)" if spilling
                       else f"  |  fp table {occ:.1%} full")
        lines.append(
            f"queue {cur['queue']:,}" + occ_txt
            + f"  |  ETA (queue drain) {_fmt_eta(eta_s(prev, cur))}"
        )
    counts = {}
    for e in events:
        counts[e["event"]] = counts.get(e["event"], 0) + 1
    lines.append(
        f"segments {counts.get('segment', 0)}"
        f"  checkpoints {counts.get('checkpoint', 0)}"
        f"  regrows {counts.get('regrow', 0)}"
        f"  retries {counts.get('retry', 0)}"
        f"  interruptions {counts.get('interrupted', 0)}"
        f"  degrades {counts.get('degrade', 0)}"
    )
    # multi-host pod (jaxtlc.dist): per-host shard-table load + spill
    # bytes from the latest pod stats row of each host, and the fence
    # exchange wall of the slowest host (the fence waits for it)
    from .views import pod_host_gauges

    pod = pod_host_gauges(events)
    if pod is not None:
        hosts = max(e["hosts"] for e in events if e["event"] == "pod")
        # per-host fence-wait column: every host reports its OWN vote/
        # exchange wall, so the skewed host is visible by name (the
        # global fence waits for the slowest one, reported last)
        per = "  ".join(
            f"h{h} shard {g['shard_occupancy']:.1%} "
            f"fence {g['exchange_us'] / 1000:.1f}ms"
            + (f" spill {g['spill_bytes'] / 1024:.0f}KiB"
               if g["spill_bytes"] else "")
            for h, g in sorted(pod.items())
        )
        fence = max(g["exchange_us"] for g in pod.values())
        reshards = sum(1 for e in events if e["event"] == "pod"
                       and e.get("phase") == "reshard")
        lines.append(
            f"pod: {hosts} hosts  |  {per}  |  slowest fence "
            f"{fence / 1000:.1f}ms"
            + (f"  |  reshards {reshards}" if reshards else "")
        )
    # host spill tier: occupancy + hit rate of the most recent spill
    # event (the device tier's cold-fingerprint overflow store)
    sp = next((e for e in reversed(events) if e["event"] == "spill"),
              None)
    if sp is not None:
        probes = max(sp.get("probes", 0), 1)
        lines.append(
            f"spill tier: {sp['spilled']:,} fps host-side "
            f"({sp['spilled'] / max(sp['capacity'], 1):.1%} of "
            f"{sp['capacity']:,})  |  flushes "
            f"{max(counts.get('spill', 1) - 1, 0)}  |  host hit-rate "
            f"{sp.get('hits', 0) / probes:.1%} of {sp.get('probes', 0):,}"
            " probes"
        )
    # simulation tier (jaxtlc.sim): the walk cursor + the sampled
    # distinct estimate of the most recent sim event (a smoke run's
    # whole progress story - walks carry no frontier/queue)
    sim = next((e for e in reversed(events) if e["event"] == "sim"),
               None)
    if sim is not None:
        est = sim.get("distinct_est", 0)
        sat = " (saturated)" if sim.get("fp_saturated") else ""
        lines.append(
            f"sim: {sim['walkers']} walkers  depth "
            f"{sim['steps']}/{sim['depth']}  "
            f"{sim['transitions']:,} transitions  "
            f"~{est:,} distinct sampled{sat}"
        )
    # inference tier (jaxtlc.infer): the candidate funnel of the most
    # recent infer event - conjectured -> killed -> surviving ->
    # certified (an inference run's whole progress story)
    inf = next((e for e in reversed(events) if e["event"] == "infer"),
               None)
    if inf is not None:
        lines.append(
            f"infer: {inf['candidates']} candidates  "
            f"{inf['killed']} killed  {inf['survivors']} survive  "
            f"{inf['certified']} certified  "
            f"[{inf.get('evidence', '?')} x "
            f"{inf.get('n_states', 0):,} states]"
        )
    # state-space reduction (engine.reduce): what symmetry/POR bought
    # the most recent reduced run - the orbit factor the space was
    # divided by and the transitions the ample sets cut pre-dedup
    red = next((e for e in reversed(events) if e["event"] == "reduce"),
               None)
    if red is not None:
        lines.append(
            f"reduction: orbit factor {red['orbit_factor']}x  |  "
            f"{red['states_pruned']:,} transitions POR-pruned "
            f"({red['ample_hit_rate']:.1%} of expansion)  |  "
            f"{red['distinct']:,} distinct representatives"
        )
    # incremental re-checking (struct.artifacts): this run's artifact
    # cache decisions - a hit means the verdict was replayed (or BFS
    # skipped) instead of re-explored
    cache_evs = [e for e in events if e["event"] == "cache"]
    if cache_evs:
        hits = [e for e in cache_evs if e.get("outcome") == "hit"]
        misses = sum(1 for e in cache_evs
                     if e.get("outcome") == "miss")
        tiers = ",".join(sorted({e["tier"] for e in hits})) or "-"
        lines.append(
            f"artifact cache: {len(hits)} hit(s) [{tiers}]  "
            f"{misses} miss(es)  "
            f"last {cache_evs[-1]['tier']}/{cache_evs[-1]['outcome']}"
        )
    # scheduler control plane (serve.scheduler): the service's
    # admission/preempt/breaker decision counts, plus the queue depth
    # of the latest event that carried one
    sched_evs = [e for e in events if e["event"] == "sched"]
    if sched_evs:
        acts = {}
        for e in sched_evs:
            acts[e["action"]] = acts.get(e["action"], 0) + 1
        depth = next((e["queued"] for e in reversed(sched_evs)
                      if "queued" in e), None)
        lines.append(
            "sched: " + "  ".join(
                f"{k} {acts[k]}" for k in
                ("admit", "dispatch", "reject", "expire", "preempt",
                 "requeue", "retry", "quarantine", "cancel")
                if k in acts
            ) + (f"  |  queue {depth}" if depth is not None else "")
        )
    # phase attribution (obs.phases): cumulative measured walls per
    # phase - expand/commit from -phase-timing, device/readback free
    # at every fence
    phases = phase_totals(events)
    if phases:
        lines.append("phase walls: " + "  ".join(
            f"{k} {v:.3f}s" for k, v in sorted(phases.items())
        ))
    # device coverage plane (obs.coverage): visited/total sites + the
    # saturation signal, folded from the journal's coverage deltas
    from .coverage import coverage_from_events

    cov = coverage_from_events(events)
    if cov is not None:
        sat = cov.get("saturated_at_level")
        lines.append(
            f"coverage: {cov['visited']}/{cov['n_sites']} sites visited"
            + (f"  |  SATURATED at level {sat} (no new site since)"
               if sat is not None else "")
        )
    last = events[-1]
    age = time.time() - last["t"]
    lines.append(f"last event: {last['event']} ({age:.1f}s ago)")
    fin = next((e for e in reversed(events) if e["event"] == "final"),
               None)
    if fin is not None:
        lines.append(
            f"VERDICT: {fin['verdict']}  -  {fin['generated']:,} "
            f"generated, {fin['distinct']:,} distinct, depth "
            f"{fin['depth']}, wall {fin['wall_s']:.3f}s"
        )
    width = max(len(x) for x in lines)
    bar = "=" * min(width, 78)
    return "\n".join([bar, *lines, bar])


def _read_maybe_pod(path: str) -> list:
    """Journal events; a per-host pod journal (``{base}.hN``) pulls in
    every sibling on disk and k-way merges them, so pointing tlcstat at
    ANY one host renders the whole pod's dashboard."""
    from .views import merge_journals, pod_sibling_journals

    paths = pod_sibling_journals(path)
    if len(paths) == 1:
        return jr.read(paths[0], validate=False)
    return merge_journals(*(jr.read(p, validate=False) for p in paths))


def _fetch_remote(url: str, run: str = "") -> list:
    """Journal events from a torchtlc.obs.serve monitor's /journal
    endpoint (the remote-client mode of the same dashboard)."""
    import urllib.request

    endpoint = url.rstrip("/") + "/journal"
    if run:
        import urllib.parse

        endpoint += "?run=" + urllib.parse.quote(run)
    with urllib.request.urlopen(endpoint, timeout=10) as r:
        return [json.loads(line) for line in
                r.read().decode().splitlines() if line.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tlcstat")
    p.add_argument("journal", nargs="?", help="run journal (JSONL)")
    p.add_argument("--connect", default="", metavar="URL",
                   help="render a REMOTE run from a torchtlc.obs.serve "
                        "monitor (base URL, e.g. http://host:8790)")
    p.add_argument("--run", default="",
                   help="with --connect: which registered run "
                        "(default: the monitor's most recent)")
    p.add_argument("--follow", action="store_true",
                   help="re-render as the journal grows (ctrl-c exits)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="follow-mode refresh seconds")
    p.add_argument("--tiny", action="store_true",
                   help="smoke: render a synthetic journal end-to-end "
                        "(no engine run; wired into tier-1)")
    args = p.parse_args(argv)

    if args.tiny:
        import tempfile

        from .trace import _tiny_journal

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "tiny.journal.jsonl")
            _tiny_journal(path)
            frame = render(jr.read(path))
        assert "VERDICT: interrupted" in frame and "ds/min" in frame
        assert "phase walls:" in frame and "expand" in frame
        print(frame)
        print("tlcstat tiny OK")
        return 0

    if args.connect:
        try:
            if not args.follow:
                print(render(_fetch_remote(args.connect, args.run)))
                return 0
            while True:
                frame = render(_fetch_remote(args.connect, args.run))
                sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
                sys.stdout.flush()
                time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
        except OSError as e:
            print(f"tlcstat: cannot reach {args.connect!r}: {e}",
                  file=sys.stderr)
            return 1
    if not args.journal:
        p.error("journal path required (or --tiny)")
    if not os.path.exists(args.journal):
        print(f"tlcstat: no journal at {args.journal!r}",
              file=sys.stderr)
        return 1
    if not args.follow:
        print(render(_read_maybe_pod(args.journal)))
        return 0
    try:
        while True:
            frame = render(_read_maybe_pod(args.journal))
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
