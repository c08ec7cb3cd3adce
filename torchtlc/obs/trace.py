"""Chrome-trace (Perfetto) export of a run journal: the timeline tier
(port of jaxtlc/obs/trace.py, which imports no jax).

Renders the journal's host-observed intervals as a `chrome://tracing` /
https://ui.perfetto.dev JSON file (`-trace-out run.trace.json`):

* pid "device": one slice per supervised segment (dispatch -> fence),
  subdivided into per-level expand/commit sub-slices on two threads.
  When the journal carries MEASURED per-level `phase` events (a
  `-phase-timing` run, obs.phases), the sub-slices use those walls -
  the lanes are measurement, not illustration.  Without them the
  per-level spans fall back to the SCHEMATIC body-count-proportional
  placement inside the segment's host-observed wall; the overlap
  structure is still real either way: in pipeline mode the commit lane
  of level k overlaps the expand lane of level k+1 (the staged-block
  schedule), in fused mode they abut.  Ground-truth device timelines
  come from torch.profiler (``python3 -m torchtlc.profile``).
* pid "host": checkpoint-write and regrow-migration slices, plus
  instant markers for retries, faults, interruption, recovery and the
  final verdict - so "why was this segment slow" is one glance (the
  TensorFlow timeline discipline, arXiv:1605.08695 §5).
* counter tracks: distinct states, queue depth and fingerprint-table
  load per level, which Perfetto renders as rate/occupancy graphs.

The export is a pure function of the journal events (obs.journal), so
it can be produced live (`-trace-out`), after the fact from any
journal file (`python -m torchtlc.obs.trace run.journal.jsonl`), or
across an interruption - a SIGTERM'd + `-recover`ed run's single
continuous journal renders as one timeline with the gap visible.

Pod runs: a merged ``{base}.hN`` sibling stream renders as
ONE trace with a process-row PAIR per host (device lanes + host lanes,
keyed by the events' ``host`` field).  Every host's segment slices
share the same time origin, so cross-host skew is the horizontal
offset between the rows' fence edges, and the all_to_all fence wait is
the gap a fast host's segment end leaves before the slow host's - the
distributed-timeline reading the TensorFlow timeline discipline
(arXiv:1605.08695 §5) is built for.  Spill flushes carry their
measured wall (the highwater-triggered sweep) and render as duration
slices on their host's row.
"""

from __future__ import annotations

import json
import os
from typing import List

PID_DEVICE = 1
PID_HOST = 2
POD_PID_BASE = 10  # host h -> pids (BASE + 2h, BASE + 2h + 1)
TID_SEGMENT = 1
TID_EXPAND = 2
TID_COMMIT = 3
TID_CKPT = 1
TID_REGROW = 2


def _meta(pid: int, name: str) -> dict:
    return {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name}}


def _thread(pid: int, tid: int, name: str) -> dict:
    return {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name}}


def chrome_trace_events(events: List[dict]) -> List[dict]:
    """The journal -> traceEvents transform (timestamps in us, relative
    to the first journal event)."""
    if not events:
        return []
    t0 = events[0]["t"]
    us = lambda t: (t - t0) * 1e6  # noqa: E731

    pipeline = False
    for ev in events:
        if ev["event"] == "run_start":
            pipeline = bool(ev.get("params", {}).get("pipeline"))
            break

    out = []
    known: set = set()

    def pid_device(h):
        return PID_DEVICE if h is None else POD_PID_BASE + 2 * h

    def pid_host(h):
        return PID_HOST if h is None else POD_PID_BASE + 2 * h + 1

    def ensure(h):
        """Emit the process/thread metadata rows for host key `h` once
        (None = the single-process row pair; pod hosts each get their
        own pair, so the merged journal renders one process row per
        host with identical lane structure)."""
        if h in known:
            return
        known.add(h)
        tag = "" if h is None else f" host {h}"
        out.extend([
            _meta(pid_device(h), f"device engine{tag}"),
            _meta(pid_host(h), f"host (checkpoint/regrow){tag}"),
            _thread(pid_device(h), TID_SEGMENT, "segments"),
            _thread(pid_device(h), TID_EXPAND,
                    "expand (per level, schematic)"),
            _thread(pid_device(h), TID_COMMIT,
                    "commit (per level, schematic)"),
            _thread(pid_host(h), TID_CKPT, "checkpoint writes"),
            _thread(pid_host(h), TID_REGROW, "regrow migrations"),
        ])

    ensure(None)

    def instant(ev, name, args=None, h=None):
        ensure(h)
        out.append({"name": name, "ph": "i", "s": "g",
                    "ts": us(ev["t"]), "pid": pid_host(h),
                    "tid": TID_CKPT, "args": args or {}})

    # level events journal at the fence AFTER the segment they ran in:
    # walk in order, buffering levels (and any measured per-level phase
    # walls) against the most recent segment - PER HOST KEY, so a
    # merged pod stream's interleaved hosts never cross-attribute
    pending_levels: dict = {}  # host key -> [level rows]
    pending_phases: dict = {}  # host key -> {level: {expand, commit}}
    last_segment: dict = {}  # host key -> segment event
    prev_level: dict = {}  # host key -> last level event

    def flush_levels(h):
        """Subdivide host `h`'s last segment wall among its buffered
        levels, emitting expand/commit sub-slices whose overlap mirrors
        the engine's step schedule.  MEASURED placement when the
        segment's `phase` events cover every buffered level (a
        -phase-timing run: sequential expand->commit slices of the
        measured walls); body-count-proportional schematic otherwise."""
        seg = last_segment.get(h)
        levels = pending_levels.pop(h, [])
        phases = pending_phases.pop(h, {})
        if seg is None or not levels:
            return
        # shadow the module pids with this host's row pair: the slice
        # emission below then lands on the right process row unchanged
        PID_DEVICE = pid_device(h)
        seg_ts = us(seg["t_dispatch"])
        seg_dur = max(seg["wall_s"] * 1e6, 1.0)
        measured = all(
            {"expand", "commit"} <= set(phases.get(lv["level"], {}))
            for lv in levels
        )
        if measured:
            cursor = seg_ts
            for lv in levels:
                ph = phases[lv["level"]]
                args = {k: lv[k] for k in
                        ("level", "generated", "distinct", "queue",
                         "bodies", "expanded") if k in lv}
                args["measured"] = True
                for phase in ("expand", "commit"):
                    dur = max(ph[phase] * 1e6, 1.0)
                    out.append({
                        "name": f"{phase} L{lv['level']}", "ph": "X",
                        "ts": cursor, "dur": dur, "pid": PID_DEVICE,
                        "tid": TID_EXPAND if phase == "expand"
                        else TID_COMMIT,
                        "args": {**args, "wall_s": ph[phase]},
                    })
                    cursor += dur
                out.append({"name": "states", "ph": "C",
                            "ts": cursor, "pid": PID_DEVICE, "tid": 0,
                            "args": {"distinct": lv["distinct"],
                                     "queue": lv["queue"]}})
                if "fp_load" in lv:
                    out.append({"name": "fp_load", "ph": "C",
                                "ts": cursor, "pid": PID_DEVICE,
                                "tid": 0,
                                "args": {"load": lv["fp_load"]}})
            return
        bodies = [max(lv.get("bodies_level", 1), 1) for lv in levels]
        total = float(sum(bodies))
        cursor = seg_ts
        for lv, b in zip(levels, bodies):
            dur = seg_dur * (b / total)
            half = dur / 2.0
            args = {k: lv[k] for k in
                    ("level", "generated", "distinct", "queue",
                     "bodies", "expanded") if k in lv}
            if pipeline:
                # staged schedule: commit of level k rides alongside the
                # NEXT level's expansion - draw commit shifted half a
                # span so the overlap is visible in the two lanes
                out.append({"name": f"expand L{lv['level']}", "ph": "X",
                            "ts": cursor, "dur": dur, "pid": PID_DEVICE,
                            "tid": TID_EXPAND, "args": args})
                out.append({"name": f"commit L{lv['level']}", "ph": "X",
                            "ts": cursor + half, "dur": dur,
                            "pid": PID_DEVICE, "tid": TID_COMMIT,
                            "args": args})
            else:
                out.append({"name": f"expand L{lv['level']}", "ph": "X",
                            "ts": cursor, "dur": half,
                            "pid": PID_DEVICE, "tid": TID_EXPAND,
                            "args": args})
                out.append({"name": f"commit L{lv['level']}", "ph": "X",
                            "ts": cursor + half, "dur": half,
                            "pid": PID_DEVICE, "tid": TID_COMMIT,
                            "args": args})
            out.append({"name": "states", "ph": "C",
                        "ts": cursor + dur, "pid": PID_DEVICE, "tid": 0,
                        "args": {"distinct": lv["distinct"],
                                 "queue": lv["queue"]}})
            if "fp_load" in lv:
                out.append({"name": "fp_load", "ph": "C",
                            "ts": cursor + dur, "pid": PID_DEVICE,
                            "tid": 0,
                            "args": {"load": lv["fp_load"]}})
            cursor += dur

    for ev in events:
        kind = ev["event"]
        h = ev.get("host") if kind in (
            "segment", "level", "phase", "checkpoint", "spill") else None
        if kind == "segment":
            ensure(h)
            flush_levels(h)
            last_segment[h] = ev
            out.append({
                "name": f"segment {ev['index']}", "ph": "X",
                "ts": us(ev["t_dispatch"]),
                "dur": max(ev["wall_s"] * 1e6, 1.0),
                "pid": pid_device(h), "tid": TID_SEGMENT,
                "args": {"index": ev["index"],
                         "wall_s": ev["wall_s"]},
            })
        elif kind == "level":
            prev = prev_level.get(h)
            if prev is not None and prev["level"] == ev["level"]:
                # empty-queue trailing flips re-record the final
                # level's (identical, cumulative) row each no-op step
                continue
            lv = dict(ev)
            # per-level body count from the cumulative counter
            lv["bodies_level"] = (
                ev["bodies"] - prev["bodies"]
                if prev is not None else ev["bodies"]
            )
            prev_level[h] = ev
            pending_levels.setdefault(h, []).append(lv)
        elif kind == "phase":
            if ev["scope"] == "level":
                pending_phases.setdefault(h, {}).setdefault(
                    ev["index"], {}
                )[ev["phase"]] = ev["wall_s"]
            elif ev["scope"] == "segment" and ev["phase"] == "readback":
                ensure(h)
                out.append({
                    "name": "readback", "ph": "X",
                    "ts": us(ev["t"] - ev["wall_s"]),
                    "dur": max(ev["wall_s"] * 1e6, 1.0),
                    "pid": pid_host(h), "tid": TID_CKPT,
                    "args": {"segment": ev["index"]},
                })
        elif kind == "checkpoint":
            ensure(h)
            out.append({
                "name": f"checkpoint ({ev['label']})", "ph": "X",
                "ts": us(ev["t"] - ev["seconds"]),
                "dur": max(ev["seconds"] * 1e6, 1.0),
                "pid": pid_host(h), "tid": TID_CKPT,
                "args": {"path": ev["path"]},
            })
        elif kind == "regrow":
            out.append({
                "name": f"regrow {ev['resource']}", "ph": "X",
                "ts": us(ev["t"] - ev["seconds"]),
                "dur": max(ev["seconds"] * 1e6, 1.0),
                "pid": PID_HOST, "tid": TID_REGROW,
                "args": {"old": ev["old"], "new": ev["new"],
                         "violation": ev["violation"]},
            })
        elif kind == "retry":
            instant(ev, f"retry #{ev['attempt']}",
                    {"error": ev["error"]})
        elif kind == "fault":
            instant(ev, f"fault {ev['kind']}@{ev['at']}")
        elif kind == "spill":
            # the host tier's lifecycle rides the regrow thread (both
            # are host-side capacity work); also a counter track so
            # Perfetto graphs the cold-tier growth.  Highwater flushes
            # carry their measured wall and render as
            # DURATION slices, so the timeline shows what the sweep
            # cost at the fence that paid it
            ensure(h)
            if ev.get("phase") == "flush" and ev.get("wall_s"):
                out.append({
                    "name": "spill flush", "ph": "X",
                    "ts": us(ev["t"] - ev["wall_s"]),
                    "dur": max(ev["wall_s"] * 1e6, 1.0),
                    "pid": pid_host(h), "tid": TID_REGROW,
                    "args": {"spilled": ev["spilled"],
                             "flushed_tables": ev.get("flushed_tables"),
                             "wall_s": ev["wall_s"]},
                })
            else:
                instant(ev, f"spill {ev['phase']}",
                        {"spilled": ev["spilled"],
                         "hits": ev.get("hits"),
                         "probes": ev.get("probes")}, h=h)
            out.append({"name": "spilled_fps", "ph": "C",
                        "ts": us(ev["t"]), "pid": pid_host(h), "tid": 0,
                        "args": {"spilled": ev["spilled"]}})
        elif kind == "degrade":
            instant(ev, f"degrade [{ev['rung']}] {ev['resource']}",
                    {"action": ev["action"], "reason": ev["reason"]})
        elif kind == "exhausted":
            instant(ev, f"exhausted ({ev['resource']})",
                    {"checkpoint": ev["path"],
                     "distinct": ev["distinct"]})
        elif kind == "interrupted":
            instant(ev, f"interrupted (signal {ev['signum']})",
                    {"checkpoint": ev["path"]})
        elif kind in ("recovery", "run_resume"):
            instant(ev, kind, {"path": ev["path"]})
        elif kind == "final":
            instant(ev, f"final: {ev['verdict']}",
                    {"generated": ev["generated"],
                     "distinct": ev["distinct"],
                     "wall_s": ev["wall_s"]})
    for h in list(pending_levels):
        flush_levels(h)
    return out


def export_chrome_trace(events: List[dict], path: str) -> int:
    """Write the Perfetto-loadable JSON for `events` to `path` (fsync +
    rename, the checkpoint durability discipline).  Returns the number
    of trace events written."""
    from ..engine.checkpoint import fsync_replace

    trace = chrome_trace_events(events)
    doc = {"traceEvents": trace, "displayTimeUnit": "ms",
           "otherData": {"producer": "torchtlc obs.trace"}}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        fsync_replace(tmp, path, f=f)
    return len(trace)


def _tiny_journal(path: str) -> None:
    """A synthetic but schema-valid journal exercising every event kind
    the exporter renders (the --tiny smoke's input)."""
    from .journal import RunJournal

    with RunJournal(path) as j:
        base = j.event("run_start", version="tiny", workload="FF",
                       engine="single", device="cpu",
                       params={"pipeline": True, "chunk": 128})["t"]
        for s in range(2):
            td = base + 0.1 * s
            j.event("segment", index=s, t_dispatch=td,
                    t_fence=td + 0.09, wall_s=0.09)
            j.event("phase", scope="segment", index=s, phase="device",
                    wall_s=0.09)
            j.event("phase", scope="segment", index=s, phase="readback",
                    wall_s=0.002)
            for i in range(2):
                lvl = 2 * s + i + 1
                # second segment: measured per-level walls (the
                # -phase-timing tier) so the exporter's measured-lane
                # path is exercised alongside the schematic one
                if s == 1:
                    j.event("phase", scope="level", index=lvl,
                            phase="expand", wall_s=0.03, bodies=2)
                    j.event("phase", scope="level", index=lvl,
                            phase="commit", wall_s=0.012, bodies=2)
                j.event("level", level=lvl, generated=100 * lvl,
                        distinct=60 * lvl, queue=30, bodies=4 * lvl,
                        expanded=50 * lvl, fp_load=0.01 * lvl)
            j.event("progress", depth=2 * s + 2, generated=200 * (s + 1),
                    distinct=120 * (s + 1), queue=30)
        j.event("checkpoint", path="ck.g000001.npz", seconds=0.004,
                label="periodic")
        j.event("regrow", resource="fp_capacity", old=1 << 11,
                new=1 << 12, violation="fpset full", seconds=0.01)
        j.event("degrade", rung="regrow", resource="fp_capacity",
                action="denied", reason="RESOURCE_EXHAUSTED (tiny)")
        j.event("spill", phase="activate", resident=240, spilled=0,
                capacity=1 << 12, hits=0, probes=0)
        j.event("spill", phase="flush", resident=0, spilled=240,
                capacity=1 << 12, hits=12, probes=60, wall_s=0.003,
                flushed_tables=1)
        j.event("retry", attempt=1, delay_s=0.01, error="injected")
        j.event("interrupted", signum=15, path=None, generated=400,
                distinct=240, queue=30, wall_s=0.2)
        j.event("final", verdict="interrupted", generated=400,
                distinct=240, depth=4, queue=30, wall_s=0.2,
                interrupted=True)


def main(argv=None) -> int:
    """CLI: `python -m torchtlc.obs.trace JOURNAL [-o OUT]` exports a
    journal file; `--tiny` self-tests the whole pipeline on a synthetic
    journal (wired into tier-1, the profile_v4 --tiny pattern)."""
    import argparse
    import sys
    import tempfile

    from . import journal as jr

    p = argparse.ArgumentParser(prog="torchtlc.obs.trace")
    p.add_argument("journal", nargs="?", help="run journal (JSONL)")
    p.add_argument("-o", "--out", default="", help="trace output path "
                   "(default: <journal>.trace.json)")
    p.add_argument("--tiny", action="store_true",
                   help="smoke: synthesize a journal, export it, "
                        "validate the result")
    args = p.parse_args(argv)
    if args.tiny:
        with tempfile.TemporaryDirectory() as d:
            jpath = os.path.join(d, "tiny.journal.jsonl")
            _tiny_journal(jpath)
            events = jr.read(jpath)
            out = args.out or os.path.join(d, "tiny.trace.json")
            n = export_chrome_trace(events, out)
            with open(out) as f:
                doc = json.load(f)
            assert doc["traceEvents"] and n == len(doc["traceEvents"])
            names = {e.get("name", "") for e in doc["traceEvents"]}
            assert any(s.startswith("expand L") for s in names)
            assert any(s.startswith("commit L") for s in names)
        print(f"trace-export tiny OK: {n} trace events "
              f"({len(events)} journal events)")
        return 0
    if not args.journal:
        p.error("journal path required (or --tiny)")
    events = jr.read(args.journal, validate=False)
    out = args.out or args.journal + ".trace.json"
    n = export_chrome_trace(events, out)
    print(f"wrote {n} trace events from {len(events)} journal events "
          f"to {out}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
