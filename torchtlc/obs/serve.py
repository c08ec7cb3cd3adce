"""Run-monitoring server: the live serving surface over the run journal
(port of jaxtlc/obs/serve.py, which imports no jax; the metric names are
the reference's ``jaxtlc_*``, so one dashboard scrapes either package).

TLC's value rests partly on its always-on reporting (the reference
MC.out is 1108 lines of live progress); ours was post-hoc only - the
journal had to be read after the fact.  This module is the front door
of the checking-as-a-service direction (ROADMAP #4): a stdlib-only HTTP
server over a journal file or a directory of them, serving

* ``/metrics`` - Prometheus text format (states/s, distinct, fp load,
  spill occupancy/hit-rate, queue-drain ETA, per-phase walls) derived
  by obs.views.metrics_from_events - the SAME arithmetic as the TLC
  2200 line and tlcstat, so a scrape cannot disagree with the
  transcript;
* ``/events`` - Server-Sent-Events tail of the journal (one ``data:``
  line per event).  Because `-recover` APPENDS to the same journal
  file, a subscriber that spans a SIGTERM + resume sees ONE continuous
  stream: run_start ... interrupted ... run_resume ... final.  A torn
  trailing line (the crash window) is held back until it completes;
  ``?once=1`` dumps the current events and closes;
* ``/runs`` - the run registry: every ``*.journal.jsonl`` under the
  root, with workload/engine/verdict summary - many concurrent runs
  multiplex through one server (``?run=NAME`` selects on the other
  endpoints).  A multi-host pod's per-host journals
  (``{base}.h{pid}.journal.jsonl``, the reference's jaxtlc.dist) are
  GROUPED into one registry row (``run={base}``, ``pod_hosts=N``);
  selecting that row serves the N journals merged into one time-ordered stream on
  /metrics /journal /events, so a pod reads like a single run;
* ``/journal`` - the raw JSONL (torchtlc.obs.tlcstat --connect renders its
  dashboard from this, a remote client of the same views).

Wiring: ``python -m torchtlc.obs.serve DIR_OR_JOURNAL [--port N]``
standalone, or CLI ``-serve PORT`` to serve the live run's journal.
The server is read-only over files the run appends+fsyncs per event,
so it never blocks the writer.  The /events tail re-reads the file per
poll - O(file) per tick, fine for the journal sizes a run produces;
a seek-based tail is the upgrade path if journals grow past that.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from . import journal as jr
from .views import merge_journals, metrics_from_events

JOURNAL_SUFFIX = ".journal.jsonl"
POLL_S = 0.2


# /runs registry cache: journal scans keyed on (path, mtime, size) so
# a poll over a directory of mostly-idle runs rescans only the files
# that actually changed (rather than re-reading every journal per
# request).  Rows are immutable snapshots; entries for
# vanished files are dropped on the next scan.
_RUNS_CACHE: dict = {}
_RUNS_CACHE_LOCK = threading.Lock()


def _run_row(p: str) -> Optional[dict]:
    try:
        st = os.stat(p)
    except OSError:
        return None
    key = (st.st_mtime_ns, st.st_size)
    with _RUNS_CACHE_LOCK:
        hit = _RUNS_CACHE.get(p)
        if hit is not None and hit[0] == key:
            return hit[1]
    try:
        events = jr.read(p, validate=False)
    except OSError:
        return None
    manifest = next(
        (e for e in events if e["event"] == "run_start"), None
    )
    fin = next(
        (e for e in reversed(events) if e["event"] == "final"), None
    )
    # coverage saturation: the journal's once-per-run saturation
    # event, surfaced on the registry
    # row so /runs answers "did coverage plateau" without a re-read -
    # `coverage` marks journals that carry the plane at all, so a pod
    # row can distinguish "no plane" from "not yet saturated"
    cov_evs = [e for e in events if e["event"] == "coverage"]
    sat = next((e for e in reversed(cov_evs) if e.get("saturated")),
               None)
    row = {
        "run": os.path.basename(p)[: -len(JOURNAL_SUFFIX)]
        if p.endswith(JOURNAL_SUFFIX) else os.path.basename(p),
        "path": p,
        "events": len(events),
        "workload": manifest["workload"] if manifest else None,
        "engine": manifest["engine"] if manifest else None,
        "verdict": fin["verdict"] if fin else "running",
        "last_t": events[-1]["t"] if events else None,
        "resumes": sum(
            1 for e in events if e["event"] == "run_resume"
        ),
        "coverage": bool(cov_evs),
        "coverage_saturated": sat is not None,
        "coverage_saturated_level": (sat.get("level")
                                     if sat is not None else None),
    }
    with _RUNS_CACHE_LOCK:
        _RUNS_CACHE[p] = (key, row)
    return row


# per-host pod journal names: {base}.h{pid}.journal.jsonl (the reference's
# jaxtlc.dist)
_POD_HOST_RE = re.compile(r"^(?P<base>.+)\.h(?P<host>\d+)$")

# worst verdict wins when a pod's hosts disagree (one host's violation
# outranks the others' ok; a still-running host outranks finished ok)
_VERDICT_RANK = {"ok": 0, "running": 1, "interrupted": 2,
                 "exhausted": 3, "error": 4, "violation": 5}


def _group_pod_rows(rows: List[dict]) -> List[dict]:
    """Collapse per-host pod journal rows into one row per pod run.

    Hosts of the same run share everything but their shard, so the
    merged row sums events/resumes, takes the newest last_t, and keeps
    the worst verdict; `paths` (host order) lets the other endpoints
    serve the journals merged into one stream."""
    out, pods = [], {}
    for r in rows:
        m = _POD_HOST_RE.match(r["run"])
        if m:
            pods.setdefault(m.group("base"), []).append(
                (int(m.group("host")), r))
        else:
            out.append(r)
    for base, members in pods.items():
        members.sort()
        hrows = [r for _, r in members]
        # pod saturation: every host's coverage is a disjoint
        # fingerprint shard, so the POD has plateaued only when EVERY
        # covered host carried its once-per-run saturation event; the
        # level reported is the last (max) host level to plateau
        covered = [r for r in hrows if r.get("coverage")]
        saturated = bool(covered) and all(
            r.get("coverage_saturated") for r in covered)
        out.append({
            "run": base,
            "path": hrows[0]["path"],
            "paths": [r["path"] for r in hrows],
            "pod_hosts": len(hrows),
            "events": sum(r["events"] for r in hrows),
            "workload": hrows[0]["workload"],
            "engine": hrows[0]["engine"],
            "verdict": max((r["verdict"] for r in hrows),
                           key=lambda v: _VERDICT_RANK.get(v, 4)),
            "last_t": max((r["last_t"] or 0 for r in hrows)) or None,
            "resumes": sum(r["resumes"] for r in hrows),
            "coverage": bool(covered),
            "coverage_saturated": saturated,
            "coverage_saturated_level": (max(
                (r.get("coverage_saturated_level") or 0
                 for r in covered), default=0) or None
                if saturated else None),
        })
    return out


def _runs(root: str) -> List[dict]:
    """The run registry: one row per journal under `root` (or the row
    of `root` itself when it IS a journal file), newest first.  Scans
    are cached by (path, mtime, size) - unchanged journals cost one
    stat per request, not a full re-read.  Per-host pod journals are
    grouped into one row per pod (_group_pod_rows)."""
    paths = []
    if os.path.isdir(root):
        for name in sorted(os.listdir(root)):
            if name.endswith(JOURNAL_SUFFIX):
                paths.append(os.path.join(root, name))
    elif os.path.exists(root):
        paths = [root]
    rows = [r for r in (_run_row(p) for p in paths) if r is not None]
    with _RUNS_CACHE_LOCK:
        for stale in set(_RUNS_CACHE) - set(paths):
            if os.path.dirname(stale) == (root if os.path.isdir(root)
                                          else os.path.dirname(root)):
                _RUNS_CACHE.pop(stale, None)
    rows = _group_pod_rows(rows)
    rows.sort(key=lambda r: r["last_t"] or 0, reverse=True)
    return rows


def _row_events(row: dict) -> List[dict]:
    """Read a registry row's events - one journal, or a pod's per-host
    journals k-way merged into one time-ordered stream."""
    paths = row.get("paths") or [row["path"]]
    if len(paths) == 1:
        return jr.read(paths[0], validate=False)
    return merge_journals(*(jr.read(p, validate=False) for p in paths))


def prometheus_text(metrics: dict) -> str:
    """Render the metrics_from_events dict as Prometheus exposition
    text (flat gauges, one info-style labeled gauge, one labeled gauge
    per measured phase)."""
    lines = []
    info = metrics.get("run_info", {})
    labels = ",".join(
        f'{k}="{v}"' for k, v in sorted(info.items()) if v is not None
    )
    lines.append("# HELP jaxtlc_run_info run manifest + verdict labels")
    lines.append("# TYPE jaxtlc_run_info gauge")
    lines.append(f"jaxtlc_run_info{{{labels}}} 1")
    for key, val in sorted(metrics.items()):
        if key == "run_info":
            continue
        if key == "phase_wall_seconds":
            lines.append("# TYPE jaxtlc_phase_wall_seconds counter")
            for phase, secs in sorted(val.items()):
                lines.append(
                    f'jaxtlc_phase_wall_seconds{{phase="{phase}"}} '
                    f"{secs}"
                )
            continue
        if key == "pod_host_rates":
            # per-host per-level rates: the same figures as
            # jaxtlc_states_per_second, computed from each host's RAW
            # partial level rows - so a scrape sees the pod rate both
            # without (folded) and with host labels
            lines.append("# HELP jaxtlc_host_states_per_second "
                         "per-host per-level state rates")
            for host, gauges in sorted(val.items()):
                for gk, gv in sorted(gauges.items()):
                    lines.append(
                        f'jaxtlc_host_{gk}{{host="{host}"}} {gv}'
                    )
            continue
        if key == "pod_hosts":
            # per-host pod gauges (jaxtlc.dist): shard-table load,
            # spill-store bytes, level-fence exchange wall
            lines.append("# HELP jaxtlc_host_shard_occupancy per-host "
                         "fingerprint-table load fraction")
            for host, gauges in sorted(val.items()):
                for gk, gv in sorted(gauges.items()):
                    lines.append(
                        f'jaxtlc_host_{gk}{{host="{host}"}} {gv}'
                    )
            continue
        if key == "coverage_sites":
            # the device coverage plane's per-site counters
            lines.append("# HELP jaxtlc_coverage_site_total cumulative "
                         "visits per coverage site")
            lines.append("# TYPE jaxtlc_coverage_site_total counter")
            for site, n in sorted(val.items()):
                lines.append(
                    f'jaxtlc_coverage_site_total{{site="{site}"}} {n}'
                )
            continue
        lines.append(f"jaxtlc_{key} {val}")
    return "\n".join(lines) + "\n"


class _JournalTail:
    """Seek-position tail over an append-only journal (the /events SSE
    poll reads only the bytes appended since the last complete line, not
    the whole file per tick).  The torn-trailing-line contract is
    preserved: a line without its newline yet (the writer's crash
    window) is buffered and held back until the writer completes it, so
    a subscriber never sees a partial event and never sees one twice.
    A file that shrank (recreated journal) resets the tail."""

    def __init__(self, path: str):
        self.path = path
        self.pos = 0  # file offset of the next unread byte
        self._buf = b""  # held-back torn trailing line

    def poll(self) -> List[dict]:
        """Complete events appended since the last poll."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self.pos:
            self.pos = 0
            self._buf = b""
        if size == self.pos:
            return []
        try:
            with open(self.path, "rb") as f:
                f.seek(self.pos)
                chunk = f.read()
        except OSError:
            return []
        self.pos += len(chunk)
        lines = (self._buf + chunk).split(b"\n")
        self._buf = lines[-1]  # b"" after a complete trailing newline
        out = []
        for ln in lines[:-1]:
            if not ln.strip():
                continue
            try:
                out.append(json.loads(ln.decode("utf-8")))
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue  # defensive: skip an unparseable mid-file line
        return out


class _Handler(BaseHTTPRequestHandler):
    # the owning OpsServer stamps these class-wide at construction
    root: str = "."
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: the run owns stdout
        pass

    # -- helpers ---------------------------------------------------------

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _journal_row(self, qs: dict) -> Optional[dict]:
        """Resolve ?run=NAME against the registry (default: the most
        recently appended run).  A pod row carries `paths` - all its
        per-host journals; NAME matches the pod base or any member."""
        rows = _runs(self.root)
        want = qs.get("run", [None])[0]
        if want is None:
            return rows[0] if rows else None
        for r in rows:
            if (r["run"] == want or r["path"] == want
                    or want in r.get("paths", ())):
                return r
        return None

    # -- endpoints -------------------------------------------------------

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
        parsed = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(parsed.query)
        route = parsed.path.rstrip("/") or "/"
        try:
            if route == "/runs":
                self._send(200, json.dumps(
                    {"runs": _runs(self.root)}
                ).encode(), "application/json")
            elif route == "/metrics":
                row = self._journal_row(qs)
                if row is None:
                    self._send(404, b"no journal\n", "text/plain")
                    return
                events = _row_events(row)
                self._send(
                    200,
                    prometheus_text(metrics_from_events(events)).encode(),
                    "text/plain; version=0.0.4",
                )
            elif route == "/journal":
                row = self._journal_row(qs)
                if row is None:
                    self._send(404, b"no journal\n", "text/plain")
                    return
                events = _row_events(row)
                body = "".join(
                    json.dumps(e, sort_keys=True) + "\n" for e in events
                ).encode()
                self._send(200, body, "application/x-ndjson")
            elif route == "/coverage":
                # live device coverage: cumulative per-site totals,
                # derived from the journal's `coverage` delta events
                # (the same fold the Prometheus counters render)
                row = self._journal_row(qs)
                if row is None:
                    self._send(404, b"no journal\n", "text/plain")
                    return
                from .coverage import coverage_from_events

                events = _row_events(row)
                cov = coverage_from_events(events)
                if cov is None:
                    self._send(404, b"run has no coverage plane\n",
                               "text/plain")
                    return
                self._send(200, json.dumps(cov).encode(),
                           "application/json")
            elif route == "/cache":
                # incremental re-checking: the process
                # artifact store's counters + content listing.  In a
                # serving/run process this is the store its checks use;
                # a standalone monitor reports the default store on
                # disk (the same files cachectl ls shows)
                from ..struct.artifacts import get_store

                store = get_store()
                if store is None:
                    body = json.dumps({"enabled": False}).encode()
                else:
                    body = json.dumps({
                        "enabled": True,
                        "stats": store.stats(),
                        "entries": store.ls(),
                    }).encode()
                self._send(200, body, "application/json")
            elif route == "/events":
                self._events(qs)
            elif route == "/":
                body = (
                    "torchtlc run monitor\n"
                    "  /runs     run registry (JSON)\n"
                    "  /metrics  Prometheus text   [?run=NAME]\n"
                    "  /coverage live per-site coverage [?run=NAME]\n"
                    "  /cache    artifact-cache stats + contents\n"
                    "  /events   SSE journal tail  [?run=NAME]"
                    "[&once=1][&since=N]\n"
                    "  /journal  raw JSONL         [?run=NAME]\n"
                ).encode()
                self._send(200, body, "text/plain")
            else:
                self._send(404, b"unknown endpoint\n", "text/plain")
        except (BrokenPipeError, ConnectionResetError):
            pass  # subscriber went away mid-write: their call

    def _events(self, qs: dict) -> None:
        """SSE tail: emit every complete journal line, then poll for
        appends with a SEEK-POSITION tail (_JournalTail) - each tick
        reads only the appended bytes, not the whole file, and a torn
        trailing line is held back until the writer completes it, so a
        subscriber never sees a partial event (and never sees it
        twice).  The stream survives the writer's interrupt+`-recover`
        because resume APPENDS to the same file - one continuous
        stream per logical run.  A pod run tails EVERY per-host journal
        and merges each tick's batch by timestamp - one stream for the
        whole pod (cross-tick ordering is arrival order, the same
        best-effort a scrape of live files can ever give)."""
        row = self._journal_row(qs)
        if row is None:
            self._send(404, b"no journal\n", "text/plain")
            return
        once = qs.get("once", ["0"])[0] not in ("0", "")
        skip = int(qs.get("since", ["0"])[0])
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        # SSE is an unbounded stream: no Content-Length, close delimits
        self.send_header("Connection", "close")
        self.end_headers()
        tails = [_JournalTail(p)
                 for p in (row.get("paths") or [row["path"]])]
        emitted = 0
        while not self.server._torchtlc_shutdown.is_set():
            batch = merge_journals(*(t.poll() for t in tails))
            wrote = False
            for ev in batch:
                emitted += 1
                if emitted <= skip:
                    continue
                data = json.dumps(ev, sort_keys=True)
                self.wfile.write(f"data: {data}\n\n".encode())
                wrote = True
            if wrote:
                self.wfile.flush()
            if once:
                return
            time.sleep(POLL_S)


class OpsServer:
    """A running monitor server (daemon-threaded).  `port=0` binds an
    ephemeral port; read it back from `.port`."""

    def __init__(self, root: str, port: int = 0,
                 host: str = "127.0.0.1"):
        handler = type("BoundHandler", (_Handler,), {"root": root})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd._torchtlc_shutdown = threading.Event()
        self.httpd.daemon_threads = True
        self.root = root
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self) -> None:
        self.httpd._torchtlc_shutdown.set()
        self.httpd.shutdown()
        self.httpd.server_close()


def start_server(root: str, port: int = 0,
                 host: str = "127.0.0.1") -> OpsServer:
    """Start a monitor server over `root` (a journal file or a
    directory of them).  Returns the running OpsServer."""
    return OpsServer(root, port=port, host=host)


def _http_get(url: str, timeout: float = 5.0) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _tiny() -> int:
    """Smoke the whole serving pipeline on a synthetic journal: start a
    server, hit every endpoint with stdlib urllib, assert the derived
    views landed (wired into tier-1; no engine, no jax)."""
    import tempfile

    from .trace import _tiny_journal

    with tempfile.TemporaryDirectory() as d:
        jpath = os.path.join(d, "tiny.journal.jsonl")
        _tiny_journal(jpath)
        srv = start_server(d)
        try:
            runs = json.loads(_http_get(srv.url + "/runs"))["runs"]
            assert len(runs) == 1 and runs[0]["run"] == "tiny", runs
            assert runs[0]["verdict"] == "interrupted", runs
            metrics = _http_get(srv.url + "/metrics")
            for needle in ("jaxtlc_run_info", "jaxtlc_generated_total",
                           "jaxtlc_distinct_total",
                           "jaxtlc_spill_occupancy",
                           "jaxtlc_phase_wall_seconds{phase="):
                assert needle in metrics, (needle, metrics)
            sse = _http_get(srv.url + "/events?once=1&run=tiny")
            datas = [ln for ln in sse.splitlines()
                     if ln.startswith("data: ")]
            events = jr.read(jpath, validate=False)
            assert len(datas) == len(events), (len(datas), len(events))
            assert '"event": "final"' in datas[-1]
            raw = _http_get(srv.url + "/journal")
            assert len(raw.splitlines()) == len(events)
        finally:
            srv.shutdown()
    print(f"serve tiny OK: {len(events)} events served on "
          f"/runs /metrics /events /journal")
    return 0


def main(argv=None) -> int:
    """CLI: ``python -m torchtlc.obs.serve DIR_OR_JOURNAL [--port N]``."""
    import argparse

    p = argparse.ArgumentParser(prog="torchtlc.obs.serve")
    p.add_argument("root", nargs="?",
                   help="journal file or a directory of *.journal.jsonl")
    p.add_argument("--port", type=int, default=8790)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--tiny", action="store_true",
                   help="smoke: serve a synthetic journal end-to-end "
                        "(no engine run; wired into tier-1)")
    args = p.parse_args(argv)
    if args.tiny:
        return _tiny()
    if not args.root:
        p.error("root path required (or --tiny)")
    srv = start_server(args.root, port=args.port, host=args.host)
    print(f"torchtlc monitor serving {args.root!r} at {srv.url} "
          "(/runs /metrics /events /journal; ctrl-c exits)")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.shutdown()
        return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
