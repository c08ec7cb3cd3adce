"""Crash-safe append-only run journal (a copy of jaxtlc/obs/journal.py,
which imports no jax; the port keeps its own).

One JSONL file records what a run did: the manifest (run_start), every
segment fence, level flip, checkpoint write, regrow, retry, spill event,
violation and the final verdict; the TLC transcript's supervisor banners
are rendered from the same events (obs.views.render_tlc_event).  Every
event is validated (obs.schema), appended as one line, flushed and
fsync'd before `event()` returns; `read()` tolerates one torn trailing
line.  A `-recover` run appends to the same file after a `run_resume`
event.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterator, List, Optional

from .schema import SCHEMA_VERSION, JournalSchemaError, validate_event


class RunJournal:
    """Append-only JSONL event sink.

    path=None keeps the journal in memory only (bench / tests want the
    event stream without a file); otherwise the file is created (or
    appended to, for `resume=True`) with per-event fsync.

    fsync_every=N (default 1) batches the fsync: every event is still
    written + flushed per call (a line is complete or absent - the SSE
    tail and the torn-line reader contract are unchanged), but the
    durability barrier is paid once per N events.  Checkpointed runs
    keep the default: a checkpoint generation must never be newer than
    its journal."""

    def __init__(self, path: Optional[str] = None, resume: bool = False,
                 fsync_every: int = 1):
        self.path = path
        self.events: List[dict] = []
        self.fsync_every = max(1, int(fsync_every))
        self._unsynced = 0
        self._f = None
        if path:
            mode = "a" if resume and os.path.exists(path) else "w"
            self._f = open(path, mode, encoding="utf-8")

    def event(self, kind: str, **fields) -> dict:
        """Validate + append one event; returns the stamped event dict."""
        ev = {"v": SCHEMA_VERSION, "t": time.time(), "event": kind,
              **fields}
        validate_event(ev)
        self.events.append(ev)
        if self._f is not None:
            self._f.write(json.dumps(ev, sort_keys=True) + "\n")
            self._f.flush()
            self._unsynced += 1
            if self._unsynced >= self.fsync_every:
                os.fsync(self._f.fileno())
                self._unsynced = 0
        return ev

    def sync(self) -> None:
        """Force the durability barrier now (batched mode's checkpoint
        hook; a no-op when nothing is pending or the journal is
        in-memory)."""
        if self._f is not None and self._unsynced:
            os.fsync(self._f.fileno())
            self._unsynced = 0

    def close(self) -> None:
        if self._f is not None:
            self.sync()
            self._f.close()
            self._f = None

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def read(path: str, validate: bool = True) -> List[dict]:
    """Load a journal file.  A single torn TRAILING line (the crash-window
    artifact of an append cut mid-write) is skipped; a torn line anywhere
    else - or any schema violation when validate=True - raises, because
    that is corruption, not a crash artifact."""
    out: List[dict] = []
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break  # torn final line: the documented crash window
            raise JournalSchemaError(
                f"{path}:{i + 1}: unparseable journal line {line!r}"
            )
        if validate:
            validate_event(ev)
        out.append(ev)
    return out


def tail(path: str, since: int = 0) -> Iterator[dict]:
    """Yield journal events after index `since` (tlcstat's follow mode);
    invalid/torn lines at the tail are skipped until complete."""
    try:
        events = read(path, validate=False)
    except (OSError, JournalSchemaError):
        return
    for ev in events[since:]:
        yield ev
