"""Versioned schema of the run journal (a copy of jaxtlc/obs/schema.py,
which imports no jax; the port keeps its own).

Every journal line is one JSON event validated here before it is
written: each kind declares its REQUIRED fields with Python type tuples;
extra fields are allowed, missing or badly typed ones raise
JournalSchemaError.  The port's journals follow the reference's schema
version, so one reader takes both.
"""

from __future__ import annotations

SCHEMA_VERSION = 1

_NUM = (int, float)
_STR = (str,)
_BOOL = (bool,)
_OPT_STR = (str, type(None))
_OPT_NUM = (int, float, type(None))

ENVELOPE = {
    "v": (int,),  # SCHEMA_VERSION of the writer
    "t": _NUM,  # host wall-clock (epoch seconds) at write time
    "event": _STR,  # the event kind (a key of EVENTS)
}

EVENTS = {
    "run_start": {"version": _STR, "workload": _STR, "engine": _STR,
                  "device": _STR, "params": (dict,)},
    "run_resume": {"version": _STR, "path": _STR},
    "segment": {"index": _NUM, "t_dispatch": _NUM, "t_fence": _NUM,
                "wall_s": _NUM},
    "level": {"level": _NUM, "generated": _NUM, "distinct": _NUM,
              "queue": _NUM, "bodies": _NUM, "expanded": _NUM},
    "progress": {"depth": _NUM, "generated": _NUM, "distinct": _NUM,
                 "queue": _NUM},
    "checkpoint": {"path": _STR, "seconds": _NUM, "label": _STR},
    "ckpt_write_failed": {"error": _STR},
    "ckpt_fallback": {"path": _STR, "error": _STR},
    "recovery": {"path": _STR, "depth": _NUM, "generated": _NUM,
                 "distinct": _NUM, "queue": _NUM},
    "regrow": {"resource": _STR, "old": _NUM, "new": _NUM,
               "violation": _STR, "seconds": _NUM},
    "retry": {"attempt": _NUM, "delay_s": _NUM, "error": _STR},
    "fault": {"kind": _STR, "at": _NUM},
    "interrupted": {"signum": _OPT_NUM, "path": _OPT_STR,
                    "generated": _NUM, "distinct": _NUM, "queue": _NUM,
                    "wall_s": _NUM},
    "degrade": {"rung": _STR, "resource": _STR, "action": _STR,
                "reason": _STR},
    "spill": {"phase": _STR, "resident": _NUM, "spilled": _NUM,
              "capacity": _NUM, "hits": _NUM, "probes": _NUM},
    "exhausted": {"resource": _STR, "path": _OPT_STR,
                  "generated": _NUM, "distinct": _NUM, "queue": _NUM,
                  "wall_s": _NUM},
    "violation": {"code": _NUM, "name": _STR},
    "final": {"verdict": _STR, "generated": _NUM, "distinct": _NUM,
              "depth": _NUM, "queue": _NUM, "wall_s": _NUM,
              "interrupted": _BOOL},
    "coverage": {"visited": _NUM, "sites": _NUM, "delta": (dict,)},
    "phase": {"scope": _STR, "index": _NUM, "phase": _STR,
              "wall_s": _NUM},
    "analysis": {"layer": _STR, "check": _STR, "severity": _STR,
                 "subject": _STR, "detail": _STR},
    "analysis_summary": {"name": _STR, "findings": _NUM,
                         "errors": _NUM, "warnings": _NUM,
                         "wall_s": _NUM},
    "cache": {"tier": _STR, "outcome": _STR, "key": _STR},
    "sim": {"phase": _STR, "walkers": _NUM, "depth": _NUM,
            "steps": _NUM, "transitions": _NUM},
    "infer": {"phase": _STR, "candidates": _NUM, "killed": _NUM,
              "survivors": _NUM, "certified": _NUM},
    "reduce": {"states_pruned": _NUM, "ample_hit_rate": _NUM,
               "orbit_factor": _NUM, "generated": _NUM,
               "distinct": _NUM},
    "pod": {"phase": _STR, "host": _NUM, "hosts": _NUM},
    "sched": {"action": _STR, "job": _STR},
    "trace_export": {"path": _STR, "events": _NUM},
    "bench_metric": {"metric": _STR, "value": _NUM, "unit": _STR,
                     "vs_baseline": _NUM},
}

VERDICTS = ("ok", "violation", "liveness_violation", "interrupted",
            "exhausted", "error", "expired", "canceled", "quarantined")


class JournalSchemaError(ValueError):
    """A journal event does not satisfy the versioned schema."""


def validate_event(ev: dict) -> dict:
    """Validate one journal event dict; returns it unchanged on success.

    Checks the envelope (v/t/event), that the kind is known, and that
    every required field of the kind is present with an accepted type.
    Extra fields pass - views ignore what they don't know."""
    if not isinstance(ev, dict):
        raise JournalSchemaError(f"event is not an object: {ev!r}")
    for field, types in ENVELOPE.items():
        if field not in ev:
            raise JournalSchemaError(f"event missing envelope {field!r}: {ev!r}")
        if not isinstance(ev[field], types) or isinstance(ev[field], bool):
            raise JournalSchemaError(
                f"envelope {field!r} has type {type(ev[field]).__name__}, "
                f"want one of {[t.__name__ for t in types]}: {ev!r}"
            )
    if ev["v"] > SCHEMA_VERSION:
        raise JournalSchemaError(
            f"journal schema v{ev['v']} is newer than this reader "
            f"(v{SCHEMA_VERSION})"
        )
    kind = ev["event"]
    spec = EVENTS.get(kind)
    if spec is None:
        raise JournalSchemaError(f"unknown event kind {kind!r}: {ev!r}")
    for field, types in spec.items():
        if field not in ev:
            raise JournalSchemaError(
                f"{kind!r} event missing required field {field!r}: {ev!r}"
            )
        v = ev[field]
        if isinstance(v, bool) and bool not in types:
            raise JournalSchemaError(
                f"{kind!r} field {field!r} is bool, want "
                f"{[t.__name__ for t in types]}: {ev!r}"
            )
        if not isinstance(v, types):
            raise JournalSchemaError(
                f"{kind!r} field {field!r} has type {type(v).__name__}, "
                f"want one of {[t.__name__ for t in types]}: {ev!r}"
            )
    if kind == "final" and ev["verdict"] not in VERDICTS:
        raise JournalSchemaError(
            f"final verdict {ev['verdict']!r} not in {VERDICTS}"
        )
    return ev
