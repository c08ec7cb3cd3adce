"""Deterministic fault injection for the run supervisor (a copy of
jaxtlc/resil/faults.py, which imports no jax; the port keeps its own).

Every recovery path the supervisor claims (auto-regrow, retry-with-
backoff, SIGTERM drain, generation fallback after a torn checkpoint) is
proven by an INJECTED fault whose recovered run must match the clean
run's final statistics exactly (tests/test_torch_resil.py).
A FaultPlan is a fixed schedule - "fail the 2nd disk write", "raise a
transient error when segment 3 starts", "deliver SIGTERM at segment 2",
"truncate the checkpoint written at segment 1" - threaded through the
supervisor's hooks, so a chaos run is reproducible bit-for-bit.

The plan DSL (the CLI's `-faults`):

    write_fail@N    raise OSError on the Nth checkpoint write (1-based)
    truncate@N      after the Nth checkpoint write succeeds, truncate the
                    published file mid-byte (simulates the torn write the
                    fsync+generation scheme defends against)
    transient@K     raise TransientFault when segment K starts (0-based;
                    the supervisor's retry/backoff path must absorb it)
    sigterm@K       deliver a real SIGTERM to this process when segment K
                    starts (the preemption drain path)
    alloc_fail@N    deny the Nth regrow allocation probe (1-based) with
                    an injected RESOURCE_EXHAUSTED - the degradation
                    ladder must route fpset growth to the host spill
                    tier instead of crashing mid-migration
    spill_fail@N    raise OSError on the Nth host spill write (the
                    device-table flush into the SpillStore, 1-based);
                    the ladder must degrade to checkpoint + exit 75
    runner_die@N    raise TransientFault when the serve scheduler's Nth
                    dispatch starts (1-based) - the scheduler's retry
                    classification must absorb it
    slow_dispatch@N sleep before the serve scheduler's Nth dispatch
                    (1-based) - the deterministic window the deadline
                    reaper / admission tests need

Entries are comma-separated: "transient@1,sigterm@3".  Each entry fires
at most once.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, FrozenSet, Optional


class TransientFault(RuntimeError):
    """An injected stand-in for a transient device error (the class of
    failure the supervisor's retry-with-backoff absorbs)."""


class AllocDeniedFault(MemoryError):
    """An injected stand-in for a deterministic device-allocation failure
    (the class retry can NEVER fix - the supervisor's degradation ladder
    must absorb it instead).  The message carries the reference's
    RESOURCE_EXHAUSTED status string."""

    def __init__(self, detail: str):
        super().__init__(f"RESOURCE_EXHAUSTED: {detail} (injected)")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault schedule.  All members are sets of 1-based
    write ordinals / 0-based segment ordinals; empty = no fault."""

    write_fail: FrozenSet[int] = frozenset()
    truncate: FrozenSet[int] = frozenset()
    transient: FrozenSet[int] = frozenset()
    sigterm: FrozenSet[int] = frozenset()
    alloc_fail: FrozenSet[int] = frozenset()
    spill_fail: FrozenSet[int] = frozenset()
    runner_die: FrozenSet[int] = frozenset()
    slow_dispatch: FrozenSet[int] = frozenset()

    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        """Parse the chaos DSL ("write_fail@2,transient@1,sigterm@3")."""
        kinds = {"write_fail": set(), "truncate": set(),
                 "transient": set(), "sigterm": set(),
                 "alloc_fail": set(), "spill_fail": set(),
                 "runner_die": set(), "slow_dispatch": set()}
        for entry in filter(None, (e.strip() for e in spec.split(","))):
            try:
                kind, at = entry.split("@")
                kinds[kind].add(int(at))
            except (ValueError, KeyError):
                raise ValueError(
                    f"bad fault entry {entry!r} (want kind@N with kind in "
                    f"{sorted(kinds)})"
                )
        return FaultPlan(**{k: frozenset(v) for k, v in kinds.items()})


class FaultInjector:
    """Runtime state of one plan: counts writes/segments, fires each
    scheduled fault exactly once.  A None plan injects nothing (the
    production configuration - the hooks cost a comparison each)."""

    # how long a slow_dispatch@N fault stalls the scheduler (seconds);
    # an attribute so chaos harnesses can tighten/loosen the window
    slow_dispatch_s = 0.25

    def __init__(self, plan: Optional[FaultPlan] = None,
                 kill: Callable[[], None] = None):
        self.plan = plan or FaultPlan()
        self.writes = 0
        self.alloc_probes = 0
        self.spill_writes = 0
        self.fired = set()
        # test seam: default delivers a real SIGTERM to this process
        self._kill = kill or (
            lambda: os.kill(os.getpid(), signal.SIGTERM)
        )

    def _once(self, key) -> bool:
        if key in self.fired:
            return False
        self.fired.add(key)
        return True

    def segment_start(self, k: int) -> None:
        """Hook: the supervisor is about to run segment k (0-based)."""
        if k in self.plan.sigterm and self._once(("sigterm", k)):
            self._kill()
        if k in self.plan.transient and self._once(("transient", k)):
            raise TransientFault(f"injected transient fault at segment {k}")

    def dispatch(self, n: int) -> None:
        """Hook: the serve scheduler is about to run its nth dispatch
        (1-based).  `slow_dispatch` stalls the worker (opening the
        deterministic window the deadline/admission chaos scenarios
        need); `runner_die` kills the dispatch with a TransientFault
        the scheduler's retry classification must absorb."""
        if n in self.plan.slow_dispatch and self._once(
            ("slow_dispatch", n)
        ):
            time.sleep(self.slow_dispatch_s)
        if n in self.plan.runner_die and self._once(("runner_die", n)):
            raise TransientFault(
                f"injected runner death at dispatch {n}"
            )

    def before_write(self) -> None:
        """Hook: a checkpoint write is about to happen (counts 1-based)."""
        self.writes += 1
        if self.writes in self.plan.write_fail and self._once(
            ("write_fail", self.writes)
        ):
            raise OSError(f"injected disk-write failure #{self.writes}")

    def alloc_probe(self) -> None:
        """Hook: the supervisor is about to probe-allocate a regrown
        resource (counts 1-based).  An injected denial is a MemoryError,
        which the supervisor classifies as exhaustion, as it does a
        torch.cuda.OutOfMemoryError."""
        self.alloc_probes += 1
        if self.alloc_probes in self.plan.alloc_fail and self._once(
            ("alloc_fail", self.alloc_probes)
        ):
            raise AllocDeniedFault(
                f"regrow allocation probe #{self.alloc_probes} denied"
            )

    def spill_write(self) -> None:
        """Hook: a device-table flush into the host spill store is
        about to happen (counts 1-based)."""
        self.spill_writes += 1
        if self.spill_writes in self.plan.spill_fail and self._once(
            ("spill_fail", self.spill_writes)
        ):
            raise OSError(
                f"injected spill-write failure #{self.spill_writes}"
            )

    def after_write(self, path: str) -> None:
        """Hook: checkpoint write #self.writes published `path`."""
        if self.writes in self.plan.truncate and self._once(
            ("truncate", self.writes)
        ):
            truncate_file(path)


def truncate_file(path: str, frac: float = 0.5) -> None:
    """Tear a published file: keep the leading `frac` of its bytes.  The
    generation fallback must then recover from the predecessor."""
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        f.truncate(max(1, int(size * frac)))
