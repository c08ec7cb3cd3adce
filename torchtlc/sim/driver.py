"""Supervised simulation runs: the (seed, step) cursor as a run unit (port
of jaxtlc/sim/driver.py).

The walk carry's ``step_i`` is the resume cursor: every lane is a pure
function of ``(seed, lane)``, so a carry at step k plus the run seed
determines the rest of the run.  This driver applies the resil conventions
to it: segments of ``ckpt_every`` transition rounds (K27 / K28 pairs
launched back to back, then one synchronize; nothing is built ahead of
time), a SIGTERM/SIGINT drain that writes a final generation and reports
``interrupted`` (the CLI's exit-75 / -recover contract), CRC-manifested
generation-numbered checkpoints through engine.checkpoint (the carry's
leaves in the reference's order, so a checkpoint of either package
resumes in the other), and deterministic fault injection (resil.faults
``sigterm@K`` fires at segment K).  Nothing in a walk grows (the sampling
filter saturates instead of halting), so there is no degradation ladder:
the only recoveries a smoke run needs are preemption and resume.
"""

from __future__ import annotations

import json
import time
from typing import NamedTuple, Optional

import torch

from ..engine.checkpoint import load_latest_generation, save_generation
from ..resil.faults import FaultInjector, FaultPlan
from ..resil.supervisor import _SignalCatcher
from .engine import (
    SimResult,
    get_sim_engine,
    result_from_sim_carry,
    sim_done,
    u32_get,
)

SIM_FORMAT = 1


class SimSupervised(NamedTuple):
    result: SimResult
    interrupted: bool
    segments: int
    ckpt_writes: int


def sim_meta(model, seed: int, walkers: int, depth: int,
             fp_capacity: int, check_deadlock: bool) -> dict:
    """The checkpoint meta stanza: spec meaning + the full walk identity,
    seed included - a -recover against a different seed (or walk
    geometry) is a different trajectory and must mismatch loudly."""
    from ..struct.backend import struct_meta_config

    return json.loads(json.dumps({
        "format": SIM_FORMAT,
        "kind": "sim",
        "config": struct_meta_config(model),
        "seed": int(seed),
        "walkers": int(walkers),
        "depth": int(depth),
        "fp_capacity": int(fp_capacity),
        "check_deadlock": bool(check_deadlock),
    }))


def _emit(on_event, kind: str, **info):
    if on_event is not None:
        on_event(kind, info)


def _distinct(carry) -> int:
    return int(carry.distinct) if carry.distinct is not None else 0


def _progress_info(carry, walkers: int, depth: int, seed: int) -> dict:
    return dict(
        phase="progress", walkers=int(walkers), depth=int(depth),
        steps=int(carry.step_i),
        transitions=int(u32_get(carry.transitions)), seed=int(seed),
        distinct_est=_distinct(carry),
    )


def _sync(carry) -> None:
    if carry.states.is_cuda:
        torch.cuda.synchronize(carry.states.device)


def run_sim(model, seed: int = 0, walkers: int = 256, depth: int = 100,
            fp_capacity: int = 0, check_deadlock: bool = True,
            device=None) -> SimResult:
    """One unsupervised walk run on `device` (None: the card), timed from
    the first round to the synchronize after the last (execution only:
    the spec's library is built by init)."""
    backend, init_fn, run_fn, _ = get_sim_engine(
        model, walkers, depth, fp_capacity=fp_capacity,
        check_deadlock=check_deadlock, device=device,
    )
    carry = init_fn(seed)
    _sync(carry)
    t0 = time.time()
    out = run_fn(carry)
    _sync(out)
    wall = time.time() - t0
    return result_from_sim_carry(out, wall, backend, walkers, depth,
                                 seed)


def run_sim_supervised(
    model,
    seed: int = 0,
    walkers: int = 256,
    depth: int = 100,
    fp_capacity: int = 0,
    check_deadlock: bool = True,
    ckpt_path: Optional[str] = None,
    ckpt_every: int = 64,
    resume: bool = False,
    faults: Optional[FaultPlan] = None,
    on_event=None,
    drain=None,
    device=None,
) -> SimSupervised:
    """Segmented walk run with preemption safety and cursor resume.

    `on_event(kind, info)` receives schema-shaped journal events: ``sim``
    progress rows at every segment fence, ``checkpoint`` / ``recovery`` /
    ``interrupted`` with the resil meanings.  A resumed run continues from
    the checkpointed (seed, step) cursor and its final carry is the
    uninterrupted run's."""
    backend, init_fn, run_fn, _ = get_sim_engine(
        model, walkers, depth, fp_capacity=fp_capacity,
        check_deadlock=check_deadlock, device=device,
    )
    meta = sim_meta(model, seed, walkers, depth, fp_capacity,
                    check_deadlock)
    carry = init_fn(seed)
    if resume:
        if not ckpt_path:
            raise FileNotFoundError("-recover needs a sim -checkpoint")
        path, saved_meta, carry = load_latest_generation(ckpt_path, carry)
        for key, want in meta.items():
            got = saved_meta.get(key)
            if got != want:
                raise ValueError(
                    f"sim checkpoint {key} mismatch: {got!r} != "
                    f"{want!r} (a walk is a pure function of its seed "
                    "and geometry - resumes cannot cross them)"
                )
        _emit(on_event, "recovery", path=path,
              depth=int(carry.step_i),
              generated=int(u32_get(carry.generated)),
              distinct=_distinct(carry), queue=0)

    injector = FaultInjector(faults)
    t0 = time.time()
    segments = 0
    ckpt_writes = 0
    interrupted = False
    # the programmatic drain twin of _SignalCatcher: a scheduler preempts
    # one sim job without signaling the process
    drained = (lambda: drain is not None and drain.is_set())
    with _SignalCatcher() as sig:
        while not sim_done(carry, depth):
            injector.segment_start(segments)
            if sig.hit is not None or drained():
                interrupted = True
                break
            carry = run_fn(carry, ckpt_every)
            _sync(carry)
            segments += 1
            _emit(on_event, "sim",
                  **_progress_info(carry, walkers, depth, seed))
            if ckpt_path and not sim_done(carry, depth):
                tck = time.time()
                path = save_generation(ckpt_path, carry, meta)
                ckpt_writes += 1
                _emit(on_event, "checkpoint", path=path,
                      seconds=round(time.time() - tck, 6), label="sim")
            if sig.hit is not None or drained():
                interrupted = True
                break
        if (sig.hit is not None or drained()) \
                and not sim_done(carry, depth):
            interrupted = True
    wall = time.time() - t0
    if interrupted:
        path = None
        if ckpt_path:
            path = save_generation(ckpt_path, carry, meta)
            ckpt_writes += 1
        _emit(on_event, "interrupted", signum=int(sig.hit or 0),
              path=path, generated=int(u32_get(carry.generated)),
              distinct=_distinct(carry), queue=0, wall_s=round(wall, 6))
    result = result_from_sim_carry(carry, wall, backend, walkers,
                                   depth, seed)
    return SimSupervised(result=result, interrupted=interrupted,
                         segments=segments, ckpt_writes=ckpt_writes)
