"""The `check` command's orchestration (port of the KubeAPI branch of
jaxtlc/api.py: _run_check, _dispatch_check).

``_run_check(args) -> exit code`` takes the CLI's parsed flags, resolves
the model (MC.cfg, MC.tla, .launch), writes the TLC transcript to stdout,
runs the exhaustive check - under the run supervisor (segments,
checkpoints, -recover, auto-regrow, the host spill tier) whenever
-auto-grow (the default) or -checkpoint is in play, the plain engine
otherwise - and on a violation re-runs the search in the host driver to
print the counterexample; with -coverage, the engine carries the device
coverage plane and the success transcript the host coverage walker's
per-expression dump (MC.out:44-1092); with -pipeline, the engines run the
pipelined body; with -sharded N, the sharded engine over N fingerprint-
space shards in one process (capacities per shard).  Exit codes are the reference's: 0
no error, 12
safety violation, 75 interrupted or capacity-exhausted with a final
checkpoint, 1 usage or configuration error.

The run goes to the card unless ``workers`` is "cpu".  The reference's
preflight analysis (its jaxpr audits) is not part of the port.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

from . import __version__
from .engine.fingerprint import DEFAULT_SEED
from .frontend.model import KNOWN_PROPERTIES, RunSpec, resolve
from .io.tlc_log import TLCLog


def _device(args):
    """The run's device: the card unless -workers cpu (no silent CPU
    run: without a card the engines raise)."""
    return "cpu" if args.workers == "cpu" else None


def _device_name(device) -> str:
    import torch

    from .engine.bfs import resolve_device

    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _run_check(args) -> int:
    try:
        spec: RunSpec = resolve(args.config, workers=args.workers,
                                fp_index=args.fp,
                                check_deadlock=not args.nodeadlock)
    except (ValueError, OSError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    unknown = [q for q in spec.properties if q not in KNOWN_PROPERTIES]
    if unknown:
        print(f"Error: unknown PROPERTY {', '.join(unknown)} "
              f"(supported: {', '.join(KNOWN_PROPERTIES)})", file=sys.stderr)
        return 1
    if spec.properties:
        print(f"Error: PROPERTY {', '.join(spec.properties)}: liveness "
              "checking is not ported yet (ROADMAP Queue A item 13)",
              file=sys.stderr)
        return 1
    if args.mutation:
        spec.model = dataclasses.replace(spec.model, mutation=args.mutation)
    if args.recover and not args.checkpoint:
        print("Error: -recover requires -checkpoint PATH", file=sys.stderr)
        return 1
    if args.sharded and (args.sharded & (args.sharded - 1) or
                         args.sharded > 8):
        print(f"Error: -sharded {args.sharded}: the shard count must be a "
              "power of two, at most 8", file=sys.stderr)
        return 1
    device = _device(args)
    try:
        device_name = _device_name(device)
    except RuntimeError as e:  # no card and no -workers cpu
        print(f"Error: {e}", file=sys.stderr)
        return 1

    log = TLCLog(tool_mode=not args.noTool,
                 **_render_sources(args.config, spec.spec_name))
    log.version(__version__)
    log.banner(spec.fp_index, DEFAULT_SEED, spec.workers, device_name)
    log.sany(*_sany_inputs(args.config, spec.spec_name))
    log.starting()
    log.computing_init()
    _open_journal(args, workload=spec.spec_name, device=device_name,
                  params=dict(chunk=args.chunk, queue_capacity=args.qcap,
                              fp_capacity=args.fpcap, sharded=args.sharded,
                              pipeline=args.pipeline,
                              sort_free=_sort_free(args),
                              deferred=_deferred(args),
                              obs_slots=_obs_slots(args)))
    t0 = time.time()
    from .resil.supervisor import EXIT_INTERRUPTED, SlotOverflowError

    try:
        r, sup = _dispatch_check(args, spec, log, device)
    except SlotOverflowError as e:
        log.msg(1000, f"Run stopped: {e}", severity=1)
        _finish_journal(args)
        return 1
    except FileNotFoundError as e:
        print(f"Error: {e}", file=sys.stderr)
        _finish_journal(args)
        return 1
    log.init_done(2 ** spec.model.n_reconcilers)

    if sup is not None and sup.interrupted:
        # the supervisor's hook already printed the interrupt banner
        log.progress(r.depth, r.generated, r.distinct, r.queue_left)
        log.final_counts(r.generated, r.distinct, r.queue_left)
        _finish_journal(args, r=None, sup=sup)
        return EXIT_INTERRUPTED

    from .engine.bfs import (
        VIOL_ASSERT,
        VIOL_DEADLOCK,
        VIOL_ONLYONEVERSION,
        VIOL_TYPEOK,
    )

    violated = r.violation != 0
    if violated:
        if r.violation == VIOL_TYPEOK and "TypeOK" in spec.invariants:
            log.invariant_violated("TypeOK")
        elif r.violation == VIOL_ONLYONEVERSION and (
                "OnlyOneVersion" in spec.invariants):
            log.invariant_violated("OnlyOneVersion")
        elif r.violation == VIOL_ASSERT:
            log.assertion_failed("Failure of PlusCal assertion.")
        elif r.violation == VIOL_DEADLOCK and spec.check_deadlock:
            log.deadlock()
        else:
            log.msg(1000, f"Run stopped: {r.violation_name}", severity=1)
        _print_trace(log, spec.model, args.chunk,
                     check_deadlock=spec.check_deadlock, device=device)
    else:
        log.success(r.generated, r.distinct, r.actual_fp_collision,
                    occupancy=r.fp_occupancy)
        if args.coverage:
            # the full per-expression dump (MC.out:44-1092): the host
            # walker re-walks the space with the instrumented evaluator
            from .spec.coverage import render_coverage, run_coverage

            cov = run_coverage(spec.model)
            stamp = time.strftime("%Y-%m-%d %H:%M:%S")
            for line in render_coverage(cov, stamp, tool_mode=log.tool):
                log.raw(line)
        else:
            log.coverage(2, r.action_generated, r.action_distinct)
    log.progress(r.depth, r.generated, r.distinct, r.queue_left)
    log.final_counts(r.generated, r.distinct, r.queue_left)
    log.depth(r.depth)
    if r.outdegree is not None:
        log.outdegree(*r.outdegree)
    log.finished(int((time.time() - t0) * 1000))
    _finish_journal(args, r=r, sup=sup, wall_s=time.time() - t0)
    return 12 if violated else 0


def _dispatch_check(args, spec, log, device):
    """The KubeAPI engine the flags pick: the supervised segmented engine
    when -auto-grow (default) or -checkpoint is in play, else the plain
    engine; the sharded ones with -sharded N.  Returns (CheckResult,
    SupervisedResult or None)."""
    if args.sharded:
        return _dispatch_sharded(args, spec, log, device)
    if args.checkpoint or args.autogrow:
        from .resil.supervisor import check_supervised

        sup = check_supervised(
            spec.model, chunk=args.chunk, queue_capacity=args.qcap,
            fp_capacity=args.fpcap, obs_slots=_obs_slots(args),
            sort_free=args.sortfree, deferred=args.deferredinv,
            opts=_sup_opts(args, log), device=device,
            fp_index=spec.fp_index, coverage=args.coverage,
            pipeline=args.pipeline)
        return sup.result, sup
    from .engine.bfs import check

    return check(spec.model, chunk=args.chunk, queue_capacity=args.qcap,
                 fp_capacity=args.fpcap, pipeline=args.pipeline,
                 obs_slots=_obs_slots(args),
                 coverage=args.coverage, sort_free=args.sortfree,
                 deferred=args.deferredinv, device=device,
                 fp_index=spec.fp_index), None


def _dispatch_sharded(args, spec, log, device):
    """-sharded N (jaxtlc/api.py:456-497): supervised when -checkpoint or
    auto-grow is in play, the raw sharded engine otherwise."""
    kw = dict(chunk=args.chunk, queue_capacity=args.qcap,
              fp_capacity=args.fpcap, route_factor=args.routefactor,
              pipeline=args.pipeline, obs_slots=_obs_slots(args),
              sort_free=args.sortfree, deferred=args.deferredinv,
              fp_index=spec.fp_index)
    if args.checkpoint or args.autogrow:
        from .resil.supervisor import check_sharded_supervised

        sup = check_sharded_supervised(
            spec.model, args.sharded, coverage=args.coverage,
            opts=_sup_opts(args, log), device=device, **kw)
        return sup.result, sup
    from .engine.backend import kubeapi_backend
    from .engine.sharded import ShardMesh, check_sharded

    return check_sharded(
        spec.model, ShardMesh(args.sharded, device),
        backend=kubeapi_backend(spec.model, coverage=args.coverage),
        **kw), None


def _sup_opts(args, log):
    """SupervisorOptions from the request: every supervisor event goes to
    the journal first, then its TLC banner is rendered from it."""
    from .obs.schema import SCHEMA_VERSION
    from .obs.views import render_tlc_event
    from .resil.faults import FaultPlan
    from .resil.supervisor import SupervisorOptions

    journal = getattr(args, "_journal", None)
    resume_cmd = _resume_command(args)

    def on_event(kind, info):
        if journal is not None:
            ev = journal.event(kind, **info)
        else:
            ev = {"v": SCHEMA_VERSION, "t": time.time(), "event": kind,
                  **info}
        render_tlc_event(log, ev, resume_cmd=resume_cmd)

    return SupervisorOptions(
        auto_grow=args.autogrow, max_regrow=args.maxregrow,
        retries=args.retry, ckpt_path=args.checkpoint or None,
        ckpt_every=args.checkpointevery, resume=args.recover,
        spill=args.spill,
        faults=FaultPlan.parse(args.faults) if args.faults else None,
        on_event=on_event)


def _obs_slots(args) -> int:
    """Counter-ring depth in effect (-no-obs: none)."""
    return args.obsslots if args.obs else 0


def _sort_free(args) -> bool:
    from .engine.bfs import resolve_sort_free

    return resolve_sort_free(args.sortfree, args.chunk)


def _deferred(args) -> bool:
    from .engine.bfs import resolve_deferred

    return resolve_deferred(args.deferredinv, args.chunk)


def _open_journal(args, workload: str, device: str, params: dict):
    """The run journal: -journal PATH, else PATH.journal.jsonl beside a
    -checkpoint, else in memory.  A -recover run appends to it."""
    from .obs.journal import RunJournal

    path = args.journal or (
        args.checkpoint + ".journal.jsonl" if args.checkpoint else "")
    resume = bool(args.recover and path and os.path.exists(path))
    j = RunJournal(path or None, resume=resume)
    if resume:
        j.event("run_resume", version=__version__, path=path)
    else:
        j.event("run_start", version=__version__, workload=workload,
                engine="sharded" if params.get("sharded") else "single",
                device=device, params=params)
    args._journal = j
    return j


def _finish_journal(args, r=None, sup=None, wall_s: float = 0.0) -> None:
    """The violation record and, when the supervisor did not write one,
    the final event; then close the journal."""
    j = getattr(args, "_journal", None)
    if j is None:
        return
    try:
        if r is not None and r.violation != 0:
            j.event("violation", code=int(r.violation),
                    name=r.violation_name)
        if sup is None and r is not None:
            j.event("final",
                    verdict="violation" if r.violation != 0 else "ok",
                    generated=r.generated, distinct=r.distinct,
                    depth=r.depth, queue=r.queue_left,
                    wall_s=round(wall_s, 6), interrupted=False)
    finally:
        j.close()
        args._journal = None


def _resume_command(args) -> str:
    """The command an interrupted run prints (the geometry travels in the
    checkpoint meta; only the run-shaping flags repeat)."""
    parts = ["python -m torchtlc.cli check", args.config]
    if args.checkpoint:
        parts += ["-checkpoint", args.checkpoint, "-recover"]
    if args.chunk != 1024:
        parts += ["-chunk", str(args.chunk)]
    if args.sharded:
        parts += ["-sharded", str(args.sharded)]
    if args.pipeline:
        parts += ["-pipeline"]  # checkpoints only resume in the same mode
    if args.sortfree is not None:
        parts += ["-sort-free" if args.sortfree else "-no-sort-free"]
    if args.deferredinv is not None:
        parts += ["-deferred-inv" if args.deferredinv
                  else "-no-deferred-inv"]
    if args.coverage:
        parts += ["-coverage"]  # the covered carry is a different layout
    if args.workers == "cpu":
        parts += ["-workers", "cpu"]
    if not args.checkpoint:
        return ("re-run from scratch (no -checkpoint was set): "
                + " ".join(parts))
    return " ".join(parts)


def _render_sources(cfg_path: str, spec_name: str) -> dict:
    """The action-line table scanned from the spec's translation and the
    Toolbox .pmap, when the model directory has them."""
    out = {}
    model_dir = os.path.dirname(os.path.abspath(cfg_path))
    tla = os.path.join(model_dir, f"{spec_name}.tla")
    if os.path.exists(tla):
        from .io.tlc_log import action_lines_from_spec

        out["action_lines"] = action_lines_from_spec(tla)
    pmap_path = os.path.join(os.path.dirname(model_dir),
                             f"{spec_name}.tla.pmap")
    if os.path.exists(pmap_path):
        from .frontend.pmap import PmapError, parse_pmap_file

        try:
            out["pcal_map"] = parse_pmap_file(pmap_path)
        except PmapError:
            pass  # a corrupt pmap must not break the run
    return out


def _sany_inputs(cfg_path: str, spec_name: str):
    """Files read and modules resolved, for the SANY log section."""
    model_dir = os.path.dirname(os.path.abspath(cfg_path))
    files, modules = [], []
    mc = os.path.join(model_dir, "MC.tla")
    if os.path.exists(mc):
        files.append(mc)
    sp = os.path.join(model_dir, f"{spec_name}.tla")
    if os.path.exists(sp):
        files.append(sp)
        modules.append(spec_name)
    if os.path.exists(mc):
        modules.append("MC")
    return files, modules


def _print_trace(log: TLCLog, model, chunk: int, check_deadlock: bool = True,
                 device=None) -> None:
    """The trace-explorer re-run: the host driver finds the violation
    again and the trace prints with the PlusCal action labels."""
    from .engine.trace import find_violation_trace
    from .spec.pretty import state_to_tla

    found = find_violation_trace(model, chunk=chunk,
                                 check_deadlock=check_deadlock, device=device)
    if found is None:
        log.msg(1000, "Violation was not reproducible in host mode",
                severity=1)
        return
    for i, (st, act) in enumerate(found[1], start=1):
        log.trace_state(i, act, state_to_tla(st, model))
