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
space shards in one process (capacities per shard).  After a clean run
with -liveness or a PROPERTY in MC.cfg / the launch file, the temporal
properties are checked (the host graph, or above 1M distinct states the
device capture and fixpoint).  Exit codes are the reference's: 0 no
error, 12 safety violation, 13 temporal property violated, 75
interrupted or capacity-exhausted with a final checkpoint, 1 usage or
configuration error.  With ``-fpset DiskFPSet`` the KubeAPI path runs the
native disk tier instead (engine.hybrid: kernels K1 and K2 on the card,
the fingerprint store and frontier queue on the host, bounded by the
disk; ``-sharded N`` is then N fingerprint partitions).

A spec the structural frontend takes (frontend.model.StructRunSpec) runs
through ``_run_check_struct`` (jaxtlc/api.py:982, 1737): the struct
backend on the same engine and supervisor, plain ``P ~> Q`` PROPERTY
lines on the host graph, a violation's trace from the host oracle.  A
spec of the generic frontend (frontend.model.GenRunSpec) runs through
``_run_check_gen`` (jaxtlc/api.py:851 with the parts of :1737 it uses):
the gen engine (kernel K19), its PROPERTY lines on the host oracle's graph
or, above 1M distinct states, on the device path (kernels K14, K20, K16),
a violation's trace from the host oracle, ``-traceExpressions`` over its
states and ``-coverage`` from the host walker.  ``-traceExpressions``
evaluates its expressions over the trace states on every frontend
(spec.texpr.eval_over_envs over the state environments of spec.texpr,
struct.oracle or gen.oracle).

A struct check consults the artifact cache first (struct.artifacts,
jaxtlc/api.py:1587-1625, :1780-1800, :2033-2049): a verdict hit replays
the stored result before the preflight and any engine build, a
reachable-set hit re-checks the stored states' invariants in one launch
of kernel K31 instead of a BFS, and a clean verdict writes both tiers;
``-artifact-cache DIR``, ``-no-artifact-cache`` and ``-recheck`` steer it,
and the simulation and inference routes journal a ``cache`` bypass.

``-narrow`` narrows a struct spec's codec to the certified reachable
bounds (analysis.absint through struct.cache.get_bounds; only a certified
report narrows): the narrowed backend on every struct route - with the
runtime certificate (kernel K23) on one device, every trap kept on the
sharded engine - the preflight's bound findings, the checkpoint meta's
bound digest, and a tripped certificate's error verdict and exit 1.  The
KubeAPI and generic paths ignore it, as the reference does (its resume
command still repeats it).

``-symmetry`` and ``-por`` (tri-state, auto off) run a struct spec's
reduced backend on every struct route: every successor canonicalized to
its orbit representative (kernel K24) and pruned to singleton ample sets
(K26), the runtime orbit certificate (K25) on one device, the journal's
``reduce`` event, the checkpoint meta's symmetry / por keys, and a
tripped orbit certificate's error verdict and exit 1; the preflight drops
its unreduced-symmetry nudge under -symmetry.  The KubeAPI and generic
paths ignore both, as the reference does (the journal's params and the
resume command still carry them).

``-simulate`` on a struct spec runs ``_run_sim_struct`` (jaxtlc/api.py:
1187-1420) instead of the exhaustive check: random walks through the
struct backend's kernels K27 and K28 (torchtlc.sim), a violating lane
replayed from its seed into the exit-12 trace, lassos on the walks for
plain ``P ~> Q`` properties (exit 13), checkpoints, SIGTERM and
``-recover`` (exit 75); on any other spec it exits 1, as the reference's
does.  ``-infer`` on a struct spec runs ``_run_infer_struct`` (jaxtlc/api.py:
1428-1584): invariant inference through torchtlc.infer (kernels K29 and
K30), the certified transcript, exit 12 when exact evidence refutes a
cfg-named invariant; with -simulate or on any other spec it exits 1, as
the reference's does.

Before the check each path runs the reference's preflight in its lite
mode (torchtlc.analysis: the struct spec lints, the unreduced-symmetry
nudge, the counter-width arithmetic); its findings print as TLC warning
lines and journal as ``analysis`` events, and an error-severity finding
aborts the run (``-no-preflight`` skips it).  With ``-sharded N`` a struct
spec runs on the sharded engine (supervised unless ``-no-auto-grow``); a
generic spec runs there whenever ``-sharded`` or ``-checkpoint`` is given,
over one shard without ``-sharded`` (jaxtlc/api.py:868-915), pipelined
with ``-pipeline``.

The run goes to the card unless ``workers`` is "cpu".
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional, TextIO

from . import __version__
from .engine.fingerprint import DEFAULT_SEED
from .frontend.model import KNOWN_PROPERTIES, RunSpec, resolve
from .io.tlc_log import TLCLog


@dataclasses.dataclass
class CheckRequest:
    """One check, fully specified - the library form of the CLI flag set
    (jaxtlc/api.py:38-155).  Field names match the argparse dests, and
    every default mirrors the flag's (torchtlc/cli.py), so the flags'
    meaning is documented once, in the CLI."""

    config: str
    workers: str = "gpu"
    frontend: str = "auto"
    fpset: str = "JaxFPSet"
    fp: Optional[int] = None
    sharded: int = 0
    chunk: int = 1024
    pipeline: bool = False
    # tri-state modes: None = auto (resolved against the chunk)
    sortfree: Optional[bool] = None
    deferredinv: Optional[bool] = None
    symmetry: Optional[bool] = None
    por: Optional[bool] = None
    routefactor: float = 2.0
    qcap: int = 1 << 15
    fpcap: int = 1 << 20
    checkpoint: str = ""
    checkpointevery: int = 256
    recover: bool = False
    autogrow: bool = True
    spill: str = "auto"
    maxregrow: int = 8
    retry: int = 2
    faults: str = ""
    obs: bool = True
    obsslots: int = 256
    journal: str = ""
    serve: int = 0
    phasetiming: bool = False
    traceout: str = ""
    xprof: str = ""
    analyze: bool = False
    preflight: bool = True
    narrow: bool = False
    coverage: bool = False
    liveness: bool = False
    liveness_host: bool = False
    fairness: str = "wf_next"
    nodeadlock: bool = False
    noTool: bool = False
    traceExpressions: str = ""
    mutation: str = ""
    compilecache: str = ""
    artifactcache: str = ""
    noartifactcache: bool = False
    recheck: bool = False
    simulate: bool = False
    depth: int = 100
    walkers: int = 256
    simseed: int = 0
    infer: bool = False
    inferbudget: int = 64
    # -- library-only knobs (no CLI flag) -------------------------------
    # MC.cfg-style constant overrides on top of the config's values (the
    # serve path: a job's constants shape the checked configuration on
    # every route, the supervised one included)
    constants: dict = dataclasses.field(default_factory=dict)
    # programmatic drain request: a threading.Event the caller sets to
    # preempt THIS run at the next segment boundary - the in-process twin
    # of SIGTERM, riding the same checkpoint + exit-75 path
    # (resil.supervisor, sim.driver).  The serve scheduler's deadline,
    # priority and cancel preemptions go through it
    drain: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)
    # transcript / error sinks; None = the process stdout / stderr (the
    # CLI path)
    out: Optional[TextIO] = dataclasses.field(
        default=None, repr=False, compare=False)
    err: Optional[TextIO] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def from_args(cls, args) -> "CheckRequest":
        """A request from an argparse namespace (unknown request fields
        keep their defaults, extra namespace attributes are ignored)."""
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in ("out", "err"):
                continue
            if hasattr(args, f.name):
                kw[f.name] = getattr(args, f.name)
        return cls(**kw)


VERDICT_BY_EXIT = {
    0: "ok",
    1: "error",
    12: "violation",
    13: "liveness_violation",
    75: "interrupted",
}


@dataclasses.dataclass
class CheckOutcome:
    """What a check did: the exit code, its verdict word, the engine-level
    result (None when resolution or the preflight failed before any
    engine ran) and where the run journal landed."""

    exit_code: int
    verdict: str
    result: object = None  # CheckResult, SimResult or InferReport
    journal_path: str = ""


def run_check(req: CheckRequest) -> CheckOutcome:
    """Run one check end to end - everything the CLI's `check` does
    (resolution, preflight, dispatch, liveness, traces, journal) - against
    the request's sinks instead of the process streams."""
    rc = _run_check(req)
    return CheckOutcome(
        exit_code=rc,
        verdict=VERDICT_BY_EXIT.get(rc, f"exit_{rc}"),
        result=getattr(req, "_result", None),
        journal_path=getattr(req, "_journal_path", "") or "",
    )


def _err(args) -> TextIO:
    return getattr(args, "err", None) or sys.stderr


def _out(args) -> TextIO:
    return getattr(args, "out", None) or sys.stdout


def _tlc_log(args, **kw) -> TLCLog:
    """The run's transcript writer, on the request's sink."""
    args._log = TLCLog(out=_out(args), tool_mode=not args.noTool, **kw)
    return args._log


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
    from .frontend.model import GenRunSpec, StructRunSpec

    try:
        spec: RunSpec = resolve(
            args.config, workers=args.workers, fp_index=args.fp,
            check_deadlock=not args.nodeadlock,
            const_overrides=getattr(args, "constants", None) or None,
            frontend=args.frontend)
    except (ValueError, OSError) as e:
        print(f"Error: {e}", file=_err(args))
        return 1
    if args.simulate and not isinstance(spec, StructRunSpec):
        # the simulation tier rides the struct frontend (jaxtlc/api.py:
        # 219-226); -frontend struct runs any spec
        print("Error: -simulate requires the structural frontend "
              "(re-run with -frontend struct)", file=_err(args))
        return 1
    if args.infer:
        # jaxtlc/api.py:227-237: inference conjectures over the struct
        # IR's shapes; like -simulate this is a spelling, not a
        # capability, gap
        if args.simulate:
            print("Error: -infer and -simulate are distinct job "
                  "classes (pick one)", file=_err(args))
            return 1
        if not isinstance(spec, StructRunSpec):
            print("Error: -infer requires the structural frontend "
                  "(re-run with -frontend struct)", file=_err(args))
            return 1
    if isinstance(spec, GenRunSpec):
        return _run_check_gen(args, spec)
    if isinstance(spec, StructRunSpec):
        return _run_check_struct(args, spec)
    unknown = [q for q in spec.properties if q not in KNOWN_PROPERTIES]
    if unknown:
        print(f"Error: unknown PROPERTY {', '.join(unknown)} "
              f"(supported: {', '.join(KNOWN_PROPERTIES)})", file=_err(args))
        return 1
    if args.mutation:
        spec.model = dataclasses.replace(spec.model, mutation=args.mutation)
    if args.recover and not args.checkpoint:
        print("Error: -recover requires -checkpoint PATH", file=_err(args))
        return 1
    # under -fpset DiskFPSet, -sharded N counts host partitions (any power
    # of two, checked by the dispatch as the reference checks it)
    disk = args.fpset == "DiskFPSet"
    if not disk and not _check_shard_count(args):
        return 1
    device = _device(args)
    try:
        device_name = _device_name(device)
    except RuntimeError as e:  # no card and no -workers cpu
        print(f"Error: {e}", file=_err(args))
        return 1

    log = _tlc_log(args, **_render_sources(args.config,
                                          spec.spec_name))
    log.version(__version__)
    log.banner(spec.fp_index, DEFAULT_SEED, spec.workers, device_name)
    log.sany(*_sany_inputs(args.config, spec.spec_name))
    log.starting()
    log.computing_init()
    _open_journal(args, workload=spec.spec_name, device=device_name,
                  engine="hybrid" if disk else None,
                  params=dict(chunk=args.chunk, queue_capacity=args.qcap,
                              fp_capacity=args.fpcap, sharded=args.sharded,
                              pipeline=args.pipeline,
                              sort_free=_sort_free(args),
                              deferred=_deferred(args),
                              obs_slots=_obs_slots(args)))

    def kubeapi_preflight():
        from .analysis.preflight import preflight_kubeapi

        return preflight_kubeapi(spec.model, fp_capacity=args.fpcap,
                                 chunk=args.chunk, queue_capacity=args.qcap)

    rc = _preflight_gate(args, log, kubeapi_preflight)
    if rc is not None:
        return rc
    t0 = time.time()
    from .resil.supervisor import EXIT_INTERRUPTED, SlotOverflowError

    try:
        r, sup = _dispatch_check(args, spec, log, device)
        args._result = r
    except SlotOverflowError as e:
        log.msg(1000, f"Run stopped: {e}", severity=1)
        _finish_journal(args)
        return 1
    except FileNotFoundError as e:
        print(f"Error: {e}", file=_err(args))
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
    liveness_violated = False
    if not violated and (args.liveness or spec.properties):
        liveness_violated = _check_liveness(args, spec, r, log, device)
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
                     trace_expr_file=args.traceExpressions,
                     check_deadlock=spec.check_deadlock, device=device)
    elif not liveness_violated:
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
    _finish_journal(args, r=r, sup=sup, wall_s=time.time() - t0,
                    verdict="liveness_violation" if liveness_violated
                    else None)
    if violated:
        return 12
    return 13 if liveness_violated else 0  # TLC's liveness exit code


def _check_liveness(args, spec, r, log, device) -> bool:
    """The temporal properties after a clean run (jaxtlc/api.py:329-382):
    the MC.cfg / launch PROPERTY list, or both KubeAPI properties with
    -liveness; the device path (live.check) above HOST_PATH_MAX distinct
    states under wf_next, the host graph (engine.liveness) otherwise.
    Prints a verdict a property, with the lasso of a violated one; returns
    whether one was violated."""
    from .live.check import check_properties_device, use_device_path
    from .spec.codec import get_codec
    from .spec.pretty import state_to_tla

    props = spec.properties or ["ReconcileCompletes", "CleansUpProperly"]
    device_path = use_device_path(r.distinct, args.fairness,
                                  args.liveness_host)
    log.checking_temporal(r.distinct, "device" if device_path else "host")
    if device_path:
        mesh = None
        if args.sharded:
            from .engine.sharded import ShardMesh

            mesh = ShardMesh(args.sharded, device)
        results = check_properties_device(
            spec.model, props, chunk=args.chunk, state_capacity=args.fpcap,
            fp_capacity=args.fpcap, mesh=mesh,
            spill_path=args.checkpoint or None, device=device)
    else:
        from .engine.liveness import build_graph, check_properties

        graph = build_graph(spec.model, chunk=args.chunk, device=device)
        results = check_properties(spec.model, props, graph=graph,
                                   fairness=args.fairness)
    decode = get_codec(spec.model).decode
    violated = False
    for res in results:
        if res.holds:
            log.msg(1000, f"Temporal property {res.name} holds "
                          f"(fairness: {args.fairness}).")
            continue
        violated = True
        log.msg(2116, f"Temporal properties were violated: {res.name} "
                      f"(fairness: {args.fairness})", severity=1)
        idx = 1
        for enc, act in zip(res.prefix, res.prefix_actions):
            log.trace_state(idx, act, state_to_tla(decode(enc), spec.model))
            idx += 1
        log.msg(1000, "-- The following states form a cycle "
                      "(back to the first of them) --")
        for enc, act in zip(res.cycle, res.cycle_actions):
            log.trace_state(idx, act, state_to_tla(decode(enc), spec.model))
            idx += 1
    return violated


def _dispatch_check(args, spec, log, device):
    """The KubeAPI engine the flags pick (jaxtlc/api.py:446-539): the
    native disk tier with -fpset DiskFPSet (engine.hybrid; -sharded N is
    then N fingerprint partitions, -checkpoint / -recover its snapshots);
    the supervised segmented engine when -auto-grow (default) or
    -checkpoint is in play, else the plain engine; the sharded ones with
    -sharded N.  Returns (CheckResult, SupervisedResult or None)."""
    if args.fpset == "DiskFPSet":
        from .engine.hybrid import check_hybrid

        nparts = max(args.sharded, 1)
        if nparts & (nparts - 1):
            raise FileNotFoundError(
                "-sharded with -fpset DiskFPSet needs a power-of-two "
                f"partition count, got {nparts}")
        return check_hybrid(
            spec.model, chunk=args.chunk, fp_index=spec.fp_index,
            fp_partitions=nparts, ckpt_path=args.checkpoint or None,
            ckpt_every=args.checkpointevery, resume=args.recover,
            device=device), None
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


def _preflight_gate(args, log, build_report):
    """The preflight before a check (jaxtlc/api.py:553-597): -no-preflight
    skips it; the findings journal as `analysis` events and print as TLC
    warning lines (derived views of the same events); a clean preflight is
    silent.  Returns the nonzero exit code on error-severity findings
    (after the `final` event), None to proceed.  A lint that raises never
    blocks a run."""
    if not args.preflight:
        return None
    from .analysis.report import emit_to_journal
    from .obs.schema import SCHEMA_VERSION
    from .obs.views import render_tlc_event

    try:
        report = build_report()
    except Exception as e:  # a broken lint must never block a run
        log.msg(1000, f"Preflight analysis skipped: {e}", severity=1)
        return None
    journal = getattr(args, "_journal", None)

    def on_event(kind, info):
        render_tlc_event(log, {"v": SCHEMA_VERSION, "t": time.time(),
                               "event": kind, **info})

    emit_to_journal(journal, report, on_event=on_event)
    if report.errors:
        if journal is not None:
            journal.event("final", verdict="error", generated=0,
                          distinct=0, depth=0, queue=0, wall_s=0.0,
                          interrupted=False)
        log.msg(1000, "Preflight analysis found error-severity findings; "
                      "run aborted (-no-preflight to override).",
                severity=1)
        _finish_journal(args)
        return report.exit_code
    return None


def _check_shard_count(args) -> bool:
    """Whether -sharded N is usable (0, or a power of two up to 8);
    prints the error when it is not."""
    if args.sharded and (args.sharded & (args.sharded - 1) or
                         args.sharded > 8):
        print(f"Error: -sharded {args.sharded}: the shard count must be a "
              "power of two, at most 8", file=_err(args))
        return False
    return True


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
        spill=args.spill, phase_timing=args.phasetiming,
        faults=FaultPlan.parse(args.faults) if args.faults else None,
        drain=getattr(args, "drain", None), on_event=on_event)


def _obs_slots(args) -> int:
    """Counter-ring depth in effect (-no-obs: none)."""
    return args.obsslots if args.obs else 0


def _sort_free(args) -> bool:
    from .engine.bfs import resolve_sort_free

    return resolve_sort_free(args.sortfree, args.chunk)


def _symmetry(args) -> bool:
    """The resolved -symmetry mode (journal params record the fact)."""
    from .engine.bfs import resolve_symmetry

    return resolve_symmetry(args.symmetry, args.chunk)


def _por(args) -> bool:
    """The resolved -por mode."""
    from .engine.bfs import resolve_por

    return resolve_por(args.por, args.chunk)


def _deferred(args) -> bool:
    from .engine.bfs import resolve_deferred

    return resolve_deferred(args.deferredinv, args.chunk)


def _open_journal(args, workload: str, device: str, params: dict,
                  engine: str = None):
    """The run journal: -journal PATH, else PATH.journal.jsonl beside a
    -checkpoint, else in memory.  A -recover run appends to it.  `engine`
    names the run_start's engine (default: sharded or single, from the
    params)."""
    from .obs.journal import RunJournal

    path = args.journal or (
        args.checkpoint + ".journal.jsonl" if args.checkpoint else "")
    if not path and args.serve:
        # the monitor serves journal FILES: an unjournaled -serve run gets
        # one in the temporary directory (jaxtlc/api.py:692-700)
        import tempfile

        path = os.path.join(tempfile.gettempdir(),
                            f"torchtlc-{os.getpid()}.journal.jsonl")
    resume = bool(args.recover and path and os.path.exists(path))
    j = RunJournal(path or None, resume=resume)
    if resume:
        j.event("run_resume", version=__version__, path=path)
    else:
        j.event("run_start", version=__version__, workload=workload,
                engine=engine or ("sharded" if params.get("sharded")
                                  else "single"),
                device=device, params=params)
    args._journal = j
    args._journal_path = path or ""
    if args.serve:
        # the live monitor - /metrics, /events (SSE), /runs - over the
        # run's journal directory for the run's whole lifetime
        from .obs.serve import start_server

        args._server = start_server(
            os.path.dirname(os.path.abspath(path)) or ".", port=args.serve)
        print(f"torchtlc monitor at {args._server.url} "
              "(/runs /metrics /events /journal)", file=_err(args))
    return j


def _finish_journal(args, r=None, sup=None, wall_s: float = 0.0,
                    verdict: str = None) -> None:
    """The violation record (a safety violation's, or exit 13's for a
    violated temporal property: verdict "liveness_violation") and, when
    the supervisor did not write one, the final event; then close the
    journal."""
    j = getattr(args, "_journal", None)
    if j is None:
        return
    try:
        if r is not None and r.violation != 0:
            j.event("violation", code=int(r.violation),
                    name=r.violation_name)
        if verdict == "liveness_violation":
            j.event("violation", code=13,
                    name="Temporal properties were violated")
        if sup is None and r is not None:
            j.event("final",
                    verdict=verdict or ("violation" if r.violation != 0
                                        else "ok"),
                    generated=r.generated, distinct=r.distinct,
                    depth=r.depth, queue=r.queue_left,
                    wall_s=round(wall_s, 6), interrupted=False)
        if args.traceout:
            # the Chrome trace of the WHOLE journal file, so a resumed
            # run's trace covers both attempts (jaxtlc/api.py:746-755)
            from .obs.journal import read as read_journal
            from .obs.trace import export_chrome_trace

            events = read_journal(j.path, validate=False) if j.path \
                else j.events
            n = export_chrome_trace(events, args.traceout)
            j.event("trace_export", path=args.traceout, events=n)
            log = getattr(args, "_log", None)
            if log is not None:
                log.msg(1000, f"Timeline trace written to {args.traceout} "
                              f"({n} events; open in ui.perfetto.dev).")
    finally:
        j.close()
        args._journal = None
        server = getattr(args, "_server", None)
        if server is not None:
            server.shutdown()
            args._server = None


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
    if args.narrow:
        parts += ["-narrow"]  # the narrowed codec is a different layout
    # the reduced carries and frontiers differ (checkpoint meta keys)
    if args.symmetry is not None:
        parts += ["-symmetry" if args.symmetry else "-no-symmetry"]
    if args.por is not None:
        parts += ["-por" if args.por else "-no-por"]
    if args.coverage:
        parts += ["-coverage"]  # the covered carry is a different layout
    if args.simulate:
        # a walk is a pure function of (seed, walkers, depth): the resume
        # must repeat all three or the cursor meta mismatches
        parts += ["-simulate", "-depth", str(args.depth),
                  "-walkers", str(args.walkers),
                  "-sim-seed", str(args.simseed)]
    if args.workers == "cpu":
        parts += ["-workers", "cpu"]
    if args.frontend != "auto":
        parts += ["-frontend", args.frontend]
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


def _print_trace(log: TLCLog, model, chunk: int, trace_expr_file: str = "",
                 check_deadlock: bool = True, device=None) -> None:
    """The trace-explorer re-run (jaxtlc/api.py:2060-2090): the host re-run
    (engine.trace) finds the violation again and the trace prints with the PlusCal action
    labels; with `trace_expr_file` each state also shows the user's
    expressions evaluated in it (a missing or bad file skips them, never
    the trace)."""
    from .engine.trace import find_violation_trace
    from .spec.pretty import state_to_tla

    found = find_violation_trace(model, chunk=chunk,
                                 check_deadlock=check_deadlock, device=device)
    if found is None:
        log.msg(1000, "Violation was not reproducible in host mode",
                severity=1)
        return
    trace = found[1]
    expr_rows = None
    if trace_expr_file:
        from .spec.texpr import state_env

        expr_rows = _trace_expr_rows(trace_expr_file, log,
                                     [state_env(st, model) for st, _ in trace])
    for i, (st, act) in enumerate(trace, start=1):
        text = state_to_tla(st, model)
        if expr_rows is not None:
            text += _expr_conjuncts(expr_rows[i - 1])
        log.trace_state(i, act, text)


def _expr_conjuncts(rows) -> str:
    """One trace state's -traceExpressions values as extra conjuncts."""
    from .spec.pretty import value_to_tla

    return "".join(
        f"\n/\\ {res.name} = "
        + (f"<evaluation failed: {res.value}>" if res.failed
           else value_to_tla(res.value))
        for res in rows)


def _trace_expr_rows(path: str, log, envs):
    """The values of the -traceExpressions file `path` over a trace's state
    environments (spec.texpr.eval_over_envs), or None without a file or
    when it is missing or bad (then a "Trace expressions skipped" line)."""
    if not path:
        return None
    from .spec.texpr import TexprError, eval_over_envs, parse_expressions

    try:
        with open(path) as f:
            exprs = parse_expressions(f.read())
        return eval_over_envs(exprs, envs)
    except (OSError, TexprError) as e:
        log.msg(1000, f"Trace expressions skipped: {e}", severity=1)
        return None


def _run_check_struct(args, spec) -> int:
    """Check a structural-frontend spec (jaxtlc/api.py:982
    _run_check_struct with _run_check_interp, :1737): the preflight, the
    struct backend (kernels K17, K18) on the engine - supervised when
    -auto-grow (the default) or -checkpoint is in play - or with -sharded
    N on the sharded engine (kernels K21, K18), the host graph for plain
    ``P ~> Q`` PROPERTY lines, and the host oracle's re-run for a
    violation's trace; with -coverage the device coverage plane (kernel
    K22) on every route, its end-of-run dump and the dead-site lint; with
    -narrow the narrowed backend (a certified bound report only: with the
    runtime certificate, kernel K23, on one device, every trap kept on the
    sharded routes), the certificate's error verdict, and
    -traceExpressions over the violation trace.  Same transcript and exit
    codes."""
    from .struct import oracle as so
    from .struct.backend import struct_meta_config
    from .struct.cache import get_backend

    sm = spec.structmodel
    system = sm.system
    if args.recover and not args.checkpoint:
        print("Error: -recover requires -checkpoint PATH", file=_err(args))
        return 1
    if args.simulate:
        return _run_sim_struct(args, spec)
    if args.infer:
        return _run_infer_struct(args, spec)
    unsupported = [flag for flag, on in (
        ("-fpset DiskFPSet", args.fpset != "JaxFPSet"),
        ("-mutation", args.mutation),
        ("-fairness wf_process", args.fairness == "wf_process"),
    ) if on]
    if unsupported:
        print(f"Error: {', '.join(unsupported)} not supported for "
              "structural-frontend specs yet", file=_err(args))
        return 1
    if not _check_shard_count(args):
        return 1
    device = _device(args)
    try:
        device_name = _device_name(device)
    except RuntimeError as e:  # no card and no -workers cpu
        print(f"Error: {e}", file=_err(args))
        return 1
    # -narrow: the certified-bound narrowed codec (jaxtlc/api.py:1011-1021);
    # only a certified report narrows, an uncertified one keeps the
    # baseline layout (the preflight says so)
    report = bounds = None
    if args.narrow:
        from .struct.cache import get_bounds

        report = get_bounds(sm)
        bounds = report if report.certified else None
    log = _tlc_log(args)
    log.version(__version__)
    log.banner(spec.fp_index, DEFAULT_SEED, spec.workers, device_name)
    log.sany(*_sany_inputs(args.config, spec.spec_name))
    log.starting()
    log.computing_init()
    _open_journal(args, workload=spec.spec_name, device=device_name,
                  params=dict(chunk=args.chunk, queue_capacity=args.qcap,
                              fp_capacity=args.fpcap, sharded=args.sharded,
                              pipeline=args.pipeline, frontend="structural",
                              sort_free=_sort_free(args),
                              deferred=_deferred(args),
                              symmetry=_symmetry(args), por=_por(args),
                              obs_slots=_obs_slots(args)))

    def struct_preflight():
        from .analysis.preflight import preflight_struct

        return preflight_struct(
            sm, fp_capacity=args.fpcap, chunk=args.chunk,
            queue_capacity=args.qcap, check_deadlock=spec.check_deadlock,
            bounds=report, narrow=args.narrow, symmetry=_symmetry(args))

    # the artifact cache (jaxtlc/api.py:1783-1800): both tiers are tried
    # BEFORE the preflight and any engine build; a verdict hit replays the
    # cached result (and attests the temporal properties), a reach hit
    # swaps the BFS for the invariant re-check (kernel K31)
    plan = _artifact_plan(args, spec, sm, bounds, device)
    fast = (plan.fast_check(getattr(args, "_journal", None), log)
            if plan is not None else None)
    cache_tier = fast[0] if fast is not None else None
    if cache_tier != "verdict":
        rc = _preflight_gate(args, log, struct_preflight)
        if rc is not None:
            return rc
    # the sharded routes narrow the codec with every trap kept and carry
    # no certificate (jaxtlc/api.py:1040-1093)
    sym, por = _symmetry(args), _por(args)
    backend = get_backend(sm, spec.check_deadlock, bounds=bounds,
                          elide=not args.sharded, coverage=args.coverage,
                          symmetry=sym, por=por)
    meta_config = struct_meta_config(sm, bounds=bounds)
    # per-action lines in module-definition (MC.out) order, zero-fire
    # actions printed 0:0 as TLC does
    names = set(backend.labels)
    order = [n for n in sm.module.def_order if n in names]
    order += [n for n in sorted(names) if n not in order]
    capture = plan is not None and not args.sharded
    t0 = time.time()
    from .resil.supervisor import EXIT_INTERRUPTED, SlotOverflowError

    kw = dict(chunk=args.chunk, queue_capacity=args.qcap,
              fp_capacity=args.fpcap, obs_slots=_obs_slots(args),
              sort_free=args.sortfree, deferred=args.deferredinv)
    try:
        if fast is not None:
            r, sup = fast[1]()
        elif args.sharded and (args.checkpoint or args.autogrow):
            from .resil.supervisor import check_sharded_supervised

            sup = check_sharded_supervised(
                None, args.sharded, backend=backend,
                meta_config=meta_config,
                route_factor=args.routefactor, pipeline=args.pipeline,
                opts=_sup_opts(args, log), device=device, **kw)
            r = sup.result
        elif args.sharded:
            from .engine.sharded import ShardMesh
            from .struct.engine import check_struct_sharded

            r, sup = check_struct_sharded(
                sm, ShardMesh(args.sharded, device),
                route_factor=args.routefactor,
                check_deadlock=spec.check_deadlock, pipeline=args.pipeline,
                coverage=args.coverage, bounds=bounds, symmetry=sym,
                por=por, **kw), None
        elif args.checkpoint or args.autogrow:
            from .resil.supervisor import check_supervised

            opts = _sup_opts(args, log)
            opts.capture_fps = capture
            sup = check_supervised(
                None, opts=opts, device=device,
                fp_index=spec.fp_index, backend=backend,
                meta_config=meta_config, pipeline=args.pipeline, **kw)
            r = sup.result
        else:
            from .struct.engine import check_struct

            r, sup = check_struct(
                sm, fp_index=spec.fp_index,
                check_deadlock=spec.check_deadlock, device=device,
                coverage=args.coverage, pipeline=args.pipeline,
                bounds=bounds, symmetry=sym, por=por, capture_fps=capture,
                **kw), None
    except SlotOverflowError as e:
        log.msg(1000, f"Run stopped: {e}", severity=1)
        _finish_journal(args)
        return 1
    except FileNotFoundError as e:
        print(f"Error: {e}", file=_err(args))
        _finish_journal(args)
        return 1
    args._result = r
    n_init = fast[2] if fast is not None else len(system.initial_states())
    log.init_done(n_init)
    if sup is not None and sup.interrupted:
        log.progress(r.depth, r.generated, r.distinct, r.queue_left)
        log.final_counts(r.generated, r.distinct, r.queue_left)
        _finish_journal(args, r=None, sup=sup)
        return EXIT_INTERRUPTED
    if sym or por:
        _reduce_event(args, backend.reduce, r, sym, por)
    if r.sym_violated:
        return _sym_violated(args, log, spec, r, t0)
    if r.cert_violated:
        return _cert_violated(args, log, spec, r, t0)
    violated = r.violation != 0
    liveness_violated = False
    if not violated and spec.properties:
        log.checking_temporal(r.distinct, "host")
        for name in spec.properties:
            ast = sm.properties[name]
            if ast[0] != "leadsto" or ast[1][0] == "box":
                log.msg(1000, f"Temporal property {name} skipped: only "
                              "plain P ~> Q is checked on the structural "
                              "path.", severity=1)
                continue
            if cache_tier == "verdict":
                # the cached clean verdict attests every selected property
                from .struct.artifacts import _PropertyHolds

                res = _PropertyHolds()
            else:
                res = so.check_leads_to(system, ast[1], ast[2], name)
            if res.holds:
                log.msg(1000, f"Temporal property {name} holds "
                              "(fairness: wf_next).")
                continue
            liveness_violated = True
            log.msg(2116, f"Temporal properties were violated: {name}",
                    severity=1)
            idx = 1
            for st in list(res.lasso_prefix) + [None] + list(
                    res.lasso_cycle):
                if st is None:
                    log.msg(1000, "-- The following states form a cycle "
                                  "(back to the first of them) --")
                    continue
                log.trace_state(idx, None, so.state_to_tla(system, st))
                idx += 1
    if violated:
        log.msg(2110 if r.violation >= 100 else 1000, r.violation_name,
                severity=1)
        found = so.violation_trace(system, sm.invariants,
                                   check_deadlock=spec.check_deadlock)
        if found is None:
            log.msg(1000, "Violation was not reproducible in host mode",
                    severity=1)
        else:
            expr_rows = _trace_expr_rows(
                args.traceExpressions, log,
                [so.state_env(system, st) for st, _ in found[1]])
            for i, (st, act) in enumerate(found[1], start=1):
                head = (f"State {i}: <Initial predicate>" if act is None
                        else f"State {i}: <{act}>")
                text = so.state_to_tla(system, st)
                if expr_rows is not None:
                    text += _expr_conjuncts(expr_rows[i - 1])
                log.msg(2217, head + "\n" + text, severity=1)
    elif not liveness_violated:
        log.success(r.generated, r.distinct, r.actual_fp_collision,
                    occupancy=r.fp_occupancy)
        if args.coverage and r.site_coverage is not None:
            _struct_coverage_dump(args, log, spec, sm, backend, r, n_init,
                                  order)
        else:
            log.coverage_generic(
                spec.spec_name, n_init,
                {a: r.action_generated.get(a, 0) for a in order},
                {a: r.action_distinct.get(a, 0) for a in order})
    log.progress(r.depth, r.generated, r.distinct, r.queue_left)
    log.final_counts(r.generated, r.distinct, r.queue_left)
    log.depth(r.depth)
    log.finished(int((time.time() - t0) * 1000))
    if (plan is not None and not violated and not liveness_violated
            and (sup is None or not (sup.interrupted or sup.exhausted))):
        # the clean-final-verdict write point (jaxtlc/api.py:2033-2049);
        # record() re-checks the violation and the certificate itself
        try:
            plan.record(r, n_init=n_init,
                        journal=getattr(args, "_journal", None),
                        action_order=order)
        except OSError as e:  # a full disk must not fail the verdict
            log.msg(1000, f"Warning: artifact cache write failed: {e}",
                    severity=1)
    _finish_journal(args, r=r, sup=sup, wall_s=time.time() - t0,
                    verdict="liveness_violation" if liveness_violated
                    else None)
    if violated:
        return 12
    return 13 if liveness_violated else 0


def _artifact_plan(args, spec, sm, bounds, device):
    """The artifact cache's plan for a struct run (jaxtlc/api.py:1587-1625),
    or None when the run is ineligible: resume/fault/mutation runs exist
    to exercise the engines, coverage/phase-timing runs produce
    run-shaped artifacts a cached verdict cannot, a reduced run's table
    is the reduced set, and -no-artifact-cache (or
    TORCHTLC_ARTIFACT_CACHE=off) disables the store outright.  A re-check
    runs on `device`."""
    if (args.recover or args.faults or args.mutation or args.coverage
            or args.phasetiming or args.simulate or args.infer):
        return None
    if _symmetry(args) or _por(args):
        return None
    from .struct import artifacts as _arts

    store = _arts.store_for(args)
    if store is None:
        return None
    return _arts.ArtifactPlan(
        store, sm, check_deadlock=spec.check_deadlock,
        properties=tuple(spec.properties), fp_capacity=args.fpcap,
        bounds=bounds, fp_index=spec.fp_index,
        bypass_read=bool(args.recheck), device=device)


def _cache_bypass(args, j, reason: str) -> None:
    """The `cache` bypass event of a run that never publishes a verdict
    (simulation, inference), when a store is configured."""
    from .struct import artifacts as _arts

    if _arts.store_for(args) is not None and j is not None:
        j.event("cache", tier="verdict", outcome="bypass", key="",
                reason=reason)


def _run_sim_struct(args, spec) -> int:
    """The simulation tier (jaxtlc/api.py:1187-1420 _run_sim_struct): W
    random walks of depth N through the struct backend's walk kernels
    (K27, K28), supervised (segments, checkpoints, SIGTERM, -recover),
    with seed-exact host replay of a violation's lane into the exit-12
    trace and plain ``P ~> Q`` PROPERTY lines checked for lassos on the
    sampled walks.  The same banner, journal, preflight and trace plumbing
    as the exhaustive struct path; the success message says smoke, not
    "model checking completed"."""
    from .resil.faults import FaultPlan
    from .resil.supervisor import EXIT_INTERRUPTED
    from .sim.driver import run_sim_supervised
    from .sim.liveness import expressible as _live_expressible
    from .sim.replay import replay_lane, walk_trace
    from .struct import oracle as so
    from .struct.cache import get_backend

    sm = spec.structmodel
    unsupported = [
        flag for flag, on in (
            ("-sharded", args.sharded),
            ("-pipeline", args.pipeline),
            ("-liveness", args.liveness),
            ("-coverage", args.coverage),
            ("-narrow", args.narrow),
            ("-phase-timing", args.phasetiming),
            ("-mutation", args.mutation),
            ("-symmetry", args.symmetry),
            ("-por", args.por),
            ("-fpset DiskFPSet", args.fpset != "JaxFPSet"),
        ) if on
    ]
    if unsupported:
        print(f"Error: {', '.join(unsupported)} not supported with "
              "-simulate (walks carry no frontier/liveness machinery)",
              file=_err(args))
        return 1
    device = _device(args)
    try:
        device_name = _device_name(device)
    except RuntimeError as e:  # no card and no -workers cpu
        print(f"Error: {e}", file=_err(args))
        return 1
    log = _tlc_log(args)
    log.version(__version__)
    log.banner(spec.fp_index, DEFAULT_SEED, spec.workers, device_name)
    log.sany(*_sany_inputs(args.config, spec.spec_name))
    log.starting()
    log.computing_init()
    _open_journal(
        args, workload=spec.spec_name, engine="sim", device=device_name,
        params=dict(walkers=args.walkers, depth=args.depth,
                    sim_seed=args.simseed, fp_capacity=args.fpcap,
                    frontend="struct"))
    j = getattr(args, "_journal", None)
    # jaxtlc/api.py:1243-1250: a poisoned verdict tier would answer later
    # exhaustive queries with an incomplete-search verdict
    _cache_bypass(args, j, "simulation verdicts are from incomplete "
                           "search and never publish")

    def struct_preflight():
        from .analysis.preflight import preflight_struct

        return preflight_struct(
            sm, fp_capacity=args.fpcap, chunk=args.chunk,
            queue_capacity=args.qcap, check_deadlock=spec.check_deadlock,
            symmetry=_symmetry(args))

    rc = _preflight_gate(args, log, struct_preflight)
    if rc is not None:
        return rc
    log.msg(1000, f"Running random simulation: {args.walkers} walks "
                  f"to depth {args.depth} (seed {args.simseed}).")
    live_props = []
    for name in spec.properties:
        # plain P ~> Q is checked on the sampled behaviors after the walk;
        # shapes the trace checker cannot express keep the skip notice
        skip = _live_expressible(sm.properties[name])
        if skip is not None:
            log.msg(1000, f"Temporal property {name} skipped: {skip}.",
                    severity=1)
        else:
            live_props.append(name)
    t0 = time.time()
    resume_cmd = _resume_command(args)

    def on_event(kind, info):
        from .obs.schema import SCHEMA_VERSION
        from .obs.views import render_tlc_event

        if j is not None:
            ev = j.event(kind, **info)
        else:
            ev = {"v": SCHEMA_VERSION, "t": time.time(), "event": kind,
                  **info}
        render_tlc_event(log, ev, resume_cmd=resume_cmd)

    try:
        sup = run_sim_supervised(
            sm, seed=args.simseed, walkers=args.walkers, depth=args.depth,
            fp_capacity=args.fpcap, check_deadlock=spec.check_deadlock,
            ckpt_path=args.checkpoint or None,
            ckpt_every=args.checkpointevery, resume=args.recover,
            faults=FaultPlan.parse(args.faults) if args.faults else None,
            on_event=on_event, device=device,
            drain=getattr(args, "drain", None))
    except (FileNotFoundError, ValueError) as e:
        print(f"Error: {e}", file=_err(args))
        _finish_journal(args)
        return 1
    r = args._result = sup.result
    log.init_done(len(sm.system.initial_states()))
    if j is not None:
        j.event("sim", phase="summary", walkers=r.walkers, depth=r.depth,
                steps=r.steps, transitions=r.transitions, seed=r.seed,
                distinct_est=r.distinct, fp_saturated=r.fp_saturated,
                halted=r.halted,
                depth_hist=[list(p) for p in r.depth_hist],
                violation=r.violation)
    if sup.interrupted:
        if j is not None:
            j.event("final", verdict="interrupted", generated=r.generated,
                    distinct=r.distinct, depth=r.steps, queue=0,
                    wall_s=round(time.time() - t0, 6), interrupted=True)
        _finish_journal(args)
        return EXIT_INTERRUPTED
    violated = r.violation != 0
    if violated:
        log.msg(2110 if r.violation >= 100 else 1000, r.violation_name,
                severity=1)
        # seed-exact replay: the lane's walk is the counterexample,
        # re-derived from (seed, lane) alone on the run's device (K17 and
        # K18 on one row, not the walk's K27)
        backend = get_backend(sm, spec.check_deadlock)
        walk = replay_lane(backend, r.seed, r.violation_lane,
                           max(r.violation_step, 0),
                           check_deadlock=spec.check_deadlock,
                           device=device)
        if j is not None:
            j.event("sim", phase="replay", walkers=r.walkers,
                    depth=r.depth, steps=len(walk.fields) - 1,
                    transitions=len(walk.fields) - 1,
                    lane=r.violation_lane, seed=r.seed,
                    violation=walk.violation)
        if walk.violation != r.violation:
            log.msg(1000, "Violation was not reproducible in host "
                          "replay", severity=1)
        else:
            for i, (st, act) in enumerate(walk_trace(walk, backend.cdc),
                                          start=1):
                head = (f"State {i}: <Initial predicate>" if act is None
                        else f"State {i}: <{act}>")
                log.msg(2217, head + "\n" + so.state_to_tla(sm.system, st),
                        severity=1)
    else:
        sat = " (sampling filter saturated: estimate is a floor)" \
            if r.fp_saturated else ""
        log.msg(1000, f"Simulation complete: {r.walkers} walks, "
                      f"{r.transitions} transitions taken to depth "
                      f"{r.steps}, ~{r.distinct} distinct states "
                      f"sampled{sat}.")
        log.msg(1000, "No violation found in the sampled behaviors "
                      "(simulation is NOT exhaustive - this is a "
                      "smoke verdict).")
    liveness_violated = False
    if not violated and live_props:
        # lassos on the walks, re-derived from the seed (a lane is a pure
        # function of (seed, lane), as the safety trace's replay)
        from .sim.liveness import check_walk_leads_to, walk_trajectories

        trajs = walk_trajectories(sm, args.walkers, args.depth,
                                  args.simseed,
                                  check_deadlock=spec.check_deadlock,
                                  device=device)
        for name in live_props:
            ast = sm.properties[name]
            res = check_walk_leads_to(sm, ast[1], ast[2], name, trajs)
            if j is not None:
                j.event("sim", phase="liveness", walkers=args.walkers,
                        depth=args.depth, steps=r.steps,
                        transitions=r.transitions, property=name,
                        lassos=res.lassos, holds=res.holds)
            if res.holds:
                log.msg(1000, f"Temporal property {name}: no violating "
                              f"lasso in the sampled behaviors "
                              f"({res.lassos} lasso(s) examined; sampling "
                              f"is NOT exhaustive).")
                continue
            liveness_violated = True
            log.msg(2116, f"Temporal properties were violated: {name}",
                    severity=1)
            idx = 1
            for st in res.prefix:
                log.trace_state(idx, None, so.state_to_tla(sm.system, st))
                idx += 1
            log.msg(1000, "-- The following states form a cycle "
                          "(back to the first of them) --")
            for st in res.cycle:
                log.trace_state(idx, None, so.state_to_tla(sm.system, st))
                idx += 1
    log.progress(r.steps, r.generated, r.distinct, 0)
    log.final_counts(r.generated, r.distinct, 0)
    log.finished(int((time.time() - t0) * 1000))
    if j is not None:
        if violated:
            j.event("violation", code=int(r.violation),
                    name=r.violation_name)
        elif liveness_violated:
            j.event("violation", code=13,
                    name="Temporal properties were violated")
        j.event("final",
                verdict=("violation" if violated else
                         "liveness_violation" if liveness_violated
                         else "ok"),
                generated=r.generated, distinct=r.distinct, depth=r.steps,
                queue=0, wall_s=round(time.time() - t0, 6),
                interrupted=False)
    _finish_journal(args)
    if violated:
        return 12
    return 13 if liveness_violated else 0


def _run_infer_struct(args, spec) -> int:
    """The inference job class (jaxtlc/api.py:1428-1584
    _run_infer_struct): conjecture candidate invariants over the struct
    IR, kill the ones reachable evidence refutes (kernel K29), certify
    the survivors inductive (kernel K30) - the same banner/journal/
    preflight plumbing as a check, but the product is a transcript of
    CERTIFIED candidate invariants (and an honest "consistent with
    evidence only" list), not a pass/fail verdict about the spec.  The
    run exits 12 only when EXACT evidence kills a cfg-named invariant - a
    real reachable violation."""
    from .infer.driver import run_infer

    sm = spec.structmodel
    unsupported = [
        flag for flag, on in (
            ("-sharded", args.sharded),
            ("-pipeline", args.pipeline),
            ("-liveness", args.liveness),
            ("-coverage", args.coverage),
            ("-narrow", args.narrow),
            ("-phase-timing", args.phasetiming),
            ("-mutation", args.mutation),
            ("-checkpoint", args.checkpoint),
            ("-recover", args.recover),
            ("-faults", args.faults),
            ("-symmetry", args.symmetry),
            ("-por", args.por),
            ("-fpset DiskFPSet", args.fpset != "JaxFPSet"),
        ) if on
    ]
    if unsupported:
        print(f"Error: {', '.join(unsupported)} not supported with "
              "-infer (inference carries no frontier/checkpoint "
              "machinery)", file=_err(args))
        return 1
    device = _device(args)
    try:
        device_name = _device_name(device)
    except RuntimeError as e:  # no card and no -workers cpu
        print(f"Error: {e}", file=_err(args))
        return 1
    log = _tlc_log(args)
    log.version(__version__)
    log.banner(spec.fp_index, DEFAULT_SEED, spec.workers, device_name)
    log.sany(*_sany_inputs(args.config, spec.spec_name))
    log.starting()
    log.computing_init()
    _open_journal(
        args, workload=spec.spec_name, engine="infer", device=device_name,
        params=dict(budget=args.inferbudget, walkers=args.walkers,
                    depth=args.depth, sim_seed=args.simseed,
                    frontend="struct"))
    j = getattr(args, "_journal", None)
    # jaxtlc/api.py:1484-1490: inference READS the reachable-set tier as
    # filter evidence but its verdict is about candidates, not the stated
    # invariants - it never publishes to the verdict tier
    _cache_bypass(args, j, "inference verdicts are about candidate "
                           "invariants and never publish")

    def struct_preflight():
        from .analysis.preflight import preflight_struct

        return preflight_struct(
            sm, fp_capacity=args.fpcap, chunk=args.chunk,
            queue_capacity=args.qcap, check_deadlock=spec.check_deadlock,
            symmetry=_symmetry(args))

    rc = _preflight_gate(args, log, struct_preflight)
    if rc is not None:
        return rc
    log.msg(1000, f"Running invariant inference: budget "
                  f"{args.inferbudget} candidates "
                  f"(walk geometry {args.walkers}x{args.depth}, "
                  f"seed {args.simseed}).")
    t0 = time.time()
    resume_cmd = _resume_command(args)

    def on_event(kind, info):
        from .obs.schema import SCHEMA_VERSION
        from .obs.views import render_tlc_event

        if j is not None:
            ev = j.event(kind, **info)
        else:
            ev = {"v": SCHEMA_VERSION, "t": time.time(), "event": kind,
                  **info}
        render_tlc_event(log, ev, resume_cmd=resume_cmd)

    running = {"killed": 0}

    def on_round(row):
        running["killed"] += row["killed"]
        on_event("infer", dict(
            phase="round",
            candidates=row["survivors"] + running["killed"],
            killed=running["killed"], survivors=row["survivors"],
            certified=0, round=row["round"],
            evidence=row["evidence"], n_states=row["n_states"],
        ))

    try:
        rep = run_infer(
            sm, budget=args.inferbudget, walkers=args.walkers,
            depth=args.depth, seed=args.simseed,
            check_deadlock=spec.check_deadlock, on_round=on_round,
            device=device)
        args._result = rep
    except (FileNotFoundError, ValueError) as e:
        print(f"Error: {e}", file=_err(args))
        _finish_journal(args)
        return 1
    log.init_done(len(sm.system.initial_states()))
    on_event("infer", dict(
        phase="summary", candidates=rep.candidates, killed=rep.killed,
        survivors=len(rep.survivors), certified=len(rep.certified),
        certified_names=[c.name for c in rep.certified],
        evidence=rep.evidence, n_states=rep.n_states,
        dropped=rep.dropped,
    ))
    violated = bool(rep.cfg_killed)
    if violated:
        for name in rep.cfg_killed:
            log.msg(2110, f"Invariant {name} is violated (refuted by "
                          f"a reachable state in the exact evidence "
                          f"set).", severity=1)
    evid = (f"exact {rep.evidence} evidence ({rep.n_states} states)"
            if rep.exact else
            f"sampled walk evidence ({rep.n_states} states - "
            f"NOT exhaustive)")
    log.msg(1000, f"Inference complete: {rep.candidates} candidates "
                  f"({rep.dropped} beyond budget), {rep.killed} killed "
                  f"by {evid}.")
    for c, basis in zip(rep.certified, rep.cert_basis):
        line = c.name if c.source == "cfg" else f"{c.name} == {c.text}"
        log.msg(1000, f"Certified inductive invariant [{basis}]: "
                      f"{line}")
    uncert = [c for c in rep.survivors if c not in rep.certified]
    for c in uncert:
        line = c.name if c.source == "cfg" else f"{c.name} == {c.text}"
        log.msg(1000, f"Consistent with evidence only (NOT certified): "
                      f"{line}", severity=1)
    for name in rep.uncompiled:
        log.msg(1000, f"Candidate {name} skipped: outside the lane-"
                      f"compilable subset.", severity=1)
    log.progress(0, rep.n_states, rep.n_states, 0)
    log.final_counts(rep.n_states, rep.n_states, 0)
    log.finished(int((time.time() - t0) * 1000))
    if j is not None:
        if violated:
            j.event("violation", code=100,
                    name=f"Invariant {rep.cfg_killed[0]} is violated.")
        j.event("final",
                verdict="violation" if violated else "ok",
                generated=rep.n_states, distinct=rep.n_states,
                depth=0, queue=0,
                wall_s=round(time.time() - t0, 6), interrupted=False)
    _finish_journal(args)
    return 12 if violated else 0


def _reduce_event(args, red, r, sym: bool, por: bool) -> None:
    """The journal's `reduce` event (jaxtlc/api.py:1831-1849 with its
    static half reduce_info, :1135-1155): what the reduction resolved for
    the run and what it bought - states_pruned, the POR count, and
    ample_hit_rate = pruned / (generated + pruned)."""
    j = getattr(args, "_journal", None)
    if j is None or red is None:
        return
    pruned = int(r.por_pruned or 0)
    total = int(r.generated) + pruned
    j.event("reduce", states_pruned=pruned,
            ample_hit_rate=round(pruned / total, 6) if total else 0.0,
            generated=int(r.generated), distinct=int(r.distinct),
            symmetry=sym, por=por, orbit_factor=red.orbit_factor,
            symmetric_sets={k: list(v) for k, v in red.sym_sets},
            dropped_sets=dict(red.dropped_sets),
            safe_actions=len(red.safe_ids))


def _sym_violated(args, log, spec, r, t0: float) -> int:
    """A tripped runtime orbit certificate (jaxtlc/api.py:1851-1869): the
    canonicalization was not constant on some reachable orbit, so the
    reduced dedup may have merged states it had no right to merge - the
    structured record, an error verdict and exit 1."""
    detail = ("runtime orbit-certificate violation: the symmetry "
              "canonicalization is not orbit-invariant on a reachable "
              "state; re-run with -no-symmetry and report the spec (the "
              "symmetry verification is unsound)")
    j = getattr(args, "_journal", None)
    if j is not None:
        j.event("analysis", layer="spec", check="orbit-certificate",
                severity="error", subject=spec.spec_name, detail=detail)
        j.event("final", verdict="error", generated=r.generated,
                distinct=r.distinct, depth=r.depth, queue=r.queue_left,
                wall_s=round(time.time() - t0, 6), interrupted=False)
    log.msg(1000, f"ERROR: {detail}", severity=1)
    _finish_journal(args)
    return 1


def _cert_violated(args, log, spec, r, t0: float) -> int:
    """A tripped runtime certificate (jaxtlc/api.py:1874-1890): a reachable
    state broke a bound the certified abstract interpretation claimed, so
    every count of the narrowed run is untrustworthy - the structured
    record, an error verdict and exit 1 (the ring's banner, when the run
    journals levels, already fired)."""
    detail = ("runtime certificate violation: a reachable state lies "
              "outside the certified bounds the narrowed codec was built "
              "from; re-run with -no-narrow and report the spec (the bound "
              "certification is unsound)")
    j = getattr(args, "_journal", None)
    if j is not None:
        j.event("analysis", layer="spec", check="bound-certificate",
                severity="error", subject=spec.spec_name, detail=detail)
        j.event("final", verdict="error", generated=r.generated,
                distinct=r.distinct, depth=r.depth, queue=r.queue_left,
                wall_s=round(time.time() - t0, 6), interrupted=False)
    log.msg(1000, f"ERROR: {detail}", severity=1)
    _finish_journal(args)
    return 1


def _struct_coverage_dump(args, log, spec, sm, backend, r, n_init: int,
                          order) -> None:
    """The device coverage plane's end-of-run dump (jaxtlc/api.py:1112-1127
    and :1979-2011): MC.out-format lines straight off the carry's counts;
    an unsupervised run journals its cumulative table as one `coverage`
    event; then the dead-site lint's events, journaled and rendered."""
    from .obs.coverage import render_site_dump
    from .obs.views import render_tlc_event

    plane = backend.coverage
    counts = [r.site_coverage.get(s.key, 0) for s in plane.sites]
    log.coverage_site_dump(render_site_dump(
        plane.sites, counts, plane.module or spec.spec_name,
        time.strftime("%Y-%m-%d %H:%M:%S"), init_count=n_init,
        act_gen=r.action_generated, act_dist=r.action_distinct,
        order=order))
    j = getattr(args, "_journal", None)
    if j is not None and not any(e["event"] == "coverage"
                                 for e in j.events):
        j.event("coverage",
                visited=sum(1 for v in r.site_coverage.values() if v),
                sites=len(r.site_coverage),
                delta={k: v for k, v in r.site_coverage.items() if v})
    for info in _struct_dead_sites(sm, plane, counts):
        if j is not None:
            ev = j.event("analysis", **info)
        else:
            from .obs.schema import SCHEMA_VERSION

            ev = {"v": SCHEMA_VERSION, "t": time.time(),
                  "event": "analysis", **info}
        render_tlc_event(log, ev)


def _struct_dead_sites(sm, plane, counts) -> list:
    """The dead-site lint (jaxtlc/api.py:1626-1673): at the final verdict,
    sites with zero visits are cross-checked against speclint's
    unreachable-action findings - a statically-REACHABLE site that never
    fired becomes a warning-severity `analysis` event.  Returns the
    (layer, check, severity, subject, detail) event dicts."""
    from .analysis.speclint import analyze_spec
    from .obs.coverage import zero_sites

    dead = zero_sites(plane.sites, counts)
    if not dead:
        return []
    try:
        static_dead = {
            f.subject for f in analyze_spec(sm).findings
            if f.check == "unreachable-action"
        }
    except Exception:  # a broken lint must never block the verdict
        static_dead = set()
    events = []
    reachable_dead = [s for s in dead if s.action not in static_dead]
    for s in reachable_dead[:20]:
        what = s.loc or s.kind
        events.append(dict(
            layer="spec", check="dead-site", severity="warning",
            subject=s.key,
            detail=(f"site never fired in this run ({s.action}: {what})"
                    " although the action is statically reachable; the"
                    " configuration may be too small to exercise it"),
        ))
    if len(reachable_dead) > 20:
        events.append(dict(
            layer="spec", check="dead-site", severity="warning",
            subject=sm.root_name,
            detail=(f"{len(reachable_dead) - 20} further zero-visit "
                    "sites suppressed (see /coverage for the full "
                    "table)"),
        ))
    return events


def _gen_check(args, spec, device):
    """The safety check of a generic spec (jaxtlc/api.py:868-915): the gen
    engine unless -sharded or -checkpoint is given (-pipeline alone runs
    it too), else the sharded engine over the generic backend - over
    args.sharded shards, or one - with whole-carry checkpoints when
    -checkpoint is given (the checkpoint's `config` stanza names the spec
    and its sorted constants)."""
    from .engine.backend import gen_backend
    from .engine.sharded import (
        ShardMesh,
        check_sharded,
        check_sharded_with_checkpoints,
    )
    from .gen.engine import check_gen

    g = spec.genspec
    if not (args.sharded or args.checkpoint):
        return check_gen(g, chunk=args.chunk, queue_capacity=args.qcap,
                         fp_capacity=args.fpcap, fp_index=spec.fp_index,
                         check_deadlock=spec.check_deadlock, device=device)
    mesh = ShardMesh(args.sharded or 1, device)
    backend = gen_backend(g)
    if mesh.device != "cpu":
        from .kernels import ops

        ops.gen_lib(backend.kernels.prog)  # built before the clock
    kw = dict(chunk=args.chunk, queue_capacity=args.qcap,
              fp_capacity=args.fpcap, route_factor=args.routefactor,
              backend=backend, pipeline=args.pipeline,
              obs_slots=_obs_slots(args), sort_free=args.sortfree,
              deferred=args.deferredinv)
    if args.checkpoint:
        meta_config = {
            "spec": spec.spec_name,
            "constants": {k: sorted(v) if isinstance(v, frozenset) else v
                          for k, v in g.constants.items()},
        }
        return check_sharded_with_checkpoints(
            None, mesh, ckpt_path=args.checkpoint,
            ckpt_every=args.checkpointevery, resume=args.recover,
            meta_config=meta_config, **kw)
    return check_sharded(None, mesh, **kw)


def _gen_coverage_lines(spec, g):
    """The generic frontend's -coverage dump (jaxtlc/api.py:963): the host
    walker over the module's source lines."""
    from .gen.coverage import coverage_walk, render_coverage

    text = ""
    if spec.tla_path:
        try:
            with open(spec.tla_path) as f:
                text = f.read()
        except OSError:
            pass
    init_count, cov = coverage_walk(g, text)
    return render_coverage(spec.spec_name, init_count, cov,
                           time.strftime("%Y-%m-%d %H:%M:%S"))


def _gen_trace_text(args, log, g, found):
    """The trace states' text, each with the -traceExpressions values
    evaluated over its state_env (the reference's trace-explorer pass)."""
    from .gen import oracle as go

    expr_rows = _trace_expr_rows(args.traceExpressions, log,
                                 [go.state_env(g, st) for st, _ in found[1]])
    out = []
    for i, (st, _) in enumerate(found[1]):
        text = go.state_to_tla(g, st)
        if expr_rows is not None:
            text += _expr_conjuncts(expr_rows[i])
        out.append(text)
    return out


def _run_check_gen(args, spec) -> int:
    """Check a generic-frontend spec (jaxtlc/api.py:851 _run_check_gen
    with the parts of _run_check_interp, :1737, that it uses): the
    preflight, then for safety the gen engine (gen.engine.check_gen,
    kernel K19) - or, whenever -sharded or -checkpoint is given, the
    sharded engine over the generic backend (kernels K21, K18; one shard
    without -sharded; whole-carry checkpoints with -checkpoint, resumed
    with -recover; pipelined with -pipeline) - its PROPERTY lines on the
    host oracle's graph or, above HOST_PATH_MAX distinct states under
    wf_next, on the device path (live.check check_leads_to_device, its
    fixpoint over the shards with -sharded), the host oracle's re-run for
    a violation's trace.  Same transcript, journal and exit codes."""
    from .gen import oracle as go
    from .live.check import (
        capture_gen_graph,
        check_leads_to_device,
        use_device_path,
    )

    unsupported = [flag for flag, on in (
        ("-fpset DiskFPSet", args.fpset != "JaxFPSet"),
        ("-mutation", args.mutation),
        # the reference's sharded gen engine always checks deadlock
        ("-nodeadlock with -sharded/-checkpoint",
         (args.sharded or args.checkpoint) and not spec.check_deadlock),
    ) if on]
    if unsupported:
        print(f"Error: {', '.join(unsupported)} not supported for "
              "generic-frontend specs yet", file=_err(args))
        return 1
    if not _check_shard_count(args):
        return 1
    g = spec.genspec
    device = _device(args)
    try:
        device_name = _device_name(device)
    except RuntimeError as e:  # no card and no -workers cpu
        print(f"Error: {e}", file=_err(args))
        return 1
    log = _tlc_log(args)
    log.version(__version__)
    log.banner(spec.fp_index, DEFAULT_SEED, spec.workers, device_name)
    log.sany(*_sany_inputs(args.config, spec.spec_name))
    log.starting()
    log.computing_init()
    _open_journal(args, workload=spec.spec_name, device=device_name,
                  params=dict(chunk=args.chunk, queue_capacity=args.qcap,
                              fp_capacity=args.fpcap, sharded=args.sharded,
                              pipeline=args.pipeline, frontend="generic",
                              sort_free=_sort_free(args),
                              deferred=_deferred(args),
                              symmetry=_symmetry(args), por=_por(args),
                              obs_slots=_obs_slots(args)))

    def gen_preflight():
        from .analysis.preflight import preflight_gen

        return preflight_gen(g, fp_capacity=args.fpcap)

    rc = _preflight_gate(args, log, gen_preflight)
    if rc is not None:
        return rc
    t0 = time.time()
    from .resil.supervisor import SlotOverflowError

    try:
        r = args._result = _gen_check(args, spec, device)
    except SlotOverflowError as e:
        log.msg(1000, f"Run stopped: {e}", severity=1)
        _finish_journal(args)
        return 1
    except FileNotFoundError as e:
        print(f"Error: {e}", file=_err(args))
        _finish_journal(args)
        return 1
    n_init = 1  # generic Init is deterministic: one state
    log.init_done(n_init)
    violated = r.violation != 0
    liveness_violated = False
    if not violated and spec.properties:
        on_device = use_device_path(r.distinct, args.fairness,
                                    args.liveness_host)
        log.checking_temporal(r.distinct, "device" if on_device else "host")
        graph = None  # captured once for every property
        mesh = None
        if on_device and args.sharded:
            from .engine.sharded import ShardMesh

            mesh = ShardMesh(args.sharded, device)
        for name, (p_ast, q_ast) in g.properties.items():
            if on_device:
                if graph is None:
                    graph = capture_gen_graph(
                        g, chunk=args.chunk, state_capacity=args.fpcap,
                        fp_capacity=args.fpcap,
                        spill_path=args.checkpoint or None, device=device)
                res = check_leads_to_device(g, p_ast, q_ast, name,
                                            graph=graph, mesh=mesh,
                                            device=device)
            else:
                res = go.check_leads_to(g, p_ast, q_ast, name,
                                        fairness=args.fairness)
            if res.holds:
                log.msg(1000, f"Temporal property {name} holds "
                              f"(fairness: {args.fairness}).")
                continue
            liveness_violated = True
            log.msg(2116, f"Temporal properties were violated: {name}",
                    severity=1)
            idx = 1
            for st in res.lasso_prefix:
                log.trace_state(idx, None, go.state_to_tla(g, st))
                idx += 1
            log.msg(1000, "-- The following states form a cycle "
                          "(back to the first of them) --")
            for st in res.lasso_cycle:
                log.trace_state(idx, None, go.state_to_tla(g, st))
                idx += 1
    if violated:
        log.msg(2110 if r.violation >= 100 else 1000, r.violation_name,
                severity=1)
        found = go.violation_trace(g, check_deadlock=spec.check_deadlock)
        if found is None:
            log.msg(1000, "Violation was not reproducible in host mode",
                    severity=1)
        else:
            texts = _gen_trace_text(args, log, g, found)
            for i, ((_, act), text) in enumerate(zip(found[1], texts),
                                                 start=1):
                head = (f"State {i}: <Initial predicate>" if act is None
                        else f"State {i}: <{act}>")
                log.msg(2217, head + "\n" + text, severity=1)
    elif not liveness_violated:
        log.success(r.generated, r.distinct, r.actual_fp_collision,
                    occupancy=r.fp_occupancy)
        if args.coverage:
            log.coverage_gen_dump(_gen_coverage_lines(spec, g))
        else:
            log.coverage_generic(spec.spec_name, n_init, r.action_generated,
                                 r.action_distinct)
    log.progress(r.depth, r.generated, r.distinct, r.queue_left)
    log.final_counts(r.generated, r.distinct, r.queue_left)
    log.depth(r.depth)
    log.finished(int((time.time() - t0) * 1000))
    _finish_journal(args, r=r, wall_s=time.time() - t0,
                    verdict="liveness_violation" if liveness_violated
                    else None)
    if violated:
        return 12
    return 13 if liveness_violated else 0
