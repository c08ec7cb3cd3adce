"""Command-line interface of the port: the TLC invocation contract of
jaxtlc/cli.py on the KubeAPI path.

    python -m torchtlc.cli check /path/to/Model_1/MC.cfg \\
        [-workers cpu] [-chunk 1024] [-qcap N] [-fpcap N] \\
        [-checkpoint PATH [-checkpointevery N] [-recover]] \\
        [-no-auto-grow] [-spill | -no-spill] [-coverage] [-pipeline] \\
        [-sharded N [-routefactor F]] [-symmetry] [-por]
        [-simulate [-walkers W] [-depth N] [-sim-seed S]]
        [-infer [-infer-budget N] [-walkers W -depth N -sim-seed S]]
        [-fpset DiskFPSet] [-artifact-cache DIR | -no-artifact-cache]
        [-recheck] [-liveness [-liveness-host]
        [-fairness wf_next|wf_process]] [-serve PORT] [-trace-out PATH]
        [-noTool] ...

Reads MC.cfg with its sibling MC.tla (and a toolbox .launch if present),
runs the exhaustive check on the card - on the CPU only with -workers cpu
- and writes the TLC structured transcript.  The KubeAPI root spec runs
on its hand-written path; a spec inside the PlusCal-translation subset
(RaftElection, Reconciler, ServiceMesh) on the generic frontend, as does
any spec with -frontend gen; a spec outside it (TwoPhase, RaftReplication)
on the structural frontend, as does any spec with -frontend struct;
-simulate runs random walks on a struct spec instead, -infer invariant
inference; -fpset DiskFPSet runs the native disk tier on KubeAPI specs,
and struct checks consult the artifact cache; -serve PORT serves the
run's journal live (torchtlc.obs.serve) and -trace-out PATH writes its
Chrome trace at the end (torchtlc.obs.trace).  Exit
codes: 0 no error, 12
safety violation (with the counterexample trace), 13 temporal property
violated (with the lasso), 75 interrupted or
capacity-exhausted with a final checkpoint (resume with -recover), 1
usage or configuration error, 2 a flag of a path the port does not run
yet (the error names the slice that will port it).
"""

from __future__ import annotations

import argparse
import sys

from .api import _run_check

# flags of paths not ported yet: dest -> (the value that means "not
# given", what the error says)
UNPORTED = {
    "analyze": (False, "-analyze (the preflight jaxpr audits) is not part "
                "of the port yet (ROADMAP Queue C, Queue A item 13)"),
    "xprof": ("", "-xprof is the JAX profiler; the port's profiler is "
              "python3 -m torchtlc.profile"),
    "compilecache": ("", "-compile-cache is XLA's; the port builds its "
                     "kernels once into torchtlc/kernels/_build"),
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="torchtlc")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="exhaustively check a TLC model config")
    c.add_argument("config", help="path to MC.cfg (sibling MC.tla is read)")
    c.add_argument("-workers", default="gpu",
                   help="cpu runs the plain torch path on the CPU; any "
                        "other value runs on the card")
    c.add_argument("-fp", type=int, default=None, help="fp polynomial index")
    c.add_argument("-chunk", type=int, default=1024)
    c.add_argument("-sort-free", dest="sortfree", action="store_const",
                   const=True, default=None,
                   help="commit through the hash-slab dedup (default auto: "
                        "on at -chunk >= 2048)")
    c.add_argument("-no-sort-free", dest="sortfree", action="store_const",
                   const=False)
    c.add_argument("-deferred-inv", dest="deferredinv",
                   action="store_const", const=True, default=None,
                   help="check invariants on the fresh-insert claimants "
                        "(default auto: on at -chunk >= 2048)")
    c.add_argument("-no-deferred-inv", dest="deferredinv",
                   action="store_const", const=False)
    c.add_argument("-qcap", type=int, default=1 << 15)
    c.add_argument("-fpcap", type=int, default=1 << 20)
    c.add_argument("-checkpoint", default="", metavar="PATH",
                   help="periodic engine snapshots to PATH; resume with "
                        "-recover")
    c.add_argument("-checkpointevery", type=int, default=256, metavar="N",
                   help="chunk steps between checkpoints")
    c.add_argument("-recover", action="store_true",
                   help="resume from -checkpoint PATH (the newest intact "
                        "generation)")
    c.add_argument("-auto-grow", dest="autogrow", action="store_true",
                   default=True,
                   help="(default) double a saturated table or queue and "
                        "resume from the last good carry")
    c.add_argument("-no-auto-grow", dest="autogrow", action="store_false",
                   help="capacity exhaustion stops the run; without "
                        "-checkpoint this runs the plain engine")
    c.add_argument("-spill", dest="spill", action="store_const",
                   const="on", default="auto",
                   help="prefer the host fingerprint spill tier at the "
                        "first table saturation (default auto: when a "
                        "regrow is denied)")
    c.add_argument("-no-spill", dest="spill", action="store_const",
                   const="off")
    c.add_argument("-max-regrow", dest="maxregrow", type=int, default=8,
                   metavar="N")
    c.add_argument("-retry", type=int, default=2, metavar="N",
                   help="retries of a segment after a transient fault")
    c.add_argument("-faults", default="", metavar="PLAN",
                   help="self-test fault plan, e.g. 'transient@1,"
                        "sigterm@3,alloc_fail@1'")
    c.add_argument("-obs", dest="obs", action="store_true", default=True,
                   help="(default) carry the per-level counter ring")
    c.add_argument("-no-obs", dest="obs", action="store_false")
    c.add_argument("-obs-slots", dest="obsslots", type=int, default=256,
                   metavar="N")
    c.add_argument("-coverage", action="store_true",
                   help="carry the device coverage plane and print TLC's "
                        "per-expression coverage dump")
    c.add_argument("-journal", default="", metavar="PATH",
                   help="append-only JSONL run journal (default "
                        "CHECKPOINT.journal.jsonl with -checkpoint)")
    c.add_argument("-no-preflight", dest="preflight", action="store_false",
                   default=True,
                   help="skip the preflight analysis (the spec lints, the "
                        "unreduced-symmetry warning and the counter-width "
                        "arithmetic that run before every check)")
    c.add_argument("-nodeadlock", action="store_true")
    c.add_argument("-noTool", action="store_true",
                   help="plain text output (no @!@!@ framing)")
    c.add_argument("-mutation", default="",
                   help="self-test: a deliberately broken transition rule "
                        "(e.g. delete_noop)")
    c.add_argument("-sharded", type=int, default=0, metavar="N",
                   help="the sharded engine over N fingerprint-space shards "
                        "(a power of two, at most 8) in one process; the "
                        "capacities are per shard")
    c.add_argument("-routefactor", type=float, default=2.0,
                   help="sharded route bucket size as a multiple of the "
                        "mean per-owner share (auto-grow doubles it on a "
                        "bucket overflow)")
    c.add_argument("-frontend", default="auto",
                   help="auto picks the frontend as the reference does "
                        "(KubeAPI: hand; a PlusCal-translation-subset "
                        "spec: gen; any other spec: struct); gen forces "
                        "the generic frontend, struct runs any spec on "
                        "the structural path")
    c.add_argument("-fpset", default="JaxFPSet",
                   choices=["JaxFPSet", "DiskFPSet"],
                   help="JaxFPSet = device-resident fingerprint table; "
                        "DiskFPSet = native host tier (disk-bounded, the "
                        "OffHeapDiskFPSet analog; -sharded N = N "
                        "fingerprint partitions, a power of two)")
    c.add_argument("-pipeline", dest="pipeline", action="store_true",
                   default=False,
                   help="the pipelined body: each step commits the "
                        "previous block while the next one is staged "
                        "(the same counts; a checkpoint records the mode "
                        "and -recover must repeat it)")
    c.add_argument("-no-pipeline", dest="pipeline", action="store_false")
    c.add_argument("-symmetry", dest="symmetry", action="store_const",
                   const=True, default=None,
                   help="symmetry reduction on struct specs: the CONSTANT "
                        "sets the spec treats as fully permutation-"
                        "symmetric (verified against the spec text) are "
                        "reduced by canonicalizing every successor to "
                        "its orbit representative before fingerprinting "
                        "(kernel K24); same verdict and trace, fewer "
                        "distinct states; a runtime orbit certificate "
                        "(K25) on one device makes a wrong "
                        "canonicalization an error verdict.  Default "
                        "off; ignored on KubeAPI and generic specs; a "
                        "checkpoint records the mode")
    c.add_argument("-no-symmetry", dest="symmetry", action="store_const",
                   const=False, help="the unreduced state space")
    c.add_argument("-por", dest="por", action="store_const",
                   const=True, default=None,
                   help="partial-order pruning on struct specs: where a "
                        "provably safe action is enabled, expand only its "
                        "transitions (singleton ample sets, kernel K26); "
                        "same verdict, fewer states; the journal's "
                        "`reduce` event counts the pruned transitions.  "
                        "Default off; ignored on KubeAPI and generic "
                        "specs; a checkpoint records the mode")
    c.add_argument("-no-por", dest="por", action="store_const",
                   const=False, help="full interleaving expansion")
    c.add_argument("-simulate", action="store_true",
                   help="randomized simulation instead of exhaustive BFS "
                        "(struct specs; -frontend struct runs any spec): "
                        "-walkers W random walks of depth -depth N on the "
                        "card (kernels K27, K28), each lane a pure "
                        "function of (-sim-seed, lane) - a violation "
                        "replays from the seed and renders the exit-12 "
                        "trace, plain P ~> Q properties are checked for "
                        "lassos on the walks.  A clean result is a smoke "
                        "verdict (sampled, not exhaustive).  Composes "
                        "with -checkpoint/-recover and -faults")
    c.add_argument("-depth", type=int, default=100,
                   help="simulation walk depth (transitions per walker; "
                        "TLC's -depth)")
    c.add_argument("-walkers", type=int, default=256,
                   help="simulation walker lanes, one thread each")
    c.add_argument("-sim-seed", dest="simseed", type=int, default=0,
                   help="simulation run seed: every walk (and any "
                        "violation it finds) is a pure function of it")
    c.add_argument("-infer", action="store_true",
                   help="inductive invariant inference instead of "
                        "checking: conjecture up to -infer-budget "
                        "candidate predicates over the spec's shapes, "
                        "kill the ones reachable evidence refutes in one "
                        "predicates-x-states kernel, certify the "
                        "survivors inductive over the reachable set's "
                        "one-step successors.  Exact evidence comes from "
                        "a host BFS; intractable configs sample -walkers "
                        "x -depth walk states (survivors are then "
                        "'consistent with evidence only').  Exits 12 "
                        "only when exact evidence refutes a cfg-named "
                        "invariant; requires the structural frontend")
    c.add_argument("-infer-budget", dest="inferbudget", type=int,
                   default=64,
                   help="candidate pool cap for -infer (conjectures "
                        "beyond it are counted as dropped in the "
                        "journal)")
    c.add_argument("-liveness", action="store_true",
                   help="check the KubeAPI temporal properties after a "
                        "clean run even when MC.cfg lists none; above 1M "
                        "distinct states on the device path")
    c.add_argument("-liveness-host", dest="liveness_host",
                   action="store_true",
                   help="force the host liveness path (explicit graph)")
    c.add_argument("-fairness", default="wf_next",
                   choices=["wf_next", "wf_process"],
                   help="wf_next = the spec's WF_vars(Next); wf_process = "
                        "per-process weak fairness (host path)")
    c.add_argument("-serve", type=int, default=0, metavar="PORT",
                   help="serve the run's journal live for its lifetime "
                        "(/runs /metrics /events /journal)")
    c.add_argument("-phase-timing", dest="phasetiming", action="store_true",
                   help="measured per-level expand/commit walls: the "
                        "supervisor swaps the fused segment for a "
                        "host-fenced step loop built from the same stage "
                        "closures, journaling `phase` events of scope "
                        "level (unpipelined single-device runs; ignored "
                        "elsewhere, as the reference ignores it)")
    c.add_argument("-trace-out", dest="traceout", default="",
                   metavar="PATH",
                   help="write the run's Chrome / Perfetto trace (from "
                        "its journal) at the end")
    c.add_argument("-xprof", default="")
    c.add_argument("-narrow", dest="narrow", action="store_true",
                   default=False)
    c.add_argument("-no-narrow", dest="narrow", action="store_false")
    c.add_argument("-analyze", action="store_true")
    c.add_argument("-traceExpressions", default="", metavar="FILE")
    c.add_argument("-compile-cache", dest="compilecache", default="")
    c.add_argument("-no-compile-cache", dest="compilecache",
                   action="store_const", const="off")
    c.add_argument("-artifact-cache", dest="artifactcache", default="",
                   metavar="DIR",
                   help="incremental re-checking artifact store "
                        "(struct frontend): cached verdicts keyed on the "
                        "spec's semantic digest (an unchanged spec "
                        "returns its verdict without building an "
                        "engine) and cached reachable sets keyed on the "
                        "behavior digest (an invariant-only edit skips "
                        "BFS and re-evaluates just the invariants, "
                        "kernel K31).  Default ~/.cache/torchtlc/"
                        "artifacts, or $TORCHTLC_ARTIFACT_CACHE (=off "
                        "disables); artifacts are CRC-verified and "
                        "written only on clean verdicts")
    c.add_argument("-no-artifact-cache", dest="noartifactcache",
                   action="store_true",
                   help="disable the artifact cache (both tiers) for "
                        "this run")
    c.add_argument("-recheck", action="store_true",
                   help="force a full re-check: bypass the artifact "
                        "cache on read (the run still refreshes the "
                        "artifacts it produces)")
    return p


def unported(args) -> list:
    """The errors of the flags given for paths not ported yet."""
    return [msg for dest, (off, msg) in UNPORTED.items()
            if getattr(args, dest) != off]


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    errs = unported(args)
    if errs:
        for e in errs:
            print(f"torchtlc: error: {e}", file=sys.stderr)
        return 2
    return _run_check(args)


if __name__ == "__main__":
    sys.exit(main())
