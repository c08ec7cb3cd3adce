"""Command-line interface of the port: the TLC invocation contract of
jaxtlc/cli.py on the KubeAPI path.

    python -m torchtlc.cli check /path/to/Model_1/MC.cfg \\
        [-workers cpu] [-chunk 1024] [-qcap N] [-fpcap N] \\
        [-checkpoint PATH [-checkpointevery N] [-recover]] \\
        [-no-auto-grow] [-spill | -no-spill] [-coverage] [-pipeline] \\
        [-sharded N [-routefactor F]] [-noTool] ...

Reads MC.cfg with its sibling MC.tla (and a toolbox .launch if present),
runs the exhaustive check on the card - on the CPU only with -workers cpu
- and writes the TLC structured transcript.  Exit codes: 0 no error, 12
safety violation (with the counterexample trace), 75 interrupted or
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
    "fpset": ("JaxFPSet", "-fpset DiskFPSet (the native disk tier) is "
              "ported with the capacity tiers (ROADMAP Queue A item 13)"),
    "symmetry": (None, "-symmetry/-no-symmetry (state-space reduction) is "
                 "ported with the reduction plane (ROADMAP Queue A item "
                 "13)"),
    "por": (None, "-por/-no-por (partial-order pruning) is ported with the "
            "reduction plane (ROADMAP Queue A item 13)"),
    "simulate": (False, "-simulate (random-walk simulation) is ported with "
                 "the simulation plane (ROADMAP Queue A item 13)"),
    "infer": (False, "-infer (invariant inference) is ported with the "
              "inference plane (ROADMAP Queue A item 13)"),
    "liveness": (False, "-liveness is ported with the liveness plane "
                 "(ROADMAP Queue A item 13)"),
    "liveness_host": (False, "-liveness-host is ported with the liveness "
                      "plane (ROADMAP Queue A item 13)"),
    "fairness": ("wf_next", "-fairness is ported with the liveness plane "
                 "(ROADMAP Queue A item 13)"),
    "serve": (0, "-serve (the live monitor server) is ported with the "
              "serving plane (ROADMAP Queue A item 13)"),
    "phasetiming": (False, "-phase-timing (measured per-level expand/commit "
                    "walls) is not ported yet (ROADMAP Queue A item 7b); "
                    "until then it is refused in every mode, -pipeline "
                    "included, where the reference ignores it"),
    "traceout": ("", "-trace-out (the Chrome-trace export) is ported with "
                 "the serving plane (ROADMAP Queue A item 13)"),
    "narrow": (False, "-narrow (the certified narrowed codec) is ported "
               "with the struct path (ROADMAP Queue A item 11)"),
    "analyze": (False, "-analyze (the preflight jaxpr audits) is not part "
                "of the port yet (ROADMAP Queue C, Queue A item 13)"),
    "frontend": ("auto", "-frontend gen/struct (the generic and structural "
                 "frontends) are ported in their own slices (ROADMAP Queue "
                 "A items 11, 12)"),
    "traceExpressions": ("", "-traceExpressions is ported with the struct "
                         "path's expression evaluator (ROADMAP Queue A "
                         "item 11)"),
    "xprof": ("", "-xprof is the JAX profiler; the port's profiler is "
              "python3 -m torchtlc.profile"),
    "compilecache": ("", "-compile-cache is XLA's; the port builds its "
                     "kernels once into torchtlc/kernels/_build"),
    "artifactcache": ("", "-artifact-cache is ported with the struct "
                      "path's artifact cache (ROADMAP Queue A item 13)"),
    "noartifactcache": (False, "-no-artifact-cache is ported with the "
                        "artifact cache (ROADMAP Queue A item 13)"),
    "recheck": (False, "-recheck is ported with the artifact cache "
                "(ROADMAP Queue A item 13)"),
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
                   help="accepted for compatibility: the port runs no "
                        "preflight analysis")
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
    # the flags of paths the port does not run yet: parsed, then refused
    c.add_argument("-frontend", default="auto")
    c.add_argument("-fpset", default="JaxFPSet")
    c.add_argument("-pipeline", dest="pipeline", action="store_true",
                   default=False,
                   help="the pipelined body: each step commits the "
                        "previous block while the next one is staged "
                        "(the same counts; a checkpoint records the mode "
                        "and -recover must repeat it)")
    c.add_argument("-no-pipeline", dest="pipeline", action="store_false")
    for flag, dest in (("symmetry", "symmetry"), ("por", "por")):
        c.add_argument(f"-{flag}", dest=dest, action="store_const",
                       const=True, default=None)
        c.add_argument(f"-no-{flag}", dest=dest, action="store_const",
                       const=False)
    c.add_argument("-simulate", action="store_true")
    c.add_argument("-depth", type=int, default=100)
    c.add_argument("-walkers", type=int, default=256)
    c.add_argument("-sim-seed", dest="simseed", type=int, default=0)
    c.add_argument("-infer", action="store_true")
    c.add_argument("-infer-budget", dest="inferbudget", type=int, default=64)
    c.add_argument("-liveness", action="store_true")
    c.add_argument("-liveness-host", dest="liveness_host",
                   action="store_true")
    c.add_argument("-fairness", default="wf_next")
    c.add_argument("-serve", type=int, default=0, metavar="PORT")
    c.add_argument("-phase-timing", dest="phasetiming", action="store_true")
    c.add_argument("-trace-out", dest="traceout", default="")
    c.add_argument("-xprof", default="")
    c.add_argument("-narrow", dest="narrow", action="store_true",
                   default=False)
    c.add_argument("-no-narrow", dest="narrow", action="store_false")
    c.add_argument("-analyze", action="store_true")
    c.add_argument("-traceExpressions", default="", metavar="FILE")
    c.add_argument("-compile-cache", dest="compilecache", default="")
    c.add_argument("-no-compile-cache", dest="compilecache",
                   action="store_const", const="off")
    c.add_argument("-artifact-cache", dest="artifactcache", default="")
    c.add_argument("-no-artifact-cache", dest="noartifactcache",
                   action="store_true")
    c.add_argument("-recheck", action="store_true")
    return p


def unported(args) -> list:
    """The errors of the flags given for paths not ported yet."""
    errs = [msg for dest, (off, msg) in UNPORTED.items()
            if getattr(args, dest) != off
            and not (dest == "frontend" and args.frontend == "hand")]
    if args.sharded and args.spill == "on":
        errs.append("-spill with -sharded (the sharded engine's host spill "
                    "tier) is ported in the sharded-spill slice (ROADMAP "
                    "Queue A item 10b)")
    if not args.simulate and (args.depth, args.walkers, args.simseed) != (
            100, 256, 0):
        errs.append(UNPORTED["simulate"][1].replace(
            "-simulate", "-depth/-walkers/-sim-seed"))
    if args.inferbudget != 64:
        errs.append(UNPORTED["infer"][1].replace("-infer", "-infer-budget"))
    return errs


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
