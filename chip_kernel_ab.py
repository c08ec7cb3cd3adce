#!/usr/bin/env python3
"""Old against new on one NVIDIA GPU: kernel K1 `expand` (the immediate
and deferred variants, the sharded variant) and the straggler walks of K3
and K33, built from two kernel source trees and timed in turns.

    python3 chip_kernel_ab.py OLD_CSRC [--k1-only] [--no-k33] [--out FILE]

OLD_CSRC is another copy of torchtlc/kernels/csrc with its ops.py beside
it (the old entry points' argument lists), e.g. a parent commit's:

    git archive <commit> torchtlc/kernels | tar -x -C ab_parent
    python3 chip_kernel_ab.py ab_parent/torchtlc/kernels/csrc

Both trees are built with nvcc (``-Xptxas -v``: each kernel's registers,
stack frame and spills are printed) and loaded side by side; every call
runs through torchtlc.kernels.ops with one tree's libraries loaded, on the
same inputs, in the order old, new, new, old, and the outputs of the two
trees must agree bitwise.  The shapes are chip_smoke.py phase 2's: K1 on
Model_1's level-40 frontier at chunk 1,024 and on the scaled 2x1 level at
chunk 131,072, and on 8,192 seeded rows of scaled 3x0 (9 words); the
sharded variant on those states as Model_1 on 8 shards at chunk 2,048
and scaled 2x1 on 4 shards at 32,768 (deferred, with the packed pop
rows, as phase 12's default modes run it) and as the disk tier's D = 1
block (Model_1, 1,000 of 1,024 staged rows, immediate, as
engine/hybrid.py make_expand runs it); the K3 walk on phase 2's seeded
tables (Model_1: R 2,048; scaled: R 262,144, load 0.55 -> 0.68) segment
by segment; K33 on phase 24b's RR4 class at body 61 (4 lanes,
chunk 16,384, R 32,768).  Times are device ms a call behind a spinning
kernel (chip_smoke.py cuda_ms).  The card's name and power limit are
printed; the numbers go to FILE (kernel_ab.json in the working directory).
``--k1-only`` times K1 alone, ``--no-k33`` leaves K33 out.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TURNS = ("old", "new", "new", "old")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("usage: chip_kernel_ab.py OLD_CSRC [--k1-only] [--no-k33] "
              "[--out FILE] (on a GPU)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from torchtlc.kernels import build, ops

    old_csrc = os.path.abspath(sys.argv[1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    new_info = ops.load(ptxas_report=True)
    libs = {"new": ops._lib,
            "old": old_lib(ops, build.build(ptxas_report=True,
                                            csrc=old_csrc), old_csrc)}
    print(f"built both trees in {time.time() - t0:.1f} s", flush=True)
    report = {"card": smi, "ptxas": {}, "cases": []}
    for tree, info in (("new", new_info), ("old", libs["old"].info)):
        ent = {}
        for stem, names in (("expand", ("expand_kernel",)),
                            ("fpset", ("walk_kernel",)),
                            ("fpset_batched", ("bwalk_kernel",))):
            ent.update(cs.ptxas_entries(info.logs.get(stem, ""), names))
        report["ptxas"][tree] = ent
        print(f"ptxas ({tree}): {ent}", flush=True)

    def use(tree):
        ops._lib = libs[tree]

    def in_turns(name, shape, fn, reps, setup=None, extra=None):
        """fn's outputs under both trees (bitwise equal), then its times
        in the order old, new, new, old."""
        outs = {}
        for tree in ("old", "new"):
            use(tree)
            outs[tree] = flat(fn(setup() if setup else None))
            torch.cuda.synchronize()
        same = len(outs["old"]) == len(outs["new"]) and all(
            torch.equal(a, b) for a, b in zip(outs["old"], outs["new"]))
        ms = {"old": [], "new": []}
        for tree in TURNS:
            use(tree)
            ms[tree].append(cs.cuda_ms(torch, fn, reps, setup))
        use("new")
        row = dict(name=name, shape=shape, equal=same, old_ms=ms["old"],
                   new_ms=ms["new"], **(extra or {}))
        report["cases"].append(row)
        print(f"{name} ({shape}): old {fmt(ms['old'])} ms, new "
              f"{fmt(ms['new'])} ms, outputs equal {same}", flush=True)
        if not same:
            raise SystemExit(f"{name}: the two trees disagree")

    from torchtlc.config import MODEL_1, scaled_config
    from torchtlc.spec.codec import get_codec

    c = cs.model1_level40()
    m1_block = c.queue[int(c.parity), :cs.M1_KW["chunk"]].contiguous()
    m1_n = int(c.level_n)
    s_cfg, s_kw = scaled_config()
    s_block, _, _ = cs.scaled_full_level(s_cfg, s_kw)
    ck_big = s_kw["chunk"]

    # K1, both variants
    for tag, cfg, block, n in (("model1", MODEL_1, m1_block, m1_n),
                               ("scaled", s_cfg, s_block, ck_big - 3)):
        for deferred in (False, True):
            in_turns("expand" + ("/deferred" if deferred else ""),
                     f"{tag}: {block.shape[0]} rows, {n} popped",
                     lambda _, cfg=cfg, block=block, n=n, d=deferred:
                     ops.expand(cfg, block, n, d), 20)

    # K1 on rows wider than the main path's: scaled 3x0 with both faults
    # (9 words), seeded random fields
    from torchtlc.config import make_scaled

    w_cfg = make_scaled(3, 0, True, True)
    w_cdc = get_codec(w_cfg)
    w_rng = np.random.default_rng(cs.SEED + 1)
    w_block = w_cdc.pack(torch.from_numpy(np.stack(
        [w_rng.integers(0, 1 << w, 8192) for w in w_cdc.lane_widths],
        1).astype(np.int32)).cuda())
    in_turns("expand", f"scaled 3x0 ({w_cdc.n_words} words): 8192 rows, "
             "8189 popped", lambda _: ops.expand(w_cfg, w_block, 8189), 20)

    # K1, the sharded variant over unpacked queue rows
    for tag, cfg, block, D, ck in (("model1", MODEL_1, m1_block, 8, 2048),
                                   ("scaled", s_cfg, s_block, 4, 1 << 15)):
        fields = get_codec(cfg).unpack(block)
        qrows = ck + 1
        pick = torch.arange(D * qrows, device=block.device) % block.shape[0]
        queue = fields[pick].reshape(D, qrows, -1).contiguous()
        qhead = torch.tensor([(17 * d) % ck for d in range(D)],
                             dtype=torch.int64, device=block.device)
        npop = torch.full((D,), ck - 3, dtype=torch.int64,
                          device=block.device)
        in_turns("expand/sharded", f"{tag}: {D} shards x {ck} rows, deferred",
                 lambda _, cfg=cfg, q=queue, h=qhead, p=npop, ck=ck:
                 ops.expand_sharded(cfg, q, h, p, ck, True, True), 20)

    # K1's sharded variant at D = 1: the disk tier's staging queue
    stage = torch.zeros((1, 1025, get_codec(MODEL_1).n_fields),
                        dtype=torch.int32, device=m1_block.device)
    stage[0, :1000] = get_codec(MODEL_1).unpack(m1_block[:1000])
    zero = torch.zeros(1, dtype=torch.int64, device=m1_block.device)
    npop1 = torch.full((1,), 1000, dtype=torch.int64, device=m1_block.device)
    in_turns("expand/sharded", "model1: disk tier, 1 shard x 1024 rows, "
             "1000 popped, immediate",
             lambda _: ops.expand_sharded(MODEL_1, stage, zero, npop1, 1024),
             20)

    # the K3 walk, segment by segment on phase 2's seeded tables
    rng = np.random.default_rng(cs.SEED)
    for tag, ncand, R in (("model1", 10240, 2048),
                          ("scaled", 1572864, 262144)):
        if "--k1-only" not in sys.argv:
            walk_case(torch, cs, ops, in_turns, rng, tag, ncand, R)

    if "--no-k33" not in sys.argv and "--k1-only" not in sys.argv:
        k33_case(torch, cs, ops, in_turns)

    out = (sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv
           else "kernel_ab.json")
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(smi, flush=True)
    return 0


# entry points whose argument list changed between the trees: this
# tree's arguments -> the old tree's (the walks gained a nullable stats
# counter before the stream)
ADAPT = {
    "tt_fpset_walk": lambda a: a[:8] + a[9:],
    "tt_fpset_bwalk": lambda a: a[:10] + a[11:],
}


def old_signatures(ops_py):
    """{entry point: ctypes argument list} of the _SIGNATURES table in an
    ops.py, read without importing it."""
    import ast

    kinds = {"_P": ctypes.c_void_p, "_I": ctypes.c_int,
             "_LL": ctypes.c_longlong}

    def arg(node):
        if isinstance(node, ast.Name):
            return kinds[node.id]
        return getattr(ctypes, node.attr)  # ctypes.c_uint and the like

    with open(ops_py) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "_SIGNATURES"):
            return {k.value: [arg(a) for a in v.elts[1].elts]
                    for k, v in zip(node.value.keys, node.value.values)}
    raise SystemExit(f"{ops_py}: no _SIGNATURES table")


def old_lib(ops, info, csrc):
    """The old tree's libraries behind this tree's ops wrappers: each
    entry point bound with the old tree's own argument list (the
    _SIGNATURES of the ops.py beside OLD_CSRC); one whose list differs
    from this tree's is called through its ADAPT entry, and the script
    stops on a changed entry that ADAPT lacks."""
    import types

    old = old_signatures(os.path.join(os.path.dirname(csrc), "ops.py"))
    dlls = {stem: ctypes.CDLL(path) for stem, path in info.libs.items()}
    lib = types.SimpleNamespace(info=info)
    for fn, (stem, argtypes) in ops._SIGNATURES.items():
        f = getattr(dlls[stem], fn, None) if fn in old else None
        if f is None:
            continue  # not in the old tree: never called here
        f.argtypes, f.restype = old[fn], ctypes.c_int
        if old[fn] == argtypes:
            setattr(lib, fn, f)
        elif fn in ADAPT:
            setattr(lib, fn, lambda *a, f=f, ad=ADAPT[fn]: f(*ad(a)))
        else:
            raise SystemExit(f"{fn}: the old tree's arguments differ and "
                             "ADAPT has no entry for it")
    return lib


def flat(x):
    """The tensors of a call's result, in order."""
    if x is None:
        return []
    if hasattr(x, "is_cuda"):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in flat(v)]
    return []


def fmt(v):
    return "/".join(f"{x:.4f}" for x in v)


def walk_case(torch, cs, ops, in_turns, rng, tag, ncand, R):
    """phase 2's K3 table (chip_smoke.py check_fpset), then each active
    segment's walk from the same post-claim state under both trees."""
    import numpy as np

    from torchtlc.engine import fpset

    dev = torch.device("cuda")
    cap = 1 << int(np.floor(np.log2(4.8 * ncand)))
    table = torch.zeros(cap // 8, 16, dtype=torch.int32, device=dev)

    def batch(n):
        lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        hi = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        dup = rng.integers(0, n // 2, n)
        t = [torch.from_numpy(x[dup].view(np.int32)).to(dev)
             for x in (lo, hi)]
        return t[0], t[1], torch.ones(n, dtype=torch.bool, device=dev)

    while int(fpset.fpset_count(fpset.FPSet(table))) < int(0.55 * cap):
        fpset.fpset_insert_sorted(fpset.FPSet(table), *batch(ncand // 4),
                                  probe_width=R, claim_width=R)
    key = fpset.fpset_key(*batch(ncand))
    c_key, _, nreps = fpset.dedup_compact(key)
    nseg = -(-ncand // R)
    c_key = torch.cat([c_key, torch.full((nseg * R - ncand,), fpset.KEY00,
                                         dtype=torch.int64, device=dev)])
    nr = int(nreps)
    for seg in range(nseg):
        off = seg * R
        if off >= nr:
            break
        keys = c_key[off:off + R].contiguous()
        slot = ops.fpset_probe(table, keys, nreps, off)
        is_new = torch.empty(R, dtype=torch.uint8, device=dev)
        pend = torch.empty(R, dtype=torch.uint8, device=dev)
        npend = torch.zeros(1, dtype=torch.int32, device=dev)
        ops.fpset_claim(table, keys, slot, R, is_new, pend, npend)
        n_s = int(npend)
        base = (table, pend, is_new)

        def setup(base=base):
            return tuple(t.clone() for t in base)

        def walk(st, keys=keys, npend=npend):
            ops.fpset_walk(st[0], keys, st[1], st[2], npend)
            return st

        in_turns("fpset_walk", f"{tag}: segment {seg}, R {R}, {n_s} "
                 f"stragglers", walk, 3, setup, dict(stragglers=n_s))
        t, p, i = setup()
        ops.fpset_walk(t, keys, p, i, npend)
        table = t


def k33_case(torch, cs, ops, in_turns):
    """phase 24b's K33 call: the RR4 class at body 61, the widest lanes'
    candidates into a clone of each lane's table."""
    from torchtlc.engine import fpset
    from torchtlc.engine.fingerprint import fp64_words
    from torchtlc.serve.sweep import SweepEngine, load_anchored

    tmp = tempfile.mkdtemp(prefix="chip_ab_")
    cfgs = cs.models24(tmp)
    m = load_anchored(cfgs["rr4s"], cs.RR4S_PARAMS)
    eng = SweepEngine(m, cs.RR4S_PARAMS, **cs.RR4S_KW)
    ops.struct_lib(eng.backend.kernels.prog)
    configs = [{"MaxTerm": v} for v in (4, 5, 6, 7)]
    b = eng._stack_fn([eng.carry_for(v) for v in configs])
    for _ in range(60):
        b = eng._brun.body(b)
    prog = eng.backend.kernels.prog
    C, L = eng.chunk, prog.L
    pops = cs.sweep_pops(b, C)
    pop = torch.tensor(pops, dtype=torch.int64).cuda()
    got = ops.emitted_expand_batched(prog, b.queue, pop, C, eng.deferred)
    w = max(p[3] for p in pops)
    live = [k for k, p in enumerate(pops) if p[3] == w]
    n = w * L
    lo, hi = fp64_words(got[0][live, :n].reshape(-1, prog.W),
                        prog.cdc.nbits)
    lo, hi = lo.view(len(live), n), hi.view(len(live), n)
    mask = got[1][live, :n].bool()
    R = min(2 * w, n)

    def insert(t):
        res = fpset.fpset_insert_sorted_batched(
            t, live, lo, hi, mask, probe_width=R, claim_width=R)
        return (t, *res)

    in_turns("fpset_insert_batched", f"RR4 class, body 61: {len(live)} "
             f"lanes x {n:,} candidates, R {R:,}", insert, 5,
             lambda: b.table.clone())


if __name__ == "__main__":
    sys.exit(main())
