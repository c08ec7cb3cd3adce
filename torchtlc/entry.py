"""Entry points of the port, shaped like the reference's __graft_entry__.

entry(device=None)   -> (step_fn, (carry,)): one BFS chunk step over Model_1
                        and a carry seeded with its Init states, on the card
                        unless `device` says otherwise.
dryrun_multichip(n, device=None)
                     -> the sharded engine over n fingerprint-space shards
                        in one process, on the full Model_1 run (TLC's
                        committed run, MC.out:1098,1101), checked against
                        its counts; on the card unless `device` says
                        otherwise.
"""

from __future__ import annotations


def entry(device=None):
    """One engine step (pop -> expand kernel -> fingerprint kernel -> dedup
    and insert kernels -> commit kernel) over Model_1, and its seed carry."""
    from .config import MODEL_1
    from .engine.bfs import make_engine

    init_fn, _, step_fn = make_engine(
        MODEL_1, chunk=256, queue_capacity=1 << 12, fp_capacity=1 << 14,
        device=device)
    return step_fn, (init_fn(),)


def dryrun_multichip(n_devices: int, device=None):
    """The workload of the reference's dryrun_multichip
    (__graft_entry__.py:_dryrun_body): full Model_1 with both fault
    constants TRUE, n shards, chunk 2048 (slab dedup and deferred
    invariants on), qcap 2^15 and fp 2^19 per shard; asserts MC.out's
    counts and returns the CheckResult."""
    from .config import ModelConfig
    from .engine.sharded import ShardMesh, check_sharded

    r = check_sharded(ModelConfig(True, True), ShardMesh(n_devices, device),
                      chunk=2048, queue_capacity=1 << 15,
                      fp_capacity=1 << 19)
    expect = (577736, 163408, 124)
    got = (r.generated, r.distinct, r.depth)
    assert got == expect, f"sharded run diverged: {got} != {expect}"
    assert r.violation == 0 and r.queue_left == 0
    assert r.action_generated["DoRequest"] == 149766  # MC.out:78
    assert r.action_generated["APIStart"] == 27059  # MC.out:621
    print(f"dryrun_multichip ok: {n_devices} shards, {r.distinct} distinct "
          f"states, depth {r.depth}, wall {r.wall_s:.1f}s")
    return r
