"""Entry points of the port, shaped like the reference's __graft_entry__.

entry(device=None)   -> (step_fn, (carry,)): one BFS chunk step over Model_1
                        and a carry seeded with its Init states, on the card
                        unless `device` says otherwise.
dryrun_multichip(n)  -> the sharded engine, which a later slice ports.
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


def dryrun_multichip(n_devices: int) -> None:
    raise NotImplementedError(
        "the sharded engine (jaxtlc/engine/sharded.py) is not ported yet; "
        f"dryrun_multichip({n_devices}) waits for that slice")
