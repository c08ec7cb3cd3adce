"""In-process memos of struct backends and engines (port of
jaxtlc/struct/cache.py).

Compiling a struct spec - parse, shape inference, the lane-IR build and
the C++ emission - is a pure function of the spec's meaning (source
digest, canonical constants, invariant list), the deadlock switch, the
certified bound report's digest with the trap-elision switch (``-narrow``),
the coverage switch and the reduction switches (``-symmetry``, ``-por``),
so one process builds each backend once.  Built engines are memoized on
the full geometry as well (``engine_key``: chunk, capacities, fingerprint
polynomial and seed, high-water mark, modes, device), so a long-lived
server's warm submit rebuilds nothing.  The memos are bounded
least-recently-used maps (``_LRUMemo``) with hit / miss / eviction
counters (``stats``; the serve plane's /pool republishes them), their caps
from ``TORCHTLC_BACKEND_MEMO_CAP`` (64) and ``TORCHTLC_ENGINE_MEMO_CAP``
(32) or ``set_caps``.  The certified bound reports (analysis.absint) are
memoized the same way, by the spec's meaning.

The reference's persistent XLA compilation cache
(``enable_persistent_cache``) has no counterpart to switch on: the port's
compiled artifacts are the kernel libraries, which already persist in
``torchtlc/kernels/_build/`` (a second process checking the same spec
finds its emitted library there and skips nvcc), so the port has no such
function.
"""

from __future__ import annotations

import os
from collections import OrderedDict

MEMO_CAP = 64


class _LRUMemo:
    """Bounded in-process memo: a long-lived serving process runs an
    unbounded stream of distinct models, so the memo evicts
    least-recently-used entries at a size cap and counts hits, misses and
    evictions.  Eviction only drops the memo's reference: callers holding
    an evicted backend or engine keep it alive."""

    def __init__(self, cap: int):
        self.cap = cap
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        hit = self._d.get(key)
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        self._d.move_to_end(key)
        return hit

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.cap:
            self._d.popitem(last=False)
            self.evictions += 1

    def stats(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    size=len(self._d), cap=self.cap,
                    evictions=self.evictions)

    def clear(self) -> None:
        self._d.clear()


def _env_cap(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, "")))
    except ValueError:
        return default


# backends are Python and emitted text; built engines hold device
# buffers' geometry and kernel closures, so their cap is tighter
_BACKEND_MEMO = _LRUMemo(_env_cap("TORCHTLC_BACKEND_MEMO_CAP", 64))
_ENGINE_MEMO = _LRUMemo(_env_cap("TORCHTLC_ENGINE_MEMO_CAP", 32))
_BOUNDS_MEMO = _LRUMemo(MEMO_CAP)


def _memo(memo, key, build, cap: int = MEMO_CAP):
    """memo[key], built by build() at the first miss: an _LRUMemo, or an
    OrderedDict whose least recently used entries beyond `cap` go."""
    if isinstance(memo, _LRUMemo):
        hit = memo.get(key)
        if hit is None:
            hit = build()
            memo.put(key, hit)
        return hit
    hit = memo.get(key)
    if hit is None:
        hit = memo[key] = build()
        while len(memo) > cap:
            memo.popitem(last=False)
    memo.move_to_end(key)
    return hit


def stats() -> dict:
    """Hit/miss/size/eviction counters for the memos (cumulative per
    process; the serve /pool endpoint republishes them)."""
    return {"backend": _BACKEND_MEMO.stats(),
            "engine": _ENGINE_MEMO.stats(),
            "bounds": _BOUNDS_MEMO.stats()}


def set_caps(backend: int = None, engine: int = None) -> None:
    """Resize the memo caps (tests + server sizing; shrinking evicts
    LRU entries immediately)."""
    for memo, cap in ((_BACKEND_MEMO, backend), (_ENGINE_MEMO, engine)):
        if cap is None:
            continue
        memo.cap = max(1, int(cap))
        while len(memo._d) > memo.cap:
            memo._d.popitem(last=False)
            memo.evictions += 1


def clear() -> None:
    """Drop the in-process memos (tests; the kernel libraries are files)."""
    _BACKEND_MEMO.clear()
    _ENGINE_MEMO.clear()
    _BOUNDS_MEMO.clear()


def model_key(model) -> tuple:
    """The spec-meaning component of every cache key."""
    from .backend import canonical_constants

    consts = tuple(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in canonical_constants(model).items()
    )
    return (
        model.source_digest or repr(id(model)),
        consts,
        tuple(model.invariants),
    )


def get_bounds(model):
    """Memoized certified bound report (analysis.absint) for a struct model
    (jaxtlc/struct/cache.py:161): the backend memo and the checkpoint meta
    derive their keys from this one report."""
    from ..analysis.absint import analyze_bounds

    return _memo(_BOUNDS_MEMO, model_key(model),
                 lambda: analyze_bounds(model))


def get_backend(model, check_deadlock: bool = True, bounds=None,
                elide: bool = True, coverage: bool = False,
                symmetry: bool = False, por: bool = False):
    """Memoized struct_backend.  `bounds` (a certified BoundReport) selects
    the narrowed compile, a distinct entry keyed on its digest; `elide`
    False keeps every trap and carries no certificate (the sharded
    routes); `symmetry` / `por` (resolved bools) attach the state-space
    reduction - distinct entries, since a reduced backend's text, carry
    and checkpoints differ."""
    from .backend import struct_backend

    key = (model_key(model), bool(check_deadlock),
           "" if bounds is None else bounds.digest(), bool(elide),
           bool(coverage), bool(symmetry), bool(por))
    return _memo(_BACKEND_MEMO, key, lambda: struct_backend(
        model, check_deadlock=check_deadlock, bounds=bounds, elide=elide,
        coverage=coverage, symmetry=symmetry, por=por))


def engine_key(model, chunk: int, queue_capacity: int, fp_capacity: int,
               fp_index: int, seed: int, fp_highwater: float,
               check_deadlock: bool = True, pipeline: bool = False,
               obs_slots: int = 0, bounds=None, coverage: bool = False,
               sort_free: bool = None, deferred: bool = None,
               symmetry: bool = None, por: bool = None,
               device=None) -> tuple:
    """The full engine-memo key: spec meaning x engine geometry x the
    pipeline / obs / coverage / mode flags x the certified-bound digest x
    the device.  The serve EnginePool keys its warm entries on exactly
    this tuple, so pool identity and memo identity cannot drift.  The
    tri-state modes are resolved against the chunk, so the key never
    depends on who asked."""
    from ..engine.bfs import (
        resolve_deferred,
        resolve_device,
        resolve_por,
        resolve_sort_free,
        resolve_symmetry,
    )

    return (
        model_key(model), "single", chunk, queue_capacity, fp_capacity,
        fp_index, seed, fp_highwater, bool(check_deadlock),
        bool(pipeline), int(obs_slots),
        "" if bounds is None else bounds.digest(), bool(coverage),
        resolve_sort_free(sort_free, chunk),
        resolve_deferred(deferred, chunk),
        resolve_symmetry(symmetry, chunk), resolve_por(por, chunk),
        str(resolve_device(device)),
    )


def get_engine(model, chunk: int, queue_capacity: int, fp_capacity: int,
               fp_index: int, seed: int, fp_highwater: float,
               check_deadlock: bool = True, pipeline: bool = False,
               obs_slots: int = 0, bounds=None, coverage: bool = False,
               sort_free: bool = None, deferred: bool = None,
               symmetry: bool = None, por: bool = None, device=None):
    """Memoized single-device engine triple (init_fn, run_fn, step_fn) of
    a struct model on `device` (None: the card), keyed by engine_key.
    The port fingerprints under the default seed and halts at the default
    high-water mark, which the key carries."""
    from ..engine.bfs import (
        FP_HIGHWATER,
        make_backend_engine,
        resolve_por,
        resolve_symmetry,
    )
    from ..engine.fingerprint import DEFAULT_SEED

    if seed != DEFAULT_SEED or fp_highwater != FP_HIGHWATER:
        raise ValueError("the port's engines run at the default "
                         "fingerprint seed and high-water mark")
    key = engine_key(
        model, chunk, queue_capacity, fp_capacity, fp_index, seed,
        fp_highwater, check_deadlock=check_deadlock, pipeline=pipeline,
        obs_slots=obs_slots, bounds=bounds, coverage=coverage,
        sort_free=sort_free, deferred=deferred, symmetry=symmetry,
        por=por, device=device)

    def build():
        backend = get_backend(model, check_deadlock, bounds=bounds,
                              coverage=coverage,
                              symmetry=resolve_symmetry(symmetry, chunk),
                              por=resolve_por(por, chunk))
        return make_backend_engine(
            backend, chunk, queue_capacity, fp_capacity, pipeline=pipeline,
            obs_slots=obs_slots, sort_free=sort_free, deferred=deferred,
            device=device, fp_index=fp_index)

    return _memo(_ENGINE_MEMO, key, build)
