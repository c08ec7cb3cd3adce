"""In-process memo of struct backends (port of jaxtlc/struct/cache.py).

Compiling a struct spec - parse, shape inference, the lane-IR build and
the C++ emission - is a pure function of the spec's meaning (source
digest, canonical constants, invariant list), the deadlock switch, the
certified bound report's digest with the trap-elision switch (``-narrow``),
the coverage switch and the reduction switches (``-symmetry``, ``-por``), so one process builds each backend once; the memo
keeps the 64 most recently used.  The certified bound reports
(analysis.absint) are memoized the same way, by the spec's meaning.  The
reference's persistent XLA cache has its counterpart in the build
directory of the emitted kernel libraries, ``torchtlc/kernels/_build/
struct/<digest>/``: a second process checking the same spec finds its
library there and skips nvcc.  The port builds no engine ahead of
time (PyTorch runs eagerly), so there is no engine memo.
"""

from __future__ import annotations

from collections import OrderedDict

MEMO_CAP = 64
_BACKENDS: OrderedDict = OrderedDict()
_BOUNDS: OrderedDict = OrderedDict()


def _memo(memo: OrderedDict, key, build, cap: int = MEMO_CAP):
    """memo[key], built by build() at the first miss; least recently used
    entries beyond `cap` go."""
    hit = memo.get(key)
    if hit is None:
        hit = memo[key] = build()
        while len(memo) > cap:
            memo.popitem(last=False)
    memo.move_to_end(key)
    return hit


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

    return _memo(_BOUNDS, model_key(model), lambda: analyze_bounds(model))


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
    return _memo(_BACKENDS, key, lambda: struct_backend(
        model, check_deadlock=check_deadlock, bounds=bounds, elide=elide,
        coverage=coverage, symmetry=symmetry, por=por))
