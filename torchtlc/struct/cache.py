"""In-process memo of struct backends (port of jaxtlc/struct/cache.py).

Compiling a struct spec - parse, shape inference, the lane-IR build and
the C++ emission - is a pure function of the spec's meaning (source
digest, canonical constants, invariant list), the deadlock switch and the
coverage switch, so
one process builds each backend once; the memo keeps the 64 most recently
used.  The reference's persistent XLA cache has its counterpart in the
build directory of the emitted kernel libraries, ``torchtlc/kernels/
_build/struct/<digest>/``: a second process checking the same spec finds
its library there and skips nvcc.  The port builds no engine ahead of
time (PyTorch runs eagerly), so there is no engine memo.
"""

from __future__ import annotations

from collections import OrderedDict

MEMO_CAP = 64
_BACKENDS: OrderedDict = OrderedDict()


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


def get_backend(model, check_deadlock: bool = True, coverage: bool = False):
    """Memoized struct_backend."""
    from .backend import struct_backend

    key = (model_key(model), bool(check_deadlock), bool(coverage))
    hit = _BACKENDS.get(key)
    if hit is None:
        hit = struct_backend(model, check_deadlock=check_deadlock,
                             coverage=coverage)
        _BACKENDS[key] = hit
        while len(_BACKENDS) > MEMO_CAP:
            _BACKENDS.popitem(last=False)
    _BACKENDS.move_to_end(key)
    return hit
