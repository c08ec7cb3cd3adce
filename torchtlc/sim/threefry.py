"""Counter-based threefry2x32: the walk's choice bits (the draw of
jaxtlc/sim/engine.py:162-170 and jaxtlc/sim/replay.py:51-56, which jax
supplies there).

Transition ``d`` of lane ``l`` under run seed ``s`` consumes exactly
``bits(fold_in(fold_in(prng_key(s), l), d))``; ``d = 0`` draws the lane's
initial state.  The rules below are jax's on its default settings
(``jax_threefry_partitionable`` on, the ``threefry2x32`` implementation,
64-bit types off), and one wrong bit changes every trajectory:

* the key of seed ``s`` is ``(0, s mod 2^32)``: -1 gives ``(0,
  0xFFFFFFFF)``, ``2^32 + 5`` gives ``(0, 5)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``, both output words;
* a scalar's 32 bits are ``x0 ^ x1`` of ``threefry2x32(k, (0, 0))`` (the
  partitionable counter layout: neither ``x0`` alone nor the older
  layout's);
* the cipher is 20 rounds in 5 groups of 4, rotations 13, 15, 26, 6 and
  17, 29, 16, 24 by turns, the key schedule ``(k0, k1, k0 ^ k1 ^
  0x1BD11BDA)`` injected before the first group and after each, with the
  group's index + 1 added to the second word.

``prng_key``, ``fold_in`` and ``bits`` work on Python ints (the host
replay); ``lane_bits`` is the torch version over W lanes, which holds each
uint32 word in an int64 masked to 32 bits (add, shifts and compares raise
on CPU ``torch.uint32``).  kernels/csrc/threefry.cuh is the same cipher in
``__host__ __device__`` C++ (kernel K27 draws with it).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(key, x):
    """The cipher on a key pair and a counter pair: Python ints or int64
    tensors holding uint32 words (broadcasting)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x[0] + ks[0]) & M32
    x1 = (x[1] + ks[1]) & M32
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & M32
    return x0, x1


def prng_key(seed: int) -> tuple:
    """jax.random.PRNGKey(seed) with 64-bit types off."""
    return (0, int(seed) & M32)


def fold_in(key, d: int) -> tuple:
    """jax.random.fold_in(key, d)."""
    return threefry2x32(key, (0, int(d) & M32))


def bits(key) -> int:
    """jax.random.bits(key, dtype=uint32) of a scalar."""
    x0, x1 = threefry2x32(key, (0, 0))
    return x0 ^ x1


def draw(key, lane: int, step: int) -> int:
    """The choice bits of (lane, step) under the run key."""
    return bits(fold_in(fold_in(key, lane), step))


def lane_bits(key, lanes: int, step, device=None) -> torch.Tensor:
    """[lanes] int64 (uint32 values): the choice bits of transition `step`
    for lanes 0..lanes-1.  `key` is a pair of ints or a [2] tensor of
    uint32 words; `step` an int or a 0-dim tensor."""
    if isinstance(key, torch.Tensor):
        device = key.device if device is None else device
        k = key.to(device).view(torch.int32).to(torch.int64) & M32 \
            if key.dtype == torch.uint32 else key.to(device, torch.int64) & M32
        key = (k[0], k[1])
    lane = torch.arange(lanes, dtype=torch.int64, device=device)
    zero = torch.zeros_like(lane)
    k = threefry2x32(key, (zero, lane))
    if isinstance(step, torch.Tensor):
        step = step.to(device, torch.int64) & M32
    else:
        step = int(step) & M32
    k = threefry2x32(k, (zero, zero + step))
    x0, x1 = threefry2x32(k, (zero, zero))
    return x0 ^ x1
