"""FP64: 64-bit GF(2) Rabin fingerprints (port of jaxtlc/engine/fingerprint.py).

The Rabin fingerprint of a fixed-length bit string is an affine GF(2) map of
its bits, so ``fp(M) = const ^ XOR_{i in M} basis[i]`` with
``basis[i] = fp(e_i) ^ fp(0)`` computed once on the host (``affine_basis``).
Values equal the reference's ``fp64_host`` / ``fp64_words`` /
``fp64_words_mxu`` bit for bit.

* ``fp64_host`` / ``affine_basis``: the exact host definition (Python ints
  and numpy).
* ``fp64_words_plain``: the torch version - one masked XOR of a basis row
  per message bit, in int64.
* ``fp64_words``: the wrapper.  A CUDA tensor goes to kernel K2
  (torchtlc/kernels/csrc/fp64.cu), a CPU tensor to the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..spec.codec import to_i32

__all__ = [
    "POLYS",
    "DEFAULT_FP_INDEX",
    "DEFAULT_SEED",
    "fp64_host",
    "fp64_words",
    "fp64_words_plain",
    "affine_basis",
    "collision_probability",
    "find_polys",
    "is_irreducible",
]

MASK64 = (1 << 64) - 1

# Table of c such that x^64 + p(c) is irreducible over GF(2) (bit i of c =
# coefficient of x^i); 131 entries, indexed like TLC's fpIndex.  A copy of
# the reference table; find_polys() regenerates it.
POLYS = [
    0x1b, 0x1d, 0x8d, 0xf5, 0x173, 0x175,
    0x1a1, 0x1b3, 0x1cd, 0x1df, 0x23d, 0x251,
    0x283, 0x289, 0x2a1, 0x2a7, 0x2cb, 0x2d3,
    0x32b, 0x347, 0x3a5, 0x3bb, 0x3c9, 0x3cf,
    0x3f3, 0x3ff, 0x40d, 0x425, 0x50f, 0x533,
    0x68b, 0x6af, 0x6c3, 0x6f5, 0x779, 0x77f,
    0x807, 0x861, 0x89d, 0x8e5, 0x90f, 0x939,
    0x993, 0xa0f, 0xa11, 0xa87, 0xad7, 0xaf9,
    0xbad, 0xc05, 0xc1d, 0xc8b, 0xcb1, 0xcf5,
    0xdcb, 0xe07, 0xe23, 0xee3, 0xf09, 0xf69,
    0xf93, 0xfeb, 0x103d, 0x107f, 0x1083, 0x10ad,
    0x10d3, 0x1139, 0x116f, 0x11a9, 0x11d7, 0x11ed,
    0x1281, 0x12a5, 0x12af, 0x12d7, 0x12db, 0x12ed,
    0x150d, 0x151f, 0x1619, 0x1645, 0x1649, 0x1657,
    0x165b, 0x166d, 0x1689, 0x16ef, 0x1709, 0x1747,
    0x174d, 0x1755, 0x175f, 0x177b, 0x1787, 0x17e7,
    0x1979, 0x19b5, 0x19e5, 0x1a1f, 0x1a31, 0x1a4f,
    0x1a75, 0x1a97, 0x1ae3, 0x1b35, 0x1b55, 0x1b7d,
    0x1bbb, 0x1bc9, 0x1c3b, 0x1c5d, 0x1c61, 0x1cb9,
    0x1ccd, 0x1d05, 0x1d3f, 0x1d41, 0x1d6f, 0x1d87,
    0x1df5, 0x1f67, 0x1f83, 0x1fc7, 0x2037, 0x2057,
    0x2067, 0x206d, 0x208f, 0x20f1, 0x2141,
]

DEFAULT_FP_INDEX = 51  # the reference run's fpIndex (launch:8)
DEFAULT_SEED = 0x9E3779B97F4A7C15  # fixed engine seed


# ---------------------------------------------------------------------------
# Polynomial generation (provenance for POLYS)
# ---------------------------------------------------------------------------


def _pmulmod(a: int, b: int, p: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> 64:
            a ^= p
    return r


def _pgcd(a: int, b: int) -> int:
    while b:
        while a and a.bit_length() >= b.bit_length():
            a ^= b << (a.bit_length() - b.bit_length())
        a, b = b, a
    return a


def is_irreducible(p: int) -> bool:
    """Rabin irreducibility test for a degree-64 polynomial over GF(2)."""
    assert p >> 64 == 1
    t = 2  # the polynomial 'x'
    for _ in range(32):
        t = _pmulmod(t, t, p)
    if _pgcd(t ^ 2, p) != 1:
        return False
    for _ in range(32):
        t = _pmulmod(t, t, p)
    return t == 2


def find_polys(n: int = 131):
    """Scan odd constants upward collecting irreducible x^64 + p(c)."""
    out, c = [], 1
    while len(out) < n:
        c += 2
        if is_irreducible((1 << 64) | c):
            out.append(c)
    return out


# ---------------------------------------------------------------------------
# Host-side exact fingerprint and its affine basis
# ---------------------------------------------------------------------------


def fp64_host(bits: int, nbits: int, fp_index: int = DEFAULT_FP_INDEX,
              seed: int = DEFAULT_SEED) -> int:
    """Rabin fingerprint of an nbits-long bit string (bit i of `bits` is
    message bit i), processed LSB-first from `seed` with the reflected
    LFSR: per bit b, s = (s >> 1) ^ ((s ^ b) & 1 ? R : 0)."""
    poly = (1 << 64) | POLYS[fp_index]
    refl = _reflect64(poly & MASK64)
    s = seed & MASK64
    for i in range(nbits):
        b = (bits >> i) & 1
        low = (s ^ b) & 1
        s >>= 1
        if low:
            s ^= refl
    return s


def _reflect64(v: int) -> int:
    r = 0
    for i in range(64):
        if (v >> i) & 1:
            r |= 1 << (63 - i)
    return r


@functools.lru_cache(maxsize=None)
def affine_basis(nbits: int, fp_index: int = DEFAULT_FP_INDEX,
                 seed: int = DEFAULT_SEED):
    """(const, basis): fp(M) = const ^ XOR_{i: bit i of M set} basis[i].
    numpy uint32: const (2,), basis (nbits, 2); column 0 = low 32 bits."""
    c = fp64_host(0, nbits, fp_index, seed)
    basis = np.zeros((nbits, 2), dtype=np.uint32)
    for i in range(nbits):
        f = fp64_host(1 << i, nbits, fp_index, seed) ^ c
        basis[i, 0] = f & 0xFFFFFFFF
        basis[i, 1] = f >> 32
    const = np.array([c & 0xFFFFFFFF, c >> 32], dtype=np.uint32)
    return const, basis


def _signed64(u: int) -> int:
    return u - (1 << 64) if u >> 63 else u


def fp64_words_plain(words: torch.Tensor, nbits: int,
                     fp_index: int = DEFAULT_FP_INDEX,
                     seed: int = DEFAULT_SEED):
    """Torch fingerprint of packed states: [N, W] int32 words (message bit
    i is bit i%32 of word i//32) -> (lo, hi) [N] int32 bit patterns.  The
    64-bit state is one int64; each message bit XORs its basis row in."""
    const, basis = affine_basis(nbits, fp_index, seed)
    w = words.to(torch.int64) & 0xFFFFFFFF
    acc = torch.full(w.shape[:-1], _signed64(
        (int(const[1]) << 32) | int(const[0])), dtype=torch.int64,
        device=words.device)
    for i in range(nbits):
        bit = ((w[..., i // 32] >> (i % 32)) & 1).bool()
        row = _signed64((int(basis[i, 1]) << 32) | int(basis[i, 0]))
        acc = torch.where(bit, acc ^ row, acc)
    lo = acc & 0xFFFFFFFF
    hi = (acc >> 32) & 0xFFFFFFFF
    return to_i32(lo), to_i32(hi)


@functools.lru_cache(maxsize=None)
def _basis_words(nbits: int, fp_index: int, seed: int,
                 device: str) -> torch.Tensor:
    """[nbits + 1, 2] int32 on `device`: the basis rows, then const as the
    last row (the layout kernel K2 reads)."""
    const, basis = affine_basis(nbits, fp_index, seed)
    words = np.concatenate([basis, const[None]], axis=0).view(np.int32)
    return torch.from_numpy(words).to(device)


def fp64_words(words: torch.Tensor, nbits: int,
               fp_index: int = DEFAULT_FP_INDEX, seed: int = DEFAULT_SEED):
    """Fingerprint of packed states, [N, W] int32 -> (lo, hi) [N] int32.
    CUDA tensors run kernel K2; CPU tensors the plain version."""
    if not words.is_cuda:
        return fp64_words_plain(words, nbits, fp_index, seed)
    from ..kernels import ops

    return ops.fp64(words, _basis_words(nbits, fp_index, seed,
                                        str(words.device)), nbits)


def collision_probability(generated: int, distinct: int) -> float:
    """TLC's "calculated (optimistic)" fingerprint-collision estimate,
    distinct * (generated - distinct) / 2^64 (MC.out:41: 3.7E-9)."""
    return float(distinct) * float(generated - distinct) / float(1 << 64)
