// Counter-based threefry2x32 as __host__ __device__ functions: the random
// walk's choice bits (kernel K27, emitted_sim.cuh), jax's on its default
// settings (jax_threefry_partitionable on, threefry2x32, 64-bit types off),
// as torchtlc/sim/threefry.py states them: 20 rounds in 5 groups of 4,
// rotations 13, 15, 26, 6 and 17, 29, 16, 24 by turns, the key schedule
// (k0, k1, k0 ^ k1 ^ 0x1BD11BDA) injected before the first group and after
// each with the group's index + 1 added to the second word; fold_in(k, d)
// is the cipher of the counter (0, d), both words; a scalar's 32 bits are
// x0 ^ x1 of the counter (0, 0).  nvcc builds it into K27; g++ builds the
// same text for the host tests.
#pragma once
#include "common.cuh"

HD uint32_t tf_rotl(uint32_t v, int r) { return (v << r) | (v >> (32 - r)); }

HD void tf2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
               uint32_t* y0, uint32_t* y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
  for (int g = 0; g < 5; g++) {
    for (int i = 0; i < 4; i++) {
      x0 += x1;
      x1 = tf_rotl(x1, rot[g & 1][i]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

// jax.random.fold_in(key, d)
HD void tf_fold_in(uint32_t k0, uint32_t k1, uint32_t d, uint32_t* o0,
                   uint32_t* o1) {
  tf2x32(k0, k1, 0u, d, o0, o1);
}

// jax.random.bits(key, dtype=uint32) of a scalar
HD uint32_t tf_bits32(uint32_t k0, uint32_t k1) {
  uint32_t a, b;
  tf2x32(k0, k1, 0u, 0u, &a, &b);
  return a ^ b;
}

// the choice bits of transition d of lane `lane` under the run key
HD uint32_t tf_draw(uint32_t k0, uint32_t k1, uint32_t lane, uint32_t d) {
  uint32_t a, b, c, e;
  tf_fold_in(k0, k1, lane, &a, &b);
  tf_fold_in(a, b, d, &c, &e);
  return tf_bits32(c, e);
}
