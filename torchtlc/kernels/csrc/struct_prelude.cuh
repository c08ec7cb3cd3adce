// The int32 semantics of the lane IR (torchtlc/struct/lanes.py) as
// __host__ __device__ helpers, for the C++ that torchtlc.struct.emit
// prints: wrapping arithmetic (through uint32), floor division and
// modulo, and the gather index rule (a negative index wraps once, then
// clamps), each as jax.numpy computes it; and tt_clip, jnp.clip(i, 0, hi)
// of a symmetry program's table lookup (struct_reduce.cuh).
#pragma once
#include "common.cuh"

HD int32_t tt_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
HD int32_t tt_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
HD int32_t tt_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
HD int32_t tt_shl(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a << b);
}
HD int32_t tt_floordiv(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
HD int32_t tt_mod(int32_t a, int32_t b) {
  const int32_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
HD int32_t tt_max(int32_t a, int32_t b) { return a > b ? a : b; }
HD int32_t tt_min(int32_t a, int32_t b) { return a < b ? a : b; }
HD int32_t tt_clampidx(int32_t i, int32_t n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}
HD int32_t tt_clip(int32_t i, int32_t hi) {
  return i < 0 ? 0 : (i > hi ? hi : i);
}
