// Kernel K20 "gen_state_masks": the property operands of a generic spec's
// temporal check, evaluated on every captured state.
//
// This is the hand-written template; the per-spec part - st_preds, which
// evaluates ST_NPRED predicates on one state's fields, and the macros
// ST_F, ST_W, ST_NPRED, ST_WIDTHS - is C++ that torchtlc.struct.emit
// (masks_source) prints from the lane IR of the predicates compiled by
// torchtlc.gen.kernel.compile_expr, and that includes this file last.
//
// K20 replaces jaxtlc/live/check.py:205-212 - compile_expr of p and q,
// vmapped over graph.states by jaxtlc/live/capture.py eval_state_masks.
// For KubeAPI kernel K15 hard-codes its predicates; here they come from
// the spec, so K20 is emitted like K19.  One thread per captured state:
// unpack its W words, evaluate every predicate, write one byte into each
// predicate's plane (out [ST_NPRED, V]).
//
// Bound: bytes for small predicates (W words in, ST_NPRED bytes out a
// state), operations for large ones.
#pragma once
#include <stddef.h>

#include "struct_codec.cuh"

HD void gen_masks_row(const int32_t* __restrict__ K,
                      const uint32_t* __restrict__ src, long long i,
                      long long V, uint8_t* __restrict__ out) {
  int32_t f[ST_F];
  st_unpack(src, f);
  bool p[ST_NPRED];
  st_preds(f, K, p);
  for (int k = 0; k < ST_NPRED; k++) out[k * V + i] = p[k];
}

extern "C" int tt_gen_masks_dims(int* out) {
  out[0] = ST_F;
  out[1] = ST_W;
  out[2] = ST_NPRED;
  out[3] = ST_NK;
  return 0;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void gen_state_masks_kernel(const int32_t* __restrict__ K,
                                       const uint32_t* __restrict__ states,
                                       long long V,
                                       uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < V) gen_masks_row(K, states + (size_t)i * ST_W, i, V, out);
}

extern "C" int tt_gen_state_masks(const void* K, const void* states,
                                  long long V, void* out, void* stream) {
  const int threads = 256;
  const long long blocks = (V + threads - 1) / threads;
  if (blocks > 0)
    gen_state_masks_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        (const int32_t*)K, (const uint32_t*)states, V, (uint8_t*)out);
  return (int)cudaGetLastError();
}

#else  // the g++ build, for the host tests

extern "C" int host_gen_state_masks(const void* K, const void* states,
                                    long long V, void* out) {
  for (long long i = 0; i < V; i++)
    gen_masks_row((const int32_t*)K, (const uint32_t*)states + (size_t)i * ST_W,
                  i, V, (uint8_t*)out);
  return 0;
}
#endif
