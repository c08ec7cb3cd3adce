// Kernel K29 "struct_pred_matrix" and kernel K30 "struct_certify": the
// evidence filter and the certify pass of invariant inference.
//
// This is the hand-written template; the per-spec part - st_step (the
// spec's step, as spec_source prints it), one st_pred_k a candidate
// predicate, st_preds (the P predicates of one row as bits in ST_NPW
// uint32 words) and the macros ST_F, ST_W, ST_L, ST_NPRED, ST_NPW, ST_NK,
// ST_WIDTHS - is C++ that torchtlc.struct.emit (infer_source) prints from
// the lane IR of the spec's step and of the candidates, and that includes
// this file last.  The evidence is rows of decoded fields [S, ST_F] int32,
// so neither kernel unpacks.
//
// K29 replaces jaxtlc/infer/filter.py:71 make_filter_fn (the P candidate
// lane functions vmapped over an evidence block, [P, B] bool) and the
// driver's fold of it (jaxtlc/infer/driver.py:157, alive &=
// matrix.all(axis=1)).  One thread a row evaluates every predicate.  The
// matrix form writes one byte into each predicate's plane, out [P, S]
// uint8, as K20 does; the fold form never writes the planes: each warp
// ANDs its rows' words (__reduce_and_sync), lane 0 ANDs them into a shared
// bitset of ST_NPW words, and each block ANDs that into the all-ones
// alive [ST_NPW] uint32 with one atomicAnd a word it clears bits of.  Rows
// are launched as they are: the reference pads a block with replicas of
// its first row, which cannot change a column it keeps.
//
// K30 replaces jaxtlc/infer/certify.py:38 make_certify_fn.  One thread a
// row: pre = the predicates on the row, the spec's step into an
// [ST_L, ST_F] frame in the thread's stack (as K27 holds its successors),
// then for each valid lane post = the predicates on the successor and the
// escape bits |= pre & ~post.  afail and ovf are ignored, as the reference
// ignores them.  The block ORs its rows' bits as K29's fold ANDs them
// (__reduce_or_sync, a shared bitset, one atomicOr a nonzero word) into
// the zeroed escaped [ST_NPW] uint32.  Every bitset is ST_NPW words: the
// pool runs to 1,446 candidates (RaftElection), so no mask is one word.
//
// Bound: operations.  A row costs the P predicates (a few to a few dozen
// integer statements each; K30 adds the step and L more evaluations of
// them); the bytes - ST_F fields in a row, one byte a predicate out in the
// matrix form, ST_NPW words a block in the folds - are small beside it.
// Each word of predicates is one out-of-line function (st_pred_word_g),
// so nvcc compiles P / 32 small bodies and not one that grows with P.
#pragma once
#include <stddef.h>

#include "common.cuh"

// st_preds needs one word at least: a pool of 0 candidates launches nothing
#define INF_NPW (ST_NPW > 0 ? ST_NPW : 1)

extern "C" int tt_struct_infer_dims(int* out) {
  out[0] = ST_F;
  out[1] = ST_L;
  out[2] = ST_NPRED;
  out[3] = ST_NK;
  return 0;
}

// K29's matrix form for row i of S
HD void inf_matrix_row(const int32_t* __restrict__ K,
                       const int32_t* __restrict__ f, long long i,
                       long long S, uint8_t* __restrict__ out) {
  uint32_t w[INF_NPW];
  st_preds(f, K, w);
  for (int k = 0; k < ST_NPRED; k++)
    out[(size_t)k * S + i] = (uint8_t)((w[k >> 5] >> (k & 31)) & 1u);
}

// K30's escape bits of one row into esc[INF_NPW]
HD void inf_certify_row(const int32_t* __restrict__ K,
                        const int32_t* __restrict__ f, uint32_t* esc) {
  uint32_t pre[INF_NPW], post[INF_NPW];
  st_preds(f, K, pre);
  for (int j = 0; j < INF_NPW; j++) esc[j] = 0u;
  int32_t succ[ST_L * ST_F];
  bool valid[ST_L], ovf[ST_L], afail[ST_L];
  st_step(f, K, succ, valid, ovf, afail);
  for (int l = 0; l < ST_L; l++) {
    if (!valid[l]) continue;
    st_preds(succ + l * ST_F, K, post);
    for (int j = 0; j < ST_NPW; j++) esc[j] |= pre[j] & ~post[j];
  }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void struct_pred_matrix_kernel(const int32_t* __restrict__ K,
                                          const int32_t* __restrict__ fields,
                                          long long S,
                                          uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < S) inf_matrix_row(K, fields + (size_t)i * ST_F, i, S, out);
}

__global__ void struct_pred_alive_kernel(const int32_t* __restrict__ K,
                                         const int32_t* __restrict__ fields,
                                         long long S,
                                         unsigned int* __restrict__ alive) {
  __shared__ unsigned int acc[INF_NPW];
  for (int t = threadIdx.x; t < INF_NPW; t += blockDim.x) acc[t] = ~0u;
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t w[INF_NPW];
  if (i < S) {
    st_preds(fields + (size_t)i * ST_F, K, w);
  } else {
    for (int j = 0; j < INF_NPW; j++) w[j] = ~0u;
  }
  const bool lead = (threadIdx.x & 31) == 0;
  for (int j = 0; j < ST_NPW; j++) {
    const unsigned r = __reduce_and_sync(0xffffffffu, w[j]);
    if (lead && r != ~0u) atomicAnd(&acc[j], r);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ST_NPW; t += blockDim.x)
    if (acc[t] != ~0u) atomicAnd(&alive[t], acc[t]);
}

__global__ void struct_certify_kernel(const int32_t* __restrict__ K,
                                      const int32_t* __restrict__ fields,
                                      long long S,
                                      unsigned int* __restrict__ escaped) {
  __shared__ unsigned int acc[INF_NPW];
  for (int t = threadIdx.x; t < INF_NPW; t += blockDim.x) acc[t] = 0u;
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t esc[INF_NPW];
  if (i < S) {
    inf_certify_row(K, fields + (size_t)i * ST_F, esc);
  } else {
    for (int j = 0; j < INF_NPW; j++) esc[j] = 0u;
  }
  const bool lead = (threadIdx.x & 31) == 0;
  for (int j = 0; j < ST_NPW; j++) {
    const unsigned r = __reduce_or_sync(0xffffffffu, esc[j]);
    if (lead && r) atomicOr(&acc[j], r);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ST_NPW; t += blockDim.x)
    if (acc[t]) atomicOr(&escaped[t], acc[t]);
}

// the block sizes are multiples of the warp: every warp reduction is full
extern "C" int tt_struct_pred_matrix(const void* K, const void* fields,
                                     long long S, void* out, void* stream) {
  const int threads = 256;
  const long long blocks = (S + threads - 1) / threads;
  if (blocks > 0)
    struct_pred_matrix_kernel<<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
        (const int32_t*)K, (const int32_t*)fields, S, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// alive must hold ST_NPW all-ones words
extern "C" int tt_struct_pred_alive(const void* K, const void* fields,
                                    long long S, void* alive, void* stream) {
  const int threads = 256;
  const long long blocks = (S + threads - 1) / threads;
  if (blocks > 0)
    struct_pred_alive_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const int32_t*)K, (const int32_t*)fields, S,
        (unsigned int*)alive);
  return (int)cudaGetLastError();
}

// escaped must hold ST_NPW zeroed words
extern "C" int tt_struct_certify(const void* K, const void* fields,
                                 long long S, void* escaped, void* stream) {
  const int threads = 128;
  const long long blocks = (S + threads - 1) / threads;
  if (blocks > 0)
    struct_certify_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (const int32_t*)K, (const int32_t*)fields, S,
        (unsigned int*)escaped);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the same row functions in a loop, for the host tests

extern "C" int host_struct_pred_matrix(const void* K, const void* fields,
                                       long long S, void* out) {
  for (long long i = 0; i < S; i++)
    inf_matrix_row((const int32_t*)K, (const int32_t*)fields + (size_t)i * ST_F,
                   i, S, (uint8_t*)out);
  return 0;
}

extern "C" int host_struct_pred_alive(const void* K, const void* fields,
                                      long long S, void* alive) {
  uint32_t* a = (uint32_t*)alive;
  uint32_t w[INF_NPW];
  for (long long i = 0; i < S; i++) {
    st_preds((const int32_t*)fields + (size_t)i * ST_F, (const int32_t*)K, w);
    for (int j = 0; j < ST_NPW; j++) a[j] &= w[j];
  }
  return 0;
}

extern "C" int host_struct_certify(const void* K, const void* fields,
                                   long long S, void* escaped) {
  uint32_t* e = (uint32_t*)escaped;
  uint32_t esc[INF_NPW];
  for (long long i = 0; i < S; i++) {
    inf_certify_row((const int32_t*)K,
                    (const int32_t*)fields + (size_t)i * ST_F, esc);
    for (int j = 0; j < ST_NPW; j++) e[j] |= esc[j];
  }
  return 0;
}
#endif
