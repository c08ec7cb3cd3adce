// Kernel K22 "struct_cov_count": the device coverage plane of a
// struct-compiled spec - one popped block's per-site visit increments.
//
// This is the hand-written template; the per-spec part - st_cov_conds,
// which evaluates the ST_NCOND visit conditions of one state, and the
// macros ST_F, ST_W, ST_L, ST_NLABELS, ST_NCOND, ST_NSITES, ST_WIDTHS,
// ST_LANE_ACTION (each lane's action) and ST_COND_SITE (each condition's
// site) - is C++ that torchtlc.struct.emit (cov_source) prints from the
// lane IR of torchtlc/struct/compile.py build_cov, and that includes this
// file last.
//
// K22 replaces the reference's cov_fn (jaxtlc/struct/compile.py:2224-2279:
// an [M, B] stack of visit conditions, a matvec by the row mask, a
// scatter-add into [n_sites] uint32) and the action-prefix fold of
// jaxtlc/struct/backend.py:214-223 (per-lane valid counts folded through
// lane_action).  One thread per popped row i < ck: a row i < n unpacks its
// W words and evaluates the M conditions, each true one a visit of its
// site; every row adds its valid lanes to their actions' sites (the
// reference sums valid with no row mask; the expand stage already cleared
// the lanes of rows >= n).  Counts are gathered per warp (a ballot and a
// popcount per condition and per lane) into a shared [ST_NSITES]
// histogram, and each block adds its nonzero counters to the zeroed
// output with one integer atomicAdd each: order-free, so the result is
// exact and deterministic.
//
// Bound: operations.  The conditions are straight-line integer code (the
// unrolled lane IR of the guards, a few hundred elements a row for the
// shipped specs); a row reads W words and L valid bytes, and the block
// writes ST_NSITES words.
#pragma once
#include <stddef.h>

#include "struct_codec.cuh"

extern "C" int tt_struct_cov_dims(int* out) {
  out[0] = ST_F;
  out[1] = ST_W;
  out[2] = ST_L;
  out[3] = ST_NCOND;
  out[4] = ST_NSITES;
  out[5] = ST_NLABELS;
  return 0;
}

// the visit conditions of popped row `src` into c[0 .. ST_NCOND)
HD void st_cov_eval(const int32_t* __restrict__ K,
                    const uint32_t* __restrict__ src, bool* c) {
  int32_t f[ST_F];
  st_unpack(src, f);
  st_cov_conds(f, K, c);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void struct_cov_kernel(const int32_t* __restrict__ K,
                                  const uint32_t* __restrict__ block, int ck,
                                  int n, const uint8_t* __restrict__ valid,
                                  unsigned int* __restrict__ out) {
  __shared__ unsigned int hist[ST_NSITES];
  for (int t = threadIdx.x; t < ST_NSITES; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lead = (threadIdx.x & 31) == 0;
  bool c[ST_NCOND + 1];
#pragma unroll
  for (int m = 0; m <= ST_NCOND; m++) c[m] = false;
  if (row < n) st_cov_eval(K, block + (size_t)row * ST_W, c);
  const int site[ST_NCOND + 1] = {ST_COND_SITE};
#pragma unroll
  for (int m = 0; m < ST_NCOND; m++) {
    const unsigned b = __ballot_sync(0xffffffffu, c[m]);
    if (lead && b) atomicAdd(&hist[site[m]], (unsigned)__popc(b));
  }
  const int la[ST_L] = {ST_LANE_ACTION};
#pragma unroll
  for (int l = 0; l < ST_L; l++) {
    const bool v = row < ck && valid[(size_t)row * ST_L + l] != 0;
    const unsigned b = __ballot_sync(0xffffffffu, v);
    if (lead && b) atomicAdd(&hist[la[l]], (unsigned)__popc(b));
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ST_NSITES; t += blockDim.x)
    if (hist[t]) atomicAdd(&out[t], hist[t]);
}

// out must hold ST_NSITES zeroed uint32 counters; valid is the expand
// stage's [ck * ST_L] lane flags
extern "C" int tt_struct_cov_count(const void* K, const void* block, int ck,
                                   int n, const void* valid, void* out,
                                   void* stream) {
  const int threads = 128;  // a multiple of the warp: every ballot is full
  const int blocks = (ck + threads - 1) / threads;
  if (blocks > 0)
    struct_cov_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)K, (const uint32_t*)block, ck, n,
        (const uint8_t*)valid, (unsigned int*)out);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the same row function in a loop, for the host tests

extern "C" int host_struct_cov_count(const void* K, const void* block, int ck,
                                     int n, const void* valid, void* out) {
  unsigned int* o = (unsigned int*)out;
  const int site[ST_NCOND + 1] = {ST_COND_SITE};
  const int la[ST_L] = {ST_LANE_ACTION};
  for (int row = 0; row < ck; row++) {
    bool c[ST_NCOND + 1];
    for (int m = 0; m <= ST_NCOND; m++) c[m] = false;
    if (row < n)
      st_cov_eval((const int32_t*)K,
                  (const uint32_t*)block + (size_t)row * ST_W, c);
    for (int m = 0; m < ST_NCOND; m++)
      if (c[m]) o[site[m]]++;
    for (int l = 0; l < ST_L; l++)
      if (((const uint8_t*)valid)[(size_t)row * ST_L + l]) o[la[l]]++;
  }
  return 0;
}
#endif
