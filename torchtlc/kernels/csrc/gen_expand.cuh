// Kernel K19 "gen_expand": the expand half of the generic frontend's
// engine body, and the generic backend's expand route.
//
// This is the hand-written template; the per-spec part - st_step, the
// invariants st_inv_k / st_inv_bits and the macros ST_F, ST_W, ST_L,
// ST_NINV, ST_NLABELS, ST_WIDTHS, ST_LANE_ACTION - is C++ that
// torchtlc.struct.emit prints from the lane IR of torchtlc.gen.kernel's
// compiled step and that includes this file last.  nvcc builds the pair
// for sm_90a; g++ builds the same text (the host launcher at the end) for
// the CPU tests.
//
// K19 replaces jaxtlc/gen/engine.py:130-150 - GenCodec.unpack, the
// vmapped lane kernel (jaxtlc/gen/kernel.py:267 make_gen_kernel, its
// guards and updates compiled by :71 compile_expr), the invariant loop
// over every valid candidate and GenCodec.pack - with the per-action
// generated counts of :182-189 and the candidates of the body's verdict
// (:140-150, :216-227).  One thread per popped row: unpack its W words,
// run the emitted L lanes, mask them by the pop (row < n), evaluate every
// invariant on every valid candidate, pack each candidate, and count the
// valid ones per action in a shared-memory histogram (one integer atomic
// per label per block).  It also folds the verdict's candidates: `first`
// gets, with integer atomicMin (order-free, so deterministic), per
// invariant k the lowest failing flat candidate (first[k]), the lowest
// overflowing flat candidate (first[ST_NINV]) and the lowest dead row
// (first[ST_NINV + 1]) - the reference's argmax over its flag rows - so
// the host reads one bundle of scalars a body.  GEN_NONE marks "none".
//
// Outputs: packed [ck*L, W]; flags [3 + ST_NINV, ck*L] (valid, afail -
// always 0, the subset has no Assert - , overflow & popped, one "invariant
// k fails" row each; the invariant rows stay 0 when inv is 0, the
// enumerator's mode); action [ck*L] (the lane's action); gen [ST_NLABELS]
// (accumulated); first [ST_NINV + 2] (GEN_NONE-initialised).
//
// Bound: operations.  A row's step is straight-line integer code (the
// unrolled lane IR: a few hundred to a thousand statements a row for the
// shipped specs); the bytes - W words in, L * (W words + 3 + ST_NINV flag
// bytes + an action) out - are small beside it.  Every intermediate stays
// in registers; the constant tables (K) are read through the cache.
#pragma once
#include <stddef.h>

#include "struct_codec.cuh"

#define GEN_NONE 0x7fffffff

// K19's work for one popped row: idx0 = row * ST_L is its first
// candidate, ncand = ck * ST_L the flag-row stride.  count(a) adds one
// generated successor of action a; fold(k, i) lowers first[k] to i.
template <typename Count, typename Fold>
HD void gen_expand_row(const int32_t* __restrict__ K,
                       const uint32_t* __restrict__ src, bool live, int row,
                       long long ncand, bool inv, bool deadlock,
                       uint32_t* __restrict__ packed,
                       uint8_t* __restrict__ flags,
                       int32_t* __restrict__ action, Count& count,
                       Fold& fold) {
  int32_t f[ST_F];
  st_unpack(src, f);
  int32_t succ[ST_L * ST_F];
  bool valid[ST_L], ovf[ST_L], afail[ST_L];
  st_step(f, K, succ, valid, ovf, afail);
  const int lane_action[ST_L] = {ST_LANE_ACTION};
  bool any = false;
  for (int l = 0; l < ST_L; l++) {
    const int idx = row * ST_L + l;
    const int32_t* s = succ + l * ST_F;
    const bool v = valid[l] && live;
    const bool o = ovf[l] && live;
    flags[idx] = v;
    flags[ncand + idx] = afail[l] && v;
    flags[2 * ncand + idx] = o;
    if (o) fold(ST_NINV, idx);
    const uint32_t bits = inv && v ? st_inv_bits(s, K) : 0xFFFFFFFFu;
    for (int k = 0; k < ST_NINV; k++) {
      const bool bad = v && !((bits >> k) & 1u);
      flags[(3 + k) * ncand + idx] = bad;
      if (bad) fold(k, idx);
    }
    st_pack(s, packed + (size_t)idx * ST_W);
    action[idx] = lane_action[l];
    if (v) {
      count(lane_action[l]);
      any = true;
    }
  }
  if (deadlock && live && !any) fold(ST_NINV + 1, row);
}

extern "C" int tt_gen_dims(int* out) {
  out[0] = ST_F;
  out[1] = ST_W;
  out[2] = ST_L;
  out[3] = ST_NINV;
  out[4] = ST_NLABELS;
  out[5] = ST_NK;
  return 0;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

struct GenSharedHist {
  unsigned int* h;
  __device__ void operator()(int a) { atomicAdd(&h[a], 1u); }
};

struct GenSharedFold {
  int* m;
  __device__ void operator()(int k, int i) { atomicMin(&m[k], i); }
};

__global__ void gen_expand_kernel(const int32_t* __restrict__ K,
                                  const uint32_t* __restrict__ block, int ck,
                                  int n, int inv, int deadlock,
                                  uint32_t* __restrict__ packed,
                                  uint8_t* __restrict__ flags,
                                  int32_t* __restrict__ action,
                                  unsigned long long* __restrict__ gen,
                                  int* __restrict__ first) {
  __shared__ unsigned int hist[ST_NLABELS];
  __shared__ int sfirst[ST_NINV + 2];
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x) hist[t] = 0;
  for (int t = threadIdx.x; t < ST_NINV + 2; t += blockDim.x)
    sfirst[t] = GEN_NONE;
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < ck) {
    GenSharedHist count{hist};
    GenSharedFold fold{sfirst};
    gen_expand_row(K, block + (size_t)row * ST_W, row < n, row,
                   (long long)ck * ST_L, inv != 0, deadlock != 0, packed,
                   flags, action, count, fold);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x)
    if (hist[t]) atomicAdd(&gen[t], (unsigned long long)hist[t]);
  for (int t = threadIdx.x; t < ST_NINV + 2; t += blockDim.x)
    if (sfirst[t] != GEN_NONE) atomicMin(&first[t], sfirst[t]);
}

// gen holds ST_NLABELS counters (added to), first ST_NINV + 2 words set
// to GEN_NONE by the caller
extern "C" int tt_gen_expand(const void* K, const void* block, int ck, int n,
                             int inv, int deadlock, void* packed, void* flags,
                             void* action, void* gen, void* first,
                             void* stream) {
  const int threads = 128;
  const int blocks = (ck + threads - 1) / threads;
  if (blocks > 0)
    gen_expand_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)K, (const uint32_t*)block, ck, n, inv, deadlock,
        (uint32_t*)packed, (uint8_t*)flags, (int32_t*)action,
        (unsigned long long*)gen, (int*)first);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the same row function in a loop, for the host tests

struct GenHostGen {
  unsigned long long* g;
  void operator()(int a) { g[a]++; }
};

struct GenHostFold {
  int* m;
  void operator()(int k, int i) {
    if (i < m[k]) m[k] = i;
  }
};

extern "C" int host_gen_expand(const void* K, const void* block, int ck,
                               int n, int inv, int deadlock, void* packed,
                               void* flags, void* action, void* gen,
                               void* first) {
  GenHostGen count{(unsigned long long*)gen};
  GenHostFold fold{(int*)first};
  for (int row = 0; row < ck; row++)
    gen_expand_row((const int32_t*)K,
                   (const uint32_t*)block + (size_t)row * ST_W, row < n, row,
                   (long long)ck * ST_L, inv != 0, deadlock != 0,
                   (uint32_t*)packed, (uint8_t*)flags, (int32_t*)action,
                   count, fold);
  return 0;
}
#endif

// the kernels both emitted templates share
#include "struct_inv_rows.cuh"
#include "emitted_sharded.cuh"
