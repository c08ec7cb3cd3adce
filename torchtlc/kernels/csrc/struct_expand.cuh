// Kernels K17 "struct_expand" and K18 "struct_inv_rows": the expand stage
// and the deferred invariant check of a struct-compiled spec.
//
// This is the hand-written template; the per-spec part - st_step, the
// invariants st_inv_k / st_inv_bits and the macros ST_F, ST_W, ST_L,
// ST_NINV, ST_NLABELS, ST_WIDTHS, ST_LANE_ACTION - is C++ that
// torchtlc.struct.emit prints from the spec's lane IR and that includes
// this file last.  nvcc builds the pair for sm_90a; g++ builds the same
// text (the host launchers at the end) for the CPU tests.
//
// K17 replaces the reference's generic expand stage over a struct backend
// (jaxtlc/engine/backend.py:135 make_expand_stage, vmapping the
// LaneCompiler step jaxtlc/struct/compile.py:2159 build_step and the
// invariants :2281 build_invariant, with StructCodec.unpack/pack
// jaxtlc/struct/codec.py:315/:290 and the lane_action fold of the
// per-action generated counts).  One thread per popped row: unpack its W
// words, run the emitted step over all L lanes, mask the lanes by the pop
// (row < n) and afail/ovf by validity, then per lane either evaluate the
// invariants (immediate mode) or write the raw successor fields to `flat`
// (deferred mode, the reference's ExpandOut.flat), pack it, and count it
// into a shared-memory per-action histogram (one integer atomicAdd per
// label per block: order-free, so deterministic).  Outputs have K1's
// shapes: packed [ck*L, W], flags [3 + ST_NINV, ck*L] (valid, afail, ovf,
// one "invariant k fails" row each), action [ck*L], gen [ST_NLABELS].
//
// K18 replaces jaxtlc/engine/backend.py:325 make_deferred_checker over a
// struct backend: one thread per claimant row; a fresh claimant runs the
// emitted invariants on its raw successor (flat[c_idx]) and folds its lane
// into the per-invariant maximum with an integer atomicMax; the last block
// to finish picks the verdict - first wins across the invariants in code
// order, the highest lane within one - as K7 does.
//
// Bound: operations for both.  A row's step is straight-line integer code
// (the unrolled lane IR, a few hundred to a few thousand statements per
// row for the shipped specs); the bytes moved - W words in, L*(W words + 3
// + ST_NINV flag bytes + an action) out - are small beside it.  The design
// keeps every intermediate in registers (the emitter unrolls every lane-IR
// node into scalars); the constant tables stay in device memory (K), read
// through the cache.
#pragma once
#include <stddef.h>

#include "struct_codec.cuh"

#if ST_NINV > 0
#define ST_NINV_ARR ST_NINV
#else
#define ST_NINV_ARR 1
#endif

// K17's work for one popped row: idx0 = row * ST_L is its first candidate,
// ncand = ck * ST_L the flag-row stride; count(a) adds one generated
// successor of action a.
template <bool kDeferred, typename Count>
HD void st_expand_row(const int32_t* __restrict__ K,
                      const uint32_t* __restrict__ src, bool live,
                      long long idx0, long long ncand,
                      uint32_t* __restrict__ packed, uint8_t* __restrict__ flags,
                      int32_t* __restrict__ action, int32_t* __restrict__ flat,
                      Count& count) {
  int32_t f[ST_F];
  st_unpack(src, f);
  int32_t succ[ST_L * ST_F];
  bool valid[ST_L], ovf[ST_L], afail[ST_L];
  st_step(f, K, succ, valid, ovf, afail);
  const int lane_action[ST_L] = {ST_LANE_ACTION};
  for (int l = 0; l < ST_L; l++) {
    const long long idx = idx0 + l;
    const int32_t* s = succ + l * ST_F;
    const bool v = valid[l] && live;
    flags[idx] = v;
    flags[ncand + idx] = afail[l] && v;
    flags[2 * ncand + idx] = ovf[l] && v;
    if (kDeferred) {
      for (int j = 0; j < ST_F; j++) flat[idx * ST_F + j] = s[j];
      for (int k = 0; k < ST_NINV; k++) flags[(3 + k) * ncand + idx] = 0;
    } else {
      const uint32_t bits = st_inv_bits(s, K);
      for (int k = 0; k < ST_NINV; k++)
        flags[(3 + k) * ncand + idx] = v && !((bits >> k) & 1u);
    }
    st_pack(s, packed + idx * ST_W);
    action[idx] = lane_action[l];
    if (v) count(lane_action[l]);
  }
}

// K18's verdict from the per-invariant highest violating lanes (bad_lane[k],
// -1 when none): code code_base + k of the first k that has one, the raw
// successor fields and action of its lane; (0, zeros, -1) when none.
HD void st_inv_pick(const int* bad_lane, const int32_t* __restrict__ flat,
                    const int32_t* __restrict__ action, int code_base,
                    long long* viol, int32_t* state, long long* vaction) {
  long long lane = -1;
  int code = 0;
  for (int k = 0; k < ST_NINV; k++)
    if (code == 0 && bad_lane[k] >= 0) {
      code = code_base + k;
      lane = bad_lane[k];
    }
  *viol = code;
  for (int j = 0; j < ST_F; j++)
    state[j] = code ? flat[lane * ST_F + j] : 0;
  *vaction = code ? action[lane] : -1;
}

extern "C" int tt_struct_dims(int* out) {
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

struct StSharedHist {
  unsigned int* h;
  __device__ void operator()(int a) { atomicAdd(&h[a], 1u); }
};

template <bool kDeferred>
__global__ void struct_expand_kernel(const int32_t* __restrict__ K,
                                     const uint32_t* __restrict__ block,
                                     int ck, int n,
                                     uint32_t* __restrict__ packed,
                                     uint8_t* __restrict__ flags,
                                     int32_t* __restrict__ action,
                                     int32_t* __restrict__ flat,
                                     unsigned long long* __restrict__ gen) {
  __shared__ unsigned int hist[ST_NLABELS];
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < ck) {
    StSharedHist count{hist};
    st_expand_row<kDeferred>(K, block + (size_t)row * ST_W, row < n,
                             (long long)row * ST_L, (long long)ck * ST_L,
                             packed, flags, action, flat, count);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x)
    if (hist[t]) atomicAdd(&gen[t], (unsigned long long)hist[t]);
}

// scratch: [0, ST_NINV) the per-invariant highest bad lane, [ST_NINV] the
// done counter; all start at -1
__global__ void struct_inv_rows_kernel(const int32_t* __restrict__ K,
                                       const int32_t* __restrict__ flat,
                                       long long rows,
                                       const uint8_t* __restrict__ fresh,
                                       const int64_t* __restrict__ c_idx,
                                       const int32_t* __restrict__ action,
                                       int code_base, int* scratch,
                                       long long* __restrict__ viol,
                                       int32_t* __restrict__ state,
                                       long long* __restrict__ vaction) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows && fresh[i]) {
    const long long lane = c_idx[i];
    const uint32_t bits = st_inv_bits(flat + lane * ST_F, K);
    for (int k = 0; k < ST_NINV; k++)
      if (!((bits >> k) & 1u)) atomicMax(&scratch[k], (int)lane);
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(&scratch[ST_NINV], 1) == (int)gridDim.x - 2;
  __syncthreads();
  if (last && threadIdx.x == 0) {
    int bad[ST_NINV_ARR];
    for (int k = 0; k < ST_NINV; k++) bad[k] = atomicAdd(&scratch[k], 0);
    st_inv_pick(bad, flat, action, code_base, viol, state, vaction);
  }
}

// gen must hold ST_NLABELS zeroed (or accumulating) counters; flat is
// written in deferred mode only ([ck*ST_L, ST_F] int32)
extern "C" int tt_struct_expand(const void* K, const void* block, int ck,
                                int n, int deferred, void* packed,
                                void* flags, void* action, void* flat,
                                void* gen, void* stream) {
  const int threads = 128;
  const int blocks = (ck + threads - 1) / threads;
  if (blocks > 0 && deferred)
    struct_expand_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)K, (const uint32_t*)block, ck, n, (uint32_t*)packed,
        (uint8_t*)flags, (int32_t*)action, (int32_t*)flat,
        (unsigned long long*)gen);
  else if (blocks > 0)
    struct_expand_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)K, (const uint32_t*)block, ck, n, (uint32_t*)packed,
        (uint8_t*)flags, (int32_t*)action, (int32_t*)flat,
        (unsigned long long*)gen);
  return (int)cudaGetLastError();
}

extern "C" int tt_struct_inv_rows(const void* K, const void* flat,
                                  long long rows, const void* fresh,
                                  const void* c_idx, const void* action,
                                  int code_base, void* scratch, void* viol,
                                  void* state, void* vaction, void* stream) {
  const int threads = 128;
  const long long blocks = rows > 0 ? (rows + threads - 1) / threads : 1;
  struct_inv_rows_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)K, (const int32_t*)flat, rows, (const uint8_t*)fresh,
      (const int64_t*)c_idx, (const int32_t*)action, code_base,
      (int*)scratch, (long long*)viol, (int32_t*)state, (long long*)vaction);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the same row functions in loops, for the host tests

struct StHostGen {
  unsigned long long* g;
  void operator()(int a) { g[a]++; }
};

extern "C" int host_struct_expand(const void* K, const void* block, int ck,
                                  int n, int deferred, void* packed,
                                  void* flags, void* action, void* flat,
                                  void* gen) {
  StHostGen count{(unsigned long long*)gen};
  const long long ncand = (long long)ck * ST_L;
  for (int row = 0; row < ck; row++) {
    const uint32_t* src = (const uint32_t*)block + (size_t)row * ST_W;
    if (deferred)
      st_expand_row<true>((const int32_t*)K, src, row < n,
                          (long long)row * ST_L, ncand, (uint32_t*)packed,
                          (uint8_t*)flags, (int32_t*)action, (int32_t*)flat,
                          count);
    else
      st_expand_row<false>((const int32_t*)K, src, row < n,
                           (long long)row * ST_L, ncand, (uint32_t*)packed,
                           (uint8_t*)flags, (int32_t*)action,
                           (int32_t*)flat, count);
  }
  return 0;
}

extern "C" int host_struct_inv_rows(const void* K, const void* flat,
                                    long long rows, const void* fresh,
                                    const void* c_idx, const void* action,
                                    int code_base, void* viol, void* state,
                                    void* vaction) {
  int bad[ST_NINV_ARR];
  for (int k = 0; k < ST_NINV_ARR; k++) bad[k] = -1;
  for (long long i = 0; i < rows; i++) {
    if (!((const uint8_t*)fresh)[i]) continue;
    const long long lane = ((const int64_t*)c_idx)[i];
    const uint32_t bits =
        st_inv_bits((const int32_t*)flat + lane * ST_F, (const int32_t*)K);
    for (int k = 0; k < ST_NINV; k++)
      if (!((bits >> k) & 1u) && lane > bad[k]) bad[k] = (int)lane;
  }
  st_inv_pick(bad, (const int32_t*)flat, (const int32_t*)action, code_base,
              (long long*)viol, (int32_t*)state, (long long*)vaction);
  return 0;
}
#endif
