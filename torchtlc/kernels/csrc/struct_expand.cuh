// Kernel K17 "struct_expand": the expand stage of a struct-compiled spec
// (with K18 "struct_inv_rows", K21 "emitted_expand_sharded", the random
// walk's K27 "struct_sim_step" and K28 "sim_fold" and the artifact cache's
// K31 "struct_recheck" from the headers it includes).
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
// K18 (its deferred invariant check, struct_inv_rows.cuh) and K21 (the
// sharded engine's expand, emitted_sharded.cuh, which also holds the lane
// body K17 runs after its unpack) are included before it: the generic
// template includes them too.  K23 (the runtime certificate of a narrowed
// spec, struct_cert.cuh) comes with K18, and K24-K26 (the symmetry and
// POR reduction, struct_reduce.cuh) with K21.  Under the kCert template flag
// (the immediate mode of a backend with a certificate) K17 calls K23's
// st_cert_row on each valid successor before it packs it, as the
// reference checks the raw fields (jaxtlc/struct/backend.py:48-50), and
// ORs the block's result into the zeroed int32 `cert` with
// __syncthreads_or and one atomicOr.  Under kSym and kPor (the text's
// ST_SYM and ST_POR) every lane is canonicalized (K24) and each row's
// lanes are pruned (K26) inside st_lanes_row; the block sums the pruned
// lanes in shared memory and adds them to `pruned` with one atomicAdd.
//
// Bound: operations.  A row's step is straight-line integer code
// (the unrolled lane IR, a few hundred to a few thousand statements per
// row for the shipped specs); the bytes moved - W words in, L*(W words + 3
// + ST_NINV flag bytes + an action) out - are small beside it.  The design
// keeps every intermediate in registers (the emitter unrolls every lane-IR
// node into scalars); the constant tables stay in device memory (K), read
// through the cache.
#pragma once
#include <stddef.h>

#include "struct_codec.cuh"
// the kernels both emitted templates share; emitted_sharded.cuh also holds
// the lane body K17 and K21 share (st_lanes_row)
#include "struct_inv_rows.cuh"
#include "emitted_sharded.cuh"
// the random walk's round (K27, K28), written against the emitted names only
#include "emitted_sim.cuh"
// the artifact cache's invariant re-check over stored rows (K31)
#include "struct_recheck.cuh"

// K17's work for one popped row: idx0 = row * ST_L is its first candidate,
// ncand = ck * ST_L the flag-row stride; count(a) adds one generated
// successor of action a, cert(s, valid) folds a successor into the
// certificate (StCert).  Returns the lanes K26 pruned (kPor).
template <bool kDeferred, bool kSym, bool kPor, typename Count, typename Cert>
HD int st_expand_row(const int32_t* __restrict__ K,
                     const uint32_t* __restrict__ src, bool live,
                     long long idx0, long long ncand,
                     uint32_t* __restrict__ packed, uint8_t* __restrict__ flags,
                     int32_t* __restrict__ action, int32_t* __restrict__ flat,
                     Count& count, Cert& cert) {
  int32_t f[ST_F];
  st_unpack(src, f);
  return st_lanes_row<kDeferred, false, kSym, kPor>(
      K, f, live, idx0, ncand, packed, flags, action, flat, count, cert);
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

template <bool kDeferred, bool kCert, bool kSym, bool kPor>
__global__ void struct_expand_kernel(const int32_t* __restrict__ K,
                                     const uint32_t* __restrict__ block,
                                     int ck, int n,
                                     uint32_t* __restrict__ packed,
                                     uint8_t* __restrict__ flags,
                                     int32_t* __restrict__ action,
                                     int32_t* __restrict__ flat,
                                     unsigned long long* __restrict__ gen,
                                     int* __restrict__ cert,
                                     unsigned long long* __restrict__ pruned) {
  __shared__ unsigned int hist[ST_NLABELS];
  __shared__ unsigned int s_pruned;
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x) hist[t] = 0;
  if (threadIdx.x == 0) s_pruned = 0u;
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  StCert<kCert> c;
  if (row < ck) {
    StSharedHist count{hist};
    const int pr = st_expand_row<kDeferred, kSym, kPor>(
        K, block + (size_t)row * ST_W, row < n, (long long)row * ST_L,
        (long long)ck * ST_L, packed, flags, action, flat, count, c);
    if (kPor && pr) atomicAdd(&s_pruned, (unsigned int)pr);
  }
  if (kCert) {
    if (__syncthreads_or(c.bad) && threadIdx.x == 0) atomicOr(cert, 1);
  } else {
    __syncthreads();
  }
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x)
    if (hist[t]) atomicAdd(&gen[t], (unsigned long long)hist[t]);
  if (kPor && threadIdx.x == 0 && s_pruned)
    atomicAdd(pruned, (unsigned long long)s_pruned);
}

// gen must hold ST_NLABELS zeroed (or accumulating) counters; flat is
// written in deferred mode only ([ck*ST_L, ST_F] int32); cert (immediate
// mode only) is NULL, or one zeroed int32 that K23 sets (kCert); pruned
// is one zeroed counter K26 adds the pruned lanes to (a text with ST_POR
// 1), else NULL.  kSym and kPor are the text's ST_SYM and ST_POR.
extern "C" int tt_struct_expand(const void* K, const void* block, int ck,
                                int n, int deferred, void* packed,
                                void* flags, void* action, void* flat,
                                void* gen, void* cert, void* pruned,
                                void* stream) {
  const int threads = 128;
  const int blocks = (ck + threads - 1) / threads;
  constexpr bool kSym = ST_SYM, kPor = ST_POR;
  if (kPor && pruned == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = deferred ? struct_expand_kernel<true, false, kSym, kPor>
                : cert   ? struct_expand_kernel<false, true, kSym, kPor>
                         : struct_expand_kernel<false, false, kSym, kPor>;
  if (blocks > 0)
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)K, (const uint32_t*)block, ck, n, (uint32_t*)packed,
        (uint8_t*)flags, (int32_t*)action, (int32_t*)flat,
        (unsigned long long*)gen, (int*)cert, (unsigned long long*)pruned);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the same row functions in loops, for the host tests

struct StHostGen {
  unsigned long long* g;
  void operator()(int a) { g[a]++; }
};

// cert (immediate mode only): NULL, or one int32 set to 1 when a valid
// successor breaks a certified bound (K17's kCert form); pruned: NULL, or
// one counter the pruned lanes are added to (a text with ST_POR 1)
extern "C" int host_struct_expand_red(const void* K, const void* block,
                                      int ck, int n, int deferred,
                                      void* packed, void* flags, void* action,
                                      void* flat, void* gen, void* cert,
                                      void* pruned) {
  constexpr bool kSym = ST_SYM, kPor = ST_POR;
  StHostGen count{(unsigned long long*)gen};
  StCert<false> none;
  StCert<true> c;
  const long long ncand = (long long)ck * ST_L;
  unsigned long long pr = 0;
  for (int row = 0; row < ck; row++) {
    const uint32_t* src = (const uint32_t*)block + (size_t)row * ST_W;
    if (deferred)
      pr += st_expand_row<true, kSym, kPor>(
          (const int32_t*)K, src, row < n, (long long)row * ST_L, ncand,
          (uint32_t*)packed, (uint8_t*)flags, (int32_t*)action,
          (int32_t*)flat, count, none);
    else if (cert)
      pr += st_expand_row<false, kSym, kPor>(
          (const int32_t*)K, src, row < n, (long long)row * ST_L, ncand,
          (uint32_t*)packed, (uint8_t*)flags, (int32_t*)action,
          (int32_t*)flat, count, c);
    else
      pr += st_expand_row<false, kSym, kPor>(
          (const int32_t*)K, src, row < n, (long long)row * ST_L, ncand,
          (uint32_t*)packed, (uint8_t*)flags, (int32_t*)action,
          (int32_t*)flat, count, none);
  }
  if (cert && c.bad) *(int*)cert = 1;
  if (pruned) *(unsigned long long*)pruned += pr;
  return 0;
}

extern "C" int host_struct_expand_cert(const void* K, const void* block,
                                       int ck, int n, int deferred,
                                       void* packed, void* flags,
                                       void* action, void* flat, void* gen,
                                       void* cert) {
  return host_struct_expand_red(K, block, ck, n, deferred, packed, flags,
                                action, flat, gen, cert, nullptr);
}

extern "C" int host_struct_expand(const void* K, const void* block, int ck,
                                  int n, int deferred, void* packed,
                                  void* flags, void* action, void* flat,
                                  void* gen) {
  return host_struct_expand_red(K, block, ck, n, deferred, packed, flags,
                                action, flat, gen, nullptr, nullptr);
}

#endif


// the serving plane's batched forms of K17, K27 and K28 (K32, K34, K35),
// in the libraries of the texts that ask for them (a sweep or smoke class:
// ST_BATCHED 1)
#if defined(ST_BATCHED) && ST_BATCHED
#include "emitted_batched.cuh"
#endif
