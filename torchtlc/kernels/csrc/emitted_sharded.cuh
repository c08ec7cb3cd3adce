// Kernel K21 "emitted_expand_sharded": the sharded engine's expand over an
// emitted backend - a struct spec's step (struct_expand.cuh) or a generic
// spec's (gen_expand.cuh); both templates include this header.  It also
// holds st_lanes_row, the lane body K21 shares with K17.
//
// K21 replaces jaxtlc/engine/sharded.py:510-556 over an emitted backend
// (the vmapped LaneCompiler step, jaxtlc/struct/backend.py:169 and :173,
// or gen_backend's step, jaxtlc/engine/backend.py:480): the pops of all D
// shards in one launch.  Shard d's queue holds raw field rows, so row r of
// shard d is queue[d, (qhead[d] + r) % (qrows - 1)] with no unpack.  One
// thread per popped row: run the emitted step over its L lanes, mask the
// lanes by the pop (r < npop[d]) and afail/ovf by validity, evaluate the
// invariants in the immediate mode (their rows stay 0 in the deferred
// mode, where the owner checks its fresh claimants with K18), pack each
// candidate, write its raw fields for the route, and count it into a
// shared-memory per-action histogram of its shard (one integer atomicAdd
// per label per block: order-free, so deterministic; a block never spans
// two shards).  Outputs have K1's sharded shapes: packed [D*ck*L, W],
// flags [3 + ST_NINV, D*ck*L] (valid, afail, ovf, one "invariant k fails"
// row each), action [D*ck*L], gen [D, ST_NLABELS] (accumulated), fields
// [D*ck*L, F], and the packed popped rows block [D*ck, W] when the caller
// passes one.
//
// Under symmetry and POR reduction (the spec's text prints ST_SYM 1 /
// ST_POR 1, struct_reduce.cuh) K21 prunes each row's lanes (K26's
// st_por_prune, after afail, ovf and the deadlock-relevant valid flags of
// the pre-pruning lanes) and canonicalizes every candidate (K24's
// st_canon_row) before it checks, writes and packs it, as the reference's
// sharded expand does (jaxtlc/engine/sharded.py:527-542); it counts no
// pruned lanes and runs no orbit check (the reference's sharded engine
// carries neither).
//
// Bound: operations.  A row's step is the unrolled lane IR (a few hundred
// to a few thousand integer statements); the bytes - F fields in, L * (W
// + F words + 3 + ST_NINV flag bytes + an action) out - are small beside
// it.  Every intermediate stays in registers; K is read through the cache.
#pragma once

#include "struct_reduce.cuh"

// The lane body K17 and K21 share, for one row's fields f: run the
// emitted step over its L lanes, mask the lanes by the pop (live) and
// afail/ovf by validity, prune the valid lanes (K26, kPor: afail and ovf
// keep the pre-pruning lanes, so a pruned trapping lane still halts),
// then per lane canonicalize the candidate (K24, kSym: every lane, valid
// or not), evaluate the invariants (their rows stay 0 with kDeferred),
// fold the candidate into the runtime certificate (cert(s, valid): K23's
// st_cert_row under K17's kCert, a no-op otherwise), pack it, write its
// action and count it.  The successor fields go to `fields` with
// kDeferred (K17's flat) or kFields (K21's rows for the route).  idx0 is
// the row's first candidate, ncand the flag-row stride; count(a) adds one
// generated successor of action a.  Returns the lanes K26 pruned.
template <bool kDeferred, bool kFields, bool kSym, bool kPor, typename Count,
          typename Cert>
HD int st_lanes_row(const int32_t* __restrict__ K, const int32_t* f,
                    bool live, long long idx0, long long ncand,
                    uint32_t* __restrict__ packed,
                    uint8_t* __restrict__ flags,
                    int32_t* __restrict__ action,
                    int32_t* __restrict__ fields, Count& count, Cert& cert) {
  int32_t succ[ST_L * ST_F];
  bool valid[ST_L], ovf[ST_L], afail[ST_L];
  st_step(f, K, succ, valid, ovf, afail);
  const int lane_action[ST_L] = {ST_LANE_ACTION};
  bool keep[ST_L];
  for (int l = 0; l < ST_L; l++) keep[l] = valid[l] && live;
  for (int l = 0; l < ST_L; l++) {
    const long long idx = idx0 + l;
    flags[ncand + idx] = afail[l] && keep[l];
    flags[2 * ncand + idx] = ovf[l] && keep[l];
  }
  const int pruned = kPor ? st_por_prune(keep) : 0;
  for (int l = 0; l < ST_L; l++) {
    const long long idx = idx0 + l;
    const int32_t* s = succ + l * ST_F;
    int32_t canon[ST_F];
    if (kSym) {
      int32_t raw[ST_F];
      for (int j = 0; j < ST_F; j++) raw[j] = s[j];
      st_canon_row(K, raw, canon);
      s = canon;
    }
    const bool v = keep[l];
    flags[idx] = v;
    if (kDeferred) {
      for (int k = 0; k < ST_NINV; k++) flags[(3 + k) * ncand + idx] = 0;
    } else {
      const uint32_t bits = st_inv_bits(s, K);
      for (int k = 0; k < ST_NINV; k++)
        flags[(3 + k) * ncand + idx] = v && !((bits >> k) & 1u);
    }
    if (kDeferred || kFields)
      for (int j = 0; j < ST_F; j++) fields[idx * ST_F + j] = s[j];
    cert(s, v);  // before the pack, which would wrap an escaped value
    st_pack(s, packed + idx * ST_W);
    action[idx] = lane_action[l];
    if (v) count(lane_action[l]);
  }
  return pruned;
}

// queue row r of shard d, copied: queue [D, qrows, F], row qrows - 1 the dump
HD void emitted_sharded_pop(const int32_t* __restrict__ queue,
                            long long qrows, long long qhead, int d, int r,
                            int32_t* f) {
  const long long slot = (qhead + r) % (qrows - 1);
  const int32_t* src = queue + ((long long)d * qrows + slot) * ST_F;
  for (int j = 0; j < ST_F; j++) f[j] = src[j];
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

struct EsSharedHist {
  unsigned int* h;
  __device__ void operator()(int a) { atomicAdd(&h[a], 1u); }
};

// grid (ceil(ck / blockDim), D): blockIdx.y is the shard
template <bool kDeferred>
__global__ void emitted_expand_sharded_kernel(
    const int32_t* __restrict__ K, const int32_t* __restrict__ queue,
    long long qrows, const long long* __restrict__ qhead,
    const long long* __restrict__ npop, int ck,
    uint32_t* __restrict__ packed, uint8_t* __restrict__ flags,
    int32_t* __restrict__ action, int32_t* __restrict__ fields,
    uint32_t* __restrict__ block, unsigned long long* __restrict__ gen) {
  __shared__ unsigned int hist[ST_NLABELS];
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const int d = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < ck) {
    int32_t f[ST_F];
    emitted_sharded_pop(queue, qrows, qhead[d], d, r, f);
    const long long row = (long long)d * ck + r;
    EsSharedHist count{hist};
    StCert<false> none;
    st_lanes_row<kDeferred, true, (bool)ST_SYM, (bool)ST_POR>(
        K, f, r < npop[d], row * ST_L, (long long)gridDim.y * ck * ST_L,
        packed, flags, action, fields, count, none);
    if (block) st_pack(f, block + row * ST_W);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x)
    if (hist[t])
      atomicAdd(&gen[(size_t)d * ST_NLABELS + t], (unsigned long long)hist[t]);
}

// gen holds D * ST_NLABELS counters (added to); block may be NULL
extern "C" int tt_emitted_expand_sharded(const void* K, const void* queue,
                                         long long qrows, const void* qhead,
                                         const void* npop, int D, int ck,
                                         int deferred, void* packed,
                                         void* flags, void* action,
                                         void* fields, void* block, void* gen,
                                         void* stream) {
  const int threads = 128;
  const dim3 grid((ck + threads - 1) / threads, D);
  auto kernel = deferred ? emitted_expand_sharded_kernel<true>
                         : emitted_expand_sharded_kernel<false>;
  if (ck > 0 && D > 0)
    kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)K, (const int32_t*)queue, qrows,
        (const long long*)qhead, (const long long*)npop, ck,
        (uint32_t*)packed, (uint8_t*)flags, (int32_t*)action,
        (int32_t*)fields, (uint32_t*)block, (unsigned long long*)gen);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the same row function in loops, for the host tests

struct EsHostGen {
  unsigned long long* g;
  void operator()(int a) { g[a]++; }
};

extern "C" int host_emitted_expand_sharded(const void* K, const void* queue,
                                           long long qrows, const void* qhead,
                                           const void* npop, int D, int ck,
                                           int deferred, void* packed,
                                           void* flags, void* action,
                                           void* fields, void* block,
                                           void* gen) {
  const long long ncand = (long long)D * ck * ST_L;
  for (int d = 0; d < D; d++) {
    EsHostGen count{(unsigned long long*)gen + (size_t)d * ST_NLABELS};
    StCert<false> none;
    for (int r = 0; r < ck; r++) {
      int32_t f[ST_F];
      emitted_sharded_pop((const int32_t*)queue, qrows,
                          ((const long long*)qhead)[d], d, r, f);
      const long long row = (long long)d * ck + r;
      const bool live = r < ((const long long*)npop)[d];
      if (deferred)
        st_lanes_row<true, true, (bool)ST_SYM, (bool)ST_POR>(
            (const int32_t*)K, f, live, row * ST_L, ncand, (uint32_t*)packed,
            (uint8_t*)flags, (int32_t*)action, (int32_t*)fields, count,
            none);
      else
        st_lanes_row<false, true, (bool)ST_SYM, (bool)ST_POR>(
            (const int32_t*)K, f, live, row * ST_L, ncand, (uint32_t*)packed,
            (uint8_t*)flags, (int32_t*)action, (int32_t*)fields, count,
            none);
      if (block) st_pack(f, (uint32_t*)block + row * ST_W);
    }
  }
  return 0;
}
#endif
