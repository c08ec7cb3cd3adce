// Kernels K5 "slab" and K6 "slab order": the sort-free in-batch dedup.
//
// K5 replaces jaxtlc/engine/fpset.py:_slab_dedup_core (:659), per pass:
//   slab_scatter  atomicMax of lane + 1 into the slab cell of every
//                 unresolved lane (max is order-free: the result does not
//                 depend on the order the atomics land in);
//   slab_resolve  each unresolved lane reads its cell's winner: the class
//                 resolves when the winner holds its fingerprint, and the
//                 winner itself becomes the representative; on the last
//                 pass, claimant flag = representative or unresolved;
// then, after a torch.cumsum of the flags (the prefix scan),
//   slab_compact  claimant lanes into their prefix positions < R (every
//                 target is distinct, so the scatter is deterministic).
// K6 replaces the gathers and the last-of-group mask of _order_and_dedup
// (:726) around the R-wide stable torch.sort:
//   slab_order    claimant row -> its int64 key (padding: the largest key);
//   slab_mark     sorted row -> its lane (sentinel N on padding) and the
//                 last-of-group active flag.
// n_cand stays on the device (the last prefix sum).
//
// Bound: bytes.  At N candidates with an m-cell slab: keys read twice (8 B),
// one random 4 B atomic and one random 4 B read per valid lane (the slab's
// zeroing, 4 B a cell, is a memset outside these kernels), the flags,
// the prefix sums (8 B) and R-wide gathers; random 4 B accesses cost a
// 32 B sector each, which sets the real floor above the byte count.
#include <cuda_runtime.h>

#include "slab.cuh"

__global__ void slab_scatter_kernel(const int64_t* __restrict__ keys,
                                    long long N, int pass, uint32_t mmask,
                                    uint8_t* __restrict__ unres,
                                    uint32_t* __restrict__ slab) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  bool u;
  if (pass == 0) {  // every valid lane starts unresolved
    u = keys[i] != fp_make_key(0u, 0u);
    unres[i] = u;
  } else {
    u = unres[i] != 0;
  }
  if (u) atomicMax(&slab[slab_cell(keys[i], pass, mmask)], (uint32_t)(i + 1));
}

__global__ void slab_resolve_kernel(const int64_t* __restrict__ keys,
                                    long long N, int pass, uint32_t mmask,
                                    const uint32_t* __restrict__ slab,
                                    uint8_t* __restrict__ unres,
                                    uint8_t* __restrict__ rep,
                                    uint8_t* __restrict__ cand) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  bool r = pass == 0 ? false : rep[i] != 0;
  bool u = unres[i] != 0;
  if (u)
    u = slab_still_unresolved(keys, slab[slab_cell(keys[i], pass, mmask)], i,
                              N, r);
  unres[i] = u;
  rep[i] = r;
  if (cand != nullptr) cand[i] = r || u;
}

__global__ void slab_compact_kernel(const uint8_t* __restrict__ cand,
                                    const long long* __restrict__ pos,
                                    long long N, int R,
                                    int32_t* __restrict__ c_lane) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N && cand[i] && pos[i] - 1 < R) c_lane[pos[i] - 1] = (int32_t)i;
}

__global__ void slab_order_kernel(const int64_t* __restrict__ keys,
                                  const int32_t* __restrict__ c_lane, int R,
                                  const long long* __restrict__ n_cand,
                                  int64_t* __restrict__ ord_key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < R) ord_key[i] = slab_order_key(keys, c_lane, i, *n_cand);
}

__global__ void slab_mark_kernel(const int64_t* __restrict__ s_key,
                                 const int64_t* __restrict__ perm,
                                 const int32_t* __restrict__ c_lane, int R,
                                 const long long* __restrict__ n_cand,
                                 long long N, int64_t* __restrict__ c_idx,
                                 uint8_t* __restrict__ active) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < R)
    slab_mark_row(s_key, perm, c_lane, i, R, *n_cand, N, c_idx, active);
}

static unsigned grid_of(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

extern "C" int tt_slab_scatter(const void* keys, long long N, int pass,
                               unsigned mmask, void* unres, void* slab,
                               void* stream) {
  if (N > 0)
    slab_scatter_kernel<<<grid_of(N, 256), 256, 0, (cudaStream_t)stream>>>(
        (const int64_t*)keys, N, pass, mmask, (uint8_t*)unres,
        (uint32_t*)slab);
  return (int)cudaGetLastError();
}

extern "C" int tt_slab_resolve(const void* keys, long long N, int pass,
                               unsigned mmask, const void* slab, void* unres,
                               void* rep, void* cand, void* stream) {
  if (N > 0)
    slab_resolve_kernel<<<grid_of(N, 256), 256, 0, (cudaStream_t)stream>>>(
        (const int64_t*)keys, N, pass, mmask, (const uint32_t*)slab,
        (uint8_t*)unres, (uint8_t*)rep, (uint8_t*)cand);
  return (int)cudaGetLastError();
}

extern "C" int tt_slab_compact(const void* cand, const void* pos, long long N,
                               int R, void* c_lane, void* stream) {
  if (N > 0)
    slab_compact_kernel<<<grid_of(N, 256), 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)cand, (const long long*)pos, N, R, (int32_t*)c_lane);
  return (int)cudaGetLastError();
}

extern "C" int tt_slab_order(const void* keys, const void* c_lane, int R,
                             const void* n_cand, void* ord_key, void* stream) {
  slab_order_kernel<<<grid_of(R, 256), 256, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const int32_t*)c_lane, R,
      (const long long*)n_cand, (int64_t*)ord_key);
  return (int)cudaGetLastError();
}

extern "C" int tt_slab_mark(const void* s_key, const void* perm,
                            const void* c_lane, int R, const void* n_cand,
                            long long N, void* c_idx, void* active,
                            void* stream) {
  slab_mark_kernel<<<grid_of(R, 256), 256, 0, (cudaStream_t)stream>>>(
      (const int64_t*)s_key, (const int64_t*)perm, (const int32_t*)c_lane, R,
      (const long long*)n_cand, N, (int64_t*)c_idx, (uint8_t*)active);
  return (int)cudaGetLastError();
}
