// Kernels K14 "edge_capture" (edge_search + edge_compact), K15
// "state_masks" and K16 "survive_sweep" (survive_scatter +
// survive_update) of the device liveness plane; the per-element logic is in
// liveness.cuh.
//
// K14 replaces the capture sweep's id resolution and compaction
// (jaxtlc/live/capture.py:187-219): edge_search gives each successor lane
// its id by a binary search over the fingerprint-sorted states (one thread
// a lane, ceil(log2 V) dependent gathers), its `changed` bit, and raises
// `missing` for a valid lane whose fingerprint is not in the set;
// edge_compact then writes the valid lanes' (src, dst, action, changed)
// rows at their inclusive-count positions (a library cumsum between the
// two launches), so the edges keep lane order exactly as the reference's
// stable sort by ~valid does.  Bound: the searches' gathers (random
// 8-byte reads of the sorted pairs, ~log2 V a lane, mostly from L2 on
// the upper levels); the byte bound counts each input once.
//
// K15 replaces eval_state_masks (:252) with the sr / secret predicates of
// jaxtlc/live/check.py:99-117: one thread a state reads its packed words
// and writes every predicate row in one pass.  Bound: bytes (W words in,
// one byte a predicate out).
//
// K16 replaces one sweep of surviving_set's while_loop
// (jaxtlc/live/fixpoint.py:41-88, sharded form engine/sharded.py:1490):
// survive_scatter stores 1 into support[slice, src] for every edge whose
// dst is alive (idempotent plain stores: any order gives the same bytes),
// survive_update folds the slices (the reference's psum), writes alive2
// into a second buffer (Jacobi: the sweep count equals the reference's)
// and sets `changed` when a state died.  Bound: bytes (8 bytes an edge
// plus the random alive read; 3 + D bytes a state).
#include <cuda_runtime.h>

#include "liveness.cuh"

#define LIVE_THREADS 256

__global__ void edge_search_kernel(const uint32_t* __restrict__ s_hi,
                                   const uint32_t* __restrict__ s_lo,
                                   const int32_t* __restrict__ perm, int n,
                                   int rounds, const uint32_t* __restrict__ q_hi,
                                   const uint32_t* __restrict__ q_lo,
                                   const uint8_t* __restrict__ valid,
                                   long long N, int L, int offset,
                                   int32_t* __restrict__ dst,
                                   uint8_t* __restrict__ changed,
                                   int* __restrict__ missing) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  if (edge_search_lane(i, s_hi, s_lo, perm, n, rounds, q_hi, q_lo, valid, L,
                       offset, dst, changed))
    *missing = 1;
}

__global__ void edge_compact_kernel(const uint8_t* __restrict__ valid,
                                    const long long* __restrict__ cum,
                                    long long N, int L, int offset,
                                    const int32_t* __restrict__ dst,
                                    const uint8_t* __restrict__ changed,
                                    const int32_t* __restrict__ action,
                                    int32_t* __restrict__ edges) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  edge_compact_lane(i, valid, cum, L, offset, dst, changed, action, edges);
}

__global__ void state_masks_kernel(MaskParams p,
                                   const uint32_t* __restrict__ states,
                                   long long V, uint8_t* __restrict__ out) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  state_masks_row(p, states + (size_t)v * p.W, v, V, out);
}

__global__ void survive_scatter_kernel(const int32_t* __restrict__ src,
                                       const int32_t* __restrict__ dst,
                                       long long E, long long slice,
                                       const uint8_t* __restrict__ alive,
                                       long long V,
                                       uint8_t* __restrict__ support) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  survive_scatter_edge(e, src, dst, alive, slice, V, support);
}

__global__ void survive_update_kernel(const uint8_t* __restrict__ alive,
                                      const uint8_t* __restrict__ term,
                                      const uint8_t* __restrict__ support,
                                      int D, long long V,
                                      uint8_t* __restrict__ alive2,
                                      int* __restrict__ changed) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  const uint8_t a = survive_update_state(v, alive, term, support, D, V);
  alive2[v] = a;
  if (a != alive[v]) *changed = 1;
}

static unsigned grid(long long n) {
  return (unsigned)((n + LIVE_THREADS - 1) / LIVE_THREADS);
}

extern "C" int tt_edge_search(const void* s_hi, const void* s_lo,
                              const void* perm, int n, int rounds,
                              const void* q_hi, const void* q_lo,
                              const void* valid, long long N, int L,
                              int offset, void* dst, void* changed,
                              void* missing, void* stream) {
  if (N > 0)
    edge_search_kernel<<<grid(N), LIVE_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)s_hi, (const uint32_t*)s_lo, (const int32_t*)perm,
        n, rounds, (const uint32_t*)q_hi, (const uint32_t*)q_lo,
        (const uint8_t*)valid, N, L, offset, (int32_t*)dst,
        (uint8_t*)changed, (int*)missing);
  return (int)cudaGetLastError();
}

extern "C" int tt_edge_compact(const void* valid, const void* cum,
                               long long N, int L, int offset,
                               const void* dst, const void* changed,
                               const void* action, void* edges,
                               void* stream) {
  if (N > 0)
    edge_compact_kernel<<<grid(N), LIVE_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)valid, (const long long*)cum, N, L, offset,
        (const int32_t*)dst, (const uint8_t*)changed, (const int32_t*)action,
        (int32_t*)edges);
  return (int)cudaGetLastError();
}

extern "C" int tt_mask_words() { return sizeof(MaskParams) / 4; }

extern "C" int tt_state_masks(const void* params, const void* states,
                              long long V, void* out, void* stream) {
  const MaskParams p = *(const MaskParams*)params;
  if (V > 0)
    state_masks_kernel<<<grid(V), LIVE_THREADS, 0, (cudaStream_t)stream>>>(
        p, (const uint32_t*)states, V, (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int tt_survive_sweep(const void* src, const void* dst, long long E,
                                long long slice, int D, const void* alive,
                                const void* term, long long V, void* support,
                                void* alive2, void* changed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(support, 0, (size_t)D * V, s);
  cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (E > 0)
    survive_scatter_kernel<<<grid(E), LIVE_THREADS, 0, s>>>(
        (const int32_t*)src, (const int32_t*)dst, E, slice,
        (const uint8_t*)alive, V, (uint8_t*)support);
  if (V > 0)
    survive_update_kernel<<<grid(V), LIVE_THREADS, 0, s>>>(
        (const uint8_t*)alive, (const uint8_t*)term,
        (const uint8_t*)support, D, V, (uint8_t*)alive2, (int*)changed);
  return (int)cudaGetLastError();
}
