// Kernel K8 "ring_row": one observability-ring row per engine body, in
// one block.
//
// Replaces jaxtlc/obs/counters.py:ring_update (:89) with pack_row,
// sticky_overflow and wrapped_any (:106-158), as the reference's commit
// calls them (jaxtlc/engine/bfs.py:625-656).  The block reads the
// counters where the step left them on the device, so the host issues no
// read for the ring:
//   1. the sticky COL_OVERFLOW word: the max of that column over every
//      ring row (dump row included) and the wrap test of each cumulative
//      counter against its value before the body, as a shared-memory max;
//   2. the row, written at head % slots on a level flip, else into the
//      dump row `slots` (flip is known on the host);
//   3. head += flip, bodies += 1, expanded += n_pop, in place.
// In spill mode the row's COL_SPILL is the carry's spill_hits counter
// (spill_new, after the body) and its wrap against spill_old joins the
// overflow test; both pointers are null otherwise.  With the coverage
// plane, the n_cov site counters after (cov_new) and before (cov_old) the
// body join the wrap test too (no column: the counters ride the carry).
// With the runtime certificate (a narrowed struct run) the row's COL_CERT
// is the carry's sticky flag `cert` (a bool the commit has already ORed,
// jaxtlc/engine/bfs.py:602-610); null otherwise, and the column is 0.
// With symmetry reduction the row's COL_SYM is the carry's sticky orbit
// flag `sym` (jaxtlc/engine/bfs.py:611-617) the same way.
// __syncthreads separates the reads of phase 1 from the writes of 2 and 3.
// `entry` (the sharded engine's pipelined ring, jaxtlc/engine/sharded.py:
// 800-817) writes the counters as they were BEFORE the body into the row -
// gen_old, dist_old, bodies, expanded and the act_gen half of acts_old -
// while the wrap test and the updates stay those of the body.
//
// Bound: latency.  It moves a few hundred bytes (one ring column of
// slots + 1 words, 2 (n_labels + 1) counters and their snapshot, one row).
#include <cuda_runtime.h>

#include "ring.cuh"

#define RING_THREADS 128

__global__ void __launch_bounds__(RING_THREADS)
    ring_kernel(uint32_t* ring, int slots, int cols, long long* head,
                long long* bodies, long long* expanded, long long n_pop,
                int flip, const long long* level, const long long* gen_new,
                const long long* gen_old, const long long* dist_new,
                const long long* dist_old, const long long* queue_n,
                const long long* act_gen, const long long* act_dist,
                const long long* acts_old, const long long* spill_new,
                const long long* spill_old, int n_acts, int n_labels,
                const long long* cov_new, const long long* cov_old,
                int n_cov, int entry, const bool* cert, const bool* sym) {
  __shared__ unsigned int s_over;
  const int tid = threadIdx.x;
  if (tid == 0) s_over = 0u;
  __syncthreads();
  unsigned int m = 0u;
  for (int r = tid; r <= slots; r += blockDim.x) {
    const unsigned int w = ring[(size_t)r * cols + RING_COL_OVERFLOW];
    m = w > m ? w : m;
  }
  bool wrap = ring_any_wrapped(act_gen, acts_old, n_acts, tid, blockDim.x) ||
              ring_any_wrapped(act_dist, acts_old + n_acts, n_acts, tid,
                               blockDim.x) ||
              ring_any_wrapped(cov_new, cov_old, n_cov, tid, blockDim.x);
  const long long b0 = *bodies, e0 = *expanded;
  if (tid == 0)
    wrap = wrap || ring_wrapped(*gen_new, *gen_old) ||
           ring_wrapped(*dist_new, *dist_old) ||
           ring_wrapped(b0 + 1, b0) || ring_wrapped(e0 + n_pop, e0) ||
           (spill_new != nullptr && ring_wrapped(*spill_new, *spill_old));
  m = wrap && m < 1u ? 1u : m;
  atomicMax(&s_over, m);
  __syncthreads();
  RingScalars v;
  v.level = *level;
  v.generated = entry ? *gen_old : *gen_new;
  v.distinct = entry ? *dist_old : *dist_new;
  v.queue = *queue_n;
  v.bodies = entry ? b0 : b0 + 1;
  v.expanded = entry ? e0 : e0 + n_pop;
  v.overflow = s_over;
  v.spill = spill_new != nullptr ? *spill_new : 0;
  v.cert = cert != nullptr && *cert ? 1u : 0u;
  v.sym = sym != nullptr && *sym ? 1u : 0u;
  const long long h = *head;
  const long long row = flip ? h % slots : slots;
  for (int col = tid; col < cols; col += blockDim.x)
    ring[(size_t)row * cols + col] =
        ring_cell(v, entry ? acts_old : act_gen, act_dist, n_labels, col);
  __syncthreads();
  if (tid == 0) {
    *head = h + (flip ? 1 : 0);
    *bodies = b0 + 1;
    *expanded = e0 + n_pop;
  }
}

extern "C" int tt_ring_row(void* ring, int slots, int cols, void* head,
                           void* bodies, void* expanded, long long n_pop,
                           int flip, const void* level, const void* gen_new,
                           const void* gen_old, const void* dist_new,
                           const void* dist_old, const void* queue_n,
                           const void* act_gen, const void* act_dist,
                           const void* acts_old, const void* spill_new,
                           const void* spill_old, int n_acts, int n_labels,
                           const void* cov_new, const void* cov_old, int n_cov,
                           int entry, const void* cert, const void* sym,
                           void* stream) {
  ring_kernel<<<1, RING_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)ring, slots, cols, (long long*)head, (long long*)bodies,
      (long long*)expanded, n_pop, flip, (const long long*)level,
      (const long long*)gen_new, (const long long*)gen_old,
      (const long long*)dist_new, (const long long*)dist_old,
      (const long long*)queue_n, (const long long*)act_gen,
      (const long long*)act_dist, (const long long*)acts_old,
      (const long long*)spill_new, (const long long*)spill_old, n_acts,
      n_labels, (const long long*)cov_new, (const long long*)cov_old, n_cov,
      entry, (const bool*)cert, (const bool*)sym);
  return (int)cudaGetLastError();
}
