// Kernel K4 "commit": enqueue, per-action distinct counts and outdegree of
// one step, one thread per enqueue position.
//
// Replaces the enqueue loop, the act_dist compare-reduce and the run-length
// outdegree histogram of jaxtlc/engine/bfs.py:make_stage_pair.commit
// (:466-551).  Input e_idx lists the new candidates in lane order, then
// the tail the reference's sort leaves behind them.  Positions are copied
// in A-wide segments while segment * A < n_new, so the rows past the new
// ones land in the level buffer exactly where the reference's
// dynamic_update_slice puts them; where clamped segments overlap at qcap,
// the later segment's row wins, as in the reference's sequential loop.
// n_new stays on the device.
//
// Bound: bytes (gather + write of about n_new packed rows).  Counts go
// through shared-memory histograms and integer atomics (order-free).
#include <cuda_runtime.h>
#include <stdint.h>

#define COMMIT_MAX_LABELS 32
#define COMMIT_MAX_L 160

__global__ void commit_kernel(uint32_t* __restrict__ dst, int W,
                              long long next_n, long long qcap,
                              const int64_t* __restrict__ e_idx,
                              long long ncand,
                              const long long* __restrict__ n_new_p,
                              const uint32_t* __restrict__ packed,
                              const int32_t* __restrict__ action,
                              long long n_pop,
                              unsigned long long* __restrict__ act_dist,
                              unsigned long long* __restrict__ outdeg, int A,
                              int L, int n_labels, long long total) {
  __shared__ unsigned int h_act[COMMIT_MAX_LABELS];
  __shared__ unsigned int h_deg[COMMIT_MAX_L + 1];
  __shared__ unsigned int s_runs;
  for (int t = threadIdx.x; t < COMMIT_MAX_LABELS; t += blockDim.x)
    h_act[t] = 0;
  for (int t = threadIdx.x; t <= COMMIT_MAX_L; t += blockDim.x) h_deg[t] = 0;
  if (threadIdx.x == 0) s_runs = 0;
  __syncthreads();
  const long long nn = *n_new_p;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < total) {
    const long long s = p / A;
    const long long nseg = (nn + A - 1) / A;
    if (s < nseg) {
      const long long src = p < ncand ? e_idx[p] : 0;
      const long long start = next_n + s * A < qcap ? next_n + s * A : qcap;
      const long long dest = start + p % A;
      bool write = true;
      if (s + 1 < nseg) {
        const long long nxt =
            next_n + (s + 1) * A < qcap ? next_n + (s + 1) * A : qcap;
        write = dest < nxt;
      }
      if (write)
        for (int w = 0; w < W; w++)
          dst[(size_t)dest * W + w] = packed[(size_t)src * W + w];
    }
    if (p < nn) {
      const int32_t act = action[e_idx[p]];
      if (act >= 0 && act < n_labels) atomicAdd(&h_act[act], 1u);
      const long long row = e_idx[p] / L;
      if (p == 0 || e_idx[p - 1] / L != row) atomicAdd(&s_runs, 1u);
      if (p == nn - 1 || e_idx[p + 1] / L != row) {
        long long q = p;
        while (q > 0 && e_idx[q - 1] / L == row) q--;
        atomicAdd(&h_deg[p - q + 1], 1u);
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_labels; t += blockDim.x)
    if (h_act[t]) atomicAdd(&act_dist[t], (unsigned long long)h_act[t]);
  for (int t = threadIdx.x + 1; t <= L; t += blockDim.x)
    if (h_deg[t]) atomicAdd(&outdeg[t], (unsigned long long)h_deg[t]);
  // bin 0: popped states with no new child = n_pop - #runs
  if (threadIdx.x == 0) {
    unsigned long long d = 0ull - (unsigned long long)s_runs;
    if (blockIdx.x == 0) d += (unsigned long long)n_pop;
    if (d) atomicAdd(&outdeg[0], d);
  }
}

extern "C" int tt_commit(void* dst, int W, long long next_n, long long qcap,
                         const void* e_idx, long long ncand,
                         const void* n_new, const void* packed,
                         const void* action, long long n_pop, void* act_dist,
                         void* outdeg, int A, int L, int n_labels,
                         void* stream) {
  if (n_labels > COMMIT_MAX_LABELS || L > COMMIT_MAX_L) return -1;
  const long long total = (ncand + A - 1) / A * A;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0)
    commit_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)dst, W, next_n, qcap, (const int64_t*)e_idx, ncand,
        (const long long*)n_new, (const uint32_t*)packed,
        (const int32_t*)action, n_pop, (unsigned long long*)act_dist,
        (unsigned long long*)outdeg, A, L, n_labels, total);
  return (int)cudaGetLastError();
}
