// Kernel K7 "deferred_check": the invariants on the fresh-insert
// claimants, one thread per claimant row.
//
// Replaces jaxtlc/engine/backend.py:make_deferred_checker (:325-420).
// Each fresh row re-derives its candidate's raw successor from the popped
// block (deferred.cuh), evaluates TypeOK and OnlyOneVersion, and folds its
// lane into the per-code maximum with an integer atomicMax (order-free, so
// the result is deterministic).  The last block to finish (a threadfence
// and a done counter) picks the verdict: first wins across the codes, the
// highest lane within one, and writes that lane's raw successor fields
// and action.  Every row of the claimant slice is scanned: rows that are
// not fresh exit after one byte read.
//
// Bound: operations.  Per fresh claimant it reads one packed source row
// (W words) and its lane, then runs the whole per-lane successor function
// and the O(ni^2) OnlyOneVersion check - like K1, integer work in local
// memory, not bytes, is the limit.
#include <cuda_runtime.h>

#include "deferred.cuh"

// scratch: [0, 1] the per-code highest bad lane, [2] the done counter; all
// three start at -1
__global__ void deferred_kernel(KubeLayout Y, const u32* __restrict__ block,
                                long long rows,
                                const uint8_t* __restrict__ fresh,
                                const int64_t* __restrict__ c_idx,
                                const int32_t* __restrict__ action,
                                int* scratch, long long* __restrict__ viol,
                                int32_t* __restrict__ state,
                                long long* __restrict__ vaction) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows && fresh[i]) {
    const long long lane = c_idx[i];
    int32_t s[KUBE_MAXF];
    const int bits = kube_claimant_bits(Y, block, lane, s);
    for (int k = 0; k < DEFERRED_N_CODES; k++)
      if (!(bits & (1 << k))) atomicMax(&scratch[k], (int)lane);
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(&scratch[DEFERRED_N_CODES], 1) == (int)gridDim.x - 2;
  __syncthreads();
  if (last && threadIdx.x == 0) {
    int bad[DEFERRED_N_CODES];
    for (int k = 0; k < DEFERRED_N_CODES; k++)
      bad[k] = atomicAdd(&scratch[k], 0);
    kube_deferred_pick(Y, block, action, bad, viol, state, vaction);
  }
}

extern "C" int tt_deferred_check(const void* layout, const void* block,
                                 long long rows, const void* fresh,
                                 const void* c_idx, const void* action,
                                 void* scratch, void* viol, void* state,
                                 void* vaction, void* stream) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  const int threads = 128;
  const long long blocks = rows > 0 ? (rows + threads - 1) / threads : 1;
  deferred_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      Y, (const u32*)block, rows, (const uint8_t*)fresh,
      (const int64_t*)c_idx, (const int32_t*)action, (int*)scratch,
      (long long*)viol, (int32_t*)state, (long long*)vaction);
  return (int)cudaGetLastError();
}

// The owner-side variant of the sharded engine: one thread per claimant
// row of the received batch, the claimant's fields read from `rows`
// ([N, F] int32) instead of derived from a popped parent.  Same scratch
// protocol and verdict rule; no action.
__global__ void deferred_rows_kernel(KubeLayout Y,
                                     const int32_t* __restrict__ rows_in,
                                     long long rows,
                                     const uint8_t* __restrict__ fresh,
                                     const int64_t* __restrict__ c_idx,
                                     int* scratch, long long* __restrict__ viol,
                                     int32_t* __restrict__ state) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows && fresh[i]) {
    const long long lane = c_idx[i];
    int32_t s[KUBE_MAXF];
    const int bits = kube_row_bits(Y, rows_in, lane, s);
    for (int k = 0; k < DEFERRED_N_CODES; k++)
      if (!(bits & (1 << k))) atomicMax(&scratch[k], (int)lane);
  }
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(&scratch[DEFERRED_N_CODES], 1) == (int)gridDim.x - 2;
  __syncthreads();
  if (last && threadIdx.x == 0) {
    int bad[DEFERRED_N_CODES];
    for (int k = 0; k < DEFERRED_N_CODES; k++)
      bad[k] = atomicAdd(&scratch[k], 0);
    kube_deferred_pick_rows(Y, rows_in, bad, viol, state);
  }
}

extern "C" int tt_deferred_check_rows(const void* layout, const void* rows_in,
                                      long long rows, const void* fresh,
                                      const void* c_idx, void* scratch,
                                      void* viol, void* state, void* stream) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  const int threads = 128;
  const long long blocks = rows > 0 ? (rows + threads - 1) / threads : 1;
  deferred_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      Y, (const int32_t*)rows_in, rows, (const uint8_t*)fresh,
      (const int64_t*)c_idx, (int*)scratch, (long long*)viol,
      (int32_t*)state);
  return (int)cudaGetLastError();
}
