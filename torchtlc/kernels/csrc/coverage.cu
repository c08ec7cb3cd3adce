// Kernel K10 "coverage_count": the device coverage plane's per-body site
// increments, one thread per popped row.
//
// Replaces jaxtlc/spec/coverage_device.py:kubeapi_coverage_plane.count
// (:766-803): per popped row the reference builds ~300 int32 site columns
// from the decoded fields, stacks them and takes one masked matvec.  Here
// each thread decodes its row and forms every site's contribution in
// registers and local memory (coverage.cuh:cov_row); nothing but the 311
// sums leaves the card's SMs:
//   1. per site, the warp's 32 contributions are summed with
//      __reduce_add_sync and lane 0 adds the sum into the block's [311]
//      uint32 shared array;
//   2. after a grid-stride loop over the rows, each block adds its nonzero
//      sums into the [311] output with one global atomicAdd per site.
// The configuration's layout and identity tables (NEQ, KEQ, LT, IS_PVC,
// KIND_ID) live in constant memory, uploaded on the launching stream when
// they change.  uint32 additions commute, so the sums are exact in any
// order: the reference's int32 matvec cast to uint32.
//
// Bound: bytes, by a wide margin only on paper.  It reads the popped rows
// (ck*W words) and the valid flags (ck*L bytes) once and writes 311 words;
// each row costs a few thousand integer operations and ~300 warp
// reductions, so the kernel is expected to run well above that bound.
#include <cuda_runtime.h>
#include <string.h>

#include "coverage.cuh"

#define COV_THREADS 256

__constant__ CovParams c_cov;

// site contributions of a warp -> the block's shared sums
struct WarpEmit {
  u32* acc;
  int k;
  unsigned lane;
  HD void operator()(int v) {
#ifdef __CUDA_ARCH__
    const u32 s = __reduce_add_sync(0xffffffffu, (u32)v);
    if (lane == 0 && s != 0u) atomicAdd(&acc[k], s);
#endif
    k++;
  }
  HD void skip(int n) { k += n; }
};

__global__ void __launch_bounds__(COV_THREADS)
    coverage_kernel(const u32* __restrict__ block, int ck, int n,
                    const uint8_t* __restrict__ valid, u32* __restrict__ out) {
  __shared__ u32 acc[COV_N_SITES];
  for (int t = threadIdx.x; t < COV_N_SITES; t += blockDim.x) acc[t] = 0u;
  __syncthreads();
  const int W = c_cov.Y.W, L = c_cov.Y.L;
  const unsigned lane = threadIdx.x & 31u;
  // block-uniform trip count: every lane of a warp emits every site
  for (int base = blockIdx.x * blockDim.x; base < ck;
       base += gridDim.x * blockDim.x) {
    const int row = base + threadIdx.x;
    const bool in = row < ck;
    WarpEmit e{acc, 0, lane};
    cov_row(c_cov, in ? block + (size_t)row * W : nullptr, in && row < n,
            in ? valid + (size_t)row * L : nullptr, e);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < COV_N_SITES; t += blockDim.x)
    if (acc[t] != 0u) atomicAdd(&out[t], acc[t]);
}

extern "C" int tt_coverage_words() { return sizeof(CovParams) / 4; }

// out: COV_N_SITES zeroed (or accumulating) uint32 counters
extern "C" int tt_coverage_count(const void* params, const void* block, int ck,
                                 int n, const void* valid, void* out,
                                 void* stream) {
  static CovParams uploaded;
  static bool have = false;
  static int sms = 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (!have || memcmp(&uploaded, params, sizeof(CovParams)) != 0) {
    cudaError_t e = cudaMemcpyToSymbolAsync(c_cov, params, sizeof(CovParams),
                                            0, cudaMemcpyHostToDevice, s);
    if (e != cudaSuccess) return (int)e;
    memcpy(&uploaded, params, sizeof(CovParams));
    have = true;
  }
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long need = ((long long)ck + COV_THREADS - 1) / COV_THREADS;
  const int blocks = (int)(need < 2LL * sms ? need : 2LL * sms);
  if (blocks > 0)
    coverage_kernel<<<blocks, COV_THREADS, 0, s>>>(
        (const u32*)block, ck, n, (const uint8_t*)valid, (u32*)out);
  return (int)cudaGetLastError();
}
