// Kernels K36 "pod_exchange_pack", K37 "pod_exchange_unpack" and K38
// "pod_stats_pack" of the pod (torchtlc/dist); the per-element logic and
// the layouts are in pod.cuh.
//
// K36 and K37 replace the layout half of the reference's candidate
// all_to_all (jaxtlc/engine/sharded.py:572-587, the [D, B, F+3] payload)
// across processes: one thread an output word, a gather each.  K38
// replaces the layout half of the reference's stats all_gather
// (jaxtlc/dist/pod.py:224) and of the body's fences (sharded.py:764,
// :776-777): one thread an output word, the leaf found by a scan of at
// most POD_PACK_MAX column offsets.  The collectives themselves are
// torch.distributed calls (torchtlc/engine/sharded.py ShardMesh).
//
// Bounds: bytes.  K36 reads (F + 2) * 4 + 1 bytes a lane and writes
// (F + 3) * 4; K37 reads and writes the same; K38 reads each leaf word
// once and writes 8 bytes a word.
#include <cuda_runtime.h>

#include "pod.cuh"

#define POD_THREADS 256

__global__ void __launch_bounds__(POD_THREADS) pod_pack_kernel(
    const int32_t* __restrict__ xrows, const int32_t* __restrict__ xlo,
    const int32_t* __restrict__ xhi, const uint8_t* __restrict__ xvalid,
    long long lanes, int F, int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int w = F + 3;
  if (i >= lanes * w) return;
  out[i] = pod_pack_word(xrows, xlo, xhi, xvalid, i / w, F, (int)(i % w));
}

// xrows, xlo, xhi: [D, S, B, .] int32; xvalid [D, S, B] bytes; out [D, S,
// B, F + 3] int32
extern "C" int tt_pod_exchange_pack(const void* xrows, const void* xlo,
                                    const void* xhi, const void* xvalid,
                                    long long lanes, int F, void* out,
                                    void* stream) {
  if (lanes < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const long long n = lanes * (F + 3);
  pod_pack_kernel<<<(unsigned)((n + POD_THREADS - 1) / POD_THREADS),
                    POD_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)xrows, (const int32_t*)xlo, (const int32_t*)xhi,
      (const uint8_t*)xvalid, lanes, F, (int32_t*)out);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(POD_THREADS) pod_unpack_kernel(
    const int32_t* __restrict__ recv, int H, int S, int B, int F,
    int32_t* __restrict__ xrows, int32_t* __restrict__ xlo,
    int32_t* __restrict__ xhi, uint8_t* __restrict__ xvalid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int w = F + 3;
  const long long lanes = (long long)S * H * S * B;
  if (i >= lanes * w) return;
  const long long lane = i / w;  // (o, g, b) of the owner planes
  const int j = (int)(i % w);
  const int b = (int)(lane % B);
  const int g = (int)((lane / B) % ((long long)H * S));
  const int o = (int)(lane / ((long long)B * H * S));
  const int32_t v = recv[pod_unpack_src(S, B, o, g, b) * w + j];
  if (j < F) xrows[lane * F + j] = v;
  else if (j == F) xlo[lane] = v;
  else if (j == F + 1) xhi[lane] = v;
  else xvalid[lane] = v != 0;
}

// recv [H, S, S, B, F + 3] int32 -> xrows [S, H*S, B, F], xlo, xhi [S,
// H*S, B] int32, xvalid [S, H*S, B] bytes
extern "C" int tt_pod_exchange_unpack(const void* recv, int H, int S, int B,
                                      int F, void* xrows, void* xlo,
                                      void* xhi, void* xvalid, void* stream) {
  if (H < 1 || S < 1 || B < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)S * H * S * B * (F + 3);
  pod_unpack_kernel<<<(unsigned)((n + POD_THREADS - 1) / POD_THREADS),
                      POD_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)recv, H, S, B, F, (int32_t*)xrows, (int32_t*)xlo,
      (int32_t*)xhi, (uint8_t*)xvalid);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(POD_THREADS) pod_stats_kernel(
    PodPackDesc P, int rows, long long* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * P.W) return;
  out[i] = pod_stats_word(P, (int)(i / P.W), (int)(i % P.W));
}

// n leaves of `rows` rows each (device pointers, words a row, kinds as in
// pod.cuh) -> out [rows, sum(widths)] int64
extern "C" int tt_pod_stats_pack(const void* const* ptrs, const int* widths,
                                 const int* kinds, int n, int rows, void* out,
                                 void* stream) {
  PodPackDesc P;
  if (rows < 1 || pod_pack_desc(P, ptrs, widths, kinds, n) != 0 || P.W < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)rows * P.W;
  pod_stats_kernel<<<(unsigned)((total + POD_THREADS - 1) / POD_THREADS),
                     POD_THREADS, 0, (cudaStream_t)stream>>>(
      P, rows, (long long*)out);
  return (int)cudaGetLastError();
}
