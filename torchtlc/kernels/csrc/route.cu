// Kernels K11 "route_scatter" (route_count + route_scatter), K12
// "verdict_fold" and K13 "shard_enqueue" of the sharded engine; the
// per-element logic is in route.cuh.
//
// K11 replaces the owner sort and bucket scatter of
// jaxtlc/engine/sharded.py:expand_half (:553-586): a stable counting sort
// of the source shard's ncand candidates over D + 1 keys (owner, or D for
// an invalid lane), one grid row per source shard.  route_count counts
// each 1024-lane tile's keys; route_scatter sums the earlier tiles' counts
// and all tiles' (class starts), ranks each lane inside its tile - per
// warp with __match_any_sync and __popc, then per-warp offsets in shared
// memory - and writes the reference's sorted-order words (order, s_own,
// s_pos = g - classStart[key], s_valid) and, for a valid lane with
// s_pos < B, the payload into the exchange planes at [owner, src, s_pos]
// (its F raw fields, lo, hi, valid = 1); a valid lane past its bucket
// sets the route-overflow flag.  The caller zeroes `xvalid` first: a slot
// no lane filled stays invalid.
//
// K12 replaces the verdict return (:691-719; pipelined :485-505): per
// sorted lane the verdict the owner wrote for it (route_got), one count
// into the source row's new-degree (lane / L) and one into the lane's
// act_dist column (its action when new, else n_labels); the last block to
// finish turns the row degrees into the outdegree histogram (unpopped rows
// into bin L + 1).  Integer atomics only, so the words are exact in any
// order.
//
// K13 replaces the owner-side circular enqueue (:685-689): a fresh row to
// (qtail + rank) % qcap, and the dump row qcap as the reference leaves it
// (route.cuh enqueue_target); the caller gives the inclusive counts of the
// fresh rows (a library cumsum).
//
// Bounds: bytes.  K11 reads 9 bytes and F words a lane and writes 13
// bytes a lane plus the payload of the valid ones; K12 reads 13 bytes a
// sorted lane, the verdict byte and the action of the new ones; K13 moves
// the fresh rows (F words each) and reads 9 bytes a received row.
#include <cuda_runtime.h>

#include "route.cuh"

#define ROUTE_TILE 1024
#define FOLD_THREADS 256
#define FOLD_MAX_LABELS 64
#define FOLD_MAX_HIST 512

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// counts[s, t, k]: lanes of source s's tile t with key k
__global__ void __launch_bounds__(ROUTE_TILE)
    route_count_kernel(const uint32_t* __restrict__ hi,
                       const uint8_t* __restrict__ valid, long long ncand,
                       int D, int ntiles, int* __restrict__ counts) {
  __shared__ int c[ROUTE_MAX_SHARDS + 1];
  const int s = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;
  if (tid <= D) c[tid] = 0;
  __syncthreads();
  const long long i = (long long)t * ROUTE_TILE + tid;
  const bool inb = i < ncand;
  const size_t g = (size_t)s * ncand + (inb ? i : 0);
  const int key = inb ? route_key(hi[g], valid[g] != 0, D) : D + 1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (inb && (lanemask_lt() & peers) == 0) atomicAdd(&c[key], __popc(peers));
  __syncthreads();
  if (tid <= D) counts[((size_t)s * ntiles + t) * (D + 1) + tid] = c[tid];
}

__global__ void __launch_bounds__(ROUTE_TILE) route_scatter_kernel(
    const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ fields,
    long long ncand, int D, int B, int F, int ntiles,
    const int* __restrict__ counts, int32_t* __restrict__ order,
    int32_t* __restrict__ s_own, int32_t* __restrict__ s_pos,
    uint8_t* __restrict__ s_valid, int32_t* __restrict__ xrows,
    uint32_t* __restrict__ xlo, uint32_t* __restrict__ xhi,
    uint8_t* __restrict__ xvalid, uint8_t* __restrict__ route_ovf) {
  __shared__ int base[ROUTE_MAX_SHARDS + 1];
  __shared__ int start[ROUTE_MAX_SHARDS + 1];
  __shared__ int total[ROUTE_MAX_SHARDS + 1];
  __shared__ int woff[ROUTE_TILE / 32][ROUTE_MAX_SHARDS + 1];
  const int s = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, wl = tid % 32;
  // 1. per key (one warp each): the earlier tiles' count and the total
  if (warp <= D) {
    int pre = 0, tot = 0;
    for (int j = wl; j < ntiles; j += 32) {
      const int v = counts[((size_t)s * ntiles + j) * (D + 1) + warp];
      tot += v;
      pre += j < t ? v : 0;
    }
    for (int off = 16; off > 0; off >>= 1) {
      pre += __shfl_down_sync(0xffffffffu, pre, off);
      tot += __shfl_down_sync(0xffffffffu, tot, off);
    }
    if (wl == 0) {
      base[warp] = pre;
      total[warp] = tot;
    }
  }
  for (int k = wl; k <= D; k += 32) woff[warp][k] = 0;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int k = 0; k <= D; k++) {
      start[k] = run;
      run += total[k];
    }
  }
  // 2. ranks inside the warp, then the warps' offsets per key
  const long long i = (long long)t * ROUTE_TILE + tid;
  const bool inb = i < ncand;
  const size_t g = (size_t)s * ncand + (inb ? i : 0);
  const int key = inb ? route_key(hi[g], valid[g] != 0, D) : D + 1;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int rank = __popc(peers & lanemask_lt());
  if (inb && rank == 0) woff[warp][key] = __popc(peers);
  __syncthreads();
  if (tid <= D) {
    int run = 0;
    for (int w = 0; w < ROUTE_TILE / 32; w++) {
      const int c = woff[w][tid];
      woff[w][tid] = run;
      run += c;
    }
  }
  __syncthreads();
  if (!inb) return;
  // 3. the sorted-order words and the payload
  const int pos = base[key] + woff[warp][key] + rank;
  const size_t out = (size_t)s * ncand + (size_t)(start[key] + pos);
  order[out] = (int32_t)i;
  s_own[out] = key;
  s_pos[out] = pos;
  s_valid[out] = key < D;
  if (key < D) {
    if (pos < B) {
      const size_t slot = ((size_t)key * D + s) * B + pos;
      const int32_t* src = fields + g * F;
      int32_t* dst = xrows + slot * F;
      for (int j = 0; j < F; j++) dst[j] = src[j];
      xlo[slot] = lo[g];
      xhi[slot] = hi[g];
      xvalid[slot] = 1;
    } else {
      route_ovf[s] = 1;
    }
  }
}

// counts: [D, ntiles, D + 1] int32 scratch
extern "C" int tt_route_scatter(const void* hi, const void* lo,
                                const void* valid, const void* fields,
                                long long ncand, int D, int B, int F,
                                void* counts, void* order, void* s_own,
                                void* s_pos, void* s_valid, void* xrows,
                                void* xlo, void* xhi, void* xvalid,
                                void* route_ovf, void* stream) {
  if (D < 1 || D > ROUTE_MAX_SHARDS || ncand < 1)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (int)((ncand + ROUTE_TILE - 1) / ROUTE_TILE);
  const dim3 grid((unsigned)ntiles, (unsigned)D);
  cudaStream_t st = (cudaStream_t)stream;
  route_count_kernel<<<grid, ROUTE_TILE, 0, st>>>(
      (const uint32_t*)hi, (const uint8_t*)valid, ncand, D, ntiles,
      (int*)counts);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  route_scatter_kernel<<<grid, ROUTE_TILE, 0, st>>>(
      (const uint32_t*)hi, (const uint32_t*)lo, (const uint8_t*)valid,
      (const int32_t*)fields, ncand, D, B, F, ntiles, (const int*)counts,
      (int32_t*)order, (int32_t*)s_own, (int32_t*)s_pos, (uint8_t*)s_valid,
      (int32_t*)xrows, (uint32_t*)xlo, (uint32_t*)xhi, (uint8_t*)xvalid,
      (uint8_t*)route_ovf);
  return (int)cudaGetLastError();
}

// rowdeg: [D * chunk + 1] zeroed int32 scratch (the last word counts the
// finished blocks)
__global__ void __launch_bounds__(FOLD_THREADS) verdict_fold_kernel(
    const uint8_t* __restrict__ verd, const int32_t* __restrict__ s_own,
    const int32_t* __restrict__ s_pos, const uint8_t* __restrict__ s_valid,
    const int32_t* __restrict__ order, const int32_t* __restrict__ faction,
    const long long* __restrict__ npop, long long ncand, int D, int B,
    int chunk, int L, int n_labels, int* rowdeg,
    unsigned long long* outdeg, unsigned long long* act_dist) {
  __shared__ unsigned int hist[FOLD_MAX_LABELS];
  __shared__ unsigned int oh[FOLD_MAX_HIST];
  __shared__ bool last;
  const int s = blockIdx.y, tid = threadIdx.x;
  for (int c = tid; c <= n_labels; c += blockDim.x) hist[c] = 0;
  __syncthreads();
  const long long g = (long long)blockIdx.x * blockDim.x + tid;
  if (g < ncand) {
    const size_t k = (size_t)s * ncand + g;
    const bool got = route_got(verd, D, B, s, s_own[k], s_pos[k],
                               s_valid[k] != 0);
    const long long lane = order[k];
    atomicAdd(&hist[got ? faction[(size_t)s * ncand + lane] : n_labels], 1u);
    if (got) atomicAdd(&rowdeg[(size_t)s * chunk + lane / L], 1);
  }
  __syncthreads();
  for (int c = tid; c <= n_labels; c += blockDim.x)
    if (hist[c])
      atomicAdd(&act_dist[(size_t)s * (n_labels + 1) + c],
                (unsigned long long)hist[c]);
  __threadfence();
  __syncthreads();
  const int nblocks = (int)(gridDim.x * gridDim.y);
  int* done = rowdeg + (size_t)D * chunk;
  if (tid == 0) last = atomicAdd(done, 1) == nblocks - 1;
  __syncthreads();
  if (!last) return;
  // the last block: every row's new-degree into the outdegree histogram
  const int H = L + 2;
  for (int c = tid; c < D * H; c += blockDim.x) oh[c] = 0;
  __syncthreads();
  const volatile int* deg = rowdeg;
  for (long long r = tid; r < (long long)D * chunk; r += blockDim.x) {
    const int d = (int)(r / chunk), row = (int)(r % chunk);
    const int bin = row < npop[d] ? deg[r] : L + 1;
    atomicAdd(&oh[d * H + bin], 1u);
  }
  __syncthreads();
  for (int c = tid; c < D * H; c += blockDim.x)
    if (oh[c]) atomicAdd(&outdeg[c], (unsigned long long)oh[c]);
}

extern "C" int tt_verdict_fold(const void* verd, const void* s_own,
                               const void* s_pos, const void* s_valid,
                               const void* order, const void* faction,
                               const void* npop, long long ncand, int D, int B,
                               int chunk, int L, int n_labels, void* rowdeg,
                               void* outdeg, void* act_dist, void* stream) {
  if (D < 1 || D > ROUTE_MAX_SHARDS || n_labels + 1 > FOLD_MAX_LABELS ||
      D * (L + 2) > FOLD_MAX_HIST || ncand < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((ncand + FOLD_THREADS - 1) / FOLD_THREADS),
                  (unsigned)D);
  verdict_fold_kernel<<<grid, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)verd, (const int32_t*)s_own, (const int32_t*)s_pos,
      (const uint8_t*)s_valid, (const int32_t*)order,
      (const int32_t*)faction, (const long long*)npop, ncand, D, B, chunk, L,
      n_labels, (int*)rowdeg, (unsigned long long*)outdeg,
      (unsigned long long*)act_dist);
  return (int)cudaGetLastError();
}

__global__ void shard_enqueue_kernel(
    int32_t* __restrict__ queue, long long qrows, int qcap,
    const uint8_t* __restrict__ is_new, const long long* __restrict__ cum,
    const long long* __restrict__ qtail, const uint8_t* __restrict__ q_full,
    const int32_t* __restrict__ xrows, const uint8_t* __restrict__ xvalid,
    long long n, int F) {
  const int o = blockIdx.y;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t k = (size_t)o * n + i;
  const long long tgt =
      enqueue_target(is_new[k] != 0, q_full[o] != 0, qtail[o], cum[k],
                     cum[(size_t)o * n + n - 1], i, n, qcap);
  if (tgt < 0) return;
  int32_t* dst = queue + ((size_t)o * qrows + (size_t)tgt) * F;
  const int32_t* src = xrows + k * F;
  const bool keep = xvalid[k] != 0;  // an empty slot's row is zeros
  for (int j = 0; j < F; j++) dst[j] = keep ? src[j] : 0;
}

extern "C" int tt_shard_enqueue(void* queue, long long qrows, int qcap,
                                const void* is_new, const void* cum,
                                const void* qtail, const void* q_full,
                                const void* xrows, const void* xvalid,
                                long long n, int D, int F, void* stream) {
  if (D < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)D);
  shard_enqueue_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)queue, qrows, qcap, (const uint8_t*)is_new,
      (const long long*)cum, (const long long*)qtail,
      (const uint8_t*)q_full, (const int32_t*)xrows,
      (const uint8_t*)xvalid, n, F);
  return (int)cudaGetLastError();
}
