// Kernel K1 "expand": one thread per (popped state, lane).
//
// Replaces jaxtlc/engine/backend.py:make_expand_stage.expand (:195) over
// Codec.unpack (codec.py:367), make_kernel.step (kernel.py:521),
// canonicalize (codec.py:319), make_invariant_kernel.check
// (invariants.py:50) and Codec.pack (codec.py:337), plus
// kubeapi_backend.gen_counts (backend.py:443).  The reference materializes
// the successor fields [ck*L, F] int32; this kernel keeps them in registers
// and local memory and writes only packed words and per-lane bytes.
//
// Deferred mode (the reference's make_expand_stage(deferred=True),
// backend.py:228-237) is the kDeferred instantiation: no invariant
// evaluation, the two invariant flag rows stay zero.
//
// Bound: bytes.  It reads the popped rows (ck*W words) and writes ck*L*W
// packed words, 5 flag bytes and an int32 action per lane.  Per-action
// generated counts go through a shared-memory histogram, then one integer
// atomicAdd per label per block (order-free, so deterministic).
#include <cuda_runtime.h>

#include "kubeapi.cuh"

template <bool kDeferred>
__global__ void expand_kernel(KubeLayout Y, const u32* __restrict__ block,
                              int ck, int n, u32* __restrict__ packed,
                              uint8_t* __restrict__ flags,
                              int32_t* __restrict__ action,
                              unsigned long long* __restrict__ gen) {
  __shared__ unsigned int hist[KUBE_N_LABELS];
  for (int t = threadIdx.x; t < KUBE_N_LABELS; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const long long ncand = (long long)ck * Y.L;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < ncand) {
    const int row = (int)(idx / Y.L), lane = (int)(idx % Y.L);
    LaneOut o = kube_expand_lane<kDeferred>(Y, block + (size_t)row * Y.W, row < n, lane,
                                 packed + (size_t)idx * Y.W);
    flags[idx] = o.valid;
    flags[ncand + idx] = o.afail;
    flags[2 * ncand + idx] = o.ovf;
    flags[3 * ncand + idx] = o.bad_typeok;
    flags[4 * ncand + idx] = o.bad_onlyone;
    action[idx] = o.action;
    if (o.valid) atomicAdd(&hist[o.action], 1u);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < KUBE_N_LABELS; t += blockDim.x)
    if (hist[t]) atomicAdd(&gen[t], (unsigned long long)hist[t]);
}

// The sharded engine's variant (jaxtlc/engine/sharded.py:510-555): one
// launch over the pops of all D shards.  Shard d's row r is the unpacked
// queue row queue[d, (qhead[d] + r) % qcap] (the reference's circular pop
// of [F] rows), popped when r < npop[d]; lane idx = (d * ck + r) * L + lane.
// Besides K1's outputs it writes each lane's raw successor fields
// (`fields`, the reference's `flat`, which the route payload carries) and,
// when `block` is given, each popped row packed (the coverage plane reads
// packed rows).  Per-action generated counts go to gen[d, label].
#define EXPAND_MAX_SHARDS 8

template <bool kDeferred>
__global__ void expand_sharded_kernel(
    KubeLayout Y, const int32_t* __restrict__ queue, long long qrows, int qcap,
    const long long* __restrict__ qhead, const long long* __restrict__ npop,
    int D, int ck, u32* __restrict__ packed, uint8_t* __restrict__ flags,
    int32_t* __restrict__ action, int32_t* __restrict__ fields,
    u32* __restrict__ block, unsigned long long* __restrict__ gen) {
  __shared__ unsigned int hist[EXPAND_MAX_SHARDS * KUBE_N_LABELS];
  for (int t = threadIdx.x; t < D * KUBE_N_LABELS; t += blockDim.x)
    hist[t] = 0;
  __syncthreads();
  const long long per = (long long)ck * Y.L;
  const long long ncand = per * D;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < ncand) {
    const int d = (int)(idx / per);
    const int row = (int)((idx % per) / Y.L), lane = (int)(idx % Y.L);
    const int32_t* src =
        queue + ((size_t)d * qrows + (size_t)((qhead[d] + row) % qcap)) * Y.F;
    int32_t f[KUBE_MAXF];
    for (int j = 0; j < Y.F; j++) f[j] = src[j];
    LaneOut o = kube_expand_fields<kDeferred>(
        Y, f, row < npop[d], lane, packed + (size_t)idx * Y.W,
        fields + (size_t)idx * Y.F);
    flags[idx] = o.valid;
    flags[ncand + idx] = o.afail;
    flags[2 * ncand + idx] = o.ovf;
    flags[3 * ncand + idx] = o.bad_typeok;
    flags[4 * ncand + idx] = o.bad_onlyone;
    action[idx] = o.action;
    if (block != nullptr && lane == 0)
      kube_pack(Y, f, block + ((size_t)d * ck + row) * Y.W);
    if (o.valid) atomicAdd(&hist[d * KUBE_N_LABELS + o.action], 1u);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < D * KUBE_N_LABELS; t += blockDim.x)
    if (hist[t]) atomicAdd(&gen[t], (unsigned long long)hist[t]);
}

extern "C" int tt_layout_words() { return sizeof(KubeLayout) / 4; }

// gen must hold D * KUBE_N_LABELS zeroed (or accumulating) counters;
// block may be null
extern "C" int tt_expand_sharded(const void* layout, const void* queue,
                                 long long qrows, int qcap, const void* qhead,
                                 const void* npop, int D, int ck, int deferred,
                                 void* packed, void* flags, void* action,
                                 void* fields, void* block, void* gen,
                                 void* stream) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  if (D < 1 || D > EXPAND_MAX_SHARDS) return (int)cudaErrorInvalidValue;
  const long long ncand = (long long)D * ck * Y.L;
  const int threads = 128;
  const long long blocks = (ncand + threads - 1) / threads;
  if (blocks > 0 && deferred)
    expand_sharded_kernel<true><<<(unsigned)blocks, threads, 0,
                                  (cudaStream_t)stream>>>(
        Y, (const int32_t*)queue, qrows, qcap, (const long long*)qhead,
        (const long long*)npop, D, ck, (u32*)packed, (uint8_t*)flags,
        (int32_t*)action, (int32_t*)fields, (u32*)block,
        (unsigned long long*)gen);
  else if (blocks > 0)
    expand_sharded_kernel<false><<<(unsigned)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
        Y, (const int32_t*)queue, qrows, qcap, (const long long*)qhead,
        (const long long*)npop, D, ck, (u32*)packed, (uint8_t*)flags,
        (int32_t*)action, (int32_t*)fields, (u32*)block,
        (unsigned long long*)gen);
  return (int)cudaGetLastError();
}

// gen must hold KUBE_N_LABELS zeroed (or accumulating) counters
extern "C" int tt_expand(const void* layout, const void* block, int ck, int n,
                         int deferred, void* packed, void* flags,
                         void* action, void* gen, void* stream) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  const long long ncand = (long long)ck * Y.L;
  const int threads = 128;
  const long long blocks = (ncand + threads - 1) / threads;
  if (blocks > 0 && deferred)
    expand_kernel<true><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        Y, (const u32*)block, ck, n, (u32*)packed, (uint8_t*)flags,
        (int32_t*)action, (unsigned long long*)gen);
  else if (blocks > 0)
    expand_kernel<false><<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
        Y, (const u32*)block, ck, n, (u32*)packed, (uint8_t*)flags,
        (int32_t*)action, (unsigned long long*)gen);
  return (int)cudaGetLastError();
}
