// Kernel K3: insert-or-find of a sorted, compacted fingerprint block into
// the bucketized table, in four launches:
//
//   fpset_key    mix + remap + mask -> int64 sort keys (elementwise);
//                replaces jaxtlc/engine/fpset.py:_remap/_fmix32/_mix
//                (:121-152) in fpset_insert_sorted (:614).
//   fpset_probe  round 0 of _probe_block (:369-417), one thread per
//                candidate: home-row gather, hit test, occupancy, claim
//                slot = occupancy + rank among the run's wanters.  The
//                active lanes are a prefix (sorted path) or a mask (the
//                slab path's interspersed layout, fpset.py:726).
//   fpset_claim  writes the round-0 claims (every claim targets a distinct
//                slot) and marks the stragglers; a separate launch so that
//                every round-0 read sees the table before any claim.
//   fpset_walk   the straggler walk (:431-543) in ONE block: stragglers are
//                settled in slices of S = min(R, 2048) taken in position
//                order; each round every pending lane re-reads its current
//                bucket, wanters of one bucket rank by ascending (lo, hi)
//                (the reference's dense [S, S] rank form, over the compacted
//                wanter list), the fitting ones claim, the rest advance to
//                the next bucket.  __syncthreads separates read, rank and
//                write phases, so no host round trip happens per round.
//
// Bound: latency.  Round 0 gathers one 64-byte row per candidate (R rows);
// the walk is serial in rounds but touches only the few stragglers.
#include <cuda_runtime.h>

#include "fpset.cuh"

#define WALK_THREADS 1024
#define WALK_S 2048

__global__ void key_kernel(const uint32_t* __restrict__ lo,
                           const uint32_t* __restrict__ hi,
                           const uint8_t* __restrict__ mask, long long N,
                           int64_t* __restrict__ key) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) key[i] = fp_key(lo[i], hi[i], mask[i] != 0);
}

// active lanes: act[i] when act is given (the slab layout), else the
// prefix off + i < nreps
__global__ void probe_kernel(const uint32_t* __restrict__ table, int lognb,
                             const int64_t* __restrict__ keys, int R,
                             const long long* __restrict__ nreps,
                             const uint8_t* __restrict__ act, long long off,
                             int32_t* __restrict__ slot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < R)
    slot[i] = fp_round0(table, lognb, keys, act, i,
                        act != nullptr ? act[i] != 0 : off + i < *nreps);
}

__global__ void claim_kernel(uint32_t* __restrict__ table,
                             const int64_t* __restrict__ keys, int R,
                             const int32_t* __restrict__ slot,
                             const long long* __restrict__ claim_cum, int C,
                             uint8_t* __restrict__ is_new,
                             uint8_t* __restrict__ pending,
                             int* __restrict__ npend) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const int32_t s = slot[i];
  const bool claimed =
      s >= 0 && (claim_cum == nullptr || claim_cum[i] - 1 < (long long)C);
  if (claimed) {
    table[2 * (size_t)s] = fp_key_lo(keys[i]);
    table[2 * (size_t)s + 1] = fp_key_hi(keys[i]);
  }
  is_new[i] = claimed;
  const bool pend = s == -2 || (s >= 0 && !claimed);
  pending[i] = pend;
  if (pend) atomicAdd(npend, 1);
}

// exclusive block-wide prefix count of `flag`; every thread must call it
__device__ int block_excl_scan(int flag, int* warp_tot, int& total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned bal = __ballot_sync(full, flag);
  const int pre = __popc(bal & ((1u << lane) - 1u));
  if (lane == 0) warp_tot[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(full, v, o);
      if (lane >= o) v += t;
    }
    warp_tot[lane] = v;  // inclusive
  }
  __syncthreads();
  const int base = warp == 0 ? 0 : warp_tot[warp - 1];
  total = warp_tot[nwarps - 1];
  __syncthreads();
  return base + pre;
}

__global__ void __launch_bounds__(WALK_THREADS)
    walk_kernel(uint32_t* table, int lognb, uint32_t nb_mask,
                const int64_t* __restrict__ keys, int R,
                uint8_t* __restrict__ pending, uint8_t* __restrict__ is_new,
                const int* __restrict__ npend) {
  __shared__ uint32_t s_lo[WALK_S], s_hi[WALK_S], s_b[WALK_S];
  __shared__ int s_pos[WALK_S];
  __shared__ short s_wl[WALK_S];
  __shared__ uint8_t s_occ[WALK_S];
  __shared__ uint8_t s_st[WALK_S];  // bit 0 pending, bit 1 claimed
  __shared__ int warp_tot[32];
  const int tid = threadIdx.x, bd = blockDim.x;
  int remaining = *npend;
  const int S = R < WALK_S ? R : WALK_S;
  int scan_from = 0;
  while (remaining > 0) {
    // the first min(S, remaining) pending positions, in position order
    int ns = 0;
    for (int base = scan_from; base < R && ns < S; base += bd) {
      const int p = base + tid;
      const int flag = p < R && pending[p];
      int total;
      const int off = block_excl_scan(flag, warp_tot, total);
      if (flag && ns + off < S) s_pos[ns + off] = p;
      ns = ns + total < S ? ns + total : S;
    }
    __syncthreads();
    scan_from = s_pos[ns - 1] + 1;
    for (int i = tid; i < ns; i += bd) {
      const int64_t k = keys[s_pos[i]];
      s_lo[i] = fp_key_lo(k);
      s_hi[i] = fp_key_hi(k);
      s_b[i] = fp_bucket(s_hi[i], lognb);
      s_st[i] = 1;
    }
    __syncthreads();
    long long rounds = 0;
    while (true) {
      // A: every pending lane reads its current bucket
      for (int i = tid; i < ns; i += bd) {
        if (s_st[i] & 1) {
          uint32_t row[2 * FP_BUCKET];
          const uint32_t* src = table + (size_t)s_b[i] * 16;
          for (int k = 0; k < 2 * FP_BUCKET; k++) row[k] = src[k];
          if (fp_row_has(row, s_lo[i], s_hi[i]))
            s_st[i] = 0;  // found: settled, not new
          else
            s_occ[i] = (uint8_t)fp_row_occ(row);
        }
      }
      __syncthreads();
      // B: compact the wanters
      int nw = 0;
      for (int base = 0; base < ns; base += bd) {
        const int i = base + tid;
        const int flag = i < ns && (s_st[i] & 1);
        int total;
        const int off = block_excl_scan(flag, warp_tot, total);
        if (flag) s_wl[nw + off] = (short)i;
        nw += total;
      }
      __syncthreads();
      if (nw == 0) break;
      // C: rank among same-bucket wanters, claim or advance
      uint32_t nextb[2];
      bool adv[2];
      for (int q = 0; q < 2; q++) {
        const int kk = tid + q * bd;
        adv[q] = false;
        if (kk < nw) {
          const int i = s_wl[kk];
          const uint32_t b = s_b[i];
          int r = 0;
          for (int m = 0; m < nw; m++) {
            const int j = s_wl[m];
            r += (s_b[j] == b && fp_less(s_lo[j], s_hi[j], s_lo[i], s_hi[i]))
                     ? 1 : 0;
          }
          const int slot = s_occ[i] + r;
          if (slot < FP_BUCKET) {
            table[(size_t)b * 16 + 2 * slot] = s_lo[i];
            table[(size_t)b * 16 + 2 * slot + 1] = s_hi[i];
            s_st[i] = 2;
          } else {
            adv[q] = true;
            nextb[q] = (b + 1u) & nb_mask;
          }
        }
      }
      __syncthreads();
      for (int q = 0; q < 2; q++)
        if (adv[q]) s_b[s_wl[tid + q * bd]] = nextb[q];
      __syncthreads();
      // a lane visits every bucket at most once before it settles; more
      // rounds mean a full table, which the engine's high-water halt
      // rules out
      if (++rounds > (long long)nb_mask + 2) __trap();
    }
    for (int i = tid; i < ns; i += bd) {
      is_new[s_pos[i]] = (s_st[i] >> 1) & 1;
      pending[s_pos[i]] = 0;
    }
    remaining -= ns;
    __syncthreads();
  }
}

extern "C" int tt_fpset_key(const void* lo, const void* hi, const void* mask,
                            long long N, void* key, void* stream) {
  const int threads = 256;
  const long long blocks = (N + threads - 1) / threads;
  if (blocks > 0)
    key_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)lo, (const uint32_t*)hi, (const uint8_t*)mask, N,
        (int64_t*)key);
  return (int)cudaGetLastError();
}

extern "C" int tt_fpset_probe(const void* table, int lognb, const void* keys,
                              int R, const void* nreps, const void* act,
                              long long off, void* slot, void* stream) {
  const int threads = 256;
  probe_kernel<<<(R + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(
      (const uint32_t*)table, lognb, (const int64_t*)keys, R,
      (const long long*)nreps, (const uint8_t*)act, off, (int32_t*)slot);
  return (int)cudaGetLastError();
}

extern "C" int tt_fpset_claim(void* table, const void* keys, int R,
                              const void* slot, const void* claim_cum, int C,
                              void* is_new, void* pending, void* npend,
                              void* stream) {
  const int threads = 256;
  claim_kernel<<<(R + threads - 1) / threads, threads, 0,
                 (cudaStream_t)stream>>>(
      (uint32_t*)table, (const int64_t*)keys, R, (const int32_t*)slot,
      (const long long*)claim_cum, C, (uint8_t*)is_new, (uint8_t*)pending,
      (int*)npend);
  return (int)cudaGetLastError();
}

extern "C" int tt_fpset_walk(void* table, int lognb, unsigned nb_mask,
                             const void* keys, int R, void* pending,
                             void* is_new, const void* npend, void* stream) {
  walk_kernel<<<1, WALK_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)table, lognb, (uint32_t)nb_mask, (const int64_t*)keys, R,
      (uint8_t*)pending, (uint8_t*)is_new, (const int*)npend);
  return (int)cudaGetLastError();
}
