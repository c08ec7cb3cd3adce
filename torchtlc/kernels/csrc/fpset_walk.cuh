// The straggler walk of kernel K3 (fpset.cu) as a block-wide device
// function over one table, shared by K3's walk kernel and by K33's
// (fpset_batched.cu), which runs one block of it per lane's table.
// Stragglers are settled in slices of S = min(R, 2048) taken in position
// order; each round every pending lane re-reads its current bucket,
// wanters of one bucket rank by ascending (lo, hi), the fitting ones
// claim, the rest advance.  Every thread of the block must call it.
//
// The rank (fpset.cuh, fp_slice_order): each slice is ordered once by
// (home, lo, hi), and thread t owns sorted entries 2t and 2t+1 for the
// whole slice, in registers.  A round is one row read per pending entry
// (four 16-byte loads), one block-wide exclusive count of the wanters in
// sorted order (two ballots a warp, the warp totals and ballots through
// shared memory, every warp scanning the totals itself), and the claims:
// a wanter's rank is the count at its own entry less the count at its
// home run's first entry.  Two __syncthreads a round.
#pragma once
#include <cuda_runtime.h>

#include "fpset.cuh"

#define WALK_THREADS 1024
#define WALK_S 2048

// Inclusive prefix of the per-warp values v_w held by lane w (0 beyond
// the block's warps), as every lane of a warp sees it.
__device__ int warp_scan_totals(const int* warp_tot, int nwarps) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int w = lane < nwarps ? warp_tot[lane] : 0;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(full, w, o);
    if (lane >= o) w += t;
  }
  return w;
}

// Exclusive block-wide prefix sum of `v` (>= 0); every thread must call
// it.  Two barriers: the warp totals' writes, then their reuse.
__device__ int block_excl_sum(int v, int* warp_tot, int& total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(full, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  const int w = warp_scan_totals(warp_tot, blockDim.x >> 5);
  total = __shfl_sync(full, w, 31);
  const int base = __shfl_sync(full, w, (warp + 31) & 31);
  __syncthreads();
  return (warp == 0 ? 0 : base) + inc - v;
}

// stats (nullable, int32 [3]): slices, rounds, and slices whose homes did
// not ascend (the general order), added to
__device__ void fp_walk_block(uint32_t* table, int lognb, uint32_t nb_mask,
                              const int64_t* __restrict__ keys, int R,
                              uint8_t* __restrict__ pending,
                              uint8_t* __restrict__ is_new,
                              const int* __restrict__ npend,
                              int* __restrict__ stats) {
  __shared__ uint32_t s_lo[WALK_S], s_hi[WALK_S], s_home[WALK_S];
  __shared__ int s_pos[WALK_S];
  __shared__ short s_ord[WALK_S], s_rs[WALK_S];
  __shared__ unsigned s_bal[2][32];
  __shared__ int warp_tot[32];
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = bd >> 5;
  const unsigned below_me = (1u << lane) - 1u;
  int remaining = *npend;
  const int S = R < WALK_S ? R : WALK_S;
  int scan_from = 0;
  int n_slices = 0, n_general = 0, n_rounds = 0;
  // the pending bytes are read 16 at a time from 16-byte aligned chunks;
  // the bytes of a chunk outside [scan_from, R) are ignored
  const int mis = (int)((uintptr_t)pending & 15);
  const uint8_t* aligned = pending - mis;
  while (remaining > 0) {
    // the first min(S, remaining) pending positions, in position order
    int ns = 0;
    for (long long c0 = (scan_from + mis) >> 4;
         ns < S && c0 * 16 - mis < R; c0 += bd) {
      const long long c = c0 + tid;
      const long long p0 = c * 16 - mis;
      uint32_t bits = 0;
      if (p0 < R) {
        const uint4 v = *reinterpret_cast<const uint4*>(aligned + c * 16);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 16; k++) {
          const long long p = p0 + k;
          if (p >= scan_from && p < R &&
              ((w[k >> 2] >> (8 * (k & 3))) & 0xffu))
            bits |= 1u << k;
        }
      }
      int total;
      int off = ns + block_excl_sum(__popc(bits), warp_tot, total);
      while (bits && off < S) {
        const int k = __ffs(bits) - 1;
        bits &= bits - 1;
        s_pos[off++] = (int)(p0 + k);
      }
      ns = ns + total < S ? ns + total : S;
    }
    if (ns == 0) break;  // npend over-counted: nothing left pending
    __syncthreads();
    scan_from = s_pos[ns - 1] + 1;
    for (int i = tid; i < ns; i += bd) {
      const int64_t k = keys[s_pos[i]];
      s_lo[i] = fp_key_lo(k);
      s_hi[i] = fp_key_hi(k);
      s_home[i] = fp_bucket(s_hi[i], lognb);
    }
    __syncthreads();
    int desc = 0;
    for (int i = tid; i < ns; i += bd) desc |= fp_slice_descends(s_home, i);
    const bool general = __syncthreads_or(desc) != 0;
    for (int i = tid; i < ns; i += bd) {
      int pos, rs;
      fp_slice_order(s_home, s_lo, s_hi, ns, i, general, &pos, &rs);
      s_ord[pos] = (short)i;
      s_rs[pos] = (short)rs;
    }
    __syncthreads();
    // this thread's sorted entries 2t + q: bucket, key, run start, state
    // (bit 0 pending, bit 1 claimed)
    uint32_t b[2] = {0u, 0u}, lo[2] = {0u, 0u}, hi[2] = {0u, 0u};
    int rs[2] = {0, 0}, st[2] = {0, 0};
    for (int q = 0; q < 2; q++) {
      const int e = 2 * tid + q;
      if (e < ns) {
        const int i = s_ord[e];
        b[q] = s_home[i];
        lo[q] = s_lo[i];
        hi[q] = s_hi[i];
        rs[q] = s_rs[e];
        st[q] = 1;
      }
    }
    int rounds = 0;
    while (true) {
      // A: every pending entry reads its current bucket
      bool want[2];
      int occ[2] = {0, 0};
      for (int q = 0; q < 2; q++) {
        want[q] = false;
        if (st[q] & 1) {
          uint32_t row[2 * FP_BUCKET];
          fp_load_row<true>(table, b[q], row);
          if (fp_row_has(row, lo[q], hi[q])) {
            st[q] = 0;  // found: settled, not new
          } else {
            occ[q] = fp_row_occ(row);
            want[q] = true;
          }
        }
      }
      // B: the wanters' exclusive count in sorted order
      const unsigned b0 = __ballot_sync(full, want[0]);
      const unsigned b1 = __ballot_sync(full, want[1]);
      if (lane == 0) {
        s_bal[0][warp] = b0;
        s_bal[1][warp] = b1;
        warp_tot[warp] = __popc(b0) + __popc(b1);
      }
      __syncthreads();
      const int inc = warp_scan_totals(warp_tot, nwarps);
      const int nw = __shfl_sync(full, inc, 31);
      if (nw == 0) break;  // uniform: every warp scanned the same totals
      // lane r holds the count before warp r
      const int exc = inc - (lane < nwarps ? warp_tot[lane] : 0);
      const int my_base = __shfl_sync(full, exc, warp);
      // C: rank inside the home run, claim or advance
      for (int q = 0; q < 2; q++) {
        const int er = rs[q];
        const int rw = er >> 6, rl = (er >> 1) & 31;
        const int run_base = __shfl_sync(full, exc, rw);
        if (!want[q]) continue;
        const unsigned rlt = (1u << rl) - 1u;
        const unsigned r0 = s_bal[0][rw], r1 = s_bal[1][rw];
        const int at_run = run_base + __popc(r0 & rlt) + __popc(r1 & rlt) +
                           ((er & 1) ? (int)((r0 >> rl) & 1u) : 0);
        const int at_me = my_base + __popc(b0 & below_me) +
                          __popc(b1 & below_me) + (q == 1 && want[0]);
        const int slot = occ[q] + at_me - at_run;
        if (slot < FP_BUCKET) {
          table[(size_t)b[q] * 16 + 2 * slot] = lo[q];
          table[(size_t)b[q] * 16 + 2 * slot + 1] = hi[q];
          st[q] = 2;
        } else {
          b[q] = (b[q] + 1u) & nb_mask;
        }
      }
      __syncthreads();
      // an entry visits every bucket at most once before it settles; more
      // rounds mean a full table, which the engine's high-water halt
      // rules out
      if (++rounds > (long long)nb_mask + 2) __trap();
    }
    __syncthreads();  // the last round's totals are read before reuse
    for (int q = 0; q < 2; q++) {
      const int e = 2 * tid + q;
      if (e < ns) {
        const int p = s_pos[s_ord[e]];
        is_new[p] = (uint8_t)((st[q] >> 1) & 1);
        pending[p] = 0;
      }
    }
    remaining -= ns;
    n_slices++;
    n_general += general ? 1 : 0;
    n_rounds += rounds + 1;
    __syncthreads();
  }
  if (stats != nullptr && tid == 0) {
    atomicAdd(&stats[0], n_slices);
    atomicAdd(&stats[1], n_rounds);
    atomicAdd(&stats[2], n_general);
  }
}
