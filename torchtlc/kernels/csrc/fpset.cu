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
//                (the reference's dense [S, S] rank, computed as a rank
//                inside the lane's home run: fpset_walk.cuh), the fitting
//                ones claim, the rest advance to the next bucket.
//                __syncthreads separates the read, count and claim phases,
//                so no host round trip happens per round.
//
// Bound: latency.  Round 0 gathers one 64-byte row per candidate (R rows);
// the walk is serial in rounds, one dependent row read each, and touches
// only the few stragglers.
//
// Kernel K9 "fpset_member" (member_kernel below) replaces
// jaxtlc/engine/fpset.py:292 fpset_member, the device filter of the host
// spill tier (jaxtlc/engine/spill.py:319-325): a read-only membership walk,
// one thread per lane.  The reference's while_loop runs every lane to the
// worst lane's round; lanes do not interact, so each thread here walks its
// own rows and stops at its first hit or non-full row, which gives the
// same per-lane answer.  Bound: bytes - each lane reads its 9 input bytes,
// writes one, and gathers one 64-byte row per round it walks (four 16-byte
// loads); at the spill's 0.85 load most lanes stop after one or two rows.
#include <cuda_runtime.h>

#include "fpset_walk.cuh"

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

__global__ void __launch_bounds__(WALK_THREADS)
    walk_kernel(uint32_t* table, int lognb, uint32_t nb_mask,
                const int64_t* __restrict__ keys, int R,
                uint8_t* __restrict__ pending, uint8_t* __restrict__ is_new,
                const int* __restrict__ npend, int* __restrict__ stats) {
  fp_walk_block(table, lognb, nb_mask, keys, R, pending, is_new, npend,
                stats);
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

// stats: NULL or int32 [3] counters (slices, rounds, general-order
// slices) the walk adds to
extern "C" int tt_fpset_walk(void* table, int lognb, unsigned nb_mask,
                             const void* keys, int R, void* pending,
                             void* is_new, const void* npend, void* stats,
                             void* stream) {
  walk_kernel<<<1, WALK_THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)table, lognb, (uint32_t)nb_mask, (const int64_t*)keys, R,
      (uint8_t*)pending, (uint8_t*)is_new, (const int*)npend, (int*)stats);
  return (int)cudaGetLastError();
}

__global__ void member_kernel(const uint32_t* __restrict__ table, int lognb,
                              uint32_t nb_mask,
                              const uint32_t* __restrict__ lo,
                              const uint32_t* __restrict__ hi,
                              const uint8_t* __restrict__ mask, long long N,
                              long long max_rounds,
                              uint8_t* __restrict__ found) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  long long rows;
  found[i] = fp_member_lane(table, lognb, nb_mask, lo[i], hi[i], mask[i] != 0,
                            max_rounds, &rows);
}

extern "C" int tt_fpset_member(const void* table, int lognb, unsigned nb_mask,
                               const void* lo, const void* hi,
                               const void* mask, long long N,
                               long long max_rounds, void* found,
                               void* stream) {
  const int threads = 256;
  const long long blocks = (N + threads - 1) / threads;
  if (blocks > 0)
    member_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, lognb, (uint32_t)nb_mask, (const uint32_t*)lo,
        (const uint32_t*)hi, (const uint8_t*)mask, N, max_rounds,
        (uint8_t*)found);
  return (int)cudaGetLastError();
}
