// Kernel K33 "fpset_insert_batched": K3's insert-or-find (fpset.cu) over K
// stacked fingerprint tables, one launch of each stage for every lane.
//
// It replaces what jax.vmap makes of the fingerprint-set insert
// (jaxtlc/engine/fpset.py:614 fpset_insert_sorted, :546
// _sorted_dedup_probe) inside jaxtlc/serve/sweep.py:260 SweepEngine._vrun
// and jaxtlc/sim/engine.py:477 SimEngine._vrun (the walks' sampling
// filter): the batched program probes K tables at once.  The tables are
// [K, nb, 16] uint32, lane k's at table + k * nb * 16; the keys of one
// probe segment are [K, R], lane-major, each lane's sorted ascending (one
// torch.sort over (lane, key) orders them), so every stage finds a
// candidate's lane as i / R and offsets its bucket by lane * nb:
//
//   bkey    mix + remap + mask -> int64 sort keys (elementwise, as K3's);
//   bprobe  round 0 of every lane's segment against its own table: the
//           active lanes are lane k's prefix off + i < nreps[k] (sorted
//           path) or act[k, i] (the slab path's interspersed layout);
//   bclaim  writes the round-0 claims (each lane's first C fitting ones,
//           by claim_cum, its inclusive prefix count) and counts each
//           lane's stragglers into npend[k];
//   bwalk   one block a lane: K3's straggler walk (fpset_walk.cuh) over
//           that lane's table, keys and flags.
//
// A lane's table words after a launch sequence equal the single-lane K3
// path's on the same keys: the stages read and write only the lane's own
// table, in the same order.  `lanes` (nullable) maps row k of the keys to
// the table it probes, so a launch serves any subset of the stacked
// tables (the live lanes of one body width); a table no row maps to is
// not touched, and a row whose segment is all inactive (nreps[k] = 0, or
// act all zero) writes nothing.
//
// Bound: latency, as K3's - one 64-byte row gathered per candidate in
// round 0, the walk serial in rounds over the few stragglers.
#include <cuda_runtime.h>

#include "fpset_walk.cuh"

__global__ void bkey_kernel(const uint32_t* __restrict__ lo,
                            const uint32_t* __restrict__ hi,
                            const uint8_t* __restrict__ mask, long long N,
                            int64_t* __restrict__ key) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) key[i] = fp_key(lo[i], hi[i], mask[i] != 0);
}

__global__ void bprobe_kernel(const uint32_t* __restrict__ table, int lognb,
                              const int64_t* __restrict__ keys, int K, int R,
                              const int* __restrict__ lanes,
                              const long long* __restrict__ nreps,
                              const uint8_t* __restrict__ act, long long off,
                              int32_t* __restrict__ slot) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)K * R) return;
  const int lane = (int)(g / R), i = (int)(g % R);
  const int tl = lanes != nullptr ? lanes[lane] : lane;
  const uint32_t* t = table + ((size_t)tl << lognb) * 16;
  const int64_t* k = keys + (size_t)lane * R;
  const uint8_t* a = act != nullptr ? act + (size_t)lane * R : nullptr;
  slot[g] = fp_round0(t, lognb, k, a, i,
                      a != nullptr ? a[i] != 0 : off + i < nreps[lane]);
}

__global__ void bclaim_kernel(uint32_t* __restrict__ table, int lognb,
                              const int64_t* __restrict__ keys, int K, int R,
                              const int* __restrict__ lanes,
                              const int32_t* __restrict__ slot,
                              const long long* __restrict__ claim_cum, int C,
                              uint8_t* __restrict__ is_new,
                              uint8_t* __restrict__ pending,
                              int* __restrict__ npend) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)K * R) return;
  const int lane = (int)(g / R);
  const int32_t s = slot[g];
  const bool claimed =
      s >= 0 && (claim_cum == nullptr || claim_cum[g] - 1 < (long long)C);
  if (claimed) {
    const int tl = lanes != nullptr ? lanes[lane] : lane;
    uint32_t* t = table + ((size_t)tl << lognb) * 16;
    t[2 * (size_t)s] = fp_key_lo(keys[g]);
    t[2 * (size_t)s + 1] = fp_key_hi(keys[g]);
  }
  is_new[g] = claimed;
  const bool pend = s == -2 || (s >= 0 && !claimed);
  pending[g] = pend;
  if (pend) atomicAdd(&npend[lane], 1);
}

__global__ void __launch_bounds__(WALK_THREADS)
    bwalk_kernel(uint32_t* table, int lognb, uint32_t nb_mask,
                 const int64_t* __restrict__ keys, int R,
                 const int* __restrict__ lanes,
                 uint8_t* __restrict__ pending, uint8_t* __restrict__ is_new,
                 const int* __restrict__ npend, int* __restrict__ stats) {
  const int lane = blockIdx.x;
  const int tl = lanes != nullptr ? lanes[lane] : lane;
  fp_walk_block(table + ((size_t)tl << lognb) * 16, lognb, nb_mask,
                keys + (size_t)lane * R, R, pending + (size_t)lane * R,
                is_new + (size_t)lane * R, npend + lane, stats);
}

extern "C" int tt_fpset_bkey(const void* lo, const void* hi, const void* mask,
                             long long N, void* key, void* stream) {
  const int threads = 256;
  const long long blocks = (N + threads - 1) / threads;
  if (blocks > 0)
    bkey_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)lo, (const uint32_t*)hi, (const uint8_t*)mask, N,
        (int64_t*)key);
  return (int)cudaGetLastError();
}

// lanes [K] int32 or NULL (row k probes table k); nreps [K] int64 (the
// prefix mode) or act [K, R] uint8; slot [K, R] int32
extern "C" int tt_fpset_bprobe(const void* table, int lognb, const void* keys,
                               int K, int R, const void* lanes,
                               const void* nreps,
                               const void* act, long long off, void* slot,
                               void* stream) {
  const int threads = 256;
  const long long n = (long long)K * R;
  if (n > 0)
    bprobe_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                    (cudaStream_t)stream>>>(
        (const uint32_t*)table, lognb, (const int64_t*)keys, K, R,
        (const int*)lanes, (const long long*)nreps, (const uint8_t*)act, off,
        (int32_t*)slot);
  return (int)cudaGetLastError();
}

// claim_cum: NULL (C >= R) or [K, R] each lane's inclusive prefix count of
// its fitting slots; npend [K] int32 zeroed
extern "C" int tt_fpset_bclaim(void* table, int lognb, const void* keys,
                               int K, int R, const void* lanes,
                               const void* slot,
                               const void* claim_cum, int C, void* is_new,
                               void* pending, void* npend, void* stream) {
  const int threads = 256;
  const long long n = (long long)K * R;
  if (n > 0)
    bclaim_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                    (cudaStream_t)stream>>>(
        (uint32_t*)table, lognb, (const int64_t*)keys, K, R,
        (const int*)lanes, (const int32_t*)slot, (const long long*)claim_cum,
        C, (uint8_t*)is_new, (uint8_t*)pending, (int*)npend);
  return (int)cudaGetLastError();
}

// stats: NULL or int32 [3] counters summed over the lanes (as K3's)
extern "C" int tt_fpset_bwalk(void* table, int lognb, unsigned nb_mask,
                              const void* keys, int K, int R,
                              const void* lanes, void* pending, void* is_new,
                              const void* npend, void* stats, void* stream) {
  if (K > 0)
    bwalk_kernel<<<K, WALK_THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t*)table, lognb, (uint32_t)nb_mask, (const int64_t*)keys, R,
        (const int*)lanes, (uint8_t*)pending, (uint8_t*)is_new,
        (const int*)npend, (int*)stats);
  return (int)cudaGetLastError();
}
