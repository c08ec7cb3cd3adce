// Fingerprint-set per-lane logic of kernel K3 (fpset.cu) as __host__
// __device__ functions.
//
// Replaces jaxtlc/engine/fpset.py:_remap/_fmix32/_mix/_bucket_of (the key
// step) and the round 0 of _probe_block (gather, hit test, occupancy,
// rank-in-run claim).  The table is [nb, 16] uint32 rows of 8 interleaved
// (lo, hi) slots; a slot id s lives at words 2s, 2s+1.
#pragma once
#include "common.cuh"

#define FP_BUCKET 8

// sort key: ((hi ^ 0x80000000) << 32) | lo read as int64, so the signed
// sort orders by unsigned (hi, lo) and the reserved (0, 0) pair sorts first
HD int64_t fp_make_key(uint32_t lo, uint32_t hi) {
  return (int64_t)(((uint64_t)(hi ^ 0x80000000u) << 32) | (uint64_t)lo);
}
HD uint32_t fp_key_lo(int64_t k) { return (uint32_t)(uint64_t)k; }
HD uint32_t fp_key_hi(int64_t k) {
  return (uint32_t)((uint64_t)k >> 32) ^ 0x80000000u;
}

HD uint32_t fp_fmix32(uint32_t h) {  // murmur3 finalizer
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// mixed + remapped key of a fingerprint; a masked-off lane gets key(0, 0)
HD int64_t fp_key(uint32_t lo, uint32_t hi, bool mask) {
  const uint32_t C[3] = {0x9E3779B9u, 0x517CC1B7u, 0x27220A95u};
  for (int r = 0; r < 3; r++) {  // 3-round Feistel avalanche
    uint32_t nhi = lo ^ fp_fmix32(hi + C[r]);
    lo = hi;
    hi = nhi;
  }
  if (lo == 0u && hi == 0u) lo = 1u;  // (0, 0) is the empty marker
  return mask ? fp_make_key(lo, hi) : fp_make_key(0u, 0u);
}

HD uint32_t fp_bucket(uint32_t hi, int lognb) {
  return lognb == 0 ? 0u : hi >> (32 - lognb);
}

HD bool fp_row_has(const uint32_t* row, uint32_t lo, uint32_t hi) {
  bool f = false;
  for (int k = 0; k < FP_BUCKET; k++)
    f = f || (row[2 * k] == lo && row[2 * k + 1] == hi);
  return f;
}

HD int fp_row_occ(const uint32_t* row) {
  int n = 0;
  for (int k = 0; k < FP_BUCKET; k++)
    n += (row[2 * k] != 0u || row[2 * k + 1] != 0u) ? 1 : 0;
  return n;
}

// Round 0 for lane i of a sorted key block whose active lanes are
// duplicate-free, against the table as it was before any claim of this
// round:
//   -1  nothing to claim (inactive, or already stored in the home bucket)
//   -2  a wanter that does not fit its home bucket (walks)
//  >=0  the slot id it claims: occupancy + rank among the run's wanters.
// The run's earlier lanes share this lane's bucket row, so the rank needs
// no other lane's result; the walk back stops once the bucket is full.
// `act` (nullable) marks the active lanes when they are not a prefix (the
// slab path's layout: duplicate rows of slab-collision classes sit
// between the actives); the walk back skips the inactive ones, so it is
// bounded by 16 steps plus the inactive rows inside the run.
HD int32_t fp_round0(const uint32_t* table, int lognb, const int64_t* keys,
                     const uint8_t* act, int i, bool active) {
  if (!active) return -1;
  const uint32_t lo = fp_key_lo(keys[i]), hi = fp_key_hi(keys[i]);
  const uint32_t b = fp_bucket(hi, lognb);
  uint32_t row[2 * FP_BUCKET];
  for (int k = 0; k < 2 * FP_BUCKET; k++) row[k] = table[(size_t)b * 16 + k];
  if (fp_row_has(row, lo, hi)) return -1;
  const int occ = fp_row_occ(row);
  int rank = 0;
  for (int j = i - 1; j >= 0 && occ + rank < FP_BUCKET; j--) {
    uint32_t hj = fp_key_hi(keys[j]);
    if (fp_bucket(hj, lognb) != b) break;
    if (act != nullptr && !act[j]) continue;
    if (!fp_row_has(row, fp_key_lo(keys[j]), hj)) rank++;
  }
  return occ + rank < FP_BUCKET ? (int32_t)(b * FP_BUCKET + occ + rank) : -2;
}

// ascending (lo, hi) order of two stragglers: the walk's claim rank
HD bool fp_less(uint32_t lo_a, uint32_t hi_a, uint32_t lo_b, uint32_t hi_b) {
  return lo_a < lo_b || (lo_a == lo_b && hi_a < hi_b);
}
