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

// -- the straggler walk's claim rank (fpset_walk.cuh, host_launch.cpp) ------
//
// A walk slice holds ns pending lanes in position order: home bucket
// home[i], key words lo[i], hi[i].  Every lane still pending after a
// round advances exactly one bucket, so at round k each pending lane
// sits at home + k (mod nb): two lanes meet in a bucket only when they
// share a home.  The reference ranks a bucket's wanters by ascending
// (lo, hi) among ALL wanters of the slice (its dense [S, S] form); here
// the slice is ordered once by (home, lo, hi), and a wanter's rank is the
// number of wanters between its home run's first sorted position and its
// own - one exclusive prefix count of the round's wanters.  The callers'
// blocks are sorted by key, so the homes ascend along the slice and a
// run is found by walking to its ends; a slice whose homes do not ascend
// (fp_slice_descends) takes the exact general form, which counts over the
// whole slice.

// whether slice entry i breaks the ascending homes (i > 0)
HD bool fp_slice_descends(const uint32_t* home, int i) {
  return i > 0 && home[i] < home[i - 1];
}

// Sorted position `pos` of slice entry i by (home, lo, hi, i) and the
// sorted position `rs` of the first entry of its home run.  general:
// the homes need not ascend (O(ns) per entry); else the run is the
// contiguous stretch of entries sharing home[i] (O(run)).
HD void fp_slice_order(const uint32_t* home, const uint32_t* lo,
                       const uint32_t* hi, int ns, int i, bool general,
                       int* pos, int* rs) {
  const uint32_t h = home[i];
  int a = 0, e = ns;
  if (!general) {
    a = i;
    while (a > 0 && home[a - 1] == h) a--;
    e = i + 1;
    while (e < ns && home[e] == h) e++;
  }
  int below = 0, rank = 0;
  for (int j = a; j < e; j++) {
    if (home[j] < h)
      below++;
    else if (home[j] == h && j != i &&
             (fp_less(lo[j], hi[j], lo[i], hi[i]) ||
              (lo[j] == lo[i] && hi[j] == hi[i] && j < i)))
      rank++;
  }
  *rs = a + below;
  *pos = a + below + rank;
}

// One 64-byte bucket row into registers: four 16-byte loads on the card,
// through the read-only data cache unless kCoherent (the walk reads rows
// its own block wrote in earlier rounds).
template <bool kCoherent = false>
HD void fp_load_row(const uint32_t* table, uint32_t b, uint32_t* row) {
#if defined(__CUDA_ARCH__)
  const uint4* src = reinterpret_cast<const uint4*>(table + (size_t)b * 16);
  for (int q = 0; q < 4; q++) {
    const uint4 v = kCoherent ? src[q] : __ldg(src + q);
    row[4 * q] = v.x;
    row[4 * q + 1] = v.y;
    row[4 * q + 2] = v.z;
    row[4 * q + 3] = v.w;
  }
#else
  for (int k = 0; k < 2 * FP_BUCKET; k++) row[k] = table[(size_t)b * 16 + k];
#endif
}

// Membership walk of one raw fingerprint (kernel K9, the reference's
// fpset_member): mix + remap, then bucket rows b, b+1, ... mod nb until a
// word-exact match (found) or a row with an empty slot (absent).  A
// positive max_rounds caps the rows read (an unresolved lane reports
// false); max_rounds == 0 walks at most nb rows, a bound that binds only
// on a full table.  *rows gets the number of rows read.
HD bool fp_member_lane(const uint32_t* table, int lognb, uint32_t nb_mask,
                       uint32_t lo, uint32_t hi, bool mask,
                       long long max_rounds, long long* rows) {
  *rows = 0;
  if (!mask) return false;
  const int64_t k = fp_key(lo, hi, true);
  const uint32_t mlo = fp_key_lo(k), mhi = fp_key_hi(k);
  uint32_t b = fp_bucket(mhi, lognb);
  const long long limit =
      max_rounds > 0 ? max_rounds : (long long)nb_mask + 1;
  for (long long r = 0; r < limit; r++) {
    uint32_t row[2 * FP_BUCKET];
    fp_load_row(table, b, row);
    *rows = r + 1;
    if (fp_row_has(row, mlo, mhi)) return true;
    if (fp_row_occ(row) < FP_BUCKET) return false;
    b = (b + 1u) & nb_mask;
  }
  return false;
}
