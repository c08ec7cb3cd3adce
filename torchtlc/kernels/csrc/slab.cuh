// Per-lane logic of the sort-free slab dedup (kernels K5 and K6, slab.cu)
// as __host__ __device__ functions.
//
// Replaces the elementwise parts of jaxtlc/engine/fpset.py:
// _slab_dedup_core (:659: the slab cell hash, the winner resolve) and
// _order_and_dedup (:726: the ordering key, the last-of-group mask).
// Keys are fpset_key's int64 sort keys: their (lo, hi) words are the
// mixed, remapped, masked fingerprint words the reference hashes, and
// equal keys are equal fingerprints.
#pragma once
#include "fpset.cuh"

#define SLAB_KEY_PAD 0x7FFFFFFFFFFFFFFFLL  // sorts after every real key

// per-pass hash constant (the reference's _SLAB_CONSTS, cycled)
HD uint32_t slab_const(int pass) {
  switch (pass & 3) {
    case 0: return 0x9E3779B9u;
    case 1: return 0x85EBCA6Bu;
    case 2: return 0xC2B2AE35u;
    default: return 0x27D4EB2Fu;
  }
}

// slab cell of a key in pass `pass`: (fmix32(lo + c) ^ hi) & (m - 1)
HD uint32_t slab_cell(int64_t key, int pass, uint32_t mmask) {
  return (fp_fmix32(fp_key_lo(key) + slab_const(pass)) ^ fp_key_hi(key)) &
         mmask;
}

// After a pass's scatter-max of lane + 1: whether unresolved lane `lane`
// stays unresolved.  The cell's winner resolves the whole class when it
// holds the same fingerprint (equal fingerprints share a cell, so the
// winner is the class's highest lane); `rep` is set for the winner itself.
HD bool slab_still_unresolved(const int64_t* keys, uint32_t win,
                              long long lane, long long n, bool& rep) {
  long long wl = (long long)win - 1;
  wl = wl < 0 ? 0 : (wl > n - 1 ? n - 1 : wl);
  const bool same = keys[wl] == keys[lane];
  if (same && wl == lane) rep = true;
  return !same;
}

// ordering key of claimant row i: the claimant's key, padding last
HD int64_t slab_order_key(const int64_t* keys, const int32_t* c_lane,
                          long long i, long long n_cand) {
  return i < n_cand ? keys[c_lane[i]] : SLAB_KEY_PAD;
}

// row i of the R-row ordered claimant slice: its lane (sentinel n on
// padding) and whether it is the last row of its fingerprint group (the
// class representative: unresolved duplicates sort adjacent,
// lane-ascending).  Row R - 1 closes its group: when the claimants exceed
// R (the batch then takes the sorted fallback) no row R exists to compare.
HD void slab_mark_row(const int64_t* s_key, const int64_t* perm,
                      const int32_t* c_lane, long long i, long long R,
                      long long n_cand, long long n, int64_t* c_idx,
                      uint8_t* active) {
  const long long p = perm[i];
  c_idx[i] = p < n_cand ? (int64_t)c_lane[p] : (int64_t)n;
  active[i] = i < n_cand &&
              (i + 1 == n_cand || i + 1 == R || s_key[i + 1] != s_key[i]);
}
