// Per-element logic of the device liveness plane: K14 "edge_capture", K15
// "state_masks", K16 "survive_sweep" (liveness.cu builds the grids,
// host_launch.cpp the CPU loops of the host tests).
#pragma once
#include "common.cuh"

#define MASK_MAX_API 32
#define MASK_MAX_SR 16

// ---------------------------------------------------------------------------
// K14: a successor's id by a lexicographic (hi, lo) lower bound over the
// fingerprint-sorted states (jaxtlc/live/capture.py:117 _pair_searchsorted:
// the same `rounds` = max(1, bit_length(n - 1)) rounds, unsigned compares).
// ---------------------------------------------------------------------------

HD int pair_lower_bound(const uint32_t* s_hi, const uint32_t* s_lo, int n,
                        int rounds, uint32_t qh, uint32_t ql) {
  int lo = 0, hi = n;
  for (int r = 0; r < rounds; r++) {
    if (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int m = mid < n - 1 ? mid : n - 1;
      const uint32_t mh = s_hi[m], ml = s_lo[m];
      const bool less = mh < qh || (mh == qh && ml < ql);
      if (less)
        lo = mid + 1;
      else
        hi = mid;
    }
  }
  return lo;
}

// lane i: dst[i] = perm[idx], changed[i] = dst != src; returns whether a
// valid lane's fingerprint is missing from the sorted states
HD bool edge_search_lane(long long i, const uint32_t* s_hi,
                         const uint32_t* s_lo, const int32_t* perm, int n,
                         int rounds, const uint32_t* q_hi,
                         const uint32_t* q_lo, const uint8_t* valid, int L,
                         int offset, int32_t* dst, uint8_t* changed) {
  const uint32_t qh = q_hi[i], ql = q_lo[i];
  const int idx = pair_lower_bound(s_hi, s_lo, n, rounds, qh, ql);
  const int c = idx < n - 1 ? idx : n - 1;
  const bool found = s_hi[c] == qh && s_lo[c] == ql && idx < n;
  const int32_t d = perm[c];
  const int32_t src = offset + (int32_t)(i / L);
  dst[i] = d;
  changed[i] = d != src;
  return valid[i] && !found;
}

// lane i of the stable compaction: a valid lane's edge (src, dst, action,
// changed) at row cum[i] - 1 (cum: inclusive counts of the valid lanes)
HD void edge_compact_lane(long long i, const uint8_t* valid,
                          const long long* cum, int L, int offset,
                          const int32_t* dst, const uint8_t* changed,
                          const int32_t* action, int32_t* edges) {
  if (!valid[i]) return;
  int32_t* e = edges + (size_t)(cum[i] - 1) * 4;
  e[0] = offset + (int32_t)(i / L);
  e[1] = dst[i];
  e[2] = action[i];
  e[3] = changed[i];
}

// ---------------------------------------------------------------------------
// K15: the property operands of one packed state (jaxtlc/live/capture.py:252
// eval_state_masks with the sr and secret predicates of
// jaxtlc/live/check.py:99-117): row k < nr is sr[k] == 1, row nr + j is
// "some apiState slot holds a present object with identity sec_ident[j]".
// ---------------------------------------------------------------------------

struct MaskParams {
  int32_t W;          // packed words a state
  int32_t o_present;  // object word: present bit
  int32_t o_ident;    // object word: identity bits
  int32_t ib;         // identity width
  int32_t obj_bits;   // object word width
  int32_t n_api;      // apiState slots
  int32_t nr;         // sr bits (reconcilers)
  int32_t n_sec;      // secret predicates
  int32_t api_off[MASK_MAX_API];  // packed bit offset of each api slot
  int32_t sr_off[MASK_MAX_SR];    // packed bit offset of each sr bit
  int32_t sec_ident[MASK_MAX_SR];
};

HD uint32_t packed_bits(const uint32_t* row, int off, int width) {
  const int w = off >> 5, b = off & 31;
  uint64_t x = row[w];
  if (b + width > 32) x |= (uint64_t)row[w + 1] << 32;
  return (uint32_t)((x >> b) & ((1ull << width) - 1));
}

HD void state_masks_row(const MaskParams& p, const uint32_t* row, long long v,
                        long long V, uint8_t* out) {
  for (int k = 0; k < p.nr; k++)
    out[(size_t)k * V + v] = packed_bits(row, p.sr_off[k], 1) == 1;
  for (int j = 0; j < p.n_sec; j++) {
    bool hit = false;
    for (int a = 0; a < p.n_api; a++) {
      const uint32_t obj = packed_bits(row, p.api_off[a], p.obj_bits);
      const uint32_t ident = (obj >> p.o_ident) & ((1u << p.ib) - 1);
      hit |= ((obj >> p.o_present) & 1) == 1 &&
             ident == (uint32_t)p.sec_ident[j];
    }
    out[(size_t)(p.nr + j) * V + v] = hit;
  }
}

// ---------------------------------------------------------------------------
// K16: one Jacobi sweep of the survive-set greatest fixpoint
// (jaxtlc/live/fixpoint.py:41 surviving_set; engine/sharded.py:1490 with
// the edges in D slices).  Scatter: edge e of slice d marks
// support[d, src[e]] when alive[dst[e]] (src outside [0, V) is padding and
// dropped).  Update: alive2[v] = alive[v] & (term[v] | any_d support[d, v]).
// ---------------------------------------------------------------------------

HD void survive_scatter_edge(long long e, const int32_t* src,
                             const int32_t* dst, const uint8_t* alive,
                             long long slice, long long V, uint8_t* support) {
  const int32_t s = src[e];
  if (s < 0 || s >= V || !alive[dst[e]]) return;
  support[(size_t)(e / slice) * V + s] = 1;
}

HD uint8_t survive_update_state(long long v, const uint8_t* alive,
                                const uint8_t* term, const uint8_t* support,
                                int D, long long V) {
  int sup = 0;
  for (int d = 0; d < D; d++) sup += support[(size_t)d * V + v];
  return alive[v] && (term[v] || sup > 0);
}
