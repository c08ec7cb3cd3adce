// Per-column logic of the observability ring row (kernel K8, ring.cu) as
// __host__ __device__ functions.
//
// Replaces jaxtlc/obs/counters.py:pack_row (:106, with COL_SPILL from
// :32-35 and the sticky COL_CERT of :36-42, 105-121), wrapped_any (:150, over the pairs jaxtlc/engine/bfs.py:632-645
// gives it, the coverage counters' included) and
// the row layout of the module docstring: 10 fixed uint32 columns, then
// the per-action generated and distinct counters.  The port's counters are
// int64; a column holds the low 32 bits, as the reference's wrapping
// uint32 counters do.
#pragma once
#include "common.cuh"

#define RING_N_FIXED 10
#define RING_COL_OVERFLOW 6

HD uint32_t ring_lo32(long long v) { return (uint32_t)(unsigned long long)v; }

// a cumulative counter's uint32 view wrapped between old and new
HD bool ring_wrapped(long long nw, long long old) {
  return ring_lo32(nw) < ring_lo32(old);
}

// any counter of a span whose uint32 view wrapped: the pairs
// (nw[k], old[k]) for k = first, first + step, ... < n
HD bool ring_any_wrapped(const long long* nw, const long long* old, int n,
                         int first, int step) {
  bool w = false;
  for (int k = first; k < n; k += step) w = w || ring_wrapped(nw[k], old[k]);
  return w;
}

struct RingScalars {
  long long level, generated, distinct, queue, bodies, expanded;
  uint32_t overflow;
  long long spill;  // spill_hits in spill mode, else 0
  uint32_t cert;    // the carry's sticky certificate flag, else 0
  uint32_t sym;     // the carry's sticky orbit-certificate flag, else 0
};

// column `col` of the row; act_gen / act_dist hold n_labels counters
HD uint32_t ring_cell(const RingScalars& v, const long long* act_gen,
                      const long long* act_dist, int n_labels, int col) {
  switch (col) {
    case 0: return ring_lo32(v.level);
    case 1: return ring_lo32(v.generated);
    case 2: return ring_lo32(v.distinct);
    case 3: return ring_lo32(v.queue);
    case 4: return ring_lo32(v.bodies);
    case 5: return ring_lo32(v.expanded);
    case RING_COL_OVERFLOW: return v.overflow;
    case 7: return ring_lo32(v.spill);
    case 8: return v.cert;
    case 9: return v.sym;
    default: break;
  }
  const int k = col - RING_N_FIXED;
  return ring_lo32(k < n_labels ? act_gen[k] : act_dist[k - n_labels]);
}
