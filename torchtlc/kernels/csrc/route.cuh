// Per-element logic of the sharded engine's route, verdict and enqueue
// kernels (K11-K13, route.cu) as __host__ __device__ functions.
//
// Replaces, in jaxtlc/engine/sharded.py: the owner and the route of
// expand_half (:375, :553-578), the verdict return of commit_half
// (:691-719, and its pipelined form :485-505) and the owner-side circular
// enqueue (:685-689).  The shards live in one process: the all_to_all is a
// layout - source shard s writes its bucket for owner o at [o, s] of the
// [D, D, B] exchange planes, so owner o's received batch [o].reshape(D*B)
// is the reference's recv.reshape(D*B, .) row for row.
#pragma once
#include "common.cuh"

#define ROUTE_MAX_SHARDS 8

// the owner key of a candidate: hi & (D - 1) when valid, D (sorts last)
// when not - the reference's jnp.where(fvalid, own, D)
HD int route_key(uint32_t hi, bool valid, int D) {
  return valid ? (int)(hi & (uint32_t)(D - 1)) : D;
}

// the verdict a source shard reads back for its sorted lane (owner `own`,
// bucket position `pos`): the owner's is_new at [own, src, pos], clipped
// as the reference clips its gather, and only for a valid lane that fit
// its bucket
HD bool route_got(const uint8_t* verd, int D, int B, int src, int own,
                  int pos, bool svalid) {
  const int o = own < 0 ? 0 : (own > D - 1 ? D - 1 : own);
  const int p = pos < 0 ? 0 : (pos > B - 1 ? B - 1 : pos);
  return verd[((size_t)o * D + src) * B + p] == 1 && svalid && pos < B;
}

// The owner-side enqueue of received row i (of n): a fresh row goes to
// queue row (qtail + cum_i - 1) % qcap (cum: the inclusive count of fresh
// rows), every other row to the dump row qcap - all of them when the
// queue is full.  The reference scatters all the others into the dump
// row and its last one stays (XLA's scatter writes in index order), so
// the row kept there is the last row that is not enqueued: the one row
// after which every row is enqueued.  Returns the target row, or -1 for a
// row whose dump write is overwritten.
HD long long enqueue_target(bool is_new, bool q_full, long long qtail,
                            long long cum_i, long long cum_last, long long i,
                            long long n, int qcap) {
  if (is_new && !q_full) return (qtail + cum_i - 1) % qcap;
  const long long after = q_full ? 0 : cum_last - cum_i;
  return after == n - 1 - i ? (long long)qcap : -1;
}
