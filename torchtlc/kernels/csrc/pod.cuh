// Per-element logic of the pod kernels K36-K38 (pod.cu) as __host__
// __device__ functions.
//
// A pod is H processes, each holding S = D / H of the D fingerprint-space
// shards (rows [p*S, (p+1)*S) on process p; the owner of a state stays
// hi & (D - 1)).  The reference runs its sharded body on one global mesh,
// where the candidate exchange is one all_to_all of [D, B, F+3] words
// (jaxtlc/engine/sharded.py:572-587) and the fences are pmax / psum over
// the shard axis (:764, :776-777, :822); its run_pod gathers the
// statistic leaves with one all_gather (jaxtlc/dist/pod.py:224).  The
// port's collectives are torch.distributed calls; these kernels lay the
// buffers out for them:
//
// * K36 pod_exchange_pack: K11's planes of this process's sources -
//   rows [D, S, B, F], lo, hi [D, S, B] int32 and valid [D, S, B] bool -
//   into one [D, S, B, F+3] int32 send buffer, the reference's lane of F
//   fields, lo, hi, valid.  The owner axis is process-major, so the buffer
//   is already grouped by destination process ([H, S owner, S source, B,
//   F+3]) and the exchange is one all_to_all;
// * K37 pod_exchange_unpack: the received [H, S owner, S source, B, F+3]
//   buffer into this process's owner planes [S owner, D source, B, .]: the
//   global source of (process p, local source s) is p*S + s, so each
//   owner sees its lanes in the order the in-process engine gives them;
// * K38 pod_stats_pack: up to POD_PACK_MAX leaves of S rows each (int64,
//   int32 or one-byte words, of any width) into one [S, W] int64 row a
//   shard - the payload of the stats gather and of the body's fence.
#pragma once
#include "common.cuh"

#define POD_PACK_MAX 24

// word j (of F + 3) of send lane `lane`
HD int32_t pod_pack_word(const int32_t* xrows, const int32_t* xlo,
                         const int32_t* xhi, const uint8_t* xvalid,
                         long long lane, int F, int j) {
  if (j < F) return xrows[(size_t)lane * F + j];
  if (j == F) return xlo[lane];
  if (j == F + 1) return xhi[lane];
  return xvalid[lane] ? 1 : 0;
}

// the received lane that lands at owner plane lane (o, g, b): process
// p = g / S sent it from its source s = g % S, for this process's owner o
HD long long pod_unpack_src(int S, int B, int o, int g, int b) {
  const int p = g / S, s = g % S;
  return (((long long)p * S + o) * S + s) * B + b;
}

struct PodPackDesc {
  const void* ptr[POD_PACK_MAX];
  int width[POD_PACK_MAX];  // words a row
  int kind[POD_PACK_MAX];   // 0: int64, 1: int32 (sign-extended), 2: byte
  int off[POD_PACK_MAX];    // first column
  int n;
  int W;                    // columns in all
};

// column c of row r of the packed stats
HD long long pod_stats_word(const PodPackDesc& P, int r, int c) {
  int k = 0;
  while (k + 1 < P.n && P.off[k + 1] <= c) k++;
  const size_t i = (size_t)r * P.width[k] + (size_t)(c - P.off[k]);
  if (P.kind[k] == 0) return ((const long long*)P.ptr[k])[i];
  if (P.kind[k] == 1) return (long long)((const int32_t*)P.ptr[k])[i];
  return (long long)((const uint8_t*)P.ptr[k])[i];
}

// the descriptor of n leaves (their columns laid out in order)
HD int pod_pack_desc(PodPackDesc& P, const void* const* ptrs,
                     const int* widths, const int* kinds, int n) {
  if (n < 1 || n > POD_PACK_MAX) return -1;
  P.n = n;
  int c = 0;
  for (int k = 0; k < n; k++) {
    P.ptr[k] = ptrs[k];
    P.width[k] = widths[k];
    P.kind[k] = kinds[k];
    P.off[k] = c;
    c += widths[k];
  }
  P.W = c;
  return 0;
}
