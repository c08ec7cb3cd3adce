// Kernels K24 "struct_canon", K25 "struct_orbit_check" and K26
// "struct_por_keep": the state-space reduction of a struct spec
// (torchtlc/engine/reduce.py, the reference's jaxtlc/engine/reduce.py).
//
// K24 replaces jaxtlc/engine/reduce.py:205 _apply_program, :296 _canon and
// :309 ReducePlan.canon: the orbit-canonical form of a row of ST_F int32
// fields is the lexicographic minimum (signed, strict <) of the row and of
// each of the ST_SYM_NPROG non-identity field programs applied to the
// ORIGINAL row.  st_sym_prog(p, f, K, c), which the spec's emitted text
// prints (torchtlc/struct/emit.py sym_function), is program p: the
// whole-field gather, the remap tables (in K) applied in order, each
// guarded one reading its guard columns as they stand at that point, and
// the mask bit permutations.  st_canon_row runs the tournament with two
// F-rows of scratch.  K17 and K21 call it on every candidate lane under
// their kSym flag (valid or not: the reference canonicalizes the whole
// block), before the invariants, the deferred `flat`, K23 and the pack;
// the standalone launch canonicalizes rows [N, ST_F] (one thread a row),
// as the single-device engine does its Init seeds.
//
// K25 replaces :327 ReducePlan.orbit_check: the first valid candidate of a
// block (lowest lane index with a set valid flag) is recomputed from its
// popped row (unpack, the emitted step, K24) - the raw canonical row,
// never unpack(pack(.)) -, each of its ST_SYM_NPROG images is
// re-canonicalized and compared with it.  One block a body: its threads
// find the first valid lane (a shared atomicMin), thread 0 builds the
// sample, thread p checks program p.  The result is "some lane is valid
// and an image disagrees", ORed into a zeroed int32.
//
// K26 replaces :376 por_keep: in a row where some action flagged safe
// (ST_POR_SAFE) has a valid lane, only the lanes of the lowest-id such
// action stay valid.  st_por_prune is the row function K17 and K21 call
// under kPor, after afail, ovf and the deadlock test have read the
// pre-pruning lanes; it returns the lanes it pruned (K17 sums them, the
// reference's por_pruned).  The standalone launch prunes a [B, ST_L]
// valid mask (one thread a row).
//
// ST_SYM 0 / ST_POR 0 (a spec run without the reduction, or a generic
// spec, whose template includes this header through emitted_sharded.cuh)
// make the row functions no-ops.
//
// Bound: operations.  A canonicalization does ST_SYM_NPROG programs of ~F
// moves, a few table reads (cached) and an F-wide compare: ~23 * 60
// integer operations a row for four symmetric servers, against the 60
// bytes of the row; K26 reads and writes ST_L flags with ~3 ST_L
// compares; K25 is one block (latency).
#pragma once
#include "common.cuh"

#if defined(__CUDACC__)
#define ST_NOINLINE __noinline__
#else
#define ST_NOINLINE
#endif

#if ST_SYM
// whether row a is lexicographically below row b (signed, strict)
HD bool st_lex_less(const int32_t* a, const int32_t* b) {
  for (int j = 0; j < ST_F; j++)
    if (a[j] != b[j]) return a[j] < b[j];
  return false;
}

// best = the orbit-canonical form of f (f and best must not overlap)
__host__ __device__ ST_NOINLINE void st_canon_row(
    const int32_t* __restrict__ K, const int32_t* __restrict__ f,
    int32_t* __restrict__ best) {
  for (int j = 0; j < ST_F; j++) best[j] = f[j];
  for (int p = 0; p < ST_SYM_NPROG; p++) {
    int32_t c[ST_F];
    st_sym_prog(p, f, K, c);
    if (st_lex_less(c, best))
      for (int j = 0; j < ST_F; j++) best[j] = c[j];
  }
}

// whether some image of the canonical row `row` re-canonicalizes to
// another row: the orbit check of program p (K25)
HD bool st_orbit_bad(const int32_t* __restrict__ K,
                     const int32_t* __restrict__ row, int p) {
  int32_t img[ST_F], rc[ST_F];
  st_sym_prog(p, row, K, img);
  st_canon_row(K, img, rc);
  bool bad = false;
  for (int j = 0; j < ST_F; j++) bad |= rc[j] != row[j];
  return bad;
}
#define ST_SYM_N ST_SYM_NPROG
#else
HD void st_canon_row(const int32_t*, const int32_t* f, int32_t* best) {
  for (int j = 0; j < ST_F; j++) best[j] = f[j];
}
HD bool st_orbit_bad(const int32_t*, const int32_t*, int) { return false; }
#define ST_SYM_N 0
#endif

#if ST_POR
// K26's row: prune the valid lanes v of one row to the lowest-id safe
// enabled action; returns the lanes pruned
HD int st_por_prune(bool* v) {
  const int lane_action[ST_L] = {ST_LANE_ACTION};
  const bool safe[ST_NLABELS] = {ST_POR_SAFE};
  int chosen = ST_NLABELS;
  for (int l = 0; l < ST_L; l++)
    if (v[l] && safe[lane_action[l]] && lane_action[l] < chosen)
      chosen = lane_action[l];
  int pruned = 0;
  if (chosen < ST_NLABELS)
    for (int l = 0; l < ST_L; l++)
      if (v[l] && lane_action[l] != chosen) {
        v[l] = false;
        pruned++;
      }
  return pruned;
}
#else
HD int st_por_prune(bool*) { return 0; }
#endif

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void struct_canon_kernel(const int32_t* __restrict__ K,
                                    const int32_t* __restrict__ rows,
                                    long long n, int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t f[ST_F], best[ST_F];
  for (int j = 0; j < ST_F; j++) f[j] = rows[i * ST_F + j];
  st_canon_row(K, f, best);
  for (int j = 0; j < ST_F; j++) out[i * ST_F + j] = best[j];
}

// out [n, ST_F] = the canonical form of each row of rows [n, ST_F]
extern "C" int tt_struct_canon(const void* K, const void* rows, long long n,
                               void* out, void* stream) {
  const int threads = 128;
  if (n > 0)
    struct_canon_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                          0, (cudaStream_t)stream>>>(
        (const int32_t*)K, (const int32_t*)rows, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

#define ORBIT_THREADS 256

#if ST_SYM
__global__ void __launch_bounds__(ORBIT_THREADS) struct_orbit_check_kernel(
    const int32_t* __restrict__ K, const uint32_t* __restrict__ block,
    const uint8_t* __restrict__ valid, long long ncand,
    int* __restrict__ flag) {
  __shared__ unsigned long long s_first;
  __shared__ int32_t s_row[ST_F];
  const int tid = threadIdx.x;
  if (tid == 0) s_first = (unsigned long long)ncand;
  __syncthreads();
  for (long long i = tid; i < ncand; i += blockDim.x)
    if (valid[i]) {
      atomicMin(&s_first, (unsigned long long)i);
      break;
    }
  __syncthreads();
  const long long first = (long long)s_first;
  if (first >= ncand) return;  // no valid lane: the check is False
  if (tid == 0) {
    int32_t f[ST_F], raw[ST_F];
    st_unpack(block + (size_t)(first / ST_L) * ST_W, f);
    int32_t succ[ST_L * ST_F];
    bool v[ST_L], ovf[ST_L], afail[ST_L];
    st_step(f, K, succ, v, ovf, afail);
    for (int j = 0; j < ST_F; j++) raw[j] = succ[(first % ST_L) * ST_F + j];
    int32_t row[ST_F];
    st_canon_row(K, raw, row);
    for (int j = 0; j < ST_F; j++) s_row[j] = row[j];
  }
  __syncthreads();
  int32_t row[ST_F];
  for (int j = 0; j < ST_F; j++) row[j] = s_row[j];
  bool bad = false;
  for (int p = tid; p < ST_SYM_N; p += blockDim.x)
    bad |= st_orbit_bad(K, row, p);
  if (__syncthreads_or(bad) && tid == 0) atomicOr(flag, 1);
}

// flag: one zeroed int32, set to 1 when the first valid candidate of the
// popped rows block [ck, ST_W] (valid: K17's [ck * ST_L] valid flags)
// fails the orbit check
extern "C" int tt_struct_orbit_check(const void* K, const void* block,
                                     const void* valid, long long ncand,
                                     void* flag, void* stream) {
  struct_orbit_check_kernel<<<1, ORBIT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)K, (const uint32_t*)block, (const uint8_t*)valid,
      ncand, (int*)flag);
  return (int)cudaGetLastError();
}
#else  // no symmetry plan in this text: nothing to check
extern "C" int tt_struct_orbit_check(const void*, const void*, const void*,
                                     long long, void*, void*) {
  return (int)cudaErrorInvalidValue;
}
#endif

__global__ void struct_por_keep_kernel(const uint8_t* __restrict__ valid,
                                       long long B,
                                       uint8_t* __restrict__ keep) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  bool v[ST_L];
  for (int l = 0; l < ST_L; l++) v[l] = valid[r * ST_L + l] != 0;
  st_por_prune(v);
  for (int l = 0; l < ST_L; l++) keep[r * ST_L + l] = v[l];
}

// keep [B, ST_L] = the valid mask [B, ST_L] after K26's pruning
extern "C" int tt_struct_por_keep(const void* valid, long long B, void* keep,
                                  void* stream) {
  const int threads = 128;
  if (B > 0)
    struct_por_keep_kernel<<<(unsigned)((B + threads - 1) / threads),
                             threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)valid, B, (uint8_t*)keep);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the same row functions in loops, for the host tests

extern "C" int host_struct_canon(const void* K, const void* rows, long long n,
                                 void* out) {
  for (long long i = 0; i < n; i++)
    st_canon_row((const int32_t*)K, (const int32_t*)rows + i * ST_F,
                 (int32_t*)out + i * ST_F);
  return 0;
}

extern "C" int host_struct_orbit_check(const void* K, const void* block,
                                       const void* valid, long long ncand,
                                       void* flag) {
#if ST_SYM
  long long first = 0;
  while (first < ncand && !((const uint8_t*)valid)[first]) first++;
  if (first >= ncand) return 0;
  int32_t f[ST_F], raw[ST_F], row[ST_F];
  st_unpack((const uint32_t*)block + (size_t)(first / ST_L) * ST_W, f);
  int32_t succ[ST_L * ST_F];
  bool v[ST_L], ovf[ST_L], afail[ST_L];
  st_step(f, (const int32_t*)K, succ, v, ovf, afail);
  for (int j = 0; j < ST_F; j++) raw[j] = succ[(first % ST_L) * ST_F + j];
  st_canon_row((const int32_t*)K, raw, row);
  for (int p = 0; p < ST_SYM_N; p++)
    if (st_orbit_bad((const int32_t*)K, row, p)) *(int*)flag = 1;
  return 0;
#else
  return 1;  // no symmetry plan in this text
#endif
}

extern "C" int host_struct_por_keep(const void* valid, long long B,
                                    void* keep) {
  for (long long r = 0; r < B; r++) {
    bool v[ST_L];
    for (int l = 0; l < ST_L; l++)
      v[l] = ((const uint8_t*)valid)[r * ST_L + l] != 0;
    st_por_prune(v);
    for (int l = 0; l < ST_L; l++) ((uint8_t*)keep)[r * ST_L + l] = v[l];
  }
  return 0;
}
#endif
