// Kernel K18 "struct_inv_rows": the deferred invariant check of an emitted
// spec - a struct spec's (struct_expand.cuh) or a generic spec's
// (gen_expand.cuh); both templates include this header, so each emitted
// library exports tt_struct_inv_rows beside its expand kernel.
//
// K18 replaces jaxtlc/engine/backend.py:325 make_deferred_checker over an
// emitted backend: one thread per claimant row; a fresh claimant runs the
// emitted invariants on its raw successor (flat[c_idx]) and folds its lane
// into the per-invariant maximum with an integer atomicMax; the last block
// to finish picks the verdict - first wins across the invariants in code
// order, the highest lane within one - as K7 does.  On the single-device
// engine `flat` is the expand stage's raw successors; on the sharded
// engine (jaxtlc/engine/sharded.py:737-747) it is one owner's received
// rows [D*B, F], which carry no action: with action == NULL the reported
// action is -1, as the sharded result always reports.
//
// With a certificate flag (`cert`, a narrowed struct spec's deferred mode,
// jaxtlc/engine/backend.py:399-400) each fresh claimant's row also goes
// through K23's st_cert_row (struct_cert.cuh), ORed into the flag with
// __syncthreads_or and one atomicOr a block; cert is NULL otherwise.
//
// Bound: operations (the emitted invariants on each fresh claimant); the
// bytes - the claimant words, F fields a fresh row - are small beside it.
#pragma once

#include "struct_cert.cuh"

#if ST_NINV > 0
#define ST_NINV_ARR ST_NINV
#else
#define ST_NINV_ARR 1
#endif

// K18's verdict from the per-invariant highest violating lanes (bad_lane[k],
// -1 when none): code code_base + k of the first k that has one, the raw
// successor fields and action of its lane (-1 without an action plane);
// (0, zeros, -1) when none.
HD void st_inv_pick(const int* bad_lane, const int32_t* __restrict__ flat,
                    const int32_t* __restrict__ action, int code_base,
                    long long* viol, int32_t* state, long long* vaction) {
  long long lane = -1;
  int code = 0;
  for (int k = 0; k < ST_NINV; k++)
    if (code == 0 && bad_lane[k] >= 0) {
      code = code_base + k;
      lane = bad_lane[k];
    }
  *viol = code;
  for (int j = 0; j < ST_F; j++)
    state[j] = code ? flat[lane * ST_F + j] : 0;
  *vaction = code && action ? action[lane] : -1;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// scratch: [0, ST_NINV) the per-invariant highest bad lane, [ST_NINV] the
// done counter; all start at -1
__global__ void struct_inv_rows_kernel(const int32_t* __restrict__ K,
                                       const int32_t* __restrict__ flat,
                                       long long rows,
                                       const uint8_t* __restrict__ fresh,
                                       const int64_t* __restrict__ c_idx,
                                       const int32_t* __restrict__ action,
                                       int code_base, int* scratch,
                                       long long* __restrict__ viol,
                                       int32_t* __restrict__ state,
                                       long long* __restrict__ vaction,
                                       int* __restrict__ cert) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool cert_bad = false;
  if (i < rows && fresh[i]) {
    const long long lane = c_idx[i];
    const uint32_t bits = st_inv_bits(flat + lane * ST_F, K);
    for (int k = 0; k < ST_NINV; k++)
      if (!((bits >> k) & 1u)) atomicMax(&scratch[k], (int)lane);
    if (cert) cert_bad = st_cert_row(flat + lane * ST_F);
  }
  __threadfence();
  if (__syncthreads_or(cert_bad) && threadIdx.x == 0) atomicOr(cert, 1);
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(&scratch[ST_NINV], 1) == (int)gridDim.x - 2;
  __syncthreads();
  if (last && threadIdx.x == 0) {
    int bad[ST_NINV_ARR];
    for (int k = 0; k < ST_NINV; k++) bad[k] = atomicAdd(&scratch[k], 0);
    st_inv_pick(bad, flat, action, code_base, viol, state, vaction);
  }
}

// action may be NULL (received rows: the reported action is -1); cert
// NULL without the runtime certificate, else one zeroed int32
extern "C" int tt_struct_inv_rows(const void* K, const void* flat,
                                  long long rows, const void* fresh,
                                  const void* c_idx, const void* action,
                                  int code_base, void* scratch, void* viol,
                                  void* state, void* vaction, void* cert,
                                  void* stream) {
  const int threads = 128;
  const long long blocks = rows > 0 ? (rows + threads - 1) / threads : 1;
  struct_inv_rows_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)K, (const int32_t*)flat, rows, (const uint8_t*)fresh,
      (const int64_t*)c_idx, (const int32_t*)action, code_base,
      (int*)scratch, (long long*)viol, (int32_t*)state, (long long*)vaction,
      (int*)cert);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the same per-row logic in a loop, for the host tests

// cert: NULL, or one int32 set to 1 when a fresh claimant breaks a bound
extern "C" int host_struct_inv_rows_cert(const void* K, const void* flat,
                                         long long rows, const void* fresh,
                                         const void* c_idx,
                                         const void* action, int code_base,
                                         void* viol, void* state,
                                         void* vaction, void* cert) {
  int bad[ST_NINV_ARR];
  for (int k = 0; k < ST_NINV_ARR; k++) bad[k] = -1;
  for (long long i = 0; i < rows; i++) {
    if (!((const uint8_t*)fresh)[i]) continue;
    const long long lane = ((const int64_t*)c_idx)[i];
    const int32_t* row = (const int32_t*)flat + lane * ST_F;
    const uint32_t bits = st_inv_bits(row, (const int32_t*)K);
    for (int k = 0; k < ST_NINV; k++)
      if (!((bits >> k) & 1u) && lane > bad[k]) bad[k] = (int)lane;
    if (cert && st_cert_row(row)) *(int*)cert = 1;
  }
  st_inv_pick(bad, (const int32_t*)flat, (const int32_t*)action, code_base,
              (long long*)viol, (int32_t*)state, (long long*)vaction);
  return 0;
}

extern "C" int host_struct_inv_rows(const void* K, const void* flat,
                                    long long rows, const void* fresh,
                                    const void* c_idx, const void* action,
                                    int code_base, void* viol, void* state,
                                    void* vaction) {
  return host_struct_inv_rows_cert(K, flat, rows, fresh, c_idx, action,
                                   code_base, viol, state, vaction, nullptr);
}
#endif
