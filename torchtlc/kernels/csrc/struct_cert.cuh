// Kernel K23 "struct_cert_check": the runtime certificate of a narrowed
// (certified-bound) struct spec.
//
// K23 replaces jaxtlc/struct/backend.py:46-71 make_cert_check, which the
// reference's engines call on the raw successor fields of every valid
// candidate (immediate mode, jaxtlc/engine/backend.py:242-249) or of the
// fresh claimants (deferred mode, :399-400).  A row breaks a claimed bound
// when one of its ST_F raw int32 fields lies outside [0, ST_MAX_CODE[j]]
// (the codec's largest legal code of the field) or when one of the
// ST_NCARD cardinality-bounded mask variables - ST_CARD_SPECS holds an
// (offset, fields, bound) triple each - has more set bits over its fields,
// read as uint32, than its bound.  The check runs on the raw fields,
// before packing: a narrowed pack would wrap an escaped value into a
// legal-looking word.
//
// st_cert_row is the per-row test.  Every certificate evaluated on the
// card goes through it: K17 (struct_expand.cuh, under its kCert template
// flag) calls it on each valid successor before packing it and K18
// (struct_inv_rows.cuh) on each fresh claimant's row; both OR the result
// into a flag with __syncthreads_or and one atomicOr a block.  The
// standalone launch below does the same over rows [N, ST_F] int32 and
// valid [N] (one thread a row).  The macros come from the spec's emitted
// text (torchtlc.struct.emit); ST_CERT 0 (a backend without a certificate,
// or a generic spec, whose template includes this header through
// struct_inv_rows.cuh) makes st_cert_row false.
//
// Bound: bytes.  A row reads its valid byte and, when valid, its ST_F
// words once, and does ~2 compares a field and a popcount a mask field,
// well under the 67e12 integer operations a second per 3.35 TB/s of
// reads; the output is one word.  Inside K17 and K18 the fields are
// already in registers: there the certificate adds only its compares.
#pragma once
#include <stddef.h>

#include "common.cuh"

HD int st_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

#if ST_CERT
// whether row f breaks a claimed bound
HD bool st_cert_row(const int32_t* f) {
  const int32_t max_code[ST_F] = {ST_MAX_CODE};
  bool bad = false;
  for (int j = 0; j < ST_F; j++) bad |= f[j] < 0 || f[j] > max_code[j];
#if ST_NCARD > 0
  const int card[3 * ST_NCARD] = {ST_CARD_SPECS};
  for (int c = 0; c < ST_NCARD; c++) {
    int pc = 0;
    for (int j = 0; j < card[3 * c + 1]; j++)
      pc += st_popc((uint32_t)f[card[3 * c] + j]);
    bad |= pc > card[3 * c + 2];
  }
#endif
  return bad;
}
#else
HD bool st_cert_row(const int32_t*) { return false; }
#endif

// The certificate fold of one thread's rows: cert(s, v) ORs st_cert_row(s)
// of each valid row s into `bad` when kOn (K17's kCert); a no-op otherwise
// (K17 without it, K21).
template <bool kOn>
struct StCert {
  bool bad = false;
  HD void operator()(const int32_t* s, bool v) {
    if (kOn && v && st_cert_row(s)) bad = true;
  }
};

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void struct_cert_kernel(const int32_t* __restrict__ rows,
                                   const uint8_t* __restrict__ valid,
                                   long long n, int* __restrict__ flag) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool bad = i < n && valid[i] && st_cert_row(rows + i * ST_F);
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// flag: one zeroed int32, set to 1 when some valid row breaks a bound
extern "C" int tt_struct_cert_check(const void* rows, const void* valid,
                                    long long n, void* flag, void* stream) {
  const int threads = 256;
  if (n > 0)
    struct_cert_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         (cudaStream_t)stream>>>(
        (const int32_t*)rows, (const uint8_t*)valid, n, (int*)flag);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the same row test in a loop, for the host tests

extern "C" int host_struct_cert_check(const void* rows, const void* valid,
                                      long long n, void* flag) {
  for (long long i = 0; i < n; i++)
    if (((const uint8_t*)valid)[i] &&
        st_cert_row((const int32_t*)rows + i * ST_F))
      *(int*)flag = 1;
  return 0;
}
#endif
