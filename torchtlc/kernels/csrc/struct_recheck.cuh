// Kernel K31 "struct_recheck": the artifact cache's invariant re-check of
// a struct spec (struct_expand.cuh includes it, so every struct spec's
// library exports tt_struct_recheck beside K17).
//
// K31 replaces jaxtlc/struct/artifacts.py:722 _recheck_fn (run by :736
// run_recheck): vmap(backend.inv_check)(cdc.unpack(words)) over a stored
// reachable set in blocks of 4096 rows.  One thread per stored row over
// the whole set in one launch: st_unpack of its W packed words (the codec
// the artifact was written under - a narrowed spec's narrowed codec, whose
// digest is in the reach artifact's meta), the emitted invariants
// (st_inv_bits), and the row's invariant-holds bits written to bits[i].
// The reference's pick is the first row in artifact order whose bits are
// not all set, then that row's lowest unset bit (K18's st_inv_pick picks
// the lowest invariant first instead): each warp takes the lowest failing
// row index of its lanes with a shuffle reduction and one atomicMin of it
// into `first` (which holds n when no row fails), so the host reads one
// scalar, then that row's bits and words.
//
// Bound: bytes for the shipped specs (W words in and one int32 out a row;
// their invariants are a few dozen integer operations a row).
#pragma once

#if ST_NINV >= 32
#define ST_INV_FULL 0xFFFFFFFFu
#else
#define ST_INV_FULL ((1u << ST_NINV) - 1u)
#endif

// one stored row: its invariant-holds bits, and whether one fails
HD uint32_t st_recheck_row(const int32_t* __restrict__ K,
                           const uint32_t* __restrict__ w, bool* bad) {
  int32_t f[ST_F];
  st_unpack(w, f);
  const uint32_t bits = st_inv_bits(f, K);
  *bad = (bits & ST_INV_FULL) != ST_INV_FULL;
  return bits;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void struct_recheck_kernel(const int32_t* __restrict__ K,
                                      const uint32_t* __restrict__ words,
                                      long long n, int32_t* __restrict__ bits,
                                      unsigned long long* __restrict__ first) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long mine = ~0ull;
  if (i < n) {
    bool bad;
    bits[i] = (int32_t)st_recheck_row(K, words + (size_t)i * ST_W, &bad);
    if (bad) mine = (unsigned long long)i;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, mine, off);
    mine = o < mine ? o : mine;
  }
  if ((threadIdx.x & 31) == 0 && mine != ~0ull) atomicMin(first, mine);
}

// words [n, ST_W] uint32; bits [n] int32; first one int64 holding n
extern "C" int tt_struct_recheck(const void* K, const void* words,
                                 long long n, void* bits, void* first,
                                 void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0)
    struct_recheck_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (const int32_t*)K, (const uint32_t*)words, n, (int32_t*)bits,
        (unsigned long long*)first);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the same per-row logic in a loop, for the host tests

extern "C" int host_struct_recheck(const void* K, const void* words,
                                   long long n, void* bits, void* first) {
  long long lo = n;
  for (long long i = 0; i < n; i++) {
    bool bad;
    ((int32_t*)bits)[i] = (int32_t)st_recheck_row(
        (const int32_t*)K, (const uint32_t*)words + (size_t)i * ST_W, &bad);
    if (bad && i < lo) lo = i;
  }
  *(long long*)first = lo;
  return 0;
}
#endif
