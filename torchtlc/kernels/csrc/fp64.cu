// Kernel K2 "fp64": the 64-bit Rabin fingerprint of packed states.
//
// Replaces jaxtlc/engine/fingerprint.py:fp64_words_mxu (:241) and
// fp64_words (:191).  The fingerprint of a fixed-length message is GF(2)
// affine in its bits: fp = const ^ XOR of basis[i] over the set bits i.
// The reference ran that as a bf16 parity matmul to use an idle matrix
// unit; here each thread XORs the basis rows of its row's set bits, the
// basis (at most a few hundred 64-bit rows) staged in shared memory and
// read at one address per warp (a broadcast), the XOR predicated so the
// warp never diverges.
//
// Bound: bytes (N*W words read, 2N words written); ~nbits predicated XOR
// pairs per row is far below the card's integer rate.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void fp64_kernel(const uint32_t* __restrict__ words, long long N,
                            int W, int nbits,
                            const uint32_t* __restrict__ basis,
                            uint32_t* __restrict__ lo,
                            uint32_t* __restrict__ hi) {
  extern __shared__ uint32_t sb[];  // [nbits + 1][2]: basis rows, then const
  for (int t = threadIdx.x; t < 2 * (nbits + 1); t += blockDim.x)
    sb[t] = basis[t];
  __syncthreads();
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  uint32_t a = sb[2 * nbits], b = sb[2 * nbits + 1];
  const uint32_t* row = words + (size_t)r * W;
  for (int wi = 0; wi * 32 < nbits; wi++) {
    const uint32_t w = row[wi];
    const int base = wi * 32;
    const int nb = nbits - base < 32 ? nbits - base : 32;
#pragma unroll 8
    for (int k = 0; k < nb; k++) {
      const uint32_t m = 0u - ((w >> k) & 1u);
      a ^= sb[2 * (base + k)] & m;
      b ^= sb[2 * (base + k) + 1] & m;
    }
  }
  lo[r] = a;
  hi[r] = b;
}

extern "C" int tt_fp64(const void* words, long long N, int W, int nbits,
                       const void* basis, void* lo, void* hi, void* stream) {
  const int threads = 256;
  const long long blocks = (N + threads - 1) / threads;
  if (blocks > 0)
    fp64_kernel<<<(unsigned)blocks, threads,
                  2 * (nbits + 1) * sizeof(uint32_t), (cudaStream_t)stream>>>(
        (const uint32_t*)words, N, W, nbits, (const uint32_t*)basis,
        (uint32_t*)lo, (uint32_t*)hi);
  return (int)cudaGetLastError();
}
