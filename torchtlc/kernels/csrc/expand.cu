// Kernel K1 "expand": every (popped state, lane) candidate of a chunk.
//
// Replaces jaxtlc/engine/backend.py:make_expand_stage.expand (:195) over
// Codec.unpack (codec.py:367), make_kernel.step (kernel.py:521),
// canonicalize (codec.py:319), make_invariant_kernel.check
// (invariants.py:50) and Codec.pack (codec.py:337), plus
// kubeapi_backend.gen_counts (backend.py:443).  The reference materializes
// the successor fields [ck*L, F] int32; this kernel keeps them in shared
// memory and writes only packed words and per-lane bytes.
//
// Deferred mode (the reference's make_expand_stage(deferred=True),
// backend.py:228-237) is the kDeferred instantiation: no invariant
// evaluation, the two invariant flag rows stay zero.
//
// Design.  A block takes a tile of RT consecutive popped rows (RT of 32,
// 16 or 8: the launch picks the widest that still gives every SM two
// tiles, and narrower while the tile's shared memory would not fit) and
// runs its RT * L candidates, one thread each, thread t on lane t / RT of
// row t % RT - so a warp runs ONE lane's handler over 32 (or 8 or 16)
// rows and diverges only where the rows' data does.  In shared memory
// sized at launch:
//   1. the fields' widths and bit offsets (the offsets computed once on
//      the host, a kernel parameter); the layout itself stays a kernel
//      parameter, so its fixed fields are constant-bank operands;
//   2. the tile's rows, loaded coalesced, each decoded ONCE into its F
//      fields and its packed words (one thread a (row, field) or (row,
//      word), stepped without a division an element; kubeapi.cuh, the
//      row steps);
//   3. each candidate's successor built in its thread's frame of F fields
//      (odd strides: no bank conflicts), canonicalized, checked, and its
//      packed words made from the row's by rewriting only the fields the
//      lane changed (kube_lane_step), staged in candidate order with its
//      flag bytes and action;
//   4. the tile's contiguous slabs stored coalesced - the packed words
//      with 16-byte stores - and the per-action generated counts through
//      a shared histogram (one shared atomic a group of equal labels in a
//      warp, __match_any_sync) and one integer atomicAdd per label per
//      block (order-free, so deterministic).
// The lane handlers are kubeapi.cuh's, shared with K7 and K39, and
// host_launch.cpp runs the same row and lane steps on the CPU.
//
// Bound: the larger of the bytes (the popped rows once, ck*L*W packed
// words, 5 flag bytes and an int32 action a lane) and the integer
// operations of the lane steps (chip_smoke.py kube_expand_ops).
//
// The sharded engine's variant (kSharded; jaxtlc/engine/sharded.py:
// 510-555): one launch over the pops of all D shards.  Shard d's row r is
// the unpacked queue row queue[d, (qhead[d] + r) % qcap] (the reference's
// circular pop of [F] rows), popped when r < npop[d]; lane idx = (d * ck +
// r) * L + lane.  Its rows' packed words are OR-ed from their fields
// (kube_field_or).
// Besides K1's outputs it writes each lane's raw successor fields
// (`fields`, the reference's `flat`, which the route payload carries) and,
// when `block` is given, each popped row packed (the coverage plane reads
// packed rows).  Per-action generated counts go to gen[d, label].
#include <cuda_runtime.h>

#include "kubeapi.cuh"

#define EXPAND_MAX_SHARDS 8
#define EXPAND_MAX_THREADS 1024
#define EXPAND_LAYOUT_WORDS ((int)(sizeof(KubeLayout) / 4))

// the fields' bit offsets, computed on the host (kube_field_offsets)
struct ExpandOffsets {
  int32_t off[KUBE_MAXF];
};

// 16-byte aligned carve of the dynamic shared memory
struct ExpandSmem {
  int wid, off, hist, rq, rf, rb, sf, so, sflag, sact, total;
};

__host__ __device__ inline int exp_align16(int b) { return (b + 15) & ~15; }

// odd strides of the row and frame fields: no bank conflicts
__host__ __device__ inline int exp_stride(int F) { return F | 1; }

__host__ __device__ inline ExpandSmem exp_smem(int F, int W, int L, int D,
                                               int RT) {
  const int T = RT * L, FS = exp_stride(F);
  ExpandSmem m;
  int at = 0;
  m.wid = at;
  at += exp_align16(F * 4);
  m.off = at;
  at += exp_align16(F * 4);
  m.hist = at;
  at += exp_align16(D * KUBE_N_LABELS * 4);
  m.rq = at;
  at += exp_align16(RT * 8);
  m.rf = at;
  at += exp_align16(RT * FS * 4);
  m.rb = at;
  at += exp_align16(RT * W * 4);
  m.sf = at;
  at += exp_align16(T * FS * 4);
  m.so = at;
  at += exp_align16(T * W * 4);
  m.sflag = at;
  at += exp_align16(5 * T);
  m.sact = at;
  at += exp_align16(T * 4);
  m.total = at;
  return m;
}

// f(a, b) for each t = a * m + b < n * m that thread tid of T owns (t =
// tid, tid + T, ...), stepping (a, b) without a division an element
template <typename Fn>
__device__ __forceinline__ void exp_for2(int n, int m, int tid, int T,
                                         Fn&& f) {
  const int da = T / m, db = T - da * m;
  int a = tid / m, b = tid - a * m;
  while (a < n) {
    f(a, b);
    a += da;
    b += db;
    if (b >= m) {
      b -= m;
      a++;
    }
  }
}

template <bool kDeferred, bool kSharded>
__global__ void __launch_bounds__(EXPAND_MAX_THREADS) expand_kernel(
    KubeLayout Y, ExpandOffsets O, int RT, const u32* __restrict__ words,
    int n, const int32_t* __restrict__ queue, long long qrows, int qcap,
    const long long* __restrict__ qhead, const long long* __restrict__ npop,
    int D, int ck, u32* __restrict__ packed, uint8_t* __restrict__ flags,
    int32_t* __restrict__ action, int32_t* __restrict__ fields,
    u32* __restrict__ block, unsigned long long* __restrict__ gen) {
  extern __shared__ int4 exp_smem_raw[];
  char* sm = reinterpret_cast<char*>(exp_smem_raw);
  const int tid = threadIdx.x;
  const int F = Y.F, W = Y.W, L = Y.L, FS = exp_stride(F);
  const int T = RT * L;  // == blockDim.x
  const ExpandSmem M = exp_smem(F, W, L, D, RT);
  int32_t* wid = reinterpret_cast<int32_t*>(sm + M.wid);
  int32_t* off = reinterpret_cast<int32_t*>(sm + M.off);
  unsigned* hist = reinterpret_cast<unsigned*>(sm + M.hist);
  long long* rq = reinterpret_cast<long long*>(sm + M.rq);
  int32_t* rf = reinterpret_cast<int32_t*>(sm + M.rf);
  u32* rb = reinterpret_cast<u32*>(sm + M.rb);
  int32_t* sf = reinterpret_cast<int32_t*>(sm + M.sf);
  u32* so = reinterpret_cast<u32*>(sm + M.so);
  uint8_t* sflag = reinterpret_cast<uint8_t*>(sm + M.sflag);
  int32_t* sact = reinterpret_cast<int32_t*>(sm + M.sact);

  // the tile: rows [g0, g0 + nr) of the D * ck, candidates from g0 * L
  const long long nrows = (long long)D * ck;
  const long long ncand = nrows * L;
  const long long g0 = (long long)blockIdx.x * RT;
  const int nr = (int)(nrows - g0 < RT ? nrows - g0 : RT);
  for (int t = tid; t < F; t += T) {
    wid[t] = Y.width[t];
    off[t] = O.off[t];
  }
  for (int t = tid; t < D * KUBE_N_LABELS; t += T) hist[t] = 0;
  if (!kSharded) {  // the popped words, one coalesced range, bits past
                    // nbits cleared
    const u32* src = words + (size_t)g0 * W;
    exp_for2(nr, W, tid, T, [&](int r, int k) {
      rb[r * W + k] = kube_row_word(Y, src + r * W, k);
    });
  } else {  // zeroed words; each row's circular queue slot
    for (int t = tid; t < nr * W; t += T) rb[t] = 0u;
    if (tid < nr) {
      const long long g = g0 + tid;
      const int d = (int)(g / ck);
      const long long q = g - (long long)d * ck;
      rq[tid] = ((long long)d * qrows + (qhead[d] + q) % qcap) * F;
    }
  }
  __syncthreads();
  if (!kSharded) {  // decode each row once: (row, field) a thread
    exp_for2(nr, F, tid, T, [&](int r, int j) {
      rf[r * FS + j] = kube_field_get(rb + r * W, W, off[j], wid[j]);
    });
  } else {  // each row's fields, OR-ed into its packed words
    exp_for2(nr, F, tid, T, [&](int r, int j) {
      const int32_t v = queue[(size_t)rq[r] + j];
      rf[r * FS + j] = v;
      kube_field_or(rb + r * W, W, off[j], wid[j], (u32)v);
    });
  }
  __syncthreads();
  if (kSharded && block != nullptr)  // the tile's rows, packed
    for (int t = tid; t < nr * W; t += T) block[(size_t)g0 * W + t] = rb[t];

  // candidate (row r, lane): thread lane * RT + r, staged at r * L + lane
  const int lane = tid / RT, r = tid - lane * RT;
  const int li = r * L + lane;
  int key = -1;  // the histogram cell of a valid candidate
  if (r < nr) {
    const long long g = g0 + r;
    const int d = kSharded ? (int)(g / ck) : 0;
    const bool popped =
        kSharded ? (g - (long long)d * ck) < npop[d] : g < (long long)n;
    LaneOut o = kube_lane_step<kDeferred>(Y, off, rf + r * FS, rb + r * W,
                                          popped, lane, sf + tid * FS,
                                          so + li * W);
    sflag[li] = o.valid;
    sflag[T + li] = o.afail;
    sflag[2 * T + li] = o.ovf;
    sflag[3 * T + li] = o.bad_typeok;
    sflag[4 * T + li] = o.bad_onlyone;
    sact[li] = o.action;
    if (o.valid) key = d * KUBE_N_LABELS + o.action;
  }
  {  // one shared atomic a group of equal cells in the warp
    const unsigned am = __activemask();
    const unsigned grp = __match_any_sync(am, key);
    if (key >= 0 && (__ffs(grp) - 1) == (tid & 31))
      atomicAdd(&hist[key], (unsigned)__popc(grp));
  }
  __syncthreads();

  // the tile's slabs: candidates [g0 * L, g0 * L + nr * L)
  const long long c0 = g0 * L;
  const int nc = nr * L;
  u32* dst = packed + (size_t)c0 * W;
  const int nw = nc * W;
  if ((((uintptr_t)dst) & 15) == 0) {
    const int n4 = nw >> 2;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* s4 = reinterpret_cast<const uint4*>(so);
    for (int t = tid; t < n4; t += T) d4[t] = s4[t];
    for (int t = (n4 << 2) + tid; t < nw; t += T) dst[t] = so[t];
  } else {
    for (int t = tid; t < nw; t += T) dst[t] = so[t];
  }
  exp_for2(5, nc, tid, T, [&](int p, int i) {
    flags[p * ncand + c0 + i] = sflag[p * T + i];
  });
  for (int t = tid; t < nc; t += T) action[c0 + t] = sact[t];
  if (kSharded) {  // the tile's successor fields, candidate order: element
                   // (i, j) of candidate i = rr * L + ll, thread ll * RT + rr
    int32_t* fdst = fields + (size_t)c0 * F;
    const int di = T / F, dj = T - di * F;
    int i = tid / F, j = tid - i * F;
    int rr = i / L, ll = i - rr * L;
    while (i < nc) {
      fdst[(size_t)i * F + j] = sf[(ll * RT + rr) * FS + j];
      int step = di;
      j += dj;
      if (j >= F) {
        j -= F;
        step++;
      }
      i += step;
      ll += step;
      while (ll >= L) {
        ll -= L;
        rr++;
      }
    }
  }
  for (int t = tid; t < D * KUBE_N_LABELS; t += T)
    if (hist[t]) atomicAdd(&gen[t], (unsigned long long)hist[t]);
}

extern "C" int tt_layout_words() { return EXPAND_LAYOUT_WORDS; }

// rows a tile: 32, or fewer while the grid would give an SM fewer than
// two tiles (down to 8), while the tile would pass EXPAND_MAX_THREADS
// candidates, and while its shared memory would pass the device's opt-in
// limit (*smem: the tile's bytes).  0 when one row does not fit - under
// kernel_layout's bounds (F <= 96, L <= 144) one row needs < 120 KB.
static int exp_tile_rows(const KubeLayout& Y, int D, long long nrows,
                         int* smem) {
  static int sms = 0, optin = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        sms <= 0 || optin <= 0) {
      (void)cudaGetLastError();
      sms = 132;
      optin = 48 * 1024;
    }
  }
  int RT = 32;
  while (RT > 8 && nrows / RT < 2 * sms) RT >>= 1;
  while (RT > 1 && (RT * Y.L > EXPAND_MAX_THREADS ||
                    exp_smem(Y.F, Y.W, Y.L, D, RT).total > optin))
    RT >>= 1;
  *smem = exp_smem(Y.F, Y.W, Y.L, D, RT).total;
  return *smem <= optin ? RT : 0;
}

template <bool kDeferred, bool kSharded>
static int exp_launch(const KubeLayout& Y, const u32* words, int n,
                      const int32_t* queue, long long qrows, int qcap,
                      const long long* qhead, const long long* npop, int D,
                      int ck, u32* packed, uint8_t* flags, int32_t* action,
                      int32_t* fields, u32* block, unsigned long long* gen,
                      cudaStream_t stream) {
  const long long nrows = (long long)D * ck;
  if (nrows <= 0) return (int)cudaGetLastError();
  int smem = 0;
  const int RT = exp_tile_rows(Y, D, nrows, &smem);
  if (RT == 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (nrows + RT - 1) / RT;
  static int allowed = 48 * 1024;  // this instantiation's opt-in so far
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        expand_kernel<kDeferred, kSharded>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  ExpandOffsets O;
  kube_field_offsets(Y, O.off);
  expand_kernel<kDeferred, kSharded>
      <<<(unsigned)blocks, RT * Y.L, smem, stream>>>(
          Y, O, RT, words, n, queue, qrows, qcap, qhead, npop, D, ck, packed,
          flags, action, fields, block, gen);
  return (int)cudaGetLastError();
}

// W <= F: a field is at most 32 bits wide
static bool exp_layout_ok(const KubeLayout& Y) {
  return Y.F > 0 && Y.F <= KUBE_MAXF && Y.W > 0 && Y.W <= Y.F && Y.L > 0 &&
         Y.L <= EXPAND_MAX_THREADS;
}
// gen must hold D * KUBE_N_LABELS zeroed (or accumulating) counters;
// block may be null
extern "C" int tt_expand_sharded(const void* layout, const void* queue,
                                 long long qrows, int qcap, const void* qhead,
                                 const void* npop, int D, int ck, int deferred,
                                 void* packed, void* flags, void* action,
                                 void* fields, void* block, void* gen,
                                 void* stream) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  if (D < 1 || D > EXPAND_MAX_SHARDS || !exp_layout_ok(Y))
    return (int)cudaErrorInvalidValue;
  if (deferred)
    return exp_launch<true, true>(
        Y, nullptr, 0, (const int32_t*)queue, qrows, qcap,
        (const long long*)qhead, (const long long*)npop, D, ck, (u32*)packed,
        (uint8_t*)flags, (int32_t*)action, (int32_t*)fields, (u32*)block,
        (unsigned long long*)gen, (cudaStream_t)stream);
  return exp_launch<false, true>(
      Y, nullptr, 0, (const int32_t*)queue, qrows, qcap,
      (const long long*)qhead, (const long long*)npop, D, ck, (u32*)packed,
      (uint8_t*)flags, (int32_t*)action, (int32_t*)fields, (u32*)block,
      (unsigned long long*)gen, (cudaStream_t)stream);
}

// gen must hold KUBE_N_LABELS zeroed (or accumulating) counters
extern "C" int tt_expand(const void* layout, const void* block, int ck, int n,
                         int deferred, void* packed, void* flags,
                         void* action, void* gen, void* stream) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  if (!exp_layout_ok(Y)) return (int)cudaErrorInvalidValue;
  if (deferred)
    return exp_launch<true, false>(
        Y, (const u32*)block, n, nullptr, 0, 1, nullptr, nullptr, 1, ck,
        (u32*)packed, (uint8_t*)flags, (int32_t*)action, nullptr, nullptr,
        (unsigned long long*)gen, (cudaStream_t)stream);
  return exp_launch<false, false>(
      Y, (const u32*)block, n, nullptr, 0, 1, nullptr, nullptr, 1, ck,
      (u32*)packed, (uint8_t*)flags, (int32_t*)action, nullptr, nullptr,
      (unsigned long long*)gen, (cudaStream_t)stream);
}
