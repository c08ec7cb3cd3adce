// Kernels K32 "emitted_expand_batched", K34 "struct_sim_step_batched" and
// K35 "sim_fold_batched": the batched forms of K17, K27 and K28 that the
// serving plane's constants-class sweeps and smoke batches launch once for
// every lane of a dispatch.  struct_expand.cuh includes this header last
// in the texts of a sweep or smoke class (ST_BATCHED 1), whose library
// exports them beside K17.
//
// They replace what jax.vmap makes of the engines in
// jaxtlc/serve/sweep.py:260 SweepEngine._vrun (the BFS body's expand
// stage over K stacked carries) and jaxtlc/sim/engine.py:477
// SimEngine._vrun (the walk's round over K stacked walk carries): the
// batched program runs every lane's work in one dispatch and freezes a
// lane whose loop condition turned false.
//
// K32: K17's lane body (st_expand_row, shared with K21 through
// st_lanes_row) on a grid of (rows, K lanes).  Lane k pops its own level
// buffer of the stacked queue [K, 2, qrows, ST_W] at its own pop
// (parity, qhead, n, ck) from `pop` [K, 4] int64: ck rows from qhead, the
// first n of them live, so lanes of one launch may differ in width (the
// two-tier body) and a frozen lane (ck = 0) pops nothing and writes
// nothing.  Each lane's outputs sit in its own slab of the [K, C * ST_L]
// successor block, laid out as K17's at width ck (flag rows of stride
// ck * ST_L), so a lane's slab is bit for bit K17's output on the same
// rows; its label histogram is counted in shared memory a block and added
// to gen[k] with one atomic a label.
//
// K34: K27 over (lane, walker), one thread each (a grid of (walkers, K)):
// lane k has its own threefry key, step cursor, device flag go[k],
// scratch slice and buffers; a lane whose go is 0 returns at once (the
// identity, as K27's), and the kInit form is round 0 over the lane's own
// Init vectors (inits [K, n0max, ST_F], n0 [K]).
//
// K35: K28 with one block a lane: the first-wins violation fold in class
// order, the uint32 counters with wrap, the step cursor, that lane's go and
// the reset of its scratch.
//
// Bound: operations, as K17's and K27's: a row's or walker's step is the
// emitted lane IR; K35 is one short block a lane (latency).
#pragma once

#ifdef __CUDACC__

template <bool kDeferred>
__global__ void emitted_expand_batched_kernel(
    const int32_t* __restrict__ K, const uint32_t* __restrict__ queue,
    long long qrows, const long long* __restrict__ pop, int C,
    uint32_t* __restrict__ packed, uint8_t* __restrict__ flags,
    int32_t* __restrict__ action, int32_t* __restrict__ flat,
    unsigned long long* __restrict__ gen) {
  const int lane = blockIdx.y;
  const long long parity = pop[4 * lane], qhead = pop[4 * lane + 1];
  const long long n = pop[4 * lane + 2], ck = pop[4 * lane + 3];
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  // ck is one value for the whole block: a frozen lane's blocks, and the
  // blocks past a narrow lane's rows, return before any barrier
  if ((long long)blockIdx.x * blockDim.x >= ck) return;
  __shared__ unsigned int hist[ST_NLABELS];
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const long long slab = (long long)lane * C * ST_L;
  if (row < ck) {
    StSharedHist count{hist};
    StCert<false> none;
    const uint32_t* src =
        queue + (((size_t)lane * 2 + parity) * qrows + qhead + row) * ST_W;
    st_expand_row<kDeferred, (bool)ST_SYM, (bool)ST_POR>(
        K, src, row < n, (long long)row * ST_L, ck * ST_L,
        packed + (size_t)slab * ST_W, flags + (size_t)slab * (3 + ST_NINV),
        action + slab, kDeferred ? flat + (size_t)slab * ST_F : flat, count,
        none);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x)
    if (hist[t])
      atomicAdd(&gen[(size_t)lane * ST_NLABELS + t],
                (unsigned long long)hist[t]);
}

// pop [nl, 4] int64 (parity, qhead, n, ck; ck = 0 freezes the lane, ck <=
// C); packed [nl, C * ST_L, ST_W], flags [nl, (3 + ST_NINV) * C * ST_L],
// action [nl, C * ST_L], flat [nl, C * ST_L, ST_F] (deferred mode, else
// NULL), gen [nl, ST_NLABELS] zeroed
extern "C" int tt_emitted_expand_batched(const void* K, const void* queue,
                                         long long qrows, const void* pop,
                                         int nl, int C, int deferred,
                                         void* packed, void* flags,
                                         void* action, void* flat, void* gen,
                                         void* stream) {
  const int threads = 128;
  const dim3 grid((C + threads - 1) / threads, nl);
  auto kernel = deferred ? emitted_expand_batched_kernel<true>
                         : emitted_expand_batched_kernel<false>;
  if (nl > 0 && C > 0)
    kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)K, (const uint32_t*)queue, qrows,
        (const long long*)pop, C, (uint32_t*)packed, (uint8_t*)flags,
        (int32_t*)action, (int32_t*)flat, (unsigned long long*)gen);
  return (int)cudaGetLastError();
}

template <bool kInit, bool kPack>
__global__ void struct_sim_step_batched_kernel(
    const int32_t* __restrict__ K, const int* __restrict__ go,
    const uint32_t* __restrict__ key, const int32_t* __restrict__ step_i,
    const int32_t* __restrict__ inits, int n0max,
    const int32_t* __restrict__ n0, int32_t* __restrict__ states,
    uint8_t* __restrict__ alive, int32_t* __restrict__ steps_taken, int W,
    bool check_deadlock, uint32_t* __restrict__ packed,
    uint8_t* __restrict__ take, int32_t* __restrict__ vold,
    int32_t* __restrict__ vact, int32_t* __restrict__ scratch) {
  const int b = blockIdx.y;  // the batch lane
  // go[b] is one word every block of the lane reads alike
  if (!kInit && go[b] == 0) return;
  const size_t wf = (size_t)b * W;
  states += wf * ST_F;
  vold += wf * ST_F;
  vact += wf;
  scratch += (size_t)b * SIM_SCRATCH;
  if (!kInit) {
    alive += wf;
    steps_taken += wf;
  }
  if (kPack) {
    packed += wf * ST_W;
    take += wf;
  }
  __shared__ unsigned int s_hist[ST_NLABELS];
  __shared__ unsigned int s_gen, s_trans, s_any;
  __shared__ int s_min[SIM_NCLS];
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x) s_hist[t] = 0u;
  for (int t = threadIdx.x; t < SIM_NCLS; t += blockDim.x) s_min[t] = SIM_NONE;
  if (threadIdx.x == 0) s_gen = s_trans = s_any = 0u;
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < W) {
    const uint32_t k0 = key[2 * b], k1 = key[2 * b + 1];
    SimSharedMin trip{s_min, lane};
    bool took;
    if (kInit) {
      st_sim_init_lane(K, k0, k1, lane, inits + (size_t)b * n0max * ST_F,
                       n0[b], states, trip);
      took = true;
      s_any = 1u;
    } else {
      const SimLane r =
          st_sim_lane(K, k0, k1, step_i[b] + 1, lane, states, alive,
                      steps_taken, check_deadlock, vold, vact, trip);
      if (r.gen) atomicAdd(&s_gen, r.gen);
      if (r.take) {
        atomicAdd(&s_trans, 1u);
        atomicAdd(&s_hist[r.act], 1u);
        s_any = 1u;
      }
      took = r.take;
    }
    if (kPack) {
      st_pack(states + (size_t)lane * ST_F, packed + (size_t)lane * ST_W);
      take[lane] = took;
    }
  }
  __syncthreads();
  unsigned int* su = (unsigned int*)scratch;
  if (threadIdx.x == 0) {
    if (s_gen) atomicAdd(&su[SIM_GEN], s_gen);
    if (s_trans) atomicAdd(&su[SIM_TRANS], s_trans);
    if (s_any) atomicOr((int*)&scratch[SIM_ANY], 1);
  }
  for (int t = threadIdx.x; t < SIM_NCLS; t += blockDim.x)
    if (s_min[t] != SIM_NONE) atomicMin((int*)&scratch[SIM_MIN + t], s_min[t]);
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x)
    if (s_hist[t]) atomicAdd(&su[SIM_HIST + t], s_hist[t]);
}

__global__ void sim_fold_batched_kernel(
    int init, int* __restrict__ go, int32_t* __restrict__ scratch, int depth,
    int code_base, int32_t* __restrict__ step_i, int32_t* __restrict__ viol,
    int32_t* __restrict__ viol_lane, int32_t* __restrict__ viol_step,
    int32_t* __restrict__ viol_state, int32_t* __restrict__ viol_action,
    uint32_t* __restrict__ generated, uint32_t* __restrict__ transitions,
    uint32_t* __restrict__ act_taken, const int32_t* __restrict__ states,
    const int32_t* __restrict__ vold, const int32_t* __restrict__ vact,
    int W) {
  const int b = blockIdx.x;  // one block a batch lane
  const size_t wf = (size_t)b * W;
  scratch += (size_t)b * SIM_SCRATCH;
  states += wf * ST_F;
  vold += wf * ST_F;
  vact += wf;
  viol_state += (size_t)b * ST_F;
  act_taken += (size_t)b * ST_NLABELS;
  __shared__ int s_go, s_cls, s_lane;
  if (threadIdx.x == 0) s_go = init || go[b] != 0;
  __syncthreads();
  if (!s_go) return;
  if (threadIdx.x == 0) {
    int lane;
    s_cls = st_sim_fold_scalars(init, scratch, depth, code_base, step_i + b,
                                viol + b, viol_lane + b, viol_step + b,
                                viol_action + b, generated + b,
                                transitions + b, vact, go + b, &lane);
    s_lane = lane;
  }
  __syncthreads();
  const int c = s_cls;
  if (c >= 0) {
    const bool old = c == ST_NINV || c == ST_NINV + 2;
    const int32_t* src = (old ? vold : states) + (size_t)s_lane * ST_F;
    for (int j = threadIdx.x; j < ST_F; j += blockDim.x) viol_state[j] = src[j];
  }
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x)
    act_taken[t] += (uint32_t)scratch[SIM_HIST + t];
  __syncthreads();
  for (int t = threadIdx.x; t < SIM_SCRATCH; t += blockDim.x)
    st_sim_reset(scratch, t);
}

// K34 over nl batch lanes of W walkers: init != 0 is the kInit form
// (inits [nl, n0max, ST_F], n0 [nl] int32; every lane alive); else one
// round (go, key [nl, 2], step_i [nl]; alive, steps_taken [nl, W]).
// states, vold [nl, W, ST_F], vact [nl, W], scratch [nl, SIM_SCRATCH];
// packed [nl, W, ST_W] and take [nl, W] when packed is not NULL.
extern "C" int tt_struct_sim_step_batched(
    const void* K, const void* go, const void* key, const void* step_i,
    const void* inits, int n0max, const void* n0, void* states, void* alive,
    void* steps_taken, int W, int nl, int init, int check_deadlock,
    void* packed, void* take, void* vold, void* vact, void* scratch,
    void* stream) {
  const int threads = 128;
  const dim3 grid((W + threads - 1) / threads, nl);
  auto kernel = init ? (packed ? struct_sim_step_batched_kernel<true, true>
                               : struct_sim_step_batched_kernel<true, false>)
                     : (packed ? struct_sim_step_batched_kernel<false, true>
                               : struct_sim_step_batched_kernel<false, false>);
  if (W > 0 && nl > 0)
    kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)K, (const int*)go, (const uint32_t*)key,
        (const int32_t*)step_i, (const int32_t*)inits, n0max,
        (const int32_t*)n0, (int32_t*)states, (uint8_t*)alive,
        (int32_t*)steps_taken, W, check_deadlock != 0, (uint32_t*)packed,
        (uint8_t*)take, (int32_t*)vold, (int32_t*)vact, (int32_t*)scratch);
  return (int)cudaGetLastError();
}

// K35 over nl batch lanes: each lane's scalars ([nl] arrays), viol_state
// [nl, ST_F], act_taken [nl, ST_NLABELS] and uint32 counters in place
extern "C" int tt_sim_fold_batched(int init, void* go, void* scratch,
                                   int depth, int code_base, void* step_i,
                                   void* viol, void* viol_lane,
                                   void* viol_step, void* viol_state,
                                   void* viol_action, void* generated,
                                   void* transitions, void* act_taken,
                                   const void* states, const void* vold,
                                   const void* vact, int W, int nl,
                                   void* stream) {
  if (nl > 0)
    sim_fold_batched_kernel<<<nl, 128, 0, (cudaStream_t)stream>>>(
        init, (int*)go, (int32_t*)scratch, depth, code_base,
        (int32_t*)step_i, (int32_t*)viol, (int32_t*)viol_lane,
        (int32_t*)viol_step, (int32_t*)viol_state, (int32_t*)viol_action,
        (uint32_t*)generated, (uint32_t*)transitions, (uint32_t*)act_taken,
        (const int32_t*)states, (const int32_t*)vold, (const int32_t*)vact,
        W);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the single-lane host launchers, lane by lane

extern "C" int host_emitted_expand_batched(const void* K, const void* queue,
                                           long long qrows, const void* pop,
                                           int nl, int C, int deferred,
                                           void* packed, void* flags,
                                           void* action, void* flat,
                                           void* gen) {
  const long long* p = (const long long*)pop;
  for (int b = 0; b < nl; b++) {
    const long long parity = p[4 * b], qhead = p[4 * b + 1];
    const long long n = p[4 * b + 2], ck = p[4 * b + 3];
    if (ck == 0) continue;
    const size_t slab = (size_t)b * C * ST_L;
    host_struct_expand_red(
        K,
        (const uint32_t*)queue + (((size_t)b * 2 + parity) * qrows + qhead) *
                                     ST_W,
        (int)ck, (int)n, deferred, (uint32_t*)packed + slab * ST_W,
        (uint8_t*)flags + slab * (3 + ST_NINV), (int32_t*)action + slab,
        deferred ? (void*)((int32_t*)flat + slab * ST_F) : nullptr,
        (unsigned long long*)gen + (size_t)b * ST_NLABELS, nullptr,
        nullptr);
  }
  return 0;
}

extern "C" int host_struct_sim_step_batched(
    const void* K, const void* go, const void* key, const void* step_i,
    const void* inits, int n0max, const void* n0, void* states, void* alive,
    void* steps_taken, int W, int nl, int init, int check_deadlock,
    void* packed, void* take, void* vold, void* vact, void* scratch) {
  for (int b = 0; b < nl; b++) {
    const size_t wf = (size_t)b * W;
    host_struct_sim_step(
        K, (const int*)go + b, (const uint32_t*)key + 2 * b,
        init ? nullptr : (const void*)((const int32_t*)step_i + b),
        init ? (const void*)((const int32_t*)inits + (size_t)b * n0max * ST_F)
             : nullptr,
        init ? ((const int32_t*)n0)[b] : 0, (int32_t*)states + wf * ST_F,
        init ? nullptr : (void*)((uint8_t*)alive + wf),
        init ? nullptr : (void*)((int32_t*)steps_taken + wf), W, init,
        check_deadlock,
        packed ? (void*)((uint32_t*)packed + wf * ST_W) : nullptr,
        packed ? (void*)((uint8_t*)take + wf) : nullptr,
        (int32_t*)vold + wf * ST_F, (int32_t*)vact + wf,
        (int32_t*)scratch + (size_t)b * SIM_SCRATCH);
  }
  return 0;
}

extern "C" int host_sim_fold_batched(int init, void* go, void* scratch,
                                     int depth, int code_base, void* step_i,
                                     void* viol, void* viol_lane,
                                     void* viol_step, void* viol_state,
                                     void* viol_action, void* generated,
                                     void* transitions, void* act_taken,
                                     const void* states, const void* vold,
                                     const void* vact, int W, int nl) {
  for (int b = 0; b < nl; b++) {
    const size_t wf = (size_t)b * W;
    host_sim_fold(init, (int*)go + b,
                  (int32_t*)scratch + (size_t)b * SIM_SCRATCH, depth,
                  code_base, (int32_t*)step_i + b, (int32_t*)viol + b,
                  (int32_t*)viol_lane + b, (int32_t*)viol_step + b,
                  (int32_t*)viol_state + (size_t)b * ST_F,
                  (int32_t*)viol_action + b, (uint32_t*)generated + b,
                  (uint32_t*)transitions + b,
                  (uint32_t*)act_taken + (size_t)b * ST_NLABELS,
                  (const int32_t*)states + wf * ST_F,
                  (const int32_t*)vold + wf * ST_F,
                  (const int32_t*)vact + wf);
  }
  return 0;
}

#endif
