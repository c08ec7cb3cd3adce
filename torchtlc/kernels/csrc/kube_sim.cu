// Kernel K39 "kube_sim_step" and kernel K40 "kube_sim_fold": one
// transition round of the random walk over the KubeAPI spec (the logic in
// kube_sim.cuh; the same grid and folds as K27 / K28 in emitted_sim.cuh).
//
// K39, one thread per walker: its round (kube_sim_lane) or, in the kInit
// form, its Init state (kube_sim_init_lane); under kPack its row packed
// (kube_pack) and its take flag for the sampling filter.  Each block folds
// in shared memory - the enabled count, the transitions, the per-action
// histogram of the actions taken, any walker still alive, and each
// violation class's lowest walker (atomicMin) - then adds into `scratch`
// with one atomic a word a block.  It reads the device flag `go` first and
// returns at once when it is 0 (not in the kInit form).
//
// K40, one block: kube_sim_fold_scalars on thread 0 (the first-wins
// violation, the uint32 counters, step_i, go), the violating row copied
// into viol_state, the histogram added to act_taken and the scratch reset
// by every thread.  It returns at once while go is 0 unless init.
//
// Bound: operations.  A walker's round is L + 1 runs of the lane handler
// (a few hundred integer operations each at Model_1's layout, the
// canonicalization's insertion sorts once), three threefry2x32 (~240
// operations), one invariant evaluation and the pack; its bytes - F
// fields in and out, W packed words, a few flag bytes - are small beside
// it.
#include <cuda_runtime.h>

#include "kube_sim.cuh"

struct KubeSimMin {  // a walker into its block's class minima
  int* m;
  int lane;
  __device__ void operator()(int c) { atomicMin(&m[c], lane); }
};

template <bool kInit, bool kPack>
__global__ void kube_sim_step_kernel(
    KubeLayout Y, const int* __restrict__ go, const uint32_t* __restrict__ key,
    const int32_t* __restrict__ step_i, const int32_t* __restrict__ inits,
    int n0, int32_t* __restrict__ states, uint8_t* __restrict__ alive,
    int32_t* __restrict__ steps_taken, int W, bool check_deadlock,
    uint32_t* __restrict__ packed, uint8_t* __restrict__ take,
    int32_t* __restrict__ vold, int32_t* __restrict__ vact,
    int32_t* __restrict__ scratch) {
  // go is one word the whole grid reads alike: every block returns here,
  // before any barrier, or none does
  if (!kInit && *go == 0) return;
  __shared__ unsigned int s_hist[KUBE_N_LABELS];
  __shared__ unsigned int s_gen, s_trans, s_any;
  __shared__ int s_min[KSIM_NCLS];
  for (int t = threadIdx.x; t < KUBE_N_LABELS; t += blockDim.x) s_hist[t] = 0u;
  for (int t = threadIdx.x; t < KSIM_NCLS; t += blockDim.x)
    s_min[t] = KSIM_NONE;
  if (threadIdx.x == 0) s_gen = s_trans = s_any = 0u;
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < W) {
    const uint32_t k0 = key[0], k1 = key[1];
    KubeSimMin trip{s_min, lane};
    bool took;
    if (kInit) {
      kube_sim_init_lane(Y, k0, k1, lane, inits, n0, states, trip);
      took = true;
      s_any = 1u;
    } else {
      const KubeSimLane r =
          kube_sim_lane(Y, k0, k1, *step_i + 1, lane, states, alive,
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
      kube_pack(Y, states + (size_t)lane * Y.F, packed + (size_t)lane * Y.W);
      take[lane] = took;
    }
  }
  __syncthreads();
  unsigned int* su = (unsigned int*)scratch;
  if (threadIdx.x == 0) {
    if (s_gen) atomicAdd(&su[KSIM_GEN], s_gen);
    if (s_trans) atomicAdd(&su[KSIM_TRANS], s_trans);
    if (s_any) atomicOr((int*)&scratch[KSIM_ANY], 1);
  }
  for (int t = threadIdx.x; t < KSIM_NCLS; t += blockDim.x)
    if (s_min[t] != KSIM_NONE) atomicMin(&scratch[KSIM_MIN + t], s_min[t]);
  for (int t = threadIdx.x; t < KUBE_N_LABELS; t += blockDim.x)
    if (s_hist[t]) atomicAdd(&su[KSIM_HIST + t], s_hist[t]);
}

__global__ void kube_sim_fold_kernel(
    int init, int F, int* __restrict__ go, int32_t* __restrict__ scratch,
    int depth, int32_t* __restrict__ step_i, int32_t* __restrict__ viol,
    int32_t* __restrict__ viol_lane, int32_t* __restrict__ viol_step,
    int32_t* __restrict__ viol_state, int32_t* __restrict__ viol_action,
    uint32_t* __restrict__ generated, uint32_t* __restrict__ transitions,
    uint32_t* __restrict__ act_taken, const int32_t* __restrict__ states,
    const int32_t* __restrict__ vold, const int32_t* __restrict__ vact) {
  // thread 0 rewrites go below: the block reads it once, before a barrier
  __shared__ int s_go, s_cls, s_lane;
  if (threadIdx.x == 0) s_go = init || *go != 0;
  __syncthreads();
  if (!s_go) return;
  if (threadIdx.x == 0) {
    int lane;
    s_cls = kube_sim_fold_scalars(init, scratch, depth, step_i, viol,
                                  viol_lane, viol_step, viol_action,
                                  generated, transitions, vact, go, &lane);
    s_lane = lane;
  }
  __syncthreads();
  const int c = s_cls;
  if (c >= 0) {
    const int32_t* src =
        (kube_sim_old_row(c) ? vold : states) + (size_t)s_lane * F;
    for (int j = threadIdx.x; j < F; j += blockDim.x) viol_state[j] = src[j];
  }
  for (int t = threadIdx.x; t < KUBE_N_LABELS; t += blockDim.x)
    act_taken[t] += (uint32_t)scratch[KSIM_HIST + t];
  __syncthreads();
  for (int t = threadIdx.x; t < KSIM_SCRATCH; t += blockDim.x)
    kube_sim_reset(scratch, t);
}

extern "C" int tt_kube_sim_dims(int* out) {
  out[0] = KSIM_SCRATCH;
  out[1] = KSIM_NCLS;
  out[2] = KUBE_N_LABELS;
  return 0;
}

// K39: init != 0 is the kInit form (inits [n0, F], every walker alive;
// states written); else one round over states [W, F] (in place).  packed
// [W, W_words] and take [W] are written when packed is not NULL.  scratch
// holds KSIM_SCRATCH words in their reset state; vold [W, F] and vact [W]
// are written only at the walkers that trip a class.
extern "C" int tt_kube_sim_step(const void* layout, const void* go,
                                const void* key, const void* step_i,
                                const void* inits, int n0, void* states,
                                void* alive, void* steps_taken, int W,
                                int init, int check_deadlock, void* packed,
                                void* take, void* vold, void* vact,
                                void* scratch, void* stream) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  const int threads = 128;
  const int blocks = (W + threads - 1) / threads;
  auto kernel = init ? (packed ? kube_sim_step_kernel<true, true>
                               : kube_sim_step_kernel<true, false>)
                     : (packed ? kube_sim_step_kernel<false, true>
                               : kube_sim_step_kernel<false, false>);
  if (blocks > 0)
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        Y, (const int*)go, (const uint32_t*)key, (const int32_t*)step_i,
        (const int32_t*)inits, n0, (int32_t*)states, (uint8_t*)alive,
        (int32_t*)steps_taken, W, check_deadlock != 0, (uint32_t*)packed,
        (uint8_t*)take, (int32_t*)vold, (int32_t*)vact, (int32_t*)scratch);
  return (int)cudaGetLastError();
}

// K40: the carry's scalars, viol_state [F] and the uint32 counters are
// updated in place; go is written (and read first unless init).
extern "C" int tt_kube_sim_fold(int init, int F, void* go, void* scratch,
                                int depth, void* step_i, void* viol,
                                void* viol_lane, void* viol_step,
                                void* viol_state, void* viol_action,
                                void* generated, void* transitions,
                                void* act_taken, const void* states,
                                const void* vold, const void* vact,
                                void* stream) {
  kube_sim_fold_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      init, F, (int*)go, (int32_t*)scratch, depth, (int32_t*)step_i,
      (int32_t*)viol, (int32_t*)viol_lane, (int32_t*)viol_step,
      (int32_t*)viol_state, (int32_t*)viol_action, (uint32_t*)generated,
      (uint32_t*)transitions, (uint32_t*)act_taken, (const int32_t*)states,
      (const int32_t*)vold, (const int32_t*)vact);
  return (int)cudaGetLastError();
}
