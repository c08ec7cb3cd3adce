// Kernel K27 "struct_sim_step" and kernel K28 "sim_fold": one transition
// round of the random-walk engine over an emitted spec.  Written only
// against the emitted st_step / st_inv_bits and the ST_* macros (and
// struct_codec.cuh's st_pack), so any emitted template can include it;
// struct_expand.cuh does, so every struct spec's library exports both.
//
// They replace jaxtlc/sim/engine.py:118 make_sim_engine's walk over a
// struct backend: :186 init_fn (round 0), :232 body, :317 cond and the
// :162 lane_bits draw (jax.random's threefry, threefry.cuh here).
//
// K27, one thread per walker (lane): read its raw fields [F] (the carry
// holds fields, not packed words), run the emitted step over all L lanes
// in registers (the successors in the thread's stack frame, as K17's),
// count the enabled lanes, draw tf_draw(key, lane, d) for d = step_i + 1,
// take idx = bits % max(n, 1) in uint32 and pick the idx-th enabled lane
// in the emitted lane order, then evaluate the invariants on the chosen
// state only.  The chosen fields are written over the lane's row in place;
// a lane whose chosen successor trips the assertion or the slot overflow
// first saves its old row to `vold` (the state those violations report;
// a deadlocked lane takes no transition, so its row stays the old state),
// and a lane that trips any class saves its action to `vact`.  It sets
// steps_taken, alive &= n > 0 and, under kPack, packs the chosen row
// (struct_codec.cuh) and its take flag for the sampling filter.  Each
// block folds, in shared memory and then with one atomic a block into
// `scratch`: the enabled count (generated), the lanes that took a
// transition, the per-action histogram of those, any lane still alive,
// and for each violation class - the ST_NINV invariants, the assertion,
// deadlock (with check_deadlock), the slot overflow - the lowest lane
// that trips it (atomicMin).  The kInit form is round 0: the draw
// tf_draw(key, lane, 0) % n0 over the Init vectors and the invariant
// classes on the chosen Init states.
//
// K28, one block: while the carry's violation is OK it takes the classes
// in priority order (jaxtlc/sim/engine.py:264-290: invariants in backend
// order, assertion, deadlock, slot overflow; the lowest lane) and sets
// viol, viol_lane, viol_step = d, viol_state (the new row for an
// invariant or deadlock, `vold` for the assertion and the slot overflow)
// and viol_action (-1 for a deadlock and on round 0); adds the partials to
// the uint32 counters (wrapping); advances step_i; resets the scratch;
// and writes the device flag go = step_i < depth & viol == OK & any lane
// alive.  K27 and K28 read go first and return at once when it is 0, so a
// round after the walk's condition turned false is the identity, as
// lax.cond makes it, and the host launches rounds with no read of its own.
// The walk is never fused into one persistent kernel: stopping is global
// (the condition reads every lane), and a kernel boundary is the fence.
//
// Bound: operations.  A lane's step is the emitted lane IR (a few hundred
// to a few thousand integer statements), plus three threefry2x32 (~200
// integer operations) and one lane's invariants; the bytes - F fields in
// and out, W packed words, a few flag bytes a lane - are small beside it.
#pragma once

#include "threefry.cuh"

#define SIM_NCLS (ST_NINV + 3)
// scratch layout (int32 words; the counters hold uint32 bit patterns)
#define SIM_GEN 0                      // enabled successors examined
#define SIM_TRANS 1                    // transitions taken
#define SIM_ANY 2                      // some lane still walking
#define SIM_MIN 3                      // SIM_NCLS lowest lanes, SIM_NONE if none
#define SIM_HIST (SIM_MIN + SIM_NCLS)  // ST_NLABELS actions taken
#define SIM_SCRATCH (SIM_HIST + ST_NLABELS)
#define SIM_NONE 0x7FFFFFFF
#define SIM_ASSERT_CODE 3
#define SIM_DEADLOCK_CODE 4
#define SIM_SLOT_CODE 5

// What one lane adds to its block's fold besides its violation classes.
struct SimLane {
  uint32_t gen;  // its enabled lanes
  bool take;     // it took a transition (and so is still walking)
  int act;       // the action it took
};

// K27's work for walker `lane` at transition d; trip(c) folds the lane
// into violation class c.
template <typename Trip>
HD SimLane st_sim_lane(const int32_t* __restrict__ K, uint32_t k0,
                       uint32_t k1, int32_t d, int lane,
                       int32_t* __restrict__ states,
                       uint8_t* __restrict__ alive,
                       int32_t* __restrict__ steps_taken, bool check_deadlock,
                       int32_t* __restrict__ vold, int32_t* __restrict__ vact,
                       Trip& trip) {
  SimLane r{0u, false, 0};
  if (!alive[lane]) return r;
  int32_t* row = states + (size_t)lane * ST_F;
  int32_t f[ST_F];
  for (int j = 0; j < ST_F; j++) f[j] = row[j];
  int32_t succ[ST_L * ST_F];
  bool valid[ST_L], ovf[ST_L], afail[ST_L];
  st_step(f, K, succ, valid, ovf, afail);
  uint32_t n = 0;
  for (int l = 0; l < ST_L; l++) n += valid[l] ? 1u : 0u;
  r.gen = n;
  if (n == 0) {
    alive[lane] = 0;
    if (check_deadlock) trip(ST_NINV + 1);
    return r;
  }
  const uint32_t idx = tf_draw(k0, k1, (uint32_t)lane, (uint32_t)d) % n;
  int chosen = 0;
  uint32_t seen = 0;
  for (int l = 0; l < ST_L; l++) {
    if (valid[l]) {
      if (seen == idx) {
        chosen = l;
        break;
      }
      seen++;
    }
  }
  const int lane_action[ST_L] = {ST_LANE_ACTION};
  r.take = true;
  r.act = lane_action[chosen];
  bool tripped = false;
  if (afail[chosen]) {
    trip(ST_NINV);
    tripped = true;
  }
  if (ovf[chosen]) {
    trip(ST_NINV + 2);
    tripped = true;
  }
  if (tripped)  // the state the assertion and the slot overflow report
    for (int j = 0; j < ST_F; j++) vold[(size_t)lane * ST_F + j] = f[j];
  const int32_t* s = succ + chosen * ST_F;
  for (int j = 0; j < ST_F; j++) row[j] = s[j];
  const uint32_t bits = st_inv_bits(row, K);
  for (int k = 0; k < ST_NINV; k++)
    if (!((bits >> k) & 1u)) {
      trip(k);
      tripped = true;
    }
  if (tripped) vact[lane] = r.act;
  steps_taken[lane] = d;
  return r;
}

// K27's kInit work for walker `lane`: its Init state and the invariant
// classes it trips.
template <typename Trip>
HD void st_sim_init_lane(const int32_t* __restrict__ K, uint32_t k0,
                         uint32_t k1, int lane,
                         const int32_t* __restrict__ inits, int n0,
                         int32_t* __restrict__ states, Trip& trip) {
  const uint32_t idx = tf_draw(k0, k1, (uint32_t)lane, 0u) % (uint32_t)n0;
  int32_t* row = states + (size_t)lane * ST_F;
  for (int j = 0; j < ST_F; j++) row[j] = inits[(size_t)idx * ST_F + j];
  const uint32_t bits = st_inv_bits(row, K);
  for (int k = 0; k < ST_NINV; k++)
    if (!((bits >> k) & 1u)) trip(k);
}

// K28's decision: the first class with a lane, while the carry is OK;
// returns the class (-1 for none) and sets *lane.
HD int st_sim_pick(const int32_t* scratch, int32_t viol, int* lane) {
  if (viol != 0) return -1;
  for (int c = 0; c < SIM_NCLS; c++)
    if (scratch[SIM_MIN + c] != SIM_NONE) {
      *lane = scratch[SIM_MIN + c];
      return c;
    }
  return -1;
}

HD int32_t st_sim_code(int c, int code_base) {
  return c < ST_NINV ? code_base + c
         : c == ST_NINV     ? SIM_ASSERT_CODE
         : c == ST_NINV + 1 ? SIM_DEADLOCK_CODE
                            : SIM_SLOT_CODE;
}

// K28's scalar part (one thread): returns the class it took (-1 none).
HD int st_sim_fold_scalars(int init, const int32_t* scratch, int depth,
                           int code_base, int32_t* step_i, int32_t* viol,
                           int32_t* viol_lane, int32_t* viol_step,
                           int32_t* viol_action, uint32_t* generated,
                           uint32_t* transitions,
                           const int32_t* __restrict__ vact, int* go,
                           int* lane_out) {
  const int32_t d = init ? 0 : *step_i + 1;
  int lane = -1;
  const int c = st_sim_pick(scratch, *viol, &lane);
  if (c >= 0) {
    *viol = st_sim_code(c, code_base);
    *viol_lane = lane;
    *viol_step = d;
    *viol_action = (init || c == ST_NINV + 1) ? -1 : vact[lane];
  }
  if (!init) {
    *generated += (uint32_t)scratch[SIM_GEN];
    *transitions += (uint32_t)scratch[SIM_TRANS];
    *step_i = d;
  }
  *go = (d < depth && *viol == 0 && scratch[SIM_ANY] != 0) ? 1 : 0;
  *lane_out = lane;
  return c;
}

HD void st_sim_reset(int32_t* scratch, int t) {
  scratch[t] = (t >= SIM_MIN && t < SIM_HIST) ? SIM_NONE : 0;
}

extern "C" int tt_sim_dims(int* out) {
  out[0] = SIM_SCRATCH;
  out[1] = SIM_NCLS;
  return 0;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

struct SimSharedMin {  // a lane into its block's class minima
  int* m;
  int lane;
  __device__ void operator()(int c) { atomicMin(&m[c], lane); }
};

template <bool kInit, bool kPack>
__global__ void struct_sim_step_kernel(
    const int32_t* __restrict__ K, const int* __restrict__ go,
    const uint32_t* __restrict__ key, const int32_t* __restrict__ step_i,
    const int32_t* __restrict__ inits, int n0, int32_t* __restrict__ states,
    uint8_t* __restrict__ alive, int32_t* __restrict__ steps_taken, int W,
    bool check_deadlock, uint32_t* __restrict__ packed,
    uint8_t* __restrict__ take, int32_t* __restrict__ vold,
    int32_t* __restrict__ vact, int32_t* __restrict__ scratch) {
  // go is one word the whole grid reads alike: every block returns here,
  // before any barrier, or none does
  if (!kInit && *go == 0) return;
  __shared__ unsigned int s_hist[ST_NLABELS];
  __shared__ unsigned int s_gen, s_trans, s_any;
  __shared__ int s_min[SIM_NCLS];
  for (int t = threadIdx.x; t < ST_NLABELS; t += blockDim.x) s_hist[t] = 0u;
  for (int t = threadIdx.x; t < SIM_NCLS; t += blockDim.x) s_min[t] = SIM_NONE;
  if (threadIdx.x == 0) s_gen = s_trans = s_any = 0u;
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < W) {
    const uint32_t k0 = key[0], k1 = key[1];
    SimSharedMin trip{s_min, lane};
    bool took;
    if (kInit) {
      st_sim_init_lane(K, k0, k1, lane, inits, n0, states, trip);
      took = true;
      s_any = 1u;
    } else {
      const SimLane r =
          st_sim_lane(K, k0, k1, *step_i + 1, lane, states, alive,
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

__global__ void sim_fold_kernel(
    int init, int* __restrict__ go, int32_t* __restrict__ scratch, int depth,
    int code_base, int32_t* __restrict__ step_i, int32_t* __restrict__ viol,
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
    s_cls = st_sim_fold_scalars(init, scratch, depth, code_base, step_i, viol,
                                viol_lane, viol_step, viol_action, generated,
                                transitions, vact, go, &lane);
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

// K27: init != 0 is the kInit form (inits [n0, ST_F], every lane alive;
// states written); else one round over states [W, ST_F] (in place).
// packed [W, ST_W] and take [W] are written when packed is not NULL.
// scratch holds SIM_SCRATCH words in their reset state; vold [W, ST_F] and
// vact [W] are written only at the lanes that trip a class.
extern "C" int tt_struct_sim_step(const void* K, const void* go,
                                  const void* key, const void* step_i,
                                  const void* inits, int n0, void* states,
                                  void* alive, void* steps_taken, int W,
                                  int init, int check_deadlock, void* packed,
                                  void* take, void* vold, void* vact,
                                  void* scratch, void* stream) {
  const int threads = 128;
  const int blocks = (W + threads - 1) / threads;
  auto kernel = init ? (packed ? struct_sim_step_kernel<true, true>
                               : struct_sim_step_kernel<true, false>)
                     : (packed ? struct_sim_step_kernel<false, true>
                               : struct_sim_step_kernel<false, false>);
  if (blocks > 0)
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)K, (const int*)go, (const uint32_t*)key,
        (const int32_t*)step_i, (const int32_t*)inits, n0, (int32_t*)states,
        (uint8_t*)alive, (int32_t*)steps_taken, W, check_deadlock != 0,
        (uint32_t*)packed, (uint8_t*)take, (int32_t*)vold, (int32_t*)vact,
        (int32_t*)scratch);
  return (int)cudaGetLastError();
}

// K28: the carry's scalars, viol_state [ST_F] and the uint32 counters are
// updated in place; go is written (and read first unless init).
extern "C" int tt_sim_fold(int init, void* go, void* scratch, int depth,
                           int code_base, void* step_i, void* viol,
                           void* viol_lane, void* viol_step, void* viol_state,
                           void* viol_action, void* generated,
                           void* transitions, void* act_taken,
                           const void* states, const void* vold,
                           const void* vact, void* stream) {
  sim_fold_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      init, (int*)go, (int32_t*)scratch, depth, code_base, (int32_t*)step_i,
      (int32_t*)viol, (int32_t*)viol_lane, (int32_t*)viol_step,
      (int32_t*)viol_state, (int32_t*)viol_action, (uint32_t*)generated,
      (uint32_t*)transitions, (uint32_t*)act_taken, (const int32_t*)states,
      (const int32_t*)vold, (const int32_t*)vact);
  return (int)cudaGetLastError();
}

#else  // the g++ build: the same lane and fold functions in loops

struct SimHostMin {  // a lane into the scratch's class minima
  int32_t* sc;
  int lane;
  void operator()(int c) {
    if (lane < sc[SIM_MIN + c]) sc[SIM_MIN + c] = lane;
  }
};

extern "C" int host_struct_sim_step(const void* K, const void* go,
                                    const void* key, const void* step_i,
                                    const void* inits, int n0, void* states,
                                    void* alive, void* steps_taken, int W,
                                    int init, int check_deadlock,
                                    void* packed, void* take, void* vold,
                                    void* vact, void* scratch) {
  if (!init && *(const int*)go == 0) return 0;
  const uint32_t k0 = ((const uint32_t*)key)[0];
  const uint32_t k1 = ((const uint32_t*)key)[1];
  int32_t* sc = (int32_t*)scratch;
  uint32_t* su = (uint32_t*)scratch;
  for (int lane = 0; lane < W; lane++) {
    SimHostMin trip{sc, lane};
    bool took;
    if (init) {
      st_sim_init_lane((const int32_t*)K, k0, k1, lane,
                       (const int32_t*)inits, n0, (int32_t*)states, trip);
      took = true;
      sc[SIM_ANY] = 1;
    } else {
      const SimLane r = st_sim_lane(
          (const int32_t*)K, k0, k1, *(const int32_t*)step_i + 1, lane,
          (int32_t*)states, (uint8_t*)alive, (int32_t*)steps_taken,
          check_deadlock != 0, (int32_t*)vold, (int32_t*)vact, trip);
      su[SIM_GEN] += r.gen;
      if (r.take) {
        su[SIM_TRANS] += 1u;
        su[SIM_HIST + r.act] += 1u;
        sc[SIM_ANY] = 1;
      }
      took = r.take;
    }
    if (packed) {
      st_pack((int32_t*)states + (size_t)lane * ST_F,
              (uint32_t*)packed + (size_t)lane * ST_W);
      ((uint8_t*)take)[lane] = took;
    }
  }
  return 0;
}

extern "C" int host_sim_fold(int init, void* go, void* scratch, int depth,
                             int code_base, void* step_i, void* viol,
                             void* viol_lane, void* viol_step,
                             void* viol_state, void* viol_action,
                             void* generated, void* transitions,
                             void* act_taken, const void* states,
                             const void* vold, const void* vact) {
  if (!init && *(int*)go == 0) return 0;
  int32_t* sc = (int32_t*)scratch;
  int lane;
  const int c = st_sim_fold_scalars(
      init, sc, depth, code_base, (int32_t*)step_i, (int32_t*)viol,
      (int32_t*)viol_lane, (int32_t*)viol_step, (int32_t*)viol_action,
      (uint32_t*)generated, (uint32_t*)transitions, (const int32_t*)vact,
      (int*)go, &lane);
  if (c >= 0) {
    const bool old = c == ST_NINV || c == ST_NINV + 2;
    const int32_t* src =
        (const int32_t*)(old ? vold : states) + (size_t)lane * ST_F;
    for (int j = 0; j < ST_F; j++) ((int32_t*)viol_state)[j] = src[j];
  }
  for (int t = 0; t < ST_NLABELS; t++)
    ((uint32_t*)act_taken)[t] += (uint32_t)sc[SIM_HIST + t];
  for (int t = 0; t < SIM_SCRATCH; t++) st_sim_reset(sc, t);
  return 0;
}
#endif
