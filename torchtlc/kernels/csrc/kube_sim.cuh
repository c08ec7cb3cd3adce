// The random walk's round over the KubeAPI spec: the logic of kernels K39
// "kube_sim_step" and K40 "kube_sim_fold" (kube_sim.cu) as __host__
// __device__ functions, so nvcc builds the kernels and g++ the host
// library of the CPU tests (host_launch.cpp) from the same code.
//
// They replace jaxtlc/sim/engine.py:118 make_sim_engine's walk over
// jaxtlc/engine/backend.py:432 kubeapi_backend - :232 body with
// make_kernel's step (jaxtlc/spec/kernel.py:521) vmapped over the walkers,
// the idx-th enabled lane, the invariants (jaxtlc/spec/invariants.py:50)
// of the chosen states, :186 init_fn (round 0) and :162 lane_bits - as
// K27 / K28 (emitted_sim.cuh) replace it over an emitted spec.
//
// K39's walker (one thread) composes kubeapi.cuh: two passes over the L
// lanes of its current state, in make_kernel's lane order (client ci's CL
// lanes at ci * CL, then the nc request and the nc list lanes of the API
// server).  The first pass runs each lane's handler only for its validity
// flag (kube_succ_raw: no canonicalization, one successor buffer reused,
// the flags kept as bits), so the thread's frame holds two rows of
// KUBE_MAXF fields, not L successors; the second recomputes the chosen
// lane's canonical successor (kube_succ_fields) - the row make_kernel's
// step returns.  The draw is threefry.cuh's tf_draw(key, lane, d), idx =
// bits % n in uint32, the idx-th enabled lane; its action is the lane's
// label as make_kernel assigns it (client ci's current pc label, APIStart
// for a server lane).  The invariants (kube_invariants) run on the chosen
// state only.
//
// Violation classes (in K40's priority order): 0 TypeOK, 1 OnlyOneVersion,
// 2 the PlusCal assertion, 3 deadlock (with check_deadlock), 4 the codec
// slot overflow; their codes 1-5 are jaxtlc/engine/bfs.py:53-58's.  The
// scratch is K27's layout with ST_NINV 2 and ST_NLABELS KUBE_N_LABELS.
#pragma once
#include "kubeapi.cuh"
#include "threefry.cuh"

#define KSIM_NINV 2
#define KSIM_NCLS (KSIM_NINV + 3)
// scratch layout (int32 words; the counters hold uint32 bit patterns)
#define KSIM_GEN 0                        // enabled successors examined
#define KSIM_TRANS 1                      // transitions taken
#define KSIM_ANY 2                        // some lane still walking
#define KSIM_MIN 3                        // KSIM_NCLS lowest lanes
#define KSIM_HIST (KSIM_MIN + KSIM_NCLS)  // KUBE_N_LABELS actions taken
#define KSIM_SCRATCH (KSIM_HIST + KUBE_N_LABELS)
#define KSIM_NONE 0x7FFFFFFF
// the lanes of one state: KUBE_MAXC clients of at most max(KUBE_MAXI, 3)
// lanes, then 2 * KUBE_MAXC server lanes; the enabled flags as bits
#define KSIM_MAXL (KUBE_MAXC * KUBE_MAXI + 2 * KUBE_MAXC)
#define KSIM_MASKW ((KSIM_MAXL + 31) / 32)

// What one walker adds to its block's fold besides its violation classes.
struct KubeSimLane {
  uint32_t gen;  // its enabled lanes
  bool take;     // it took a transition (and so is still walking)
  int act;       // the action it took
};

// K39's work for walker `lane` at transition d over states [W, F] (in
// place); trip(c) folds the walker into violation class c.
template <typename Trip>
HD KubeSimLane kube_sim_lane(const KubeLayout& Y, uint32_t k0, uint32_t k1,
                             int32_t d, int lane, int32_t* states,
                             uint8_t* alive, int32_t* steps_taken,
                             bool check_deadlock, int32_t* vold,
                             int32_t* vact, Trip& trip) {
  KubeSimLane r{0u, false, 0};
  if (!alive[lane]) return r;
  int32_t* row = states + (size_t)lane * Y.F;
  int32_t f[KUBE_MAXF], s[KUBE_MAXF];
  for (int j = 0; j < Y.F; j++) f[j] = row[j];
  uint32_t mask[KSIM_MASKW];
  for (int w = 0; w < KSIM_MASKW; w++) mask[w] = 0u;
  uint32_t n = 0;
  for (int l = 0; l < Y.L; l++)
    if (kube_succ_raw(Y, f, l, s).valid) {
      mask[l >> 5] |= 1u << (l & 31);
      n++;
    }
  r.gen = n;
  if (n == 0) {
    alive[lane] = 0;
    if (check_deadlock) trip(KSIM_NINV + 1);
    return r;
  }
  uint32_t idx = tf_draw(k0, k1, (uint32_t)lane, (uint32_t)d) % n;
  int chosen = 0;
  for (int l = 0; l < Y.L; l++)
    if ((mask[l >> 5] >> (l & 31)) & 1u) {
      if (idx == 0u) {
        chosen = l;
        break;
      }
      idx--;
    }
  const LaneOut o = kube_succ_fields(Y, f, true, chosen, s);
  r.take = true;
  r.act = o.action;
  bool tripped = false;
  if (o.afail) {
    trip(KSIM_NINV);
    tripped = true;
  }
  if (o.ovf) {
    trip(KSIM_NINV + 2);
    tripped = true;
  }
  if (tripped)  // the state the assertion and the slot overflow report
    for (int j = 0; j < Y.F; j++) vold[(size_t)lane * Y.F + j] = f[j];
  for (int j = 0; j < Y.F; j++) row[j] = s[j];
  const int bits = kube_invariants(Y, s);
  for (int k = 0; k < KSIM_NINV; k++)
    if (!((bits >> k) & 1)) {
      trip(k);
      tripped = true;
    }
  if (tripped) vact[lane] = r.act;
  steps_taken[lane] = d;
  return r;
}

// K39's kInit work for walker `lane`: its Init state (the draw of (lane,
// 0) % n0 over inits [n0, F]) and the invariant classes it trips.
template <typename Trip>
HD void kube_sim_init_lane(const KubeLayout& Y, uint32_t k0, uint32_t k1,
                           int lane, const int32_t* inits, int n0,
                           int32_t* states, Trip& trip) {
  const uint32_t idx = tf_draw(k0, k1, (uint32_t)lane, 0u) % (uint32_t)n0;
  int32_t* row = states + (size_t)lane * Y.F;
  for (int j = 0; j < Y.F; j++) row[j] = inits[(size_t)idx * Y.F + j];
  const int bits = kube_invariants(Y, row);
  for (int k = 0; k < KSIM_NINV; k++)
    if (!((bits >> k) & 1)) trip(k);
}

// K40's violation code of class c: TypeOK 1, OnlyOneVersion 2, assertion
// 3, deadlock 4, slot overflow 5.
HD int32_t kube_sim_code(int c) {
  return c < KSIM_NINV ? 1 + c
         : c == KSIM_NINV     ? 3
         : c == KSIM_NINV + 1 ? 4
                              : 5;
}

// K40's scalar part (one thread): while the carry's violation is OK the
// first class with a lane sets the violation leaves; the counters add the
// partials (wrapping), step_i advances and go is rewritten.  Returns the
// class it took (-1 none) and sets *lane_out.
HD int kube_sim_fold_scalars(int init, const int32_t* scratch, int depth,
                             int32_t* step_i, int32_t* viol,
                             int32_t* viol_lane, int32_t* viol_step,
                             int32_t* viol_action, uint32_t* generated,
                             uint32_t* transitions, const int32_t* vact,
                             int* go, int* lane_out) {
  const int32_t d = init ? 0 : *step_i + 1;
  int c = -1, lane = -1;
  if (*viol == 0)
    for (int k = 0; k < KSIM_NCLS; k++)
      if (scratch[KSIM_MIN + k] != KSIM_NONE) {
        c = k;
        lane = scratch[KSIM_MIN + k];
        break;
      }
  if (c >= 0) {
    *viol = kube_sim_code(c);
    *viol_lane = lane;
    *viol_step = d;
    *viol_action = (init || c == KSIM_NINV + 1) ? -1 : vact[lane];
  }
  if (!init) {
    *generated += (uint32_t)scratch[KSIM_GEN];
    *transitions += (uint32_t)scratch[KSIM_TRANS];
    *step_i = d;
  }
  *go = (d < depth && *viol == 0 && scratch[KSIM_ANY] != 0) ? 1 : 0;
  *lane_out = lane;
  return c;
}

// The row the violation of class c reports: the old row for the
// assertion and the slot overflow, else the walker's current row.
HD bool kube_sim_old_row(int c) {
  return c == KSIM_NINV || c == KSIM_NINV + 2;
}

HD void kube_sim_reset(int32_t* scratch, int t) {
  scratch[t] = (t >= KSIM_MIN && t < KSIM_HIST) ? KSIM_NONE : 0;
}
