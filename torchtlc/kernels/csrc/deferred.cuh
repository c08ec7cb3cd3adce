// Per-claimant logic of the deferred invariant check (kernel K7,
// deferred.cu) as __host__ __device__ functions.
//
// Replaces the body of jaxtlc/engine/backend.py:make_deferred_checker
// (:325-420) for KubeAPI (no certificate check).  The reference gathers
// the fresh claimant's raw successor fields from the expand stage's
// [N, F] `flat`; the port's expand kernel writes packed words only
// (packing truncates fields), so the raw successor is derived again from
// the popped source row (lane / L) and the lane (lane % L) through the
// expand kernel's own per-lane function.
#pragma once
#include "kubeapi.cuh"

#define DEFERRED_N_CODES 2  // bit k failing reports code k + 1

// invariant bits (bit 0 TypeOK, bit 1 OnlyOneVersion; set = holds) of
// candidate `lane`'s raw successor, whose F fields go to s
HD int kube_claimant_bits(const KubeLayout& Y, const u32* block,
                          long long lane, int32_t* s) {
  kube_succ_lane(Y, block + (size_t)(lane / Y.L) * Y.W, true,
                 (int)(lane % Y.L), s);
  return kube_invariants(Y, s);
}

// The verdict from the per-code highest violating lanes (bad_lane[k], -1
// when none): first wins across the codes, the highest lane within one.
// Writes the code (0 = OK), the lane's raw successor fields ([F] zeros
// when OK) and its action (-1 when OK).
HD void kube_deferred_pick(const KubeLayout& Y, const u32* block,
                           const int32_t* action, const int* bad_lane,
                           long long* viol, int32_t* state,
                           long long* vaction) {
  int code = 0;
  long long lane = -1;
  for (int k = 0; k < DEFERRED_N_CODES; k++)
    if (code == 0 && bad_lane[k] >= 0) {
      code = k + 1;
      lane = bad_lane[k];
    }
  *viol = code;
  if (code == 0) {
    for (int j = 0; j < Y.F; j++) state[j] = 0;
    *vaction = -1;
    return;
  }
  int32_t s[KUBE_MAXF];
  kube_claimant_bits(Y, block, lane, s);
  for (int j = 0; j < Y.F; j++) state[j] = s[j];
  *vaction = action[lane];
}

// The sharded engine's owner-side check (jaxtlc/engine/sharded.py:737-747):
// the claimants are rows of the owner's received batch, whose raw
// successor fields arrived with them ([N, F] int32 `rows`), so a
// claimant's state is read, not derived again.
HD int kube_row_bits(const KubeLayout& Y, const int32_t* rows,
                     long long lane, int32_t* s) {
  for (int j = 0; j < Y.F; j++) s[j] = rows[(size_t)lane * Y.F + j];
  return kube_invariants(Y, s);
}

// kube_deferred_pick over received rows: the code (0 = OK) and the
// violating row's fields ([F] zeros when OK); the sharded result reports
// no action.
HD void kube_deferred_pick_rows(const KubeLayout& Y, const int32_t* rows,
                                const int* bad_lane, long long* viol,
                                int32_t* state) {
  int code = 0;
  long long lane = -1;
  for (int k = 0; k < DEFERRED_N_CODES; k++)
    if (code == 0 && bad_lane[k] >= 0) {
      code = k + 1;
      lane = bad_lane[k];
    }
  *viol = code;
  for (int j = 0; j < Y.F; j++)
    state[j] = code == 0 ? 0 : rows[(size_t)lane * Y.F + j];
}
