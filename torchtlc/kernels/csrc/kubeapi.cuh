// KubeAPI per-lane expansion: the logic of kernel K1 (expand.cu) as
// __host__ __device__ functions.
//
// Replaces jaxtlc/spec/codec.py:Codec.unpack/canonicalize/pack,
// jaxtlc/spec/kernel.py:make_kernel.step and
// jaxtlc/spec/invariants.py:make_invariant_kernel.check for ONE (state,
// lane) pair: unpack the packed row, compute the lane's successor,
// canonicalize it, evaluate TypeOK/OnlyOneVersion on it, pack it.  The
// reference dispatches statically per client role; here the handler is a
// run-time switch on (role, pc label, lane).  Lane contents equal the
// reference's, including guarded-off lanes (the handler's successor, the
// label id) and lanes no handler emits (the unchanged state, action 0).
//
// Word arithmetic is uint32 (the reference's int32 words, bit for bit);
// every layout constant comes in the KubeLayout argument, so one build
// serves every ModelConfig within the KUBE_MAX* bounds.
#pragma once
#include "common.cuh"

#define KUBE_MAXC 8
#define KUBE_MAXI 16
#define KUBE_MAXF 96
#define KUBE_MAXW 8

// label / verb / response ids: torchtlc/spec/labels.py order
enum {
  LBL_DoRequest = 0, LBL_DoReply, LBL_DoListRequest, LBL_DoListReply,
  LBL_CStart, LBL_C1, LBL_C10, LBL_C11, LBL_c12, LBL_C13, LBL_C2, LBL_C3,
  LBL_C8, LBL_C6, LBL_C7, LBL_C4, LBL_C5, LBL_PVCStart, LBL_PVCListedPVCs,
  LBL_PVCHavePVCs, LBL_PVCDone, LBL_APIStart, KUBE_N_LABELS
};
enum { VERB_Create = 0, VERB_Get, VERB_Update, VERB_Delete, VERB_Force };
enum { ST_PENDING = 0, ST_OK, ST_ERROR };
enum { MUT_NONE = 0, MUT_DELETE_NOOP, MUT_STICKY_RECONCILE };

// Field order == torchtlc/engine/backend.py:kernel_layout.
struct KubeLayout {
  int32_t ni, nc, ls, nr, ib, kb, lb, n_kinds;
  int32_t o_spec, o_vv, o_hasvv, o_ident, o_present, obj_bits;
  int32_t r_obj, r_status, r_op, r_present;
  int32_t lm_status, lm_kind, lm_present;
  int32_t s_retpc, s_proc, s_present;
  int32_t F, W, nbits, CL, L;
  int32_t fail, timeout, mutation, pvc_kind;
  int32_t off_api, off_req, off_lm, off_lo, off_pc, off_stack, off_pop,
      off_pobj, off_pkind, off_sr;
  int32_t width[KUBE_MAXF];  // packed width of each field lane
  int32_t role[KUBE_MAXC];   // 0 reconciler, 1 binder
  int32_t secret_w[KUBE_MAXC], pvc_w[KUBE_MAXC];  // target object words
  int32_t secret_kind[KUBE_MAXC], sr_idx[KUBE_MAXC];
  int32_t ident_kind[KUBE_MAXI];
};

typedef uint32_t u32;
#define KUBE_INT32_MIN (-2147483647 - 1)

struct LaneOut {
  bool valid, afail, ovf, bad_typeok, bad_onlyone;
  int32_t action;
};

// -- object / request word ops ----------------------------------------------

HD u32 k_present(const KubeLayout& Y, u32 w) { return (w >> Y.o_present) & 1u; }
HD u32 k_ident(const KubeLayout& Y, u32 w) {
  return (w >> Y.o_ident) & ((1u << Y.ib) - 1u);
}
// an out-of-range ident maps to INT32_MIN, the reference's jnp.take fill
HD int32_t k_kind_of(const KubeLayout& Y, u32 w) {
  u32 i = k_ident(Y, w);
  return i < (u32)Y.ni ? Y.ident_kind[i] : KUBE_INT32_MIN;
}
HD u32 k_obj_mask(const KubeLayout& Y) { return (1u << Y.obj_bits) - 1u; }
HD u32 k_write_w(const KubeLayout& Y, u32 w) {  // Write: vv := {}
  u32 vv = ((1u << Y.nc) - 1u) << Y.o_vv;
  return (w & ~vv) | (1u << Y.o_hasvv);
}
HD u32 k_read_w(const KubeLayout& Y, u32 w, int c) {  // Read: vv += {c}
  return w | (1u << (Y.o_vv + c));
}
HD bool k_unbound_pvc(const KubeLayout& Y, u32 w) {
  return k_present(Y, w) == 1u && k_kind_of(Y, w) == Y.pvc_kind &&
         ((w >> Y.o_spec) & 1u) == 0u;
}
HD u32 k_req_status(const KubeLayout& Y, u32 w) { return (w >> Y.r_status) & 3u; }
HD u32 k_req_obj(const KubeLayout& Y, u32 w) {
  return (w >> Y.r_obj) & k_obj_mask(Y);
}
HD u32 k_req_with_status(const KubeLayout& Y, u32 w, u32 st) {
  return (w & ~(3u << Y.r_status)) | (st << Y.r_status);
}
HD u32 k_lm_status(const KubeLayout& Y, u32 w) { return (w >> Y.lm_status) & 3u; }
HD u32 k_lm_with(const KubeLayout& Y, u32 w, u32 st) {
  return (w & ~(3u << Y.lm_status)) | (st << Y.lm_status);
}

// descending sort in the reference's -sort(-x) int32 order (negation wraps)
HD int32_t k_neg(int32_t x) { return (int32_t)(0u - (u32)x); }
HD void k_sort_desc(int32_t* a, int n) {
  for (int i = 1; i < n; i++) {
    int32_t v = a[i];
    int j = i - 1;
    while (j >= 0 && k_neg(a[j]) > k_neg(v)) {
      a[j + 1] = a[j];
      j--;
    }
    a[j + 1] = v;
  }
}

// -- codec --------------------------------------------------------------------

HD void kube_unpack(const KubeLayout& Y, const u32* w, int32_t* f) {
  int wi = 0, bitpos = 0;
  for (int j = 0; j < Y.F; j++) {
    int width = Y.width[j];
    u32 val = 0;
    int got = 0;
    while (got < width) {
      int take = width - got < 32 - bitpos ? width - got : 32 - bitpos;
      u32 mask = take == 32 ? 0xFFFFFFFFu : ((1u << take) - 1u);
      val |= ((w[wi] >> bitpos) & mask) << got;
      got += take;
      bitpos += take;
      if (bitpos == 32) {
        wi++;
        bitpos = 0;
      }
    }
    f[j] = (int32_t)val;
  }
}

HD void kube_pack(const KubeLayout& Y, const int32_t* s, u32* out) {
  u32 cur = 0;
  int cur_bits = 0, wi = 0;
  for (int j = 0; j < Y.F; j++) {
    u32 v = (u32)s[j];
    int rbits = Y.width[j];
    while (rbits > 0) {
      int take = rbits < 32 - cur_bits ? rbits : 32 - cur_bits;
      u32 mask = take == 32 ? 0xFFFFFFFFu : ((1u << take) - 1u);
      cur |= (v & mask) << cur_bits;
      v = take == 32 ? 0u : v >> take;
      rbits -= take;
      cur_bits += take;
      if (cur_bits == 32) {
        out[wi++] = cur;
        cur = 0;
        cur_bits = 0;
      }
    }
  }
  if (cur_bits > 0) out[wi] = cur;
}

HD void kube_canon(const KubeLayout& Y, int32_t* s) {
  k_sort_desc(s + Y.off_api, Y.ni);
  if (Y.ls > 1)
    for (int c = 0; c < Y.nc; c++) k_sort_desc(s + Y.off_lo + c * Y.ls, Y.ls);
}

// -- invariants (bit 0 TypeOK, bit 1 OnlyOneVersion; set = holds) ---------

HD bool k_obj_ok(const KubeLayout& Y, u32 w) {
  return k_present(Y, w) == 1u ? k_ident(Y, w) < (u32)Y.ni : w == 0u;
}

HD int kube_invariants(const KubeLayout& Y, const int32_t* s) {
  bool ok = true;
  for (int j = 0; j < Y.ni; j++) ok = ok && k_obj_ok(Y, (u32)s[Y.off_api + j]);
  for (int c = 0; c < Y.nc; c++) {
    u32 rw = (u32)s[Y.off_req + c];
    if ((rw >> Y.r_present) & 1u) {
      u32 op = (rw >> Y.r_op) & 7u, st = (rw >> Y.r_status) & 3u;
      u32 ro = k_req_obj(Y, rw);
      ok = ok && op <= 4u && st <= 2u && k_present(Y, ro) == 1u &&
           k_obj_ok(Y, ro);
    }
  }
  for (int c = 0; c < Y.nc; c++) {
    u32 lw = (u32)s[Y.off_lm + c];
    const int32_t* lo = s + Y.off_lo + c * Y.ls;
    if ((lw >> Y.lm_present) & 1u) {
      u32 kind = (lw >> Y.lm_kind) & ((1u << Y.kb) - 1u);
      bool objs = true;
      for (int j = 0; j < Y.ls; j++) {
        u32 w = (u32)lo[j];
        if (k_present(Y, w))
          objs = objs && k_obj_ok(Y, w) && k_kind_of(Y, w) == (int32_t)kind;
      }
      ok = ok && kind < (u32)Y.n_kinds && k_lm_status(Y, lw) <= 2u && objs;
    } else {
      for (int j = 0; j < Y.ls; j++) ok = ok && lo[j] == 0;
    }
  }
  bool only_one = true;
  for (int a = 0; a < Y.ni; a++)
    for (int b = a + 1; b < Y.ni; b++) {
      u32 wa = (u32)s[Y.off_api + a], wb = (u32)s[Y.off_api + b];
      if (k_present(Y, wa) && k_present(Y, wb) &&
          k_ident(Y, wa) == k_ident(Y, wb))
        only_one = false;
    }
  return (ok ? 1 : 0) | (only_one ? 2 : 0);
}

// -- client handlers ----------------------------------------------------------

HD void k_call_api(const KubeLayout& Y, int32_t* s, int i, int ret, int verb,
                   u32 obj_w) {
  s[Y.off_stack + i] = (int32_t)((1u << Y.s_present) | ((u32)ret << Y.s_retpc));
  s[Y.off_pop + i] = 1 + verb;
  s[Y.off_pobj + i] = (int32_t)obj_w;
  s[Y.off_pc + i] = LBL_DoRequest;
}

HD void k_call_listapi(const KubeLayout& Y, int32_t* s, int i, int ret,
                       int kind) {
  s[Y.off_stack + i] = (int32_t)((1u << Y.s_present) | (1u << Y.s_proc) |
                                 ((u32)ret << Y.s_retpc));
  s[Y.off_pkind + i] = 1 + kind;
  s[Y.off_pc + i] = LBL_DoListRequest;
}

HD bool k_api_found(const KubeLayout& Y, const int32_t* f, u32 obj_w) {
  bool found = false;
  for (int j = 0; j < Y.ni; j++) {
    u32 w = (u32)f[Y.off_api + j];
    found = found || (k_present(Y, w) && k_ident(Y, w) == k_ident(Y, obj_w));
  }
  return found;
}

// lane 0 of a two-way branch on `cond`
HD bool k_branch(const KubeLayout& Y, int32_t* s, int i, int k, bool cond,
                 int then_lbl, int else_lbl, bool& valid) {
  if (k != 0) return false;
  s[Y.off_pc + i] = cond ? then_lbl : else_lbl;
  valid = true;
  return true;
}

// Client i's lane k.  Returns whether the handler of i's pc label emits
// lane k (false leaves s untouched: the zero lane).
HD bool kube_client_lane(const KubeLayout& Y, const int32_t* f, int i, int k,
                         int32_t* s, bool& valid, bool& afail) {
  const int lbl = f[Y.off_pc + i];
  const int ls = Y.ls;
  const int32_t* lo = f + Y.off_lo + i * ls;
  const u32 rw = (u32)f[Y.off_req + i];
  const u32 lw = (u32)f[Y.off_lm + i];
  const int n_req_lanes = 1 + Y.fail + Y.timeout;
  valid = false;
  afail = false;
  switch (lbl) {  // the procedures, both roles
    case LBL_DoRequest: {
      if (k >= n_req_lanes) return false;
      u32 op_id = (u32)(f[Y.off_pop + i] - 1);
      u32 st = k == 0 ? ST_PENDING : ST_ERROR;
      s[Y.off_req + i] = (int32_t)((1u << Y.r_present) | (op_id << Y.r_op) |
                                   (st << Y.r_status) |
                                   ((u32)f[Y.off_pobj + i] << Y.r_obj));
      s[Y.off_pc + i] = LBL_DoReply;
      valid = true;
      return true;
    }
    case LBL_DoReply: {
      if (k > (Y.timeout ? 1 : 0)) return false;
      valid = k_req_status(Y, rw) != ST_PENDING;
      u32 frame = (u32)f[Y.off_stack + i];
      s[Y.off_pc + i] = (int32_t)((frame >> Y.s_retpc) & ((1u << Y.lb) - 1u));
      s[Y.off_stack + i] = 0;
      s[Y.off_pop + i] = 0;
      s[Y.off_pobj + i] = 0;
      if (k == 1) s[Y.off_req + i] = (int32_t)k_req_with_status(Y, rw, ST_ERROR);
      return true;
    }
    case LBL_DoListRequest: {
      if (k >= n_req_lanes) return false;
      u32 kind_id = (u32)(f[Y.off_pkind + i] - 1);
      u32 st = k == 0 ? ST_PENDING : ST_ERROR;
      s[Y.off_lm + i] = (int32_t)((1u << Y.lm_present) | (kind_id << Y.lm_kind) |
                                  (st << Y.lm_status));
      for (int j = 0; j < ls; j++) s[Y.off_lo + i * ls + j] = 0;
      s[Y.off_pc + i] = LBL_DoListReply;
      valid = true;
      return true;
    }
    case LBL_DoListReply: {
      if (k > (Y.timeout ? 1 : 0)) return false;
      valid = k_lm_status(Y, lw) != ST_PENDING;
      u32 frame = (u32)f[Y.off_stack + i];
      s[Y.off_pc + i] = (int32_t)((frame >> Y.s_retpc) & ((1u << Y.lb) - 1u));
      s[Y.off_stack + i] = 0;
      s[Y.off_pkind + i] = 0;
      if (k == 1) {
        s[Y.off_lm + i] = (int32_t)k_lm_with(Y, lw, ST_ERROR);
        for (int j = 0; j < ls; j++) s[Y.off_lo + i * ls + j] = 0;
      }
      return true;
    }
    default:
      break;
  }
  if (Y.role[i] == 0) {  // reconciler: the Client label machine
    const int ri = Y.sr_idx[i];
    switch (lbl) {
      case LBL_C1:
        return k_branch(Y, s, i, k, k_req_status(Y, rw) == ST_OK, LBL_C10,
                        LBL_CStart, valid);
      case LBL_C11:
        return k_branch(Y, s, i, k, k_req_status(Y, rw) == ST_OK, LBL_c12,
                        LBL_CStart, valid);
      case LBL_C13:
        return k_branch(Y, s, i, k,
                        k_req_status(Y, rw) == ST_OK &&
                            !k_unbound_pvc(Y, k_req_obj(Y, rw)),
                        LBL_C2, LBL_CStart, valid);
      case LBL_C3:
        return k_branch(Y, s, i, k, k_lm_status(Y, lw) == ST_OK, LBL_C8,
                        LBL_CStart, valid);
      case LBL_C8: {
        bool empty = true;
        for (int j = 0; j < ls; j++) empty = empty && !k_present(Y, (u32)lo[j]);
        return k_branch(Y, s, i, k, empty, LBL_C4, LBL_C6, valid);
      }
      case LBL_C6: {  // Delete a bare [k, n] record per listed object
        if (k >= ls) return false;
        u32 w = (u32)lo[k];
        u32 bare = (1u << Y.o_present) | (k_ident(Y, w) << Y.o_ident);
        k_call_api(Y, s, i, LBL_C7, VERB_Delete, bare);
        valid = k_present(Y, w) == 1u;
        return true;
      }
      case LBL_C7: {
        int npres = 0;
        for (int j = 0; j < ls; j++) npres += (int)k_present(Y, (u32)lo[j]);
        return k_branch(Y, s, i, k, k_req_status(Y, rw) == ST_OK && npres <= 1,
                        LBL_C4, LBL_CStart, valid);
      }
      case LBL_C5:
        return k_branch(Y, s, i, k, true, LBL_CStart, LBL_CStart, valid);
      case LBL_CStart: {
        // lane 0: sr' := TRUE and reconcile; lane 1: the skip branch,
        // dispatched on the OLD sr value (KubeAPI.tla:528-549)
        if (k >= 2) return false;
        if (k == 0 || f[Y.off_sr + ri] == 1) {
          s[Y.off_sr + ri] = 1;
          k_call_api(Y, s, i, LBL_C1, VERB_Force, (u32)Y.secret_w[i]);
        } else {
          s[Y.off_sr + ri] = 0;
          k_call_listapi(Y, s, i, LBL_C3, Y.secret_kind[i]);
        }
        valid = true;
        return true;
      }
      case LBL_C10:
        if (k != 0) return false;
        k_call_api(Y, s, i, LBL_C11, VERB_Force, (u32)Y.pvc_w[i]);
        valid = true;
        return true;
      case LBL_c12:
        if (k != 0) return false;
        k_call_api(Y, s, i, LBL_C13, VERB_Get, (u32)Y.pvc_w[i]);
        valid = true;
        return true;
      case LBL_C2: {  // assert ObjectExists(own secret) (KubeAPI.tla:196)
        if (k != 0) return false;
        bool found = k_api_found(Y, f, (u32)Y.secret_w[i]);
        if (Y.mutation != MUT_STICKY_RECONCILE) s[Y.off_sr + ri] = 0;
        s[Y.off_pc + i] = LBL_C5;
        valid = true;
        afail = !found;
        return true;
      }
      case LBL_C4: {  // assert ~ObjectExists(own secret) (KubeAPI.tla:216)
        if (k != 0) return false;
        bool found = k_api_found(Y, f, (u32)Y.secret_w[i]);
        s[Y.off_pc + i] = LBL_C5;
        valid = true;
        afail = found;
        return true;
      }
      default:
        return false;
    }
  }
  switch (lbl) {  // binder: the PVCController label machine
    case LBL_PVCStart:
      if (k != 0) return false;
      k_call_listapi(Y, s, i, LBL_PVCListedPVCs, Y.pvc_kind);
      valid = true;
      return true;
    case LBL_PVCListedPVCs: {
      bool any = false;
      for (int j = 0; j < ls; j++) any = any || k_unbound_pvc(Y, (u32)lo[j]);
      return k_branch(Y, s, i, k, k_lm_status(Y, lw) == ST_OK && any,
                      LBL_PVCHavePVCs, LBL_PVCStart, valid);
    }
    case LBL_PVCHavePVCs: {  // bind one unbound listed PVC: set has_spec
      if (k >= ls) return false;
      u32 unb = (u32)lo[k];
      k_call_api(Y, s, i, LBL_PVCDone, VERB_Update, unb | (1u << Y.o_spec));
      valid = k_unbound_pvc(Y, unb);
      return true;
    }
    case LBL_PVCDone:
      return k_branch(Y, s, i, k, true, LBL_PVCStart, LBL_PVCStart, valid);
    default:
      return false;
  }
}

// -- APIServer lanes (KubeAPI.tla:698-756) -----------------------------------

HD void kube_server_req(const KubeLayout& Y, const int32_t* f, int c,
                        int32_t* s, bool& valid, bool& afail, bool& ovf) {
  const u32 rw = (u32)f[Y.off_req + c];
  valid = ((rw >> Y.r_present) & 1u) && k_req_status(Y, rw) == ST_PENDING;
  const u32 op = (rw >> Y.r_op) & 7u;
  const u32 robj = k_req_obj(Y, rw);
  const u32 written = k_write_w(Y, robj);
  bool found = false, hasread = false;
  int free_idx = -1;
  int32_t chosen = KUBE_INT32_MIN;
  for (int j = 0; j < Y.ni; j++) {
    u32 w = (u32)f[Y.off_api + j];
    bool m = k_present(Y, w) && k_ident(Y, w) == k_ident(Y, robj);
    found = found || m;
    hasread = hasread || (m && ((w >> (Y.o_vv + c)) & 1u));
    if (!k_present(Y, w) && free_idx < 0) free_idx = j;
    int32_t cand = m ? (int32_t)w : 0;
    chosen = cand > chosen ? cand : chosen;
  }
  const bool can_insert = free_idx >= 0;
  for (int j = 0; j < Y.ni; j++) {
    u32 w = (u32)f[Y.off_api + j];
    bool m = k_present(Y, w) && k_ident(Y, w) == k_ident(Y, robj);
    bool ins = !found && can_insert && j == free_idx;
    u32 nw;
    switch (op) {
      case VERB_Create: nw = ins ? written : w; break;
      case VERB_Force: nw = (found ? m : ins) ? written : w; break;
      case VERB_Get: nw = m ? k_read_w(Y, w, c) : w; break;
      case VERB_Delete:
        nw = (Y.mutation != MUT_DELETE_NOOP && m) ? 0u : w;
        break;
      default: nw = (hasread && m) ? written : w; break;  // Update
    }
    s[Y.off_api + j] = (int32_t)nw;
  }
  u32 st;
  switch (op) {
    case VERB_Create: st = found ? ST_ERROR : ST_OK; break;
    case VERB_Force: st = ST_OK; break;
    case VERB_Get: st = found ? ST_OK : ST_ERROR; break;
    case VERB_Delete: st = ST_OK; break;
    default: st = hasread ? ST_OK : ST_ERROR; break;
  }
  u32 nrw = k_req_with_status(Y, rw, st);
  if (op == VERB_Get && found) {
    u32 om = k_obj_mask(Y) << Y.r_obj;
    nrw = (nrw & ~om) | ((u32)chosen << Y.r_obj);
  }
  s[Y.off_req + c] = (int32_t)nrw;
  afail = valid && op > 4u;
  ovf = valid && (op == VERB_Create || op == VERB_Force) && !found &&
        !can_insert;
}

HD void kube_server_list(const KubeLayout& Y, const int32_t* f, int c,
                         int32_t* s, bool& valid, bool& ovf) {
  const u32 lw = (u32)f[Y.off_lm + c];
  valid = ((lw >> Y.lm_present) & 1u) && k_lm_status(Y, lw) == ST_PENDING;
  const int32_t kind = (int32_t)((lw >> Y.lm_kind) & ((1u << Y.kb) - 1u));
  int32_t matched[KUBE_MAXI];
  int cnt = 0;
  for (int j = 0; j < Y.ni; j++) {
    u32 w = (u32)f[Y.off_api + j];
    bool m = k_present(Y, w) && k_kind_of(Y, w) == kind;
    matched[j] = m ? (int32_t)w : 0;
    cnt += m ? 1 : 0;
    s[Y.off_api + j] = (int32_t)(m ? k_read_w(Y, w, c) : w);
  }
  k_sort_desc(matched, Y.ni);
  for (int j = 0; j < Y.ls; j++) s[Y.off_lo + c * Y.ls + j] = matched[j];
  s[Y.off_lm + c] = (int32_t)k_lm_with(Y, lw, ST_OK);
  ovf = valid && cnt > Y.ls;
}

// -- one (state, lane) ------------------------------------------------------

// The canonical successor of lane `lane` of the state whose F raw fields
// are `f` (popped: the row is inside the pop mask), as F raw int32 fields
// in `s` - the reference's pre-pack `flat` row.  bad_typeok/bad_onlyone
// are left false.
HD LaneOut kube_succ_fields(const KubeLayout& Y, const int32_t* f,
                            bool popped, int lane, int32_t* s) {
  for (int j = 0; j < Y.F; j++) s[j] = f[j];
  LaneOut o;
  o.valid = o.afail = o.ovf = o.bad_typeok = o.bad_onlyone = false;
  o.action = 0;
  const int ncl = Y.nc * Y.CL;
  if (lane < ncl) {
    int i = lane / Y.CL;
    if (kube_client_lane(Y, f, i, lane % Y.CL, s, o.valid, o.afail)) {
      o.action = f[Y.off_pc + i];
    } else {
      o.valid = o.afail = false;
    }
  } else if (lane < ncl + Y.nc) {
    kube_server_req(Y, f, lane - ncl, s, o.valid, o.afail, o.ovf);
    o.action = LBL_APIStart;
  } else {
    kube_server_list(Y, f, lane - ncl - Y.nc, s, o.valid, o.ovf);
    o.action = LBL_APIStart;
  }
  kube_canon(Y, s);
  o.valid = o.valid && popped;
  o.afail = o.afail && o.valid;
  o.ovf = o.ovf && o.valid;
  return o;
}

// The same for lane `lane` of the packed row `row`.
HD LaneOut kube_succ_lane(const KubeLayout& Y, const u32* row, bool popped,
                          int lane, int32_t* s) {
  int32_t f[KUBE_MAXF];
  kube_unpack(Y, row, f);
  return kube_succ_fields(Y, f, popped, lane, s);
}

// Expand lane `lane` of the packed row `row`; writes the packed canonical
// successor to `out` (W words).  kDeferred skips the invariants (the
// reference's deferred=True expand stage, jaxtlc/engine/backend.py:228):
// the commit's deferred checker (deferred.cu) evaluates them on the fresh
// claimants instead.
template <bool kDeferred>
HD LaneOut kube_expand_lane(const KubeLayout& Y, const u32* row, bool popped,
                            int lane, u32* out) {
  int32_t s[KUBE_MAXF];
  LaneOut o = kube_succ_lane(Y, row, popped, lane, s);
  if (!kDeferred) {
    int bits = kube_invariants(Y, s);
    o.bad_typeok = o.valid && !(bits & 1);
    o.bad_onlyone = o.valid && !(bits & 2);
  }
  kube_pack(Y, s, out);
  return o;
}

// Expand lane `lane` of the state whose F raw fields are `f` (the sharded
// engine's queue holds unpacked rows): the packed canonical successor to
// `out` (W words) and its F raw fields to `fields_out`, the reference's
// pre-pack `flat` row that the route payload carries.
template <bool kDeferred>
HD LaneOut kube_expand_fields(const KubeLayout& Y, const int32_t* f,
                              bool popped, int lane, u32* out,
                              int32_t* fields_out) {
  int32_t s[KUBE_MAXF];
  LaneOut o = kube_succ_fields(Y, f, popped, lane, s);
  if (!kDeferred) {
    int bits = kube_invariants(Y, s);
    o.bad_typeok = o.valid && !(bits & 1);
    o.bad_onlyone = o.valid && !(bits & 2);
  }
  kube_pack(Y, s, out);
  for (int j = 0; j < Y.F; j++) fields_out[j] = s[j];
  return o;
}
