// Per-row logic of the device coverage plane (kernel K10, coverage.cu) as
// __host__ __device__ functions.
//
// Replaces jaxtlc/spec/coverage_device.py:kubeapi_coverage_plane.count
// (:766-803) and the site formulas it folds (:138-754).  For ONE popped
// row, cov_row decodes the packed words (kube_unpack, as K1 does),
// computes the shared per-state facts the reference memoizes (_memo:
// label occupancy, request and list statuses, apiState matches through
// the identity tables, version-vector bits, listed-object counts) once,
// and hands every site's contribution of this row, in site-table order,
// to an emitter:
//   sites 0-21    the per-action generated prefix: valid lanes of client
//                 ci's range counted under ci's pc label, plus APIStart's
//                 server lanes (the valid flags as given: the caller's
//                 flags already carry the pop mask);
//   sites 22-30   the Init sites: no emission (their per-block count is 0);
//   sites 31-310  the 280 span sites, each an int32 contribution of the
//                 row, zero when the row is past the pop count n.
// The order of the emissions below IS the site order of
// torchtlc/spec/coverage_device.py (the reference's registration order);
// a shifted site shows as a shifted vector in the tests, which compare
// whole vectors against jaxtlc.
//
// The reference sums the [S, ck] int32 contribution matrix against the
// pop mask and casts the sums to uint32; every contribution is a small
// nonnegative int, so uint32 sums in any order are the same numbers.
#pragma once
#include "kubeapi.cuh"

#define COV_N_ACTIONS KUBE_N_LABELS  // 22
#define COV_N_INIT 9
#define COV_N_SPAN 280
#define COV_N_SITES (COV_N_ACTIONS + COV_N_INIT + COV_N_SPAN)  // 311

// The configuration's geometry and identity tables; field order ==
// torchtlc/spec/coverage_device.py:kernel_params.  Identity i is
// (kind_i, name_i) of ModelConfig.identities:
//   neq[a][b]  name_a == name_b;  keq[a][b]  kind_a == kind_b;
//   lt[a][b]   (name_a, kind_a) < (name_b, kind_b) (the host walker's
//              apiState scan order);  is_pvc[a]  kind_a == "PVC";
//   kind_id[a] the codec's kind id of kind_a.
struct CovParams {
  KubeLayout Y;
  int32_t neq[KUBE_MAXI][KUBE_MAXI];
  int32_t keq[KUBE_MAXI][KUBE_MAXI];
  int32_t lt[KUBE_MAXI][KUBE_MAXI];
  int32_t is_pvc[KUBE_MAXI];
  int32_t kind_id[KUBE_MAXI];
};

// an out-of-range identity index clamps, as the reference's gathers do
HD int cov_clamp(const KubeLayout& Y, u32 i) {
  return i < (u32)Y.ni ? (int)i : Y.ni - 1;
}

// Emit every site contribution of one row.  words: the row's W packed
// words (null: the thread has no row, every contribution is 0); masked:
// the row is inside the pop count; valid: the row's L lane flags (null
// when words is null).  emit(v) takes the next site's contribution,
// emit.skip(k) passes k sites.
template <class Emit>
HD void cov_row(const CovParams& P, const u32* words, bool masked,
                const uint8_t* valid, Emit& emit) {
  const KubeLayout& Y = P.Y;
  const int nc = Y.nc, ni = Y.ni, ls = Y.ls;
  int32_t f[KUBE_MAXF];
  if (words != nullptr)
    kube_unpack(Y, words, f);
  else
    for (int j = 0; j < Y.F; j++) f[j] = 0;

  // ---- the per-action generated prefix (gen_counts' fold) --------------
  int vc[KUBE_MAXC], vs = 0;
  for (int ci = 0; ci < nc; ci++) {
    vc[ci] = 0;
    if (valid != nullptr)
      for (int j = 0; j < Y.CL; j++) vc[ci] += valid[ci * Y.CL + j] ? 1 : 0;
  }
  if (valid != nullptr)
    for (int j = nc * Y.CL; j < Y.L; j++) vs += valid[j] ? 1 : 0;
  for (int l = 0; l < COV_N_ACTIONS; l++) {
    int v = l == LBL_APIStart ? vs : 0;
    for (int ci = 0; ci < nc; ci++) v += f[Y.off_pc + ci] == l ? vc[ci] : 0;
    emit(v);
  }
  emit.skip(COV_N_INIT);

  // ---- the per-state leaves (the reference's _memo entries) -------------
  const u32 imask = (1u << Y.ib) - 1u;
  int api_n = 0;
  for (int s = 0; s < ni; s++) api_n += (f[Y.off_api + s] >> Y.o_present) & 1;
  int pc[KUBE_MAXC + 1];
  for (int i = 0; i <= nc; i++) pc[i] = f[Y.off_pc + i];
  int rp[KUBE_MAXC], rs[KUBE_MAXC], rop[KUBE_MAXC], roi[KUBE_MAXC],
      rspec[KUBE_MAXC], lmp[KUBE_MAXC], lms[KUBE_MAXC], lmk[KUBE_MAXC],
      nobjs[KUBE_MAXC], nunb[KUBE_MAXC];
  // per client: api slots matching the request object by (name, kind),
  // by name, and by (name, kind) with client i in the version vector;
  // api slots of the listed kind
  int m_nk[KUBE_MAXC], m_n[KUBE_MAXC], found[KUBE_MAXC], kmatch[KUBE_MAXC];
  for (int i = 0; i < nc; i++) {
    const u32 rw = (u32)f[Y.off_req + i], lw = (u32)f[Y.off_lm + i];
    rp[i] = (rw >> Y.r_present) & 1u;
    rs[i] = (rw >> Y.r_status) & 3u;
    rop[i] = (rw >> Y.r_op) & 7u;
    roi[i] = cov_clamp(Y, ((rw >> Y.r_obj) >> Y.o_ident) & imask);
    rspec[i] = ((rw >> Y.r_obj) >> Y.o_spec) & 1u;
    lmp[i] = (lw >> Y.lm_present) & 1u;
    lms[i] = (lw >> Y.lm_status) & 3u;
    lmk[i] = (lw >> Y.lm_kind) & ((1u << Y.kb) - 1u);
    nobjs[i] = nunb[i] = 0;
    for (int s = 0; s < ls; s++) {
      const u32 w = (u32)f[Y.off_lo + i * ls + s];
      const int pres = (w >> Y.o_present) & 1u;
      nobjs[i] += pres;
      nunb[i] += pres & !((w >> Y.o_spec) & 1u);
    }
    m_nk[i] = m_n[i] = found[i] = kmatch[i] = 0;
    for (int s = 0; s < ni; s++) {
      const u32 aw = (u32)f[Y.off_api + s];
      if (!((aw >> Y.o_present) & 1u)) continue;
      const int id = cov_clamp(Y, (aw >> Y.o_ident) & imask);
      const int nk = P.neq[id][roi[i]] & P.keq[id][roi[i]];
      m_nk[i] += nk;
      m_n[i] += P.neq[id][roi[i]];
      found[i] |= nk & (int)((aw >> (Y.o_vv + i)) & 1u);
      kmatch[i] += P.kind_id[id] == lmk[i] ? 1 : 0;
    }
  }
  auto occ = [&](int i, int lbl) { return pc[i] == lbl ? 1 : 0; };
  // sums over all clients, over reconcilers, over binders
  auto csum = [&](auto fn) {
    int a = 0;
    for (int i = 0; i < nc; i++) a += fn(i);
    return a;
  };
  auto rsum = [&](auto fn) {
    int a = 0;
    for (int i = 0; i < nc; i++)
      if (Y.role[i] == 0) a += fn(i);
    return a;
  };
  auto bsum = [&](auto fn) {
    int a = 0;
    for (int i = 0; i < nc; i++)
      if (Y.role[i] != 0) a += fn(i);
    return a;
  };
  auto E = [&](int v) { emit(masked ? v : 0); };
  const int np_procs = nc + 1, nr = Y.nr, n_bind = nc - Y.nr;
  const int fail_t = Y.fail + Y.timeout, timeout = Y.timeout;

  // ---- procedure labels (DR / DLR / DRp / DLRp) ---------------------------
  const int req_lbls[2] = {LBL_DoRequest, LBL_DoListRequest};
  for (int t = 0; t < 2; t++) {
    const int lbl = req_lbls[t];
    const int fire = csum([&](int i) { return occ(i, lbl); });
    E(np_procs + fire);             // .g
    E(np_procs);                    // .gs
    E(fire);                        // .b1
    E(fire);                        // .b2g
    E(fire * fail_t);               // .b2b
    E(fire * (1 + fail_t));         // .pc
    E(fire * (1 + fail_t));         // .un
  }
  const int reply_lbls[2] = {LBL_DoReply, LBL_DoListReply};
  for (int t = 0; t < 2; t++) {
    const int lbl = reply_lbls[t];
    const int* st = lbl == LBL_DoReply ? rs : lms;
    const int o = csum([&](int i) { return occ(i, lbl); });
    const int fire = csum([&](int i) { return occ(i, lbl) * (st[i] != 0); });
    E(np_procs + fire);  // .g
    E(np_procs);         // .gs
    E(o + fire);         // .aw
    E(o);                // .aws
    E(fire);             // .b1g
    E(fire);             // .b1b
    E(fire);             // .b2
    // DoReply: pc op obj st un; DoListReply: pc kind st un
    const int subs = lbl == LBL_DoReply ? 5 : 4;
    for (int k = 0; k < subs; k++) E(fire * (1 + timeout));
  }

  // ---- the reconciler Client machine --------------------------------------
  {
    const int o = rsum([&](int i) { return occ(i, LBL_CStart); });
    E(nr + o);  // CS.g
    E(nr);      // CS.gs
    E(o);       // CS.b1
    E(o);       // CS.b2g
    E(o);       // CS.b2b
    E(2 * o);   // CS.if
    E(2 * o);   // CS.un
    const int sr_on = rsum([&](int i) {
      return occ(i, LBL_CStart) * (1 + f[Y.off_sr + Y.sr_idx[i]]);
    });
    const int sr_off = rsum([&](int i) {
      return occ(i, LBL_CStart) * (1 - f[Y.off_sr + Y.sr_idx[i]]);
    });
    E(sr_on);   // CS.then
    E(sr_off);  // CS.else
    E(sr_off);  // CS.epc
    E(sr_off);  // CS.eun
  }
  const int if_lbls[3] = {LBL_C1, LBL_C11, LBL_C3};
  for (int t = 0; t < 3; t++) {
    const int lbl = if_lbls[t];
    const int* st = lbl == LBL_C3 ? lms : rs;
    const int o = rsum([&](int i) { return occ(i, lbl); });
    const int ok = rsum([&](int i) { return occ(i, lbl) * (st[i] == 1); });
    E(nr + o);  // .g
    E(nr);      // .gs
    E(o);       // .if
    E(o - ok);  // .then
    E(ok);      // .else
    E(o);       // .un
  }
  {  // straight-line labels: C10 (asg pc un), c12 (asg pc un), C2 (sr as
     // pc un), C5 (pc un)
    const int lbls[4] = {LBL_C10, LBL_c12, LBL_C2, LBL_C5};
    const int subs[4] = {3, 3, 4, 2};
    for (int t = 0; t < 4; t++) {
      const int o = rsum([&](int i) { return occ(i, lbls[t]); });
      E(nr + o);
      E(nr);
      for (int k = 0; k < subs[t]; k++) E(o);
    }
  }
  {  // C13: the Get reply through IsUnboundPVC
    auto ok1 = [&](int i) { return occ(i, LBL_C13) * (rs[i] == 1); };
    const int o = rsum([&](int i) { return occ(i, LBL_C13); });
    const int ok = rsum(ok1);
    E(nr + o);  // C13.g
    E(nr);      // C13.gs
    E(o);       // C13.if
    E(o);       // C13.o1
    E(ok);      // C13.o2
    E(ok);      // C13.ubarg
    E(ok);      // C13.ub.w
    E(ok);      // C13.ub.k
    const int ub_or = rsum([&](int i) { return ok1(i) * P.is_pvc[roi[i]]; });
    E(ub_or);   // C13.ub.or
    E(ub_or);   // C13.ub.o1
    E(rsum([&](int i) { return ok1(i) * (P.is_pvc[roi[i]] & rspec[i]); }));
    const int bad = rsum([&](int i) {
      const int unbound = P.is_pvc[roi[i]] & !rspec[i];
      return occ(i, LBL_C13) * (rs[i] == 1 ? unbound : 1);
    });
    E(bad);      // C13.then
    E(o - bad);  // C13.else
    E(o);        // C13.un
  }
  {  // C8: branch on an empty listed set
    const int o = rsum([&](int i) { return occ(i, LBL_C8); });
    const int empty =
        rsum([&](int i) { return occ(i, LBL_C8) * (nobjs[i] == 0); });
    E(nr + o);
    E(nr);
    E(o);          // .if
    E(empty);      // .then
    E(o - empty);  // .else
    E(o);          // .un
  }
  {  // C6: one `with` path per listed object
    const int ne = rsum([&](int i) { return occ(i, LBL_C6) * (nobjs[i] > 0); });
    const int paths = rsum([&](int i) { return occ(i, LBL_C6) * nobjs[i]; });
    E(nr + ne);  // C6.g
    E(nr);       // C6.gs
    E(paths);    // C6.with
    E(paths);    // C6.un
  }
  {  // C7: retry unless the delete succeeded and one object remains
    const int o = rsum([&](int i) { return occ(i, LBL_C7); });
    const int ok = rsum([&](int i) { return occ(i, LBL_C7) * (rs[i] == 1); });
    const int retry = rsum([&](int i) {
      return occ(i, LBL_C7) * (rs[i] == 1 ? (nobjs[i] > 1 ? 1 : 0) : 1);
    });
    E(nr + o);
    E(nr);
    E(o);          // .if
    E(o);          // .o1
    E(ok);         // .o2
    E(retry);      // .then
    E(o - retry);  // .else
    E(o);          // .un
  }
  {  // C4: the ObjectExists scan over the walker's sorted apiState
    const int o = rsum([&](int i) { return occ(i, LBL_C4); });
    E(nr + o);
    E(nr);
    for (int k = 0; k < 5; k++) E(o);  // .as .neg .oe .pc .un
    E(o);                              // .oed.w
    E(o);                              // .oed.dom
    const int oed = rsum([&](int i) {
      const int si = cov_clamp(Y, k_ident(Y, (u32)Y.secret_w[i]));
      int match = 0, less = 0;
      for (int s = 0; s < ni; s++) {
        const u32 aw = (u32)f[Y.off_api + s];
        if (!((aw >> Y.o_present) & 1u)) continue;
        const int id = cov_clamp(Y, (aw >> Y.o_ident) & imask);
        match += P.neq[id][si] & P.keq[id][si];
        less += P.lt[id][si];
      }
      return occ(i, LBL_C4) * (match > 0 ? less + 1 : api_n);
    });
    E(oed);  // C4.oed.body
    E(oed);  // C4.oed.arg
  }

  // ---- the binder PVCController machine ------------------------------------
  {
    const int lbls[2] = {LBL_PVCStart, LBL_PVCDone};
    const int subs[2] = {3, 2};  // PS: asg pc un; PD: pc un
    for (int t = 0; t < 2; t++) {
      const int o = bsum([&](int i) { return occ(i, lbls[t]); });
      E(n_bind + o);
      E(n_bind);
      for (int k = 0; k < subs[t]; k++) E(o);
    }
  }
  {  // PVCListedPVCs: retry on a failed list or when everything is bound
    const int o = bsum([&](int i) { return occ(i, LBL_PVCListedPVCs); });
    const int ok = bsum([&](int i) {
      return occ(i, LBL_PVCListedPVCs) * (lms[i] == 1);
    });
    E(n_bind + o);
    E(n_bind);
    E(o);                              // PL.if
    E(o);                              // PL.o1
    for (int k = 0; k < 4; k++) E(ok);  // PL.all .all2 .dom .var
    const int retry = bsum([&](int i) {
      return occ(i, LBL_PVCListedPVCs) * (lms[i] == 1 ? (nunb[i] == 0) : 1);
    });
    E(retry);      // PL.then
    E(o - retry);  // PL.else
    E(o);          // PL.un
  }
  {  // PVCHavePVCs: one \E path per unbound listed PVC
    const int ne = bsum([&](int i) {
      return occ(i, LBL_PVCHavePVCs) * (nunb[i] > 0);
    });
    const int paths =
        bsum([&](int i) { return occ(i, LBL_PVCHavePVCs) * nunb[i]; });
    E(n_bind + ne);  // PH.g
    E(n_bind);       // PH.gs
    E(paths);        // PH.ex
    E(paths);        // PH.un
  }

  // ---- the API server --------------------------------------------------
  auto pending = [&](int i) { return rp[i] & (rs[i] == 0); };
  auto lpending = [&](int i) { return lmp[i] & (lms[i] == 0); };
  auto op_is = [&](int i, int verb) { return pending(i) * (rop[i] == verb); };
  const int pend = csum(pending), lpend = csum(lpending);
  {
    const int paths = pend + lpend;
    E(1 + (paths > 0));                          // AS.g
    E(1);                                        // AS.gs
    for (int k = 0; k < 3; k++) E(1);            // AS.pcref .pcdef .pcdom
    E(csum([&](int i) { return rp[i]; }));       // AS.pcpred
    for (int k = 0; k < 3; k++) E(1);            // AS.plref .pldef .pldom
    E(csum([&](int i) { return lmp[i]; }));      // AS.plpred
    E(pend);                                     // AS.bind
    E(pend);                                     // AS.unl
    E(lpend);                                    // AS.unr
    E(paths);                                    // AS.pc
    E(paths);                                    // AS.un
  }
  // op dispatch: Force, Get, Delete, Update.  For verb v and a per-client
  // factor g: sum over clients of op_is(i, v) * g(i)
  auto vsum = [&](int verb, auto g) {
    return csum([&](int i) { return op_is(i, verb) * g(i); });
  };
  auto one = [&](int) { return 1; };
  auto exists = [&](int i) { return m_nk[i] > 0 ? 1 : 0; };
  const int force = vsum(VERB_Force, one);
  {
    E(pend);   // AS.fif
    E(force);  // AS.f.if
    const int ex = vsum(VERB_Force, exists);
    E(force - ex);                      // AS.f.add
    E(force);                           // AS.f.ok
    for (int k = 0; k < 3; k++) E(ex);  // AS.f.set .setc .dom
    const int elems =
        vsum(VERB_Force, [&](int i) { return exists(i) * api_n; });
    // .elif .cond .co .cr .civo.w .civo.1
    for (int k = 0; k < 6; k++) E(elems);
    E(vsum(VERB_Force, [&](int i) { return exists(i) * m_n[i]; }));  // .civo.2
    const int match =
        vsum(VERB_Force, [&](int i) { return exists(i) * m_nk[i]; });
    E(match);          // AS.f.wr
    E(elems - match);  // AS.f.o
  }
  const int get = vsum(VERB_Get, one);
  {
    E(pend - force);  // AS.gif
    E(get);           // AS.g.if
    const int ex = vsum(VERB_Get, exists);
    E(get - ex);                         // AS.g.err
    E(get - ex);                         // AS.g.unch
    for (int k = 0; k < 10; k++) E(ex);  // .req .req2 .api1 .cho .cho2 .chod
                                         // .st .set .setc .dom
    const int elems = vsum(VERB_Get, [&](int i) { return exists(i) * api_n; });
    for (int k = 0; k < 6; k++) E(elems);  // .chob .choo .chor .elif .cond .co
    E(elems + ex);                         // AS.g.cr
    const int nmatch =
        vsum(VERB_Get, [&](int i) { return exists(i) * m_n[i]; });
    E(elems);   // AS.g.chivo.w
    E(elems);   // AS.g.chivo.1
    E(nmatch);  // AS.g.chivo.2
    E(elems);   // AS.g.civo.w
    E(elems);   // AS.g.civo.1
    E(nmatch);  // AS.g.civo.2
    const int match =
        vsum(VERB_Get, [&](int i) { return exists(i) * m_nk[i]; });
    E(match);          // AS.g.rd
    E(elems - match);  // AS.g.o
  }
  const int del = vsum(VERB_Delete, one);
  {
    E(pend - force - get);                  // AS.dif
    for (int k = 0; k < 4; k++) E(del);     // AS.d.set .setc .dom .ok
    const int elems = vsum(VERB_Delete, [&](int) { return api_n; });
    for (int k = 0; k < 6; k++) E(elems);   // .neg .negi .co .cr .ivo.w .ivo.1
    E(vsum(VERB_Delete, [&](int i) { return m_n[i]; }));  // AS.d.ivo.2
  }
  {
    const int upd = vsum(VERB_Update, one);
    E(pend - force - get - del);  // AS.uif
    E(upd);                       // AS.u.if
    E(upd);                       // AS.u.dom
    const int fnd = vsum(VERB_Update, [&](int i) { return found[i]; });
    for (int k = 0; k < 6; k++) E(fnd);  // .set .set2 .filt .fdom .wr .ok
    E(upd - fnd);                        // AS.u.err
    E(upd - fnd);                        // AS.u.unch
    const int elems =
        vsum(VERB_Update, [&](int i) { return found[i] * api_n; });
    // .fneg .fnegi .fo .fr .fivo.w .fivo.1
    for (int k = 0; k < 6; k++) E(elems);
    E(vsum(VERB_Update, [&](int i) { return found[i] * m_n[i]; }));  // .fivo.2
  }
  {  // list serving: every span iterates the whole apiState
    for (int k = 0; k < 10; k++) E(lpend);  // AS.l.req ... AS.l.dom
    const int elems = csum([&](int i) { return lpending(i) * api_n; });
    E(elems);  // AS.l.pred
    E(elems);  // AS.l.elif
    E(elems);  // AS.l.cond
    const int rd = csum([&](int i) { return lpending(i) * kmatch[i]; });
    E(rd);          // AS.l.rd
    E(elems - rd);  // AS.l.o
  }

  // ---- invariants: one evaluation per expanded state ----------------------
  {
    for (int k = 0; k < 7; k++) E(1);  // TY.w .c1 .c1dom .c2 .c2dom .c3 .c3dom
    E(api_n);                          // TY.c1body
    E(csum([&](int i) { return rp[i]; }));  // TY.c2body
    const int lm_n = csum([&](int i) { return lmp[i]; });
    for (int k = 0; k < 7; k++) E(lm_n);  // TY.c3body .vlr .vlr1 .vlr2 .vlr2q
                                          // .vlr3 .vlrarg
    E(csum([&](int i) { return nobjs[i]; }));  // TY.vlr2b
    E(1);                                      // OV.w
    E(1);                                      // OV.dom
    E(api_n * api_n);                          // OV.body
    E(api_n * api_n);                          // OV.o1
    E(api_n * (api_n - 1));                    // OV.o2
  }
}
