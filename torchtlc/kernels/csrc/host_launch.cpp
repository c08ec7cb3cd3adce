// CPU build of the per-lane logic of K1, K3, K5-K13, for the host tests
// (tests/test_torch_kernels_host.py, tests/test_torch_sharded.py).  g++ compiles the same
// __host__ __device__ headers nvcc builds the kernels from; these loops
// stand in for the grids, the straggler walk runs the walk kernel's
// rounds (read, rank, claim-or-advance) sequentially, and std::stable_sort
// stands in for the ordering sort.  Not used by the engine.
#include <algorithm>
#include <vector>

#include "coverage.cuh"
#include "deferred.cuh"
#include "fpset.cuh"
#include "ring.cuh"
#include "route.cuh"
#include "slab.cuh"

extern "C" int tt_layout_words() { return sizeof(KubeLayout) / 4; }
extern "C" int tt_coverage_words() { return sizeof(CovParams) / 4; }

// K10: every row's site contributions, added into out[COV_N_SITES]
struct HostEmit {
  uint32_t* out;
  int k;
  void operator()(int v) { out[k++] += (uint32_t)v; }
  void skip(int n) { k += n; }
};

extern "C" void host_coverage_count(const void* params, const uint32_t* block,
                                    int ck, int n, const uint8_t* valid,
                                    uint32_t* out) {
  const CovParams& P = *(const CovParams*)params;
  for (int row = 0; row < ck; row++) {
    HostEmit e{out, 0};
    cov_row(P, block + (size_t)row * P.Y.W, row < n,
            valid + (size_t)row * P.Y.L, e);
  }
}

extern "C" void host_expand(const void* layout, const uint32_t* block, int ck,
                            int n, int deferred, uint32_t* packed,
                            uint8_t* flags,
                            int32_t* action, unsigned long long* gen) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  const long long ncand = (long long)ck * Y.L;
  for (long long idx = 0; idx < ncand; idx++) {
    const int row = (int)(idx / Y.L), lane = (int)(idx % Y.L);
    const u32* src = block + (size_t)row * Y.W;
    u32* dst = packed + (size_t)idx * Y.W;
    LaneOut o = deferred ? kube_expand_lane<true>(Y, src, row < n, lane, dst)
                         : kube_expand_lane<false>(Y, src, row < n, lane, dst);
    flags[idx] = o.valid;
    flags[ncand + idx] = o.afail;
    flags[2 * ncand + idx] = o.ovf;
    flags[3 * ncand + idx] = o.bad_typeok;
    flags[4 * ncand + idx] = o.bad_onlyone;
    action[idx] = o.action;
    if (o.valid) gen[o.action]++;
  }
}

extern "C" void host_fpset_key(const uint32_t* lo, const uint32_t* hi,
                               const uint8_t* mask, long long N, int64_t* key) {
  for (long long i = 0; i < N; i++) key[i] = fp_key(lo[i], hi[i], mask[i] != 0);
}

// The membership walk (K9) of every lane; returns the bucket rows read.
extern "C" long long host_fpset_member(const uint32_t* table, int lognb,
                                       const uint32_t* lo, const uint32_t* hi,
                                       const uint8_t* mask, long long N,
                                       long long max_rounds, uint8_t* found) {
  const uint32_t nb_mask = (uint32_t)((1ull << lognb) - 1ull);
  long long total = 0;
  for (long long i = 0; i < N; i++) {
    long long rows;
    found[i] = fp_member_lane(table, lognb, nb_mask, lo[i], hi[i],
                              mask[i] != 0, max_rounds, &rows);
    total += rows;
  }
  return total;
}

// One probe segment: round 0 against the pre-claim table, the first C
// fitting claims, then the straggler walk.  Active lanes: act (nullable,
// the slab layout) or the prefix off + i < nreps.  is_new: [R] bytes.
extern "C" void host_fpset_probe_segment(uint32_t* table, int lognb,
                                         const int64_t* keys, int R,
                                         long long nreps, long long off,
                                         const uint8_t* act, int C,
                                         uint8_t* is_new) {
  const uint32_t nb_mask = (1u << lognb) - 1u;
  std::vector<int32_t> slot(R);
  for (int i = 0; i < R; i++)
    slot[i] = fp_round0(table, lognb, keys, act, i,
                        act != nullptr ? act[i] != 0 : off + i < nreps);
  std::vector<int> pending;
  int nclaim = 0;
  for (int i = 0; i < R; i++) {
    bool claimed = slot[i] >= 0 && nclaim < C;
    nclaim += slot[i] >= 0 ? 1 : 0;
    if (claimed) {
      table[2 * (size_t)slot[i]] = fp_key_lo(keys[i]);
      table[2 * (size_t)slot[i] + 1] = fp_key_hi(keys[i]);
    }
    is_new[i] = claimed;
    if (slot[i] == -2 || (slot[i] >= 0 && !claimed)) pending.push_back(i);
  }
  const int S = R < 2048 ? R : 2048;
  for (size_t start = 0; start < pending.size(); start += S) {
    const size_t ns = std::min(pending.size() - start, (size_t)S);
    std::vector<uint32_t> lo(ns), hi(ns), b(ns);
    std::vector<int> st(ns, 1), occ(ns);
    for (size_t i = 0; i < ns; i++) {
      lo[i] = fp_key_lo(keys[pending[start + i]]);
      hi[i] = fp_key_hi(keys[pending[start + i]]);
      b[i] = fp_bucket(hi[i], lognb);
    }
    while (true) {
      std::vector<int> wl;
      for (size_t i = 0; i < ns; i++) {
        if (!(st[i] & 1)) continue;
        const uint32_t* row = table + (size_t)b[i] * 16;
        if (fp_row_has(row, lo[i], hi[i])) {
          st[i] = 0;
        } else {
          occ[i] = fp_row_occ(row);
          wl.push_back((int)i);
        }
      }
      if (wl.empty()) break;
      std::vector<uint32_t> nb = b;
      for (int i : wl) {
        int r = 0;
        for (int j : wl)
          r += (b[j] == b[i] && fp_less(lo[j], hi[j], lo[i], hi[i])) ? 1 : 0;
        const int s = occ[i] + r;
        if (s < FP_BUCKET) {
          table[(size_t)b[i] * 16 + 2 * s] = lo[i];
          table[(size_t)b[i] * 16 + 2 * s + 1] = hi[i];
          st[i] = 2;
        } else {
          nb[i] = (b[i] + 1u) & nb_mask;
        }
      }
      b = nb;
    }
    for (size_t i = 0; i < ns; i++) is_new[pending[start + i]] = st[i] >> 1;
  }
}

// The slab dedup of one batch (K5 then K6): keys [N] from host_fpset_key,
// `passes` slab passes over 2^bits cells, claimants compacted to R rows,
// ordered, marked.  Returns n_cand; c_idx [R] and active [R] are written
// also when n_cand > R (the batch then takes the sorted path, and every
// row is filled).
extern "C" long long host_slab_dedup(const int64_t* keys, long long N,
                                     int bits, int passes, int R,
                                     int64_t* c_idx, uint8_t* active) {
  const uint32_t mmask = (uint32_t)((1ull << bits) - 1ull);
  std::vector<uint32_t> slab((size_t)1 << bits);
  std::vector<uint8_t> unres(N), rep(N, 0);
  for (long long i = 0; i < N; i++) unres[i] = keys[i] != fp_make_key(0u, 0u);
  for (int p = 0; p < passes; p++) {
    std::fill(slab.begin(), slab.end(), 0u);
    for (long long i = 0; i < N; i++)
      if (unres[i]) {
        uint32_t& cell = slab[slab_cell(keys[i], p, mmask)];
        cell = std::max(cell, (uint32_t)(i + 1));
      }
    for (long long i = 0; i < N; i++)
      if (unres[i]) {
        bool r = rep[i] != 0;
        unres[i] = slab_still_unresolved(
            keys, slab[slab_cell(keys[i], p, mmask)], i, N, r);
        rep[i] = r;
      }
  }
  std::vector<int32_t> c_lane(R, 0);
  long long n_cand = 0;
  for (long long i = 0; i < N; i++)
    if (rep[i] || unres[i]) {
      if (n_cand < R) c_lane[n_cand] = (int32_t)i;
      n_cand++;
    }
  std::vector<int64_t> ord(R), s_key(R), perm(R);
  for (int i = 0; i < R; i++) {
    ord[i] = slab_order_key(keys, c_lane.data(), i, n_cand);
    perm[i] = i;
  }
  std::stable_sort(perm.begin(), perm.end(),
                   [&](int64_t a, int64_t b) { return ord[a] < ord[b]; });
  for (int i = 0; i < R; i++) s_key[i] = ord[perm[i]];
  for (int i = 0; i < R; i++)
    slab_mark_row(s_key.data(), perm.data(), c_lane.data(), i, R, n_cand,
                  N, c_idx, active);
  return n_cand;
}

// The deferred check over `rows` claimant rows: viol, state [F], action.
extern "C" void host_deferred_check(const void* layout, const uint32_t* block,
                                    long long rows, const uint8_t* fresh,
                                    const int64_t* c_idx,
                                    const int32_t* action, long long* viol,
                                    int32_t* state, long long* vaction) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  int bad[DEFERRED_N_CODES];
  for (int k = 0; k < DEFERRED_N_CODES; k++) bad[k] = -1;
  for (long long i = 0; i < rows; i++) {
    if (!fresh[i]) continue;
    int32_t s[KUBE_MAXF];
    const int bits = kube_claimant_bits(Y, block, c_idx[i], s);
    for (int k = 0; k < DEFERRED_N_CODES; k++)
      if (!(bits & (1 << k))) bad[k] = std::max(bad[k], (int)c_idx[i]);
  }
  kube_deferred_pick(Y, block, action, bad, viol, state, vaction);
}

// One ring row (K8): the same reads, row and updates, sequentially;
// spill_new / spill_old null outside spill mode, as in tt_ring_row.
extern "C" void host_ring_row(uint32_t* ring, int slots, int cols,
                              long long* head, long long* bodies,
                              long long* expanded, long long n_pop, int flip,
                              long long level, long long gen_new,
                              long long gen_old, long long dist_new,
                              long long dist_old, long long queue_n,
                              const long long* act_gen,
                              const long long* act_dist,
                              const long long* acts_old,
                              const long long* spill_new,
                              const long long* spill_old, int n_acts,
                              int n_labels, const long long* cov_new,
                              const long long* cov_old, int n_cov) {
  uint32_t m = 0u;
  for (int r = 0; r <= slots; r++)
    m = std::max(m, ring[(size_t)r * cols + RING_COL_OVERFLOW]);
  bool wrap = ring_wrapped(gen_new, gen_old) ||
              ring_wrapped(dist_new, dist_old) ||
              ring_wrapped(*bodies + 1, *bodies) ||
              ring_wrapped(*expanded + n_pop, *expanded) ||
              (spill_new != nullptr && ring_wrapped(*spill_new, *spill_old));
  wrap = wrap || ring_any_wrapped(act_gen, acts_old, n_acts, 0, 1) ||
         ring_any_wrapped(act_dist, acts_old + n_acts, n_acts, 0, 1) ||
         ring_any_wrapped(cov_new, cov_old, n_cov, 0, 1);
  RingScalars v;
  v.level = level;
  v.generated = gen_new;
  v.distinct = dist_new;
  v.queue = queue_n;
  v.bodies = *bodies + 1;
  v.expanded = *expanded + n_pop;
  v.overflow = std::max(m, wrap ? 1u : 0u);
  v.spill = spill_new != nullptr ? *spill_new : 0;
  const long long row = flip ? *head % slots : slots;
  for (int c = 0; c < cols; c++)
    ring[(size_t)row * cols + c] = ring_cell(v, act_gen, act_dist, n_labels, c);
  *head += flip ? 1 : 0;
  *bodies = v.bodies;
  *expanded = v.expanded;
}

// K1's sharded variant: every lane of the D shards' pops, reading the
// unpacked circular queue rows (expand.cu expand_sharded_kernel); block
// may be null.
extern "C" void host_expand_sharded(const void* layout, const int32_t* queue,
                                    long long qrows, int qcap,
                                    const long long* qhead,
                                    const long long* npop, int D, int ck,
                                    int deferred, uint32_t* packed,
                                    uint8_t* flags, int32_t* action,
                                    int32_t* fields, uint32_t* block,
                                    unsigned long long* gen) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  const long long per = (long long)ck * Y.L, ncand = per * D;
  for (long long idx = 0; idx < ncand; idx++) {
    const int d = (int)(idx / per);
    const int row = (int)((idx % per) / Y.L), lane = (int)(idx % Y.L);
    const int32_t* src =
        queue + ((size_t)d * qrows + (size_t)((qhead[d] + row) % qcap)) * Y.F;
    u32* dst = packed + (size_t)idx * Y.W;
    int32_t* fo = fields + (size_t)idx * Y.F;
    LaneOut o =
        deferred ? kube_expand_fields<true>(Y, src, row < npop[d], lane, dst, fo)
                 : kube_expand_fields<false>(Y, src, row < npop[d], lane, dst,
                                             fo);
    flags[idx] = o.valid;
    flags[ncand + idx] = o.afail;
    flags[2 * ncand + idx] = o.ovf;
    flags[3 * ncand + idx] = o.bad_typeok;
    flags[4 * ncand + idx] = o.bad_onlyone;
    action[idx] = o.action;
    if (block != nullptr && lane == 0)
      kube_pack(Y, src, block + ((size_t)d * ck + row) * Y.W);
    if (o.valid) gen[(size_t)d * KUBE_N_LABELS + o.action]++;
  }
}

// K7's owner-side variant over received rows [N, F].
extern "C" void host_deferred_check_rows(const void* layout,
                                         const int32_t* rows_in,
                                         long long rows, const uint8_t* fresh,
                                         const int64_t* c_idx, long long* viol,
                                         int32_t* state) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  int bad[DEFERRED_N_CODES];
  for (int k = 0; k < DEFERRED_N_CODES; k++) bad[k] = -1;
  for (long long i = 0; i < rows; i++) {
    if (!fresh[i]) continue;
    int32_t s[KUBE_MAXF];
    const int bits = kube_row_bits(Y, rows_in, c_idx[i], s);
    for (int k = 0; k < DEFERRED_N_CODES; k++)
      if (!(bits & (1 << k))) bad[k] = std::max(bad[k], (int)c_idx[i]);
  }
  kube_deferred_pick_rows(Y, rows_in, bad, viol, state);
}

// K11: the stable counting sort of each source shard's lanes by owner key
// and the payload scatter, sequentially (xvalid zeroed by the caller).
extern "C" void host_route_scatter(const uint32_t* hi, const uint32_t* lo,
                                   const uint8_t* valid, const int32_t* fields,
                                   long long ncand, int D, int B, int F,
                                   int32_t* order, int32_t* s_own,
                                   int32_t* s_pos, uint8_t* s_valid,
                                   int32_t* xrows, uint32_t* xlo,
                                   uint32_t* xhi, uint8_t* xvalid,
                                   uint8_t* route_ovf) {
  for (int s = 0; s < D; s++) {
    std::vector<long long> total(D + 1, 0), start(D + 1, 0), seen(D + 1, 0);
    const size_t b = (size_t)s * ncand;
    for (long long i = 0; i < ncand; i++)
      total[route_key(hi[b + i], valid[b + i] != 0, D)]++;
    for (int k = 1; k <= D; k++) start[k] = start[k - 1] + total[k - 1];
    for (long long i = 0; i < ncand; i++) {
      const int key = route_key(hi[b + i], valid[b + i] != 0, D);
      const long long pos = seen[key]++;
      const size_t out = b + (size_t)(start[key] + pos);
      order[out] = (int32_t)i;
      s_own[out] = key;
      s_pos[out] = (int32_t)pos;
      s_valid[out] = key < D;
      if (key == D) continue;
      if (pos < B) {
        const size_t slot = ((size_t)key * D + s) * B + pos;
        for (int j = 0; j < F; j++)
          xrows[slot * F + j] = fields[(b + i) * F + j];
        xlo[slot] = lo[b + i];
        xhi[slot] = hi[b + i];
        xvalid[slot] = 1;
      } else {
        route_ovf[s] = 1;
      }
    }
  }
}

// K12: the verdict fold of every source shard, sequentially.
extern "C" void host_verdict_fold(const uint8_t* verd, const int32_t* s_own,
                                  const int32_t* s_pos,
                                  const uint8_t* s_valid,
                                  const int32_t* order, const int32_t* faction,
                                  const long long* npop, long long ncand,
                                  int D, int B, int chunk, int L,
                                  int n_labels, long long* outdeg,
                                  long long* act_dist) {
  for (int s = 0; s < D; s++) {
    std::vector<int> deg(chunk, 0);
    const size_t b = (size_t)s * ncand;
    for (long long g = 0; g < ncand; g++) {
      const bool got = route_got(verd, D, B, s, s_own[b + g], s_pos[b + g],
                                 s_valid[b + g] != 0);
      const long long lane = order[b + g];
      act_dist[(size_t)s * (n_labels + 1) + (got ? faction[b + lane]
                                                  : n_labels)]++;
      if (got) deg[lane / L]++;
    }
    for (int r = 0; r < chunk; r++)
      outdeg[(size_t)s * (L + 2) + (r < npop[s] ? deg[r] : L + 1)]++;
  }
}

// K13: the owner-side enqueue of every owner's received rows.
extern "C" void host_shard_enqueue(int32_t* queue, long long qrows, int qcap,
                                   const uint8_t* is_new,
                                   const long long* cum,
                                   const long long* qtail,
                                   const uint8_t* q_full,
                                   const int32_t* xrows,
                                   const uint8_t* xvalid, long long n, int D,
                                   int F) {
  for (int o = 0; o < D; o++)
    for (long long i = 0; i < n; i++) {
      const size_t k = (size_t)o * n + i;
      const long long tgt =
          enqueue_target(is_new[k] != 0, q_full[o] != 0, qtail[o], cum[k],
                         cum[(size_t)o * n + n - 1], i, n, qcap);
      if (tgt < 0) continue;
      for (int j = 0; j < F; j++)
        queue[((size_t)o * qrows + (size_t)tgt) * F + j] =
            xvalid[k] ? xrows[k * F + j] : 0;
    }
}
