// CPU build of the per-lane logic of K1, K3, K5-K16 and K36-K40, for the
// host tests (tests/test_torch_kernels_host.py, tests/test_torch_sharded.py,
// tests/test_torch_live.py, tests/test_torch_pod.py,
// tests/test_torch_sim_kube.py).  g++ compiles the same
// __host__ __device__ headers nvcc builds the kernels from; these loops
// stand in for the grids, the straggler walk runs the walk kernel's
// rounds (read, count, claim-or-advance) sequentially, and std::stable_sort
// stands in for the ordering sort.  Not used by the engine.
#include <algorithm>
#include <vector>

#include "coverage.cuh"
#include "deferred.cuh"
#include "fpset.cuh"
#include "kube_sim.cuh"
#include "liveness.cuh"
#include "pod.cuh"
#include "ring.cuh"
#include "route.cuh"
#include "slab.cuh"

extern "C" int tt_layout_words() { return sizeof(KubeLayout) / 4; }
extern "C" int tt_coverage_words() { return sizeof(CovParams) / 4; }
extern "C" int tt_mask_words() { return sizeof(MaskParams) / 4; }

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

// K1 (expand.cu): each row decoded once (its words with the bits past
// nbits cleared, kube_field_get at the fields' offsets), then its L lanes
// (kube_lane_step).
extern "C" void host_expand(const void* layout, const uint32_t* block, int ck,
                            int n, int deferred, uint32_t* packed,
                            uint8_t* flags,
                            int32_t* action, unsigned long long* gen) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  const long long ncand = (long long)ck * Y.L;
  int32_t off[KUBE_MAXF];
  kube_field_offsets(Y, off);
  for (int row = 0; row < ck; row++) {
    u32 base[KUBE_MAXF];
    for (int k = 0; k < Y.W; k++)
      base[k] = kube_row_word(Y, block + (size_t)row * Y.W, k);
    int32_t f[KUBE_MAXF], s[KUBE_MAXF];
    for (int j = 0; j < Y.F; j++)
      f[j] = kube_field_get(base, Y.W, off[j], Y.width[j]);
    for (int lane = 0; lane < Y.L; lane++) {
      const long long idx = (long long)row * Y.L + lane;
      u32* dst = packed + (size_t)idx * Y.W;
      LaneOut o =
          deferred
              ? kube_lane_step<true>(Y, off, f, base, row < n, lane, s, dst)
              : kube_lane_step<false>(Y, off, f, base, row < n, lane, s, dst);
      flags[idx] = o.valid;
      flags[ncand + idx] = o.afail;
      flags[2 * ncand + idx] = o.ovf;
      flags[3 * ncand + idx] = o.bad_typeok;
      flags[4 * ncand + idx] = o.bad_onlyone;
      action[idx] = o.action;
      if (o.valid) gen[o.action]++;
    }
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

// The straggler walk (fpset_walk.cuh) over the pending positions [R]
// bytes, sequentially: slices of S = min(R, 2048) in position order, each
// ordered once by (home, lo, hi) (fp_slice_order), then rounds of row
// reads, the wanters' exclusive count in sorted order, and claims at
// occupancy + (count at the entry - count at its home run's first entry).
// Clears pending, sets is_new; stats (nullable) gets slices, rounds and
// general-order slices added.
extern "C" void host_fpset_walk(uint32_t* table, int lognb,
                                const int64_t* keys, int R, uint8_t* pending,
                                uint8_t* is_new, int* stats) {
  const uint32_t nb_mask = (uint32_t)((1ull << lognb) - 1ull);
  std::vector<int> pend;
  for (int i = 0; i < R; i++)
    if (pending[i]) pend.push_back(i);
  const int S = R < 2048 ? R : 2048;
  for (size_t start = 0; start < pend.size(); start += S) {
    const int ns = (int)std::min(pend.size() - start, (size_t)S);
    std::vector<uint32_t> lo(ns), hi(ns), home(ns);
    for (int i = 0; i < ns; i++) {
      lo[i] = fp_key_lo(keys[pend[start + i]]);
      hi[i] = fp_key_hi(keys[pend[start + i]]);
      home[i] = fp_bucket(hi[i], lognb);
    }
    bool general = false;
    for (int i = 0; i < ns; i++)
      general = general || fp_slice_descends(home.data(), i);
    std::vector<int> ord(ns), rs(ns), st(ns, 1), occ(ns), ex(ns + 1);
    std::vector<uint32_t> b(ns);
    for (int i = 0; i < ns; i++) {
      int pos, r;
      fp_slice_order(home.data(), lo.data(), hi.data(), ns, i, general, &pos,
                     &r);
      ord[pos] = i;
      rs[pos] = r;
    }
    for (int e = 0; e < ns; e++) b[e] = home[ord[e]];
    int rounds = 0;
    while (true) {
      rounds++;
      std::vector<char> want(ns, 0);
      for (int e = 0; e < ns; e++) {
        if (!(st[e] & 1)) continue;
        uint32_t row[2 * FP_BUCKET];
        fp_load_row<true>(table, b[e], row);
        if (fp_row_has(row, lo[ord[e]], hi[ord[e]])) {
          st[e] = 0;
        } else {
          occ[e] = fp_row_occ(row);
          want[e] = 1;
        }
      }
      ex[0] = 0;
      for (int e = 0; e < ns; e++) ex[e + 1] = ex[e] + want[e];
      if (ex[ns] == 0) break;
      for (int e = 0; e < ns; e++) {
        if (!want[e]) continue;
        const int slot = occ[e] + ex[e] - ex[rs[e]];
        if (slot < FP_BUCKET) {
          table[(size_t)b[e] * 16 + 2 * slot] = lo[ord[e]];
          table[(size_t)b[e] * 16 + 2 * slot + 1] = hi[ord[e]];
          st[e] = 2;
        } else {
          b[e] = (b[e] + 1u) & nb_mask;
        }
      }
    }
    for (int e = 0; e < ns; e++) {
      const int p = pend[start + ord[e]];
      is_new[p] = (uint8_t)(st[e] >> 1);
      pending[p] = 0;
    }
    if (stats != nullptr) {
      stats[0] += 1;
      stats[1] += rounds;
      stats[2] += general ? 1 : 0;
    }
  }
}

// One probe segment: round 0 against the pre-claim table, the first C
// fitting claims, then the straggler walk.  Active lanes: act (nullable,
// the slab layout) or the prefix off + i < nreps.  is_new: [R] bytes;
// walk_stats as host_fpset_walk's.
extern "C" void host_fpset_probe_segment(
    uint32_t* table, int lognb, const int64_t* keys, int R, long long nreps,
    long long off, const uint8_t* act, int C, uint8_t* is_new,
    int* walk_stats) {
  std::vector<int32_t> slot(R);
  for (int i = 0; i < R; i++)
    slot[i] = fp_round0(table, lognb, keys, act, i,
                        act != nullptr ? act[i] != 0 : off + i < nreps);
  std::vector<uint8_t> pending(R, 0);
  int nclaim = 0;
  for (int i = 0; i < R; i++) {
    bool claimed = slot[i] >= 0 && nclaim < C;
    nclaim += slot[i] >= 0 ? 1 : 0;
    if (claimed) {
      table[2 * (size_t)slot[i]] = fp_key_lo(keys[i]);
      table[2 * (size_t)slot[i] + 1] = fp_key_hi(keys[i]);
    }
    is_new[i] = claimed;
    pending[i] = slot[i] == -2 || (slot[i] >= 0 && !claimed);
  }
  host_fpset_walk(table, lognb, keys, R, pending.data(), is_new, walk_stats);
}

// K33's probe segment over stacked tables ([*, nb, 16]): row k's R keys at
// keys + k * R against table lanes[k] (k when lanes is NULL), active lanes
// act[k, :] or the prefix off + i < nreps[k]; is_new [K, R] bytes.
extern "C" void host_fpset_insert_batched(uint32_t* table, int lognb,
                                          const int64_t* keys, int K, int R,
                                          const int* lanes,
                                          const long long* nreps,
                                          long long off, const uint8_t* act,
                                          int C, uint8_t* is_new) {
  for (int k = 0; k < K; k++)
    host_fpset_probe_segment(
        table + ((size_t)(lanes != nullptr ? lanes[k] : k) << lognb) * 16,
        lognb, keys + (size_t)k * R, R, act != nullptr ? 0 : nreps[k], off,
        act != nullptr ? act + (size_t)k * R : nullptr, C,
        is_new + (size_t)k * R, nullptr);
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
// spill_new / spill_old null outside spill mode, cert null without the
// runtime certificate, sym null without symmetry reduction, as in
// tt_ring_row.
static void host_ring_row_impl(uint32_t* ring, int slots, int cols,
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
                               const long long* cov_old, int n_cov,
                               const bool* cert, const bool* sym) {
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
  v.cert = cert != nullptr && *cert ? 1u : 0u;
  v.sym = sym != nullptr && *sym ? 1u : 0u;
  const long long row = flip ? *head % slots : slots;
  for (int c = 0; c < cols; c++)
    ring[(size_t)row * cols + c] = ring_cell(v, act_gen, act_dist, n_labels, c);
  *head += flip ? 1 : 0;
  *bodies = v.bodies;
  *expanded = v.expanded;
}

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
  host_ring_row_impl(ring, slots, cols, head, bodies, expanded, n_pop, flip,
                     level, gen_new, gen_old, dist_new, dist_old, queue_n,
                     act_gen, act_dist, acts_old, spill_new, spill_old,
                     n_acts, n_labels, cov_new, cov_old, n_cov, nullptr,
                     nullptr);
}

// the same with the carry's certificate flag in COL_CERT
extern "C" void host_ring_row_cert(
    uint32_t* ring, int slots, int cols, long long* head, long long* bodies,
    long long* expanded, long long n_pop, int flip, long long level,
    long long gen_new, long long gen_old, long long dist_new,
    long long dist_old, long long queue_n, const long long* act_gen,
    const long long* act_dist, const long long* acts_old,
    const long long* spill_new, const long long* spill_old, int n_acts,
    int n_labels, const long long* cov_new, const long long* cov_old,
    int n_cov, const bool* cert) {
  host_ring_row_impl(ring, slots, cols, head, bodies, expanded, n_pop, flip,
                     level, gen_new, gen_old, dist_new, dist_old, queue_n,
                     act_gen, act_dist, acts_old, spill_new, spill_old,
                     n_acts, n_labels, cov_new, cov_old, n_cov, cert,
                     nullptr);
}

// the same with the carry's orbit-certificate flag in COL_SYM too
extern "C" void host_ring_row_sym(
    uint32_t* ring, int slots, int cols, long long* head, long long* bodies,
    long long* expanded, long long n_pop, int flip, long long level,
    long long gen_new, long long gen_old, long long dist_new,
    long long dist_old, long long queue_n, const long long* act_gen,
    const long long* act_dist, const long long* acts_old,
    const long long* spill_new, const long long* spill_old, int n_acts,
    int n_labels, const long long* cov_new, const long long* cov_old,
    int n_cov, const bool* cert, const bool* sym) {
  host_ring_row_impl(ring, slots, cols, head, bodies, expanded, n_pop, flip,
                     level, gen_new, gen_old, dist_new, dist_old, queue_n,
                     act_gen, act_dist, acts_old, spill_new, spill_old,
                     n_acts, n_labels, cov_new, cov_old, n_cov, cert, sym);
}

// K1's sharded variant: every lane of the D shards' pops, reading the
// unpacked circular queue rows (expand.cu, kSharded): each row's packed
// words once (its fields OR-ed in, kube_field_or), then its L lanes
// (kube_lane_step); block may be null.
extern "C" void host_expand_sharded(const void* layout, const int32_t* queue,
                                    long long qrows, int qcap,
                                    const long long* qhead,
                                    const long long* npop, int D, int ck,
                                    int deferred, uint32_t* packed,
                                    uint8_t* flags, int32_t* action,
                                    int32_t* fields, uint32_t* block,
                                    unsigned long long* gen) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  const long long ncand = (long long)D * ck * Y.L;
  int32_t off[KUBE_MAXF];
  kube_field_offsets(Y, off);
  for (int d = 0; d < D; d++)
    for (int row = 0; row < ck; row++) {
      const int32_t* src =
          queue + ((size_t)d * qrows + (size_t)((qhead[d] + row) % qcap)) * Y.F;
      u32 base[KUBE_MAXF] = {};  // W <= F words
      for (int j = 0; j < Y.F; j++)
        kube_field_or(base, Y.W, off[j], Y.width[j], (u32)src[j]);
      if (block != nullptr)
        for (int k = 0; k < Y.W; k++)
          block[((size_t)d * ck + row) * Y.W + k] = base[k];
      for (int lane = 0; lane < Y.L; lane++) {
        const long long idx = ((long long)d * ck + row) * Y.L + lane;
        u32* dst = packed + (size_t)idx * Y.W;
        int32_t* fo = fields + (size_t)idx * Y.F;
        const bool popped = row < npop[d];
        LaneOut o =
            deferred
                ? kube_lane_step<true>(Y, off, src, base, popped, lane, fo, dst)
                : kube_lane_step<false>(Y, off, src, base, popped, lane, fo,
                                        dst);
        flags[idx] = o.valid;
        flags[ncand + idx] = o.afail;
        flags[2 * ncand + idx] = o.ovf;
        flags[3 * ncand + idx] = o.bad_typeok;
        flags[4 * ncand + idx] = o.bad_onlyone;
        action[idx] = o.action;
        if (o.valid) gen[(size_t)d * KUBE_N_LABELS + o.action]++;
      }
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
// and the payload scatter, sequentially (xvalid zeroed by the caller); S
// source shards (D / H in a pod), D owners, planes [D, S, B, .].
extern "C" void host_route_scatter_s(const uint32_t* hi, const uint32_t* lo,
                                     const uint8_t* valid,
                                     const int32_t* fields, long long ncand,
                                     int D, int S, int B, int F,
                                     int32_t* order, int32_t* s_own,
                                     int32_t* s_pos, uint8_t* s_valid,
                                     int32_t* xrows, uint32_t* xlo,
                                     uint32_t* xhi, uint8_t* xvalid,
                                     uint8_t* route_ovf) {
  for (int s = 0; s < S; s++) {
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
        const size_t slot = ((size_t)key * S + s) * B + pos;
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

extern "C" void host_route_scatter(const uint32_t* hi, const uint32_t* lo,
                                   const uint8_t* valid, const int32_t* fields,
                                   long long ncand, int D, int B, int F,
                                   int32_t* order, int32_t* s_own,
                                   int32_t* s_pos, uint8_t* s_valid,
                                   int32_t* xrows, uint32_t* xlo,
                                   uint32_t* xhi, uint8_t* xvalid,
                                   uint8_t* route_ovf) {
  host_route_scatter_s(hi, lo, valid, fields, ncand, D, D, B, F, order, s_own,
                       s_pos, s_valid, xrows, xlo, xhi, xvalid, route_ovf);
}

// K12: the verdict fold of every source shard, sequentially (verd [D, S,
// B]).
extern "C" void host_verdict_fold_s(const uint8_t* verd, const int32_t* s_own,
                                    const int32_t* s_pos,
                                    const uint8_t* s_valid,
                                    const int32_t* order,
                                    const int32_t* faction,
                                    const long long* npop, long long ncand,
                                    int D, int S, int B, int chunk, int L,
                                    int n_labels, long long* outdeg,
                                    long long* act_dist) {
  for (int s = 0; s < S; s++) {
    std::vector<int> deg(chunk, 0);
    const size_t b = (size_t)s * ncand;
    for (long long g = 0; g < ncand; g++) {
      const bool got = route_got_s(verd, D, S, B, s, s_own[b + g],
                                   s_pos[b + g], s_valid[b + g] != 0);
      const long long lane = order[b + g];
      act_dist[(size_t)s * (n_labels + 1) + (got ? faction[b + lane]
                                                  : n_labels)]++;
      if (got) deg[lane / L]++;
    }
    for (int r = 0; r < chunk; r++)
      outdeg[(size_t)s * (L + 2) + (r < npop[s] ? deg[r] : L + 1)]++;
  }
}

extern "C" void host_verdict_fold(const uint8_t* verd, const int32_t* s_own,
                                  const int32_t* s_pos,
                                  const uint8_t* s_valid,
                                  const int32_t* order, const int32_t* faction,
                                  const long long* npop, long long ncand,
                                  int D, int B, int chunk, int L,
                                  int n_labels, long long* outdeg,
                                  long long* act_dist) {
  host_verdict_fold_s(verd, s_own, s_pos, s_valid, order, faction, npop,
                      ncand, D, D, B, chunk, L, n_labels, outdeg, act_dist);
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

// K14: both passes over N lanes, the inclusive counts summed in between;
// returns the number of edges written, or -1 when a valid lane's
// fingerprint is missing.
extern "C" long long host_edge_capture(const uint32_t* s_hi,
                                       const uint32_t* s_lo,
                                       const int32_t* perm, int n, int rounds,
                                       const uint32_t* q_hi,
                                       const uint32_t* q_lo,
                                       const uint8_t* valid,
                                       const int32_t* action, long long N,
                                       int L, int offset, int32_t* edges) {
  std::vector<int32_t> dst(N);
  std::vector<uint8_t> changed(N);
  std::vector<long long> cum(N);
  bool missing = false;
  long long c = 0;
  for (long long i = 0; i < N; i++) {
    missing |= edge_search_lane(i, s_hi, s_lo, perm, n, rounds, q_hi, q_lo,
                                valid, L, offset, dst.data(), changed.data());
    c += valid[i] != 0;
    cum[i] = c;
  }
  for (long long i = 0; i < N; i++)
    edge_compact_lane(i, valid, cum.data(), L, offset, dst.data(),
                      changed.data(), action, edges);
  return missing ? -1 : c;
}

// K15: every state's predicate rows.
extern "C" void host_state_masks(const void* params, const uint32_t* states,
                                 long long V, uint8_t* out) {
  const MaskParams& p = *(const MaskParams*)params;
  for (long long v = 0; v < V; v++)
    state_masks_row(p, states + (size_t)v * p.W, v, V, out);
}

// K16: one sweep; returns whether a state died.
extern "C" int host_survive_sweep(const int32_t* src, const int32_t* dst,
                                  long long E, long long slice, int D,
                                  const uint8_t* alive, const uint8_t* term,
                                  long long V, uint8_t* alive2) {
  std::vector<uint8_t> support((size_t)D * V, 0);
  for (long long e = 0; e < E; e++)
    survive_scatter_edge(e, src, dst, alive, slice, V, support.data());
  int changed = 0;
  for (long long v = 0; v < V; v++) {
    alive2[v] = survive_update_state(v, alive, term, support.data(), D, V);
    changed |= alive2[v] != alive[v];
  }
  return changed;
}

// K36: K11's planes into the [D, S, B, F + 3] send buffer, sequentially.
extern "C" void host_pod_exchange_pack(const int32_t* xrows,
                                       const int32_t* xlo, const int32_t* xhi,
                                       const uint8_t* xvalid, long long lanes,
                                       int F, int32_t* out) {
  for (long long lane = 0; lane < lanes; lane++)
    for (int j = 0; j < F + 3; j++)
      out[lane * (F + 3) + j] = pod_pack_word(xrows, xlo, xhi, xvalid, lane,
                                              F, j);
}

// K37: the received [H, S, S, B, F + 3] buffer into the owner planes.
extern "C" void host_pod_exchange_unpack(const int32_t* recv, int H, int S,
                                         int B, int F, int32_t* xrows,
                                         int32_t* xlo, int32_t* xhi,
                                         uint8_t* xvalid) {
  const int w = F + 3;
  for (int o = 0; o < S; o++)
    for (int g = 0; g < H * S; g++)
      for (int b = 0; b < B; b++) {
        const long long lane = ((long long)o * H * S + g) * B + b;
        const int32_t* src = recv + pod_unpack_src(S, B, o, g, b) * w;
        for (int j = 0; j < F; j++) xrows[lane * F + j] = src[j];
        xlo[lane] = src[F];
        xhi[lane] = src[F + 1];
        xvalid[lane] = src[F + 2] != 0;
      }
}

// K38: n leaves of `rows` rows into [rows, W] int64 words; -1 on a bad
// descriptor.
extern "C" int host_pod_stats_pack(const void* const* ptrs, const int* widths,
                                   const int* kinds, int n, int rows,
                                   long long* out) {
  PodPackDesc P;
  if (pod_pack_desc(P, ptrs, widths, kinds, n) != 0) return -1;
  for (int r = 0; r < rows; r++)
    for (int c = 0; c < P.W; c++)
      out[(size_t)r * P.W + c] = pod_stats_word(P, r, c);
  return 0;
}

// K39: every walker's round (or, with init, its Init state) in lane order,
// the block folds into the scratch directly; packed may be null.
struct HostKubeSimMin {  // a walker into the scratch's class minima
  int32_t* sc;
  int lane;
  void operator()(int c) {
    if (lane < sc[KSIM_MIN + c]) sc[KSIM_MIN + c] = lane;
  }
};

extern "C" int host_kube_sim_step(const void* layout, const int* go,
                                  const uint32_t* key, const int32_t* step_i,
                                  const int32_t* inits, int n0,
                                  int32_t* states, uint8_t* alive,
                                  int32_t* steps_taken, int W, int init,
                                  int check_deadlock, uint32_t* packed,
                                  uint8_t* take, int32_t* vold, int32_t* vact,
                                  int32_t* scratch) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  if (!init && *go == 0) return 0;
  uint32_t* su = (uint32_t*)scratch;
  for (int lane = 0; lane < W; lane++) {
    HostKubeSimMin trip{scratch, lane};
    bool took;
    if (init) {
      kube_sim_init_lane(Y, key[0], key[1], lane, inits, n0, states, trip);
      took = true;
      scratch[KSIM_ANY] = 1;
    } else {
      const KubeSimLane r =
          kube_sim_lane(Y, key[0], key[1], *step_i + 1, lane, states, alive,
                        steps_taken, check_deadlock != 0, vold, vact, trip);
      su[KSIM_GEN] += r.gen;
      if (r.take) {
        su[KSIM_TRANS] += 1u;
        su[KSIM_HIST + r.act] += 1u;
        scratch[KSIM_ANY] = 1;
      }
      took = r.take;
    }
    if (packed) {
      kube_pack(Y, states + (size_t)lane * Y.F, packed + (size_t)lane * Y.W);
      take[lane] = took;
    }
  }
  return 0;
}

// K40: the fold of one round's scratch into the carry, in place.
extern "C" int host_kube_sim_fold(int init, int F, int* go, int32_t* scratch,
                                  int depth, int32_t* step_i, int32_t* viol,
                                  int32_t* viol_lane, int32_t* viol_step,
                                  int32_t* viol_state, int32_t* viol_action,
                                  uint32_t* generated, uint32_t* transitions,
                                  uint32_t* act_taken, const int32_t* states,
                                  const int32_t* vold, const int32_t* vact) {
  if (!init && *go == 0) return 0;
  int lane;
  const int c = kube_sim_fold_scalars(init, scratch, depth, step_i, viol,
                                      viol_lane, viol_step, viol_action,
                                      generated, transitions, vact, go, &lane);
  if (c >= 0) {
    const int32_t* src = (kube_sim_old_row(c) ? vold : states) + (size_t)lane * F;
    for (int j = 0; j < F; j++) viol_state[j] = src[j];
  }
  for (int t = 0; t < KUBE_N_LABELS; t++)
    act_taken[t] += (uint32_t)scratch[KSIM_HIST + t];
  for (int t = 0; t < KSIM_SCRATCH; t++) kube_sim_reset(scratch, t);
  return 0;
}
