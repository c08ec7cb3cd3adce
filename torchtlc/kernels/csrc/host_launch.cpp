// CPU build of the per-lane logic of K1, K3, K5-K9, for the host tests
// (tests/test_torch_kernels_host.py).  g++ compiles the same
// __host__ __device__ headers nvcc builds the kernels from; these loops
// stand in for the grids, the straggler walk runs the walk kernel's
// rounds (read, rank, claim-or-advance) sequentially, and std::stable_sort
// stands in for the ordering sort.  Not used by the engine.
#include <algorithm>
#include <vector>

#include "deferred.cuh"
#include "fpset.cuh"
#include "ring.cuh"
#include "slab.cuh"

extern "C" int tt_layout_words() { return sizeof(KubeLayout) / 4; }

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
                              int n_labels) {
  uint32_t m = 0u;
  for (int r = 0; r <= slots; r++)
    m = std::max(m, ring[(size_t)r * cols + RING_COL_OVERFLOW]);
  bool wrap = ring_wrapped(gen_new, gen_old) ||
              ring_wrapped(dist_new, dist_old) ||
              ring_wrapped(*bodies + 1, *bodies) ||
              ring_wrapped(*expanded + n_pop, *expanded) ||
              (spill_new != nullptr && ring_wrapped(*spill_new, *spill_old));
  for (int k = 0; k < n_acts; k++)
    wrap = wrap || ring_wrapped(act_gen[k], acts_old[k]) ||
           ring_wrapped(act_dist[k], acts_old[n_acts + k]);
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
