// CPU build of the K1 and K3 per-lane logic, for the host tests
// (tests/test_torch_kernels_host.py).  g++ compiles the same
// __host__ __device__ headers nvcc builds the kernels from; these loops
// stand in for the grids, and host_fpset_walk runs the walk kernel's
// rounds (read, rank, claim-or-advance) sequentially.  Not used by the
// engine.
#include <algorithm>
#include <vector>

#include "fpset.cuh"
#include "kubeapi.cuh"

extern "C" int tt_layout_words() { return sizeof(KubeLayout) / 4; }

extern "C" void host_expand(const void* layout, const uint32_t* block, int ck,
                            int n, uint32_t* packed, uint8_t* flags,
                            int32_t* action, unsigned long long* gen) {
  const KubeLayout& Y = *(const KubeLayout*)layout;
  const long long ncand = (long long)ck * Y.L;
  for (long long idx = 0; idx < ncand; idx++) {
    const int row = (int)(idx / Y.L), lane = (int)(idx % Y.L);
    LaneOut o = kube_expand_lane(Y, block + (size_t)row * Y.W, row < n, lane,
                                 packed + (size_t)idx * Y.W);
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

// One probe segment: round 0 against the pre-claim table, the first C
// fitting claims, then the straggler walk.  is_new: [R] bytes.
extern "C" void host_fpset_probe_segment(uint32_t* table, int lognb,
                                         const int64_t* keys, int R,
                                         long long nreps, long long off, int C,
                                         uint8_t* is_new) {
  const uint32_t nb_mask = (1u << lognb) - 1u;
  std::vector<int32_t> slot(R);
  for (int i = 0; i < R; i++)
    slot[i] = fp_round0(table, lognb, keys, i, off + i < nreps);
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
