// Covalent bond-graph extraction + reference-set diff via cell lists.
//
// The sample-quality metrics (eval/metrics.py; reference
// scripts/sampling.py:120-239) compare each generated structure's
// covalent-distance bond graph (d_ij < scale*(r_i + r_j)) against the
// reference structure's. The numpy path materializes dense (N, N)
// distance matrices -- O(N^2) time and memory per structure, prohibitive
// at spike-protein scale (10k atoms -> 100M-entry matrices per sample).
// This computes the same comparison in O(N) with a cell list whose cell
// size is the largest pair cutoff, threaded over structures, returning
// per-structure (missing, spurious) edge counts -- exactly the
// sufficient statistics for validity (missing+spurious == 0), the true
// edit distance (missing+spurious), and the reference's net GED
// (|spurious - missing|).
//
// Exposed via ctypes from coarsegrainingvae_tpu/native/bond_diff.py.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Enumerate undirected pairs (i < j) within scale*(r_i + r_j) and call fn.
template <typename Fn>
void for_bonded_pairs(const float* xyz, const float* radii, int64_t n,
                      float scale, Fn&& fn) {
  float rmax = 0.f;
  for (int64_t i = 0; i < n; ++i) rmax = std::max(rmax, radii[i]);
  const float cutoff = std::max(2.f * rmax * scale, 1e-6f);

  float lo[3] = {xyz[0], xyz[1], xyz[2]};
  float hi[3] = {xyz[0], xyz[1], xyz[2]};
  for (int64_t i = 0; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      const float v = xyz[i * 3 + d];
      lo[d] = std::min(lo[d], v);
      hi[d] = std::max(hi[d], v);
    }
  }
  int64_t dims[3];
  for (int d = 0; d < 3; ++d) {
    dims[d] = std::max<int64_t>(1, (int64_t)((hi[d] - lo[d]) / cutoff) + 1);
    dims[d] = std::min<int64_t>(dims[d], 256);
  }
  const int64_t n_cells = dims[0] * dims[1] * dims[2];

  auto cell_of = [&](int64_t i, int64_t* c) {
    for (int d = 0; d < 3; ++d) {
      float span = hi[d] - lo[d];
      int64_t k = span > 0
          ? (int64_t)((xyz[i * 3 + d] - lo[d]) / span * dims[d])
          : 0;
      c[d] = std::min(std::max<int64_t>(k, 0), dims[d] - 1);
    }
  };

  std::vector<int64_t> cell_idx(n), cell_count(n_cells + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    int64_t c[3];
    cell_of(i, c);
    cell_idx[i] = (c[0] * dims[1] + c[1]) * dims[2] + c[2];
    ++cell_count[cell_idx[i] + 1];
  }
  for (int64_t c = 0; c < n_cells; ++c) cell_count[c + 1] += cell_count[c];
  std::vector<int64_t> order(n);
  {
    std::vector<int64_t> cursor(cell_count.begin(), cell_count.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cursor[cell_idx[i]]++] = i;
  }

  const float span0 = std::max(hi[0] - lo[0], 1e-9f);
  const float span1 = std::max(hi[1] - lo[1], 1e-9f);
  const float span2 = std::max(hi[2] - lo[2], 1e-9f);
  const int64_t rx = std::max<int64_t>(1, (int64_t)std::ceil(cutoff * dims[0] / span0));
  const int64_t ry = std::max<int64_t>(1, (int64_t)std::ceil(cutoff * dims[1] / span1));
  const int64_t rz = std::max<int64_t>(1, (int64_t)std::ceil(cutoff * dims[2] / span2));

  for (int64_t i = 0; i < n; ++i) {
    int64_t c[3];
    cell_of(i, c);
    for (int64_t dx = -rx; dx <= rx; ++dx) {
      const int64_t cx = c[0] + dx;
      if (cx < 0 || cx >= dims[0]) continue;
      for (int64_t dy = -ry; dy <= ry; ++dy) {
        const int64_t cy = c[1] + dy;
        if (cy < 0 || cy >= dims[1]) continue;
        for (int64_t dz = -rz; dz <= rz; ++dz) {
          const int64_t cz = c[2] + dz;
          if (cz < 0 || cz >= dims[2]) continue;
          const int64_t cell = (cx * dims[1] + cy) * dims[2] + cz;
          for (int64_t p = cell_count[cell]; p < cell_count[cell + 1]; ++p) {
            const int64_t j = order[p];
            if (j <= i) continue;
            const float ddx = xyz[i * 3 + 0] - xyz[j * 3 + 0];
            const float ddy = xyz[i * 3 + 1] - xyz[j * 3 + 1];
            const float ddz = xyz[i * 3 + 2] - xyz[j * 3 + 2];
            const float cut = scale * (radii[i] + radii[j]);
            if (ddx * ddx + ddy * ddy + ddz * ddz < cut * cut) fn(i, j);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// xyz: (s, n, 3) structures; radii: (n,) covalent radii; ref_keys: (e_ref,)
// SORTED undirected pair keys i*n+j (i<j). Writes per-structure missing and
// spurious edge counts. Threaded over structures.
void bond_graph_diff(const float* xyz, int64_t s, int64_t n,
                     const float* radii, float scale,
                     const int64_t* ref_keys, int64_t e_ref,
                     int64_t* out_missing, int64_t* out_spurious) {
  std::atomic<int64_t> next{0};
  const unsigned n_threads =
      std::max(1u, std::min(std::thread::hardware_concurrency(),
                            (unsigned)std::min<int64_t>(s, 64)));
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      int64_t k;
      while ((k = next.fetch_add(1)) < s) {
        int64_t found = 0, spurious = 0;
        for_bonded_pairs(
            xyz + k * n * 3, radii, n, scale, [&](int64_t i, int64_t j) {
              const int64_t key = i * n + j;
              const bool in_ref = std::binary_search(
                  ref_keys, ref_keys + e_ref, key);
              if (in_ref) ++found; else ++spurious;
            });
        out_missing[k] = e_ref - found;
        out_spurious[k] = spurious;
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Extract one structure's bond edges (i<j pairs) into out_edges
// (max_edges, 2). Returns the true edge count (may exceed max_edges; the
// caller re-budgets and retries).
int64_t bond_graph_extract(const float* xyz, int64_t n, const float* radii,
                           float scale, int32_t* out_edges,
                           int64_t max_edges) {
  int64_t count = 0;
  for_bonded_pairs(xyz, radii, n, scale, [&](int64_t i, int64_t j) {
    if (count < max_edges) {
      out_edges[count * 2 + 0] = (int32_t)i;
      out_edges[count * 2 + 1] = (int32_t)j;
    }
    ++count;
  });
  return count;
}

}  // extern "C"
