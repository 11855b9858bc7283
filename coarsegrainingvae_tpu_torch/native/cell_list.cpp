// Cell-list radius-graph construction over trajectory frames.
//
// Native replacement for the host preprocessing hot spot: the reference
// builds an O(N^2) dense pairwise radius graph per frame in torch
// (get_neighbor_list, data.py:65-82 in the reference repo). For large
// systems (chignolin 1.3 GB xtc, spike protein) that dominates dataset
// build time. This implements the standard O(N) cell-list algorithm,
// parallelized over frames with std::thread, and writes directly into the
// caller's preallocated fixed-shape padded edge buffers (the layout the
// TPU pipeline consumes).
//
// Exposed via ctypes from coarsegrainingvae_tpu/native/cell_list.py.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct FrameResult {
  int64_t count = 0;   // number of directed edges found
  bool overflow = false;
};

// Build the directed radius graph of one frame into out_edges/out_mask.
FrameResult frame_radius_graph(const float* xyz, int64_t n, float cutoff,
                               int64_t max_edges, int directed,
                               int32_t* out_edges, uint8_t* out_mask) {
  FrameResult res;
  const float cut2 = cutoff * cutoff;

  // bounding box
  float lo[3] = {xyz[0], xyz[1], xyz[2]};
  float hi[3] = {xyz[0], xyz[1], xyz[2]};
  for (int64_t i = 0; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      const float v = xyz[i * 3 + d];
      lo[d] = std::min(lo[d], v);
      hi[d] = std::max(hi[d], v);
    }
  }

  // cell grid with cell size >= cutoff
  int64_t dims[3];
  for (int d = 0; d < 3; ++d) {
    dims[d] = std::max<int64_t>(1, (int64_t)((hi[d] - lo[d]) / cutoff) + 1);
    dims[d] = std::min<int64_t>(dims[d], 256);  // cap tiny-cutoff blowups
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

  // counting sort of atoms into cells
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

  auto emit = [&](int64_t i, int64_t j) {
    if (res.count < max_edges) {
      out_edges[res.count * 2 + 0] = (int32_t)i;
      out_edges[res.count * 2 + 1] = (int32_t)j;
      out_mask[res.count] = 1;
    } else {
      res.overflow = true;
    }
    ++res.count;
  };

  // scan each atom's 27-cell neighborhood
  for (int64_t i = 0; i < n; ++i) {
    int64_t c[3];
    cell_of(i, c);
    // cells may be wider than cutoff when dims were capped; widen the stencil
    const float span0 = std::max(hi[0] - lo[0], 1e-9f);
    const float span1 = std::max(hi[1] - lo[1], 1e-9f);
    const float span2 = std::max(hi[2] - lo[2], 1e-9f);
    const int64_t rx = std::max<int64_t>(1, (int64_t)std::ceil(cutoff * dims[0] / span0));
    const int64_t ry = std::max<int64_t>(1, (int64_t)std::ceil(cutoff * dims[1] / span1));
    const int64_t rz = std::max<int64_t>(1, (int64_t)std::ceil(cutoff * dims[2] / span2));
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
            if (directed ? (j == i) : (j <= i)) continue;
            const float ddx = xyz[i * 3 + 0] - xyz[j * 3 + 0];
            const float ddy = xyz[i * 3 + 1] - xyz[j * 3 + 1];
            const float ddz = xyz[i * 3 + 2] - xyz[j * 3 + 2];
            if (ddx * ddx + ddy * ddy + ddz * ddz <= cut2) emit(i, j);
          }
        }
      }
    }
  }
  return res;
}

}  // namespace

extern "C" {

// traj: (f, n, 3) float32. out_edges: (f, max_edges, 2) int32 (zeroed by
// caller). out_mask: (f, max_edges) uint8 (zeroed). out_counts: (f,) int64.
// Returns 0 on success, 1 if any frame overflowed max_edges (out_counts
// still holds true counts, so the caller can re-budget and retry).
int radius_graph_frames_cell(const float* traj, int64_t f, int64_t n,
                             float cutoff, int64_t max_edges, int directed,
                             int32_t* out_edges, uint8_t* out_mask,
                             int64_t* out_counts) {
  std::atomic<int> overflow{0};
  const unsigned n_threads =
      std::max(1u, std::min(std::thread::hardware_concurrency(),
                            (unsigned)std::min<int64_t>(f, 64)));
  std::vector<std::thread> pool;
  std::atomic<int64_t> next{0};
  for (unsigned t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      int64_t k;
      while ((k = next.fetch_add(1)) < f) {
        FrameResult r = frame_radius_graph(
            traj + k * n * 3, n, cutoff, max_edges, directed,
            out_edges + k * max_edges * 2, out_mask + k * max_edges);
        out_counts[k] = r.count;
        if (r.overflow) overflow.store(1);
      }
    });
  }
  for (auto& th : pool) th.join();
  return overflow.load();
}

// Count-only pass (max per-frame edge count) so the caller can size the
// padded buffers before the fill pass.
int64_t radius_graph_frames_count(const float* traj, int64_t f, int64_t n,
                                  float cutoff, int directed) {
  std::vector<int64_t> counts(f, 0);
  std::atomic<int64_t> next{0};
  const unsigned n_threads =
      std::max(1u, std::min(std::thread::hardware_concurrency(),
                            (unsigned)std::min<int64_t>(f, 64)));
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      int64_t k;
      while ((k = next.fetch_add(1)) < f) {
        FrameResult r = frame_radius_graph(traj + k * n * 3, n, cutoff,
                                           /*max_edges=*/0, directed,
                                           nullptr, nullptr);
        counts[k] = r.count;
      }
    });
  }
  for (auto& th : pool) th.join();
  int64_t m = 0;
  for (int64_t k = 0; k < f; ++k) m = std::max(m, counts[k]);
  return m;
}

}  // extern "C"
