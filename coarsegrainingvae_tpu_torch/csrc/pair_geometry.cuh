// Pair geometry of the fused pseudo kernels, forward and backward, for
// Hopper (sm_90a), and the second pass of the weight gradients.
//
// The kernels of fused_pseudo.cu rebuild the pair pipeline of the JAX
// package's _geometry (pallas_pseudo.py:57-73) on chip, one row node p
// against a chunk of partner nodes q (fused_message.cu builds its own
// per-pair records of the same quantities):
//
//   r = x_q - x_p,  d = sqrt(|r|^2 + 1e-3),  unit = r / d
//   adj = (d < cutoff) * (p != q) * mask_p * mask_q
//   K[r] = adj * env(d) * [rbf_1..R(d), 1]_r
//
// K and adj are symmetric in (p, q) and unit is antisymmetric, so the
// backward kernels use the same rows for a node in either role.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace cgvae {
namespace {

constexpr int kMaxRA = 16;      // n_rbf + 1 <= 16 (checked by the wrappers)
constexpr int kChunk = 64;      // partner nodes per shared-memory chunk
constexpr int kThreads = 128;   // threads per block, striding over F
constexpr float kEps = 1e-3f;
constexpr float kPi = 3.14159265358979323846f;

// One chunk of partners q0 .. q0 + nq - 1 of row node p, in shared memory.
struct PairChunk {
  float k[kChunk][kMaxRA];  // K[r]; rows r >= RA are zero
  float unit[kChunk][3];    // (x_q - x_p) / d
  float adj[kChunk];        // 0/1 cutoff adjacency
  float on[kChunk];         // adj * env != 0: the pair contributes
};

// The block's threads fill the chunk; callers bracket the call with
// __syncthreads(). xb and mb are one batch element's coordinates and mask.
__device__ inline void build_pair_chunk(PairChunk& c, const float* xb,
                                        const float* mb, int p, int q0,
                                        int nq, int RA, float cutoff) {
  const float xp0 = xb[p * 3 + 0], xp1 = xb[p * 3 + 1], xp2 = xb[p * 3 + 2];
  const float mp = mb[p];
  const int n_rbf = RA - 1;
  for (int qq = threadIdx.x; qq < nq; qq += blockDim.x) {
    const int q = q0 + qq;
    const float r0 = xb[q * 3 + 0] - xp0;
    const float r1 = xb[q * 3 + 1] - xp1;
    const float r2 = xb[q * 3 + 2] - xp2;
    const float d = sqrtf(r0 * r0 + r1 * r1 + r2 * r2 + kEps);
    c.unit[qq][0] = r0 / d;
    c.unit[qq][1] = r1 / d;
    c.unit[qq][2] = r2 / d;
    const float adj = (d < cutoff ? 1.f : 0.f) * (q != p ? 1.f : 0.f) * mp * mb[q];
    const float env = d >= cutoff ? 0.f : 0.5f * (cosf(kPi * d / cutoff) + 1.f);
    const float ae = adj * env;
    for (int r = 0; r < n_rbf; ++r) {
      const float coef = (float)(r + 1) * kPi / cutoff;
      float rbf = d == 0.f ? coef : sinf(coef * d) / d;
      if (d >= cutoff) rbf = 0.f;
      c.k[qq][r] = ae * rbf;
    }
    c.k[qq][n_rbf] = ae;
    for (int r = RA; r < kMaxRA; ++r) c.k[qq][r] = 0.f;
    c.adj[qq] = adj;
    c.on[qq] = ae != 0.f ? 1.f : 0.f;
  }
}

// out[i] = sum_b part[b * n + i]: the second pass of a weight gradient that
// the backward kernels leave as one partial sum per batch element. A fixed
// order of summation, so the result is deterministic.
__global__ void sum_over_batch(const float* __restrict__ part,
                               float* __restrict__ out, int B, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += part[(size_t)b * n + i];
  out[i] = acc;
}

// Launch sum_over_batch on the stream and return the launch's error.
inline int launch_sum_over_batch(const float* part, float* out, int B, int n,
                                 cudaStream_t stream) {
  constexpr int kSumThreads = 256;
  sum_over_batch<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads, 0, stream>>>(
      part, out, B, n);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cgvae
