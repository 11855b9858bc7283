// Fused factored PaiNN message, forward and backward (f32), for Hopper
// (sm_90a).
//
// Replaces the TPU kernels coarsegrainingvae_tpu/ops/pallas_message.py::
// _fused_kernel (forward, launched by _fused_call) and ::_bwd_kernel (its
// hand-derived VJP, launched by _bwd_call). Same semantics as the plain
// versions message_reference (pallas_message.py:72-113) and
// message_vjp_reference (coarsegrainingvae_tpu_torch/ops/fused_message.py):
//
//   K[i,j,r] = adj_ij * env(d_ij) * [rbf_1..R(d_ij), 1]_r
//   filt_c   = sum_r K[i,j,r] w[r,c,f]
//   ds_i     = sum_j filt_1 phi[j,1]
//   dv_i     = sum_j filt_2 unit_ij phi[j,2] + sum_j filt_0 phi[j,0] v_j
//            (+ v_i x w3_i,  w3_i = sum_j filt_3 phi[j,3] v_j   when S == 4)
//
// with r_ij = x_j - x_i, d = sqrt(|r|^2 + 1e-3), unit = r / d, and
// adj = (d < cutoff) * (i != j) * mask_i * mask_j (pair_geometry.cuh).
//
// Forward. What bounds it on this card: on the served path (B = 64
// samples, M = 3 beads, F = 600) one call reads and writes ~4.7 MB and does
// ~12 MFLOP, i.e. ~1.4 us at 3.35 TB/s: it is launch- and latency-bound,
// far from both the memory and the FP32 rate. At N = 27 (the encoder) the
// senders' phi/v rows are re-read by every receiver block, from L2. Design:
// one block per (batch element, receiver i), threads striding over F so
// every global access is coalesced along F. The block builds the pair
// geometry for a chunk of senders in shared memory once (rebuilt per
// F-group only when N exceeds one chunk), and each thread keeps one
// channel's w[:, c, f] column in registers while it walks the senders.
//
// Backward. Given the cotangents gs (B,N,F) and gv (B,N,3,F) it writes
// d_phi (B,N,S,F), d_v (B,N,3,F) and d_w (R+1,S,F) summed over the batch;
// xyz and mask get no gradient (the JAX contract, pallas_message.py:38-42).
// With node p as the sender of the pair (q <- p) and t_c(q) the cotangent
// that pair hands channel c per unit of p's payload:
//
//   t_1 = gs_q,   t_2 = gv_q . unit_qp,   t_0 = gv_q . v_p,
//   t_3 = (gv_q x v_q) . v_p
//   d_phi[p,c] = sum_q filt_c[p,q] t_c(q)
//   d_v_p      = phi[p,0] sum_q filt_0 gv_q + phi[p,3] sum_q filt_3 (gv_q x v_q)
//              + w3_p x gv_p                       (receiver side of the cross)
//   d_w[r,c]   = sum_b sum_p phi[p,c] sum_q K[p,q,r] t_c(q)
//
// K is symmetric and unit antisymmetric (unit_qp = -unit_pq), so one row
// of geometry per node p serves both roles, as in the TPU kernel. The TPU
// kernel sums d_w across its sequential grid into one block; blocks here run
// in no order, so the sum takes two passes: each block writes one partial
// d_w per batch element (B x (R+1) x S x F floats, 8.3 MB at B = 128, F =
// 600), and sum_over_batch adds them in a fixed order. No atomics; the
// result is deterministic. Design: one block per (batch element, chunk of
// 128 features); each thread owns one feature column and walks the nodes p,
// the channels c and the partners q, so every output element has one writer.
// The forward's "fold the basis first" trick (filt in a register) serves
// d_phi and d_v; d_w needs the R+1 per-basis sums sum_q K[r] t_c(q), kept
// in registers for one (p, c) at a time and added into the block's partial.
// What bounds it: at B = 128, N = 27, F = 600, S = 3 it reads ~25 MB and
// does ~2 GFLOP, latency-bound on the per-pair loop.
//
// The TPU kernels' 8-node tiling and their padding of N to a multiple of 8
// came from the (8, 128) vreg layout and are not carried over.

#include "pair_geometry.cuh"

namespace cgvae {
namespace {

__global__ void fused_message_kernel(
    const float* __restrict__ xyz,    // (B, N, 3)
    const float* __restrict__ mask,   // (B, N)
    const float* __restrict__ phi,    // (B, N, S, F)
    const float* __restrict__ v,      // (B, N, 3, F)
    const float* __restrict__ w,      // (RA, S, F)
    float* __restrict__ ds,           // (B, N, F)
    float* __restrict__ dv,           // (B, N, 3, F)
    int N, int S, int F, int RA, float cutoff) {
  __shared__ PairChunk pc;

  const int b = blockIdx.x / N;
  const int i = blockIdx.x % N;
  const float* xb = xyz + (size_t)b * N * 3;
  const float* mb = mask + (size_t)b * N;
  const int n_chunks = (N + kChunk - 1) / kChunk;

  for (int f0 = 0; f0 < F; f0 += blockDim.x) {
    const int f = f0 + threadIdx.x;
    const bool active = f < F;
    float acc_s = 0.f;
    float acc_v[3] = {0.f, 0.f, 0.f};
    float acc_w3[3] = {0.f, 0.f, 0.f};

    for (int c0 = 0; c0 < n_chunks; ++c0) {
      const int j0 = c0 * kChunk;
      const int nj = min(kChunk, N - j0);
      if (n_chunks > 1 || f0 == 0) {
        __syncthreads();
        build_pair_chunk(pc, xb, mb, i, j0, nj, RA, cutoff);
        __syncthreads();
      }
      if (!active) continue;

      for (int c = 0; c < S; ++c) {
        float wc[kMaxRA];
#pragma unroll
        for (int r = 0; r < kMaxRA; ++r)
          wc[r] = r < RA ? w[((size_t)r * S + c) * F + f] : 0.f;
        for (int jj = 0; jj < nj; ++jj) {
          if (pc.on[jj] == 0.f) continue;
          float filt = 0.f;
#pragma unroll
          for (int r = 0; r < kMaxRA; ++r) filt += pc.k[jj][r] * wc[r];
          const size_t row = (size_t)b * N + j0 + jj;
          const float p = phi[(row * S + c) * F + f] * filt;
          if (c == 1) {
            acc_s += p;
          } else if (c == 2) {
            acc_v[0] += p * pc.unit[jj][0];
            acc_v[1] += p * pc.unit[jj][1];
            acc_v[2] += p * pc.unit[jj][2];
          } else {
            const float p0 = p * v[(row * 3 + 0) * F + f];
            const float p1 = p * v[(row * 3 + 1) * F + f];
            const float p2 = p * v[(row * 3 + 2) * F + f];
            if (c == 0) {
              acc_v[0] += p0; acc_v[1] += p1; acc_v[2] += p2;
            } else {
              acc_w3[0] += p0; acc_w3[1] += p1; acc_w3[2] += p2;
            }
          }
        }
      }
    }
    if (!active) continue;

    const size_t row_i = (size_t)b * N + i;
    if (S == 4) {
      // dv_i += v_i x w3_i (the cross product commutes with the sum over j)
      const float a0 = v[(row_i * 3 + 0) * F + f];
      const float a1 = v[(row_i * 3 + 1) * F + f];
      const float a2 = v[(row_i * 3 + 2) * F + f];
      acc_v[0] += a1 * acc_w3[2] - a2 * acc_w3[1];
      acc_v[1] += a2 * acc_w3[0] - a0 * acc_w3[2];
      acc_v[2] += a0 * acc_w3[1] - a1 * acc_w3[0];
    }
    ds[row_i * F + f] = acc_s;
    dv[(row_i * 3 + 0) * F + f] = acc_v[0];
    dv[(row_i * 3 + 1) * F + f] = acc_v[1];
    dv[(row_i * 3 + 2) * F + f] = acc_v[2];
  }
}

__global__ void fused_message_bwd_kernel(
    const float* __restrict__ xyz,    // (B, N, 3)
    const float* __restrict__ mask,   // (B, N)
    const float* __restrict__ phi,    // (B, N, S, F)
    const float* __restrict__ v,      // (B, N, 3, F)
    const float* __restrict__ w,      // (RA, S, F)
    const float* __restrict__ gs,     // (B, N, F)
    const float* __restrict__ gv,     // (B, N, 3, F)
    float* __restrict__ dphi,         // (B, N, S, F)
    float* __restrict__ dv,           // (B, N, 3, F)
    float* __restrict__ dw_part,      // (B, RA, S, F)
    int N, int S, int F, int RA, float cutoff) {
  __shared__ PairChunk pc;

  const int b = blockIdx.x;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = f < F;
  const float* xb = xyz + (size_t)b * N * 3;
  const float* mb = mask + (size_t)b * N;
  const int n_chunks = (N + kChunk - 1) / kChunk;

  for (int p = 0; p < N; ++p) {
    const size_t row_p = (size_t)b * N + p;
    float vp[3] = {0.f, 0.f, 0.f};
    if (active) {
#pragma unroll
      for (int d = 0; d < 3; ++d) vp[d] = v[(row_p * 3 + d) * F + f];
    }
    float dvp[3] = {0.f, 0.f, 0.f};

    for (int c = 0; c < S; ++c) {
      float wc[kMaxRA];
#pragma unroll
      for (int r = 0; r < kMaxRA; ++r)
        wc[r] = (active && r < RA) ? w[((size_t)r * S + c) * F + f] : 0.f;
      float G[kMaxRA];        // sum_q K[p,q,r] t_c(q)
#pragma unroll
      for (int r = 0; r < kMaxRA; ++r) G[r] = 0.f;
      float dphi_c = 0.f;
      float A[3] = {0.f, 0.f, 0.f};    // sum_q filt_c gv_q (c = 0) or Gamma3_q (c = 3)
      float w3[3] = {0.f, 0.f, 0.f};   // forward w3 at p as the receiver (c = 3)

      for (int c0 = 0; c0 < n_chunks; ++c0) {
        const int q0 = c0 * kChunk;
        const int nq = min(kChunk, N - q0);
        if (n_chunks > 1 || c == 0) {
          __syncthreads();
          build_pair_chunk(pc, xb, mb, p, q0, nq, RA, cutoff);
          __syncthreads();
        }
        if (!active) continue;

        for (int qq = 0; qq < nq; ++qq) {
          if (pc.on[qq] == 0.f) continue;
          float filt = 0.f;
#pragma unroll
          for (int r = 0; r < kMaxRA; ++r) filt += pc.k[qq][r] * wc[r];
          const size_t row_q = (size_t)b * N + q0 + qq;
          float t;
          if (c == 1) {
            t = gs[row_q * F + f];
          } else {
            float g[3];
#pragma unroll
            for (int d = 0; d < 3; ++d) g[d] = gv[(row_q * 3 + d) * F + f];
            if (c == 2) {
              // unit of the pair (q <- p) is (x_p - x_q) / d = -pc.unit
              t = -(g[0] * pc.unit[qq][0] + g[1] * pc.unit[qq][1] +
                    g[2] * pc.unit[qq][2]);
            } else {
              if (c == 3) {
                float u[3];
#pragma unroll
                for (int d = 0; d < 3; ++d) u[d] = v[(row_q * 3 + d) * F + f];
                const float fp = filt * phi[(row_q * S + 3) * F + f];
                w3[0] += fp * u[0]; w3[1] += fp * u[1]; w3[2] += fp * u[2];
                // Gamma3_q = gv_q x v_q, the cotangent of w3_q
                const float c0_ = g[1] * u[2] - g[2] * u[1];
                const float c1_ = g[2] * u[0] - g[0] * u[2];
                const float c2_ = g[0] * u[1] - g[1] * u[0];
                g[0] = c0_; g[1] = c1_; g[2] = c2_;
              }
              A[0] += filt * g[0]; A[1] += filt * g[1]; A[2] += filt * g[2];
              t = g[0] * vp[0] + g[1] * vp[1] + g[2] * vp[2];
            }
          }
          dphi_c += filt * t;
#pragma unroll
          for (int r = 0; r < kMaxRA; ++r) G[r] += pc.k[qq][r] * t;
        }
      }
      if (!active) continue;

      const float phic = phi[(row_p * S + c) * F + f];
      dphi[(row_p * S + c) * F + f] = dphi_c;
      if (c == 0 || c == 3) {
        dvp[0] += phic * A[0]; dvp[1] += phic * A[1]; dvp[2] += phic * A[2];
      }
      if (c == 3) {
        // receiver side of dv_p += v_p x w3_p: d v_p = w3_p x gv_p
        float g[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) g[d] = gv[(row_p * 3 + d) * F + f];
        dvp[0] += w3[1] * g[2] - w3[2] * g[1];
        dvp[1] += w3[2] * g[0] - w3[0] * g[2];
        dvp[2] += w3[0] * g[1] - w3[1] * g[0];
      }
      for (int r = 0; r < RA; ++r) {
        float* out = dw_part + (((size_t)b * RA + r) * S + c) * F + f;
        *out = (p == 0 ? 0.f : *out) + G[r] * phic;
      }
    }
    if (!active) continue;
#pragma unroll
    for (int d = 0; d < 3; ++d) dv[(row_p * 3 + d) * F + f] = dvp[d];
  }
}

}  // namespace
}  // namespace cgvae

extern "C" int fused_message_fwd(
    const void* xyz, const void* mask, const void* phi, const void* v,
    const void* w, void* ds, void* dv, int B, int N, int S, int F, int RA,
    float cutoff, void* stream) {
  using namespace cgvae;
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((unsigned)(B * N));
  fused_message_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)mask, (const float*)phi,
      (const float*)v, (const float*)w, (float*)ds, (float*)dv,
      N, S, F, RA, cutoff);
  return (int)cudaGetLastError();
}

// dw_part is scratch of B * RA * S * F floats; dw receives its sum over B.
extern "C" int fused_message_bwd(
    const void* xyz, const void* mask, const void* phi, const void* v,
    const void* w, const void* gs, const void* gv, void* dphi, void* dv,
    void* dw_part, void* dw, int B, int N, int S, int F, int RA,
    float cutoff, void* stream) {
  using namespace cgvae;
  const cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || N <= 0)
    return (int)cudaMemsetAsync(dw, 0, sizeof(float) * RA * S * F, st);
  const dim3 grid((unsigned)B, (unsigned)((F + kThreads - 1) / kThreads));
  fused_message_bwd_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)xyz, (const float*)mask, (const float*)phi,
      (const float*)v, (const float*)w, (const float*)gs, (const float*)gv,
      (float*)dphi, (float*)dv, (float*)dw_part, N, S, F, RA, cutoff);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_sum_over_batch((const float*)dw_part, (float*)dw, B,
                               RA * S * F, st);
}
