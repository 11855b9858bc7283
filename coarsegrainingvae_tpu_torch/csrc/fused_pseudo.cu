// Fused 9-channel chirality (pseudo) message, forward and backward (f32),
// for Hopper (sm_90a).
//
// Replaces the TPU kernels coarsegrainingvae_tpu/ops/pallas_pseudo.py::
// _fwd_kernel (with _tile_forward and _geometry; launched by _fused_call)
// and ::_bwd_kernel (its hand-derived VJP, launched by _vjp_bwd). Same
// semantics as the plain versions pseudo_reference (pallas_pseudo.py:77-117)
// and pseudo_vjp_reference (coarsegrainingvae_tpu_torch/ops/fused_pseudo.py).
// With K[i,j,r] = adj*env*[rbf_1..R, 1]_r, filt_ch = sum_r K w[r,ch,f] and
// g_ch = filt_ch * phi[j,ch,f]:
//
//   ds_i    = s_i * s0_i,  s0_i = sum_j g_0
//   dsbar_i = sum_d v_i,d * t_i,d,  t_i = sum_j adj_ij vbar_j
//   dv_i    = sum_j g_1 unit_ij + a2_i + v_i x a3_i + sbar_i * a4_i
//   dvbar_i = a5_i + sbar_i * a6_i + v_i x a7_i + vbar_i x a8_i
//   a_ch,i  = sum_j g_ch x_ch,j,  x = v for ch 2, 6, 7 and vbar for 3, 4, 5, 8
//
// with the geometry of pair_geometry.cuh.
//
// Forward. What bounds it on this card: the decoder graph has M = 3 beads
// (6 for chignolin) and F = 600; at batch 64 one call reads and writes
// ~11.7 MB (~3.5 us at 3.35 TB/s) and does ~0.1 GFLOP, so it is launch- and
// latency-bound: 192 blocks of 4 warps leave most of the 132 SMs idle.
// Design: one block per (batch element, receiver bead), threads striding
// over F (coalesced loads along F); the senders' K, unit and adj are built
// once into shared memory (in chunks of 64 senders, so M is arbitrary); each
// thread walks the nine channels, keeping one channel's w[:, ch, f] column
// in registers, and accumulates the eight sender sums in registers. The
// gates and the three cross products are linear in those sums and are
// applied once at the end.
//
// Backward. Given gs, gsb (B,M,F) and gv, gvb (B,M,3,F) it writes d_phi
// (B,M,9,F), d_s, d_sbar (B,M,F), d_v, d_vbar (B,M,3,F) and d_w (R+1,9,F)
// summed over the batch; xyz and mask get no gradient (the JAX contract,
// pallas_pseudo.py:27-31). The receiver cotangents of the sums a_ch are
// Gamma_2 = gv, Gamma_3 = gv x v, Gamma_4 = sbar gv, Gamma_5 = gvb,
// Gamma_6 = sbar gvb, Gamma_7 = gvb x v, Gamma_8 = gvb x vbar
// (pallas_pseudo.py:237-245). With node p as the sender of the pair
// (q <- p), the cotangent of g_ch[q,p] is
//
//   dG_0 = s_q gs_q,  dG_1 = gv_q . unit_qp,  dG_ch = Gamma_ch(q) . x_ch,p
//   d_phi[p,ch] = sum_q filt_ch[p,q] dG_ch(q)
//   d_x_ch,p   += phi[p,ch] sum_q filt_ch Gamma_ch(q)       (sender side)
//   d_w[r,ch]   = sum_b sum_p phi[p,ch] sum_q K[p,q,r] dG_ch(q)
//
// and p as a receiver adds d_s_p = s0_p gs_p, d_sbar_p = a4_p . gv_p +
// a6_p . gvb_p, d_v_p += a3_p x gv_p + a7_p x gvb_p + gsb_p t_p and
// d_vbar_p += a8_p x gvb_p, with s0, t and a_ch recomputed as in the
// forward, and the dsbar path d_vbar_p += sum_q adj_qp gsb_q v_q. K and adj
// are symmetric, so one geometry row per node p serves both roles. As in
// fused_message.cu, d_w takes two passes: one partial per batch element
// (B x (R+1) x 9 x F floats, 24.9 MB at B = 128, F = 600), then
// sum_over_batch in a fixed order; no atomics, deterministic. Design: one
// block per (batch element, chunk of 128 features); each thread owns one
// feature column and walks the beads p, the nine channels and the partners
// q, keeping the (R+1) per-basis sums of one (p, ch) in registers. At M = 3
// the pair loop is short and the kernel is bound by latency and by the
// 9 x (R+1) read-modify-writes of its partial per bead.
//
// The TPU kernels' batch tiling, their VMEM budget (_tile_b_budget) and the
// Mosaic bead padding (_pad_beads) are not carried over: nothing on this
// card calls for them.

#include "pair_geometry.cuh"

namespace cgvae {
namespace {

constexpr int kCh = 9;

// channels whose sender payload is v (the rest of 2..8 carry vbar)
__device__ inline bool carries_v(int ch) { return ch == 2 || ch == 6 || ch == 7; }

__global__ void fused_pseudo_kernel(
    const float* __restrict__ xyz,    // (B, M, 3)
    const float* __restrict__ mask,   // (B, M)
    const float* __restrict__ phi,    // (B, M, 9, F)
    const float* __restrict__ s,      // (B, M, F)
    const float* __restrict__ sbar,   // (B, M, F)
    const float* __restrict__ v,      // (B, M, 3, F)
    const float* __restrict__ vbar,   // (B, M, 3, F)
    const float* __restrict__ w,      // (RA, 9, F)
    float* __restrict__ ds,           // (B, M, F)
    float* __restrict__ dsbar,        // (B, M, F)
    float* __restrict__ dv,           // (B, M, 3, F)
    float* __restrict__ dvbar,        // (B, M, 3, F)
    int M, int F, int RA, float cutoff) {
  __shared__ PairChunk pc;

  const int b = blockIdx.x / M;
  const int i = blockIdx.x % M;
  const float* xb = xyz + (size_t)b * M * 3;
  const float* mb = mask + (size_t)b * M;
  const int n_chunks = (M + kChunk - 1) / kChunk;

  for (int f0 = 0; f0 < F; f0 += blockDim.x) {
    const int f = f0 + threadIdx.x;
    const bool active = f < F;
    // sender sums: s0; t = sum adj vbar; dv direct (g1 unit + g2 v);
    // a3, a4 (dv gates); dvbar direct (g5 vbar); a6, a7, a8 (dvbar gates)
    float s0 = 0.f;
    float t[3] = {0.f, 0.f, 0.f};
    float dvd[3] = {0.f, 0.f, 0.f};
    float a3[3] = {0.f, 0.f, 0.f}, a4[3] = {0.f, 0.f, 0.f};
    float dvbd[3] = {0.f, 0.f, 0.f};
    float a6[3] = {0.f, 0.f, 0.f}, a7[3] = {0.f, 0.f, 0.f};
    float a8[3] = {0.f, 0.f, 0.f};

    for (int c0 = 0; c0 < n_chunks; ++c0) {
      const int j0 = c0 * kChunk;
      const int nj = min(kChunk, M - j0);
      if (n_chunks > 1 || f0 == 0) {
        __syncthreads();
        build_pair_chunk(pc, xb, mb, i, j0, nj, RA, cutoff);
        __syncthreads();
      }
      if (!active) continue;

      // dsbar: plain adjacency-weighted sum of the senders' vbar
      for (int jj = 0; jj < nj; ++jj) {
        const size_t row = (size_t)b * M + j0 + jj;
        const float a = pc.adj[jj];
        t[0] += a * vbar[(row * 3 + 0) * F + f];
        t[1] += a * vbar[(row * 3 + 1) * F + f];
        t[2] += a * vbar[(row * 3 + 2) * F + f];
      }

      for (int ch = 0; ch < kCh; ++ch) {
        float wc[kMaxRA];
#pragma unroll
        for (int r = 0; r < kMaxRA; ++r)
          wc[r] = r < RA ? w[((size_t)r * kCh + ch) * F + f] : 0.f;
        for (int jj = 0; jj < nj; ++jj) {
          if (pc.on[jj] == 0.f) continue;
          float filt = 0.f;
#pragma unroll
          for (int r = 0; r < kMaxRA; ++r) filt += pc.k[jj][r] * wc[r];
          const size_t row = (size_t)b * M + j0 + jj;
          const float g = filt * phi[(row * kCh + ch) * F + f];
          if (ch == 0) {
            s0 += g;
            continue;
          }
          if (ch == 1) {
            dvd[0] += g * pc.unit[jj][0];
            dvd[1] += g * pc.unit[jj][1];
            dvd[2] += g * pc.unit[jj][2];
            continue;
          }
          const float* x = carries_v(ch) ? v : vbar;
          const float x0 = g * x[(row * 3 + 0) * F + f];
          const float x1 = g * x[(row * 3 + 1) * F + f];
          const float x2 = g * x[(row * 3 + 2) * F + f];
          switch (ch) {
            case 2: dvd[0] += x0; dvd[1] += x1; dvd[2] += x2; break;
            case 3: a3[0] += x0; a3[1] += x1; a3[2] += x2; break;
            case 4: a4[0] += x0; a4[1] += x1; a4[2] += x2; break;
            case 5: dvbd[0] += x0; dvbd[1] += x1; dvbd[2] += x2; break;
            case 6: a6[0] += x0; a6[1] += x1; a6[2] += x2; break;
            case 7: a7[0] += x0; a7[1] += x1; a7[2] += x2; break;
            default: a8[0] += x0; a8[1] += x1; a8[2] += x2; break;
          }
        }
      }
    }
    if (!active) continue;

    const size_t row_i = (size_t)b * M + i;
    const float si = s[row_i * F + f];
    const float gi = sbar[row_i * F + f];
    float vi[3], vbi[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      vi[d] = v[(row_i * 3 + d) * F + f];
      vbi[d] = vbar[(row_i * 3 + d) * F + f];
    }
    ds[row_i * F + f] = si * s0;
    dsbar[row_i * F + f] = vi[0] * t[0] + vi[1] * t[1] + vi[2] * t[2];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int p = (d + 1) % 3, q = (d + 2) % 3;  // (a x b)_d = a_p b_q - a_q b_p
      dv[(row_i * 3 + d) * F + f] =
          dvd[d] + (vi[p] * a3[q] - vi[q] * a3[p]) + gi * a4[d];
      dvbar[(row_i * 3 + d) * F + f] =
          dvbd[d] + gi * a6[d] + (vi[p] * a7[q] - vi[q] * a7[p]) +
          (vbi[p] * a8[q] - vbi[q] * a8[p]);
    }
  }
}

// c += a x b
__device__ inline void add_cross(float* c, const float* a, const float* b) {
  c[0] += a[1] * b[2] - a[2] * b[1];
  c[1] += a[2] * b[0] - a[0] * b[2];
  c[2] += a[0] * b[1] - a[1] * b[0];
}

__global__ void fused_pseudo_bwd_kernel(
    const float* __restrict__ xyz,    // (B, M, 3)
    const float* __restrict__ mask,   // (B, M)
    const float* __restrict__ phi,    // (B, M, 9, F)
    const float* __restrict__ s,      // (B, M, F)
    const float* __restrict__ sbar,   // (B, M, F)
    const float* __restrict__ v,      // (B, M, 3, F)
    const float* __restrict__ vbar,   // (B, M, 3, F)
    const float* __restrict__ w,      // (RA, 9, F)
    const float* __restrict__ gs,     // (B, M, F)
    const float* __restrict__ gsb,    // (B, M, F)
    const float* __restrict__ gv,     // (B, M, 3, F)
    const float* __restrict__ gvb,    // (B, M, 3, F)
    float* __restrict__ dphi,         // (B, M, 9, F)
    float* __restrict__ d_s,          // (B, M, F)
    float* __restrict__ d_sbar,       // (B, M, F)
    float* __restrict__ d_v,          // (B, M, 3, F)
    float* __restrict__ d_vbar,       // (B, M, 3, F)
    float* __restrict__ dw_part,      // (B, RA, 9, F)
    int M, int F, int RA, float cutoff) {
  __shared__ PairChunk pc;

  const int b = blockIdx.x;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = f < F;
  const float* xb = xyz + (size_t)b * M * 3;
  const float* mb = mask + (size_t)b * M;
  const int n_chunks = (M + kChunk - 1) / kChunk;

  for (int p = 0; p < M; ++p) {
    const size_t row_p = (size_t)b * M + p;
    float vp[3] = {0.f, 0.f, 0.f}, vbp[3] = {0.f, 0.f, 0.f};
    float gvp[3] = {0.f, 0.f, 0.f}, gvbp[3] = {0.f, 0.f, 0.f};
    if (active) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        vp[d] = v[(row_p * 3 + d) * F + f];
        vbp[d] = vbar[(row_p * 3 + d) * F + f];
        gvp[d] = gv[(row_p * 3 + d) * F + f];
        gvbp[d] = gvb[(row_p * 3 + d) * F + f];
      }
    }
    float dvp[3] = {0.f, 0.f, 0.f}, dvbp[3] = {0.f, 0.f, 0.f};
    float dsbp = 0.f;

    for (int ch = 0; ch < kCh; ++ch) {
      float wc[kMaxRA];
#pragma unroll
      for (int r = 0; r < kMaxRA; ++r)
        wc[r] = (active && r < RA) ? w[((size_t)r * kCh + ch) * F + f] : 0.f;
      float G[kMaxRA];        // sum_q K[p,q,r] dG_ch(q)
#pragma unroll
      for (int r = 0; r < kMaxRA; ++r) G[r] = 0.f;
      float dphi_c = 0.f;
      float bx[3] = {0.f, 0.f, 0.f};   // sum_q filt Gamma_ch(q)
      float fw[3] = {0.f, 0.f, 0.f};   // forward a_ch at p (or t_p, ch 0)
      float s0 = 0.f;                  // forward s0 at p (ch 0)

      for (int c0 = 0; c0 < n_chunks; ++c0) {
        const int q0 = c0 * kChunk;
        const int nq = min(kChunk, M - q0);
        if (n_chunks > 1 || ch == 0) {
          __syncthreads();
          build_pair_chunk(pc, xb, mb, p, q0, nq, RA, cutoff);
          __syncthreads();
        }
        if (!active) continue;

        for (int qq = 0; qq < nq; ++qq) {
          const size_t row_q = (size_t)b * M + q0 + qq;
          if (ch == 0 && pc.adj[qq] != 0.f) {
            // dsbar path, both roles: t_p and d_vbar_p += adj gsb_q v_q
            const float a = pc.adj[qq];
            const float ag = a * gsb[row_q * F + f];
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              fw[d] += a * vbar[(row_q * 3 + d) * F + f];
              dvbp[d] += ag * v[(row_q * 3 + d) * F + f];
            }
          }
          if (pc.on[qq] == 0.f) continue;
          float filt = 0.f;
#pragma unroll
          for (int r = 0; r < kMaxRA; ++r) filt += pc.k[qq][r] * wc[r];
          float dG;
          if (ch == 0) {
            dG = s[row_q * F + f] * gs[row_q * F + f];
            s0 += filt * phi[(row_q * kCh) * F + f];
          } else if (ch == 1) {
            // unit of the pair (q <- p) is (x_p - x_q) / d = -pc.unit
            dG = 0.f;
#pragma unroll
            for (int d = 0; d < 3; ++d) dG -= gv[(row_q * 3 + d) * F + f] * pc.unit[qq][d];
          } else {
            // Gamma_ch(q), the cotangent of a_ch at q
            const bool vb_side = ch >= 5;             // from gvb, else gv
            const float* gsrc = vb_side ? gvb : gv;
            float gam[3];
#pragma unroll
            for (int d = 0; d < 3; ++d) gam[d] = gsrc[(row_q * 3 + d) * F + f];
            if (ch == 4 || ch == 6) {
              const float sb = sbar[row_q * F + f];
              gam[0] *= sb; gam[1] *= sb; gam[2] *= sb;
            } else if (ch == 3 || ch == 7 || ch == 8) {
              const float* xs = ch == 8 ? vbar : v;  // Gamma = g x v (x vbar for 8)
              float u[3], c[3] = {0.f, 0.f, 0.f};
#pragma unroll
              for (int d = 0; d < 3; ++d) u[d] = xs[(row_q * 3 + d) * F + f];
              add_cross(c, gam, u);
              gam[0] = c[0]; gam[1] = c[1]; gam[2] = c[2];
            }
            const float* xp = carries_v(ch) ? vp : vbp;
            dG = gam[0] * xp[0] + gam[1] * xp[1] + gam[2] * xp[2];
            bx[0] += filt * gam[0]; bx[1] += filt * gam[1]; bx[2] += filt * gam[2];
            if (ch != 2 && ch != 5) {
              // forward a_ch at p as the receiver
              const float* x = carries_v(ch) ? v : vbar;
              const float fp = filt * phi[(row_q * kCh + ch) * F + f];
#pragma unroll
              for (int d = 0; d < 3; ++d) fw[d] += fp * x[(row_q * 3 + d) * F + f];
            }
          }
          dphi_c += filt * dG;
#pragma unroll
          for (int r = 0; r < kMaxRA; ++r) G[r] += pc.k[qq][r] * dG;
        }
      }
      if (!active) continue;

      const float phic = phi[(row_p * kCh + ch) * F + f];
      dphi[(row_p * kCh + ch) * F + f] = dphi_c;
      for (int r = 0; r < RA; ++r) {
        float* out = dw_part + (((size_t)b * RA + r) * kCh + ch) * F + f;
        *out = (p == 0 ? 0.f : *out) + G[r] * phic;
      }
      if (ch >= 2) {
        float* dx = carries_v(ch) ? dvp : dvbp;
        dx[0] += phic * bx[0]; dx[1] += phic * bx[1]; dx[2] += phic * bx[2];
      }
      switch (ch) {
        case 0: {
          const float gsbp = gsb[row_p * F + f];
          d_s[row_p * F + f] = s0 * gs[row_p * F + f];
          dvp[0] += gsbp * fw[0]; dvp[1] += gsbp * fw[1]; dvp[2] += gsbp * fw[2];
          break;
        }
        case 3: add_cross(dvp, fw, gvp); break;
        case 4: dsbp += fw[0] * gvp[0] + fw[1] * gvp[1] + fw[2] * gvp[2]; break;
        case 6: dsbp += fw[0] * gvbp[0] + fw[1] * gvbp[1] + fw[2] * gvbp[2]; break;
        case 7: add_cross(dvp, fw, gvbp); break;
        case 8: add_cross(dvbp, fw, gvbp); break;
        default: break;
      }
    }
    if (!active) continue;
    d_sbar[row_p * F + f] = dsbp;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      d_v[(row_p * 3 + d) * F + f] = dvp[d];
      d_vbar[(row_p * 3 + d) * F + f] = dvbp[d];
    }
  }
}

}  // namespace
}  // namespace cgvae

extern "C" int fused_pseudo_fwd(
    const void* xyz, const void* mask, const void* phi, const void* s,
    const void* sbar, const void* v, const void* vbar, const void* w,
    void* ds, void* dsbar, void* dv, void* dvbar, int B, int M, int F,
    int RA, float cutoff, void* stream) {
  using namespace cgvae;
  if (B <= 0 || M <= 0) return 0;
  const dim3 grid((unsigned)(B * M));
  fused_pseudo_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)mask, (const float*)phi,
      (const float*)s, (const float*)sbar, (const float*)v,
      (const float*)vbar, (const float*)w, (float*)ds, (float*)dsbar,
      (float*)dv, (float*)dvbar, M, F, RA, cutoff);
  return (int)cudaGetLastError();
}

// dw_part is scratch of B * RA * 9 * F floats; dw receives its sum over B.
extern "C" int fused_pseudo_bwd(
    const void* xyz, const void* mask, const void* phi, const void* s,
    const void* sbar, const void* v, const void* vbar, const void* w,
    const void* gs, const void* gsb, const void* gv, const void* gvb,
    void* dphi, void* d_s, void* d_sbar, void* d_v, void* d_vbar,
    void* dw_part, void* dw, int B, int M, int F, int RA, float cutoff,
    void* stream) {
  using namespace cgvae;
  const cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || M <= 0)
    return (int)cudaMemsetAsync(dw, 0, sizeof(float) * RA * kCh * F, st);
  const dim3 grid((unsigned)B, (unsigned)((F + kThreads - 1) / kThreads));
  fused_pseudo_bwd_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)xyz, (const float*)mask, (const float*)phi,
      (const float*)s, (const float*)sbar, (const float*)v,
      (const float*)vbar, (const float*)w, (const float*)gs,
      (const float*)gsb, (const float*)gv, (const float*)gvb, (float*)dphi,
      (float*)d_s, (float*)d_sbar, (float*)d_v, (float*)d_vbar,
      (float*)dw_part, M, F, RA, cutoff);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_sum_over_batch((const float*)dw_part, (float*)dw, B,
                               RA * kCh * F, st);
}
