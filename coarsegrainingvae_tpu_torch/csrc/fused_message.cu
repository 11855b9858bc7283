// Fused factored PaiNN message, forward and backward (f32), for Hopper
// (sm_90a).
//
// Replaces the TPU kernels coarsegrainingvae_tpu/ops/pallas_message.py::
// _fused_kernel (forward, :126-199, launched by _fused_call) and ::_bwd_kernel
// (its hand-derived VJP, :202-342, launched by _bwd_call). Same semantics as
// the plain versions message_reference and message_vjp_reference
// (coarsegrainingvae_tpu_torch/ops/fused_message.py):
//
//   K[i,j,r] = adj_ij * env(d_ij) * [rbf_1..R(d_ij), 1]_r
//   filt_c   = sum_r K[i,j,r] w[r,c,f]
//   ds_i     = sum_j filt_1 phi[j,1]
//   dv_i     = sum_j filt_2 unit_ij phi[j,2] + sum_j filt_0 phi[j,0] v_j
//            (+ v_i x w3_i,  w3_i = sum_j filt_3 phi[j,3] v_j   when S == 4)
//
// with r_ij = x_j - x_i, d = sqrt(|r|^2 + 1e-3), unit = r / d and
// adj = (d < cutoff) * (i != j) * mask_i * mask_j. The backward takes the
// cotangents gs (B,N,F), gv (B,N,3,F) and writes d_phi (B,N,S,F), d_v
// (B,N,3,F) and d_w (R+1,S,F) summed over the batch; xyz and mask get no
// gradient (pallas_message.py:38-42). With node p the sender of the pair
// (q <- p) and t_c(q) the cotangent that pair hands channel c:
//
//   t_1 = gs_q,   t_2 = gv_q . unit_qp,   t_0 = gv_q . v_p,
//   t_3 = (gv_q x v_q) . v_p
//   d_phi[p,c] = sum_q filt_c[p,q] t_c(q)
//   d_v_p      = phi[p,0] sum_q filt_0 gv_q + phi[p,3] sum_q filt_3 (gv_q x v_q)
//              + w3_p x gv_p                       (receiver side of the cross)
//   d_w[r,c]   = sum_b sum_p sum_q K[p,q,r] phi[p,c] t_c(q)
//
// K is symmetric and unit antisymmetric, so one geometry record per (p, q)
// serves a node in either role, as in the TPU kernel.
//
// What bounds them on this card (chip_smoke.py::kernel_cost, the least
// work of the function: K is symmetric, so each unordered pair's filter and
// its d_w chain count once). At the encoder's shape (B 128, N 27, S 3,
// F 600, R+1 9; 702 interacting ordered pairs per batch element) the forward
// moves 83 MB (25 us at 3.35 TB/s) and does 2.3 GFLOP (35 us at the
// 67 TFLOP/s FP32 rate); the backward moves 133 MB (40 us) and does 4.3
// GFLOP (65 us). Both are bound by the FP32 rate, and nearly every useful
// operation is a fused multiply-add, so the design keeps the FMA pipes fed:
// no padded basis, no global or L2 traffic on the pair loop's critical path,
// independent work in each warp.
//
// Design, all the kernels:
// - A block owns one batch element b, a tile of rows (receivers in the
//   forward, nodes p in the backward) and 32 features, one per lane. Warps
//   run along f, so each per-node read is one coalesced 128-byte line and
//   each geometry read is a shared-memory broadcast. F = 600 is 19 tiles of
//   32 with 8 idle lanes in the last (1.3 %).
// - The block stages its batch element's coordinates and mask, then builds
//   the geometry of its pairs once, in shared memory: per pair the R+1
//   values K[r] and the unit vector, padded to a multiple of 4 floats and
//   read as float4 (12 floats at R+1 = 9), by pair_geometry.cuh::pair_record,
//   which the pseudo kernels share. One rsqrtf and one __sincosf per pair;
//   the radial sines follow by the angle-addition recurrence (relative error
//   ~3e-6 against the plain version's sin per basis, far inside its 1e-4
//   gate).
// - R+1 and S are template parameters (the C entry points switch over R+1
//   in 2..16 and S in {3, 4}): the basis loops unroll with no zero padding
//   and w[:, :, f] lives in registers.
// - R+1 > 16 (the wide kernels, fused_message_wide_kernel and
//   fused_message_bwd_wide_kernel): R+1 is a runtime value, cut into the
//   fewest chunks of at most kWideChunk = 12 functions, all of one width C
//   in 9..12 (a template parameter; the last chunk zero-padded: R+1 = 21 is
//   two chunks of 11). The message is linear in the filter, so each chunk
//   adds its share to the node sums, which stay in registers across the
//   chunks; w[:, :, f] and the backward's d_w sums of one chunk live in
//   registers as in the templated kernels. Each chunk's records are built
//   once per block by pair_geometry.cuh::chunk_record: an accurate
//   sincospif at the chunk's first angle, then at most 11 recurrence steps,
//   so the error does not grow with R; past R+1 = 32 each function rounded
//   as the plain version rounds it (the template flag E; the header says
//   why). The forward is the tiled forward
//   below, chunk by chunk. The backward gives each warp kBwdTogether = 3
//   nodes (3 warps, 9 nodes per block), so their sums stay in registers
//   across the chunks, and writes one d_w partial per (b, node tile of 9,
//   feature) chunk by chunk: fused_message_bwd_partials sizes the scratch.
//   Nothing per basis function sits in shared memory, so the card sets no
//   bound on R+1: the wrapper takes any, and the tests hold the kernels up
//   to R+1 = 513. ptxas at C = 11: forward 128 / 164 registers (S = 3 / 4),
//   backward 168 / 228, no spills (126-168 and 154-233 over C = 9..12). At
//   B 128, N 27, S 3, n_rbf 20 the forward takes 0.332 ms and the backward
//   0.682 ms, 15 / 14 % of their FP32 bound, where the earlier wide
//   kernels (one warp per (32 features, frame), the pair's basis rebuilt
//   per lane with one sinf per function, w and d_w in shared memory) took
//   3.466 / 6.595 ms (scripts/kernel_ab.py, one H100 80GB HBM3 at 700 W;
//   PERF.md).
// Forward, S = 3 and N <= 27 (the encoder and the prior; fused_message_sym_
//   kernel): K is symmetric and unit antisymmetric, so each unordered pair's
//   folded filter serves both directions: 3 (R+1) + 18 FMAs per pair instead
//   of 2 (3 (R+1) + 9). Each warp holds a group of 9 nodes' payloads and sums
//   in registers and takes the pairs inside its group and those between its
//   group and the next; the sums that land in another warp's group pass
//   through shared memory, one writer per node. Why a second forward: at
//   B 128, N 27, S 3 it takes 0.1046 ms where the tiled kernel takes
//   0.1297 ms, and the two are equal at M 3 (scripts/kernel_ab.py against
//   this source with the dispatch to it switched off, one H100 80GB HBM3
//   at 700 W).
// Forward, otherwise (fused_message_kernel): each thread keeps the sums of 9
//   receivers in registers, so a sender's payload, read once, feeds all nine.
//   Each warp streams the senders' payloads through a private 3-slot ring in
//   shared memory with cp.async, two senders ahead; partner chunks of 32
//   cover any N (the cross decoder's N = 209).
// Backward: each warp owns 9 nodes p (3 warps cover N = 27) and takes them
//   three at a time against every partner q, so a partner's row, read once,
//   feeds three nodes' independent sums. The partners' cotangent rows (gs,
//   gv, and for S = 4 gv x v and phi_3 v) are staged per chunk with cp.async
//   while the geometry is built, and read as float4. Each thread keeps its
//   share of d_w, the sum over its nodes and partners of K[r] phi[p,c] t_c,
//   in registers; the block adds its warps' sums through shared memory in a
//   fixed order and writes one partial per (b, node tile, feature), and
//   sum_over_batch adds the partials in a fixed order. No atomics: d_w is
//   deterministic.
// Forward, S = 3, R+1 <= 16 and N >= kTcMinN (chignolin's encoder on its
//   209 atoms; fused_message_tc_kernel; fused_message_route says which
//   launches take it): under a 25-A cutoff every ordered pair interacts,
//   and the tiled kernel spends 33 of its 41 FMAs per pair and feature
//   folding the filter, filt_c = sum_r K[r] w[r, c]. Here the fold runs on
//   the tensor cores as 3xTF32 m16n8k8 MMAs: A = w^T (a warp's 16 features
//   x 8 basis functions a step, split once into registers), B = K^T (8
//   basis functions x 8 receivers, one sender's records), C = filt (16
//   features x 8 receivers). Each f32 operand is split into a TF32 high
//   and low part (cvt.rna), and lo x hi, hi x lo, hi x hi are accumulated
//   in f32: within ~1e-6 of max|ref|, where single-pass TF32 reads 2.9-4.6e-4
//   at N 209 (tests/test_torch_message_tc.py), past the 1e-4 gate; no bf16.
//   The message stays on the FMA pipes (9 per pair and feature). A block
//   owns kTcTiles x 8 receivers and 64 features and walks the senders in
//   chunks of kTcCols, staged by 16-byte cp.async (their payload rows) and
//   built once per block (pair_geometry.cuh::pair_basis: K[r][i] and
//   unit[d][i], 19 floats per pair); nothing of size N^2 leaves the chip.
//   Per ordered pair and feature the fold is 3 channels x 16 basis slots x
//   3 passes = 144 tensor-core MACs, bound in time like the FMA fold's 33
//   FMAs: mma.sync does not reach the card's TF32 rate (~9 cycles an
//   m16n8k8 MMA per sub-partition here), and the gain comes as much from
//   the structure around it. Where it engages, and why kTcMinN = 33
//   (scripts/kernel_ab.py --nodes, B 16, S 3, R+1 11, cutoff 25, F 600,
//   one H100 80GB HBM3 at 700 W; the tiled kernel -> this one, ms): N 33
//   0.0549 -> 0.0414, N 48 0.1132 -> 0.0581, N 64 0.1558 -> 0.0907, N 128
//   0.5093 -> 0.3461, N 209 1.1720 -> 0.9315 (32.6 % of its 0.3038-ms
//   FP32 bound, chip_smoke.py::kernel_cost); faster from the first N the
//   symmetric kernel leaves (N <= 27 keeps it), so the threshold is the
//   least allowed.
// Left out, and why:
// - The backward on the tensor cores. A 3xTF32 backward (the fold as here,
//   d_w[r, c] = sum_pairs K[p, q, r] phi[p, c] t_c as MMAs with the fold's
//   C fragment as the A fragment, one partial per (b, node tile)) was
//   within 1.1e-6 of max|ref| but took 2.37-2.46 ms at N 209 against the
//   templated kernel's 2.41 (its 288 tensor-core MACs and ~36 ALU
//   operations per pair and feature against ~81 FMAs), so the backward
//   keeps its kernel at every N.
// - K's symmetry in the backward: one pair would need both nodes' inputs
//   (v, phi, gs, gv) and sums (d_phi, d_v) at once, some 16 registers per
//   node beyond the 9-node group's, more than a thread holds.

#include <algorithm>
#include <cstdint>

#include "pair_geometry.cuh"

namespace cgvae {
namespace {

constexpr int kLanes = 32;        // features per block, one per lane
constexpr int kCols = 32;         // partner nodes per shared-memory chunk
constexpr int kFwdRows = 9;       // receivers per thread (forward)
constexpr int kFwdMaxWarps = 4;
constexpr int kRing = 3;          // senders in flight per warp (forward)
constexpr int kBwdRows = 9;       // nodes per warp (backward)
constexpr int kBwdTogether = 3;   // of which a warp takes this many at once
constexpr int kBwdMaxWarps = 3;
constexpr int kSymRows = 9;       // nodes per warp group (symmetric forward)
constexpr int kSymGroups = 3;     // so it covers N <= 27
constexpr int kWideBwdWarps = 3;  // warps per block of the wide backward, kBwdTogether nodes each
constexpr int kTcWarps = 4;       // warps per block of the tensor-core forward, 16 features each
constexpr int kTcF = 16 * kTcWarps;   // features per block (tensor cores)
constexpr int kTcKR = 16;         // basis slots per pair record (tensor cores), zero past R+1
constexpr int kTcK = 8;           // basis functions per fold MMA (m16n8k8)
constexpr int kTcTiles = 2;       // tiles of 8 receivers (the MMAs' n) per block (tensor cores)
constexpr int kTcCols = 16;       // senders per staged chunk (tensor cores)
constexpr int kTcMinN = 33;       // the tensor-core forward takes N >= kTcMinN (the note at the top)

// Stage one batch element's coordinates and mask, (x, y, z, m) per node.
__device__ __forceinline__ void stage_nodes(float4* __restrict__ nodes,
                                            const float* __restrict__ xb,
                                            const float* __restrict__ mb, int N) {
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    nodes[n] = make_float4(xb[n * 3 + 0], xb[n * 3 + 1], xb[n * 3 + 2], mb[n]);
}

// filt[c] = sum_r K[r] w[r][c]
template <int RA, int S, int W>
__device__ __forceinline__ void fold(float (&filt)[S], const float (&g)[W],
                                     const float (&wr)[RA][S]) {
#pragma unroll
  for (int c = 0; c < S; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < RA; ++r) acc = fmaf(g[r], wr[r][c], acc);
    filt[c] = acc;
  }
}

template <int RA, int S>
__global__ void __launch_bounds__(kLanes * kFwdMaxWarps,
                                  S * RA + kFwdRows * (S == 4 ? 7 : 4) <= 72 ? 4 : 2)
fused_message_kernel(
    const float* __restrict__ xyz,    // (B, N, 3)
    const float* __restrict__ mask,   // (B, N)
    const float* __restrict__ phi,    // (B, N, S, F)
    const float* __restrict__ v,      // (B, N, 3, F)
    const float* __restrict__ w,      // (RA, S, F)
    float* __restrict__ ds,           // (B, N, F)
    float* __restrict__ dv,           // (B, N, 3, F)
    int N, int F, float cutoff) {
  constexpr int W = record_width(RA);
  constexpr int P = S + 3;            // payload floats per sender: phi[j, :], v[j, :]
  constexpr int kCross = S == 4 ? kFwdRows : 1;
  extern __shared__ float4 smem[];

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int rows = blockDim.x / kLanes * kFwdRows;
  const int cols = min(N, kCols);
  const int b = blockIdx.z, i0 = blockIdx.y * rows;
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const float pi_c = kPi / cutoff;
  float4* nodes = smem;                               // (N): x, y, z, mask
  float* geo = reinterpret_cast<float*>(smem + N);    // (rows, chunk, W)
  // this warp's ring of sender payloads, (slot, P, lane), at this lane
  float* ring = geo + rows * cols * W + warp * kRing * P * kLanes + lane;
  const float* xb = xyz + (size_t)b * N * 3;
  const float* mb = mask + (size_t)b * N;
  const float* phib = phi + (size_t)b * N * S * F + f;
  const float* vb = v + (size_t)b * N * 3 * F + f;

  float wr[RA][S];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) wr[r][c] = w[((size_t)r * S + c) * F + f];
  float acc_s[kFwdRows], acc_v[kFwdRows][3], acc_w3[kCross][3];
#pragma unroll
  for (int k = 0; k < kFwdRows; ++k) {
    acc_s[k] = 0.f;
    acc_v[k][0] = acc_v[k][1] = acc_v[k][2] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < kCross; ++k) acc_w3[k][0] = acc_w3[k][1] = acc_w3[k][2] = 0.f;

  stage_nodes(nodes, xb, mb, N);
  for (int j0 = 0; j0 < N; j0 += kCols) {
    const int nc = min(kCols, N - j0);
    // sender jj's payload into ring slot jj % kRing, one commit group each
    auto stage = [&](int jj) {
      if (jj < nc) {
        float* dst = ring + (jj % kRing) * P * kLanes;
        const size_t j = j0 + jj;
#pragma unroll
        for (int c = 0; c < S; ++c) cp_async4(dst + c * kLanes, phib + (j * S + c) * F);
#pragma unroll
        for (int d = 0; d < 3; ++d) cp_async4(dst + (S + d) * kLanes, vb + (j * 3 + d) * F);
      }
      cp_async_commit();
    };
    __syncthreads();                  // the nodes are staged; the previous chunk's readers are done
#pragma unroll
    for (int jj = 0; jj < kRing - 1; ++jj) stage(jj);   // in flight while the geometry is built
    for (int t = threadIdx.x; t < rows * nc; t += blockDim.x)
      pair_record<RA>(geo + t * W, nodes, i0 + t / nc, j0 + t % nc, N, cutoff, pi_c);
    __syncthreads();

    const float* rec0 = geo + warp * kFwdRows * nc * W;
    for (int jj = 0; jj < nc; ++jj) {
      stage(jj + kRing - 1);
      cp_async_wait<kRing - 1>();     // sender jj has landed (each lane reads its own copies)
      float pay[P];
      const float* src = ring + (jj % kRing) * P * kLanes;
#pragma unroll
      for (int e = 0; e < P; ++e) pay[e] = src[e * kLanes];
#pragma unroll
      for (int k = 0; k < kFwdRows; ++k) {
        float g[W];
        load_record(g, rec0 + (k * nc + jj) * W);
        float filt[S];
        fold<RA, S>(filt, g, wr);
        acc_s[k] = fmaf(filt[1], pay[1], acc_s[k]);
        const float p0 = filt[0] * pay[0], p2 = filt[2] * pay[2];
#pragma unroll
        for (int d = 0; d < 3; ++d)
          acc_v[k][d] = fmaf(p2, g[RA + d], fmaf(p0, pay[S + d], acc_v[k][d]));
        if constexpr (S == 4) {
          const float p3 = filt[3] * pay[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) acc_w3[k][d] = fmaf(p3, pay[S + d], acc_w3[k][d]);
        }
      }
    }
  }
  if (f_out >= F) return;

#pragma unroll
  for (int k = 0; k < kFwdRows; ++k) {
    const int i = i0 + warp * kFwdRows + k;
    if (i >= N) break;
    const size_t row = (size_t)b * N + i;
    float o[3] = {acc_v[k][0], acc_v[k][1], acc_v[k][2]};
    if constexpr (S == 4) {
      // dv_i += v_i x w3_i (the cross product commutes with the sum over j)
      const float a0 = v[(row * 3 + 0) * F + f];
      const float a1 = v[(row * 3 + 1) * F + f];
      const float a2 = v[(row * 3 + 2) * F + f];
      o[0] += a1 * acc_w3[k][2] - a2 * acc_w3[k][1];
      o[1] += a2 * acc_w3[k][0] - a0 * acc_w3[k][2];
      o[2] += a0 * acc_w3[k][1] - a1 * acc_w3[k][0];
    }
    ds[row * F + f] = acc_s[k];
#pragma unroll
    for (int d = 0; d < 3; ++d) dv[(row * 3 + d) * F + f] = o[d];
  }
}

// Forward for S = 3 and N <= 27, each unordered pair once (the note at the
// top). Warp g takes the pairs inside node group g and, as rows, the tile
// between group g and group g+1 mod 3 (with two groups warp 0 takes the
// 0-1 tile). Grid (F/32, 1, B).
template <int RA>
__global__ void __launch_bounds__(kLanes * kSymGroups, 4)
fused_message_sym_kernel(
    const float* __restrict__ xyz,    // (B, N, 3)
    const float* __restrict__ mask,   // (B, N)
    const float* __restrict__ phi,    // (B, N, 3, F)
    const float* __restrict__ v,      // (B, N, 3, F)
    const float* __restrict__ w,      // (RA, 3, F)
    float* __restrict__ ds,           // (B, N, F)
    float* __restrict__ dv,           // (B, N, 3, F)
    int N, int F, float cutoff) {
  constexpr int S = 3, P = 6, W = record_width(RA);
  constexpr int G9 = kSymRows, kDiag = G9 * (G9 - 1) / 2, kTile = kDiag + G9 * G9;
  extern __shared__ float4 smem[];

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int groups = blockDim.x / kLanes;
  const int b = blockIdx.z, g0 = warp * G9;
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const float pi_c = kPi / cutoff;
  // the column group of each warp's off-diagonal tile, or -1
  auto column_group = [groups](int g) {
    return groups == 3 ? (g + 1) % 3 : (groups == 2 && g == 0 ? 1 : -1);
  };
  float4* nodes = smem;                                // (N): x, y, z, mask
  float* geo = reinterpret_cast<float*>(smem + N);     // (warp, kTile, W)
  float* xacc = geo + groups * kTile * W;              // (node, 4, lane)
  const float* xb = xyz + (size_t)b * N * 3;
  const float* mb = mask + (size_t)b * N;
  const float* phib = phi + (size_t)b * N * S * F + f;
  const float* vb = v + (size_t)b * N * 3 * F + f;

  float wr[RA][S];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) wr[r][c] = w[((size_t)r * S + c) * F + f];
  auto load_payload = [&](int n, float (&pay)[P]) {
#pragma unroll
    for (int c = 0; c < S; ++c) pay[c] = n < N ? phib[((size_t)n * S + c) * F] : 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) pay[S + d] = n < N ? vb[((size_t)n * 3 + d) * F] : 0.f;
  };
  float pa[G9][P], acc[G9][4];        // the group's payloads and sums (ds, dv)
#pragma unroll
  for (int a = 0; a < G9; ++a) {
    load_payload(g0 + a, pa[a]);
    acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;
  }

  stage_nodes(nodes, xb, mb, N);
  __syncthreads();
  // records: per warp the pairs a < b' of its group, then its a x j tile
  for (int t = threadIdx.x; t < groups * kTile; t += blockDim.x) {
    const int wg = t / kTile;
    int e = t % kTile, p, q;
    if (e < kDiag) {
      int a = 0;
      while (e >= G9 - 1 - a) e -= G9 - 1 - a, ++a;
      p = wg * G9 + a;
      q = p + 1 + e;
    } else {
      const int h = column_group(wg);
      p = h < 0 ? N : wg * G9 + (e - kDiag) / G9;
      q = h < 0 ? N : h * G9 + (e - kDiag) % G9;
    }
    pair_record<RA>(geo + t * W, nodes, p, q, N, cutoff, pi_c);
  }
  __syncthreads();

  // one pair: receiver x gets sender y's payload along +unit, y gets x's
  // along -unit
  auto pair = [&](const float* rec, const float (&px)[P], const float (&py)[P],
                  float (&ax)[4], float (&ay)[4]) {
    float g[W];
    load_record(g, rec);
    float filt[S];
    fold<RA, S>(filt, g, wr);
    ax[0] = fmaf(filt[1], py[1], ax[0]);
    ay[0] = fmaf(filt[1], px[1], ay[0]);
    const float y0 = filt[0] * py[0], y2 = filt[2] * py[2];
    const float x0 = filt[0] * px[0], x2 = filt[2] * px[2];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      ax[1 + d] = fmaf(y2, g[RA + d], fmaf(y0, py[S + d], ax[1 + d]));
      ay[1 + d] = fmaf(-x2, g[RA + d], fmaf(x0, px[S + d], ay[1 + d]));
    }
  };

  const float* rec = geo + warp * kTile * W;
#pragma unroll
  for (int a = 0; a < G9 - 1; ++a) {
    if (g0 + a + 1 >= N) break;
#pragma unroll
    for (int c = a + 1; c < G9; ++c) {
      if (g0 + c >= N) break;
      pair(rec + (a * (2 * G9 - 1 - a) / 2 + c - a - 1) * W, pa[a], pa[c], acc[a], acc[c]);
    }
  }
  const int h = column_group(warp);
  if (h >= 0) {
    float pj[P];
    load_payload(h * G9, pj);
    for (int jj = 0; jj < G9 && h * G9 + jj < N; ++jj) {
      float nxt[P];
      load_payload(h * G9 + jj + 1, nxt);
      float aj[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < G9; ++a)
        pair(rec + (kDiag + a * G9 + jj) * W, pa[a], pj, acc[a], aj);
#pragma unroll
      for (int e = 0; e < 4; ++e) xacc[((h * G9 + jj) * 4 + e) * kLanes + lane] = aj[e];
#pragma unroll
      for (int e = 0; e < P; ++e) pj[e] = nxt[e];
    }
  }
  __syncthreads();

  // the group's sums from the other warp's tile, if one has it as columns
  const bool receives = groups == 3 || (groups == 2 && warp == 1);
  if (f_out >= F) return;
#pragma unroll
  for (int a = 0; a < G9; ++a) {
    const int i = g0 + a;
    if (i >= N) break;
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = acc[a][e] + (receives ? xacc[(i * 4 + e) * kLanes + lane] : 0.f);
    const size_t row = (size_t)b * N + i;
    ds[row * F + f] = o[0];
#pragma unroll
    for (int d = 0; d < 3; ++d) dv[(row * 3 + d) * F + f] = o[1 + d];
  }
}

template <int RA, int S>
__global__ void __launch_bounds__(kLanes * kBwdMaxWarps, S * RA <= 30 ? 4 : 2)
fused_message_bwd_kernel(
    const float* __restrict__ xyz,    // (B, N, 3)
    const float* __restrict__ mask,   // (B, N)
    const float* __restrict__ phi,    // (B, N, S, F)
    const float* __restrict__ v,      // (B, N, 3, F)
    const float* __restrict__ w,      // (RA, S, F)
    const float* __restrict__ gs,     // (B, N, F)
    const float* __restrict__ gv,     // (B, N, 3, F)
    float* __restrict__ dphi,         // (B, N, S, F)
    float* __restrict__ dv,           // (B, N, 3, F)
    float* __restrict__ dw_part,      // (B, node tiles, RA, S, F)
    int N, int F, float cutoff) {
  constexpr int W = record_width(RA);
  extern __shared__ float4 smem[];

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int n_warps = blockDim.x / kLanes, rows = n_warps * kBwdRows;
  const int b = blockIdx.z, p0 = blockIdx.y * rows;
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const int cols = min(N, kCols);
  const float pi_c = kPi / cutoff;
  float4* nodes = smem;                               // (N): x, y, z, mask
  float* geo = reinterpret_cast<float*>(smem + N);    // (rows, chunk, W)
  // partner rows, float4 (e, chunk, lane): e = 0 (gs, gv), and for S = 4
  // e = 1 (gv x v, phi_3 v_0), e = 2 (phi_3 v_1, phi_3 v_2, -, -)
  float4* part = smem + N + rows * cols * W / 4;
  const float* xb = xyz + (size_t)b * N * 3;
  const float* mb = mask + (size_t)b * N;
  const float* phib = phi + (size_t)b * N * S * F + f;
  const float* vb = v + (size_t)b * N * 3 * F + f;
  const float* gsb = gs + (size_t)b * N * F + f;
  const float* gvb = gv + (size_t)b * N * 3 * F + f;

  float wr[RA][S], dw[RA][S];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) {
      wr[r][c] = w[((size_t)r * S + c) * F + f];
      dw[r][c] = 0.f;
    }
  const int n_chunks = (N + kCols - 1) / kCols;
  stage_nodes(nodes, xb, mb, N);      // read after the first __syncthreads below

  constexpr int kSim = kBwdTogether;
  constexpr int kCross = S == 4 ? kSim : 1;
  for (int k0 = 0; k0 < kBwdRows; k0 += kSim) {
    float vp[kSim][3], php[kSim][S], dph[kSim][S], a0[kSim][3], a3[kCross][3], w3[kCross][3];
#pragma unroll
    for (int s = 0; s < kSim; ++s) {
      const int pc = min(p0 + warp * kBwdRows + k0 + s, N - 1);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        vp[s][d] = vb[((size_t)pc * 3 + d) * F];
        a0[s][d] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < S; ++c) {
        php[s][c] = phib[((size_t)pc * S + c) * F];
        dph[s][c] = 0.f;
      }
    }
#pragma unroll
    for (int s = 0; s < kCross; ++s)
#pragma unroll
      for (int d = 0; d < 3; ++d) a3[s][d] = w3[s][d] = 0.f;

    for (int ci = 0; ci < n_chunks; ++ci) {
      const int q0 = ci * kCols, nc = min(kCols, N - q0);
      if (n_chunks > 1 || k0 == 0) {
        __syncthreads();              // the previous chunk's readers are done
        // partner rows by cp.async, in flight while the geometry is built
        for (int qq = warp; qq < nc; qq += n_warps) {
          const size_t q = q0 + qq;
          float* e0 = reinterpret_cast<float*>(part + qq * kLanes + lane);
          cp_async4(e0 + 0, gsb + q * F);
#pragma unroll
          for (int d = 0; d < 3; ++d) cp_async4(e0 + 1 + d, gvb + (q * 3 + d) * F);
          if constexpr (S == 4) {     // raw v_q and phi[q, 3]; turned into products below
            float* e1 = reinterpret_cast<float*>(part + (cols + qq) * kLanes + lane);
#pragma unroll
            for (int d = 0; d < 3; ++d) cp_async4(e1 + d, vb + (q * 3 + d) * F);
            cp_async4(e1 + 3, phib + (q * S + 3) * F);
          }
        }
        cp_async_commit();
        // every row's geometry once when one chunk holds all partners, else
        // the rows of these kSim nodes
        const int kr = n_chunks > 1 ? kSim : kBwdRows;
        for (int t = threadIdx.x; t < n_warps * kr * nc; t += blockDim.x) {
          const int rr = t / nc, qq = t % nc;
          const int sl = n_chunks > 1 ? (rr / kSim) * kBwdRows + k0 + rr % kSim : rr;
          pair_record<RA>(geo + (sl * nc + qq) * W, nodes, p0 + sl, q0 + qq, N, cutoff, pi_c);
        }
        cp_async_wait<0>();
        if constexpr (S == 4) {       // each thread rewrites the entries it copied
          for (int qq = warp; qq < nc; qq += n_warps) {
            const float4 g = part[qq * kLanes + lane];
            const float4 u = part[(cols + qq) * kLanes + lane];
            part[(cols + qq) * kLanes + lane] =
                make_float4(g.z * u.z - g.w * u.y, g.w * u.x - g.y * u.z,
                            g.y * u.y - g.z * u.x, u.w * u.x);
            part[(2 * cols + qq) * kLanes + lane] = make_float4(u.w * u.y, u.w * u.z, 0.f, 0.f);
          }
        }
        __syncthreads();
      }
      if (p0 + warp * kBwdRows + k0 >= N) continue;

      const float* rec0 = geo + (warp * kBwdRows + k0) * nc * W;
#pragma unroll 1
      for (int qq = 0; qq < nc; ++qq) {    // partner q against the kSim nodes
        const float4 a = part[qq * kLanes + lane];
        float4 e, h;
        if constexpr (S == 4) {
          e = part[(cols + qq) * kLanes + lane];
          h = part[(2 * cols + qq) * kLanes + lane];
        }
#pragma unroll
        for (int s = 0; s < kSim; ++s) {
          float g[W];
          load_record(g, rec0 + (s * nc + qq) * W);
          float filt[S];
          fold<RA, S>(filt, g, wr);
          float t[S];
          t[1] = a.x;
          // unit of the pair (q <- p) is (x_p - x_q) / d = -unit in the record
          t[2] = -(a.y * g[RA] + a.z * g[RA + 1] + a.w * g[RA + 2]);
          t[0] = a.y * vp[s][0] + a.z * vp[s][1] + a.w * vp[s][2];
          a0[s][0] = fmaf(filt[0], a.y, a0[s][0]);
          a0[s][1] = fmaf(filt[0], a.z, a0[s][1]);
          a0[s][2] = fmaf(filt[0], a.w, a0[s][2]);
          if constexpr (S == 4) {
            t[3] = e.x * vp[s][0] + e.y * vp[s][1] + e.z * vp[s][2];
            a3[s][0] = fmaf(filt[3], e.x, a3[s][0]);
            a3[s][1] = fmaf(filt[3], e.y, a3[s][1]);
            a3[s][2] = fmaf(filt[3], e.z, a3[s][2]);
            w3[s][0] = fmaf(filt[3], e.w, w3[s][0]);
            w3[s][1] = fmaf(filt[3], h.x, w3[s][1]);
            w3[s][2] = fmaf(filt[3], h.y, w3[s][2]);
          }
#pragma unroll
          for (int c = 0; c < S; ++c) {
            dph[s][c] = fmaf(filt[c], t[c], dph[s][c]);
            const float x = php[s][c] * t[c];
#pragma unroll
            for (int r = 0; r < RA; ++r) dw[r][c] = fmaf(g[r], x, dw[r][c]);
          }
        }
      }
    }
    if (f_out < F) {
#pragma unroll
      for (int s = 0; s < kSim; ++s) {
        const int p = p0 + warp * kBwdRows + k0 + s;
        if (p >= N) break;
        const size_t row = (size_t)b * N + p;
#pragma unroll
        for (int c = 0; c < S; ++c) dphi[(row * S + c) * F + f] = dph[s][c];
        float o[3] = {php[s][0] * a0[s][0], php[s][0] * a0[s][1], php[s][0] * a0[s][2]};
        if constexpr (S == 4) {
          // receiver side of dv_p += v_p x w3_p: d v_p = w3_p x gv_p
          const float h0 = gvb[((size_t)p * 3 + 0) * F], h1 = gvb[((size_t)p * 3 + 1) * F],
                      h2 = gvb[((size_t)p * 3 + 2) * F];
          o[0] += php[s][3] * a3[s][0] + (w3[s][1] * h2 - w3[s][2] * h1);
          o[1] += php[s][3] * a3[s][1] + (w3[s][2] * h0 - w3[s][0] * h2);
          o[2] += php[s][3] * a3[s][2] + (w3[s][0] * h1 - w3[s][1] * h0);
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) dv[(row * 3 + d) * F + f] = o[d];
      }
    }
  }

  // the block's d_w: its warps' sums added in a fixed order, one partial
  // per (b, node tile, feature)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);    // (warp, RA * S, lane)
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int c = 0; c < S; ++c) red[((warp * RA + r) * S + c) * kLanes + lane] = dw[r][c];
  __syncthreads();
  float* out = dw_part + ((size_t)b * gridDim.y + blockIdx.y) * RA * S * F;
  for (int t = threadIdx.x; t < RA * S * kLanes; t += blockDim.x) {
    const int rc = t / kLanes, ln = t % kLanes, ff = blockIdx.x * kLanes + ln;
    float acc = 0.f;
    for (int wi = 0; wi < n_warps; ++wi) acc += red[(wi * RA * S + rc) * kLanes + ln];
    if (ff < F) out[(size_t)rc * F + ff] = acc;
  }
}

// ---------------------------------------------------------------------------
// Wide basis, RA > kTemplateMaxRA (the note at the top): the basis in chunks
// of C <= kWideChunk functions (pair_geometry.cuh::chunk_record), each
// chunk's w[:, :, f] and, in the backward, its d_w sums in registers. The
// message is linear in the filter, so the node sums stay in registers
// across the chunks and each chunk adds its share.

// Forward: fused_message_kernel's blocking (kFwdRows receivers per thread, a
// cp.async ring of senders per warp, partner chunks of kCols), with the
// records and the weights taken one basis chunk at a time.
template <int C, int S, bool E>
__global__ void __launch_bounds__(kLanes * kFwdMaxWarps, 2)
fused_message_wide_kernel(
    const float* __restrict__ xyz,    // (B, N, 3)
    const float* __restrict__ mask,   // (B, N)
    const float* __restrict__ phi,    // (B, N, S, F)
    const float* __restrict__ v,      // (B, N, 3, F)
    const float* __restrict__ w,      // (RA, S, F)
    float* __restrict__ ds,           // (B, N, F)
    float* __restrict__ dv,           // (B, N, 3, F)
    int N, int F, int RA, float cutoff) {
  constexpr int W = record_width(C);
  constexpr int P = S + 3;            // payload floats per sender: phi[j, :], v[j, :]
  constexpr int kCross = S == 4 ? kFwdRows : 1;
  extern __shared__ float4 smem[];

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int rows = blockDim.x / kLanes * kFwdRows;
  const int cols = min(N, kCols);
  const int b = blockIdx.z, i0 = blockIdx.y * rows;
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const float inv_cut = 1.f / cutoff;
  float4* nodes = smem;                               // (N): x, y, z, mask
  float* geo = reinterpret_cast<float*>(smem + N);    // (rows, chunk, W)
  // this warp's ring of sender payloads, (slot, P, lane), at this lane
  float* ring = geo + rows * cols * W + warp * kRing * P * kLanes + lane;
  const float* xb = xyz + (size_t)b * N * 3;
  const float* mb = mask + (size_t)b * N;
  const float* phib = phi + (size_t)b * N * S * F + f;
  const float* vb = v + (size_t)b * N * 3 * F + f;

  float acc_s[kFwdRows], acc_v[kFwdRows][3], acc_w3[kCross][3];
#pragma unroll
  for (int k = 0; k < kFwdRows; ++k) {
    acc_s[k] = 0.f;
    acc_v[k][0] = acc_v[k][1] = acc_v[k][2] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < kCross; ++k) acc_w3[k][0] = acc_w3[k][1] = acc_w3[k][2] = 0.f;

  stage_nodes(nodes, xb, mb, N);
  for (int j0 = 0; j0 < N; j0 += kCols) {
    const int nc = min(kCols, N - j0);
    // sender jj's payload into ring slot jj % kRing, one commit group each
    auto stage = [&](int jj) {
      if (jj < nc) {
        float* dst = ring + (jj % kRing) * P * kLanes;
        const size_t j = j0 + jj;
#pragma unroll
        for (int c = 0; c < S; ++c) cp_async4(dst + c * kLanes, phib + (j * S + c) * F);
#pragma unroll
        for (int d = 0; d < 3; ++d) cp_async4(dst + (S + d) * kLanes, vb + (j * 3 + d) * F);
      }
      cp_async_commit();
    };
    for (int r0 = 0; r0 < RA; r0 += C) {
      float wr[C][S];                 // this chunk's weights, zero past RA
#pragma unroll
      for (int r = 0; r < C; ++r)
#pragma unroll
        for (int c = 0; c < S; ++c)
          wr[r][c] = r0 + r < RA ? w[((size_t)(r0 + r) * S + c) * F + f] : 0.f;
      __syncthreads();                // the nodes are staged; the previous chunk's readers are done
#pragma unroll
      for (int jj = 0; jj < kRing - 1; ++jj) stage(jj);   // in flight while the records are built
      for (int t = threadIdx.x; t < rows * nc; t += blockDim.x)
        chunk_record<C, E>(geo + t * W, nodes, i0 + t / nc, j0 + t % nc, N, r0, RA, cutoff,
                        inv_cut);
      __syncthreads();

      const float* rec0 = geo + warp * kFwdRows * nc * W;
      for (int jj = 0; jj < nc; ++jj) {
        stage(jj + kRing - 1);
        cp_async_wait<kRing - 1>();   // sender jj has landed (each lane reads its own copies)
        float pay[P];
        const float* src = ring + (jj % kRing) * P * kLanes;
#pragma unroll
        for (int e = 0; e < P; ++e) pay[e] = src[e * kLanes];
#pragma unroll
        for (int k = 0; k < kFwdRows; ++k) {
          float g[W];
          load_record(g, rec0 + (k * nc + jj) * W);
          float filt[S];
          fold<C, S>(filt, g, wr);
          acc_s[k] = fmaf(filt[1], pay[1], acc_s[k]);
          const float p0 = filt[0] * pay[0], p2 = filt[2] * pay[2];
#pragma unroll
          for (int d = 0; d < 3; ++d)
            acc_v[k][d] = fmaf(p2, g[C + d], fmaf(p0, pay[S + d], acc_v[k][d]));
          if constexpr (S == 4) {
            const float p3 = filt[3] * pay[3];
#pragma unroll
            for (int d = 0; d < 3; ++d) acc_w3[k][d] = fmaf(p3, pay[S + d], acc_w3[k][d]);
          }
        }
      }
    }
  }
  if (f_out >= F) return;

#pragma unroll
  for (int k = 0; k < kFwdRows; ++k) {
    const int i = i0 + warp * kFwdRows + k;
    if (i >= N) break;
    const size_t row = (size_t)b * N + i;
    float o[3] = {acc_v[k][0], acc_v[k][1], acc_v[k][2]};
    if constexpr (S == 4) {
      // dv_i += v_i x w3_i (the cross product commutes with the sum over j)
      const float a0 = v[(row * 3 + 0) * F + f];
      const float a1 = v[(row * 3 + 1) * F + f];
      const float a2 = v[(row * 3 + 2) * F + f];
      o[0] += a1 * acc_w3[k][2] - a2 * acc_w3[k][1];
      o[1] += a2 * acc_w3[k][0] - a0 * acc_w3[k][2];
      o[2] += a0 * acc_w3[k][1] - a1 * acc_w3[k][0];
    }
    ds[row * F + f] = acc_s[k];
#pragma unroll
    for (int d = 0; d < 3; ++d) dv[(row * 3 + d) * F + f] = o[d];
  }
}

// Backward: each warp owns kBwdTogether nodes p, taken together against
// every partner q, so their sums stay in registers across the basis chunks;
// the partners' cotangent rows are staged as in fused_message_bwd_kernel
// (once when one chunk holds all partners). After each basis chunk the
// block adds its warps' d_w sums in a fixed order and writes that chunk's
// rows of its partial, one per (b, node tile, feature). Grid (F/32, node
// tiles, B).
template <int C, int S, bool E>
__global__ void __launch_bounds__(kLanes * kWideBwdWarps, 2)
fused_message_bwd_wide_kernel(
    const float* __restrict__ xyz,    // (B, N, 3)
    const float* __restrict__ mask,   // (B, N)
    const float* __restrict__ phi,    // (B, N, S, F)
    const float* __restrict__ v,      // (B, N, 3, F)
    const float* __restrict__ w,      // (RA, S, F)
    const float* __restrict__ gs,     // (B, N, F)
    const float* __restrict__ gv,     // (B, N, 3, F)
    float* __restrict__ dphi,         // (B, N, S, F)
    float* __restrict__ dv,           // (B, N, 3, F)
    float* __restrict__ dw_part,      // (B, node tiles, RA, S, F)
    int N, int F, int RA, float cutoff) {
  constexpr int W = record_width(C);
  constexpr int kSim = kBwdTogether;
  constexpr int kCross = S == 4 ? kSim : 1;
  extern __shared__ float4 smem[];

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int n_warps = blockDim.x / kLanes, rows = n_warps * kSim;
  const int b = blockIdx.z, p0 = blockIdx.y * rows, pw = p0 + warp * kSim;
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const int cols = min(N, kCols);
  const float inv_cut = 1.f / cutoff;
  float4* nodes = smem;                               // (N): x, y, z, mask
  // (rows, chunk, W) records; after each basis chunk's walk the d_w
  // reduction (warp, C, S, lane)
  float* geo = reinterpret_cast<float*>(smem + N);
  const int geo_f4 = max(rows * cols * W, n_warps * C * S * kLanes) / 4;
  // partner rows, float4 (e, chunk, lane), as in fused_message_bwd_kernel
  float4* part = smem + N + geo_f4;
  const float* xb = xyz + (size_t)b * N * 3;
  const float* mb = mask + (size_t)b * N;
  const float* phib = phi + (size_t)b * N * S * F + f;
  const float* vb = v + (size_t)b * N * 3 * F + f;
  const float* gsb = gs + (size_t)b * N * F + f;
  const float* gvb = gv + (size_t)b * N * 3 * F + f;

  float vp[kSim][3], php[kSim][S], dph[kSim][S], a0[kSim][3], a3[kCross][3], w3[kCross][3];
#pragma unroll
  for (int s = 0; s < kSim; ++s) {
    const int pc = min(pw + s, N - 1);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      vp[s][d] = vb[((size_t)pc * 3 + d) * F];
      a0[s][d] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < S; ++c) {
      php[s][c] = phib[((size_t)pc * S + c) * F];
      dph[s][c] = 0.f;
    }
  }
#pragma unroll
  for (int s = 0; s < kCross; ++s)
#pragma unroll
    for (int d = 0; d < 3; ++d) a3[s][d] = w3[s][d] = 0.f;
  const int n_chunks = (N + kCols - 1) / kCols;
  stage_nodes(nodes, xb, mb, N);      // read after the first __syncthreads below
  float* out = dw_part + ((size_t)b * gridDim.y + blockIdx.y) * RA * S * F;

  for (int r0 = 0; r0 < RA; r0 += C) {
    float wr[C][S], dw[C][S];         // this chunk's weights (zero past RA) and d_w sums
#pragma unroll
    for (int r = 0; r < C; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c) {
        wr[r][c] = r0 + r < RA ? w[((size_t)(r0 + r) * S + c) * F + f] : 0.f;
        dw[r][c] = 0.f;
      }
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int q0 = ci * kCols, nc = min(kCols, N - q0);
      const bool restage = n_chunks > 1 || r0 == 0;
      __syncthreads();                // the previous chunk's readers are done
      if (restage) {                  // partner rows by cp.async, in flight while the records are built
        for (int qq = warp; qq < nc; qq += n_warps) {
          const size_t q = q0 + qq;
          float* e0 = reinterpret_cast<float*>(part + qq * kLanes + lane);
          cp_async4(e0 + 0, gsb + q * F);
#pragma unroll
          for (int d = 0; d < 3; ++d) cp_async4(e0 + 1 + d, gvb + (q * 3 + d) * F);
          if constexpr (S == 4) {     // raw v_q and phi[q, 3]; turned into products below
            float* e1 = reinterpret_cast<float*>(part + (cols + qq) * kLanes + lane);
#pragma unroll
            for (int d = 0; d < 3; ++d) cp_async4(e1 + d, vb + (q * 3 + d) * F);
            cp_async4(e1 + 3, phib + (q * S + 3) * F);
          }
        }
        cp_async_commit();
      }
      for (int t = threadIdx.x; t < rows * nc; t += blockDim.x)
        chunk_record<C, E>(geo + t * W, nodes, p0 + t / nc, q0 + t % nc, N, r0, RA, cutoff,
                        inv_cut);
      if (restage) {
        cp_async_wait<0>();
        if constexpr (S == 4) {       // each thread rewrites the entries it copied
          for (int qq = warp; qq < nc; qq += n_warps) {
            const float4 g = part[qq * kLanes + lane];
            const float4 u = part[(cols + qq) * kLanes + lane];
            part[(cols + qq) * kLanes + lane] =
                make_float4(g.z * u.z - g.w * u.y, g.w * u.x - g.y * u.z,
                            g.y * u.y - g.z * u.x, u.w * u.x);
            part[(2 * cols + qq) * kLanes + lane] = make_float4(u.w * u.y, u.w * u.z, 0.f, 0.f);
          }
        }
      }
      __syncthreads();
      if (pw >= N) continue;

      const float* rec0 = geo + warp * kSim * nc * W;
#pragma unroll 1
      for (int qq = 0; qq < nc; ++qq) {    // partner q against the kSim nodes
        const float4 a = part[qq * kLanes + lane];
        float4 e, h;
        if constexpr (S == 4) {
          e = part[(cols + qq) * kLanes + lane];
          h = part[(2 * cols + qq) * kLanes + lane];
        }
#pragma unroll
        for (int s = 0; s < kSim; ++s) {
          float g[W];
          load_record(g, rec0 + (s * nc + qq) * W);
          float filt[S];
          fold<C, S>(filt, g, wr);
          float t[S];
          t[1] = a.x;
          // unit of the pair (q <- p) is (x_p - x_q) / d = -unit in the record
          t[2] = -(a.y * g[C] + a.z * g[C + 1] + a.w * g[C + 2]);
          t[0] = a.y * vp[s][0] + a.z * vp[s][1] + a.w * vp[s][2];
          a0[s][0] = fmaf(filt[0], a.y, a0[s][0]);
          a0[s][1] = fmaf(filt[0], a.z, a0[s][1]);
          a0[s][2] = fmaf(filt[0], a.w, a0[s][2]);
          if constexpr (S == 4) {
            t[3] = e.x * vp[s][0] + e.y * vp[s][1] + e.z * vp[s][2];
            a3[s][0] = fmaf(filt[3], e.x, a3[s][0]);
            a3[s][1] = fmaf(filt[3], e.y, a3[s][1]);
            a3[s][2] = fmaf(filt[3], e.z, a3[s][2]);
            w3[s][0] = fmaf(filt[3], e.w, w3[s][0]);
            w3[s][1] = fmaf(filt[3], h.x, w3[s][1]);
            w3[s][2] = fmaf(filt[3], h.y, w3[s][2]);
          }
#pragma unroll
          for (int c = 0; c < S; ++c) {
            dph[s][c] = fmaf(filt[c], t[c], dph[s][c]);
            const float x = php[s][c] * t[c];
#pragma unroll
            for (int r = 0; r < C; ++r) dw[r][c] = fmaf(g[r], x, dw[r][c]);
          }
        }
      }
    }
    // this chunk's d_w: the warps' sums added in a fixed order
    __syncthreads();                  // every warp is done with the records
#pragma unroll
    for (int r = 0; r < C; ++r)
#pragma unroll
      for (int c = 0; c < S; ++c) geo[((warp * C + r) * S + c) * kLanes + lane] = dw[r][c];
    __syncthreads();
    for (int t = threadIdx.x; t < C * S * kLanes; t += blockDim.x) {
      const int rc = t / kLanes, ln = t % kLanes, ff = blockIdx.x * kLanes + ln;
      float acc = 0.f;
      for (int wi = 0; wi < n_warps; ++wi) acc += geo[(wi * C * S + rc) * kLanes + ln];
      if (r0 + rc / S < RA && ff < F) out[(size_t)(r0 * S + rc) * F + ff] = acc;
    }
  }

  if (f_out >= F) return;
#pragma unroll
  for (int s = 0; s < kSim; ++s) {
    const int p = pw + s;
    if (p >= N) break;
    const size_t row = (size_t)b * N + p;
#pragma unroll
    for (int c = 0; c < S; ++c) dphi[(row * S + c) * F + f] = dph[s][c];
    float o[3] = {php[s][0] * a0[s][0], php[s][0] * a0[s][1], php[s][0] * a0[s][2]};
    if constexpr (S == 4) {
      // receiver side of dv_p += v_p x w3_p: d v_p = w3_p x gv_p
      const float h0 = gvb[((size_t)p * 3 + 0) * F], h1 = gvb[((size_t)p * 3 + 1) * F],
                  h2 = gvb[((size_t)p * 3 + 2) * F];
      o[0] += php[s][3] * a3[s][0] + (w3[s][1] * h2 - w3[s][2] * h1);
      o[1] += php[s][3] * a3[s][1] + (w3[s][2] * h0 - w3[s][0] * h2);
      o[2] += php[s][3] * a3[s][2] + (w3[s][0] * h1 - w3[s][1] * h0);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) dv[(row * 3 + d) * F + f] = o[d];
  }
}

// ---------------------------------------------------------------------------
// The tensor-core forward, S = 3, R+1 <= 16, N >= kTcMinN (the note at the
// top): the per-pair fold of the filter over the basis as 3xTF32 MMAs. A
// block owns one batch element, kTcTiles tiles of 8 receivers (the MMAs'
// n) and kTcF features (16, the MMAs' m, per warp), and walks the senders
// in staged chunks of kTcCols.

// floats of one sender's records for rn receivers: K[r][i], then unit[d][i]
__host__ __device__ constexpr int tc_geo(int rn) { return (kTcKR + 3) * rn; }

// x as TF32 (round to nearest, ties away; the low 13 bits zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 of x, each part TF32: the 3xTF32 split
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b: one m16n8k8 TF32 MMA, f32 accumulator
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fold's A operand, w^T (this warp's 16 features x kTcK basis functions
// a step), split: wa[c][step][i][0 hi, 1 lo] is A register i, at feature
// fw + g + 8 (i % 2) and basis function kTcK step + t + 4 (i / 2); zeros
// past R+1 and past F.
template <int KK>
__device__ __forceinline__ void tc_weights(uint32_t (&wa)[3][KK][4][2],
                                           const float* __restrict__ w, int RA, int F, int fw,
                                           int g, int t) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = kTcK * kk + t + 4 * (i / 2), f = fw + g + 8 * (i % 2);
        const float x = r < RA && f < F ? w[((size_t)r * 3 + c) * F + f] : 0.f;
        split_tf32(x, wa[c][kk][i][0], wa[c][kk][i][1]);
      }
}

// filt[s][c] = sum_r w[r, c, f] K[i, j, r] of one sender j for the
// block's tiles s of 8 receivers, whose records K[r][i] start at gq: the C
// fragment (row f = fw + g + 8 (e / 2), column i = 8 s + 2 t + e % 2) of
// w^T (16 x kTcK) by K^T (kTcK x 8) per basis step, 3xTF32, lo x hi and
// hi x lo before hi x hi. The tiles' and channels' MMAs form 3 RT
// independent chains.
template <int KK, int RT>
__device__ __forceinline__ void tc_fold(float (&filt)[RT][3][4],
                                        const uint32_t (&wa)[3][KK][4][2],
                                        const float* __restrict__ gq, int g, int t) {
  constexpr int RN = 8 * RT;
#pragma unroll
  for (int s = 0; s < RT; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) filt[s][c][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    uint32_t bh[RT][2], bl[RT][2];    // K[8 s + g][kTcK kk + t + 4 i]
#pragma unroll
    for (int s = 0; s < RT; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        split_tf32(gq[(kTcK * kk + t + 4 * i) * RN + 8 * s + g], bh[s][i], bl[s][i]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = wa[c][kk][i][0];
        al[i] = wa[c][kk][i][1];
      }
#pragma unroll
      for (int s = 0; s < RT; ++s) {
        mma_k8(filt[s][c], al, bh[s][0], bh[s][1]);    // lo x hi
        mma_k8(filt[s][c], ah, bl[s][0], bl[s][1]);    // hi x lo
        mma_k8(filt[s][c], ah, bh[s][0], bh[s][1]);    // hi x hi
      }
    }
  }
}

// The chunk's pair records, one per (receiver i0 + i, sender j0 + jj), i <
// RN: G[jj][r][i] = K[r] (zeros from R+1 on and for a receiver past N),
// then G[jj][kTcKR + d][i] = unit[d] = (x_j - x_i)[d] / d_ij. rows holds
// the receivers' (x, y, z, mask).
template <int RN>
__device__ __forceinline__ void tc_stage_pairs(float* __restrict__ G, const float4* __restrict__ rows,
                                               const float* __restrict__ xb,
                                               const float* __restrict__ mb, int i0, int j0,
                                               int nc, int N, int RA, float cutoff, float pi_c) {
  for (int k = threadIdx.x; k < RN * nc; k += blockDim.x) {
    const int i = k % RN, jj = k / RN, j = j0 + jj;
    float K[kTcKR], unit[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kTcKR; ++r) K[r] = 0.f;
    if (i0 + i < N) {
      const float4 c = make_float4(xb[j * 3 + 0], xb[j * 3 + 1], xb[j * 3 + 2], mb[j]);
      pair_basis<kTcKR>(K, unit, rows[i], c, i0 + i == j, RA, cutoff, pi_c);
    }
    float* gj = G + jj * tc_geo(RN) + i;
#pragma unroll
    for (int r = 0; r < kTcKR; ++r) gj[r * RN] = K[r];
#pragma unroll
    for (int d = 0; d < 3; ++d) gj[(kTcKR + d) * RN] = unit[d];
  }
}

// The chunk's sender payloads by cp.async: P[jj][e][fl] = phi[j, e] (e < 3)
// or v[j, e - 3] of sender j = j0 + jj at feature fb + fl, features past F
// repeating the last ones. 16-byte copies when F % 4 == 0.
__device__ __forceinline__ void tc_stage_payloads(float* __restrict__ P,
                                                  const float* __restrict__ phib,
                                                  const float* __restrict__ vb, int j0, int nc,
                                                  int fb, int F) {
  constexpr int E = 6, V = kTcF / 4;
  auto row = [&](int e, int j) {
    return e < 3 ? phib + ((size_t)j * 3 + e) * F : vb + ((size_t)j * 3 + e - 3) * F;
  };
  if (F % 4 == 0) {
    for (int k = threadIdx.x; k < nc * E * V; k += blockDim.x) {
      const int fl = 4 * (k % V), e = (k / V) % E, jj = k / (E * V);
      cp_async16(P + 4 * k, row(e, j0 + jj) + min(fb + fl, F - 4));
    }
  } else {
    for (int k = threadIdx.x; k < nc * E * kTcF; k += blockDim.x) {
      const int fl = k % kTcF, e = (k / kTcF) % E, jj = k / (E * kTcF);
      cp_async4(P + k, row(e, j0 + jj) + min(fb + fl, F - 1));
    }
  }
  cp_async_commit();
}

// Per sender the fold gives filt[c] (16 features x 8 receivers per tile) on
// the tensor cores, and each thread adds its four (feature, receiver)
// elements' messages per tile on the FMA pipes from the sender's staged
// payload, read once for all tiles. Grid (F / kTcF, N / (8 kTcTiles), B).
template <int KK>
__global__ void __launch_bounds__(kLanes * kTcWarps, 3)
fused_message_tc_kernel(
    const float* __restrict__ xyz,    // (B, N, 3)
    const float* __restrict__ mask,   // (B, N)
    const float* __restrict__ phi,    // (B, N, 3, F)
    const float* __restrict__ v,      // (B, N, 3, F)
    const float* __restrict__ w,      // (RA, 3, F)
    float* __restrict__ ds,           // (B, N, F)
    float* __restrict__ dv,           // (B, N, 3, F)
    int N, int F, int RA, float cutoff) {
  constexpr int E = 6;                // payload rows per sender: phi[j, 0..2], v[j, 0..2]
  constexpr int RT = kTcTiles, RN = 8 * RT, GEO = tc_geo(RN);
  extern __shared__ float4 smem[];

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.z, i0 = blockIdx.y * RN;
  const int fb = blockIdx.x * kTcF, fw = fb + warp * 16;
  const float pi_c = kPi / cutoff;
  float4* rows = smem;                                    // (RN): x, y, z, mask
  float* G = reinterpret_cast<float*>(smem + RN);         // (kTcCols, GEO)
  float* P = G + kTcCols * GEO;                           // (kTcCols, E, kTcF)
  const float* xb = xyz + (size_t)b * N * 3;
  const float* mb = mask + (size_t)b * N;

  uint32_t wa[3][KK][4][2];
  tc_weights<KK>(wa, w, RA, F, fw, g, t);
  float acc[RT][4][4];                // per tile and C element: ds, dv[0..2]
#pragma unroll
  for (int s = 0; s < RT; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[s][e][0] = acc[s][e][1] = acc[s][e][2] = acc[s][e][3] = 0.f;
  if (threadIdx.x < RN) {
    const int i = i0 + threadIdx.x;
    rows[threadIdx.x] = i < N ? make_float4(xb[i * 3 + 0], xb[i * 3 + 1], xb[i * 3 + 2], mb[i])
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int j0 = 0; j0 < N; j0 += kTcCols) {
    const int nc = min(kTcCols, N - j0);
    __syncthreads();                  // the rows are staged; the previous chunk's readers are done
    tc_stage_payloads(P, phi + (size_t)b * N * 3 * F, v + (size_t)b * N * 3 * F, j0, nc, fb, F);
    tc_stage_pairs<RN>(G, rows, xb, mb, i0, j0, nc, N, RA, cutoff, pi_c);
    cp_async_wait<0>();
    __syncthreads();
    if (fw >= F) continue;            // a warp wholly past F stages, and computes nothing

#pragma unroll 1
    for (int jj = 0; jj < nc; ++jj) {
      const float* gj = G + jj * GEO;
      float filt[RT][3][4];
      tc_fold<KK, RT>(filt, wa, gj, g, t);
      float pay[2][E];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < E; ++e) pay[h][e] = P[(jj * E + e) * kTcF + warp * 16 + g + 8 * h];
#pragma unroll
      for (int s = 0; s < RT; ++s) {
        float u[3][2];                // unit[d] of receivers 8 s + 2 t, + 1
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float2 x =
              *reinterpret_cast<const float2*>(gj + (kTcKR + d) * RN + 8 * s + 2 * t);
          u[d][0] = x.x;
          u[d][1] = x.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, c = e % 2;
          acc[s][e][0] = fmaf(filt[s][1][e], pay[h][1], acc[s][e][0]);
          const float p0 = filt[s][0][e] * pay[h][0], p2 = filt[s][2][e] * pay[h][2];
#pragma unroll
          for (int d = 0; d < 3; ++d)
            acc[s][e][1 + d] = fmaf(p2, u[d][c], fmaf(p0, pay[h][3 + d], acc[s][e][1 + d]));
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < RT; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 8 * s + 2 * t + e % 2, f = fw + g + 8 * (e / 2);
      if (i >= N || f >= F) continue;
      const size_t row = (size_t)b * N + i;
      ds[row * F + f] = acc[s][e][0];
#pragma unroll
      for (int d = 0; d < 3; ++d) dv[(row * 3 + d) * F + f] = acc[s][e][1 + d];
    }
}

// Warps of a block: kFwdRows receivers (forward) and kBwdRows nodes
// (backward) per warp; the wide backward's kBwdTogether nodes per warp.
int fwd_warps(int N) { return std::min(kFwdMaxWarps, (N + kFwdRows - 1) / kFwdRows); }
int bwd_warps(int N) { return std::min(kBwdMaxWarps, (N + kBwdRows - 1) / kBwdRows); }
int bwd_tiles(int N) { return (N + bwd_warps(N) * kBwdRows - 1) / (bwd_warps(N) * kBwdRows); }
int wide_bwd_warps(int N) {
  return std::min(kWideBwdWarps, (N + kBwdTogether - 1) / kBwdTogether);
}
int wide_bwd_tiles(int N) {
  const int rows = wide_bwd_warps(N) * kBwdTogether;
  return (N + rows - 1) / rows;
}

// Run fn(integral_constant<S>, integral_constant<RA>) for the runtime S and
// RA; the kernels exist for S in {3, 4} and RA in 2..16.
template <typename Fn>
int with_shape(int S, int RA, Fn&& fn) {
  if (S == 3)
    return with_ra(RA, [&](auto ra_c) { return fn(std::integral_constant<int, 3>{}, ra_c); });
  if (S == 4)
    return with_ra(RA, [&](auto ra_c) { return fn(std::integral_constant<int, 4>{}, ra_c); });
  return (int)cudaErrorInvalidValue;
}

// The tensor-core forward takes a launch of S = 3, R+1 <= 16 and N >=
// kTcMinN; fused_message_fwd and fused_message_route ask this.
bool tc_route(int N, int S, int RA) { return S == 3 && RA <= kTemplateMaxRA && N >= kTcMinN; }

// Run fn(integral_constant<KK>) for the tensor-core forward's basis steps:
// KK = ceil(RA / kTcK), 1 or 2 for RA in 2..16.
template <typename Fn>
int with_tc(int RA, Fn&& fn) {
  if (RA <= kTcK) return fn(std::integral_constant<int, 1>{});
  return fn(std::integral_constant<int, 2>{});
}

// Run fn(integral_constant<S>, integral_constant<C>) for the runtime S and
// the chunk width C of a wide basis of RA: the fewest chunks of at most
// kWideChunk functions, of equal width (the last one zero-padded). For RA >
// 16 that is C in 9..12.
template <typename Fn>
int with_wide(int S, int RA, Fn&& fn) {
  const int n = (RA + kWideChunk - 1) / kWideChunk;
  auto with_c = [&](auto s_c) {
    switch ((RA + n - 1) / n) {
      case 9: return fn(s_c, std::integral_constant<int, 9>{});
      case 10: return fn(s_c, std::integral_constant<int, 10>{});
      case 11: return fn(s_c, std::integral_constant<int, 11>{});
      case 12: return fn(s_c, std::integral_constant<int, 12>{});
    }
    return (int)cudaErrorInvalidValue;
  };
  if (S == 3) return with_c(std::integral_constant<int, 3>{});
  if (S == 4) return with_c(std::integral_constant<int, 4>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cgvae

// 1 when a forward launch of (B, N, S, R+1) takes the tensor-core kernel,
// else 0.
extern "C" int fused_message_route(int B, int N, int S, int RA) {
  return B > 0 && N > 0 && cgvae::tc_route(N, S, RA) ? 1 : 0;
}

extern "C" int fused_message_fwd(
    const void* xyz, const void* mask, const void* phi, const void* v,
    const void* w, void* ds, void* dv, int B, int N, int S, int F, int RA,
    float cutoff, void* stream) {
  using namespace cgvae;
  if (B <= 0 || N <= 0) return 0;
  if (fused_message_route(B, N, S, RA)) {
    constexpr int rn = 8 * kTcTiles;
    const dim3 grid((unsigned)((F + kTcF - 1) / kTcF), (unsigned)((N + rn - 1) / rn), (unsigned)B);
    return with_tc(RA, [&](auto kk_c) {
      constexpr int kKK = decltype(kk_c)::value;
      const size_t smem = sizeof(float4) * rn + sizeof(float) * kTcCols * (tc_geo(rn) + 6 * kTcF);
      static int allowed[kMaxDevices] = {};
      const int err = allow_smem(fused_message_tc_kernel<kKK>, smem, allowed);
      if (err != 0) return err;
      fused_message_tc_kernel<kKK><<<grid, kTcWarps * kLanes, smem, (cudaStream_t)stream>>>(
          (const float*)xyz, (const float*)mask, (const float*)phi, (const float*)v,
          (const float*)w, (float*)ds, (float*)dv, N, F, RA, cutoff);
      return (int)cudaGetLastError();
    });
  }
  if (RA > kTemplateMaxRA) {
    const int warps = fwd_warps(N), rows = warps * kFwdRows;
    const dim3 grid((unsigned)((F + kLanes - 1) / kLanes), (unsigned)((N + rows - 1) / rows),
                    (unsigned)B);
    return with_wide(S, RA, [&](auto s_c, auto c_c) {
      return with_exact(RA, [&](auto e_c) {
        constexpr int kS = decltype(s_c)::value, kC = decltype(c_c)::value;
        constexpr bool kE = decltype(e_c)::value;
        const size_t smem = sizeof(float4) * N
                            + sizeof(float) * rows * std::min(N, kCols) * record_width(kC)
                            + sizeof(float) * warps * kRing * (kS + 3) * kLanes;
        static int allowed[kMaxDevices] = {};
        const int err = allow_smem(fused_message_wide_kernel<kC, kS, kE>, smem, allowed);
        if (err != 0) return err;
        fused_message_wide_kernel<kC, kS, kE>
            <<<grid, warps * kLanes, smem, (cudaStream_t)stream>>>(
                (const float*)xyz, (const float*)mask, (const float*)phi, (const float*)v,
                (const float*)w, (float*)ds, (float*)dv, N, F, RA, cutoff);
        return (int)cudaGetLastError();
      });
    });
  }
  if (S == 3 && N <= kSymRows * kSymGroups) {
    const int groups = (N + kSymRows - 1) / kSymRows;
    const dim3 grid((unsigned)((F + kLanes - 1) / kLanes), 1u, (unsigned)B);
    return with_shape(S, RA, [&](auto, auto ra_c) {
      constexpr int kRA = decltype(ra_c)::value;
      constexpr int kTile = kSymRows * (kSymRows - 1) / 2 + kSymRows * kSymRows;
      const size_t smem = sizeof(float4) * N
                          + sizeof(float) * groups * kTile * record_width(kRA)
                          + sizeof(float) * N * 4 * kLanes;
      static int allowed[kMaxDevices] = {};
      const int err = allow_smem(fused_message_sym_kernel<kRA>, smem, allowed);
      if (err != 0) return err;
      fused_message_sym_kernel<kRA><<<grid, groups * kLanes, smem, (cudaStream_t)stream>>>(
          (const float*)xyz, (const float*)mask, (const float*)phi, (const float*)v,
          (const float*)w, (float*)ds, (float*)dv, N, F, cutoff);
      return (int)cudaGetLastError();
    });
  }
  const int warps = fwd_warps(N), rows = warps * kFwdRows;
  const dim3 grid((unsigned)((F + kLanes - 1) / kLanes), (unsigned)((N + rows - 1) / rows),
                  (unsigned)B);
  return with_shape(S, RA, [&](auto s_c, auto ra_c) {
    constexpr int kS = decltype(s_c)::value, kRA = decltype(ra_c)::value;
    const size_t smem = sizeof(float4) * N
                        + sizeof(float) * rows * std::min(N, kCols) * record_width(kRA)
                        + sizeof(float) * warps * kRing * (kS + 3) * kLanes;
    static int allowed[kMaxDevices] = {};
    const int err = allow_smem(fused_message_kernel<kRA, kS>, smem, allowed);
    if (err != 0) return err;
    fused_message_kernel<kRA, kS><<<grid, warps * kLanes, smem, (cudaStream_t)stream>>>(
        (const float*)xyz, (const float*)mask, (const float*)phi, (const float*)v,
        (const float*)w, (float*)ds, (float*)dv, N, F, cutoff);
    return (int)cudaGetLastError();
  });
}

// Node tiles of the templated backward's grid (R+1 <= 16): its dw_part
// holds B * tiles partial sums.
extern "C" int fused_message_bwd_tiles(int N) { return N <= 0 ? 1 : cgvae::bwd_tiles(N); }

// Partial sums of d_w that the backward writes for (B, N, R+1), one per
// (batch element, node tile) of either path's grid.
extern "C" int fused_message_bwd_partials(int B, int N, int RA) {
  using namespace cgvae;
  if (B <= 0 || N <= 0) return 0;
  return B * (RA > kTemplateMaxRA ? wide_bwd_tiles(N) : bwd_tiles(N));
}

// dw_part is scratch of fused_message_bwd_partials(B, N, RA) * RA * S * F
// floats; dw receives its sum.
extern "C" int fused_message_bwd(
    const void* xyz, const void* mask, const void* phi, const void* v,
    const void* w, const void* gs, const void* gv, void* dphi, void* dv,
    void* dw_part, void* dw, int B, int N, int S, int F, int RA,
    float cutoff, void* stream) {
  using namespace cgvae;
  const cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || N <= 0)
    return (int)cudaMemsetAsync(dw, 0, sizeof(float) * RA * S * F, st);
  if (RA > kTemplateMaxRA) {
    const int warps = wide_bwd_warps(N), tiles = wide_bwd_tiles(N);
    const int rows = warps * kBwdTogether, cols = std::min(N, kCols);
    const dim3 grid((unsigned)((F + kLanes - 1) / kLanes), (unsigned)tiles, (unsigned)B);
    const int err = with_wide(S, RA, [&](auto s_c, auto c_c) {
      return with_exact(RA, [&](auto e_c) {
        constexpr int kS = decltype(s_c)::value, kC = decltype(c_c)::value;
        constexpr bool kE = decltype(e_c)::value;
        const size_t geo = std::max(rows * cols * record_width(kC), warps * kC * kS * kLanes);
        const size_t smem = sizeof(float4) * N + sizeof(float) * geo
                            + sizeof(float4) * (kS == 4 ? 3 : 1) * cols * kLanes;
        static int allowed[kMaxDevices] = {};
        const int e = allow_smem(fused_message_bwd_wide_kernel<kC, kS, kE>, smem, allowed);
        if (e != 0) return e;
        fused_message_bwd_wide_kernel<kC, kS, kE><<<grid, warps * kLanes, smem, st>>>(
            (const float*)xyz, (const float*)mask, (const float*)phi, (const float*)v,
            (const float*)w, (const float*)gs, (const float*)gv, (float*)dphi, (float*)dv,
            (float*)dw_part, N, F, RA, cutoff);
        return (int)cudaGetLastError();
      });
    });
    if (err != 0) return err;
    return launch_sum_over_batch((const float*)dw_part, (float*)dw, B * tiles, RA * S * F, st);
  }
  const int warps = bwd_warps(N), tiles = bwd_tiles(N);
  const int rows = warps * kBwdRows, cols = std::min(N, kCols);
  const dim3 grid((unsigned)((F + kLanes - 1) / kLanes), (unsigned)tiles, (unsigned)B);
  const int err = with_shape(S, RA, [&](auto s_c, auto ra_c) {
    constexpr int kS = decltype(s_c)::value, kRA = decltype(ra_c)::value;
    const size_t stage = sizeof(float4) * N + sizeof(float) * rows * cols * record_width(kRA)
                         + sizeof(float4) * (kS == 4 ? 3 : 1) * cols * kLanes;
    const size_t reduce = sizeof(float) * warps * kRA * kS * kLanes;
    const size_t smem = stage > reduce ? stage : reduce;
    static int allowed[kMaxDevices] = {};
    const int e = allow_smem(fused_message_bwd_kernel<kRA, kS>, smem, allowed);
    if (e != 0) return e;
    fused_message_bwd_kernel<kRA, kS><<<grid, warps * kLanes, smem, st>>>(
        (const float*)xyz, (const float*)mask, (const float*)phi, (const float*)v,
        (const float*)w, (const float*)gs, (const float*)gv, (float*)dphi, (float*)dv,
        (float*)dw_part, N, F, cutoff);
    return (int)cudaGetLastError();
  });
  if (err != 0) return err;
  return launch_sum_over_batch((const float*)dw_part, (float*)dw, B * tiles,
                               RA * S * F, st);
}
