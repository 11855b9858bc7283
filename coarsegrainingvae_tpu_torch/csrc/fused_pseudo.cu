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
// with the geometry of pair_geometry.cuh (one record per unordered pair:
// K and adj are symmetric, unit is antisymmetric). The backward takes gs,
// gsb (B,M,F) and gv, gvb (B,M,3,F) and writes d_phi (B,M,9,F), d_s, d_sbar
// (B,M,F), d_v, d_vbar (B,M,3,F) and d_w (R+1,9,F) summed over the batch; xyz
// and mask get no gradient (the JAX contract, pallas_pseudo.py:27-31). The
// receiver cotangents of the sums a_ch are Gamma_2 = gv, Gamma_3 = gv x v,
// Gamma_4 = sbar gv, Gamma_5 = gvb, Gamma_6 = sbar gvb, Gamma_7 = gvb x v,
// Gamma_8 = gvb x vbar (pallas_pseudo.py:237-245). For receiver i and sender
// j the cotangent of g_ch[i,j] is
//
//   dG_0 = s_i gs_i,  dG_1 = gv_i . unit_ij,  dG_ch = Gamma_ch(i) . x_ch,j
//   d_phi[j,ch] += filt_ch dG_ch[i,j],  d_x_ch,j += filt_ch phi[j,ch] Gamma_ch(i)
//   d_w[r,ch]    = sum_b sum_{i<j} K[i,j,r] (phi[j,ch] dG_ch[i,j] + phi[i,ch] dG_ch[j,i])
//
// and node i as a receiver adds d_s_i = s0_i gs_i, d_sbar_i = a4_i . gv_i +
// a6_i . gvb_i, d_v_i += a3_i x gv_i + a7_i x gvb_i + gsb_i t_i and
// d_vbar_i += a8_i x gvb_i, with s0, t and a_ch recomputed as in the forward,
// and the dsbar path d_vbar_j += sum_i adj_ij gsb_i v_i.
//
// What bounds them on this card (chip_smoke.py::kernel_cost, the least
// work of each function). At the decoder's shapes (M = 3 beads, F = 600,
// R+1 = 9) both are bound by bytes: the forward reads 17 and writes 8 floats
// per node and feature (23.2 MB at B 128, 6.9 us at 3.35 TB/s; 11.7 MB,
// 3.5 us, at B 64) against 0.05 GFLOP; the backward reads 25 and writes 17
// (39.1 MB at B 128, 11.7 us) against 0.09 GFLOP. A frame is 3 nodes and 3
// pairs, so each thread's work per frame is short, and what the kernels
// reach is set by per-block latency (loads, geometry, a launch of ~3 us in
// a CUDA graph) more than by either rate.
//
// Design, M <= kRegMax = 6 (the register path; the dipeptide's 3 beads and
// chignolin's 6):
// - A block owns 32 features, one per lane, and a group of frames; each of
//   its 4 warps takes one frame at a time. Every per-node read and write is
//   one coalesced 128-byte line. The block stages w[:, :, its 32 features]
//   in shared memory once and every frame of the group reads it from there.
// - Per frame the warp builds each unordered pair's record once
//   (pair_geometry.cuh::pair_record, one lane per pair) in its shared
//   memory; the lanes read them as broadcasts. A thread loads every input of
//   its frame, phi included, before the channel walk, so a warp has a
//   frame's lines (51 in the forward, 75 in the backward at M = 3) in flight
//   together.
// - One thread holds every node of its frame (R+1 and the node bound MC in
//   {3, 6} are template parameters; M < MC is predicated). It walks the nine
//   channels; per channel each unordered pair's filter is folded once, R+1
//   FMAs, and serves both directions (channel 1 takes -unit for the reverse
//   one). The gates and crosses of a channel are linear in its sums and are
//   applied once per node at the channel's end, so nothing of a channel
//   outlives it but the outputs.
// - Backward: the same walk, with the forward's sums recomputed. d_w's
//   chain for a pair is one (R+1)-long FMA chain on phi[j] dG[i,j] +
//   phi[i] dG[j,i]. Each thread adds its frame's d_w for a channel into its
//   own column in shared memory; at the end the block adds its four warps'
//   columns in a fixed order and writes one partial per (frame group,
//   feature), once. sum_over_batch adds the partials in a fixed order: no
//   atomics, d_w is deterministic. fused_pseudo_bwd_partials(B, M) says how
//   many partials the scratch holds.
// Design, M > kRegMax (the chunked path: chignolin with ten beads, M 10;
// the kernel shape table's PCN-scale M 100 and 300). Past a few beads both
// functions are bound by operations: at B 4, M 100 and B 1, M 300 (F 600,
// R+1 9, nearly every pair inside the cutoff) the forward needs 3.4 / 7.8
// GFLOP (0.051 / 0.116 ms at 67 TFLOP/s) against 24 / 18 MB, the backward
// 7.7 / 17.5 GFLOP (0.115 / 0.262 ms). At M 10, B 16 it is bytes again
// (10 / 17 MB, 3 / 5 us) and a block's work is short.
// - Grid (F / 32, node tiles, B). A block owns one batch element, a tile of
//   up to 8 nodes (receivers in the forward, nodes p in the backward; M is
//   split evenly, chunk_tiling) and 32 features, one per lane; each of its
//   up to 4 warps holds kTileRows = 2 of the tile's nodes in registers.
//   That is 722 blocks at B 1, M 300, 988 at B 4, M 100 and 608 at B 16,
//   M 10, two per SM. Every per-node read and write is one coalesced
//   128-byte line.
// - Partners come in chunks of kFwdChunk = 32 (forward) or kBwdChunk = 16
//   (backward). The block stages a chunk's partner rows in shared memory
//   with cp.async, one copy per (partner, row, lane), while it builds the
//   records of its (tile node, chunk partner) pairs, each once per chunk
//   (pair_geometry.cuh::pair_record). Every warp reads a staged row, and it
//   feeds both of a thread's nodes. Rows a thread holds past the tile or
//   past M get zero records, so the two nodes run without a branch and
//   interleave; a partner is skipped only when both records are zero.
// - Forward: each thread holds w[:, :, f] ((R+1) x 9 registers) and 25 sums
//   per node. Per (partner, node) it folds the nine filters, 9 (R+1) FMAs,
//   and adds the channels' terms; the gates are applied once per node at
//   the end.
// - Backward: per chunk a thread walks the nine channels, and per channel
//   the chunk's partners q: node p as the receiver of q (the forward's sums
//   a_ch and t, whose gates are linear in them and are applied to the
//   chunk's sum at the channel's end) and p as the sender to q (d_phi, the
//   sender side of d_v and d_vbar, d_w). w[:, ch] comes from shared memory
//   per (chunk, channel); the thread's d_w for the channel, one (R+1)-long
//   FMA chain on phi[p, ch] dG per pair, goes into its own column of shared
//   memory at the channel's end. So a thread holds its two nodes' inputs and
//   sums (~80 registers), not w and d_w of all nine channels (2 x 81 at
//   R+1 9), and reads each record from shared memory once per channel as a
//   broadcast. The block adds its warps' columns in a fixed order and writes
//   one partial per (batch element, node tile), once; sum_over_batch adds
//   the partials in a fixed order: no atomics, d_w is deterministic. The
//   partner loop is unrolled by two, so one partner's loads overlap the
//   other's arithmetic.
// - Each ordered pair's filters are folded once: K is symmetric, but a block
//   writes only its own rows, so the other direction of a pair belongs to
//   another block (the bound counts each unordered pair's filters once).
// Design, R+1 > 16 (the wide kernels): R+1 is a runtime value, cut into the
//   fewest chunks of at most kPseudoChunk = 9 functions, all of one width C
//   in 7..9 (a template parameter; the last chunk zero-padded: R+1 = 21 is
//   three chunks of 7). Each chunk's records come from
//   pair_geometry.cuh::chunk_record (an accurate sincospif at the chunk's
//   first angle, then at most 8 recurrence steps, so the error does not grow
//   with R; past R+1 = 32 each function rounded as the plain version rounds
//   it, the template flag E). Every
//   output is linear in the filter, so the node sums stay in registers
//   across the chunks and each chunk adds its share; the gates are linear in
//   their sums and take each chunk's share as it comes; the adjacency sums
//   (t, the dsbar path) come with the first chunk. Nothing per basis
//   function sits in shared memory, so the card sets no bound on R+1.
// - M <= kWideRegMax = 3 (fused_pseudo_wide_reg_kernel,
//   fused_pseudo_bwd_wide_reg_kernel): the register path's layout, one
//   frame per warp, 4 per block. Per chunk the block stages the chunk's w
//   (C x 9 per lane) with cp.async and each warp builds its frame's chunk
//   records; each pair's filter is folded once for both directions. The
//   backward keeps d_phi of all nine channels (27 sums) in registers across
//   the chunks and each thread's d_w column of one chunk in shared memory;
//   at a chunk's end the block adds its warps' columns in a fixed order and
//   writes that chunk's rows of its partial, one per 4 frames.
// - M > 3 (fused_pseudo_wide_chunk_kernel, fused_pseudo_bwd_wide_chunk_
//   kernel): the chunked path's node tiles and cp.async-staged partner
//   chunks, each record built once per (tile, partner chunk, basis chunk).
//   The forward holds one chunk's w (C x 9) in registers. The backward walks,
//   per frame, the basis chunks, and per chunk the partner chunks and
//   channels as the chunked backward does, with that chunk's w and each
//   thread's d_w column in shared memory, and writes each chunk's rows of
//   its one partial per (frame, node tile).
// - Why chunks of at most 9, fewer than the message kernels' 12: a thread
//   holds two nodes' inputs and 25 sums (chunked forward) or ~78 values
//   (chunked backward) beside the chunk's w, and the register backward its
//   frame's inputs and sums (phi and d_phi in shared memory, private to the
//   thread, keep it without spills).
// - Measured (scripts/kernel_ab.py against the one-warp wide kernels that
//   came before, 10 alternating pairs; one H100 80GB HBM3 at 700.00 W;
//   PERF.md has the runs), F 600, n_rbf 20: B 128, M 3 forward 0.1016 ->
//   0.0270 ms, backward 0.5959 -> 0.0816 (26 / 15 % of the bound); B 16,
//   M 10 0.6215 -> 0.0455 / 1.0716 -> 0.1829; B 4, M 100 67.30 -> 0.519 /
//   115.9 -> 1.887. ptxas at C 7-9, no spills: register forward 127-128,
//   register backward 237-243, chunked forward 196-222, chunked backward
//   183-201. Tried and not kept: the node tiles at M <= 3 (backward 0.499 ms
//   at B 128, M 3: one frame's short work per block, three barriers per
//   chunk), and frame groups re-reading one d_w partial per group (dropped
//   for one partial per frame once M <= 3 took the register layout: none
//   of the timed shapes grouped frames any more).
// Measured (scripts/kernel_ab.py against the previous design, one block per
//   (frame, receiver) or per (frame, 128 features) with threads striding
//   over F and the basis padded to 16; one H100 80GB HBM3 at 700 W; PERF.md
//   has the runs): forward 0.069 -> 0.014 ms at B 128
//   and 0.065 -> 0.010 ms at B 64, backward 0.238 -> 0.035 ms at B 128, M 3.
//   ptxas at R+1 = 9: forward <9,3> 107 registers, backward <9,3> 165, no
//   spills. Tried and not kept: one frame per warp at B 128, twice the
//   blocks and the partials (forward 0.0177 against 0.0149 ms, backward
//   0.0463 against 0.0381, measured before phi was loaded up front), and
//   issuing a frame's loads before the staging of w and the geometry (no
//   gain measured).
// Measured, chunked path (scripts/kernel_ab.py against the previous chunked
//   design, one block per (batch element, receiver) in the forward and per
//   (batch element, 128 features) in the backward, threads striding over F,
//   10 alternating pairs; scripts/kernel_table.py; one H100 80GB HBM3 at
//   700.00 W; F 600, R 8 unless stated; PERF.md has the runs):
//   backward 43.33 -> 0.714 ms at B 4, M 100 and 376.2 -> 1.533 ms at B 1,
//   M 300 (16.3 / 17.3 % of the bound; the plain version under torch.compile
//   takes 5.65 / 17.89 ms); forward 2.130 -> 0.182 ms and 6.169 -> 0.393 ms
//   (28.3 / 29.6 %); chignolin with ten beads (B 16, M 10, R 10) forward
//   0.181 -> 0.020 ms, backward 0.567 -> 0.094 ms. ptxas: forward 197
//   registers at R+1 = 9 and 215 at 11, backward 199 and 222, no spills.
//   Tried and not kept: a branch per node instead of per partner (1.29-1.31x
//   slower backward, 1.17-1.18x slower forward), and the forward's partner
//   loop unrolled by two (no gain, 17 more registers).
// Left out, and why:
// - Tensor cores: a contraction depth of M = 3 leaves them nothing. On the
//   chunked path the per-basis contraction K_r (M x M) @ payload has depth
//   M = 100-300, but single-pass TF32 (~5e-4 relative) fails the 1e-4 gate,
//   so it takes the 3xTF32 split, three MMAs per product; that becomes the
//   lever once this design reaches about half its FP32 bound, as in
//   fused_message.cu.
// - M = 6 (chignolin) runs the register path at 255 registers in the
//   backward, two blocks per SM, 0.09-0.12 ms at B 64: it holds six nodes'
//   inputs and sums; a layout of its own waits for a benchmark cell at
//   M 6.
// - The TPU kernels' batch tiling, their VMEM budget (_tile_b_budget) and
//   the Mosaic bead padding (_pad_beads): nothing on this card calls for
//   them.

#include <algorithm>

#include "pair_geometry.cuh"

namespace cgvae {
namespace {

constexpr int kCh = 9;
constexpr int kLanes = 32;          // features per block, one per lane (register path)
constexpr int kWarps = 4;           // warps per block, one frame each at a time
constexpr int kRegMax = 6;          // the register path takes M <= kRegMax
constexpr int kPseudoChunk = 9;     // basis functions per chunk of the wide kernels, at most
constexpr int kWideRegMax = 3;      // the wide register kernels take M <= kWideRegMax

// channels whose sender payload is v (the rest of 2..8 carry vbar)
__host__ __device__ constexpr bool carries_v(int ch) { return ch == 2 || ch == 6 || ch == 7; }

// c += a x b
__device__ __forceinline__ void add_cross(float* c, const float* a, const float* b) {
  c[0] += a[1] * b[2] - a[2] * b[1];
  c[1] += a[2] * b[0] - a[0] * b[2];
  c[2] += a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// ---------------------------------------------------------------------------
// Register path, M <= kRegMax

// unordered pairs (a < c) of MC nodes, in the order a = 0, 1, ...
__host__ __device__ constexpr int n_pairs(int MC) { return MC * (MC - 1) / 2; }
__host__ __device__ constexpr int pair_index(int MC, int a, int c) {
  return a * (2 * MC - 1 - a) / 2 + c - a - 1;
}

// One warp's frame in shared memory: the nodes and the pair records.
template <int RA, int MC>
struct FrameGeo {
  alignas(16) float rec[n_pairs(MC)][record_width(RA)];
  float4 nodes[MC];
  float adj[n_pairs(MC)];
};

// The warp builds its frame's records, one lane per unordered pair.
template <int RA, int MC>
__device__ __forceinline__ void build_frame(FrameGeo<RA, MC>& geo, const float* xb,
                                            const float* mb, int M, int lane,
                                            float cutoff, float pi_c) {
  __syncwarp();                       // the warp's reads of the previous frame are done
  if (lane < M)
    geo.nodes[lane] = make_float4(xb[lane * 3 + 0], xb[lane * 3 + 1], xb[lane * 3 + 2], mb[lane]);
  __syncwarp();
  if (lane < n_pairs(MC)) {
    int a = 0, e = lane;
    while (e >= MC - 1 - a) e -= MC - 1 - a, ++a;
    geo.adj[lane] = pair_record<RA>(geo.rec[lane], geo.nodes, a, a + 1 + e, M, cutoff, pi_c);
  }
  __syncwarp();
}

// Stage w[:, :, the block's 32 features] as (RA * 9, lane); the idle lanes of
// the last tile repeat F - 1.
template <int RA>
__device__ __forceinline__ void stage_w(float* ws, const float* __restrict__ w, int F) {
  for (int t = threadIdx.x; t < RA * kCh * kLanes; t += blockDim.x)
    ws[t] = w[(size_t)(t / kLanes) * F + min((int)blockIdx.x * kLanes + t % kLanes, F - 1)];
}

// Grid (F / 32, frame groups); frame group y holds frames y * 4 fpw ..
// y * 4 fpw + 4 fpw - 1, warp k of the block takes every 4th of them.
template <int RA, int MC>
__global__ void __launch_bounds__(kLanes * kWarps, MC <= 3 ? 4 : 3)
fused_pseudo_kernel(
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
    int B, int M, int F, int fpw, float cutoff) {
  constexpr int W = record_width(RA);
  __shared__ float ws[RA * kCh * kLanes];
  __shared__ FrameGeo<RA, MC> frames[kWarps];

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const float pi_c = kPi / cutoff;
  FrameGeo<RA, MC>& geo = frames[warp];
  stage_w<RA>(ws, w, F);
  __syncthreads();

  for (int k = 0; k < fpw; ++k) {
    const int b = (blockIdx.y * fpw + k) * kWarps + warp;
    if (b >= B) break;
    build_frame<RA, MC>(geo, xyz + (size_t)b * M * 3, mask + (size_t)b * M, M, lane, cutoff, pi_c);
    const size_t n0 = (size_t)b * M;

    // the frame's payloads: x[0] = v, x[1] = vbar
    float sv[MC], sb[MC], x[2][MC][3];
    float o_ds[MC], o_dsb[MC], o_dv[MC][3], o_dvb[MC][3];
#pragma unroll
    for (int a = 0; a < MC; ++a) {
      const bool on = a < M;
      sv[a] = on ? s[(n0 + a) * F + f] : 0.f;
      sb[a] = on ? sbar[(n0 + a) * F + f] : 0.f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        x[0][a][d] = on ? v[((n0 + a) * 3 + d) * F + f] : 0.f;
        x[1][a][d] = on ? vbar[((n0 + a) * 3 + d) * F + f] : 0.f;
        o_dv[a][d] = o_dvb[a][d] = 0.f;
      }
      o_ds[a] = o_dsb[a] = 0.f;
    }
    float phv[kCh][MC];               // every phi of the frame, loaded up front
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch)
#pragma unroll
      for (int a = 0; a < MC; ++a) phv[ch][a] = a < M ? phi[((n0 + a) * kCh + ch) * F + f] : 0.f;
    // dsbar_a = v_a . sum_c adj vbar_c, both directions of each pair
#pragma unroll
    for (int a = 0; a < MC - 1; ++a)
#pragma unroll
      for (int c = a + 1; c < MC; ++c) {
        if (c >= M) break;
        const float adj = geo.adj[pair_index(MC, a, c)];
        o_dsb[a] = fmaf(adj, dot3(x[0][a], x[1][c]), o_dsb[a]);
        o_dsb[c] = fmaf(adj, dot3(x[0][c], x[1][a]), o_dsb[c]);
      }

#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      float wc[RA], ph[MC], acc[MC][3];
#pragma unroll
      for (int r = 0; r < RA; ++r) wc[r] = ws[(r * kCh + ch) * kLanes + lane];
#pragma unroll
      for (int a = 0; a < MC; ++a) {
        ph[a] = phv[ch][a];
        acc[a][0] = acc[a][1] = acc[a][2] = 0.f;
      }
#pragma unroll
      for (int a = 0; a < MC - 1; ++a)
#pragma unroll
        for (int c = a + 1; c < MC; ++c) {
          if (c >= M) break;
          float g[W];
          load_record(g, geo.rec[pair_index(MC, a, c)]);
          float filt = 0.f;
#pragma unroll
          for (int r = 0; r < RA; ++r) filt = fmaf(g[r], wc[r], filt);
          const float ga = filt * ph[c], gc = filt * ph[a];  // receiver a, receiver c
          if (ch == 0) {
            acc[a][0] += ga;
            acc[c][0] += gc;
          } else if (ch == 1) {               // unit_ca = -unit_ac
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              acc[a][d] = fmaf(ga, g[RA + d], acc[a][d]);
              acc[c][d] = fmaf(-gc, g[RA + d], acc[c][d]);
            }
          } else {
            const int xi = carries_v(ch) ? 0 : 1;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              acc[a][d] = fmaf(ga, x[xi][c][d], acc[a][d]);
              acc[c][d] = fmaf(gc, x[xi][a][d], acc[c][d]);
            }
          }
        }
      // the channel's gate, once per node
#pragma unroll
      for (int a = 0; a < MC; ++a) {
        float* A = acc[a];
        switch (ch) {
          case 0: o_ds[a] = sv[a] * A[0]; break;
          case 1:
          case 2: o_dv[a][0] += A[0]; o_dv[a][1] += A[1]; o_dv[a][2] += A[2]; break;
          case 3: add_cross(o_dv[a], x[0][a], A); break;
          case 4: for (int d = 0; d < 3; ++d) o_dv[a][d] = fmaf(sb[a], A[d], o_dv[a][d]); break;
          case 5: o_dvb[a][0] += A[0]; o_dvb[a][1] += A[1]; o_dvb[a][2] += A[2]; break;
          case 6: for (int d = 0; d < 3; ++d) o_dvb[a][d] = fmaf(sb[a], A[d], o_dvb[a][d]); break;
          case 7: add_cross(o_dvb[a], x[0][a], A); break;
          default: add_cross(o_dvb[a], x[1][a], A); break;
        }
      }
    }

    if (f_out < F) {
#pragma unroll
      for (int a = 0; a < MC; ++a) {
        if (a >= M) break;
        ds[(n0 + a) * F + f] = o_ds[a];
        dsbar[(n0 + a) * F + f] = o_dsb[a];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          dv[((n0 + a) * 3 + d) * F + f] = o_dv[a][d];
          dvbar[((n0 + a) * 3 + d) * F + f] = o_dvb[a][d];
        }
      }
    }
  }
}

// Dynamic shared memory: w as (RA * 9, lane), then each thread's d_w column,
// (RA * 9, thread).
template <int RA, int MC>
__global__ void __launch_bounds__(kLanes * kWarps, MC <= 3 ? 3 : 2)
fused_pseudo_bwd_kernel(
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
    float* __restrict__ dw_part,      // (frame groups, RA, 9, F)
    int B, int M, int F, int fpw, float cutoff) {
  constexpr int W = record_width(RA);
  constexpr int kThreads = kLanes * kWarps;
  extern __shared__ float4 smem[];
  __shared__ FrameGeo<RA, MC> frames[kWarps];

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const float pi_c = kPi / cutoff;
  float* ws = reinterpret_cast<float*>(smem);
  float* dws = ws + RA * kCh * kLanes + threadIdx.x;   // this thread's column, stride kThreads
  FrameGeo<RA, MC>& geo = frames[warp];
  stage_w<RA>(ws, w, F);
#pragma unroll
  for (int rc = 0; rc < RA * kCh; ++rc) dws[rc * kThreads] = 0.f;
  __syncthreads();

  for (int k = 0; k < fpw; ++k) {
    const int b = (blockIdx.y * fpw + k) * kWarps + warp;
    if (b >= B) break;
    build_frame<RA, MC>(geo, xyz + (size_t)b * M * 3, mask + (size_t)b * M, M, lane, cutoff, pi_c);
    const size_t n0 = (size_t)b * M;

    // the frame's inputs: x[0] = v, x[1] = vbar; sig = s gs (dG_0)
    float x[2][MC][3], gvv[MC][3], gvbv[MC][3], sb[MC], sig[MC], gsv[MC], gsbv[MC];
    // the sums: dx[0] = d_v, dx[1] = d_vbar
    float dx[2][MC][3], dsb[MC];
#pragma unroll
    for (int a = 0; a < MC; ++a) {
      const bool on = a < M;
      const size_t n = n0 + a;
      sb[a] = on ? sbar[n * F + f] : 0.f;
      gsv[a] = on ? gs[n * F + f] : 0.f;
      gsbv[a] = on ? gsb[n * F + f] : 0.f;
      sig[a] = on ? s[n * F + f] * gsv[a] : 0.f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        x[0][a][d] = on ? v[(n * 3 + d) * F + f] : 0.f;
        x[1][a][d] = on ? vbar[(n * 3 + d) * F + f] : 0.f;
        gvv[a][d] = on ? gv[(n * 3 + d) * F + f] : 0.f;
        gvbv[a][d] = on ? gvb[(n * 3 + d) * F + f] : 0.f;
        dx[0][a][d] = dx[1][a][d] = 0.f;
      }
      dsb[a] = 0.f;
    }
    float phv[kCh][MC];               // every phi of the frame, loaded up front
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch)
#pragma unroll
      for (int a = 0; a < MC; ++a) phv[ch][a] = a < M ? phi[((n0 + a) * kCh + ch) * F + f] : 0.f;
    // the dsbar path: d_v_a += gsb_a adj vbar_c, d_vbar_c += adj gsb_a v_a,
    // both directions of each pair
#pragma unroll
    for (int a = 0; a < MC - 1; ++a)
#pragma unroll
      for (int c = a + 1; c < MC; ++c) {
        if (c >= M) break;
        const float adj = geo.adj[pair_index(MC, a, c)];
        const float ga = adj * gsbv[a], gc = adj * gsbv[c];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          dx[0][a][d] = fmaf(ga, x[1][c][d], dx[0][a][d]);
          dx[0][c][d] = fmaf(gc, x[1][a][d], dx[0][c][d]);
          dx[1][a][d] = fmaf(gc, x[0][c][d], dx[1][a][d]);
          dx[1][c][d] = fmaf(ga, x[0][a][d], dx[1][c][d]);
        }
      }

#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      const int xi = carries_v(ch) ? 0 : 1;
      float wc[RA], ph[MC], gam[MC][3];
      // fa: the forward's sum at each receiver (s0 in fa[.][0] for ch 0);
      // bx: sum_i filt Gamma_ch(i) at each sender; dph: d_phi[., ch]
      float fa[MC][3], bx[MC][3], dph[MC], dwc[RA];
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        wc[r] = ws[(r * kCh + ch) * kLanes + lane];
        dwc[r] = 0.f;
      }
#pragma unroll
      for (int a = 0; a < MC; ++a) {
        ph[a] = phv[ch][a];
        dph[a] = 0.f;
#pragma unroll
        for (int d = 0; d < 3; ++d) fa[a][d] = bx[a][d] = 0.f;
        switch (ch) {                   // Gamma_ch(a)
          case 2: case 5: {
            const float* g = ch == 2 ? gvv[a] : gvbv[a];
            gam[a][0] = g[0]; gam[a][1] = g[1]; gam[a][2] = g[2];
            break;
          }
          case 4: case 6: {
            const float* g = ch == 4 ? gvv[a] : gvbv[a];
            for (int d = 0; d < 3; ++d) gam[a][d] = sb[a] * g[d];
            break;
          }
          case 3: case 7: case 8: {
            const float* g = ch == 3 ? gvv[a] : gvbv[a];
            const float* u = ch == 8 ? x[1][a] : x[0][a];
            gam[a][0] = gam[a][1] = gam[a][2] = 0.f;
            add_cross(gam[a], g, u);
            break;
          }
          default: gam[a][0] = gam[a][1] = gam[a][2] = 0.f; break;
        }
      }
#pragma unroll
      for (int a = 0; a < MC - 1; ++a)
#pragma unroll
        for (int c = a + 1; c < MC; ++c) {
          if (c >= M) break;
          float g[W];
          load_record(g, geo.rec[pair_index(MC, a, c)]);
          float filt = 0.f;
#pragma unroll
          for (int r = 0; r < RA; ++r) filt = fmaf(g[r], wc[r], filt);
          float dac, dca;                 // dG[a, c] (receiver a), dG[c, a]
          if (ch == 0) {
            dac = sig[a];
            dca = sig[c];
            fa[a][0] = fmaf(filt, ph[c], fa[a][0]);
            fa[c][0] = fmaf(filt, ph[a], fa[c][0]);
          } else if (ch == 1) {           // unit_ca = -unit_ac
            dac = dot3(gvv[a], g + RA);
            dca = -dot3(gvv[c], g + RA);
          } else {
            dac = dot3(gam[a], x[xi][c]);
            dca = dot3(gam[c], x[xi][a]);
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              bx[c][d] = fmaf(filt, gam[a][d], bx[c][d]);
              bx[a][d] = fmaf(filt, gam[c][d], bx[a][d]);
            }
            if (ch != 2 && ch != 5) {     // the forward's a_ch, needed by a gate
              const float ga = filt * ph[c], gc = filt * ph[a];
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                fa[a][d] = fmaf(ga, x[xi][c][d], fa[a][d]);
                fa[c][d] = fmaf(gc, x[xi][a][d], fa[c][d]);
              }
            }
          }
          dph[c] = fmaf(filt, dac, dph[c]);
          dph[a] = fmaf(filt, dca, dph[a]);
          const float X = fmaf(ph[c], dac, ph[a] * dca);
#pragma unroll
          for (int r = 0; r < RA; ++r) dwc[r] = fmaf(g[r], X, dwc[r]);
        }
      // per node: d_phi, the sender side and the receiver gates
#pragma unroll
      for (int a = 0; a < MC; ++a) {
        if (a >= M) break;
        if (f_out < F) dphi[((n0 + a) * kCh + ch) * F + f] = dph[a];
        if (ch >= 2)
#pragma unroll
          for (int d = 0; d < 3; ++d) dx[xi][a][d] = fmaf(ph[a], bx[a][d], dx[xi][a][d]);
        switch (ch) {
          case 0: if (f_out < F) d_s[(n0 + a) * F + f] = fa[a][0] * gsv[a]; break;
          case 3: add_cross(dx[0][a], fa[a], gvv[a]); break;
          case 4: dsb[a] += dot3(fa[a], gvv[a]); break;
          case 6: dsb[a] += dot3(fa[a], gvbv[a]); break;
          case 7: add_cross(dx[0][a], fa[a], gvbv[a]); break;
          case 8: add_cross(dx[1][a], fa[a], gvbv[a]); break;
          default: break;
        }
      }
#pragma unroll
      for (int r = 0; r < RA; ++r) dws[(r * kCh + ch) * kThreads] += dwc[r];
    }

    if (f_out < F) {
#pragma unroll
      for (int a = 0; a < MC; ++a) {
        if (a >= M) break;
        d_sbar[(n0 + a) * F + f] = dsb[a];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          d_v[((n0 + a) * 3 + d) * F + f] = dx[0][a][d];
          d_vbar[((n0 + a) * 3 + d) * F + f] = dx[1][a][d];
        }
      }
    }
  }

  // the block's d_w: its warps' columns added in a fixed order, one partial
  // per (frame group, feature)
  __syncthreads();
  const float* cols = ws + RA * kCh * kLanes;
  float* out = dw_part + (size_t)blockIdx.y * RA * kCh * F;
  for (int t = threadIdx.x; t < RA * kCh * kLanes; t += kThreads) {
    const int rc = t / kLanes, ln = t % kLanes, ff = blockIdx.x * kLanes + ln;
    float acc = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) acc += cols[rc * kThreads + wi * kLanes + ln];
    if (ff < F) out[(size_t)rc * F + ff] = acc;
  }
}

// ---------------------------------------------------------------------------
// Chunked path, M > kRegMax (the design note at the top). A block owns one
// batch element, a tile of `rows` nodes and 32 features, one per lane; warp w
// holds the tile's nodes w * kTileRows .. w * kTileRows + kTileRows - 1 in
// registers. Dynamic shared memory: the frame's nodes (x, y, z, mask), in the
// backward w and each thread's d_w column, then one chunk of partner rows
// (partner, slot, lane) and the records of (tile node, chunk partner) with
// their adjacency.

constexpr int kTileRows = 2;        // nodes per thread
constexpr int kTileWarps = 4;       // warps per block at most, so tiles of up to 8 nodes
constexpr int kFwdChunk = 32;       // partners per staged chunk, forward
constexpr int kBwdChunk = 16;       // partners per staged chunk, backward
// a partner's row in the forward: phi (9), v (3), vbar (3)
constexpr int kFwdV = kCh, kFwdVb = kCh + 3, kFwdRow = kCh + 6;
// channels whose forward sum a gate of the backward reads (a3, a4, a6, a7, a8)
__host__ __device__ constexpr bool gated(int ch) { return ch == 3 || ch == 4 || ch >= 6; }
// a partner's row in the backward: phi of channel 0 and of the gated
// channels, then s, gs, sbar, gsb, v, vbar, gv, gvb
constexpr int kBS = 6, kBGs = 7, kBSbar = 8, kBGsb = 9, kBV = 10, kBVb = 13, kBGv = 16,
              kBGvb = 19, kBwdRow = 22;
__host__ __device__ constexpr int phi_slot(int ch) {
  return ch == 0 ? 0 : ch == 3 ? 1 : ch == 4 ? 2 : ch == 6 ? 3 : ch == 7 ? 4 : 5;
}

__device__ __forceinline__ void stage_frame(float4* nodes, const float* __restrict__ xb,
                                            const float* __restrict__ mb, int M) {
  for (int n = threadIdx.x; n < M; n += blockDim.x)
    nodes[n] = make_float4(xb[n * 3 + 0], xb[n * 3 + 1], xb[n * 3 + 2], mb[n]);
}

// The records of the rows the block's threads hold (kTileRows per thread)
// against partners q0 .. q0 + nq - 1, built once per chunk. Rows past the
// tile or past N get zero records, so a thread computes its rows without a
// branch and a row it does not own adds exactly nothing.
template <int RA>
__device__ __forceinline__ void build_tile(float* rec, float* adj, const float4* nodes, int p0,
                                           int rows, int q0, int nq, int cols, int N,
                                           float cutoff, float pi_c) {
  const int held = blockDim.x / kLanes * kTileRows;
  for (int e = threadIdx.x; e < held * nq; e += blockDim.x) {
    const int rr = e / nq, qq = e % nq;
    adj[rr * cols + qq] = pair_record<RA>(rec + (rr * cols + qq) * record_width(RA), nodes,
                                          rr < rows ? p0 + rr : N, q0 + qq, N, cutoff, pi_c);
  }
}

// Rows of the tile that warp `warp` holds: 0 .. kTileRows.
__device__ __forceinline__ int warp_rows(int warp, int rows, int p0, int N) {
  return max(0, min(kTileRows, min(rows, N - p0) - warp * kTileRows));
}

// Grid (F / 32, node tiles, B).
template <int RA>
__global__ void __launch_bounds__(kLanes * kTileWarps, 2)
fused_pseudo_chunk_kernel(
    const float* __restrict__ xyz, const float* __restrict__ mask,
    const float* __restrict__ phi, const float* __restrict__ s,
    const float* __restrict__ sbar, const float* __restrict__ v,
    const float* __restrict__ vbar, const float* __restrict__ w,
    float* __restrict__ ds, float* __restrict__ dsbar, float* __restrict__ dv,
    float* __restrict__ dvbar, int M, int F, int rows, float cutoff) {
  constexpr int W = record_width(RA), P = kFwdRow, TI = kTileRows;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int n_warps = blockDim.x / kLanes, cols = min(M, kFwdChunk);
  const int b = blockIdx.z, i0 = blockIdx.y * rows, mine = warp_rows(warp, rows, i0, M);
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const float pi_c = kPi / cutoff;
  float4* nodes = smem;                                   // (M)
  float* part = reinterpret_cast<float*>(smem + M);       // (cols, P, lane)
  float* rec = part + cols * P * kLanes;                  // (n_warps * TI, cols, W)
  float* adj = rec + n_warps * TI * cols * W;             // (n_warps * TI, cols)
  const size_t n0 = (size_t)b * M;
  const float* phib = phi + n0 * kCh * F + f;
  const float* vb = v + n0 * 3 * F + f;
  const float* vbb = vbar + n0 * 3 * F + f;

  float wr[RA][kCh];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) wr[r][ch] = w[((size_t)r * kCh + ch) * F + f];
  // per node: s0; t = sum adj vbar; dv's direct sum (ch 1 unit, ch 2 v),
  // dvbar's (ch 5 vbar); the gated sums a3, a4, a6, a7, a8
  float s0[TI], t[TI][3], dvd[TI][3], dvbd[TI][3], a[TI][5][3];
#pragma unroll
  for (int k = 0; k < TI; ++k) {
    s0[k] = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      t[k][d] = dvd[k][d] = dvbd[k][d] = 0.f;
#pragma unroll
      for (int e = 0; e < 5; ++e) a[k][e][d] = 0.f;
    }
  }
  stage_frame(nodes, xyz + n0 * 3, mask + n0, M);

  for (int j0 = 0; j0 < M; j0 += kFwdChunk) {
    const int nc = min(kFwdChunk, M - j0);
    __syncthreads();                  // the nodes are staged; the previous chunk's readers are done
    // the chunk's sender rows by cp.async, in flight while the records are built
    for (int qq = warp; qq < nc; qq += n_warps) {
      float* dst = part + qq * P * kLanes + lane;
      const size_t q = j0 + qq;
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) cp_async4(dst + ch * kLanes, phib + (q * kCh + ch) * F);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        cp_async4(dst + (kFwdV + d) * kLanes, vb + (q * 3 + d) * F);
        cp_async4(dst + (kFwdVb + d) * kLanes, vbb + (q * 3 + d) * F);
      }
    }
    cp_async_commit();
    build_tile<RA>(rec, adj, nodes, i0, rows, j0, nc, cols, M, cutoff, pi_c);
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll 1
    for (int qq = 0; qq < nc; ++qq) {   // sender j against the thread's receivers
      float pj[P], g[TI][W];
      const float* src = part + qq * P * kLanes + lane;
#pragma unroll
      for (int e = 0; e < P; ++e) pj[e] = src[e * kLanes];
      bool none = true;                 // adj * env == 0 at every row: no contribution
#pragma unroll
      for (int k = 0; k < TI; ++k) {
        const int rr = warp * TI + k;
        const float aj = adj[rr * cols + qq];
#pragma unroll
        for (int d = 0; d < 3; ++d) t[k][d] = fmaf(aj, pj[kFwdVb + d], t[k][d]);
        load_record(g[k], rec + (rr * cols + qq) * W);
        none = none && g[k][RA - 1] == 0.f;
      }
      if (none) continue;
#pragma unroll
      for (int k = 0; k < TI; ++k) {
        float gg[kCh];                          // g_ch = filt_ch phi[j, ch]
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) {
          float filt = 0.f;
#pragma unroll
          for (int r = 0; r < RA; ++r) filt = fmaf(g[k][r], wr[r][ch], filt);
          gg[ch] = filt * pj[ch];
        }
        s0[k] += gg[0];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float vj = pj[kFwdV + d], vbj = pj[kFwdVb + d];
          dvd[k][d] = fmaf(gg[1], g[k][RA + d], fmaf(gg[2], vj, dvd[k][d]));
          a[k][0][d] = fmaf(gg[3], vbj, a[k][0][d]);
          a[k][1][d] = fmaf(gg[4], vbj, a[k][1][d]);
          dvbd[k][d] = fmaf(gg[5], vbj, dvbd[k][d]);
          a[k][2][d] = fmaf(gg[6], vj, a[k][2][d]);
          a[k][3][d] = fmaf(gg[7], vj, a[k][3][d]);
          a[k][4][d] = fmaf(gg[8], vbj, a[k][4][d]);
        }
      }
    }
  }
  if (f_out >= F) return;

#pragma unroll
  for (int k = 0; k < TI; ++k) {
    if (k >= mine) break;
    const size_t row = n0 + i0 + warp * TI + k;
    const float si = s[row * F + f], gi = sbar[row * F + f];
    float vi[3], vbi[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      vi[d] = v[(row * 3 + d) * F + f];
      vbi[d] = vbar[(row * 3 + d) * F + f];
    }
    ds[row * F + f] = si * s0[k];
    dsbar[row * F + f] = dot3(vi, t[k]);
    float o[3] = {dvd[k][0], dvd[k][1], dvd[k][2]};
    float ob[3] = {dvbd[k][0], dvbd[k][1], dvbd[k][2]};
    add_cross(o, vi, a[k][0]);
    add_cross(ob, vi, a[k][3]);
    add_cross(ob, vbi, a[k][4]);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      dv[(row * 3 + d) * F + f] = fmaf(gi, a[k][1][d], o[d]);
      dvbar[(row * 3 + d) * F + f] = fmaf(gi, a[k][2][d], ob[d]);
    }
  }
}

// Grid (F / 32, node tiles, B). Node p of the thread walks, per chunk, the
// nine channels, and per channel the chunk's partners q: p as the receiver
// of q (the forward's sums, gated at the channel's end) and p as the sender
// to q (d_phi, the sender side of d_v and d_vbar, d_w). The block writes one
// d_w partial, dw_part[b, tile].
template <int RA>
__global__ void __launch_bounds__(kLanes * kTileWarps, 2)
fused_pseudo_bwd_chunk_kernel(
    const float* __restrict__ xyz, const float* __restrict__ mask,
    const float* __restrict__ phi, const float* __restrict__ s,
    const float* __restrict__ sbar, const float* __restrict__ v,
    const float* __restrict__ vbar, const float* __restrict__ w,
    const float* __restrict__ gs, const float* __restrict__ gsb,
    const float* __restrict__ gv, const float* __restrict__ gvb,
    float* __restrict__ dphi, float* __restrict__ d_s, float* __restrict__ d_sbar,
    float* __restrict__ d_v, float* __restrict__ d_vbar,
    float* __restrict__ dw_part,      // (B, node tiles, RA, 9, F)
    int M, int F, int rows, float cutoff) {
  constexpr int W = record_width(RA), P = kBwdRow, TI = kTileRows;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int n_warps = blockDim.x / kLanes, cols = min(M, kBwdChunk);
  const int b = blockIdx.z, p0 = blockIdx.y * rows, mine = warp_rows(warp, rows, p0, M);
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const float pi_c = kPi / cutoff;
  float4* nodes = smem;                                   // (M)
  float* ws = reinterpret_cast<float*>(smem + M);         // (RA * 9, lane)
  float* dws = ws + RA * kCh * kLanes;                    // (RA * 9, thread)
  float* part = dws + RA * kCh * blockDim.x;              // (cols, P, lane)
  float* rec = part + cols * P * kLanes;                  // (n_warps * TI, cols, W)
  float* adj = rec + n_warps * TI * cols * W;             // (n_warps * TI, cols)
  const size_t n0 = (size_t)b * M;

  stage_w<RA>(ws, w, F);
#pragma unroll
  for (int rc = 0; rc < RA * kCh; ++rc) dws[rc * blockDim.x + threadIdx.x] = 0.f;
  stage_frame(nodes, xyz + n0 * 3, mask + n0, M);

  // the thread's nodes: their inputs, and their sums over the partners
  // (dvs and dvbs take the sender side, the gates and the dsbar path)
  float vp[TI][3], vbp[TI][3], php[TI][kCh], gvp[TI][3], gvbp[TI][3], gsbp[TI];
  float dph[TI][kCh], dvs[TI][3], dvbs[TI][3], dsb[TI], s0[TI];
#pragma unroll
  for (int k = 0; k < TI; ++k) {
    const size_t row = n0 + min(p0 + warp * TI + k, M - 1);
    gsbp[k] = gsb[row * F + f];
    dsb[k] = s0[k] = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      vp[k][d] = v[(row * 3 + d) * F + f];
      vbp[k][d] = vbar[(row * 3 + d) * F + f];
      gvp[k][d] = gv[(row * 3 + d) * F + f];
      gvbp[k][d] = gvb[(row * 3 + d) * F + f];
      dvs[k][d] = dvbs[k][d] = 0.f;
    }
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      php[k][ch] = phi[(row * kCh + ch) * F + f];
      dph[k][ch] = 0.f;
    }
  }

  for (int q0 = 0; q0 < M; q0 += kBwdChunk) {
    const int nc = min(kBwdChunk, M - q0);
    __syncthreads();                  // nodes, w, d_w staged; the previous chunk's readers are done
    // the chunk's partner rows by cp.async, in flight while the records are built
    for (int qq = warp; qq < nc; qq += n_warps) {
      float* dst = part + qq * P * kLanes + lane;
      const size_t q = n0 + q0 + qq;
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch)
        if (ch == 0 || gated(ch))
          cp_async4(dst + phi_slot(ch) * kLanes, phi + (q * kCh + ch) * F + f);
      cp_async4(dst + kBS * kLanes, s + q * F + f);
      cp_async4(dst + kBGs * kLanes, gs + q * F + f);
      cp_async4(dst + kBSbar * kLanes, sbar + q * F + f);
      cp_async4(dst + kBGsb * kLanes, gsb + q * F + f);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        cp_async4(dst + (kBV + d) * kLanes, v + (q * 3 + d) * F + f);
        cp_async4(dst + (kBVb + d) * kLanes, vbar + (q * 3 + d) * F + f);
        cp_async4(dst + (kBGv + d) * kLanes, gv + (q * 3 + d) * F + f);
        cp_async4(dst + (kBGvb + d) * kLanes, gvb + (q * 3 + d) * F + f);
      }
    }
    cp_async_commit();
    build_tile<RA>(rec, adj, nodes, p0, rows, q0, nc, cols, M, cutoff, pi_c);
    cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      const bool on_v = carries_v(ch);
      float wc[RA], dwc[RA], ac[TI][3];   // ac: the chunk's forward sum at p (t for ch 0)
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        wc[r] = ws[(r * kCh + ch) * kLanes + lane];
        dwc[r] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < TI; ++k) ac[k][0] = ac[k][1] = ac[k][2] = 0.f;

#pragma unroll 2
      for (int qq = 0; qq < nc; ++qq) {
        const float* src = part + qq * P * kLanes + lane;
        // partner q's share of the channel: x_ch,q and phi[q, ch] for the
        // forward's sum, Gamma_ch(q) (gv for ch 1) and s_q gs_q (ch 0)
        float xq[3] = {0.f, 0.f, 0.f}, gam[3] = {0.f, 0.f, 0.f}, phq = 0.f, sig = 0.f;
        if (ch == 0) {
          phq = src[0];
          sig = src[kBS * kLanes] * src[kBGs * kLanes];
        } else {
          const int gsrc = ch >= 5 ? kBGvb : kBGv;
#pragma unroll
          for (int d = 0; d < 3; ++d) gam[d] = src[(gsrc + d) * kLanes];
          if (gated(ch)) {
            phq = src[phi_slot(ch) * kLanes];
#pragma unroll
            for (int d = 0; d < 3; ++d) xq[d] = src[((on_v ? kBV : kBVb) + d) * kLanes];
          }
          if (ch == 4 || ch == 6) {
            const float sb = src[kBSbar * kLanes];
            gam[0] *= sb; gam[1] *= sb; gam[2] *= sb;
          } else if (ch == 3 || ch == 7 || ch == 8) {   // Gamma = g x v (x vbar for 8)
            float u[3], c[3] = {0.f, 0.f, 0.f};
#pragma unroll
            for (int d = 0; d < 3; ++d) u[d] = src[((ch == 8 ? kBVb : kBV) + d) * kLanes];
            add_cross(c, gam, u);
            gam[0] = c[0]; gam[1] = c[1]; gam[2] = c[2];
          }
        }
        float g[TI][W];
        bool none = true;               // adj * env == 0 at every row: no contribution
#pragma unroll
        for (int k = 0; k < TI; ++k) {
          const int rr = warp * TI + k;
          if (ch == 0) {                  // the dsbar path, both roles
            const float aq = adj[rr * cols + qq];
            const float ag = aq * src[kBGsb * kLanes];
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              ac[k][d] = fmaf(aq, src[(kBVb + d) * kLanes], ac[k][d]);
              dvbs[k][d] = fmaf(ag, src[(kBV + d) * kLanes], dvbs[k][d]);
            }
          }
          load_record(g[k], rec + (rr * cols + qq) * W);
          none = none && g[k][RA - 1] == 0.f;
        }
        if (none) continue;
#pragma unroll
        for (int k = 0; k < TI; ++k) {
          float filt = 0.f;
#pragma unroll
          for (int r = 0; r < RA; ++r) filt = fmaf(g[k][r], wc[r], filt);
          float dG;                             // the cotangent of g_ch[q <- p]
          if (ch == 0) {
            dG = sig;
            s0[k] = fmaf(filt, phq, s0[k]);
          } else if (ch == 1) {                 // unit of (q <- p) is -unit of the record
            dG = -dot3(gam, g[k] + RA);
          } else {
            dG = dot3(gam, on_v ? vp[k] : vbp[k]);
            const float pf = filt * php[k][ch];
            float* dx = on_v ? dvs[k] : dvbs[k];
#pragma unroll
            for (int d = 0; d < 3; ++d) dx[d] = fmaf(pf, gam[d], dx[d]);
            if (gated(ch)) {
              const float fp = filt * phq;
#pragma unroll
              for (int d = 0; d < 3; ++d) ac[k][d] = fmaf(fp, xq[d], ac[k][d]);
            }
          }
          dph[k][ch] = fmaf(filt, dG, dph[k][ch]);
          const float X = php[k][ch] * dG;
#pragma unroll
          for (int r = 0; r < RA; ++r) dwc[r] = fmaf(g[k][r], X, dwc[r]);
        }
      }
      // the channel's gates on the chunk's forward sums; d_w into the
      // thread's column
#pragma unroll
      for (int k = 0; k < TI; ++k) {
        switch (ch) {
          case 0:
#pragma unroll
            for (int d = 0; d < 3; ++d) dvs[k][d] = fmaf(gsbp[k], ac[k][d], dvs[k][d]);
            break;
          case 3: add_cross(dvs[k], ac[k], gvp[k]); break;
          case 4: dsb[k] += dot3(ac[k], gvp[k]); break;
          case 6: dsb[k] += dot3(ac[k], gvbp[k]); break;
          case 7: add_cross(dvs[k], ac[k], gvbp[k]); break;
          case 8: add_cross(dvbs[k], ac[k], gvbp[k]); break;
          default: break;
        }
      }
#pragma unroll
      for (int r = 0; r < RA; ++r) dws[(r * kCh + ch) * blockDim.x + threadIdx.x] += dwc[r];
    }
  }

  if (f_out < F) {
#pragma unroll
    for (int k = 0; k < TI; ++k) {
      if (k >= mine) break;
      const size_t row = n0 + p0 + warp * TI + k;
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) dphi[(row * kCh + ch) * F + f] = dph[k][ch];
      d_s[row * F + f] = s0[k] * gs[row * F + f];
      d_sbar[row * F + f] = dsb[k];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        d_v[(row * 3 + d) * F + f] = dvs[k][d];
        d_vbar[(row * 3 + d) * F + f] = dvbs[k][d];
      }
    }
  }

  // the block's d_w: its warps' columns added in a fixed order, one partial
  // per (batch element, node tile, feature)
  __syncthreads();
  float* out = dw_part + ((size_t)b * gridDim.y + blockIdx.y) * RA * kCh * F;
  for (int e = threadIdx.x; e < RA * kCh * kLanes; e += blockDim.x) {
    const int rc = e / kLanes, ln = e % kLanes, ff = blockIdx.x * kLanes + ln;
    float acc = 0.f;
    for (int wi = 0; wi < n_warps; ++wi) acc += dws[rc * blockDim.x + wi * kLanes + ln];
    if (ff < F) out[(size_t)rc * F + ff] = acc;
  }
}

// ---------------------------------------------------------------------------
// Wide basis, RA > kTemplateMaxRA (the note at the top), at M <= kWideRegMax:
// the register path's layout with the basis in chunks of C <= kPseudoChunk
// functions (pair_geometry.cuh::chunk_record). A block owns 32 features and
// kWarps frames, one per warp, so a thread holds its frame's nodes, inputs
// and sums in registers across the chunks and each chunk adds its share;
// the adjacency sums (dsbar and its path in the backward) are taken with the
// first chunk only. Per chunk the block stages that chunk's w in shared
// memory and each warp builds its frame's chunk records, one lane per
// unordered pair. A warp past B computes nothing but takes the barriers.

// Stage w[r0 .. r0 + C - 1, :, the block's 32 features] as (C * 9, lane),
// zero past RA, by cp.async (one commit group); the idle lanes of the last
// tile repeat F - 1.
template <int C>
__device__ __forceinline__ void stage_w_chunk(float* ws, const float* __restrict__ w, int F,
                                              int r0, int RA) {
  for (int t = threadIdx.x; t < C * kCh * kLanes; t += blockDim.x) {
    const int rc = t / kLanes;
    if (r0 + rc / kCh < RA)
      cp_async4(ws + t, w + (size_t)(r0 * kCh + rc) * F +
                            min((int)blockIdx.x * kLanes + t % kLanes, F - 1));
    else
      ws[t] = 0.f;
  }
  cp_async_commit();
}

// The warp's frame: its nodes (lanes < M), before the first chunk.
template <int C, int MC>
__device__ __forceinline__ void stage_frame_nodes(FrameGeo<C, MC>& geo, const float* xb,
                                                  const float* mb, int M, int lane) {
  if (lane < M)
    geo.nodes[lane] = make_float4(xb[lane * 3 + 0], xb[lane * 3 + 1], xb[lane * 3 + 2], mb[lane]);
}

// The warp's records of a basis chunk, one lane per unordered pair.
template <int C, bool E, int MC>
__device__ __forceinline__ void build_frame_chunk(FrameGeo<C, MC>& geo, int M, int lane, int r0,
                                                  int RA, float cutoff, float inv_cut) {
  if (lane < n_pairs(MC)) {
    int a = 0, e = lane;
    while (e >= MC - 1 - a) e -= MC - 1 - a, ++a;
    geo.adj[lane] = chunk_record<C, E>(geo.rec[lane], geo.nodes, a, a + 1 + e, M, r0, RA, cutoff,
                                       inv_cut);
  }
}

// Grid (F / 32, frame groups of kWarps).
template <int C, bool E>
__global__ void __launch_bounds__(kLanes * kWarps, 4)
fused_pseudo_wide_reg_kernel(
    const float* __restrict__ xyz, const float* __restrict__ mask,
    const float* __restrict__ phi, const float* __restrict__ s,
    const float* __restrict__ sbar, const float* __restrict__ v,
    const float* __restrict__ vbar, const float* __restrict__ w,
    float* __restrict__ ds, float* __restrict__ dsbar, float* __restrict__ dv,
    float* __restrict__ dvbar, int B, int M, int F, int RA, float cutoff) {
  constexpr int MC = kWideRegMax, W = record_width(C);
  __shared__ float ws[C * kCh * kLanes];
  __shared__ FrameGeo<C, MC> frames[kWarps];

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const float inv_cut = 1.f / cutoff;
  const int b = blockIdx.y * kWarps + warp;
  const bool live = b < B;
  const size_t n0 = (size_t)min(b, B - 1) * M;
  FrameGeo<C, MC>& geo = frames[warp];
  stage_frame_nodes<C, MC>(geo, xyz + n0 * 3, mask + n0, M, lane);

  // the frame's payloads: x[0] = v, x[1] = vbar
  float sv[MC], sb[MC], x[2][MC][3], phv[kCh][MC];
  float o_ds[MC], o_dsb[MC], o_dv[MC][3], o_dvb[MC][3];
#pragma unroll
  for (int a = 0; a < MC; ++a) {
    const bool on = a < M;
    sv[a] = on ? s[(n0 + a) * F + f] : 0.f;
    sb[a] = on ? sbar[(n0 + a) * F + f] : 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      x[0][a][d] = on ? v[((n0 + a) * 3 + d) * F + f] : 0.f;
      x[1][a][d] = on ? vbar[((n0 + a) * 3 + d) * F + f] : 0.f;
      o_dv[a][d] = o_dvb[a][d] = 0.f;
    }
    o_ds[a] = o_dsb[a] = 0.f;
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) phv[ch][a] = on ? phi[((n0 + a) * kCh + ch) * F + f] : 0.f;
  }

  for (int r0 = 0; r0 < RA; r0 += C) {
    __syncthreads();                  // the nodes are staged; the previous chunk's readers are done
    stage_w_chunk<C>(ws, w, F, r0, RA);
    build_frame_chunk<C, E, MC>(geo, M, lane, r0, RA, cutoff, inv_cut);
    cp_async_wait<0>();
    __syncthreads();
    if (!live) continue;
    if (r0 == 0)                      // dsbar_a = v_a . sum_c adj vbar_c, both directions
#pragma unroll
      for (int a = 0; a < MC - 1; ++a)
#pragma unroll
        for (int c = a + 1; c < MC; ++c) {
          if (c >= M) break;
          const float adj = geo.adj[pair_index(MC, a, c)];
          o_dsb[a] = fmaf(adj, dot3(x[0][a], x[1][c]), o_dsb[a]);
          o_dsb[c] = fmaf(adj, dot3(x[0][c], x[1][a]), o_dsb[c]);
        }

#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      float wc[C], acc[MC][3];
#pragma unroll
      for (int r = 0; r < C; ++r) wc[r] = ws[(r * kCh + ch) * kLanes + lane];
#pragma unroll
      for (int a = 0; a < MC; ++a) acc[a][0] = acc[a][1] = acc[a][2] = 0.f;
#pragma unroll
      for (int a = 0; a < MC - 1; ++a)
#pragma unroll
        for (int c = a + 1; c < MC; ++c) {
          if (c >= M) break;
          float g[W];
          load_record(g, geo.rec[pair_index(MC, a, c)]);
          float filt = 0.f;
#pragma unroll
          for (int r = 0; r < C; ++r) filt = fmaf(g[r], wc[r], filt);
          const float ga = filt * phv[ch][c], gc = filt * phv[ch][a];  // receiver a, receiver c
          if (ch == 0) {
            acc[a][0] += ga;
            acc[c][0] += gc;
          } else if (ch == 1) {               // unit_ca = -unit_ac
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              acc[a][d] = fmaf(ga, g[C + d], acc[a][d]);
              acc[c][d] = fmaf(-gc, g[C + d], acc[c][d]);
            }
          } else {
            const int xi = carries_v(ch) ? 0 : 1;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              acc[a][d] = fmaf(ga, x[xi][c][d], acc[a][d]);
              acc[c][d] = fmaf(gc, x[xi][a][d], acc[c][d]);
            }
          }
        }
      // the channel's gate on this chunk's share, once per node
#pragma unroll
      for (int a = 0; a < MC; ++a) {
        float* A = acc[a];
        switch (ch) {
          case 0: o_ds[a] = fmaf(sv[a], A[0], o_ds[a]); break;
          case 1:
          case 2: o_dv[a][0] += A[0]; o_dv[a][1] += A[1]; o_dv[a][2] += A[2]; break;
          case 3: add_cross(o_dv[a], x[0][a], A); break;
          case 4: for (int d = 0; d < 3; ++d) o_dv[a][d] = fmaf(sb[a], A[d], o_dv[a][d]); break;
          case 5: o_dvb[a][0] += A[0]; o_dvb[a][1] += A[1]; o_dvb[a][2] += A[2]; break;
          case 6: for (int d = 0; d < 3; ++d) o_dvb[a][d] = fmaf(sb[a], A[d], o_dvb[a][d]); break;
          case 7: add_cross(o_dvb[a], x[0][a], A); break;
          default: add_cross(o_dvb[a], x[1][a], A); break;
        }
      }
    }
  }

  if (live && f_out < F) {
#pragma unroll
    for (int a = 0; a < MC; ++a) {
      if (a >= M) break;
      ds[(n0 + a) * F + f] = o_ds[a];
      dsbar[(n0 + a) * F + f] = o_dsb[a];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        dv[((n0 + a) * 3 + d) * F + f] = o_dv[a][d];
        dvbar[((n0 + a) * 3 + d) * F + f] = o_dvb[a][d];
      }
    }
  }
}

// Grid (F / 32, frame groups of kWarps). Dynamic shared memory: the chunk's
// w as (C * 9, lane), then each thread's d_w column of the chunk, (C * 9,
// thread), and its frame's phi and d_phi sums, (9 * kWideRegMax, thread)
// each: a thread reads and writes only its own columns, and holding phi and
// d_phi there keeps the rest in registers without spills. After each chunk
// the block adds its warps' d_w columns in a fixed order and writes that
// chunk's rows of its partial, dw_part[frame group], once.
template <int C, bool E>
__global__ void __launch_bounds__(kLanes * kWarps, 2)
fused_pseudo_bwd_wide_reg_kernel(
    const float* __restrict__ xyz, const float* __restrict__ mask,
    const float* __restrict__ phi, const float* __restrict__ s,
    const float* __restrict__ sbar, const float* __restrict__ v,
    const float* __restrict__ vbar, const float* __restrict__ w,
    const float* __restrict__ gs, const float* __restrict__ gsb,
    const float* __restrict__ gv, const float* __restrict__ gvb,
    float* __restrict__ dphi, float* __restrict__ d_s, float* __restrict__ d_sbar,
    float* __restrict__ d_v, float* __restrict__ d_vbar,
    float* __restrict__ dw_part,      // (frame groups, RA, 9, F)
    int B, int M, int F, int RA, float cutoff) {
  constexpr int MC = kWideRegMax, W = record_width(C), kThreads = kLanes * kWarps;
  extern __shared__ float4 smem[];
  __shared__ FrameGeo<C, MC> frames[kWarps];

  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const float inv_cut = 1.f / cutoff;
  const int b = blockIdx.y * kWarps + warp;
  const bool live = b < B;
  const size_t n0 = (size_t)min(b, B - 1) * M;
  float* ws = reinterpret_cast<float*>(smem);
  float* dws = ws + C * kCh * kLanes + threadIdx.x;      // this thread's columns, stride kThreads
  float* phs = dws + C * kCh * kThreads;                 // phi[a, ch] at (ch * MC + a)
  float* dphs = phs + kCh * MC * kThreads;               // d_phi[a, ch] likewise
  float* out = dw_part + (size_t)blockIdx.y * RA * kCh * F;
  FrameGeo<C, MC>& geo = frames[warp];
  stage_frame_nodes<C, MC>(geo, xyz + n0 * 3, mask + n0, M, lane);

  // the frame's inputs: x[0] = v, x[1] = vbar; sig = s gs (dG_0)
  float x[2][MC][3], gvv[MC][3], gvbv[MC][3], sb[MC], sig[MC];
  // the sums: dx[0] = d_v, dx[1] = d_vbar; s0 (d_s / gs), d_sbar
  float dx[2][MC][3], s0[MC], dsb[MC];
#pragma unroll
  for (int a = 0; a < MC; ++a) {
    const bool on = a < M;
    const size_t n = n0 + a;
    sb[a] = on ? sbar[n * F + f] : 0.f;
    sig[a] = on ? s[n * F + f] * gs[n * F + f] : 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      x[0][a][d] = on ? v[(n * 3 + d) * F + f] : 0.f;
      x[1][a][d] = on ? vbar[(n * 3 + d) * F + f] : 0.f;
      gvv[a][d] = on ? gv[(n * 3 + d) * F + f] : 0.f;
      gvbv[a][d] = on ? gvb[(n * 3 + d) * F + f] : 0.f;
      dx[0][a][d] = dx[1][a][d] = 0.f;
    }
    s0[a] = dsb[a] = 0.f;
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      phs[(ch * MC + a) * kThreads] = on ? phi[(n * kCh + ch) * F + f] : 0.f;
      dphs[(ch * MC + a) * kThreads] = 0.f;
    }
  }

  for (int r0 = 0; r0 < RA; r0 += C) {
    __syncthreads();                  // the nodes are staged; the previous chunk's readers are done
    stage_w_chunk<C>(ws, w, F, r0, RA);
#pragma unroll
    for (int rc = 0; rc < C * kCh; ++rc) dws[rc * kThreads] = 0.f;
    build_frame_chunk<C, E, MC>(geo, M, lane, r0, RA, cutoff, inv_cut);
    cp_async_wait<0>();
    __syncthreads();
    if (live) {
      if (r0 == 0) {                  // the dsbar path, both directions of each pair
        float gsbv[MC];
#pragma unroll
        for (int a = 0; a < MC; ++a) gsbv[a] = a < M ? gsb[(n0 + a) * F + f] : 0.f;
#pragma unroll
        for (int a = 0; a < MC - 1; ++a)
#pragma unroll
          for (int c = a + 1; c < MC; ++c) {
            if (c >= M) break;
            const float adj = geo.adj[pair_index(MC, a, c)];
            const float ga = adj * gsbv[a], gc = adj * gsbv[c];
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              dx[0][a][d] = fmaf(ga, x[1][c][d], dx[0][a][d]);
              dx[0][c][d] = fmaf(gc, x[1][a][d], dx[0][c][d]);
              dx[1][a][d] = fmaf(gc, x[0][c][d], dx[1][a][d]);
              dx[1][c][d] = fmaf(ga, x[0][a][d], dx[1][c][d]);
            }
          }
      }

#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) {
        const int xi = carries_v(ch) ? 0 : 1;
        float wc[C], gam[MC][3], ph[MC], dph[MC];
        // fa: this chunk's share of the forward's sum at each receiver (of
        // s0 in fa[.][0] for ch 0); bx: of sum_i filt Gamma_ch(i) at each
        // sender
        float fa[MC][3], bx[MC][3], dwc[C];
#pragma unroll
        for (int r = 0; r < C; ++r) {
          wc[r] = ws[(r * kCh + ch) * kLanes + lane];
          dwc[r] = 0.f;
        }
#pragma unroll
        for (int a = 0; a < MC; ++a) {
          ph[a] = phs[(ch * MC + a) * kThreads];
          dph[a] = 0.f;
#pragma unroll
          for (int d = 0; d < 3; ++d) fa[a][d] = bx[a][d] = 0.f;
          switch (ch) {                   // Gamma_ch(a)
            case 2: case 5: {
              const float* g = ch == 2 ? gvv[a] : gvbv[a];
              gam[a][0] = g[0]; gam[a][1] = g[1]; gam[a][2] = g[2];
              break;
            }
            case 4: case 6: {
              const float* g = ch == 4 ? gvv[a] : gvbv[a];
              for (int d = 0; d < 3; ++d) gam[a][d] = sb[a] * g[d];
              break;
            }
            case 3: case 7: case 8: {
              const float* g = ch == 3 ? gvv[a] : gvbv[a];
              const float* u = ch == 8 ? x[1][a] : x[0][a];
              gam[a][0] = gam[a][1] = gam[a][2] = 0.f;
              add_cross(gam[a], g, u);
              break;
            }
            default: gam[a][0] = gam[a][1] = gam[a][2] = 0.f; break;
          }
        }
#pragma unroll
        for (int a = 0; a < MC - 1; ++a)
#pragma unroll
          for (int c = a + 1; c < MC; ++c) {
            if (c >= M) break;
            float g[W];
            load_record(g, geo.rec[pair_index(MC, a, c)]);
            float filt = 0.f;
#pragma unroll
            for (int r = 0; r < C; ++r) filt = fmaf(g[r], wc[r], filt);
            float dac, dca;                 // dG[a, c] (receiver a), dG[c, a]
            if (ch == 0) {
              dac = sig[a];
              dca = sig[c];
              fa[a][0] = fmaf(filt, ph[c], fa[a][0]);
              fa[c][0] = fmaf(filt, ph[a], fa[c][0]);
            } else if (ch == 1) {           // unit_ca = -unit_ac
              dac = dot3(gvv[a], g + C);
              dca = -dot3(gvv[c], g + C);
            } else {
              dac = dot3(gam[a], x[xi][c]);
              dca = dot3(gam[c], x[xi][a]);
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                bx[c][d] = fmaf(filt, gam[a][d], bx[c][d]);
                bx[a][d] = fmaf(filt, gam[c][d], bx[a][d]);
              }
              if (ch != 2 && ch != 5) {     // the forward's a_ch, needed by a gate
                const float ga = filt * ph[c], gc = filt * ph[a];
#pragma unroll
                for (int d = 0; d < 3; ++d) {
                  fa[a][d] = fmaf(ga, x[xi][c][d], fa[a][d]);
                  fa[c][d] = fmaf(gc, x[xi][a][d], fa[c][d]);
                }
              }
            }
            dph[c] = fmaf(filt, dac, dph[c]);
            dph[a] = fmaf(filt, dca, dph[a]);
            const float X = fmaf(ph[c], dac, ph[a] * dca);
#pragma unroll
            for (int r = 0; r < C; ++r) dwc[r] = fmaf(g[r], X, dwc[r]);
          }
        // per node: the sender side and the receiver gates, on this
        // chunk's shares (linear in them)
#pragma unroll
        for (int a = 0; a < MC; ++a) {
          dphs[(ch * MC + a) * kThreads] += dph[a];
          if (ch >= 2)
#pragma unroll
            for (int d = 0; d < 3; ++d) dx[xi][a][d] = fmaf(ph[a], bx[a][d], dx[xi][a][d]);
          switch (ch) {
            case 0: s0[a] += fa[a][0]; break;
            case 3: add_cross(dx[0][a], fa[a], gvv[a]); break;
            case 4: dsb[a] += dot3(fa[a], gvv[a]); break;
            case 6: dsb[a] += dot3(fa[a], gvbv[a]); break;
            case 7: add_cross(dx[0][a], fa[a], gvbv[a]); break;
            case 8: add_cross(dx[1][a], fa[a], gvbv[a]); break;
            default: break;
          }
        }
#pragma unroll
        for (int r = 0; r < C; ++r) dws[(r * kCh + ch) * kThreads] += dwc[r];
      }
    }
    // this chunk's d_w: the warps' columns added in a fixed order, its rows
    // of the block's partial written once
    __syncthreads();
    const float* cols = ws + C * kCh * kLanes;
    for (int t = threadIdx.x; t < C * kCh * kLanes; t += kThreads) {
      const int rc = t / kLanes, ln = t % kLanes, ff = blockIdx.x * kLanes + ln;
      if (r0 + rc / kCh >= RA || ff >= F) continue;
      float acc = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) acc += cols[rc * kThreads + wi * kLanes + ln];
      out[(size_t)(r0 * kCh + rc) * F + ff] = acc;
    }
  }

  if (live && f_out < F) {
#pragma unroll
    for (int a = 0; a < MC; ++a) {
      if (a >= M) break;
      const size_t n = n0 + a;
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch)
        dphi[(n * kCh + ch) * F + f] = dphs[(ch * MC + a) * kThreads];
      d_s[n * F + f] = s0[a] * gs[n * F + f];
      d_sbar[n * F + f] = dsb[a];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        d_v[(n * 3 + d) * F + f] = dx[0][a][d];
        d_vbar[(n * 3 + d) * F + f] = dx[1][a][d];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Wide basis, RA > kTemplateMaxRA (the note at the top): the chunked path's
// tiling for every M, the basis in chunks of C <= kPseudoChunk functions
// (pair_geometry.cuh::chunk_record). Every output is linear in the filter,
// so the node sums stay in registers across the basis chunks and each chunk
// adds its share; the adjacency sums (t, the dsbar path) are taken with the
// first basis chunk only. A partner is skipped where adj is 0 at every row
// the thread holds (then its whole basis is 0).

// Grid (F / 32, node tiles, B), as fused_pseudo_chunk_kernel. Per partner
// chunk the block stages the partner rows once; per basis chunk each thread
// loads that chunk's w[:, :, f] into registers and the block builds the
// chunk's (tile node, partner) records.
template <int C, bool E>
__global__ void __launch_bounds__(kLanes * kTileWarps, 2)
fused_pseudo_wide_chunk_kernel(
    const float* __restrict__ xyz, const float* __restrict__ mask,
    const float* __restrict__ phi, const float* __restrict__ s,
    const float* __restrict__ sbar, const float* __restrict__ v,
    const float* __restrict__ vbar, const float* __restrict__ w,
    float* __restrict__ ds, float* __restrict__ dsbar, float* __restrict__ dv,
    float* __restrict__ dvbar, int M, int F, int rows, int RA, float cutoff) {
  constexpr int W = record_width(C), P = kFwdRow, TI = kTileRows;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int n_warps = blockDim.x / kLanes, cols = min(M, kFwdChunk), held = n_warps * TI;
  const int b = blockIdx.z, i0 = blockIdx.y * rows, mine = warp_rows(warp, rows, i0, M);
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const float inv_cut = 1.f / cutoff;
  float4* nodes = smem;                                   // (M)
  float* part = reinterpret_cast<float*>(smem + M);       // (cols, P, lane)
  float* rec = part + cols * P * kLanes;                  // (held, cols, W)
  float* adj = rec + held * cols * W;                     // (held, cols)
  const size_t n0 = (size_t)b * M;
  const float* phib = phi + n0 * kCh * F + f;
  const float* vb = v + n0 * 3 * F + f;
  const float* vbb = vbar + n0 * 3 * F + f;

  // per node, as fused_pseudo_chunk_kernel: s0, t, the direct sums and the
  // gated sums a3, a4, a6, a7, a8
  float s0[TI], t[TI][3], dvd[TI][3], dvbd[TI][3], a[TI][5][3];
#pragma unroll
  for (int k = 0; k < TI; ++k) {
    s0[k] = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      t[k][d] = dvd[k][d] = dvbd[k][d] = 0.f;
#pragma unroll
      for (int e = 0; e < 5; ++e) a[k][e][d] = 0.f;
    }
  }
  stage_frame(nodes, xyz + n0 * 3, mask + n0, M);

  for (int j0 = 0; j0 < M; j0 += kFwdChunk) {
    const int nc = min(kFwdChunk, M - j0);
    for (int r0 = 0; r0 < RA; r0 += C) {
      float wr[C][kCh];               // this basis chunk's weights, zero past RA
#pragma unroll
      for (int r = 0; r < C; ++r)
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch)
          wr[r][ch] = r0 + r < RA ? w[((size_t)(r0 + r) * kCh + ch) * F + f] : 0.f;
      __syncthreads();                // the nodes are staged; the previous readers are done
      if (r0 == 0) {                  // the sender rows, in flight while the records are built
        for (int qq = warp; qq < nc; qq += n_warps) {
          float* dst = part + qq * P * kLanes + lane;
          const size_t q = j0 + qq;
#pragma unroll
          for (int ch = 0; ch < kCh; ++ch) cp_async4(dst + ch * kLanes, phib + (q * kCh + ch) * F);
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            cp_async4(dst + (kFwdV + d) * kLanes, vb + (q * 3 + d) * F);
            cp_async4(dst + (kFwdVb + d) * kLanes, vbb + (q * 3 + d) * F);
          }
        }
        cp_async_commit();
      }
      for (int e = threadIdx.x; e < held * nc; e += blockDim.x) {
        const int rr = e / nc, qq = e % nc;
        adj[rr * cols + qq] = chunk_record<C, E>(rec + (rr * cols + qq) * W, nodes,
                                              rr < rows ? i0 + rr : M, j0 + qq, M, r0, RA,
                                              cutoff, inv_cut);
      }
      if (r0 == 0) cp_async_wait<0>();
      __syncthreads();

#pragma unroll 1
      for (int qq = 0; qq < nc; ++qq) {   // sender j against the thread's receivers
        float pj[P], g[TI][W];
        const float* src = part + qq * P * kLanes + lane;
#pragma unroll
        for (int e = 0; e < P; ++e) pj[e] = src[e * kLanes];
        bool none = true;
#pragma unroll
        for (int k = 0; k < TI; ++k) {
          const int rr = warp * TI + k;
          const float aj = adj[rr * cols + qq];
          if (r0 == 0)
#pragma unroll
            for (int d = 0; d < 3; ++d) t[k][d] = fmaf(aj, pj[kFwdVb + d], t[k][d]);
          load_record(g[k], rec + (rr * cols + qq) * W);
          none = none && aj == 0.f;
        }
        if (none) continue;
#pragma unroll
        for (int k = 0; k < TI; ++k) {
          float gg[kCh];                          // this chunk's share of g_ch
#pragma unroll
          for (int ch = 0; ch < kCh; ++ch) {
            float filt = 0.f;
#pragma unroll
            for (int r = 0; r < C; ++r) filt = fmaf(g[k][r], wr[r][ch], filt);
            gg[ch] = filt * pj[ch];
          }
          s0[k] += gg[0];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float vj = pj[kFwdV + d], vbj = pj[kFwdVb + d];
            dvd[k][d] = fmaf(gg[1], g[k][C + d], fmaf(gg[2], vj, dvd[k][d]));
            a[k][0][d] = fmaf(gg[3], vbj, a[k][0][d]);
            a[k][1][d] = fmaf(gg[4], vbj, a[k][1][d]);
            dvbd[k][d] = fmaf(gg[5], vbj, dvbd[k][d]);
            a[k][2][d] = fmaf(gg[6], vj, a[k][2][d]);
            a[k][3][d] = fmaf(gg[7], vj, a[k][3][d]);
            a[k][4][d] = fmaf(gg[8], vbj, a[k][4][d]);
          }
        }
      }
    }
  }
  if (f_out >= F) return;

#pragma unroll
  for (int k = 0; k < TI; ++k) {
    if (k >= mine) break;
    const size_t row = n0 + i0 + warp * TI + k;
    const float si = s[row * F + f], gi = sbar[row * F + f];
    float vi[3], vbi[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      vi[d] = v[(row * 3 + d) * F + f];
      vbi[d] = vbar[(row * 3 + d) * F + f];
    }
    ds[row * F + f] = si * s0[k];
    dsbar[row * F + f] = dot3(vi, t[k]);
    float o[3] = {dvd[k][0], dvd[k][1], dvd[k][2]};
    float ob[3] = {dvbd[k][0], dvbd[k][1], dvbd[k][2]};
    add_cross(o, vi, a[k][0]);
    add_cross(ob, vi, a[k][3]);
    add_cross(ob, vbi, a[k][4]);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      dv[(row * 3 + d) * F + f] = fmaf(gi, a[k][1][d], o[d]);
      dvbar[(row * 3 + d) * F + f] = fmaf(gi, a[k][2][d], ob[d]);
    }
  }
}

// Grid (F / 32, node tiles, B), as fused_pseudo_bwd_chunk_kernel. Per basis
// chunk the block stages the chunk's w in shared memory with cp.async and
// walks the partner chunks and channels as that kernel does (the partner
// rows staged once when one chunk holds every partner). At the end of a
// basis chunk the block adds its warps' d_w columns in a fixed order and
// writes that chunk's rows of its partial, dw_part[b, tile], once.
template <int C, bool E>
__global__ void __launch_bounds__(kLanes * kTileWarps, 2)
fused_pseudo_bwd_wide_chunk_kernel(
    const float* __restrict__ xyz, const float* __restrict__ mask,
    const float* __restrict__ phi, const float* __restrict__ s,
    const float* __restrict__ sbar, const float* __restrict__ v,
    const float* __restrict__ vbar, const float* __restrict__ w,
    const float* __restrict__ gs, const float* __restrict__ gsb,
    const float* __restrict__ gv, const float* __restrict__ gvb,
    float* __restrict__ dphi, float* __restrict__ d_s, float* __restrict__ d_sbar,
    float* __restrict__ d_v, float* __restrict__ d_vbar,
    float* __restrict__ dw_part,      // (B, node tiles, RA, 9, F)
    int M, int F, int rows, int RA, float cutoff) {
  constexpr int W = record_width(C), P = kBwdRow, TI = kTileRows;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int n_warps = blockDim.x / kLanes, cols = min(M, kBwdChunk), held = n_warps * TI;
  const int b = blockIdx.z, p0 = blockIdx.y * rows, mine = warp_rows(warp, rows, p0, M);
  const int f_out = blockIdx.x * kLanes + lane;
  const int f = min(f_out, F - 1);    // idle lanes of the last tile repeat F - 1
  const float inv_cut = 1.f / cutoff;
  const bool one_chunk = M <= kBwdChunk;
  float4* nodes = smem;                                   // (M)
  float* ws = reinterpret_cast<float*>(smem + M);         // (C * 9, lane)
  float* dws = ws + C * kCh * kLanes;                     // (C * 9, thread)
  float* part = dws + C * kCh * blockDim.x;               // (cols, P, lane)
  float* rec = part + cols * P * kLanes;                  // (held, cols, W)
  float* adj = rec + held * cols * W;                     // (held, cols)
  float* out = dw_part + ((size_t)b * gridDim.y + blockIdx.y) * RA * kCh * F;
  const size_t n0 = (size_t)b * M;
  stage_frame(nodes, xyz + n0 * 3, mask + n0, M);

  // the thread's nodes: their inputs, and their sums over the partners
  // and the basis chunks (dvs and dvbs take the sender side, the gates
  // and the dsbar path)
  float vp[TI][3], vbp[TI][3], php[TI][kCh], gvp[TI][3], gvbp[TI][3], gsbp[TI];
  float dph[TI][kCh], dvs[TI][3], dvbs[TI][3], dsb[TI], s0[TI];
#pragma unroll
  for (int k = 0; k < TI; ++k) {
    const size_t row = n0 + min(p0 + warp * TI + k, M - 1);
    gsbp[k] = gsb[row * F + f];
    dsb[k] = s0[k] = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      vp[k][d] = v[(row * 3 + d) * F + f];
      vbp[k][d] = vbar[(row * 3 + d) * F + f];
      gvp[k][d] = gv[(row * 3 + d) * F + f];
      gvbp[k][d] = gvb[(row * 3 + d) * F + f];
      dvs[k][d] = dvbs[k][d] = 0.f;
    }
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      php[k][ch] = phi[(row * kCh + ch) * F + f];
      dph[k][ch] = 0.f;
    }
  }

  for (int r0 = 0; r0 < RA; r0 += C) {
    for (int q0 = 0; q0 < M; q0 += kBwdChunk) {
      const int nc = min(kBwdChunk, M - q0);
      const bool restage = !one_chunk || r0 == 0;
      __syncthreads();              // the previous readers of ws, part, rec and dws are done
      if (q0 == 0) {                // the basis chunk's w (zero past RA); the d_w column zeroed
        stage_w_chunk<C>(ws, w, F, r0, RA);
#pragma unroll
        for (int rc = 0; rc < C * kCh; ++rc) dws[rc * blockDim.x + threadIdx.x] = 0.f;
      }
      if (restage) {                // partner rows by cp.async, in flight while the records are built
        for (int qq = warp; qq < nc; qq += n_warps) {
          float* dst = part + qq * P * kLanes + lane;
          const size_t q = n0 + q0 + qq;
#pragma unroll
          for (int ch = 0; ch < kCh; ++ch)
            if (ch == 0 || gated(ch))
              cp_async4(dst + phi_slot(ch) * kLanes, phi + (q * kCh + ch) * F + f);
          cp_async4(dst + kBS * kLanes, s + q * F + f);
          cp_async4(dst + kBGs * kLanes, gs + q * F + f);
          cp_async4(dst + kBSbar * kLanes, sbar + q * F + f);
          cp_async4(dst + kBGsb * kLanes, gsb + q * F + f);
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            cp_async4(dst + (kBV + d) * kLanes, v + (q * 3 + d) * F + f);
            cp_async4(dst + (kBVb + d) * kLanes, vbar + (q * 3 + d) * F + f);
            cp_async4(dst + (kBGv + d) * kLanes, gv + (q * 3 + d) * F + f);
            cp_async4(dst + (kBGvb + d) * kLanes, gvb + (q * 3 + d) * F + f);
          }
        }
        cp_async_commit();
      }
      for (int e = threadIdx.x; e < held * nc; e += blockDim.x) {
        const int rr = e / nc, qq = e % nc;
        adj[rr * cols + qq] = chunk_record<C, E>(rec + (rr * cols + qq) * W, nodes,
                                              rr < rows ? p0 + rr : M, q0 + qq, M, r0, RA,
                                              cutoff, inv_cut);
      }
      if (restage || q0 == 0) cp_async_wait<0>();
      __syncthreads();

#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) {
        const bool on_v = carries_v(ch);
        float wc[C], dwc[C], ac[TI][3];   // ac: this chunk's forward sum at p (t for ch 0)
#pragma unroll
        for (int r = 0; r < C; ++r) {
          wc[r] = ws[(r * kCh + ch) * kLanes + lane];
          dwc[r] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < TI; ++k) ac[k][0] = ac[k][1] = ac[k][2] = 0.f;

#pragma unroll 2
        for (int qq = 0; qq < nc; ++qq) {
          const float* src = part + qq * P * kLanes + lane;
          float xq[3] = {0.f, 0.f, 0.f}, gam[3] = {0.f, 0.f, 0.f}, phq = 0.f, sig = 0.f;
          if (ch == 0) {
            phq = src[0];
            sig = src[kBS * kLanes] * src[kBGs * kLanes];
          } else {
            const int gsrc = ch >= 5 ? kBGvb : kBGv;
#pragma unroll
            for (int d = 0; d < 3; ++d) gam[d] = src[(gsrc + d) * kLanes];
            if (gated(ch)) {
              phq = src[phi_slot(ch) * kLanes];
#pragma unroll
              for (int d = 0; d < 3; ++d) xq[d] = src[((on_v ? kBV : kBVb) + d) * kLanes];
            }
            if (ch == 4 || ch == 6) {
              const float sb = src[kBSbar * kLanes];
              gam[0] *= sb; gam[1] *= sb; gam[2] *= sb;
            } else if (ch == 3 || ch == 7 || ch == 8) {   // Gamma = g x v (x vbar for 8)
              float u[3], c[3] = {0.f, 0.f, 0.f};
#pragma unroll
              for (int d = 0; d < 3; ++d) u[d] = src[((ch == 8 ? kBVb : kBV) + d) * kLanes];
              add_cross(c, gam, u);
              gam[0] = c[0]; gam[1] = c[1]; gam[2] = c[2];
            }
          }
          float g[TI][W];
          bool none = true;
#pragma unroll
          for (int k = 0; k < TI; ++k) {
            const int rr = warp * TI + k;
            const float aq = adj[rr * cols + qq];
            if (ch == 0 && r0 == 0) {       // the dsbar path, both roles
              const float ag = aq * src[kBGsb * kLanes];
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                ac[k][d] = fmaf(aq, src[(kBVb + d) * kLanes], ac[k][d]);
                dvbs[k][d] = fmaf(ag, src[(kBV + d) * kLanes], dvbs[k][d]);
              }
            }
            load_record(g[k], rec + (rr * cols + qq) * W);
            none = none && aq == 0.f;
          }
          if (none) continue;
#pragma unroll
          for (int k = 0; k < TI; ++k) {
            float filt = 0.f;
#pragma unroll
            for (int r = 0; r < C; ++r) filt = fmaf(g[k][r], wc[r], filt);
            float dG;                           // the cotangent of g_ch[q <- p]
            if (ch == 0) {
              dG = sig;
              s0[k] = fmaf(filt, phq, s0[k]);
            } else if (ch == 1) {               // unit of (q <- p) is -unit of the record
              dG = -dot3(gam, g[k] + C);
            } else {
              dG = dot3(gam, on_v ? vp[k] : vbp[k]);
              const float pf = filt * php[k][ch];
              float* dx = on_v ? dvs[k] : dvbs[k];
#pragma unroll
              for (int d = 0; d < 3; ++d) dx[d] = fmaf(pf, gam[d], dx[d]);
              if (gated(ch)) {
                const float fp = filt * phq;
#pragma unroll
                for (int d = 0; d < 3; ++d) ac[k][d] = fmaf(fp, xq[d], ac[k][d]);
              }
            }
            dph[k][ch] = fmaf(filt, dG, dph[k][ch]);
            const float X = php[k][ch] * dG;
#pragma unroll
            for (int r = 0; r < C; ++r) dwc[r] = fmaf(g[k][r], X, dwc[r]);
          }
        }
        // the channel's gates on this chunk's forward sums (linear in
        // them, so the chunks' shares add up); d_w into the thread's column
#pragma unroll
        for (int k = 0; k < TI; ++k) {
          switch (ch) {
            case 0:
#pragma unroll
              for (int d = 0; d < 3; ++d) dvs[k][d] = fmaf(gsbp[k], ac[k][d], dvs[k][d]);
              break;
            case 3: add_cross(dvs[k], ac[k], gvp[k]); break;
            case 4: dsb[k] += dot3(ac[k], gvp[k]); break;
            case 6: dsb[k] += dot3(ac[k], gvbp[k]); break;
            case 7: add_cross(dvs[k], ac[k], gvbp[k]); break;
            case 8: add_cross(dvbs[k], ac[k], gvbp[k]); break;
            default: break;
          }
        }
#pragma unroll
        for (int r = 0; r < C; ++r) dws[(r * kCh + ch) * blockDim.x + threadIdx.x] += dwc[r];
      }
    }
    // this basis chunk's d_w: the warps' columns added in a fixed order,
    // its rows of the partial written once
    __syncthreads();
    for (int e = threadIdx.x; e < C * kCh * kLanes; e += blockDim.x) {
      const int rc = e / kLanes, ln = e % kLanes, ff = blockIdx.x * kLanes + ln;
      if (r0 + rc / kCh >= RA || ff >= F) continue;
      float acc = 0.f;
      for (int wi = 0; wi < n_warps; ++wi) acc += dws[rc * blockDim.x + wi * kLanes + ln];
      out[(size_t)(r0 * kCh + rc) * F + ff] = acc;
    }
  }

  if (f_out < F) {
#pragma unroll
    for (int k = 0; k < TI; ++k) {
      if (k >= mine) break;
      const size_t row = n0 + p0 + warp * TI + k;
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) dphi[(row * kCh + ch) * F + f] = dph[k][ch];
      d_s[row * F + f] = s0[k] * gs[row * F + f];
      d_sbar[row * F + f] = dsb[k];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        d_v[(row * 3 + d) * F + f] = dvs[k][d];
        d_vbar[(row * 3 + d) * F + f] = dvbs[k][d];
      }
    }
  }
}

// ---------------------------------------------------------------------------

// Frames per warp of the register path: one at batch 64 and below, so the
// grid fills the card; more above it, for fewer d_w partials.
int frames_per_warp(int B) { return std::max(1, std::min(8, B / 64)); }
int frame_groups(int B) { return (B + kWarps * frames_per_warp(B) - 1) / (kWarps * frames_per_warp(B)); }

// Node tiles of the chunked path: M split evenly into tiles of at most
// kTileRows * kTileWarps nodes, kTileRows per thread.
struct ChunkTiling {
  int tiles, rows, warps;
};
ChunkTiling chunk_tiling(int M) {
  constexpr int cap = kTileRows * kTileWarps;
  const int tiles = (M + cap - 1) / cap, rows = (M + tiles - 1) / tiles;
  return {tiles, rows, (rows + kTileRows - 1) / kTileRows};
}

// Dynamic shared memory of the chunked path (the kernels' layouts); of the
// wide kernels with the chunk width C for RA.
size_t chunk_smem(int M, int RA, bool backward) {
  const ChunkTiling t = chunk_tiling(M);
  const int cols = std::min(M, backward ? kBwdChunk : kFwdChunk);
  size_t floats = (size_t)cols * (backward ? kBwdRow : kFwdRow) * kLanes
                  + (size_t)t.warps * kTileRows * cols * (record_width(RA) + 1);
  if (backward) floats += (size_t)RA * kCh * kLanes * (1 + t.warps);   // w and d_w
  return sizeof(float4) * M + sizeof(float) * floats;
}

// Run fn(integral_constant<C>) for the chunk width C of a wide basis of RA:
// the fewest chunks of at most kPseudoChunk functions, of equal width (the
// last one zero-padded). For RA > 16 that is C in 7..9.
template <typename Fn>
int with_wide(int RA, Fn&& fn) {
  const int n = (RA + kPseudoChunk - 1) / kPseudoChunk;
  switch ((RA + n - 1) / n) {
    case 7: return fn(std::integral_constant<int, 7>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    case 9: return fn(std::integral_constant<int, 9>{});
  }
  return (int)cudaErrorInvalidValue;
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
  const cudaStream_t st = (cudaStream_t)stream;
  auto args = [&](auto kernel) {
    return [=](dim3 grid, dim3 block, size_t smem, auto... tail) {
      kernel<<<grid, block, smem, st>>>(
          (const float*)xyz, (const float*)mask, (const float*)phi, (const float*)s,
          (const float*)sbar, (const float*)v, (const float*)vbar, (const float*)w,
          (float*)ds, (float*)dsbar, (float*)dv, (float*)dvbar, tail...);
      return (int)cudaGetLastError();
    };
  };
  if (RA > kTemplateMaxRA)
    return with_wide(RA, [&](auto c_c) {
      return with_exact(RA, [&](auto e_c) {
        constexpr int kC = decltype(c_c)::value;
        constexpr bool kE = decltype(e_c)::value;
        if (M <= kWideRegMax)
          return args(fused_pseudo_wide_reg_kernel<kC, kE>)(
              dim3((unsigned)((F + kLanes - 1) / kLanes), (unsigned)((B + kWarps - 1) / kWarps)),
              kLanes * kWarps, 0, B, M, F, RA, cutoff);
        const ChunkTiling t = chunk_tiling(M);
        const size_t smem = chunk_smem(M, kC, false);
        static int allowed[kMaxDevices] = {};
        const int err = allow_smem(fused_pseudo_wide_chunk_kernel<kC, kE>, smem, allowed);
        if (err != 0) return err;
        const dim3 grid((unsigned)((F + kLanes - 1) / kLanes), (unsigned)t.tiles, (unsigned)B);
        return args(fused_pseudo_wide_chunk_kernel<kC, kE>)(grid, t.warps * kLanes, smem, M, F,
                                                            t.rows, RA, cutoff);
      });
    });
  return with_ra(RA, [&](auto ra_c) {
    constexpr int kRA = decltype(ra_c)::value;
    if (M <= kRegMax) {
      const dim3 grid((unsigned)((F + kLanes - 1) / kLanes), (unsigned)frame_groups(B));
      const int fpw = frames_per_warp(B);
      if (M <= 3)
        return args(fused_pseudo_kernel<kRA, 3>)(grid, kLanes * kWarps, 0, B, M, F, fpw, cutoff);
      return args(fused_pseudo_kernel<kRA, kRegMax>)(grid, kLanes * kWarps, 0, B, M, F, fpw,
                                                     cutoff);
    }
    const ChunkTiling t = chunk_tiling(M);
    const size_t smem = chunk_smem(M, kRA, false);
    static int allowed[kMaxDevices] = {};
    const int err = allow_smem(fused_pseudo_chunk_kernel<kRA>, smem, allowed);
    if (err != 0) return err;
    const dim3 grid((unsigned)((F + kLanes - 1) / kLanes), (unsigned)t.tiles, (unsigned)B);
    return args(fused_pseudo_chunk_kernel<kRA>)(grid, t.warps * kLanes, smem, M, F, t.rows,
                                                cutoff);
  });
}

// d_w partials that fused_pseudo_bwd leaves in its scratch for a basis of
// RA: one per frame group on the register path (one per kWarps frames on
// its wide layout), one per (batch element, node tile) on the chunked
// paths.
extern "C" int fused_pseudo_bwd_partials(int B, int M, int RA) {
  using namespace cgvae;
  if (B <= 0 || M <= 0) return 1;
  if (RA > kTemplateMaxRA && M <= kWideRegMax) return (B + kWarps - 1) / kWarps;
  if (RA <= kTemplateMaxRA && M <= kRegMax) return frame_groups(B);
  return B * chunk_tiling(M).tiles;
}

// dw_part is scratch of fused_pseudo_bwd_partials(B, M, RA) * RA * 9 * F
// floats; dw receives its sum.
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
  auto args = [&](auto kernel) {
    return [=](dim3 grid, dim3 block, size_t smem, auto... tail) {
      kernel<<<grid, block, smem, st>>>(
          (const float*)xyz, (const float*)mask, (const float*)phi, (const float*)s,
          (const float*)sbar, (const float*)v, (const float*)vbar, (const float*)w,
          (const float*)gs, (const float*)gsb, (const float*)gv, (const float*)gvb,
          (float*)dphi, (float*)d_s, (float*)d_sbar, (float*)d_v, (float*)d_vbar,
          (float*)dw_part, tail...);
      return (int)cudaGetLastError();
    };
  };
  if (RA > kTemplateMaxRA) {
    const int err = with_wide(RA, [&](auto c_c) {
      return with_exact(RA, [&](auto e_c) {
        constexpr int kC = decltype(c_c)::value;
        constexpr bool kE = decltype(e_c)::value;
        if (M <= kWideRegMax) {
          const size_t smem =
              sizeof(float) * kCh * kLanes * kWarps * (kC + 2 * kWideRegMax) +
              sizeof(float) * kCh * kC * kLanes;
          static int allowed[kMaxDevices] = {};
          const int e = allow_smem(fused_pseudo_bwd_wide_reg_kernel<kC, kE>, smem, allowed);
          if (e != 0) return e;
          return args(fused_pseudo_bwd_wide_reg_kernel<kC, kE>)(
              dim3((unsigned)((F + kLanes - 1) / kLanes), (unsigned)((B + kWarps - 1) / kWarps)),
              kLanes * kWarps, smem, B, M, F, RA, cutoff);
        }
        const ChunkTiling t = chunk_tiling(M);
        const size_t smem = chunk_smem(M, kC, true);
        static int allowed[kMaxDevices] = {};
        const int e = allow_smem(fused_pseudo_bwd_wide_chunk_kernel<kC, kE>, smem, allowed);
        if (e != 0) return e;
        const dim3 grid((unsigned)((F + kLanes - 1) / kLanes), (unsigned)t.tiles, (unsigned)B);
        return args(fused_pseudo_bwd_wide_chunk_kernel<kC, kE>)(grid, t.warps * kLanes, smem, M,
                                                                F, t.rows, RA, cutoff);
      });
    });
    if (err != 0) return err;
    return launch_sum_over_batch((const float*)dw_part, (float*)dw,
                                 fused_pseudo_bwd_partials(B, M, RA), RA * kCh * F, st);
  }
  const int err = with_ra(RA, [&](auto ra_c) {
    constexpr int kRA = decltype(ra_c)::value;
    if (M <= kRegMax) {
      const dim3 grid((unsigned)((F + kLanes - 1) / kLanes), (unsigned)frame_groups(B));
      const int fpw = frames_per_warp(B);
      const size_t smem = sizeof(float) * kRA * kCh * (kLanes + kLanes * kWarps);
      auto launch = [&](auto kernel, int (&allowed)[kMaxDevices]) {
        const int e = allow_smem(kernel, smem, allowed);
        if (e != 0) return e;
        return args(kernel)(grid, kLanes * kWarps, smem, B, M, F, fpw, cutoff);
      };
      static int allowed3[kMaxDevices] = {}, allowed6[kMaxDevices] = {};
      if (M <= 3) return launch(fused_pseudo_bwd_kernel<kRA, 3>, allowed3);
      return launch(fused_pseudo_bwd_kernel<kRA, kRegMax>, allowed6);
    }
    const ChunkTiling t = chunk_tiling(M);
    const size_t smem = chunk_smem(M, kRA, true);
    static int allowed[kMaxDevices] = {};
    const int e = allow_smem(fused_pseudo_bwd_chunk_kernel<kRA>, smem, allowed);
    if (e != 0) return e;
    const dim3 grid((unsigned)((F + kLanes - 1) / kLanes), (unsigned)t.tiles, (unsigned)B);
    return args(fused_pseudo_bwd_chunk_kernel<kRA>)(grid, t.warps * kLanes, smem, M, F, t.rows,
                                                    cutoff);
  });
  if (err != 0) return err;
  return launch_sum_over_batch((const float*)dw_part, (float*)dw,
                               fused_pseudo_bwd_partials(B, M, RA), RA * kCh * F, st);
}
