// Pair geometry of the fused message and pseudo kernels, forward and
// backward, for Hopper (sm_90a), and the second pass of the weight
// gradients.
//
// Every kernel of fused_message.cu and fused_pseudo.cu rebuilds the pair
// pipeline of the JAX package's _geometry (pallas_pseudo.py:57-73) on chip,
// one record per pair (row node p, partner q):
//
//   r = x_q - x_p,  d = sqrt(|r|^2 + 1e-3),  unit = r / d
//   adj = (d < cutoff) * (p != q) * mask_p * mask_q
//   K[r] = adj * env(d) * [rbf_1..R(d), 1]_r
//
// K and adj are symmetric in (p, q) and unit is antisymmetric, so one record
// serves a pair in either direction.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace cgvae {
namespace {

constexpr float kEps = 1e-3f;
constexpr float kPi = 3.14159265358979323846f;
constexpr int kMaxDevices = 64;

// floats per pair record: K[0..RA-1], unit[0..2], padded to a multiple of 4
__host__ __device__ constexpr int record_width(int RA) { return (RA + 3 + 3) / 4 * 4; }

// The pair of node a against partner c, each (x, y, z, mask), both below
// N: k[r] = K[r] for r < RA and zeros on to KR, and unit = (x_c - x_a) / d.
// self: a and c are one node. Returns the plain adjacency adj; pi_c =
// pi / cutoff. One rsqrtf and one __sincosf per pair; the radial sines
// follow by the angle-addition recurrence (relative error ~3e-6 against the
// plain version's sin per basis function).
template <int KR>
__device__ __forceinline__ float pair_basis(float (&k)[KR], float (&unit)[3], float4 a,
                                            float4 c, bool self, int RA, float cutoff,
                                            float pi_c) {
  const float r0 = c.x - a.x, r1 = c.y - a.y, r2 = c.z - a.z;
  const float d2 = r0 * r0 + r1 * r1 + r2 * r2 + kEps;
  const float inv_d = rsqrtf(d2);
  const float d = d2 * inv_d;
  unit[0] = r0 * inv_d;
  unit[1] = r1 * inv_d;
  unit[2] = r2 * inv_d;
#pragma unroll
  for (int r = 0; r < KR; ++r) k[r] = 0.f;
  float adj = 0.f;
  if (d < cutoff && !self) {
    float s1, c1;                         // sin and cos of pi d / cutoff
    __sincosf(pi_c * d, &s1, &c1);      // |error| < 4e-7 for arguments in [0, pi)
    adj = a.w * c.w;
    const float ae = adj * (0.5f * (c1 + 1.f));
    const float ae_d = ae * inv_d;
    float sk = s1, ck = c1;               // sin and cos of (r + 1) pi d / cutoff
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      k[r] = r < RA - 1 ? ae_d * sk : (r == RA - 1 ? ae : 0.f);
      const float sn = sk * c1 + ck * s1;
      ck = ck * c1 - sk * s1;
      sk = sn;
    }
  }
  return adj;
}

// The record of row node p against partner q (zeros when either lies past
// N): K[r] for the pair, then unit = (x_q - x_p) / d, written as float4
// (pair_basis). Returns the plain adjacency adj. nodes holds (x, y, z,
// mask).
template <int RA>
__device__ __forceinline__ float pair_record(float* __restrict__ rec,
                                             const float4* __restrict__ nodes,
                                             int p, int q, int N, float cutoff, float pi_c) {
  constexpr int W = record_width(RA);
  float out[W];
#pragma unroll
  for (int k = 0; k < W; ++k) out[k] = 0.f;
  float adj = 0.f;
  if (p < N && q < N) {
    float k[RA], unit[3];
    adj = pair_basis<RA>(k, unit, nodes[p], nodes[q], p == q, RA, cutoff, pi_c);
#pragma unroll
    for (int r = 0; r < RA; ++r) out[r] = k[r];
#pragma unroll
    for (int d = 0; d < 3; ++d) out[RA + d] = unit[d];
  }
  float4* r4 = reinterpret_cast<float4*>(rec);
#pragma unroll
  for (int k = 0; k < W / 4; ++k)
    r4[k] = make_float4(out[4 * k], out[4 * k + 1], out[4 * k + 2], out[4 * k + 3]);
  return adj;
}

// 4-byte and 16-byte (both addresses 16-byte aligned; through L2 only)
// asynchronous copies global -> shared (cp.async), their group commit and
// the wait until at most n groups are in flight.
__device__ __forceinline__ void cp_async4(float* smem_dst, const float* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int n>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(n)); }

template <int W>
__device__ __forceinline__ void load_record(float (&g)[W], const float* rec) {
  const float4* r4 = reinterpret_cast<const float4*>(rec);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const float4 t = r4[k];
    g[4 * k] = t.x; g[4 * k + 1] = t.y; g[4 * k + 2] = t.z; g[4 * k + 3] = t.w;
  }
}

// ---------------------------------------------------------------------------
// The wide-basis path, RA > kTemplateMaxRA, where RA is a runtime value.
//
// The message kernels (fused_message.cu) split the basis into chunks of at
// most kWideChunk functions and build each chunk's records once per block
// with chunk_record, as pair_record builds the templated ones: an accurate
// sin and cos (sincospif, ~1 ulp) at the chunk's first angle and at the
// step, then at most kWideChunk - 1 = 11 steps of the angle-addition
// recurrence, whatever RA is. So the recurrence's error does not grow with
// the basis, where one recurrence over a hundred functions and more would
// leave the 1e-4 gate: tests/test_torch_message_wide.py finds the chunked
// f32 basis within 1.40e-5 of each function's max |K| of the float64 plain
// basis at n_rbf 200, as close as the plain f32 basis itself (1.26e-5; the
// f32 distance through an angle of up to 200 pi sets both), and within
// 1.7e-6 up to n_rbf 32. But the f32 angle of function r carries a relative
// rounding error of a few 1e-7, in the kernels as in the plain version, so
// its absolute error grows as r: ~1e-4 rad at r 120, the size of the 1e-4
// gate on the weight gradient's rows (a train step at n_rbf 120 read
// 9.0e-5 on the card) and past it by r 200. A basis of more than kExactFrom
// = 32 functions is therefore built as the plain version builds its
// functions (ops/basis.py::painn_radial_basis: the IEEE distance,
// coefficient and angle in the plain version's order, and the sine within
// ~5e-7, sin_reduced), so that the records carry the plain version's
// rounding and not a second one; the template flag E of chunk_record
// selects it (with_exact). The chunked
// records keep no per-basis state in shared memory, so the card sets them
// no bound on RA (the kernels' ptxas and times: fused_message.cu's note).
//
// The pseudo kernels (fused_pseudo.cu) take the same records for their
// wide path, in chunks of at most kPseudoChunk functions (their note says
// why fewer): each record built once per (node tile, partner chunk, basis
// chunk), w and the backward's d_w sums of one chunk only. Nothing per basis
// function sits in shared memory there either.

constexpr int kTemplateMaxRA = 16;
constexpr int kWideChunk = 12;   // basis functions per chunk of the message kernels, at most
constexpr int kExactFrom = 32;   // a longer basis follows the plain version's rounding

// sin x for 0 <= x < 2^16 (the basis' angles stay below (R+1) pi): x less
// the nearest multiple of 2 pi, in three parts (Cody and Waite; the first
// part, 201 / 32, makes an exact product and difference), then the hardware
// sine, within ~5e-7 of sin x. sinf's own reduction, for any x, keeps a
// stack frame in every kernel that inlines it.
__device__ __forceinline__ float sin_reduced(float x) {
  constexpr float kInv2Pi = 0.159154943091895335769f;
  constexpr float kC1 = 6.28125f;                       // 2 pi in three parts
  constexpr float kC2 = 1.9353071693331003e-3f;
  constexpr float kC3 = 1.0253131677018246e-11f;
  const float n = rintf(x * kInv2Pi);
  float y = fmaf(-n, kC1, x);
  y = fmaf(-n, kC2, y);
  y = fmaf(-n, kC3, y);
  return __sinf(y);
}

// The record of row node p against partner q for the basis functions r0 ..
// r0 + C - 1 of a basis of RA: K[r0 + k] (zero past RA), then unit =
// (x_q - x_p) / d, written as float4 like pair_record's. inv_cut =
// 1 / cutoff. Returns the plain adjacency adj, as pair_record does. E:
// each function as the plain version rounds it (RA > kExactFrom), else
// the recurrence.
template <int C, bool E = false>
__device__ __forceinline__ float chunk_record(float* __restrict__ rec,
                                             const float4* __restrict__ nodes, int p, int q,
                                             int N, int r0, int RA, float cutoff,
                                             float inv_cut) {
  constexpr int W = record_width(C);
  float out[W];
#pragma unroll
  for (int k = 0; k < W; ++k) out[k] = 0.f;
  float adj = 0.f;
  if (p < N && q < N) {
    const float4 a = nodes[p], c = nodes[q];
    const float r0x = c.x - a.x, r0y = c.y - a.y, r0z = c.z - a.z;
    const float d2 = r0x * r0x + r0y * r0y + r0z * r0z + kEps;
    const float inv_d = rsqrtf(d2);
    const float d = d2 * inv_d;
    out[C + 0] = r0x * inv_d;
    out[C + 1] = r0y * inv_d;
    out[C + 2] = r0z * inv_d;
    if (d < cutoff && p != q) {
      const float u = d * inv_cut;        // the angle pi d / cutoff, in units of pi
      float s1, c1, sk, ck;               // sin and cos of it and of (r0 + 1) pi u
      sincospif(u, &s1, &c1);
      sincospif((float)(r0 + 1) * u, &sk, &ck);
      adj = a.w * c.w;
      const float ae = adj * (0.5f * (c1 + 1.f));
      const float ae_d = ae * inv_d;
      if constexpr (E) {                  // as ops/basis.py::painn_radial_basis rounds
        const float dp = __fsqrt_rn(__fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(r0x, r0x), __fmul_rn(r0y, r0y)), __fmul_rn(r0z, r0z)),
            kEps));
        const float inv_dp = __frcp_rn(dp);
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const int r = r0 + k;
          const float coef = __fdiv_rn(__fmul_rn((float)(r + 1), kPi), cutoff);
          out[k] = r < RA - 1 ? ae * (sin_reduced(__fmul_rn(coef, dp)) * inv_dp)
                              : (r == RA - 1 ? ae : 0.f);
        }
      } else {
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const int r = r0 + k;
          out[k] = r < RA - 1 ? ae_d * sk : (r == RA - 1 ? ae : 0.f);
          const float sn = sk * c1 + ck * s1;
          ck = ck * c1 - sk * s1;
          sk = sn;
        }
      }
    }
  }
  float4* r4 = reinterpret_cast<float4*>(rec);
#pragma unroll
  for (int k = 0; k < W / 4; ++k)
    r4[k] = make_float4(out[4 * k], out[4 * k + 1], out[4 * k + 2], out[4 * k + 3]);
  return adj;
}

// Run fn(bool_constant<RA > kExactFrom>): chunk_record's E for a wide basis.
template <typename Fn>
int with_exact(int RA, Fn&& fn) {
  return RA > kExactFrom ? fn(std::true_type{}) : fn(std::false_type{});
}

// Run fn(integral_constant<RA>) for the runtime RA; the templated kernels
// exist for RA (n_rbf + 1) in 2..kTemplateMaxRA.
template <typename Fn>
int with_ra(int RA, Fn&& fn) {
  switch (RA) {
#define CGVAE_RA_CASE(n) \
  case n:                \
    return fn(std::integral_constant<int, n>{});
    CGVAE_RA_CASE(2) CGVAE_RA_CASE(3) CGVAE_RA_CASE(4) CGVAE_RA_CASE(5)
    CGVAE_RA_CASE(6) CGVAE_RA_CASE(7) CGVAE_RA_CASE(8) CGVAE_RA_CASE(9)
    CGVAE_RA_CASE(10) CGVAE_RA_CASE(11) CGVAE_RA_CASE(12) CGVAE_RA_CASE(13)
    CGVAE_RA_CASE(14) CGVAE_RA_CASE(15) CGVAE_RA_CASE(16)
#undef CGVAE_RA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Allow a kernel more than the default 48 KB of dynamic shared memory.
// ``allowed`` (one slot per device) remembers what was granted, so a launch
// that needs no more makes no runtime call (as inside a CUDA graph capture).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, int (&allowed)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0 || dev >= kMaxDevices) return err != 0 ? err : (int)cudaErrorInvalidDevice;
  if ((int)bytes <= allowed[dev]) return 0;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes);
  if (err == 0) allowed[dev] = (int)bytes;
  return err;
}

// out[i] = sum_k part[k * n + i]: the second pass of a weight gradient that
// the backward kernels leave as partial sums (per batch element, node tile
// or frame group). A fixed order of summation, so the result is
// deterministic.
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
