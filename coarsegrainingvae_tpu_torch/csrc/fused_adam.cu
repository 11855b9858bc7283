// The optimizer step of the train step, fused: the skip-batch guard, the
// global-norm clip, Adam with both moments in the moment dtype, and the
// apply, in one pass over device memory, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's optimizer is plain jnp
// (train/trainer.py there), which XLA fuses into a few loops. Written as
// PyTorch ops over the flat gradient (ops/fused_adam.py::fused_adam_reference)
// the same step makes about 25 full-length passes over the P parameters
// (casts, the clip's divide and select, each moment's multiplies and adds,
// the bias corrections, the square root, the selects of the guard), about
// 220 bytes a parameter, 11.3 GB a step at the recipe's P = 51.4 M.
//
// What bounds it: bytes. The work needs one read of the gradient for its
// norm (4 B/P) and one pass that reads the gradient, the parameters and both
// moments and writes the parameters and moments back in place: 4 + 4 + 2 + 2
// read, 4 + 2 + 2 written at f32 parameters and bf16 moments, 24 B/P in
// all, 1.23 GB or 0.37 ms at 3.35 TB/s at the recipe's P (32 B/P with the
// flat gradient's concatenation that precedes it). Its arithmetic (three
// divisions, a square root, a dozen multiplies and adds an element) is far
// below the card's rate.
//
// What the design does about it: three launches in place of ~25 passes.
//  (a) fused_adam_sq_partials: a fixed grid of kNormBlocks blocks sums the
//      squares of the gradient (16-byte loads, each thread a fixed sequence
//      of elements), one partial per block. No float atomics: the norm is
//      summed in one order, so a replay gives the same bits.
//  (b) fused_adam_finalize: one block sums the partials in a fixed order and
//      computes the norm, the guard (loss finite and below the threshold,
//      norm finite), whether the clip acts, the bias corrections from
//      count + 1 and -lr; it writes ok and, on an accepted batch, count + 1.
//      These scalars are final before any block of (c) reads them (stream
//      order), so no kernel both reads and bumps the count.
//  (c) fused_adam_update<M>: one block per chunk of the chunk table
//      (ops/fused_adam.py::chunk_table; a chunk never crosses a parameter).
//      Each thread takes kVec = 8 elements a pass with 16-byte loads and
//      stores of the gradient, the parameter and both moments where the
//      chunk is aligned (kVector), one element at a time where it is not
//      and in the chunk's tail. The update is computed in f32 in the plain
//      version's order, each operation rounded alone (__f*_rn: no FMA
//      contraction), the moments rounded to M and the parameter to its own
//      dtype (f32, or bf16 for the compute-dtype filters) once, to nearest
//      even. A rejected batch writes nothing: parameters, moments and count
//      keep their bits.
// fused_adam_norm runs (a) and a norm-only (b), so that every path on the
// card that clips with the whole gradient's norm reads the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kNormBlocks = 1024;  // the partials' grid, fixed, and the finalize's block
constexpr int kThreads = 256;      // threads of a block of (a) and (c)
constexpr int kVec = 8;            // elements a thread takes a pass: ops/fused_adam.py::VEC
constexpr int kScalars = 8;        // the scalars (b) writes after the partials

enum ChunkFlags { kBf16Param = 1, kVector = 2 };  // ops/fused_adam.py::BF16, VECTOR
enum Scalar { kOk, kClip, kNorm, kC1, kC2, kNegLr };

__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= 3.40282347e38f; }

// The block's sum in thread 0: each warp by shuffles, then warp 0 over the
// warps' sums; a fixed order for a fixed block size (a multiple of 32).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? warp_sums[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

struct Step {
  bool clip;
  float norm, max_norm, c1, c2, neg_lr, b1, omb1, b2, omb2, eps;
};

// One element, in ops/fused_adam.py::fused_adam_reference's order:
// clip_by_global_norm, scale_by_adam, then p + (-lr * update).
__device__ __forceinline__ void adam(float g, float& p, float& m, float& v, const Step& s) {
  if (s.clip) g = __fmul_rn(__fdiv_rn(g, s.norm), s.max_norm);
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float upd =
      __fdiv_rn(__fdiv_rn(m, s.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), s.eps));
  p = __fadd_rn(p, __fmul_rn(s.neg_lr, upd));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_float(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// kVec elements at a 16-byte-aligned address: two float4, or one uint4 of bf16
__device__ __forceinline__ void load(const float* a, float (&x)[kVec]) {
  const float4 lo = reinterpret_cast<const float4*>(a)[0];
  const float4 hi = reinterpret_cast<const float4*>(a)[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}
__device__ __forceinline__ void store(float* a, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(a)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(a)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
union Bf16x8 {
  uint4 u;
  __nv_bfloat162 h[4];
};
__device__ __forceinline__ void load(const __nv_bfloat16* a, float (&x)[kVec]) {
  Bf16x8 b;
  b.u = *reinterpret_cast<const uint4*>(a);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(b.h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store(__nv_bfloat16* a, const float (&x)[kVec]) {
  Bf16x8 b;
#pragma unroll
  for (int k = 0; k < 4; ++k) b.h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(a) = b.u;
}

// One chunk: len elements of one parameter p, at g, m and v of the same
// flat offset. With `vec` the first len / kVec * kVec go kVec at a time.
template <typename M, typename P>
__device__ __forceinline__ void update_chunk(P* p, const float* g, M* m, M* v, int len, bool vec,
                                             const Step& s) {
  const int n_vec = vec ? len / kVec : 0;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const int o = i * kVec;
    float gx[kVec], px[kVec], mx[kVec], vx[kVec];
    load(g + o, gx);
    load(p + o, px);
    load(m + o, mx);
    load(v + o, vx);
#pragma unroll
    for (int k = 0; k < kVec; ++k) adam(gx[k], px[k], mx[k], vx[k], s);
    store(p + o, px);
    store(m + o, mx);
    store(v + o, vx);
  }
  for (int i = n_vec * kVec + threadIdx.x; i < len; i += blockDim.x) {
    float px = to_float(p[i]), mx = to_float(m[i]), vx = to_float(v[i]);
    adam(g[i], px, mx, vx, s);
    from_float(px, p + i);
    from_float(mx, m + i);
    from_float(vx, v + i);
  }
}

}  // namespace

// (a) one partial sum of squares per block
__global__ void __launch_bounds__(kThreads)
    fused_adam_sq_partials(const float* __restrict__ g, long long n, float* __restrict__ partials) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const long long n4 = n / 4;
  float acc0 = 0.f, acc1 = 0.f;
  long long i = t;
  for (; i + stride < n4; i += 2 * stride) {
    const float4 a = g4[i], b = g4[i + stride];
    acc0 = fmaf(a.x, a.x, acc0); acc0 = fmaf(a.y, a.y, acc0);
    acc0 = fmaf(a.z, a.z, acc0); acc0 = fmaf(a.w, a.w, acc0);
    acc1 = fmaf(b.x, b.x, acc1); acc1 = fmaf(b.y, b.y, acc1);
    acc1 = fmaf(b.z, b.z, acc1); acc1 = fmaf(b.w, b.w, acc1);
  }
  if (i < n4) {
    const float4 a = g4[i];
    acc0 = fmaf(a.x, a.x, acc0); acc0 = fmaf(a.y, a.y, acc0);
    acc0 = fmaf(a.z, a.z, acc0); acc0 = fmaf(a.w, a.w, acc0);
  }
  for (long long j = 4 * n4 + t; j < n; j += stride) acc1 = fmaf(g[j], g[j], acc1);
  const float s = block_sum(acc0 + acc1);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// (b) the norm and the step's scalars; with count null, the norm alone
__global__ void __launch_bounds__(kNormBlocks)
    fused_adam_finalize(const float* __restrict__ partials, float* __restrict__ scalars,
                        const float* loss, const float* lr, int* count, unsigned char* ok_out,
                        float thresh, float max_norm, float b1, float b2) {
  const float s = block_sum(partials[threadIdx.x]);
  if (threadIdx.x != 0) return;
  const float norm = __fsqrt_rn(s);
  scalars[kNorm] = norm;
  if (count == nullptr) return;
  const float l = *loss;
  const bool ok = finite(l) && l < thresh && finite(norm);
  const int next = *count + 1;
  const float t = __int2float_rn(next);
  scalars[kOk] = ok ? 1.f : 0.f;
  scalars[kClip] = norm < max_norm ? 0.f : 1.f;
  scalars[kC1] = __fsub_rn(1.f, powf(b1, t));
  scalars[kC2] = __fsub_rn(1.f, powf(b2, t));
  scalars[kNegLr] = -*lr;
  *ok_out = ok ? 1 : 0;
  if (ok) *count = next;
}

// (c) the update, in place; chunks is the (n_chunks, 4) int64 table of
// (address of the chunk's first parameter element, flat offset, length, flags)
template <typename M>
__global__ void __launch_bounds__(kThreads)
    fused_adam_update(const long long* __restrict__ chunks, const float* __restrict__ g,
                      M* __restrict__ mu, M* __restrict__ nu, const float* __restrict__ scalars,
                      float max_norm, float b1, float omb1, float b2, float omb2, float eps) {
  if (scalars[kOk] == 0.f) return;
  const long long* c = chunks + 4 * static_cast<long long>(blockIdx.x);
  const long long flat = c[1];
  const int len = static_cast<int>(c[2]);
  const int flags = static_cast<int>(c[3]);
  const Step s{scalars[kClip] != 0.f, scalars[kNorm], max_norm, scalars[kC1], scalars[kC2],
               scalars[kNegLr], b1, omb1, b2, omb2, eps};
  const bool vec = (flags & kVector) != 0;
  if (flags & kBf16Param) {
    update_chunk(reinterpret_cast<__nv_bfloat16*>(c[0]), g + flat, mu + flat, nu + flat, len,
                 vec, s);
  } else {
    update_chunk(reinterpret_cast<float*>(c[0]), g + flat, mu + flat, nu + flat, len, vec, s);
  }
}

// What the wrapper reads once: the floats of scratch a call needs (the
// partials, then the scalars), where the norm lies in it, and the vector
// width the chunk table is cut for.
extern "C" void fused_adam_layout(int* out) {
  out[0] = kNormBlocks + kScalars;
  out[1] = kNormBlocks + kNorm;
  out[2] = kVec;
}

// The step: (a), (b), (c) on `stream`; returns the first failed launch's
// cudaError_t, or 0.
extern "C" int fused_adam_step(const float* g, long long n, const long long* chunks, int n_chunks,
                               void* mu, void* nu, int moments_bf16, int* count,
                               const float* loss, const float* lr, float thresh, float max_norm,
                               float b1, float omb1, float b2, float omb2, float eps,
                               float* scratch, unsigned char* ok, cudaStream_t stream) {
  float* scalars = scratch + kNormBlocks;
  fused_adam_sq_partials<<<kNormBlocks, kThreads, 0, stream>>>(g, n, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_adam_finalize<<<1, kNormBlocks, 0, stream>>>(scratch, scalars, loss, lr, count, ok,
                                                     thresh, max_norm, b1, b2);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 0) return static_cast<int>(err);
  if (moments_bf16) {
    fused_adam_update<__nv_bfloat16><<<n_chunks, kThreads, 0, stream>>>(
        chunks, g, static_cast<__nv_bfloat16*>(mu), static_cast<__nv_bfloat16*>(nu), scalars,
        max_norm, b1, omb1, b2, omb2, eps);
  } else {
    fused_adam_update<float><<<n_chunks, kThreads, 0, stream>>>(
        chunks, g, static_cast<float*>(mu), static_cast<float*>(nu), scalars, max_norm, b1, omb1,
        b2, omb2, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The global norm of g alone, as the step computes it, into scratch's norm
// slot (fused_adam_layout).
extern "C" int fused_adam_norm(const float* g, long long n, float* scratch, cudaStream_t stream) {
  fused_adam_sq_partials<<<kNormBlocks, kThreads, 0, stream>>>(g, n, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_adam_finalize<<<1, kNormBlocks, 0, stream>>>(scratch, scratch + kNormBlocks, nullptr,
                                                     nullptr, nullptr, nullptr, 0.f, 0.f, 0.f,
                                                     0.f);
  return static_cast<int>(cudaGetLastError());
}
