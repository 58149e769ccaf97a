// Device functions shared by the port's attention kernels (fft_block.cu, the
// fused inference block; attn_core.cu, the training attention core;
// block_train.cu, the whole-block training kernels): compute-dtype <-> f32
// conversion, 8-wide head-slice loads and stores, warp reductions and the
// softmax of one query row against all keys of its head.
//
// Numerics (as the TPU kernels' _attn_headloop / _attn_packed): exact row max
// for the head loop, per-head Cauchy–Schwarz bound ‖q_t‖·max_s‖k_s‖/√d_k for
// the packed form; exp in f32, cast to the compute dtype before e·v; den
// summed from the cast values in f32 and clamped at 1e-30 (a row whose exps
// all underflow gives ctx = 0, not NaN); the divide comes after the product.
// Every multiply-then-add that must give the same bits in two kernels (the
// backward recomputes the forward's e) is written with the _rn intrinsics,
// which the compiler never contracts into an FMA.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace s2s {

constexpr int D = 64;   // d_model
constexpr int H = 8;    // heads
constexpr int DK = 8;   // d_k
constexpr float DEN_MIN = 1e-30f;

static_assert(D == H * DK, "head split");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the compute dtype, as f32.
template <typename T> __device__ __forceinline__ float round_cd(float v) {
  return to_f(from_f<T>(v));
}

// Eight consecutive compute-dtype values (one head's d_k channels) -> f32.
__device__ __forceinline__ void load8(const float* p, float o[DK]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float o[DK]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Eight f32 values -> eight consecutive compute-dtype values, rounded once.
__device__ __forceinline__ void store8(float* p, const float o[DK]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float o[DK]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Eight consecutive values copied as they are (16-byte aligned both sides).
template <typename T> struct alignas(16) Pack8 { T v[DK]; };
template <typename T> __device__ __forceinline__ void copy8(T* dst, const T* src) {
  *reinterpret_cast<Pack8<T>*>(dst) = *reinterpret_cast<const Pack8<T>*>(src);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float dot8(const float a[DK], const float b[DK]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DK; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// max over the L keys of one head of ‖k_s‖, computed by one whole warp.
// kh points at the head's first channel of key 0; rows are S values apart.
template <typename T, int S>
__device__ __forceinline__ float warp_max_knorm(const T* kh, int L, int lane) {
  float m2 = 0.f;
  for (int s = lane; s < L; s += 32) {
    float kv[DK];
    load8(kh + s * S, kv);
    m2 = fmaxf(m2, dot8(kv, kv));
  }
  return sqrtf(warp_max(m2));
}

// The Cauchy–Schwarz shift of one query: ‖q_t‖ · max_s‖k_s‖ / √d_k.
__device__ __forceinline__ float cs_shift(const float q[DK], float knorm, float inv_temp) {
  return __fmul_rn(__fmul_rn(sqrtf(dot8(q, q)), knorm), inv_temp);
}

// e = exp(q·k/√d_k − shift) rounded to the compute dtype (packed form).
template <typename T>
__device__ __forceinline__ float cs_exp(float score, float shift, float inv_temp) {
  return round_cd<T>(expf(__fsub_rn(__fmul_rn(score, inv_temp), shift)));
}

// One query of one head against all L keys: num = Σ_s e·v and den = max(Σ_s e,
// 1e-30), both f32 sums of the compute-dtype e. qh/kh/vh point at the head's
// first channel of row 0 (shared memory; rows S values apart); a warp that
// shares the head reads each k/v row as a broadcast. headloop picks the exact
// row max (one more pass over the keys), else `shift` is the query's
// Cauchy–Schwarz shift.
template <typename T, int S>
__device__ __forceinline__ void attend_query(const float q[DK], const T* kh, const T* vh,
                                             int L, float inv_temp, bool headloop,
                                             float shift, float num[DK], float& den) {
  if (headloop) {
    float m = -INFINITY;
    for (int s = 0; s < L; ++s) {
      float kv[DK];
      load8(kh + s * S, kv);
      m = fmaxf(m, dot8(q, kv));
    }
    shift = m;
  }
#pragma unroll
  for (int c = 0; c < DK; ++c) num[c] = 0.f;
  den = 0.f;
  for (int s = 0; s < L; ++s) {
    float kv[DK], vv[DK];
    load8(kh + s * S, kv);
    const float sc = dot8(q, kv);
    const float e = headloop ? round_cd<T>(expf(__fmul_rn(__fsub_rn(sc, shift), inv_temp)))
                             : cs_exp<T>(sc, shift, inv_temp);
    den = __fadd_rn(den, e);
    load8(vh + s * S, vv);
#pragma unroll
    for (int c = 0; c < DK; ++c) num[c] = fmaf(e, vv[c], num[c]);
  }
  den = fmaxf(den, DEN_MIN);
}

// Dynamic shared memory above 48 KB (long sequences) must be asked for; a
// size past the device's limit is refused here or at the launch, and reported.
constexpr size_t STATIC_SMEM_MAX = 48 * 1024;
template <typename K>
inline cudaError_t allow_shared_memory(K kernel, size_t smem) {
  if (smem <= STATIC_SMEM_MAX) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The attention-core backward (attn_core.cu) with gq, gk, gv left as the f32
// sums, before their cast: one stage of the whole-block training backward
// (block_train.cu), which adds the f32 values into the bias gradients. q, k,
// v, g: (B, L, 64) in the compute dtype (0 bf16, 1 f32). Returns
// cudaGetLastError() after the launch.
int attn_core_bwd_f32(const void* q, const void* k, const void* v, const void* g, float* gq,
                      float* gk, float* gv, int B, int L, int dtype, float inv_temp,
                      cudaStream_t stream);

}  // namespace s2s
