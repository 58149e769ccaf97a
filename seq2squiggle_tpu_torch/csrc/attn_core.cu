// Training attention core for Hopper (sm_90a), forward and backward: the port
// of the Pallas kernel pair behind
// seq2squiggle_tpu/ops/pallas/attn_core.py::packed_attention_core
// (_core_fwd_call, _core_bwd_call). q, k, v, out and the gradients are all
// (B, L, 64) with the 8 heads packed along the last axis (d_k = 8).
//
//   forward   ctx = softmax(q kᵀ/√d_k) v per head, with the Cauchy–Schwarz
//             shift ‖q_t‖·max_s‖k_s‖/√d_k; e = exp(..) rounded to the compute
//             dtype, num and den summed in f32 from it, ctx = num/den.
//   backward  nothing is saved but q, k, v: e and den are recomputed with the
//             forward's own code (attn_common.cuh), then
//               ĝ  = cast(g/den)            g_a = ĝ·vᵀ (f32)
//               r  = (Σ_d ĝ·num)/den        dS  = cast(e·((g_a − r)/√d_k))
//               gq = dS·k    gk = dSᵀ·q    gv = eᵀ·ĝ   (f32 sums, cast once)
//             The shift is a constant of the softmax and gets no gradient.
//
// Bound: operations, not bytes. A call at B = 512, L = 250 moves 4 (forward)
// or 7 (backward) tensors of 16 MB in bf16, microseconds at 3.35 TB/s,
// against 16 (forward) to ~100 (backward) f32 FMAs and one to three expf per
// (query, key) pair of 2.6e8 pairs. The d_k = 8 products are too thin for
// the tensor cores to pay without repacking, so this first version runs them
// on the CUDA cores. Design: one thread block per (batch row, head); the
// head's q, k, v slices (L x 8) live in shared memory, so device memory is
// read once; scores are recomputed and never stored. gq is a sum over keys
// and needs no reduction: one thread per query. gk and gv are sums over
// queries: instead of reducing across the query threads (atomics, or a tree
// in shared memory), a second sweep gives one thread per KEY, which walks all
// queries in order with the per-query shift, r and ĝ that the first sweep
// left in shared memory. That costs a third evaluation of exp per pair and
// buys a fixed summation order: the gradients are bit-equal from run to run.
// Ragged L needs no padding: every loop is bounded by L.
//
// C interface (loaded with ctypes by ops/_build.py): each entry point returns
// cudaGetLastError() after its launch.

#include "attn_common.cuh"

namespace {

using namespace s2s;

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ void load_head(T* dst, const T* src, int L, int tid) {
  for (int t = tid; t < L; t += THREADS) copy8(dst + t * DK, src + (size_t)t * D);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_core_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, const int L,
                     const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + (size_t)L * DK;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const size_t base = (size_t)b * L * D + h * DK;
  load_head(sK, k + base, L, tid);
  load_head(sV, v + base, L, tid);
  __syncthreads();
  const float knorm = warp_max_knorm<T, DK>(sK, L, tid & 31);

  for (int t = tid; t < L; t += THREADS) {
    float qv[DK], num[DK], den, ctx[DK];
    load8(q + base + (size_t)t * D, qv);
    attend_query<T, DK>(qv, sK, sV, L, inv_temp, false, cs_shift(qv, knorm, inv_temp),
                        num, den);
#pragma unroll
    for (int c = 0; c < DK; ++c) ctx[c] = __fdiv_rn(num[c], den);
    store8(out + base + (size_t)t * D, ctx);
  }
}

// TO is the gradients' type: T (rounded once on store), or float for the
// whole-block training backward, which wants the f32 sums themselves.
template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
attn_core_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     TO* __restrict__ gq, TO* __restrict__ gk, TO* __restrict__ gv,
                     const int L, const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + (size_t)L * DK;
  T* sV = sK + (size_t)L * DK;
  T* sGh = sV + (size_t)L * DK;                       // ĝ = cast(g/den) per query
  float* sShift = reinterpret_cast<float*>(sGh + (size_t)L * DK);
  float* sR = sShift + L;                             // softmax-jacobian row dot

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const size_t base = (size_t)b * L * D + h * DK;
  load_head(sQ, q + base, L, tid);
  load_head(sK, k + base, L, tid);
  load_head(sV, v + base, L, tid);
  __syncthreads();
  const float knorm = warp_max_knorm<T, DK>(sK, L, tid & 31);

  // ---- sweep over queries: den, num, ĝ, r (kept for the key sweep), then gq.
  for (int t = tid; t < L; t += THREADS) {
    float qv[DK], num[DK], den, gh[DK];
    load8(sQ + t * DK, qv);
    const float shift = cs_shift(qv, knorm, inv_temp);
    attend_query<T, DK>(qv, sK, sV, L, inv_temp, false, shift, num, den);
    load8(g + base + (size_t)t * D, gh);
    float r = 0.f;
#pragma unroll
    for (int c = 0; c < DK; ++c) {
      gh[c] = round_cd<T>(__fdiv_rn(gh[c], den));
      r = fmaf(gh[c], num[c], r);
    }
    r = __fdiv_rn(r, den);
    store8(sGh + t * DK, gh);  // exact: gh is already in the compute dtype
    sShift[t] = shift;
    sR[t] = r;

    float acc[DK] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < L; ++s) {
      float kv[DK], vv[DK];
      load8(sK + s * DK, kv);
      load8(sV + s * DK, vv);
      const float e = cs_exp<T>(dot8(qv, kv), shift, inv_temp);
      const float ds =
          round_cd<T>(__fmul_rn(e, __fmul_rn(__fsub_rn(dot8(gh, vv), r), inv_temp)));
#pragma unroll
      for (int c = 0; c < DK; ++c) acc[c] = fmaf(ds, kv[c], acc[c]);
    }
    store8(gq + base + (size_t)t * D, acc);
  }
  __syncthreads();

  // ---- sweep over keys: gk and gv, summed over the queries in order.
  for (int s = tid; s < L; s += THREADS) {
    float kv[DK], vv[DK];
    load8(sK + s * DK, kv);
    load8(sV + s * DK, vv);
    float ak[DK] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float av[DK] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < L; ++t) {
      float qv[DK], gh[DK];
      load8(sQ + t * DK, qv);
      load8(sGh + t * DK, gh);
      const float e = cs_exp<T>(dot8(qv, kv), sShift[t], inv_temp);
      const float ds =
          round_cd<T>(__fmul_rn(e, __fmul_rn(__fsub_rn(dot8(gh, vv), sR[t]), inv_temp)));
#pragma unroll
      for (int c = 0; c < DK; ++c) {
        ak[c] = fmaf(ds, qv[c], ak[c]);
        av[c] = fmaf(e, gh[c], av[c]);
      }
    }
    store8(gk + base + (size_t)s * D, ak);
    store8(gv + base + (size_t)s * D, av);
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, int B, int L,
               float inv_temp, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)L * DK * sizeof(T);
  cudaError_t err = allow_shared_memory(attn_core_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_core_fwd_kernel<T><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), L, inv_temp);
  return (int)cudaGetLastError();
}

template <typename T, typename TO>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* gq,
               void* gk, void* gv, int B, int L, float inv_temp, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)L * DK * sizeof(T) + 2 * (size_t)L * sizeof(float);
  cudaError_t err = allow_shared_memory(attn_core_bwd_kernel<T, TO>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_core_bwd_kernel<T, TO><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<TO*>(gq), static_cast<TO*>(gk),
      static_cast<TO*>(gv), L, inv_temp);
  return (int)cudaGetLastError();
}

}  // namespace

int s2s::attn_core_bwd_f32(const void* q, const void* k, const void* v, const void* g,
                           float* gq, float* gk, float* gv, int B, int L, int dtype,
                           float inv_temp, cudaStream_t stream) {
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(q, k, v, g, gq, gk, gv, B, L, inv_temp, stream);
  if (dtype == 1) return launch_bwd<float, float>(q, k, v, g, gq, gk, gv, B, L, inv_temp, stream);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, out: (B, L, 64) contiguous, bf16 (dtype 0) or f32 (dtype 1).
extern "C" int s2s_attn_core_fwd(const void* q, const void* k, const void* v, void* out,
                                 int B, int L, int dtype, float inv_temp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<__nv_bfloat16>(q, k, v, out, B, L, inv_temp, s);
  if (dtype == 1) return launch_fwd<float>(q, k, v, out, B, L, inv_temp, s);
  return (int)cudaErrorInvalidValue;
}

// g: the gradient of the loss by out, in q's dtype; gq, gk, gv: as q.
extern "C" int s2s_attn_core_bwd(const void* q, const void* k, const void* v, const void* g,
                                 void* gq, void* gk, void* gv, int B, int L, int dtype,
                                 float inv_temp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(q, k, v, g, gq, gk, gv, B, L, inv_temp, s);
  if (dtype == 1) return launch_bwd<float, float>(q, k, v, g, gq, gk, gv, B, L, inv_temp, s);
  return (int)cudaErrorInvalidValue;
}
