// Profiling variants of the fused FFT block for Hopper (sm_90a): the ports of
// the three Pallas timing kernels
//   scripts/profiling/profile_abc.py::fused    (softmax orderings a, b, c),
//   scripts/profiling/profile_d.py::fused      (exact max b against the per-head
//                                               Cauchy–Schwarz shift d),
//   scripts/profiling/profile_parts2.py::fused (the block cut after a stage).
// They answer what each piece of the attention costs inside the fused block
// on this card; the model never calls them.
//
// Every kernel here is fft_block_body.cuh's block with another attention:
// the same projections into shared memory, then one thread per QUERY that
// walks the eight heads in order (a warp's lanes share the head, so each k/v
// row read is a shared-memory broadcast, as in the block's own attention; the
// work per thread is the same eight (head, query) items), then the same
// fc + LN1 + FFN + LN2 tail. A thread owns a whole query so that the partial
// stages can sum their per-head results over the heads in f32, in head
// order, as the TPU script's `acc` does. Bound: as the fused block, the issue
// rate of the f32 loops over shared memory, not device memory.
//
//   a  scores·τ, f32 softmax (max, sum, divide), probabilities cast, then p·v
//   b  the block's exact-max form: one exp pass cast to the compute dtype,
//      den summed from the cast values, the divide after e·v  (= attend_query)
//   c  b with den carried as a ninth column of the e·v product (v extended
//      by a column of ones). On this card den is already summed in that loop,
//      and fma(e, 1, den) rounds as den + e does: bit-equal to b.
//   d  the Cauchy–Schwarz shift ‖q_t‖·max_s‖k_s‖·τ computed per head, and
//      den + 1e-30 (b's forms clamp with max instead)
//   stages proj, scores, max, exp, ctx, den: the block cut there, what was
//      computed folded into the output by the script's sinks (q + k + v; the
//      first eight key columns of the scores, of scores + max, of e; num;
//      cast(num / den)), summed over the heads and tiled eight times. `full`
//      is b.
// A value that nothing reads is never computed by this compiler, so the
// stages that compute L scores or exps but sink only eight of them also fold
// all of them into one word that is compared with a NaN argument (never
// equal): one integer op per element.
//
// C interface (loaded with ctypes by ops/_build.py): each entry point returns
// cudaGetLastError() after the launch.

#include "fft_block_body.cuh"

namespace {

using namespace s2s;

enum Mode : int {
  MODE_A = 0, MODE_B, MODE_C, MODE_D,
  STAGE_PROJ, STAGE_SCORES, STAGE_MAX, STAGE_EXP, STAGE_CTX, STAGE_DEN,
  N_MODES
};

__host__ __device__ constexpr bool is_stage(int mode) { return mode >= STAGE_PROJ; }

// e of the exact-max form: exp((s − m)·τ) rounded to the compute dtype.
template <typename T>
__device__ __forceinline__ float exact_exp(float score, float m, float inv_temp) {
  return round_cd<T>(expf(__fmul_rn(__fsub_rn(score, m), inv_temp)));
}

template <typename T>
__device__ __forceinline__ float score_of(const float q[DK], const T* kh, int s) {
  float kv[DK];
  load8(kh + s * D, kv);
  return dot8(q, kv);
}

// max over the keys of the un-tempered scores, the first eight kept in
// first[] (L >= 8).
template <typename T>
__device__ __forceinline__ float row_max(const float q[DK], const T* kh, int L,
                                         float first[DK]) {
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < DK; ++s) {
    first[s] = score_of(q, kh, s);
    m = fmaxf(m, first[s]);
  }
  for (int s = DK; s < L; ++s) m = fmaxf(m, score_of(q, kh, s));
  return m;
}

// One (head, query) item of a whole-block variant: ctx in f32, before its cast.
template <typename T, int MODE>
__device__ __forceinline__ void variant_ctx(const float q[DK], const T* kh, const T* vh, int L,
                                            float inv_temp, float knorm, float ctx[DK]) {
  if constexpr (MODE == MODE_A) {
    float m = -INFINITY;
    for (int s = 0; s < L; ++s) m = fmaxf(m, __fmul_rn(score_of(q, kh, s), inv_temp));
    float den = 0.f;
    for (int s = 0; s < L; ++s)
      den = __fadd_rn(den, expf(__fsub_rn(__fmul_rn(score_of(q, kh, s), inv_temp), m)));
#pragma unroll
    for (int c = 0; c < DK; ++c) ctx[c] = 0.f;
    for (int s = 0; s < L; ++s) {
      const float e = expf(__fsub_rn(__fmul_rn(score_of(q, kh, s), inv_temp), m));
      const float p = round_cd<T>(__fdiv_rn(e, den));
      float vv[DK];
      load8(vh + s * D, vv);
#pragma unroll
      for (int c = 0; c < DK; ++c) ctx[c] = fmaf(p, vv[c], ctx[c]);
    }
  } else if constexpr (MODE == MODE_B) {
    // den >= 1 under the exact max (the largest score gives e = 1), so
    // attend_query's clamp at 1e-30 changes nothing.
    float den;
    attend_query<T, D>(q, kh, vh, L, inv_temp, true, 0.f, ctx, den);
#pragma unroll
    for (int c = 0; c < DK; ++c) ctx[c] = __fdiv_rn(ctx[c], den);
  } else if constexpr (MODE == MODE_C) {
    float m = -INFINITY;
    for (int s = 0; s < L; ++s) m = fmaxf(m, score_of(q, kh, s));
    float nd[DK + 1];
#pragma unroll
    for (int c = 0; c <= DK; ++c) nd[c] = 0.f;
    for (int s = 0; s < L; ++s) {
      const float e = exact_exp<T>(score_of(q, kh, s), m, inv_temp);
      float va[DK + 1];
      load8(vh + s * D, va);
      va[DK] = 1.f;
#pragma unroll
      for (int c = 0; c <= DK; ++c) nd[c] = fmaf(e, va[c], nd[c]);
    }
#pragma unroll
    for (int c = 0; c < DK; ++c) ctx[c] = __fdiv_rn(nd[c], nd[DK]);
  } else {
    static_assert(MODE == MODE_D, "a whole-block variant");
    const float shift = cs_shift(q, knorm, inv_temp);
    float den = 0.f;
#pragma unroll
    for (int c = 0; c < DK; ++c) ctx[c] = 0.f;
    for (int s = 0; s < L; ++s) {
      const float e = cs_exp<T>(score_of(q, kh, s), shift, inv_temp);
      den = __fadd_rn(den, e);
      float vv[DK];
      load8(vh + s * D, vv);
#pragma unroll
      for (int c = 0; c < DK; ++c) ctx[c] = fmaf(e, vv[c], ctx[c]);
    }
    den = __fadd_rn(den, DEN_MIN);
#pragma unroll
    for (int c = 0; c < DK; ++c) ctx[c] = __fdiv_rn(ctx[c], den);
  }
}

// One (head, query) item of a partial stage: what the script's sink adds to
// acc. `live` folds every score or exp of the row into one word.
template <typename T, int MODE>
__device__ __forceinline__ void stage_sink(const float q[DK], const T* kh, const T* vh, int L,
                                           float inv_temp, float add[DK], unsigned& live) {
  if constexpr (MODE == STAGE_SCORES) {
#pragma unroll
    for (int s = 0; s < DK; ++s) {
      add[s] = score_of(q, kh, s);
      live ^= __float_as_uint(add[s]);
    }
    for (int s = DK; s < L; ++s) live ^= __float_as_uint(score_of(q, kh, s));
  } else {
    float first[DK];
    const float m = row_max(q, kh, L, first);
    if constexpr (MODE == STAGE_MAX) {
#pragma unroll
      for (int c = 0; c < DK; ++c) add[c] = __fadd_rn(first[c], m);
    } else if constexpr (MODE == STAGE_EXP) {
#pragma unroll
      for (int s = 0; s < DK; ++s) {
        add[s] = exact_exp<T>(first[s], m, inv_temp);
        live ^= __float_as_uint(add[s]);
      }
      for (int s = DK; s < L; ++s)
        live ^= __float_as_uint(exact_exp<T>(score_of(q, kh, s), m, inv_temp));
    } else {
      static_assert(MODE == STAGE_CTX || MODE == STAGE_DEN, "a partial stage");
      float den = 0.f;
#pragma unroll
      for (int c = 0; c < DK; ++c) add[c] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float e = exact_exp<T>(score_of(q, kh, s), m, inv_temp);
        if constexpr (MODE == STAGE_DEN) den = __fadd_rn(den, e);
        float vv[DK];
        load8(vh + s * D, vv);
#pragma unroll
        for (int c = 0; c < DK; ++c) add[c] = fmaf(e, vv[c], add[c]);
      }
      if constexpr (MODE == STAGE_DEN) {
#pragma unroll
        for (int c = 0; c < DK; ++c) add[c] = round_cd<T>(__fdiv_rn(add[c], den));
      }
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
fft_block_variant_kernel(const T* __restrict__ x, T* __restrict__ out, const BlockWeights<T> w,
                         const int L, const float inv_temp, const float never) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockSmem<T> s = carve_smem<T>(smem, L);
  const T* xb = x + (size_t)blockIdx.x * L * D;
  T* ob = out + (size_t)blockIdx.x * L * D;

  project_qkv(xb, w, L, s.q, s.k, s.v);
  __syncthreads();

  if constexpr (MODE == STAGE_PROJ) {
    // (q + k + v) in the compute dtype: each sum rounded, as two array adds
    for (int i = threadIdx.x; i < L * D; i += THREADS)
      ob[i] = from_f<T>(__fadd_rn(round_cd<T>(__fadd_rn(to_f(s.q[i]), to_f(s.k[i]))),
                                  to_f(s.v[i])));
  } else if constexpr (is_stage(MODE)) {
    for (int t = threadIdx.x; t < L; t += THREADS) {
      float acc[DK];
#pragma unroll
      for (int c = 0; c < DK; ++c) acc[c] = 0.f;
      unsigned live = 0u;
      for (int h = 0; h < H; ++h) {
        float q[DK], add[DK];
        load8(s.q + t * D + h * DK, q);
        stage_sink<T, MODE>(q, s.k + h * DK, s.v + h * DK, L, inv_temp, add, live);
#pragma unroll
        for (int c = 0; c < DK; ++c) acc[c] = __fadd_rn(acc[c], add[c]);
      }
      if (__uint_as_float(live) == never) acc[0] = never;
      for (int h = 0; h < H; ++h) store8(ob + t * D + h * DK, acc);
    }
  } else {
    if constexpr (MODE == MODE_D) {
      max_key_norms(s.k, L, s.kn);
      __syncthreads();
    }
    for (int t = threadIdx.x; t < L; t += THREADS) {
      for (int h = 0; h < H; ++h) {
        float q[DK], ctx[DK];
        load8(s.q + t * D + h * DK, q);
        variant_ctx<T, MODE>(q, s.k + h * DK, s.v + h * DK, L, inv_temp,
                             MODE == MODE_D ? s.kn[h] : 0.f, ctx);
        // q[t, h] is read only by this thread, so ctx overwrites it in place
        store8(s.q + t * D + h * DK, ctx);
      }
    }
    __syncthreads();
    block_tail(xb, ob, w, L, s.q, s.hid);
  }
}

template <typename T, int MODE>
int launch_mode(const void* x, void* out, void* const* p, int B, int L, float inv_temp,
                cudaStream_t stream) {
  static SharedMemoryOptIn opted;
  size_t limit = 0;
  cudaError_t err = opt_in_shared_memory(fft_block_variant_kernel<T, MODE>, opted, &limit);
  if (err != cudaSuccess) return (int)err;
  fft_block_variant_kernel<T, MODE><<<B, THREADS, block_smem_bytes<T>(L), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), block_weights<T>(p), L, inv_temp,
      nanf(""));
  return (int)cudaGetLastError();
}

template <typename T, int MODE = 0>
int launch_any(int mode, const void* x, void* out, void* const* p, int B, int L,
               float inv_temp, cudaStream_t stream) {
  if constexpr (MODE < N_MODES) {
    if (mode == MODE) return launch_mode<T, MODE>(x, out, p, B, L, inv_temp, stream);
    return launch_any<T, MODE + 1>(mode, x, out, p, B, L, inv_temp, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

int launch(int mode, const void* x, void* out, void* const* p, int B, int L, int dtype,
           float inv_temp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the sinks read eight key columns
  if (mode > STAGE_PROJ && L < DK) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_any<__nv_bfloat16>(mode, x, out, p, B, L, inv_temp, s);
  if (dtype == 1) return launch_any<float>(mode, x, out, p, B, L, inv_temp, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// All three: x, out (B, L, 64) contiguous, bf16 (dtype 0) or f32 (dtype 1);
// weights as s2s_fft_block's.

// variant: 0 a, 1 b, 2 c.
extern "C" int s2s_fft_block_abc(const void* x, void* out, void* const* weights, int B, int L,
                                 int dtype, float inv_temp, int variant, void* stream) {
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  return launch(MODE_A + variant, x, out, weights, B, L, dtype, inv_temp, stream);
}

// variant: 0 b, 1 d.
extern "C" int s2s_fft_block_d(const void* x, void* out, void* const* weights, int B, int L,
                               int dtype, float inv_temp, int variant, void* stream) {
  if (variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  return launch(variant == 0 ? MODE_B : MODE_D, x, out, weights, B, L, dtype, inv_temp, stream);
}

// stage: 0 proj, 1 scores, 2 max, 3 exp, 4 ctx, 5 den, 6 full; scores to den
// need L >= 8 (their sinks read eight key columns).
extern "C" int s2s_fft_block_parts(const void* x, void* out, void* const* weights, int B, int L,
                                   int dtype, float inv_temp, int stage, void* stream) {
  if (stage < 0 || stage > 6) return (int)cudaErrorInvalidValue;
  return launch(stage == 6 ? MODE_B : STAGE_PROJ + stage, x, out, weights, B, L, dtype,
                inv_temp, stream);
}
