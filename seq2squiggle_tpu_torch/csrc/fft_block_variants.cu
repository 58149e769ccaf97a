// Profiling kernels of the fused FFT block for Hopper (sm_90a): the ports of
// the three Pallas timing kernels
//   scripts/profiling/profile_abc.py::fused    (softmax orderings a, b, c),
//   scripts/profiling/profile_d.py::fused      (exact max b against the per-head
//                                               Cauchy–Schwarz shift d),
//   scripts/profiling/profile_parts2.py::fused (the block cut after a stage),
// and of the eight `ablate` cuts of seq2squiggle_tpu/ops/pallas/fft_block.py::
// fused_fft_block (each takes one piece out of the block: noshift, thin16,
// noexp, bf16exp, nomask, noden inside the Cauchy–Schwarz attention, noattn
// and noffn around it; ops/fft_block_variants.py says what each computes).
// They answer what each piece costs inside the fused block on this card; the
// model never calls them.
//
// bfloat16 runs the fused block's own tensor-core body, block_mma.cuh: the
// same staged weights, 16-row-slab projections and tail, and one warp per
// head for the attention, so every difference between two of these kernels
// is a difference of the block that the predict path runs.
//   cuts  block_rows_mma with the cut as its CUT template choice (row_mma.cuh
//         lists what each hooks); in the exact form only noattn and noffn
//         exist, the others launch the uncut block
//   b, c  the block's exact form, block_rows_mma<EXACT>: b's kernel is the
//         fused block's, bit for bit. c carries den as a column of ones in
//         the e·v product, which the body's den `mma.sync` already is: c
//         launches b's kernel
//   d     the Cauchy–Schwarz form with den + 1e-30 (CUT_DEN_PLUS)
//   a     projections and tail of the body around three passes over the keys
//         per 16 queries: the row max of the scores (row_max_tile), the f32
//         sum of exp(s·τ − m), then p = cast(e / den) as the A operand of p·v
//   stages the body's projections, then proj (q + k + v) or, per head, a warp
//         sweeps the keys as far as the stage (scores; max; exp; num; cast(num
//         / den)) and sinks the first eight key columns (or ctx) into an L x 8
//         f32 buffer of its own in shared memory; after a barrier one pass
//         sums the heads 0..7 in f32 in head order, as the script's `acc`, and
//         tiles the sum eight times along D
// A value that nothing reads is never computed by this compiler, so the
// stages that compute L scores or exps but sink only eight of them also fold
// all of them into one word that is compared with a NaN argument (never
// equal): one integer op per element.
//
// float32 runs the CUDA-core body, fft_block_body.cuh, as the float32 block
// does: the timing kernels with one thread per query walking the eight heads
// (a thread owns a whole query, so the stages sum their per-head results over
// the heads in f32, in head order), the cuts with one (head, query) item per
// thread.
//
// Bound: as the fused block, operations (41.5 GFLOP per (1024, 250, 64)
// block) against ~66 MB of activations; what holds the tensor-core body is
// what these kernels are here to show.
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

// ---- bf16 on the tensor cores (block_mma.cuh) ---------------------------------

// The body's `finish`: LN2's affine, rounded, into the output rows. Under
// CUT_NOFFN the body hands over LN1's zhat, and the output is cast(h1).
template <int CUT = CUT_NONE>
__device__ __forceinline__ auto store_output(bf16* ob, const BlockWeights<bf16>& w) {
  return [ob, &w](const SlabLane& s, const float (&)[8][4], const float*,
                  const float (&zh)[8][4], const float*, const uint32_t*,
                  const uint32_t (&)[8][2]) {
    uint32_t op[8][2];
    if constexpr (CUT == CUT_NOFFN)
      ln_affine_packed(op, zh, w.ln1s, w.ln1b, s);
    else
      ln_affine_packed(op, zh, w.ln2s, w.ln2b, s);
    store_packed(ob, D, op, s);
  };
}

// The block with a cut: <true, CUT_NONE> is the fused block's exact form
// (fft_block.cu's fft_block_mma_kernel<true>, the same code), variant b.
template <bool EXACT, int CUT>
__global__ void __launch_bounds__(THREADS)
ablate_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                  const BlockWeights<bf16> w, const int L, const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)blockIdx.x * L * D;
  block_rows_mma<EXACT, false, false, CUT>(x + base, D, nullptr, nullptr, w, RowStores{}, L,
                                           inv_temp, smem, store_output<CUT>(out + base, w));
}

// e of variant a for one score: exp(s·τ − m) in f32, 0 for a key >= L.
__device__ __forceinline__ float softmax_exp(float score, float m, float inv_temp, bool key) {
  return key ? ex2(__fmul_rn(__fsub_rn(__fmul_rn(score, inv_temp), m), EXP_UNIT)) : 0.f;
}

// Variant a's attention, warp h on head h, ctx over q: per 16 queries m =
// max(s)·τ (rounding is monotone, so it is the max of the rounded s·τ), den
// the f32 sum of exp(s·τ − m) over the keys (lane sums joined across the
// quad), then p = cast(e / den) as the A operand of ctx = cast(p·v).
__device__ __forceinline__ void attend_heads_a(const SlabSmem& sm, int L, int Lp,
                                               float inv_temp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bf16* qh = sm.q + warp * DK;
  const bf16* kh = sm.k + warp * DK;
  const bf16* vh = sm.v + warp * DK;
  for (int q0 = 0; q0 < Lp; q0 += TILE) {
    uint32_t qa[2];
    load_a<LDA>(qa, qh, q0, lane);
    float m0, m1;
    row_max_tile<LDA>(m0, m1, qa, kh, L, Lp, lane);
    m0 = __fmul_rn(m0, inv_temp);
    m1 = __fmul_rn(m1, inv_temp);
    float den0 = 0.f, den1 = 0.f;
    for (int s0 = 0; s0 < Lp; s0 += TILE) {
      float c0[4], c1[4];
      score_block<LDA>(c0, c1, qa, kh, s0, lane);
      const int key = s0 + 2 * (lane & 3);
      den0 += softmax_exp(c0[0], m0, inv_temp, key < L) + softmax_exp(c0[1], m0, inv_temp, key + 1 < L)
            + softmax_exp(c1[0], m0, inv_temp, key + 8 < L) + softmax_exp(c1[1], m0, inv_temp, key + 9 < L);
      den1 += softmax_exp(c0[2], m1, inv_temp, key < L) + softmax_exp(c0[3], m1, inv_temp, key + 1 < L)
            + softmax_exp(c1[2], m1, inv_temp, key + 8 < L) + softmax_exp(c1[3], m1, inv_temp, key + 9 < L);
    }
    den0 = quad_sum(den0);
    den1 = quad_sum(den1);
    float num[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < Lp; s0 += TILE) {
      float c0[4], c1[4];
      score_block<LDA>(c0, c1, qa, kh, s0, lane);
      const int key = s0 + 2 * (lane & 3);
      uint32_t pa[4], vt0, vt1;
      pa[0] = pack2(__fdiv_rn(softmax_exp(c0[0], m0, inv_temp, key < L), den0),
                    __fdiv_rn(softmax_exp(c0[1], m0, inv_temp, key + 1 < L), den0));
      pa[1] = pack2(__fdiv_rn(softmax_exp(c0[2], m1, inv_temp, key < L), den1),
                    __fdiv_rn(softmax_exp(c0[3], m1, inv_temp, key + 1 < L), den1));
      pa[2] = pack2(__fdiv_rn(softmax_exp(c1[0], m0, inv_temp, key + 8 < L), den0),
                    __fdiv_rn(softmax_exp(c1[1], m0, inv_temp, key + 9 < L), den0));
      pa[3] = pack2(__fdiv_rn(softmax_exp(c1[2], m1, inv_temp, key + 8 < L), den1),
                    __fdiv_rn(softmax_exp(c1[3], m1, inv_temp, key + 9 < L), den1));
      load_rows_t<LDA>(vt0, vt1, vh, s0, lane);
      mma_k16(num, pa, vt0, vt1);
    }
    uint32_t* words =
        reinterpret_cast<uint32_t*>(qh) + (q0 + (lane >> 2)) * (LDA / 2) + (lane & 3);
    words[0] = pack2(num[0], num[1]);
    words[8 * (LDA / 2)] = pack2(num[2], num[3]);
  }
}

// Bytes of the stages' sinks: an Lp x 8 f32 buffer per head after the body's
// layout. variants_smem_bytes is the C twin of ops/fft_block_variants.py::
// shared_memory_bytes: change both together.
__host__ __device__ inline size_t sink_bytes(int L) { return (size_t)H * pad_tile(L) * DK * 4; }
inline size_t variants_smem_bytes(int L, bool sink) {
  return slab_smem_bytes(L) + (sink ? sink_bytes(L) : 0);
}

// A partial stage on the body's q, k, v: each warp sinks its head's values
// for the first eight key columns (or ctx) of every query into sink + h·Lp·8;
// then one pass sums the heads in order and tiles the sum along D.
template <int MODE>
__device__ __forceinline__ void stage_mma(const SlabSmem& sm, bf16* ob, float* sink, int L,
                                          int Lp, float inv_temp, float never) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if constexpr (MODE == STAGE_PROJ) {
    // (q + k + v) in bf16: each sum rounded, as two array adds
    for (int i = tid; i < L * D; i += THREADS) {
      const int r = i / D, c = i - r * D, at = r * LDA + c;
      ob[i] = __float2bfloat16_rn(__fadd_rn(
          round_cd<bf16>(__fadd_rn(to_f(sm.q[at]), to_f(sm.k[at]))), to_f(sm.v[at])));
    }
    return;
  } else {
    const bf16* qh = sm.q + warp * DK;
    const bf16* kh = sm.k + warp * DK;
    const bf16* vh = sm.v + warp * DK;
    float* sk = sink + (size_t)warp * Lp * DK;
    const float scale2 = __fmul_rn(inv_temp, EXP_UNIT);
    uint32_t live = 0u;
    for (int q0 = 0; q0 < Lp; q0 += TILE) {
      uint32_t qa[2];
      load_a<LDA>(qa, qh, q0, lane);
      float add[4];  // rows g ([0], [1]) and g + 8, columns c, c + 1
      if constexpr (MODE == STAGE_SCORES) {
        for (int s0 = 0; s0 < Lp; s0 += TILE) {
          float c0[4], c1[4];
          score_block<LDA>(c0, c1, qa, kh, s0, lane);
          if (s0 == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) add[i] = c0[i];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) live ^= __float_as_uint(c0[i]) ^ __float_as_uint(c1[i]);
        }
      } else {
        float m0, m1;
        row_max_tile<LDA>(m0, m1, qa, kh, L, Lp, lane);
        if constexpr (MODE == STAGE_MAX) {
          float c0[4], c1[4];
          score_block<LDA>(c0, c1, qa, kh, 0, lane);
          add[0] = __fadd_rn(c0[0], m0);
          add[1] = __fadd_rn(c0[1], m0);
          add[2] = __fadd_rn(c0[2], m1);
          add[3] = __fadd_rn(c0[3], m1);
        } else if constexpr (MODE == STAGE_EXP) {
          for (int s0 = 0; s0 < Lp; s0 += TILE) {
            uint32_t e[4];
            exp_block_rows<LDA, true>(e, qa, kh, s0, L, lane, scale2, m0, m1);
            if (s0 == 0) {
              add[0] = lo_f(e[0]);
              add[1] = hi_f(e[0]);
              add[2] = lo_f(e[1]);
              add[3] = hi_f(e[1]);
            }
            live ^= e[0] ^ e[1] ^ e[2] ^ e[3];
          }
        } else {
          static_assert(MODE == STAGE_CTX || MODE == STAGE_DEN, "a partial stage");
          float num[4], den[4];
          attend_tile<LDA, true, MODE == STAGE_CTX ? CUT_NODEN : CUT_NONE>(
              num, den, qa, kh, vh, L, Lp, lane, scale2, m0, m1);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            add[i] = MODE == STAGE_CTX ? num[i] : round_cd<bf16>(__fdiv_rn(num[i], den[i & 2]));
        }
      }
      const int r = q0 + (lane >> 2), c = 2 * (lane & 3);
      *reinterpret_cast<float2*>(sk + r * DK + c) = make_float2(add[0], add[1]);
      *reinterpret_cast<float2*>(sk + (r + 8) * DK + c) = make_float2(add[2], add[3]);
    }
    if (__uint_as_float(live) == never) sk[lane] = never;
    __syncthreads();
    for (int i = tid; i < L * DK; i += THREADS) {
      float acc = 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) acc = __fadd_rn(acc, sink[(size_t)h * Lp * DK + i]);
      const bf16 v = __float2bfloat16_rn(acc);
      const int r = i / DK, c = i - r * DK;
#pragma unroll
      for (int h = 0; h < H; ++h) ob[r * D + h * DK + c] = v;
    }
  }
}

// Variant a (the body with its own attention) and the stages (the body's
// projections, then the sinks and no tail) on the tensor-core body.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
variant_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                   const BlockWeights<bf16> w, const int L, const float inv_temp,
                   const float never) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)blockIdx.x * L * D;
  bf16* ob = out + base;
  if constexpr (MODE == MODE_A) {
    block_rows_mma<false, false, false, CUT_ATTEND>(
        x + base, D, nullptr, nullptr, w, RowStores{}, L, inv_temp, smem, store_output(ob, w),
        [&](const SlabSmem& sm, int L, int Lp) { attend_heads_a(sm, L, Lp, inv_temp); });
  } else {
    float* sink = reinterpret_cast<float*>(smem + slab_smem_bytes(L));
    block_rows_mma<false, false, false, CUT_STAGE>(
        x + base, D, nullptr, nullptr, w, RowStores{}, L, inv_temp, smem, store_output(ob, w),
        [&](const SlabSmem& sm, int L, int Lp) {
          stage_mma<MODE>(sm, ob, sink, L, Lp, inv_temp, never);
        });
  }
}

template <bool EXACT, int CUT>
int launch_ablate_mma(const void* x, void* out, void* const* p, int B, int L, float inv_temp,
                      cudaStream_t stream) {
  static SharedMemoryOptIn opted;
  size_t limit = 0;
  cudaError_t err = opt_in_shared_memory(ablate_mma_kernel<EXACT, CUT>, opted, &limit);
  if (err != cudaSuccess) return (int)err;
  ablate_mma_kernel<EXACT, CUT><<<B, THREADS, slab_smem_bytes(L), stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), block_weights<bf16>(p), L,
      inv_temp);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_variant_mma(const void* x, void* out, void* const* p, int B, int L, float inv_temp,
                       cudaStream_t stream) {
  static SharedMemoryOptIn opted;
  size_t limit = 0;
  cudaError_t err = opt_in_shared_memory(variant_mma_kernel<MODE>, opted, &limit);
  if (err != cudaSuccess) return (int)err;
  variant_mma_kernel<MODE><<<B, THREADS, variants_smem_bytes(L, MODE > STAGE_PROJ), stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), block_weights<bf16>(p), L, inv_temp,
      nanf(""));
  return (int)cudaGetLastError();
}

// bf16 a, b, c, d and the stages on the tensor cores: b and c launch the
// block's exact form, d the Cauchy–Schwarz form with den + 1e-30.
int launch_mode_mma(int mode, const void* x, void* out, void* const* p, int B, int L,
                    float inv_temp, cudaStream_t s) {
  switch (mode) {
    case MODE_A: return launch_variant_mma<MODE_A>(x, out, p, B, L, inv_temp, s);
    case MODE_B:
    case MODE_C: return launch_ablate_mma<true, CUT_NONE>(x, out, p, B, L, inv_temp, s);
    case MODE_D: return launch_ablate_mma<false, CUT_DEN_PLUS>(x, out, p, B, L, inv_temp, s);
    case STAGE_PROJ: return launch_variant_mma<STAGE_PROJ>(x, out, p, B, L, inv_temp, s);
    case STAGE_SCORES: return launch_variant_mma<STAGE_SCORES>(x, out, p, B, L, inv_temp, s);
    case STAGE_MAX: return launch_variant_mma<STAGE_MAX>(x, out, p, B, L, inv_temp, s);
    case STAGE_EXP: return launch_variant_mma<STAGE_EXP>(x, out, p, B, L, inv_temp, s);
    case STAGE_CTX: return launch_variant_mma<STAGE_CTX>(x, out, p, B, L, inv_temp, s);
    case STAGE_DEN: return launch_variant_mma<STAGE_DEN>(x, out, p, B, L, inv_temp, s);
  }
  return (int)cudaErrorInvalidValue;
}

int launch(int mode, const void* x, void* out, void* const* p, int B, int L, int dtype,
           float inv_temp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the sinks read eight key columns
  if (mode > STAGE_PROJ && L < DK) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_mode_mma(mode, x, out, p, B, L, inv_temp, s);
  if (dtype == 1) return launch_any<float>(mode, x, out, p, B, L, inv_temp, s);
  return (int)cudaErrorInvalidValue;
}

// ---- the cuts in f32, on the CUDA cores (fft_block_body.cuh) -------------------

__host__ __device__ constexpr bool is_attention_cut(int cut) {
  return cut >= CUT_NOSHIFT && cut <= CUT_NODEN;
}

// One (head, query) item of the Cauchy–Schwarz attention with one of the cuts
// of the attention: attend_query's loop with the cut. bk, bv: the head's
// slices of the biases, the key and value of the TPU kernel's zero padding
// rows, which CUT_NOMASK counts up to pad8(L). zero_scores: CUT_THIN16 on
// heads 2..7.
template <int CUT>
__device__ __forceinline__ void attend_query_cut(const float q[DK], const float* kh,
                                                 const float* vh, int L, float inv_temp,
                                                 float shift, bool zero_scores, const float* bk,
                                                 const float* bv, float num[DK], float& den) {
  const int keys = CUT == CUT_NOMASK ? (L + 7) / 8 * 8 : L;
#pragma unroll
  for (int c = 0; c < DK; ++c) num[c] = 0.f;
  den = 0.f;
  for (int s = 0; s < keys; ++s) {
    float kv[DK], vv[DK];
    if (s < L) {
      load8(kh + s * D, kv);
      load8(vh + s * D, vv);
    } else {
#pragma unroll
      for (int c = 0; c < DK; ++c) {
        kv[c] = bk[c];
        vv[c] = bv[c];
      }
    }
    const float sc = (CUT == CUT_THIN16 && zero_scores) ? 0.f : dot8(q, kv);
    // (bf16exp: its argument rounded to f32, the identity)
    const float e = CUT == CUT_NOEXP ? __fsub_rn(__fmul_rn(sc, inv_temp), shift)
                                     : cs_exp<float>(sc, shift, inv_temp);
    den = __fadd_rn(den, e);
#pragma unroll
    for (int c = 0; c < DK; ++c) num[c] = fmaf(e, vv[c], num[c]);
  }
  if constexpr (CUT != CUT_NODEN) den = fmaxf(den, DEN_MIN);
}

// The f32 block with a cut: fft_block_body with the cut's attention (one of
// the cuts of the attention; `exact` is then 0), no attention (CUT_NOATTN), or
// block_tail stopping after LN1 (CUT_NOFFN). CUT_NONE is the block.
template <int CUT>
__global__ void __launch_bounds__(THREADS)
ablate_cuda_core_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const BlockWeights<float> w, const int L, const float inv_temp,
                        const int exact) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockSmem<float> s = carve_smem<float>(smem, L);
  const float* xb = x + (size_t)blockIdx.x * L * D;
  float* ob = out + (size_t)blockIdx.x * L * D;
  project_qkv(xb, w, L, s.q, s.k, s.v);
  __syncthreads();
  if constexpr (CUT != CUT_NOATTN) {
    if (!exact && CUT != CUT_NOSHIFT) max_key_norms(s.k, L, s.kn);
    __syncthreads();
    for (int it = threadIdx.x; it < H * L; it += THREADS) {
      const int h = it / L;
      const int t = it - h * L;
      float q[DK], num[DK], den;
      load8(s.q + t * D + h * DK, q);
      if constexpr (is_attention_cut(CUT)) {
        const float shift = CUT == CUT_NOSHIFT ? 0.f : cs_shift(q, s.kn[h], inv_temp);
        attend_query_cut<CUT>(q, s.k + h * DK, s.v + h * DK, L, inv_temp, shift, h >= 2,
                              w.bk + h * DK, w.bv + h * DK, num, den);
      } else {
        const float shift = exact ? 0.f : cs_shift(q, s.kn[h], inv_temp);
        attend_query<float, D>(q, s.k + h * DK, s.v + h * DK, L, inv_temp, exact != 0, shift,
                               num, den);
      }
#pragma unroll
      for (int c = 0; c < DK; ++c)
        s.q[t * D + h * DK + c] = CUT == CUT_NODEN ? num[c] : __fdiv_rn(num[c], den);
    }
    __syncthreads();
  }
  block_tail<float, CUT != CUT_NOFFN>(xb, ob, w, L, s.q, s.hid);
}

template <int CUT>
int launch_ablate_f32(const void* x, void* out, void* const* p, int B, int L, float inv_temp,
                      int exact, cudaStream_t stream) {
  static SharedMemoryOptIn opted;
  size_t limit = 0;
  cudaError_t err = opt_in_shared_memory(ablate_cuda_core_kernel<CUT>, opted, &limit);
  if (err != cudaSuccess) return (int)err;
  ablate_cuda_core_kernel<CUT><<<B, THREADS, block_smem_bytes<float>(L), stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), block_weights<float>(p), L,
      inv_temp, exact);
  return (int)cudaGetLastError();
}

// cut: CUT_NOSHIFT .. CUT_NOFFN, the order of ops/fft_block_variants.py's
// ABLATIONS. In the exact form the cuts of the attention launch the uncut
// block, as the TPU kernel's head loop ignores them.
template <int CUT = CUT_NOSHIFT>
int launch_ablate(int cut, bool exact, int dtype, const void* x, void* out, void* const* p,
                  int B, int L, float inv_temp, cudaStream_t s) {
  if constexpr (CUT > CUT_NOFFN) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (cut != CUT) return launch_ablate<CUT + 1>(cut, exact, dtype, x, out, p, B, L, inv_temp, s);
    if (dtype == 1) {
      if (exact && is_attention_cut(CUT))
        return launch_ablate_f32<CUT_NONE>(x, out, p, B, L, inv_temp, 1, s);
      return launch_ablate_f32<CUT>(x, out, p, B, L, inv_temp, exact ? 1 : 0, s);
    }
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    if constexpr (CUT == CUT_NOATTN) {  // no attention, so no softmax form
      return launch_ablate_mma<false, CUT_NOATTN>(x, out, p, B, L, inv_temp, s);
    } else if constexpr (CUT == CUT_NOFFN) {
      return exact ? launch_ablate_mma<true, CUT_NOFFN>(x, out, p, B, L, inv_temp, s)
                   : launch_ablate_mma<false, CUT_NOFFN>(x, out, p, B, L, inv_temp, s);
    } else {
      return exact ? launch_ablate_mma<true, CUT_NONE>(x, out, p, B, L, inv_temp, s)
                   : launch_ablate_mma<false, CUT>(x, out, p, B, L, inv_temp, s);
    }
  }
}

}  // namespace

// All four: x, out (B, L, 64) contiguous, bf16 (dtype 0) or f32 (dtype 1);
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

// option: 2·cut + exact, cut 1..8 in the order noshift, thin16, noexp, bf16exp,
// nomask, noden, noattn, noffn; exact as s2s_fft_block's.
extern "C" int s2s_fft_block_ablate(const void* x, void* out, void* const* weights, int B,
                                    int L, int dtype, float inv_temp, int option, void* stream) {
  return launch_ablate(option >> 1, (option & 1) != 0, dtype, x, out, weights, B, L, inv_temp,
                       static_cast<cudaStream_t>(stream));
}
