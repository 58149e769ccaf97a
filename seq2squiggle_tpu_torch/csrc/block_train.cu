// Whole-FFT-block training kernels for Hopper (sm_90a), forward and backward:
// the port of the Pallas kernel pair behind
// seq2squiggle_tpu/ops/pallas/block_train.py::fused_block_train
// (_block_fwd_call / _fwd_kernel, _block_bwd_call / _bwd_kernel).
//
//   forward   q/k/v = cast(x W + b); ctx = packed attention with the
//             Cauchy–Schwarz shift; o = (ctx Wf + bf)·s_a; h1 = LN1(o + x)
//             (f32); f1 = cast(relu(cast(h1) W1 + b1)); f2 = (f1 W2 + b2)·s_f;
//             out = cast(LN2(f2 + h1)).
//   backward  saves nothing: recomputes the above from (x, weights, s_a, s_f),
//             then walks back in f32 through LN2, the FFN (relu mask pre > 0),
//             LN1, fc, the attention core and the projections. Outputs gx and
//             the 16 weight gradients summed over all B·L positions. Matrix
//             gradients multiply operands rounded to the compute dtype (gf2c,
//             gf1c, goc, gpc); bias and LayerNorm gradients sum f32 values.
//
// x, s_a, s_f, g, out, gx are (B, L, 64) in the compute dtype T (bf16 or f32);
// s_a and s_f are dropout scales (0 or 1/keep) or null. The 16 weights are the
// f32 masters: a first pass rounds the six matrices to T once per call (and,
// for the f32 backward, also writes their transposes, so that every product of
// the CUDA-core kernels reads its weights along the lanes).
//
// Bound: operations (20.7 GFLOP forward, about 62 backward at B = 512,
// L = 250, against four or five tensors of 16 MB).
//
// bf16 runs on the tensor cores (`mma.sync` through row_mma.cuh; the kernels
// *_mma_kernel below, described where they start): a warp owns a 16-row slab
// of positions, every thread block stages its weights in shared memory once,
// the 256-wide hidden layer stays in registers, and the in-block attention is
// the attention core's sweep. Measured at (512, 250, 64) with dropout scales on
// an NVIDIA H100 80GB HBM3 at 700 W (scripts/profile_torch_block_train.py,
// launches back to back): forward 0.25 ms, backward 1.20 ms (rows 0.62, the
// attention-core backward 0.35, wgrad 0.11, input 0.09), where the f32 path's
// design below, built for bf16, takes 2.29 and 10.66 ms. PERF.md (section 6,
// B3) has the rest. f32 has no tensor-core form with TF32 off and keeps the
// CUDA-core kernels:
//
// Forward: one thread block per batch row, as fft_block.cu: q, k, v in shared
// memory, scores recomputed per query and never stored, then fc + LN1 + FFN +
// LN2 one row per warp.
//
// Backward: the live set of one batch row (x, q, k, v, ctx, both LayerNorms'
// statistics, the 256-wide hidden layer and all their gradients) does not fit
// in 227 KB of shared memory, and the weight gradients contract over every
// position of the batch while thread blocks run concurrently. Only attention
// couples positions, so the call is six launches over a device-memory
// workspace (what each stage leaves for a later one is listed at `Workspace`;
// both types):
//   1. round_weights_kernel    W (and, f32, Wᵀ) in T
//   2. bwd_rows_kernel         block per batch row: recompute q, k, v, ctx as
//                              the forward does, then per row (one per warp;
//                              bf16: per 16-row slab) the rest of the forward
//                              and the walk back to gctx; per-block sums of
//                              the seven vector gradients it sees, warps
//                              added in order
//   3. attn_core.cu's backward per (batch row, head): gq, gk, gv as f32
//   4. bwd_input_kernel        gx = gz1 + Σ gpc Wᵀ per row; sums of gq, gk, gv
//   5. wgrad_kernel            the six Aᵀ·G products as twelve 64 x 64 tiles,
//                              each over NPART fixed contiguous ranges of
//                              positions, rows in order
//   6. reduce_partials_kernel  partial sums added in index order
// No atomics: every sum has a fixed order that depends on (B, L) alone, not
// on the card, so two runs give the same bits. The workspace costs about
// 1216 T + 256 f32 values per position, written once and read once.
// Ragged L and B need no padding in f32: every loop is bounded by L.
//
// C interface (loaded with ctypes by ops/_build.py): each entry point returns
// the first launch error of its stages (cudaGetLastError() after each).

#include "row_mma.cuh"

#include <type_traits>

// Two compile-time switches, both 0 as the package builds this file;
// scripts/profile_torch_block_train.py builds it with each set to 1 and times
// the results beside the package's build, in one call on one card:
//   S2S_BLOCK_TRAIN_CUDA_CORES       bf16 takes the f32 path's kernels (one
//                                    warp per position on the CUDA cores,
//                                    weights streamed from L1/L2 per position)
//   S2S_BLOCK_TRAIN_ATTN_CUDA_CORES  the tensor-core bf16 kernels keep the
//                                    in-block attention on the CUDA cores
//                                    (one thread per (head, query))
#ifndef S2S_BLOCK_TRAIN_CUDA_CORES
#define S2S_BLOCK_TRAIN_CUDA_CORES 0
#endif
#ifndef S2S_BLOCK_TRAIN_ATTN_CUDA_CORES
#define S2S_BLOCK_TRAIN_ATTN_CUDA_CORES 0
#endif

namespace {

using namespace s2s;

constexpr int DFF = 256;  // FFN width
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float LN_EPS = 1e-5f;
constexpr int NPART = 64;  // partial sums per matrix-gradient entry

static_assert(WARPS == H, "the k-norm reduction uses one warp per head");

// Flat layout of the six matrices (rounded weights, partial sums, gradients).
constexpr int N_MAT = 4 * D * D + 2 * D * DFF;
constexpr int M_WQ = 0, M_WK = D * D, M_WV = 2 * D * D, M_WF = 3 * D * D, M_W1 = 4 * D * D,
              M_W2 = 4 * D * D + D * DFF;
// ... and of the ten vectors, after the matrices in the gradient buffer.
constexpr int N_VEC = 9 * D + DFF;
constexpr int V_BQ = 0, V_BK = D, V_BV = 2 * D, V_BF = 3 * D, V_LN1S = 4 * D, V_LN1B = 5 * D,
              V_B1 = 6 * D, V_B2 = 6 * D + DFF, V_LN2S = 7 * D + DFF, V_LN2B = 8 * D + DFF;
constexpr int N_ROW_VECS = N_VEC - V_BF;  // the vectors bwd_rows_kernel sums

#define S2S_CHECK_LAUNCH()                        \
  do {                                            \
    const cudaError_t e_ = cudaGetLastError();    \
    if (e_ != cudaSuccess) return (int)e_;        \
  } while (0)

struct Masters {  // the f32 master weights, in the Pallas kernel's order
  const float* p[16];
};

template <typename T>
struct Params {
  const T *wq, *wk, *wv, *wf, *w1, *w2;        // rounded, (in, out) row-major
  const T *wqT, *wkT, *wvT, *wfT, *w1T, *w2T;  // their transposes (backward only)
  const float *bq, *bk, *bv, *bf, *ln1s, *ln1b, *b1, *b2, *ln2s, *ln2b;
};

template <typename T>
Params<T> make_params(const Masters& m, const T* wc) {
  const T* t = wc + N_MAT;
  return Params<T>{wc + M_WQ, wc + M_WK, wc + M_WV, wc + M_WF, wc + M_W1, wc + M_W2,
                   t + M_WQ,  t + M_WK,  t + M_WV,  t + M_WF,  t + M_W1,  t + M_W2,
                   m.p[1],    m.p[3],    m.p[5],    m.p[7],    m.p[8],    m.p[9],
                   m.p[11],   m.p[13],   m.p[14],   m.p[15]};
}

// What the backward's stages hand to each other, per position (N = B·L rows).
template <typename T>
struct Workspace {
  T *q, *k, *v, *ctx, *h1c, *gf2c, *goc, *gctx, *gqc, *gkc, *gvc;  // N x 64
  T *f1, *gf1c;                                                    // N x 256
  float *gz1, *gq, *gk, *gv;                                       // N x 64
  float* part_m;  // NPART x N_MAT partial matrix gradients
  float* part_v;  // B x N_VEC per-batch-row vector gradients
};
constexpr long long WS_T_PER_ROW = 11 * D + 2 * DFF;
constexpr long long WS_F_PER_ROW = 4 * D;

template <typename T>
Workspace<T> make_workspace(T* t, float* f, long long n) {
  Workspace<T> w;
  T** narrow[] = {&w.q, &w.k, &w.v, &w.ctx, &w.h1c, &w.gf2c, &w.goc, &w.gctx,
                  &w.gqc, &w.gkc, &w.gvc};
  for (T** p : narrow) { *p = t; t += n * D; }
  w.f1 = t;
  w.gf1c = t + n * DFF;
  float** wide[] = {&w.gz1, &w.gq, &w.gk, &w.gv};
  for (float** p : wide) { *p = f; f += n * D; }
  w.part_m = f;
  w.part_v = f + (long long)NPART * N_MAT;
  return w;
}

// ---- stage: the six matrices rounded to T, and transposed -------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
round_weights_kernel(const Masters m, T* __restrict__ wc, const bool transposes) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= N_MAT) return;
  int field, off, rows = D, cols = D;  // Wq, Wk, Wv, Wf: masters 0, 2, 4, 6
  if (idx < M_W1) { field = 2 * (idx / (D * D)); off = idx / (D * D) * D * D; }
  else if (idx < M_W2) { field = 10; off = M_W1; cols = DFF; }
  else { field = 12; off = M_W2; rows = DFF; }
  const int e = idx - off;
  const T val = from_f<T>(m.p[field][e]);
  wc[idx] = val;
  if (transposes) wc[N_MAT + off + (e % cols) * rows + e / cols] = val;
}

// ---- pieces of one batch row's forward, shared by both directions -----------

// q, k, v = cast(x W + b) into shared memory (and device memory where gq is
// given): column j, rows tr, tr + 4, tr + 8, tr + 12 of each 16-row slab.
template <typename T>
__device__ __forceinline__ void project_qkv(const T* __restrict__ xb, const Params<T>& w,
                                            T* sQ, T* sK, T* sV, T* gq, T* gk, T* gv,
                                            const int L, const int tid) {
  const int j = tid & (D - 1);
  const int tr = tid >> 6;
  const float bq = w.bq[j], bk = w.bk[j], bv = w.bv[j];
  for (int t0 = 0; t0 < L; t0 += 16) {
    float aq[4] = {0.f, 0.f, 0.f, 0.f}, ak[4] = {0.f, 0.f, 0.f, 0.f},
          av[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < D; ++i) {
      const float wq = to_f(w.wq[i * D + j]);
      const float wk = to_f(w.wk[i * D + j]);
      const float wv = to_f(w.wv[i * D + j]);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int t = t0 + tr + 4 * m;
        if (t < L) {
          const float xv = to_f(xb[t * D + i]);
          aq[m] = fmaf(xv, wq, aq[m]);
          ak[m] = fmaf(xv, wk, ak[m]);
          av[m] = fmaf(xv, wv, av[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int t = t0 + tr + 4 * m;
      if (t < L) {
        const T q = from_f<T>(__fadd_rn(aq[m], bq));
        const T k = from_f<T>(__fadd_rn(ak[m], bk));
        const T v = from_f<T>(__fadd_rn(av[m], bv));
        sQ[t * D + j] = q;
        sK[t * D + j] = k;
        sV[t * D + j] = v;
        if (gq != nullptr) {
          gq[t * D + j] = q;
          gk[t * D + j] = k;
          gv[t * D + j] = v;
        }
      }
    }
  }
}

// ctx = softmax(q kᵀ/√d_k) v with the Cauchy–Schwarz shift, one (head, query)
// item per thread; ctx overwrites q in shared memory (q[t, h] is read only by
// its own item) and goes to device memory too where gctx is given.
// S: the values between two rows in shared memory.
template <typename T, int S = D>
__device__ __forceinline__ void attend_row(T* sQ, const T* sK, const T* sV, float* sKn,
                                           T* gctx, const int L, const float inv_temp,
                                           const int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const float kn = warp_max_knorm<T, S>(sK + warp * DK, L, lane);
  if (lane == 0) sKn[warp] = kn;
  __syncthreads();
  for (int it = tid; it < H * L; it += THREADS) {
    const int h = it / L;
    const int t = it - h * L;
    float q[DK], num[DK], den, ctx[DK];
    load8(sQ + t * S + h * DK, q);
    attend_query<T, S>(q, sK + h * DK, sV + h * DK, L, inv_temp, false,
                       cs_shift(q, sKn[h], inv_temp), num, den);
#pragma unroll
    for (int c = 0; c < DK; ++c) ctx[c] = __fdiv_rn(num[c], den);
    store8(sQ + t * S + h * DK, ctx);
    if (gctx != nullptr) store8(gctx + t * D + h * DK, ctx);
  }
  __syncthreads();
}

// LayerNorm statistics of the 64 values held two per lane (columns lane and
// lane + 32): zhat and 1/sigma.
__device__ __forceinline__ void ln_stats(const float v0, const float v1, float zh[2],
                                         float& inv) {
  const float mean = __fdiv_rn(warp_sum(__fadd_rn(v0, v1)), (float)D);
  const float d0 = __fsub_rn(v0, mean), d1 = __fsub_rn(v1, mean);
  const float var =
      __fdiv_rn(warp_sum(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1))), (float)D);
  inv = rsqrtf(__fadd_rn(var, LN_EPS));
  zh[0] = __fmul_rn(d0, inv);
  zh[1] = __fmul_rn(d1, inv);
}

// Backward of y = zhat·scale + bias for the row's two columns per lane.
__device__ __forceinline__ void ln_backward(const float gy[2], const float zh[2],
                                            const float inv, const float* scale,
                                            const int lane, float gz[2]) {
  const float a0 = gy[0] * scale[lane], a1 = gy[1] * scale[lane + 32];
  const float m1 = warp_sum(a0 + a1) / (float)D;
  const float m2 = warp_sum(a0 * zh[0] + a1 * zh[1]) / (float)D;
  gz[0] = (a0 - m1 - zh[0] * m2) * inv;
  gz[1] = (a1 - m1 - zh[1] * m2) * inv;
}

// One position's forward after attention, by one warp: lane holds columns
// lane and lane + 32 of the 64-wide rows and hidden units lane + 32 m.
struct RowState {
  float zh1[2], inv1, h1[2];  // LN1: zhat, 1/sigma, output (f32)
  float pre[8];               // f32 pre-activations of the FFN's hidden layer
  float zh2[2], inv2;         // LN2
};

// ctx_row: shared memory. x_row, sa_row, sf_row: device memory (the scales may
// be null). buf64, buf256: this warp's scratch rows; on return buf64 holds
// cast(h1) and buf256 holds f1. h1c_out, f1_out: device rows to keep them in,
// or null.
template <typename T>
__device__ __forceinline__ void row_forward(const Params<T>& w, const T* ctx_row,
                                            const T* __restrict__ x_row,
                                            const T* __restrict__ sa_row,
                                            const T* __restrict__ sf_row, T* buf64,
                                            T* buf256, T* h1c_out, T* f1_out,
                                            const int lane, RowState& r) {
  float o0 = 0.f, o1 = 0.f;
  for (int c = 0; c < D; ++c) {
    const float cv = to_f(ctx_row[c]);
    o0 = fmaf(cv, to_f(w.wf[c * D + lane]), o0);
    o1 = fmaf(cv, to_f(w.wf[c * D + lane + 32]), o1);
  }
  o0 = __fadd_rn(o0, w.bf[lane]);
  o1 = __fadd_rn(o1, w.bf[lane + 32]);
  if (sa_row != nullptr) {
    o0 = __fmul_rn(o0, to_f(sa_row[lane]));
    o1 = __fmul_rn(o1, to_f(sa_row[lane + 32]));
  }
  ln_stats(__fadd_rn(o0, to_f(x_row[lane])), __fadd_rn(o1, to_f(x_row[lane + 32])), r.zh1,
           r.inv1);
  r.h1[0] = __fadd_rn(__fmul_rn(r.zh1[0], w.ln1s[lane]), w.ln1b[lane]);
  r.h1[1] = __fadd_rn(__fmul_rn(r.zh1[1], w.ln1s[lane + 32]), w.ln1b[lane + 32]);
  __syncwarp();  // the previous row's readers of the scratch rows are done
  buf64[lane] = from_f<T>(r.h1[0]);
  buf64[lane + 32] = from_f<T>(r.h1[1]);
  if (h1c_out != nullptr) {
    h1c_out[lane] = buf64[lane];
    h1c_out[lane + 32] = buf64[lane + 32];
  }
  __syncwarp();

#pragma unroll
  for (int m = 0; m < 8; ++m) r.pre[m] = 0.f;
  for (int j = 0; j < D; ++j) {
    const float hv = to_f(buf64[j]);
#pragma unroll
    for (int m = 0; m < 8; ++m) r.pre[m] = fmaf(hv, to_f(w.w1[j * DFF + lane + 32 * m]), r.pre[m]);
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    r.pre[m] = __fadd_rn(r.pre[m], w.b1[lane + 32 * m]);
    const T f = from_f<T>(fmaxf(r.pre[m], 0.f));
    buf256[lane + 32 * m] = f;
    if (f1_out != nullptr) f1_out[lane + 32 * m] = f;
  }
  __syncwarp();

  float f0 = 0.f, f1 = 0.f;
  for (int n = 0; n < DFF; ++n) {
    const float hv = to_f(buf256[n]);
    f0 = fmaf(hv, to_f(w.w2[n * D + lane]), f0);
    f1 = fmaf(hv, to_f(w.w2[n * D + lane + 32]), f1);
  }
  f0 = __fadd_rn(f0, w.b2[lane]);
  f1 = __fadd_rn(f1, w.b2[lane + 32]);
  if (sf_row != nullptr) {
    f0 = __fmul_rn(f0, to_f(sf_row[lane]));
    f1 = __fmul_rn(f1, to_f(sf_row[lane + 32]));
  }
  ln_stats(__fadd_rn(f0, r.h1[0]), __fadd_rn(f1, r.h1[1]), r.zh2, r.inv2);
}

// Shared memory of the two per-batch-row kernels: q (then ctx), k, v, then
// per warp a 64-wide and a 256-wide scratch row (and a second 64-wide one for
// the backward), then floats: max‖k‖ per head and the block's vector sums.
// ops/block_train.py::shared_memory_bytes is the Python twin, checked by the
// wrapper before a launch: change both together.
template <typename T>
size_t row_kernel_smem(int L, bool backward) {
  return (3 * (size_t)L * D + WARPS * (size_t)(D + DFF + (backward ? D : 0))) * sizeof(T) +
         (H + (backward ? N_ROW_VECS : 0)) * sizeof(float);
}

// ---- forward ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_train_fwd_kernel(const T* __restrict__ x, const T* __restrict__ s_a,
                       const T* __restrict__ s_f, T* __restrict__ out, const Params<T> w,
                       const int L, const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + (size_t)L * D;
  T* sV = sK + (size_t)L * D;
  T* sBuf = sV + (size_t)L * D;
  float* sKn = reinterpret_cast<float*>(sBuf + WARPS * (D + DFF));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * L * D;
  project_qkv<T>(x + base, w, sQ, sK, sV, nullptr, nullptr, nullptr, L, tid);
  __syncthreads();
  attend_row<T>(sQ, sK, sV, sKn, nullptr, L, inv_temp, tid);

  T* buf64 = sBuf + warp * (D + DFF);
  T* buf256 = buf64 + D;
  for (int t = warp; t < L; t += WARPS) {
    const size_t row = base + (size_t)t * D;
    RowState r;
    row_forward<T>(w, sQ + t * D, x + row, s_a ? s_a + row : nullptr,
                   s_f ? s_f + row : nullptr, buf64, buf256, nullptr, nullptr, lane, r);
    out[row + lane] = from_f<T>(__fadd_rn(__fmul_rn(r.zh2[0], w.ln2s[lane]), w.ln2b[lane]));
    out[row + lane + 32] =
        from_f<T>(__fadd_rn(__fmul_rn(r.zh2[1], w.ln2s[lane + 32]), w.ln2b[lane + 32]));
  }
}

// ---- backward, stage 2: recompute, and walk back to gctx, per row ----------

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ s_a, const T* __restrict__ s_f,
                const T* __restrict__ g, const Params<T> w, const Workspace<T> ws, const int L,
                const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + (size_t)L * D;
  T* sV = sK + (size_t)L * D;
  T* sBuf = sV + (size_t)L * D;
  float* sKn = reinterpret_cast<float*>(sBuf + WARPS * (2 * D + DFF));
  float* sVec = sKn + H;  // N_ROW_VECS sums, from V_BF on

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * L * D;
  project_qkv<T>(x + base, w, sQ, sK, sV, ws.q + base, ws.k + base, ws.v + base, L, tid);
  __syncthreads();
  attend_row<T>(sQ, sK, sV, sKn, ws.ctx + base, L, inv_temp, tid);

  T* buf64 = sBuf + warp * (2 * D + DFF);
  T* buf256 = buf64 + D;
  T* bufg = buf256 + DFF;  // the row's rounded gradient entering a product
  // this warp's share of the vector gradients: two columns of each 64-wide
  // one (in the order of ROW_VECS), eight hidden units of b1
  enum { A_BF, A_LN1S, A_LN1B, A_B2, A_LN2S, A_LN2B, N_ACC };
  constexpr int ROW_VECS[N_ACC] = {V_BF, V_LN1S, V_LN1B, V_B2, V_LN2S, V_LN2B};
  float acc[N_ACC][2] = {};
  float a_b1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int t = warp; t < L; t += WARPS) {
    const size_t row = base + (size_t)t * D;
    const size_t wide = ((size_t)blockIdx.x * L + t) * DFF;
    const T* sa_row = s_a ? s_a + row : nullptr;
    const T* sf_row = s_f ? s_f + row : nullptr;
    RowState r;
    row_forward<T>(w, sQ + t * D, x + row, sa_row, sf_row, buf64, buf256, ws.h1c + row,
                   ws.f1 + wide, lane, r);

    // LN2, the second dropout, the bias b2
    const float gy[2] = {to_f(g[row + lane]), to_f(g[row + lane + 32])};
    float gz2[2], gf2[2];
    ln_backward(gy, r.zh2, r.inv2, w.ln2s, lane, gz2);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      acc[A_LN2S][c] += gy[c] * r.zh2[c];
      acc[A_LN2B][c] += gy[c];
      gf2[c] = sf_row ? gz2[c] * to_f(sf_row[lane + 32 * c]) : gz2[c];
      acc[A_B2][c] += gf2[c];
      const T gc = from_f<T>(gf2[c]);
      bufg[lane + 32 * c] = gc;
      ws.gf2c[row + lane + 32 * c] = gc;
    }
    __syncwarp();

    // gf1 = gf2c W2ᵀ under the relu mask; its cast replaces f1 in buf256
    float gf1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < D; ++c) {
      const float gv = to_f(bufg[c]);
#pragma unroll
      for (int m = 0; m < 8; ++m) gf1[m] = fmaf(gv, to_f(w.w2T[c * DFF + lane + 32 * m]), gf1[m]);
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      gf1[m] = r.pre[m] > 0.f ? gf1[m] : 0.f;
      a_b1[m] += gf1[m];
      const T gc = from_f<T>(gf1[m]);
      buf256[lane + 32 * m] = gc;  // f1 was last read before LN2's warp sums
      ws.gf1c[wide + lane + 32 * m] = gc;
    }
    __syncwarp();

    // gh1 = gz2 + gf1c W1ᵀ, then LN1 and the first dropout
    float d0 = 0.f, d1 = 0.f;
    for (int n = 0; n < DFF; ++n) {
      const float gv = to_f(buf256[n]);
      d0 = fmaf(gv, to_f(w.w1T[n * D + lane]), d0);
      d1 = fmaf(gv, to_f(w.w1T[n * D + lane + 32]), d1);
    }
    const float gh1[2] = {gz2[0] + d0, gz2[1] + d1};
    float gz1[2];
    ln_backward(gh1, r.zh1, r.inv1, w.ln1s, lane, gz1);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      acc[A_LN1S][c] += gh1[c] * r.zh1[c];
      acc[A_LN1B][c] += gh1[c];
      ws.gz1[row + lane + 32 * c] = gz1[c];
      const float go = sa_row ? gz1[c] * to_f(sa_row[lane + 32 * c]) : gz1[c];
      acc[A_BF][c] += go;
      const T gc = from_f<T>(go);
      bufg[lane + 32 * c] = gc;  // gf2c was last read before LN1's warp sums
      ws.goc[row + lane + 32 * c] = gc;
    }
    __syncwarp();

    // gctx = cast(goc Wfᵀ)
    d0 = 0.f;
    d1 = 0.f;
    for (int c = 0; c < D; ++c) {
      const float gv = to_f(bufg[c]);
      d0 = fmaf(gv, to_f(w.wfT[c * D + lane]), d0);
      d1 = fmaf(gv, to_f(w.wfT[c * D + lane + 32]), d1);
    }
    ws.gctx[row + lane] = from_f<T>(d0);
    ws.gctx[row + lane + 32] = from_f<T>(d1);
  }

  // the block's sums: warp 0's, then warp 1's added, ... (a fixed order)
  for (int wi = 0; wi < WARPS; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int v = 0; v < N_ACC; ++v)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* s = sVec + ROW_VECS[v] - V_BF + lane + 32 * c;
          *s = wi == 0 ? acc[v][c] : __fadd_rn(*s, acc[v][c]);
        }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float* s = sVec + V_B1 - V_BF + lane + 32 * m;
        *s = wi == 0 ? a_b1[m] : __fadd_rn(*s, a_b1[m]);
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < N_ROW_VECS; i += THREADS)
    ws.part_v[(size_t)blockIdx.x * N_VEC + V_BF + i] = sVec[i];
}

// ---- bf16 on the tensor cores: the forward and the backward's stage 2 -------
//
// One thread block per batch row as above, but a WARP owns a 16-row slab of
// positions and every matrix product of the row stages is `mma.sync` over that
// slab (row_mma.cuh) against weights that the thread block staged in shared
// memory once: Wq, Wk, Wv for the projections beside k and v, then Wf, W1, W2
// over k, v and those three for the tail. Nothing streams a weight matrix per
// position.
//   projections  x slab (A operands straight from device memory) · Wq, Wk, Wv;
//                bias, cast, into shared memory (rows 144 bytes apart)
//   attention    warp h takes head h: `attend_tile`, the attention core's
//                sweep (16 queries over all keys, e on the fragment with
//                ex2.approx); ctx overwrites q word for word
//   tail         ctx·Wf, bias, ·s_a, + x, LN1 on the accumulator fragments
//                (a row's 64 values lie 16 to a lane across a quad); the
//                256-wide hidden layer in four chunks of 64 columns: pre =
//                cast(h1)·W1[:, chunk], bias, relu, cast, and the packed
//                fragment is the A operand of f2 += f1[chunk]·W2[chunk, :], so
//                the hidden layer never leaves the registers; ·s_f, + h1, LN2
//   walk back    (backward) the same way on the forward's copies of W2, W1, Wf
//                read as g·Wᵀ (plain `ldmatrix`; the forward's a·W is the
//                `.trans` load): gf2c·W2ᵀ per chunk under the relu mask (32
//                bits a chunk a lane), gf1c[chunk]·W1ᵀ accumulated, LN1,
//                goc·Wfᵀ. Every rounding point is where the f32 path has it.
// Ragged L: slabs pad L to a multiple of 16. Padded rows hold finite values
// (the biases), are never keys (`exp_block_rows` masks them), and add nothing:
// their stores to the workspace and their terms of the vector gradients are
// masked row by row (`SlabLane`). The vector gradients keep a fixed order:
// rows of a slab by shuffles, a warp's slabs in order, warps in order.

constexpr int LDA = D + 8;      // values between 64-wide rows in shared memory
constexpr int LDW1 = DFF + 8;   // ... between W1's 256-wide rows
// the tail's weights, in values from the start of the region: Wf, W2, W1
constexpr int SW_WF = 0, SW_W2 = D * LDA, SW_W1 = (D + DFF) * LDA;
constexpr int SW_SIZE = SW_W1 + D * LDW1;
constexpr int FFN_CHUNK = 64;
constexpr int N_CHUNKS = DFF / FFN_CHUNK;

static_assert(WARPS == H, "the in-block attention gives each warp one head");

// The region after q (then ctx), in values: k, v and the projections' Wq, Wk,
// Wv while the projections and the attention run; after the attention k and v
// are dead and the tail's Wf, W2, W1 take the region from its start.
__host__ __device__ inline size_t region_values(int Lp) {
  const size_t attention = 2 * (size_t)Lp * LDA + 3 * D * LDA;
  return attention > SW_SIZE ? attention : SW_SIZE;
}

// Shared memory of the two tensor-core kernels: q with L padded to 16 rows of
// LDA values; the region; then floats: max‖k‖ per head and (backward) the
// block's vector sums.
// ops/block_train.py::shared_memory_bytes is the Python twin, checked by the
// wrapper before a launch: change both together.
size_t rows_mma_smem(int L, bool backward) {
  const int Lp = pad_tile(L);
  return ((size_t)Lp * LDA + region_values(Lp)) * sizeof(bf16) +
         (H + (backward ? N_ROW_VECS : 0)) * sizeof(float);
}

// A dense rows x cols matrix from device memory into shared memory, rows ld
// values apart.
__device__ __forceinline__ void stage_matrix(bf16* dst, int ld, const bf16* __restrict__ src,
                                             int rows, int cols, int tid) {
  const int per_row = cols / DK;
  for (int i = tid; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c = (i - r * per_row) * DK;
    copy8(dst + r * ld + c, src + r * cols + c);
  }
}

__device__ __forceinline__ float half_f(uint32_t word, int i) {
  return (i & 1) ? hi_f(word) : lo_f(word);
}
__device__ __forceinline__ float half_f(float2 v, int i) { return (i & 1) ? v.y : v.x; }

// LayerNorm statistics of a slab in the accumulator layout, `ln_stats`'s
// operations in its order: zhat, and 1/sigma of rows g and g + 8.
__device__ __forceinline__ void ln_stats_slab(const float (&z)[8][4], float (&zh)[8][4],
                                              float inv[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum = __fadd_rn(sum, __fadd_rn(z[j][2 * h], z[j][2 * h + 1]));
    const float mean = __fdiv_rn(quad_sum(sum), (float)D);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = __fsub_rn(z[j][2 * h + e], mean);
        zh[j][2 * h + e] = d;
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    inv[h] = rsqrtf(__fadd_rn(__fdiv_rn(quad_sum(sq), (float)D), LN_EPS));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) zh[j][2 * h + e] = __fmul_rn(zh[j][2 * h + e], inv[h]);
  }
}

// Backward of y = zhat·scale + bias on a slab (`ln_backward`'s arithmetic).
__device__ __forceinline__ void ln_backward_slab(float (&gz)[8][4], const float (&gy)[8][4],
                                                 const float (&zh)[8][4], const float inv[2],
                                                 const float* scale, const SlabLane& s) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 sc = vec2(scale, j, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) gz[j][i] = gy[j][i] * half_f(sc, i);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s1 += gz[j][2 * h + e];
        s2 += gz[j][2 * h + e] * zh[j][2 * h + e];
      }
    const float m1 = quad_sum(s1) / (float)D, m2 = quad_sum(s2) / (float)D;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        gz[j][2 * h + e] = (gz[j][2 * h + e] - m1 - zh[j][2 * h + e] * m2) * inv[h];
  }
}

// cast(x W + b) of one slab into all 16 rows of dst (shared memory).
__device__ __forceinline__ void project_slab(bf16* dst, const bf16* sWp, const float* bias,
                                             const uint32_t (&xa)[4][4], const SlabLane& s,
                                             int lane) {
  float acc[8][4];
  zero_acc(acc);
  mma_a_w<4, 8, LDA>(acc, xa, sWp, lane);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = vec2(bias, j, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = __fadd_rn(acc[j][i], half_f(b, i));
  }
  uint32_t p[8][2];
  pack_acc(p, acc);
  SlabLane all = s;
  all.ok0 = all.ok1 = true;
  store_packed(dst, LDA, p, all);
}

// BWD false: the forward kernel, writes out. BWD true: the backward's stage 2,
// recomputes, walks back to gctx and fills the workspace.
template <bool BWD>
__device__ __forceinline__ void rows_mma_body(const bf16* __restrict__ x,
                                              const bf16* __restrict__ s_a,
                                              const bf16* __restrict__ s_f,
                                              const bf16* __restrict__ g, bf16* __restrict__ out,
                                              const Params<bf16>& w, const Workspace<bf16>& ws,
                                              const int L, const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lp = pad_tile(L);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + (size_t)Lp * LDA;
  bf16* sV = sK + (size_t)Lp * LDA;
  bf16* sWp = sV + (size_t)Lp * LDA;  // Wq, Wk, Wv
  bf16* sW = sK;                      // Wf, W2, W1 once k and v are dead
  float* sKn = reinterpret_cast<float*>(sK + region_values(Lp));
  float* sVec = sKn + H;  // N_ROW_VECS sums, from V_BF on (backward)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * L * D;
  const size_t wide = (size_t)blockIdx.x * L * DFF;
  const bf16* xb = x + base;

  // ---- q, k, v = cast(x W + b), all Lp rows
  stage_matrix(sWp, LDA, w.wq, D, D, tid);
  stage_matrix(sWp + D * LDA, LDA, w.wk, D, D, tid);
  stage_matrix(sWp + 2 * D * LDA, LDA, w.wv, D, D, tid);
  __syncthreads();
  for (int slab = warp * TILE; slab < Lp; slab += WARPS * TILE) {
    const SlabLane s(slab, L, lane);
    uint32_t xp[8][2], xa[4][4];
    load_packed(xp, xb, D, s);
    pack_a(xa, xp);
    project_slab(sQ, sWp, w.bq, xa, s, lane);
    project_slab(sK, sWp + D * LDA, w.bk, xa, s, lane);
    project_slab(sV, sWp + 2 * D * LDA, w.bv, xa, s, lane);
  }
  __syncthreads();

  // ---- q, k, v to the workspace, rows striped over all warps: every copy of
  // a q row is done before the attention overwrites it with ctx
  if constexpr (BWD) {
    for (int i = tid; i < L * (D / DK); i += THREADS) {
      const int r = i / (D / DK), c = (i - r * (D / DK)) * DK;
      copy8(ws.q + base + r * D + c, sQ + r * LDA + c);
      copy8(ws.k + base + r * D + c, sK + r * LDA + c);
      copy8(ws.v + base + r * D + c, sV + r * LDA + c);
    }
    __syncthreads();
  }

  // ---- ctx over q, head by head
#if S2S_BLOCK_TRAIN_ATTN_CUDA_CORES
  attend_row<bf16, LDA>(sQ, sK, sV, sKn, BWD ? ws.ctx + base : nullptr, L, inv_temp, tid);
#else
  {
    bf16* qh = sQ + warp * DK;
    const bf16* kh = sK + warp * DK;
    const bf16* vh = sV + warp * DK;
    const float knorm = warp_max_knorm<bf16, LDA>(kh, L, lane);
    const float scale2 = __fmul_rn(inv_temp, EXP_UNIT);
    for (int q0 = 0; q0 < Lp; q0 += TILE) {
      uint32_t qa[2];
      load_a<LDA>(qa, qh, q0, lane);
      const float sh0 = row_shift2(qa[0], knorm, inv_temp);
      const float sh1 = row_shift2(qa[1], knorm, inv_temp);
      float num[4], den[4];
      attend_tile<LDA>(num, den, qa, kh, vh, L, Lp, lane, scale2, sh0, sh1);
      const float d0 = fmaxf(den[0], DEN_MIN), d1 = fmaxf(den[2], DEN_MIN);
      const uint32_t c0 = pack2(__fdiv_rn(num[0], d0), __fdiv_rn(num[1], d0));
      const uint32_t c1 = pack2(__fdiv_rn(num[2], d1), __fdiv_rn(num[3], d1));
      // the accumulator's layout is the A operand's: each lane overwrites the
      // words of q it loaded
      uint32_t* words =
          reinterpret_cast<uint32_t*>(qh) + (q0 + (lane >> 2)) * (LDA / 2) + (lane & 3);
      words[0] = c0;
      words[8 * (LDA / 2)] = c1;
      if constexpr (BWD) {
        const SlabLane s(q0, L, lane);
        bf16* o = ws.ctx + base + warp * DK + s.c;
        if (s.ok0) *reinterpret_cast<uint32_t*>(o + (size_t)s.r0 * D) = c0;
        if (s.ok1) *reinterpret_cast<uint32_t*>(o + (size_t)s.r1 * D) = c1;
      }
    }
  }
  __syncthreads();
#endif

  // ---- the tail's weights over k and v, which no warp reads any more
  stage_matrix(sW + SW_WF, LDA, w.wf, D, D, tid);
  stage_matrix(sW + SW_W2, LDA, w.w2, DFF, D, tid);
  stage_matrix(sW + SW_W1, LDW1, w.w1, D, DFF, tid);
  __syncthreads();

  // ---- the tail (and the walk back), slab by slab
  // this lane's share of the vector gradients: columns 8g + c, c + 1 of each
  // 64-wide one (in the order of ROW_VECS) and of each chunk of b1
  enum { A_BF, A_LN1S, A_LN1B, A_B2, A_LN2S, A_LN2B, N_ACC };
  constexpr int ROW_VECS[N_ACC] = {V_BF, V_LN1S, V_LN1B, V_B2, V_LN2S, V_LN2B};
  float acc[N_ACC][2] = {};
  float a_b1[N_CHUNKS][2] = {};

  for (int slab = warp * TILE; slab < Lp; slab += WARPS * TILE) {
    const SlabLane s(slab, L, lane);

    // z1 = (ctx Wf + bf)·s_a + x, then LN1
    float z[8][4], zh1[8][4], inv1[2];
    {
      uint32_t ca[4][4];
      load_a_slab<4, LDA>(ca, sQ, slab, lane);
      zero_acc(z);
      mma_a_w<4, 8, LDA>(z, ca, sW + SW_WF, lane);
      uint32_t xp[8][2], sap[8][2];
      load_packed(xp, xb, D, s);
      if (s_a != nullptr) load_packed(sap, s_a + base, D, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b = vec2(w.bf, j, s);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float o = __fadd_rn(z[j][i], half_f(b, i));
          if (s_a != nullptr) o = __fmul_rn(o, half_f(sap[j][i >> 1], i));
          z[j][i] = __fadd_rn(o, half_f(xp[j][i >> 1], i));
        }
      }
      ln_stats_slab(z, zh1, inv1);
    }

    // cast(h1) as the FFN's A operands
    uint32_t ha[4][4];
    {
      uint32_t hp[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 sc = vec2(w.ln1s, j, s), b = vec2(w.ln1b, j, s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          z[j][i] = __fadd_rn(__fmul_rn(zh1[j][i], half_f(sc, i)), half_f(b, i));
      }
      pack_acc(hp, z);
      pack_a(ha, hp);
      if constexpr (BWD) store_packed(ws.h1c + base, D, hp, s);
    }

    // the hidden layer, a chunk of columns at a time, never out of registers
    float f2[8][4];
    zero_acc(f2);
    uint32_t relu_mask[N_CHUNKS];  // bit 4j + i: pre > 0 at tile j, entry i
#pragma unroll
    for (int ch = 0; ch < N_CHUNKS; ++ch) {
      float pre[8][4];
      zero_acc(pre);
      mma_a_w<4, 8, LDW1>(pre, ha, sW + SW_W1 + FFN_CHUNK * ch, lane);
      uint32_t mask = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b = vec2(w.b1 + FFN_CHUNK * ch, j, s);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = __fadd_rn(pre[j][i], half_f(b, i));
          if (p > 0.f) mask |= 1u << (4 * j + i);
          pre[j][i] = fmaxf(p, 0.f);
        }
      }
      relu_mask[ch] = mask;
      uint32_t fp[8][2], fa[4][4];
      pack_acc(fp, pre);
      pack_a(fa, fp);
      if constexpr (BWD) store_packed(ws.f1 + wide + FFN_CHUNK * ch, DFF, fp, s);
      mma_a_w<4, 8, LDA>(f2, fa, sW + SW_W2 + FFN_CHUNK * ch * LDA, lane);
    }

    // z2 = (f1 W2 + b2)·s_f + h1, then LN2
    float zh2[8][4], inv2[2];
    uint32_t sfp[8][2];
    if (s_f != nullptr) load_packed(sfp, s_f + base, D, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b = vec2(w.b2, j, s), sc = vec2(w.ln1s, j, s), hb = vec2(w.ln1b, j, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float f = __fadd_rn(f2[j][i], half_f(b, i));
        if (s_f != nullptr) f = __fmul_rn(f, half_f(sfp[j][i >> 1], i));
        // h1 in f32 again, the bits that were cast for the FFN
        f2[j][i] = __fadd_rn(f, __fadd_rn(__fmul_rn(zh1[j][i], half_f(sc, i)), half_f(hb, i)));
      }
    }
    ln_stats_slab(f2, zh2, inv2);

    if constexpr (!BWD) {
      uint32_t op[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 sc = vec2(w.ln2s, j, s), b = vec2(w.ln2b, j, s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          f2[j][i] = __fadd_rn(__fmul_rn(zh2[j][i], half_f(sc, i)), half_f(b, i));
      }
      pack_acc(op, f2);
      store_packed(out + base, D, op, s);
    } else {
      // LN2, the second dropout, the bias b2
      float gy[8][4], gz2[8][4];
      uint32_t p[8][2], ga[4][4];
      load_packed(p, g + base, D, s);
      unpack_acc(gy, p);
      add_column_sums(acc[A_LN2S], s, lane, [&](int j, int i) { return gy[j][i] * zh2[j][i]; });
      add_column_sums(acc[A_LN2B], s, lane, [&](int j, int i) { return gy[j][i]; });
      ln_backward_slab(gz2, gy, zh2, inv2, w.ln2s, s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          gy[j][i] = s_f != nullptr ? gz2[j][i] * half_f(sfp[j][i >> 1], i) : gz2[j][i];
      add_column_sums(acc[A_B2], s, lane, [&](int j, int i) { return gy[j][i]; });
      pack_acc(p, gy);  // gf2c
      store_packed(ws.gf2c + base, D, p, s);
      pack_a(ga, p);

      // gf1 = gf2c W2ᵀ under the relu mask, chunk by chunk; its cast is the A
      // operand of gh1 = gz2 + gf1c W1ᵀ, summed onto gz2 in the accumulators
      float (&d)[8][4] = gz2;
#pragma unroll
      for (int ch = 0; ch < N_CHUNKS; ++ch) {
        float gf1[8][4];
        zero_acc(gf1);
        mma_a_wt<4, 8, LDA>(gf1, ga, sW + SW_W2 + FFN_CHUNK * ch * LDA, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (!((relu_mask[ch] >> (4 * j + i)) & 1u)) gf1[j][i] = 0.f;
        add_column_sums(a_b1[ch], s, lane, [&](int j, int i) { return gf1[j][i]; });
        uint32_t gfa[4][4];
        pack_acc(p, gf1);  // gf1c
        store_packed(ws.gf1c + wide + FFN_CHUNK * ch, DFF, p, s);
        pack_a(gfa, p);
        mma_a_wt<4, 8, LDW1>(d, gfa, sW + SW_W1 + FFN_CHUNK * ch, lane);
      }

      // LN1 and the first dropout
      add_column_sums(acc[A_LN1S], s, lane, [&](int j, int i) { return d[j][i] * zh1[j][i]; });
      add_column_sums(acc[A_LN1B], s, lane, [&](int j, int i) { return d[j][i]; });
      ln_backward_slab(gy, d, zh1, inv1, w.ln1s, s);  // gz1
      store_acc(ws.gz1 + base, D, gy, s);
      if (s_a != nullptr) {
        load_packed(p, s_a + base, D, s);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) gy[j][i] = gy[j][i] * half_f(p[j][i >> 1], i);
      }
      add_column_sums(acc[A_BF], s, lane, [&](int j, int i) { return gy[j][i]; });
      pack_acc(p, gy);  // goc
      store_packed(ws.goc + base, D, p, s);
      pack_a(ga, p);

      // gctx = cast(goc Wfᵀ)
      zero_acc(d);
      mma_a_wt<4, 8, LDA>(d, ga, sW + SW_WF, lane);
      pack_acc(p, d);
      store_packed(ws.gctx + base, D, p, s);
    }
  }

  if constexpr (BWD) {
    // the block's sums: warp 0's, then warp 1's added, ... (a fixed order)
    const int col = 8 * (lane >> 2) + 2 * (lane & 3);
    for (int wi = 0; wi < WARPS; ++wi) {
      if (warp == wi) {
#pragma unroll
        for (int v = 0; v < N_ACC; ++v)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* sp = sVec + ROW_VECS[v] - V_BF + col + e;
            *sp = wi == 0 ? acc[v][e] : __fadd_rn(*sp, acc[v][e]);
          }
#pragma unroll
        for (int ch = 0; ch < N_CHUNKS; ++ch)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* sp = sVec + V_B1 - V_BF + FFN_CHUNK * ch + col + e;
            *sp = wi == 0 ? a_b1[ch][e] : __fadd_rn(*sp, a_b1[ch][e]);
          }
      }
      __syncthreads();
    }
    for (int i = tid; i < N_ROW_VECS; i += THREADS)
      ws.part_v[(size_t)blockIdx.x * N_VEC + V_BF + i] = sVec[i];
  }
}

__global__ void __launch_bounds__(THREADS)
block_train_fwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ s_a,
                           const bf16* __restrict__ s_f, bf16* __restrict__ out,
                           const Params<bf16> w, const int L, const float inv_temp) {
  rows_mma_body<false>(x, s_a, s_f, nullptr, out, w, Workspace<bf16>{}, L, inv_temp);
}

__global__ void __launch_bounds__(THREADS)
bwd_rows_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ s_a,
                    const bf16* __restrict__ s_f, const bf16* __restrict__ g,
                    const Params<bf16> w, const Workspace<bf16> ws, const int L,
                    const float inv_temp) {
  rows_mma_body<true>(x, s_a, s_f, g, nullptr, w, ws, L, inv_temp);
}

// ---- backward, stage 4: gx and the projections' gradient operands ----------

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_input_kernel(T* __restrict__ gx, const Params<T> w, const Workspace<T> ws, const int L) {
  __shared__ T sBuf[WARPS][3][D];
  __shared__ float sVec[3 * D];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * L * D;
  const float* gp[3] = {ws.gq, ws.gk, ws.gv};
  T* gpc[3] = {ws.gqc, ws.gkc, ws.gvc};
  const T* wT[3] = {w.wqT, w.wkT, w.wvT};
  float acc[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};

  for (int t = warp; t < L; t += WARPS) {
    const size_t row = base + (size_t)t * D;
    __syncwarp();  // the previous row's readers of sBuf are done
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float v = gp[p][row + lane + 32 * c];
        acc[p][c] += v;
        const T vc = from_f<T>(v);
        sBuf[warp][p][lane + 32 * c] = vc;
        gpc[p][row + lane + 32 * c] = vc;
      }
    __syncwarp();
    float g0 = ws.gz1[row + lane], g1 = ws.gz1[row + lane + 32];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float d0 = 0.f, d1 = 0.f;
      for (int c = 0; c < D; ++c) {
        const float gv = to_f(sBuf[warp][p][c]);
        d0 = fmaf(gv, to_f(wT[p][c * D + lane]), d0);
        d1 = fmaf(gv, to_f(wT[p][c * D + lane + 32]), d1);
      }
      g0 += d0;
      g1 += d1;
    }
    gx[row + lane] = from_f<T>(g0);
    gx[row + lane + 32] = from_f<T>(g1);
  }

  for (int wi = 0; wi < WARPS; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* s = sVec + p * D + lane + 32 * c;
          *s = wi == 0 ? acc[p][c] : __fadd_rn(*s, acc[p][c]);
        }
    }
    __syncthreads();
  }
  // V_BQ, V_BK, V_BV are the first three vectors
  for (int i = tid; i < 3 * D; i += THREADS)
    ws.part_v[(size_t)blockIdx.x * N_VEC + V_BQ + i] = sVec[i];
}

// bf16: the same stage with a warp per 16-row slab; Wq, Wk, Wv staged once per
// thread block and read as g·Wᵀ, the three products summed onto gz1 in the
// accumulators.
__global__ void __launch_bounds__(THREADS)
bwd_input_mma_kernel(bf16* __restrict__ gx, const Params<bf16> w, const Workspace<bf16> ws,
                     const int L) {
  __shared__ __align__(16) bf16 sW[3 * D * LDA];
  __shared__ float sVec[3 * D];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * L * D;
  const float* gp[3] = {ws.gq, ws.gk, ws.gv};
  bf16* gpc[3] = {ws.gqc, ws.gkc, ws.gvc};
  stage_matrix(sW, LDA, w.wq, D, D, tid);
  stage_matrix(sW + D * LDA, LDA, w.wk, D, D, tid);
  stage_matrix(sW + 2 * D * LDA, LDA, w.wv, D, D, tid);
  __syncthreads();
  float acc[3][2] = {};

  for (int slab = warp * TILE; slab < L; slab += WARPS * TILE) {
    const SlabLane s(slab, L, lane);
    float d[8][4];
    load_acc(d, ws.gz1 + base, D, s);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float v[8][4];
      load_acc(v, gp[p] + base, D, s);
      add_column_sums(acc[p], s, lane, [&](int j, int i) { return v[j][i]; });
      uint32_t pk[8][2], ga[4][4];
      pack_acc(pk, v);
      store_packed(gpc[p] + base, D, pk, s);
      pack_a(ga, pk);
      mma_a_wt<4, 8, LDA>(d, ga, sW + p * D * LDA, lane);
    }
    uint32_t pk[8][2];
    pack_acc(pk, d);
    store_packed(gx + base, D, pk, s);
  }

  const int col = 8 * (lane >> 2) + 2 * (lane & 3);
  for (int wi = 0; wi < WARPS; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* sp = sVec + p * D + col + e;
          *sp = wi == 0 ? acc[p][e] : __fadd_rn(*sp, acc[p][e]);
        }
    }
    __syncthreads();
  }
  // V_BQ, V_BK, V_BV are the first three vectors
  for (int i = tid; i < 3 * D; i += THREADS)
    ws.part_v[(size_t)blockIdx.x * N_VEC + V_BQ + i] = sVec[i];
}

// ---- backward, stage 5: the matrix gradients Aᵀ·G, split over positions ----

constexpr int N_TILES = N_MAT / (D * D);  // 64 x 64 output tiles
constexpr int CHUNK = 32;                 // rows staged in shared memory at a time

template <typename T>
struct Tile {
  const T* a;  // (N, lda) operand, at the tile's first column
  const T* g;  // (N, ldg) gradient operand, at the tile's first column
  int lda, ldg;
  int out, ldo;  // the tile's first entry in the flat matrix layout, its row stride
};
template <typename T>
struct Tiles {
  Tile<T> t[N_TILES];
};

template <typename T>
Tiles<T> make_tiles(const T* x, const Workspace<T>& ws) {
  Tiles<T> r;
  r.t[0] = {x, ws.gqc, D, D, M_WQ, D};
  r.t[1] = {x, ws.gkc, D, D, M_WK, D};
  r.t[2] = {x, ws.gvc, D, D, M_WV, D};
  r.t[3] = {ws.ctx, ws.goc, D, D, M_WF, D};
  for (int i = 0; i < DFF / D; ++i) {
    r.t[4 + i] = {ws.h1c, ws.gf1c + i * D, D, DFF, M_W1 + i * D, DFF};
    r.t[4 + DFF / D + i] = {ws.f1 + i * D, ws.gf2c, DFF, D, M_W2 + i * D * D, D};
  }
  return r;
}

// Block (tile, part): out[i][j] = Σ_rows a[row][i]·g[row][j] over the part's
// rows in order; thread (ty, tx) of 16 x 16 holds a 4 x 4 patch.
template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const Tiles<T> tiles, float* __restrict__ part_m, const long long n_rows,
             const long long rows_per_part) {
  __shared__ __align__(16) float sA[CHUNK][D];
  __shared__ __align__(16) float sG[CHUNK][D];
  const Tile<T> tl = tiles.t[blockIdx.x];
  const long long r0 = blockIdx.y * rows_per_part;
  const long long r1 = r0 + rows_per_part < n_rows ? r0 + rows_per_part : n_rows;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lr = tid >> 3, lc = (tid & 7) * DK;  // this thread's 8 values of a chunk
  float acc[4][4] = {};

  for (long long r = r0; r < r1; r += CHUNK) {
    float va[DK] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float vg[DK] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r + lr < r1) {
      load8(tl.a + (r + lr) * tl.lda + lc, va);
      load8(tl.g + (r + lr) * tl.ldg + lc, vg);
    }
    store8(&sA[lr][lc], va);
    store8(&sG[lr][lc], vg);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < CHUNK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sG[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = part_m + (size_t)blockIdx.y * N_MAT + tl.out;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(o + (ty * 4 + i) * tl.ldo + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// bf16: the same block (tile, part) on the tensor cores. The operands' rows
// are staged 64 at a time, as they lie; out = Aᵀ·G runs over the rows, so both
// operands are `.trans` loads. Warp w holds rows 16·(w % 4).. of the tile and
// columns 32·(w / 4)..; every sum runs over the part's rows in order.
constexpr int WG_ROWS = 64;

__global__ void __launch_bounds__(THREADS)
wgrad_mma_kernel(const Tiles<bf16> tiles, float* __restrict__ part_m, const long long n_rows,
                 const long long rows_per_part) {
  __shared__ __align__(16) bf16 sA[WG_ROWS * LDA];
  __shared__ __align__(16) bf16 sG[WG_ROWS * LDA];
  const Tile<bf16> tl = tiles.t[blockIdx.x];
  const long long r0 = blockIdx.y * rows_per_part;
  const long long r1 = r0 + rows_per_part < n_rows ? r0 + rows_per_part : n_rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = 16 * (warp & 3), j0 = 32 * (warp >> 2);
  // A operand (16 outputs i x 16 rows) out of rows stored (row, i): matrix m of
  // the four is rows 8·(m / 2).., columns i0 + 8·(m % 2)..
  const int a_off = ((lane & 7) + 8 * (lane >> 4)) * LDA + i0 + 8 * ((lane >> 3) & 1);
  float acc[4][4];
  zero_acc(acc);

  for (long long r = r0; r < r1; r += WG_ROWS) {
    for (int i = tid; i < WG_ROWS * (D / DK); i += THREADS) {
      const int lr = i / (D / DK), lc = (i - lr * (D / DK)) * DK;
      if (r + lr < r1) {
        copy8(sA + lr * LDA + lc, tl.a + (r + lr) * tl.lda + lc);
        copy8(sG + lr * LDA + lc, tl.g + (r + lr) * tl.ldg + lc);
      } else {
        *reinterpret_cast<uint4*>(sA + lr * LDA + lc) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(sG + lr * LDA + lc) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WG_ROWS; k += 16) {
      uint32_t a[1][4];
      ldmatrix_x4_trans(a[0], sA + k * LDA + a_off);
      mma_a_w<1, 4, LDA>(acc, a, sG + k * LDA + j0, lane);
    }
    __syncthreads();
  }
  float* o = part_m + (size_t)blockIdx.y * N_MAT + tl.out;
  const int row = i0 + (lane >> 2), col = j0 + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<float2*>(o + row * tl.ldo + col + 8 * nt) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(o + (row + 8) * tl.ldo + col + 8 * nt) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- backward, stage 6: partial sums added in index order ------------------

__global__ void __launch_bounds__(THREADS)
reduce_partials_kernel(const float* __restrict__ part_m, const float* __restrict__ part_v,
                       float* __restrict__ gw, const int B) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= N_MAT + N_VEC) return;
  float s = 0.f;
  if (e < N_MAT) {
    for (int p = 0; p < NPART; ++p) s = __fadd_rn(s, part_m[(size_t)p * N_MAT + e]);
  } else {
    for (int b = 0; b < B; ++b) s = __fadd_rn(s, part_v[(size_t)b * N_VEC + e - N_MAT]);
  }
  gw[e] = s;
}

// ---- host side -------------------------------------------------------------

// bf16 takes the tensor-core kernels, f32 the CUDA-core ones.
template <typename T>
constexpr bool USE_MMA = std::is_same<T, bf16>::value && !S2S_BLOCK_TRAIN_CUDA_CORES;

template <typename T>
size_t smem_bytes(int L, bool backward) {
  if constexpr (USE_MMA<T>) return rows_mma_smem(L, backward);
  else return row_kernel_smem<T>(L, backward);
}

template <typename T>
int launch_fwd(const void* x_, const void* s_a_, const void* s_f_, void* out_, const Masters& m,
               void* wc, int B, int L, float inv_temp, cudaStream_t stream) {
  const T *x = static_cast<const T*>(x_), *s_a = static_cast<const T*>(s_a_),
          *s_f = static_cast<const T*>(s_f_);
  T* out = static_cast<T*>(out_);
  const size_t smem = smem_bytes<T>(L, false);
  const Params<T> w = make_params<T>(m, static_cast<const T*>(wc));
  round_weights_kernel<T><<<N_MAT / THREADS, THREADS, 0, stream>>>(m, static_cast<T*>(wc), false);
  S2S_CHECK_LAUNCH();
  if constexpr (USE_MMA<T>) {
    const cudaError_t err = allow_shared_memory(block_train_fwd_mma_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    block_train_fwd_mma_kernel<<<B, THREADS, smem, stream>>>(x, s_a, s_f, out, w, L, inv_temp);
  } else {
    const cudaError_t err = allow_shared_memory(block_train_fwd_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    block_train_fwd_kernel<T><<<B, THREADS, smem, stream>>>(x, s_a, s_f, out, w, L, inv_temp);
  }
  return (int)cudaGetLastError();
}

// The backward's launches, in order; `stages` picks them by bit (a stage reads
// what the earlier ones left in the workspace, so one stage alone can be run
// again after a whole call, which is how the stages are timed).
enum Stage { ROUND_WEIGHTS = 1, ROWS = 2, ATTENTION = 4, INPUT = 8, WGRAD = 16, REDUCE = 32 };

template <typename T>
int launch_bwd(const void* x_, const void* s_a_, const void* s_f_, const void* g_, void* gx,
               float* gw, const Masters& m, void* wc, void* ws_t, float* ws_f, int B, int L,
               int dtype, float inv_temp, int stages, cudaStream_t stream) {
  const T *x = static_cast<const T*>(x_), *s_a = static_cast<const T*>(s_a_),
          *s_f = static_cast<const T*>(s_f_), *g = static_cast<const T*>(g_);
  const long long n_rows = (long long)B * L;
  const size_t smem = smem_bytes<T>(L, true);
  const Params<T> w = make_params<T>(m, static_cast<const T*>(wc));
  const Workspace<T> ws = make_workspace<T>(static_cast<T*>(ws_t), ws_f, n_rows);

  if (stages & ROUND_WEIGHTS) {
    // only the CUDA-core kernels read transposed copies
    round_weights_kernel<T><<<N_MAT / THREADS, THREADS, 0, stream>>>(m, static_cast<T*>(wc),
                                                                   !USE_MMA<T>);
    S2S_CHECK_LAUNCH();
  }
  if (stages & ROWS) {
    if constexpr (USE_MMA<T>) {
      const cudaError_t err = allow_shared_memory(bwd_rows_mma_kernel, smem);
      if (err != cudaSuccess) return (int)err;
      bwd_rows_mma_kernel<<<B, THREADS, smem, stream>>>(x, s_a, s_f, g, w, ws, L, inv_temp);
    } else {
      const cudaError_t err = allow_shared_memory(bwd_rows_kernel<T>, smem);
      if (err != cudaSuccess) return (int)err;
      bwd_rows_kernel<T><<<B, THREADS, smem, stream>>>(x, s_a, s_f, g, w, ws, L, inv_temp);
    }
    S2S_CHECK_LAUNCH();
  }
  if (stages & ATTENTION) {
    const int rc = attn_core_bwd_f32(ws.q, ws.k, ws.v, ws.gctx, ws.gq, ws.gk, ws.gv, B, L, dtype,
                                     inv_temp, stream);
    if (rc != 0) return rc;
  }
  if (stages & INPUT) {
    if constexpr (USE_MMA<T>)
      bwd_input_mma_kernel<<<B, THREADS, 0, stream>>>(static_cast<T*>(gx), w, ws, L);
    else
      bwd_input_kernel<T><<<B, THREADS, 0, stream>>>(static_cast<T*>(gx), w, ws, L);
    S2S_CHECK_LAUNCH();
  }
  if (stages & WGRAD) {
    const long long rows_per_part = (n_rows + NPART - 1) / NPART;
    const dim3 grid(N_TILES, NPART);
    if constexpr (USE_MMA<T>)
      wgrad_mma_kernel<<<grid, THREADS, 0, stream>>>(make_tiles<T>(x, ws), ws.part_m, n_rows,
                                                     rows_per_part);
    else
      wgrad_kernel<T><<<grid, THREADS, 0, stream>>>(make_tiles<T>(x, ws), ws.part_m, n_rows,
                                                    rows_per_part);
    S2S_CHECK_LAUNCH();
  }
  if (stages & REDUCE) {
    reduce_partials_kernel<<<(N_MAT + N_VEC + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        ws.part_m, ws.part_v, gw, B);
    S2S_CHECK_LAUNCH();
  }
  return 0;
}

Masters masters(void* const* weights) {
  Masters m;
  for (int i = 0; i < 16; ++i) m.p[i] = static_cast<const float*>(weights[i]);
  return m;
}

}  // namespace

// Element counts of the buffers a call at (B, L) needs: sizes[0] the rounded
// weights (compute dtype; the forward needs only this one), sizes[1] the
// backward's compute-dtype workspace, sizes[2] its f32 workspace.
extern "C" void s2s_block_train_workspace(int B, int L, long long* sizes) {
  const long long n = (long long)B * L;
  sizes[0] = 2 * N_MAT;
  sizes[1] = n * WS_T_PER_ROW;
  sizes[2] = n * WS_F_PER_ROW + (long long)NPART * N_MAT + (long long)B * N_VEC;
}

// x, out: (B, L, 64) contiguous, bf16 (dtype 0) or f32 (dtype 1); s_a, s_f:
// like x, or both null. weights: 16 device pointers to the f32 masters in the
// Pallas kernel's _WEIGHT_FIELDS order, matrices (in, out) row-major. wc:
// sizes[0] values of x's dtype.
extern "C" int s2s_block_train_fwd(const void* x, const void* s_a, const void* s_f, void* out,
                                   void* const* weights, void* wc, int B, int L, int dtype,
                                   float inv_temp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Masters m = masters(weights);
  if (dtype == 0) return launch_fwd<__nv_bfloat16>(x, s_a, s_f, out, m, wc, B, L, inv_temp, s);
  if (dtype == 1) return launch_fwd<float>(x, s_a, s_f, out, m, wc, B, L, inv_temp, s);
  return (int)cudaErrorInvalidValue;
}

// g: the gradient of the loss by out, in x's dtype; gx: as x. gw: N_MAT +
// N_VEC floats, the six matrix gradients (Wq, Wk, Wv, Wf, W1, W2) then the ten
// vector gradients (bq, bk, bv, bf, ln1 scale, ln1 bias, b1, b2, ln2 scale,
// ln2 bias). ws_t, ws_f: sizes[1] values of x's dtype and sizes[2] floats.
// stages: the launches to make, bit i for the i-th of the six (63: the whole
// backward; fewer only after a whole call on the same buffers, to time them).
extern "C" int s2s_block_train_bwd(const void* x, const void* s_a, const void* s_f,
                                   const void* g, void* gx, float* gw, void* const* weights,
                                   void* wc, void* ws_t, float* ws_f, int B, int L, int dtype,
                                   float inv_temp, int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Masters m = masters(weights);
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16>(x, s_a, s_f, g, gx, gw, m, wc, ws_t, ws_f, B, L, dtype,
                                     inv_temp, stages, s);
  if (dtype == 1)
    return launch_bwd<float>(x, s_a, s_f, g, gx, gw, m, wc, ws_t, ws_f, B, L, dtype, inv_temp,
                             stages, s);
  return (int)cudaErrorInvalidValue;
}
