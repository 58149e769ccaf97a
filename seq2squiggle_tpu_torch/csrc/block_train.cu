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
// for the backward, also writes their transposes, so that every product reads
// its weights along the lanes).
//
// Bound: operations (20.7 GFLOP forward, about 62 backward at B = 512,
// L = 250, against four or five tensors of 16 MB), run here as f32 FMA loops
// on the CUDA cores; tensor cores are left to a later change.
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
// workspace (what each stage leaves for a later one is listed at `Workspace`):
//   1. round_weights_kernel    W and Wᵀ in T
//   2. bwd_rows_kernel         block per batch row: recompute q, k, v, ctx as
//                              the forward does, then per row (one per warp)
//                              the rest of the forward and the walk back to
//                              gctx; per-block sums of the seven vector
//                              gradients it sees, warps added in order
//   3. attn_core.cu's backward per (batch row, head): gq, gk, gv as f32
//   4. bwd_input_kernel        gx = gz1 + Σ gpc Wᵀ per row; sums of gq, gk, gv
//   5. wgrad_kernel            the six Aᵀ·G products as twelve 64 x 64 tiles,
//                              each over NPART fixed contiguous ranges of
//                              positions, rows in order
//   6. reduce_partials_kernel  partial sums added in index order
// No atomics: every sum has a fixed order that depends on (B, L) alone, not
// on the card, so two runs give the same bits. The workspace costs about
// 1216 T + 256 f32 values per position, written once and read once.
// Ragged L and B need no padding: every loop is bounded by L.
//
// C interface (loaded with ctypes by ops/_build.py): each entry point returns
// the first launch error of its stages (cudaGetLastError() after each).

#include "attn_common.cuh"

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
template <typename T>
__device__ __forceinline__ void attend_row(T* sQ, const T* sK, const T* sV, float* sKn,
                                           T* gctx, const int L, const float inv_temp,
                                           const int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const float kn = warp_max_knorm<T, D>(sK + warp * DK, L, lane);
  if (lane == 0) sKn[warp] = kn;
  __syncthreads();
  for (int it = tid; it < H * L; it += THREADS) {
    const int h = it / L;
    const int t = it - h * L;
    float q[DK], num[DK], den, ctx[DK];
    load8(sQ + t * D + h * DK, q);
    attend_query<T, D>(q, sK + h * DK, sV + h * DK, L, inv_temp, false,
                       cs_shift(q, sKn[h], inv_temp), num, den);
#pragma unroll
    for (int c = 0; c < DK; ++c) ctx[c] = __fdiv_rn(num[c], den);
    store8(sQ + t * D + h * DK, ctx);
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

template <typename T>
int launch_fwd(const void* x, const void* s_a, const void* s_f, void* out, const Masters& m,
               void* wc, int B, int L, float inv_temp, cudaStream_t stream) {
  const size_t smem = row_kernel_smem<T>(L, false);
  cudaError_t err = allow_shared_memory(block_train_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  round_weights_kernel<T><<<N_MAT / THREADS, THREADS, 0, stream>>>(m, static_cast<T*>(wc), false);
  S2S_CHECK_LAUNCH();
  block_train_fwd_kernel<T><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(s_a), static_cast<const T*>(s_f),
      static_cast<T*>(out), make_params<T>(m, static_cast<const T*>(wc)), L, inv_temp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x_, const void* s_a, const void* s_f, const void* g, void* gx,
               float* gw, const Masters& m, void* wc, void* ws_t, float* ws_f, int B, int L,
               int dtype, float inv_temp, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const long long n_rows = (long long)B * L;
  const size_t smem = row_kernel_smem<T>(L, true);
  cudaError_t err = allow_shared_memory(bwd_rows_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const Params<T> w = make_params<T>(m, static_cast<const T*>(wc));
  const Workspace<T> ws = make_workspace<T>(static_cast<T*>(ws_t), ws_f, n_rows);

  round_weights_kernel<T><<<N_MAT / THREADS, THREADS, 0, stream>>>(m, static_cast<T*>(wc), true);
  S2S_CHECK_LAUNCH();
  bwd_rows_kernel<T><<<B, THREADS, smem, stream>>>(
      x, static_cast<const T*>(s_a), static_cast<const T*>(s_f), static_cast<const T*>(g), w,
      ws, L, inv_temp);
  S2S_CHECK_LAUNCH();
  const int rc = attn_core_bwd_f32(ws.q, ws.k, ws.v, ws.gctx, ws.gq, ws.gk, ws.gv, B, L, dtype,
                                   inv_temp, stream);
  if (rc != 0) return rc;
  bwd_input_kernel<T><<<B, THREADS, 0, stream>>>(static_cast<T*>(gx), w, ws, L);
  S2S_CHECK_LAUNCH();
  const long long rows_per_part = (n_rows + NPART - 1) / NPART;
  wgrad_kernel<T><<<dim3(N_TILES, NPART), THREADS, 0, stream>>>(make_tiles<T>(x, ws), ws.part_m,
                                                                n_rows, rows_per_part);
  S2S_CHECK_LAUNCH();
  reduce_partials_kernel<<<(N_MAT + N_VEC + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      ws.part_m, ws.part_v, gw, B);
  return (int)cudaGetLastError();
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
extern "C" int s2s_block_train_bwd(const void* x, const void* s_a, const void* s_f,
                                   const void* g, void* gx, float* gw, void* const* weights,
                                   void* wc, void* ws_t, float* ws_f, int B, int L, int dtype,
                                   float inv_temp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Masters m = masters(weights);
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16>(x, s_a, s_f, g, gx, gw, m, wc, ws_t, ws_f, B, L, dtype,
                                     inv_temp, s);
  if (dtype == 1)
    return launch_bwd<float>(x, s_a, s_f, g, gx, gw, m, wc, ws_t, ws_f, B, L, dtype, inv_temp, s);
  return (int)cudaErrorInvalidValue;
}
