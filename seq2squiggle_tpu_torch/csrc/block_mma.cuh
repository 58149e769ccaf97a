// The bf16 post-LN FFT block on the H100's tensor cores, forward, for one
// batch row per thread block: the body that block_train.cu's training kernels
// (its forward, and its backward's recompute) and fft_block.cu's inference
// kernels (one block, and the pair) share.
//
//   q/k/v = cast(x Wq + bq) ...   (bf16 operands, f32 sums)
//   ctx   = softmax(q kᵀ / √d_k) v   per head, 8 heads of d_k = 8
//   h1    = LN1((ctx Wf + bf)·s_a + x)   (f32 statistics, f32 result)
//   f2    = (cast(relu(cast(h1) W1 + b1)) W2 + b2)·s_f;  LN2(f2 + h1)
//
// A WARP owns a 16-row slab of positions, and every matrix product is
// `mma.sync` over that slab (row_mma.cuh) against weights that the thread
// block staged in shared memory once: Wq, Wk, Wv for the projections beside k
// and v, then Wf, W1, W2 over k, v and those three for the tail. Nothing
// streams a weight matrix per position.
//   projections  x slab (A operands straight from its rows) · Wq, Wk, Wv;
//                bias, cast, into shared memory (rows 144 bytes apart)
//   attention    warp h takes head h: `attend_tile`, the attention core's
//                sweep (16 queries over all keys, e on the fragment with
//                ex2.approx), shifted by the Cauchy–Schwarz bound or, in the
//                exact form, by each query's largest score (`row_max_tile`,
//                one more `mma.sync` pass over the keys); ctx overwrites q
//                word for word
//   tail         ctx·Wf, bias, ·s_a, + x, LN1 on the accumulator fragments
//                (a row's 64 values lie 16 to a lane across a quad); the
//                256-wide hidden layer in four chunks of 64 columns: pre =
//                cast(h1)·W1[:, chunk], bias, relu, cast, and the packed
//                fragment is the A operand of f2 += f1[chunk]·W2[chunk, :], so
//                the hidden layer never leaves the registers; ·s_f, + h1, LN2's
//                statistics; then the caller's `finish` on the slab (the
//                output, or the training backward's walk back)
// Template choices: EXACT (the exact row max, else the Cauchy–Schwarz shift),
// SCALES (the dropout scales s_a, s_f, each null or not), STORES (q, k, v,
// ctx, cast(h1) and f1 to the training backward's workspace), CUT (a
// profiling cut, row_mma.cuh; only fft_block_variants.cu takes one). The
// inference block turns SCALES and STORES off. Every rounding point is where
// the f32 CUDA-core path has it.
//
// Ragged L: slabs pad L to a multiple of 16. Padded rows hold finite values
// (the biases), are never keys (`exp_block_rows` and `row_max_tile` mask
// them), and add nothing: stores and sums are masked row by row (`SlabLane`).
//
// Bound: operations (41.5 GFLOP per (1024, 250, 64) block) against ~66 MB of
// activations; what holds the body is issue (ldmatrix, epilogues, 4-byte
// loads and stores) at 8 warps an SM, not the tensor cores' rate.

#pragma once

#include "row_mma.cuh"

namespace s2s {

constexpr int DFF = 256;  // FFN width
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float LN_EPS = 1e-5f;

static_assert(WARPS == H, "the in-block attention gives each warp one head");

template <typename T>
struct BlockWeights {
  const T* wq; const float* bq;
  const T* wk; const float* bk;
  const T* wv; const float* bv;
  const T* wf; const float* bf;
  const float* ln1s; const float* ln1b;
  const T* w1; const float* b1;
  const T* w2; const float* b2;
  const float* ln2s; const float* ln2b;
};

// 16 device pointers in the Pallas kernel's _WEIGHT_FIELDS order.
template <typename T>
inline BlockWeights<T> block_weights(void* const* p) {
  return BlockWeights<T>{
      static_cast<const T*>(p[0]),      static_cast<const float*>(p[1]),
      static_cast<const T*>(p[2]),      static_cast<const float*>(p[3]),
      static_cast<const T*>(p[4]),      static_cast<const float*>(p[5]),
      static_cast<const T*>(p[6]),      static_cast<const float*>(p[7]),
      static_cast<const float*>(p[8]),  static_cast<const float*>(p[9]),
      static_cast<const T*>(p[10]),     static_cast<const float*>(p[11]),
      static_cast<const T*>(p[12]),     static_cast<const float*>(p[13]),
      static_cast<const float*>(p[14]), static_cast<const float*>(p[15]),
  };
}

constexpr int LDA = D + 8;      // values between 64-wide rows in shared memory
constexpr int LDW1 = DFF + 8;   // ... between W1's 256-wide rows
// the tail's weights, in values from the start of the region: Wf, W2, W1
constexpr int SW_WF = 0, SW_W2 = D * LDA, SW_W1 = (D + DFF) * LDA;
constexpr int SW_SIZE = SW_W1 + D * LDW1;
constexpr int FFN_CHUNK = 64;
constexpr int N_CHUNKS = DFF / FFN_CHUNK;

// The region after q (then ctx), in values: k, v and the projections' Wq, Wk,
// Wv while the projections and the attention run; after the attention k and v
// are dead and the tail's Wf, W2, W1 take the region from its start.
__host__ __device__ inline size_t region_values(int Lp) {
  const size_t attention = 2 * (size_t)Lp * LDA + 3 * D * LDA;
  return attention > SW_SIZE ? attention : SW_SIZE;
}

// Bytes of the body's shared memory: q with L padded to 16 rows of LDA
// values, then the region. A caller's own buffers follow (16-byte aligned).
// ops/fft_block.py::shared_memory_bytes and ops/block_train.py::
// shared_memory_bytes are the Python twins of the kernels' totals, checked by
// the wrappers before a launch: change them together.
__host__ __device__ inline size_t slab_smem_bytes(int L) {
  const int Lp = pad_tile(L);
  return ((size_t)Lp * LDA + region_values(Lp)) * sizeof(bf16);
}

struct SlabSmem {
  bf16 *q, *k, *v;  // Lp rows of LDA values each
  bf16* wp;         // Wq, Wk, Wv, 3·64 rows of LDA values
  bf16* w;          // Wf, W2, W1 (SW_*) once k and v are dead
};

__device__ __forceinline__ SlabSmem slab_smem(unsigned char* smem, int Lp) {
  SlabSmem s;
  s.q = reinterpret_cast<bf16*>(smem);
  s.k = s.q + (size_t)Lp * LDA;
  s.v = s.k + (size_t)Lp * LDA;
  s.wp = s.v + (size_t)Lp * LDA;
  s.w = s.k;
  return s;
}

// Where the training backward keeps the forward's intermediates of one batch
// row (device memory; rows of 64 values, f1's of 256).
struct RowStores {
  bf16 *q, *k, *v, *ctx, *h1c, *f1;
};

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

// LayerNorm statistics of a slab in the accumulator layout, in the order of
// the warp-per-row `ln_stats`: zhat, and 1/sigma of rows g and g + 8.
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

// y = zhat·scale + bias of a slab, rounded to bf16 in the packed layout.
__device__ __forceinline__ void ln_affine_packed(uint32_t (&p)[8][2], const float (&zh)[8][4],
                                                 const float* scale, const float* bias,
                                                 const SlabLane& s) {
  float y[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 sc = vec2(scale, j, s), b = vec2(bias, j, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      y[j][i] = __fadd_rn(__fmul_rn(zh[j][i], half_f(sc, i)), half_f(b, i));
  }
  pack_acc(p, y);
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

// The attention hook's default: block_rows_mma calls it only with CUT_ATTEND
// or CUT_STAGE.
struct NoAttend {
  __device__ void operator()(const SlabSmem&, int, int) const {}
};

// The block's forward over the L rows at xb (ldx values apart, device or
// shared memory) with the dynamic shared memory at smem (slab_smem_bytes(L)
// bytes). Every thread of the block calls it. Per slab, after LN2's
// statistics, it calls
//   finish(s, zh1, inv1, zh2, inv2, relu_mask, sfp)
// with the slab's lane (SlabLane), LN1's and LN2's zhat and 1/sigma, the relu
// mask (bit 4j + i of word ch: pre > 0 at tile j, entry i of chunk ch) and
// s_f's packed rows (SCALES with s_f given; else unset); the tail's weights are
// at slab_smem(smem, Lp).w until the body returns. The finish may write the
// rows at xb: each lane reads a slab's residual before it writes the words it
// read. sab, sfb: the rows of s_a and s_f (64 values apart) or null. w: the
// weights by BlockWeights' member names (BlockWeights<bf16>, or the training
// kernels' own struct), best a kernel parameter itself: its pointers are
// then read from the parameter bank where they are used, not held in
// registers.
// CUT: a profiling cut (row_mma.cuh), CUT_NONE on every main path. Two more
// serve the profiling kernels: with CUT_ATTEND the caller's attend(sm, L, Lp)
// runs in place of the attention (it writes ctx over sm.q), with CUT_STAGE
// too and then the body returns after the attention's barrier, without the
// tail. (Keep this one function: split into phase functions, the same code
// compiled to other spills in the training kernels and their forward ran
// slower; PERF.md has the numbers.)
template <bool EXACT, bool SCALES, bool STORES, int CUT = CUT_NONE, typename W,
          typename Finish, typename Attend = NoAttend>
__device__ __forceinline__ void block_rows_mma(const bf16* xb, int ldx, const bf16* sab,
                                               const bf16* sfb, const W& w,
                                               const RowStores& st, int L, float inv_temp,
                                               unsigned char* smem, Finish finish,
                                               Attend attend = {}) {
  const int Lp = pad_tile(L);
  const SlabSmem sm = slab_smem(smem, Lp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // ---- q, k, v = cast(x W + b), all Lp rows
  stage_matrix(sm.wp, LDA, w.wq, D, D, tid);
  stage_matrix(sm.wp + D * LDA, LDA, w.wk, D, D, tid);
  stage_matrix(sm.wp + 2 * D * LDA, LDA, w.wv, D, D, tid);
  __syncthreads();
  for (int slab = warp * TILE; slab < Lp; slab += WARPS * TILE) {
    const SlabLane s(slab, L, lane);
    uint32_t xp[8][2], xa[4][4];
    load_packed(xp, xb, ldx, s);
    pack_a(xa, xp);
    project_slab(sm.q, sm.wp, w.bq, xa, s, lane);
    project_slab(sm.k, sm.wp + D * LDA, w.bk, xa, s, lane);
    project_slab(sm.v, sm.wp + 2 * D * LDA, w.bv, xa, s, lane);
  }
  __syncthreads();

  // ---- q, k, v to the workspace, rows striped over all warps: every copy of
  // a q row is done before the attention overwrites it with ctx
  if constexpr (STORES) {
    for (int i = tid; i < L * (D / DK); i += THREADS) {
      const int r = i / (D / DK), c = (i - r * (D / DK)) * DK;
      copy8(st.q + r * D + c, sm.q + r * LDA + c);
      copy8(st.k + r * D + c, sm.k + r * LDA + c);
      copy8(st.v + r * D + c, sm.v + r * LDA + c);
    }
    __syncthreads();
  }

  // ---- ctx over q, head by head
  static_assert(!EXACT || CUT == CUT_NONE || CUT == CUT_NOATTN || CUT == CUT_NOFFN,
                "the exact form takes no cut of the attention");
  if constexpr (CUT == CUT_ATTEND || CUT == CUT_STAGE) {
    attend(sm, L, Lp);
  } else if constexpr (CUT != CUT_NOATTN) {
    bf16* qh = sm.q + warp * DK;
    const bf16* kh = sm.k + warp * DK;
    const bf16* vh = sm.v + warp * DK;
    // the cuts of the exp take e's argument in natural units
    constexpr bool NATURAL = CUT == CUT_NOEXP || CUT == CUT_BF16EXP;
    const float knorm =
        (EXACT || CUT == CUT_NOSHIFT) ? 0.f : warp_max_knorm<bf16, LDA>(kh, L, lane);
    const float scale2 = NATURAL ? inv_temp : __fmul_rn(inv_temp, EXP_UNIT);
    // keys that count: the TPU kernel pads L to a multiple of 8 with zero rows
    // (here: the biases' keys), which CUT_NOMASK leaves unmasked
    const int keys = CUT == CUT_NOMASK ? (L + 7) / 8 * 8 : L;
    for (int q0 = 0; q0 < Lp; q0 += TILE) {
      uint32_t qa[2];
      load_a<LDA>(qa, qh, q0, lane);
      float sh0, sh1, num[4], den[4];
      if constexpr (EXACT) {
        row_max_tile<LDA>(sh0, sh1, qa, kh, L, Lp, lane);
      } else if constexpr (CUT == CUT_NOSHIFT) {
        sh0 = sh1 = 0.f;
      } else if constexpr (NATURAL) {
        sh0 = row_shift(qa[0], knorm, inv_temp);
        sh1 = row_shift(qa[1], knorm, inv_temp);
      } else {
        sh0 = row_shift2(qa[0], knorm, inv_temp);
        sh1 = row_shift2(qa[1], knorm, inv_temp);
      }
      if constexpr (CUT == CUT_THIN16) {  // the score product over channels 0..15
        if (warp >= 2)
          attend_tile<LDA, false, CUT_THIN16>(num, den, qa, kh, vh, keys, Lp, lane, scale2, sh0,
                                              sh1);
        else
          attend_tile<LDA, false>(num, den, qa, kh, vh, keys, Lp, lane, scale2, sh0, sh1);
      } else {
        attend_tile<LDA, EXACT, CUT>(num, den, qa, kh, vh, keys, Lp, lane, scale2, sh0, sh1);
      }
      uint32_t c0, c1;
      if constexpr (CUT == CUT_NODEN) {
        c0 = pack2(num[0], num[1]);
        c1 = pack2(num[2], num[3]);
      } else {
        const float d0 = CUT == CUT_DEN_PLUS ? __fadd_rn(den[0], DEN_MIN) : fmaxf(den[0], DEN_MIN);
        const float d1 = CUT == CUT_DEN_PLUS ? __fadd_rn(den[2], DEN_MIN) : fmaxf(den[2], DEN_MIN);
        c0 = pack2(__fdiv_rn(num[0], d0), __fdiv_rn(num[1], d0));
        c1 = pack2(__fdiv_rn(num[2], d1), __fdiv_rn(num[3], d1));
      }
      uint32_t* words =
          reinterpret_cast<uint32_t*>(qh) + (q0 + (lane >> 2)) * (LDA / 2) + (lane & 3);
      words[0] = c0;
      words[8 * (LDA / 2)] = c1;
      if constexpr (STORES) {
        const SlabLane s(q0, L, lane);
        bf16* o = st.ctx + warp * DK + s.c;
        if (s.ok0) *reinterpret_cast<uint32_t*>(o + (size_t)s.r0 * D) = c0;
        if (s.ok1) *reinterpret_cast<uint32_t*>(o + (size_t)s.r1 * D) = c1;
      }
    }
  }
  __syncthreads();
  if constexpr (CUT == CUT_STAGE) return;

  // ---- the tail's weights over k and v, which no warp reads any more
  stage_matrix(sm.w + SW_WF, LDA, w.wf, D, D, tid);
  if constexpr (CUT != CUT_NOFFN) {  // CUT_NOFFN: no FFN, so Wf alone
    stage_matrix(sm.w + SW_W2, LDA, w.w2, DFF, D, tid);
    stage_matrix(sm.w + SW_W1, LDW1, w.w1, D, DFF, tid);
  }
  __syncthreads();

  // ---- the tail, slab by slab
  for (int slab = warp * TILE; slab < Lp; slab += WARPS * TILE) {
    const SlabLane s(slab, L, lane);

    // z1 = (ctx Wf + bf)·s_a + x, then LN1
    float z[8][4], zh1[8][4], inv1[2];
    {
      uint32_t ca[4][4];
      load_a_slab<4, LDA>(ca, sm.q, slab, lane);
      zero_acc(z);
      mma_a_w<4, 8, LDA>(z, ca, sm.w + SW_WF, lane);
      uint32_t xp[8][2], sap[8][2];
      load_packed(xp, xb, ldx, s);
      if (SCALES && sab != nullptr) load_packed(sap, sab, D, s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 b = vec2(w.bf, j, s);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float o = __fadd_rn(z[j][i], half_f(b, i));
          if (SCALES && sab != nullptr) o = __fmul_rn(o, half_f(sap[j][i >> 1], i));
          z[j][i] = __fadd_rn(o, half_f(xp[j][i >> 1], i));
        }
      }
      ln_stats_slab(z, zh1, inv1);
    }
    if constexpr (CUT == CUT_NOFFN) {  // finish gets LN1's zhat and 1/sigma as LN2's
      const uint32_t relu_mask[N_CHUNKS] = {};
      const uint32_t sfp[8][2] = {};
      finish(s, zh1, inv1, zh1, inv1, relu_mask, sfp);
      continue;
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
      if constexpr (STORES) store_packed(st.h1c, D, hp, s);
    }

    // the hidden layer, a chunk of columns at a time, never out of registers
    float f2[8][4];
    zero_acc(f2);
    uint32_t relu_mask[N_CHUNKS];
#pragma unroll
    for (int ch = 0; ch < N_CHUNKS; ++ch) {
      float pre[8][4];
      zero_acc(pre);
      mma_a_w<4, 8, LDW1>(pre, ha, sm.w + SW_W1 + FFN_CHUNK * ch, lane);
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
      if constexpr (STORES) store_packed(st.f1 + FFN_CHUNK * ch, DFF, fp, s);
      mma_a_w<4, 8, LDA>(f2, fa, sm.w + SW_W2 + FFN_CHUNK * ch * LDA, lane);
    }

    // z2 = (f1 W2 + b2)·s_f + h1, then LN2
    float zh2[8][4], inv2[2];
    uint32_t sfp[8][2];
    if (SCALES && sfb != nullptr) load_packed(sfp, sfb, D, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b = vec2(w.b2, j, s), sc = vec2(w.ln1s, j, s), hb = vec2(w.ln1b, j, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float f = __fadd_rn(f2[j][i], half_f(b, i));
        if (SCALES && sfb != nullptr) f = __fmul_rn(f, half_f(sfp[j][i >> 1], i));
        // h1 in f32 again, the bits that were cast for the FFN
        f2[j][i] = __fadd_rn(f, __fadd_rn(__fmul_rn(zh1[j][i], half_f(sc, i)), half_f(hb, i)));
      }
    }
    ln_stats_slab(f2, zh2, inv2);
    finish(s, zh1, inv1, zh2, inv2, relu_mask, sfp);
  }
}

}  // namespace s2s
