// Tensor-core building blocks shared by the port's bf16 kernels (attn_core.cu,
// the training attention core; block_train.cu, the whole-block training
// kernels): `mma.sync` steps with f32 sums, `ldmatrix` fragment loads from
// shared memory, products of a warp's 16-row slab against a weight tile in
// shared memory, epilogue helpers on accumulator fragments, and the attention
// sweep of 16 queries over all keys of one head.
//
// Fragment layouts of mma.sync.m16n8k16 (bf16 operands, f32 sums). Lane l has
// g = l / 4 and c = 2·(l % 4):
//   A, 16 x 16   a[0] rows g, a[1] rows g + 8, columns c, c + 1; a[2], a[3]
//                the same rows, columns c + 8, c + 9
//   B, 16 x 8    b0 rows c, c + 1 and b1 rows c + 8, c + 9 of column g
//   C/D, 16 x 8  d[0], d[1] row g and d[2], d[3] row g + 8, columns c, c + 1
// So two neighbouring 16 x 8 accumulator tiles, rounded to bf16 in pairs, ARE
// one A operand (`pack_a`): a product's result feeds the next product without
// a trip through shared memory. A slab's 64-wide row lies 16 values to a lane
// across a quad, so row statistics join with two shuffles (`quad_sum`).
//
// "Packed" layout of a 16 x 64 bf16 slab: p[j][0] = row g, p[j][1] = row g + 8,
// columns 8j + c, c + 1 as one 32-bit word, j = 0..7: the accumulator layout
// after rounding, what a lane reads from and writes to a (rows, 64) tensor.
//
// Shared-memory rows of 128 bytes would put the 8 rows of one `ldmatrix` on
// the same banks: row strides here are 16 bytes more than a multiple of 128
// (72 values for a 64-wide row, 264 for a 256-wide one), which spreads them
// over all 32 banks.

#pragma once

#include "attn_common.cuh"

#include <cstdint>

namespace s2s {

using bf16 = __nv_bfloat16;

// Two choices of the attention sweep made by measurement
// (scripts/profile_torch_attn_core.py builds attn_core.cu with the other
// values and times them in turns; PERF.md has the numbers): the exp as
// ex2.approx on base-2 exponents (1: libm's expf on natural ones, the same in
// the forward and both sweeps of the backward).
#ifndef S2S_ATTN_CORE_EXPF
#define S2S_ATTN_CORE_EXPF 0
#endif

constexpr int TILE = 16;                  // rows a warp owns; keys per step
// exponents are kept in units of 1/EXP_UNIT: base 2 for ex2.approx
constexpr float EXP_UNIT = S2S_ATTN_CORE_EXPF ? 1.f : 1.4426950408889634f;
constexpr uint32_t ONES2 = 0x3F803F80u;   // two bf16 ones

__host__ __device__ inline int pad_tile(int L) { return (L + TILE - 1) / TILE * TILE; }

// D += A·B, A 16 x 8 (row), B 8 x 8 (col), bf16 operands, f32 sums. Lane l
// holds, with g = l / 4 and c = 2·(l % 4): A rows g (a[0]) and g + 8 (a[1]),
// columns c, c + 1; B rows c, c + 1 of column g; D rows g (d[0], d[1]) and
// g + 8 (d[2], d[3]), columns c, c + 1.
__device__ __forceinline__ void mma_k8(float d[4], const uint32_t a[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// D += A·B, A 16 x 16, B 16 x 8: a[0], a[1] as above for columns 0..7, a[2],
// a[3] the same rows for columns 8..15; b0 rows c, c + 1 and b1 rows c + 8,
// c + 9 of column g.
__device__ __forceinline__ void mma_k16(float d[4], const uint32_t a[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sixteen rows of a head's slice in shared memory (16 bytes each, LD values
// apart) as two 8 x 8 fragments: r0 from rows row0..row0+7, r1 from the next
// eight. Plain: lane l gets columns c, c + 1 of row g (the B operand of a
// product over the 8 channels, or the rows' own values). Transposed: rows c,
// c + 1 of column g (the B operand of a product over the 16 rows).
template <int LD = DK>
__device__ __forceinline__ void load_rows(uint32_t& r0, uint32_t& r1, const bf16* slice,
                                          int row0, int lane) {
  const uint32_t addr =
      (uint32_t)__cvta_generic_to_shared(slice + (row0 + (lane & 15)) * LD);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}
template <int LD = DK>
__device__ __forceinline__ void load_rows_t(uint32_t& r0, uint32_t& r1, const bf16* slice,
                                            int row0, int lane) {
  const uint32_t addr =
      (uint32_t)__cvta_generic_to_shared(slice + (row0 + (lane & 15)) * LD);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// The A operand of m16n8k8 for rows row0..row0+15 of a slice.
template <int LD = DK>
__device__ __forceinline__ void load_a(uint32_t a[2], const bf16* slice, int row0, int lane) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(slice) +
                      (row0 + (lane >> 2)) * (LD / 2) + (lane & 3);
  a[0] = w[0];
  a[1] = w[8 * (LD / 2)];
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float lo_f(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float ex2(float x) {
#if S2S_ATTN_CORE_EXPF
  return expf(x);
#else
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
#endif
}

// Two neighbouring values of e = exp(s/√d_k − shift), rounded to bf16 and
// packed: 2^(s·scale2 − shift2) with scale2 = log2(e)/√d_k and shift2 =
// log2(e)·shift. The one place the kernels evaluate the exp: forward and both
// sweeps of the backward go through it.
__device__ __forceinline__ uint32_t exp_pair(float s0, float s1, float scale2, float shift2_0,
                                             float shift2_1) {
  return pack2(ex2(fmaf(s0, scale2, -shift2_0)), ex2(fmaf(s1, scale2, -shift2_1)));
}

// log2(e)·(the Cauchy–Schwarz shift) of the row whose channels c, c + 1 this
// lane holds in `pair` (the quad holds the row's eight).
__device__ __forceinline__ float row_shift2(uint32_t pair, float knorm, float inv_temp) {
  const float lo = lo_f(pair), hi = hi_f(pair);
  const float n2 = quad_sum(fmaf(hi, hi, __fmul_rn(lo, lo)));
  return __fmul_rn(__fmul_rn(__fmul_rn(sqrtf(n2), knorm), inv_temp), EXP_UNIT);
}

// e for the 16 queries of A operand `qa` against keys s0..s0+15, as the A
// operand of m16n8k16 (queries x keys); keys >= L give 0. sh0, sh1: shift2 of
// query rows g and g + 8.
template <int LD = DK>
__device__ __forceinline__ void exp_block_rows(uint32_t e[4], const uint32_t qa[2],
                                               const bf16* sK, int s0, int L, int lane,
                                               float scale2, float sh0, float sh1) {
  uint32_t kb0, kb1;
  load_rows<LD>(kb0, kb1, sK, s0, lane);
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  mma_k8(c0, qa, kb0);
  mma_k8(c1, qa, kb1);
  e[0] = exp_pair(c0[0], c0[1], scale2, sh0, sh0);
  e[1] = exp_pair(c0[2], c0[3], scale2, sh1, sh1);
  e[2] = exp_pair(c1[0], c1[1], scale2, sh0, sh0);
  e[3] = exp_pair(c1[2], c1[3], scale2, sh1, sh1);
  if (s0 + TILE > L) {  // the ragged last step: a zero key would give exp(−shift)
    const int key = s0 + 2 * (lane & 3);
    const uint32_t m0 = (key < L ? 0x0000ffffu : 0u) | (key + 1 < L ? 0xffff0000u : 0u);
    const uint32_t m1 = (key + 8 < L ? 0x0000ffffu : 0u) | (key + 9 < L ? 0xffff0000u : 0u);
    e[0] &= m0; e[1] &= m0; e[2] &= m1; e[3] &= m1;
  }
}

// num = Σ e·v and den = Σ e (not yet clamped) of the 16 queries of `qa` over
// all keys: rows g in [0], [1] and g + 8 in [2], [3]; den the same in both
// columns.
template <int LD = DK>
__device__ __forceinline__ void attend_tile(float num[4], float den[4], const uint32_t qa[2],
                                            const bf16* sK, const bf16* sV, int L, int Lp,
                                            int lane, float scale2, float sh0, float sh1) {
#pragma unroll
  for (int i = 0; i < 4; ++i) num[i] = den[i] = 0.f;
  for (int s0 = 0; s0 < Lp; s0 += TILE) {
    uint32_t e[4], vt0, vt1;
    exp_block_rows<LD>(e, qa, sK, s0, L, lane, scale2, sh0, sh1);
    load_rows_t<LD>(vt0, vt1, sV, s0, lane);
    mma_k16(num, e, vt0, vt1);
    mma_k16(den, e, ONES2, ONES2);
  }
}

// ---- a warp's 16-row slab against a weight tile in shared memory -------------

// Four 8 x 8 matrices at once: lane l gives the address of row l % 8 of
// matrix l / 8 (16 bytes, 16-byte aligned); r[i] is this lane's word of
// matrix i (plain: row g, columns c, c + 1; .trans: rows c, c + 1, column g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The A operands of a slab in shared memory: rows row0..row0+15 (LD values
// apart), columns 0..16·KT-1.
template <int KT, int LD>
__device__ __forceinline__ void load_a_slab(uint32_t (&a)[KT][4], const bf16* rows, int row0,
                                            int lane) {
  const bf16* p = rows + (row0 + (lane & 15)) * LD + 8 * (lane >> 4);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) ldmatrix_x4(a[kt], p + 16 * kt);
}

// acc += A·W for a weight stored (in, out) row-major in shared memory, rows
// LD values apart: w points at W[k0][n0]; A covers the depth k0..k0+16·KT-1,
// acc the columns n0..n0+8·NT-1. W's rows run along the depth, so the B
// operand is the `.trans` load.
template <int KT, int NT, int LD>
__device__ __forceinline__ void mma_a_w(float (&acc)[NT][4], const uint32_t (&a)[KT][4],
                                        const bf16* w, int lane) {
  static_assert(NT % 2 == 0, "column tiles are loaded in pairs");
  const bf16* p = w + (lane & 15) * LD + 8 * (lane >> 4);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, p + kt * 16 * LD + nt * 8);
      mma_k16(acc[nt], a[kt], b[0], b[1]);
      mma_k16(acc[nt + 1], a[kt], b[2], b[3]);
    }
}

// acc += A·Wᵀ for the same storage: w points at W[n0][k0]; acc column n is W's
// row n0 + n, the depth runs along W's rows, so the B operand is the plain
// load. This is the backward's g·Wᵀ on the forward's copy of W: no transposed
// copy exists.
template <int KT, int NT, int LD>
__device__ __forceinline__ void mma_a_wt(float (&acc)[NT][4], const uint32_t (&a)[KT][4],
                                         const bf16* w, int lane) {
  static_assert(NT % 2 == 0, "column tiles are loaded in pairs");
  const bf16* p = w + ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, p + nt * 8 * LD + kt * 16);
      mma_k16(acc[nt], a[kt], b[0], b[1]);
      mma_k16(acc[nt + 1], a[kt], b[2], b[3]);
    }
}

// ---- epilogues on accumulator fragments -------------------------------------

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// Accumulator tiles rounded to bf16 in pairs: the packed layout.
template <int NT>
__device__ __forceinline__ void pack_acc(uint32_t (&p)[NT][2], const float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    p[j][0] = pack2(acc[j][0], acc[j][1]);
    p[j][1] = pack2(acc[j][2], acc[j][3]);
  }
}
template <int NT>
__device__ __forceinline__ void unpack_acc(float (&acc)[NT][4], const uint32_t (&p)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] = lo_f(p[j][0]);
    acc[j][1] = hi_f(p[j][0]);
    acc[j][2] = lo_f(p[j][1]);
    acc[j][3] = hi_f(p[j][1]);
  }
}

// A packed slab as the A operands of a product over its columns.
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NT / 2][4], const uint32_t (&p)[NT][2]) {
#pragma unroll
  for (int t = 0; t < NT / 2; ++t) {
    a[t][0] = p[2 * t][0];
    a[t][1] = p[2 * t][1];
    a[t][2] = p[2 * t + 1][0];
    a[t][3] = p[2 * t + 1][1];
  }
}

// This lane's rows and columns of a slab that starts at row `slab` of a
// sequence of L rows.
struct SlabLane {
  int r0, r1, c;   // rows slab + g and slab + g + 8; first column within a tile
  bool ok0, ok1;   // the rows exist (< L)
  __device__ __forceinline__ SlabLane(int slab, int L, int lane)
      : r0(slab + (lane >> 2)), r1(r0 + 8), c(2 * (lane & 3)), ok0(r0 < L), ok1(r1 < L) {}
};

// A packed slab from / to rows of `ld` bf16 values (device or shared memory),
// `t` at the slab's sequence and first column; rows >= L read as 0 and are
// not written.
template <int NT>
__device__ __forceinline__ void load_packed(uint32_t (&p)[NT][2], const bf16* t, int ld,
                                            const SlabLane& s) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    p[j][0] = s.ok0 ? *reinterpret_cast<const uint32_t*>(t + (size_t)s.r0 * ld + 8 * j + s.c) : 0u;
    p[j][1] = s.ok1 ? *reinterpret_cast<const uint32_t*>(t + (size_t)s.r1 * ld + 8 * j + s.c) : 0u;
  }
}
template <int NT>
__device__ __forceinline__ void store_packed(bf16* t, int ld, const uint32_t (&p)[NT][2],
                                             const SlabLane& s) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (s.ok0) *reinterpret_cast<uint32_t*>(t + (size_t)s.r0 * ld + 8 * j + s.c) = p[j][0];
    if (s.ok1) *reinterpret_cast<uint32_t*>(t + (size_t)s.r1 * ld + 8 * j + s.c) = p[j][1];
  }
}
// f32 accumulator tiles from / to rows of `ld` floats, the same way.
template <int NT>
__device__ __forceinline__ void load_acc(float (&acc)[NT][4], const float* t, int ld,
                                         const SlabLane& s) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 z = make_float2(0.f, 0.f);
    const float2 a = s.ok0 ? *reinterpret_cast<const float2*>(t + (size_t)s.r0 * ld + 8 * j + s.c) : z;
    const float2 b = s.ok1 ? *reinterpret_cast<const float2*>(t + (size_t)s.r1 * ld + 8 * j + s.c) : z;
    acc[j][0] = a.x; acc[j][1] = a.y; acc[j][2] = b.x; acc[j][3] = b.y;
  }
}
template <int NT>
__device__ __forceinline__ void store_acc(float* t, int ld, const float (&acc)[NT][4],
                                          const SlabLane& s) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (s.ok0)
      *reinterpret_cast<float2*>(t + (size_t)s.r0 * ld + 8 * j + s.c) = make_float2(acc[j][0], acc[j][1]);
    if (s.ok1)
      *reinterpret_cast<float2*>(t + (size_t)s.r1 * ld + 8 * j + s.c) = make_float2(acc[j][2], acc[j][3]);
  }
}

// The two entries of an f32 vector (a bias, a LayerNorm scale) over this
// lane's columns of tile j.
__device__ __forceinline__ float2 vec2(const float* v, int j, const SlabLane& s) {
  return __ldg(reinterpret_cast<const float2*>(v + 8 * j + s.c));
}

// Sums over the slab's rows (those < L) of f(j, i), the value at tile j and
// fragment entry i, for each of the 64 columns, in a fixed order: the lane's
// two rows, then lanes 4, 8 and 16 apart. Lane (g, c) keeps the two sums of
// tile g (columns 8g + c, c + 1) and adds them to keep[0], keep[1].
template <typename F>
__device__ __forceinline__ void add_column_sums(float keep[2], const SlabLane& s, int lane,
                                                F f) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s0 = (s.ok0 ? f(j, 0) : 0.f) + (s.ok1 ? f(j, 2) : 0.f);
    float s1 = (s.ok0 ? f(j, 1) : 0.f) + (s.ok1 ? f(j, 3) : 0.f);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (j == (lane >> 2)) {
      keep[0] += s0;
      keep[1] += s1;
    }
  }
}

}  // namespace s2s
