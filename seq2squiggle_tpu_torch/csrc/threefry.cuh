// Threefry-2x32 counter-based random numbers on the card, draw for draw with
// jax.random: the device twins of seq2squiggle_tpu_torch/prng.py (threefry2x32,
// fold_in, split, random_bits, uniform, normal with XLA's erfinv, XLA's f32
// log and log1p) and of sampling.py::sample_gamma, one element per call.
//
// Numerics are prng.py's, op for op, in native uint32 (no masking):
//   - each f32 multiply, add, divide and square root that prng.py rounds on
//     its own is an _rn intrinsic, which the compiler never contracts into an
//     FMA; __fmaf_rn stands exactly where prng.py calls prng.fma (its f64
//     emulation of XLA's contracted multiply-add);
//   - square roots and divisions are IEEE (__fsqrt_rn, __fdiv_rn, __frcp_rn);
//   - exp is expf, torch.exp's own on the card;
//   - the constants are prng.py's, rounded to f32 as it rounds them, written
//     as hex floats (tests/test_torch_port_sampling.py holds them against it).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace s2s {
namespace threefry {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// One Threefry-2x32-20 block of the counter (x0, x1) under `key`.
__device__ __forceinline__ Key threefry2x32(Key key, uint32_t x0, uint32_t x1) {
  const uint32_t k0 = key.k0, k1 = key.k1, k2 = key.k0 ^ key.k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  mix4<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  mix4<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  mix4<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
  return {x0, x1};
}

// jax.random.fold_in(key, d); d an int32 wraps to uint32 as in jax.
__device__ __forceinline__ Key fold_in(Key key, uint32_t d) { return threefry2x32(key, 0u, d); }

// jax.random.split(key, n)[i].
__device__ __forceinline__ Key split(Key key, uint32_t i) { return threefry2x32(key, 0u, i); }

// The i-th 32-bit word of jax.random.bits(key, shape) (row-major flat index i).
__device__ __forceinline__ uint32_t random_bits(Key key, uint32_t i) {
  const Key o = threefry2x32(key, 0u, i);
  return o.k0 ^ o.k1;
}

// jax.random.uniform's value for one word of bits, in [lo, hi).
__device__ __forceinline__ float uniform(uint32_t bits, float lo, float hi) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float v = __fmaf_rn(f, __fsub_rn(hi, lo), lo);
  return v < lo ? lo : v;
}

// XLA's f32 log on the CPU (Cephes/Eigen plog with FMA contraction), for
// positive normal x: prng.log_xla.
__device__ __forceinline__ float log_xla(float x) {
  const int xi = __float_as_int(x);
  float e = __fsub_rn((float)((xi >> 23) & 0xFF), 126.0f);
  float m = __int_as_float((xi & ~0x7F800000) | 0x3F000000);
  const bool small = m < 0x1.6a09e6p-1f;  // sqrt(1/2)
  const float tmp = small ? m : 0.0f;
  m = __fsub_rn(m, 1.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  m = __fadd_rn(m, tmp);
  const float x2 = __fmul_rn(m, m);
  const float x3 = __fmul_rn(x2, m);
  float y = __fmaf_rn(m, 0x1.204376p-4f, -0x1.d7a370p-4f);
  float y1 = __fmaf_rn(m, -0x1.fcba9ep-4f, 0x1.23d37ep-3f);
  float y2 = __fmaf_rn(m, 0x1.999d58p-3f, -0x1.fffff8p-3f);
  y = __fmaf_rn(y, m, 0x1.de4a34p-4f);
  y1 = __fmaf_rn(y1, m, -0x1.555ca0p-3f);
  y2 = __fmaf_rn(y2, m, 0x1.555554p-2f);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(e, -0x1.bd0106p-13f));
  m = __fmaf_rn(x2, -0.5f, m);
  m = __fadd_rn(m, y);
  return __fmaf_rn(e, 0x1.630000p-1f, m);
}

// XLA's f32 log1p: the Cephes rational for |x| < sqrt(2) - 1, else
// log(1 + x): prng.log1p_xla (the branch not taken is not computed).
__device__ __forceinline__ float log1p_xla(float x) {
  if (!(fabsf(x) < 0x1.a8279ap-2f)) return log_xla(__fadd_rn(x, 1.0f));
  float num = 0x1.7bc096p-15f;
  num = __fmaf_rn(num, x, 0x1.fe818ap-2f);
  num = __fmaf_rn(num, x, 0x1.a509f4p+2f);
  num = __fmaf_rn(num, x, 0x1.de9738p+4f);
  num = __fmaf_rn(num, x, 0x1.e798ecp+5f);
  num = __fmaf_rn(num, x, 0x1.c8e75ap+5f);
  num = __fmaf_rn(num, x, 0x1.40a202p+4f);
  float den = 1.0f;
  den = __fmaf_rn(den, x, 0x1.e2035ap+3f);
  den = __fmaf_rn(den, x, 0x1.4c30b6p+6f);
  den = __fmaf_rn(den, x, 0x1.bb865ap+7f);
  den = __fmaf_rn(den, x, 0x1.351946p+8f);
  den = __fmaf_rn(den, x, 0x1.b0db14p+7f);
  den = __fmaf_rn(den, x, 0x1.e0f304p+5f);
  const float x2 = __fmul_rn(x, x);
  const float r = __fdiv_rn(num, den);
  return __fadd_rn(x, __fmaf_rn(x2, -0.5f, __fmul_rn(__fmul_rn(x, x2), r)));
}

// XLA's single-precision erfinv (Giles' polynomial), |x| < 1: prng.erfinv_xla.
__device__ __forceinline__ float erfinv_xla(float x) {
  float w = -log1p_xla(__fmul_rn(-x, x));
  const bool s = w < 5.0f;
  w = s ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = s ? 0x1.e2cb10p-26f : -0x1.a3e136p-13f;
  p = __fmaf_rn(p, w, s ? 0x1.70966cp-22f : 0x1.a76ad6p-14f);
  p = __fmaf_rn(p, w, s ? -0x1.d8e6aep-19f : 0x1.61b8e4p-10f);
  p = __fmaf_rn(p, w, s ? -0x1.26b582p-18f : -0x1.e17bcep-9f);
  p = __fmaf_rn(p, w, s ? 0x1.ca65b6p-13f : 0x1.7824f6p-8f);
  p = __fmaf_rn(p, w, s ? -0x1.48a810p-10f : -0x1.f38baep-8f);
  p = __fmaf_rn(p, w, s ? -0x1.11c9dep-8f : 0x1.354afcp-7f);
  p = __fmaf_rn(p, w, s ? 0x1.f91ec6p-3f : 0x1.006db6p+0f);
  p = __fmaf_rn(p, w, s ? 0x1.805c5ep+0f : 0x1.6a9efcp+1f);
  return __fmul_rn(p, x);
}

// jax.random.normal's value for one word of bits: sqrt(2) *
// erfinv(uniform(bits, nextafter(-1, 0), 1)).
__device__ __forceinline__ float normal(uint32_t bits) {
  return __fmul_rn(0x1.6a09e6p+0f, erfinv_xla(uniform(bits, -0x1.fffffep-1f, 1.0f)));
}

constexpr int GAMMA_ROUNDS = 8;         // sampling._GAMMA_ROUNDS
constexpr float UNIFORM_LO = 0x1.1039d4p-123f;  // f32(1e-37), the Gamma uniforms' lower end
constexpr float FLT_MIN_F32 = 0x1p-126f;

// Gamma(a, 1) for element k of the row whose key is `key`:
// sampling.sample_gamma's draw. Round i draws its proposal from
// split(fold_in(key, i)) = (normal key, uniform key) at counter k and the
// first accepted round is kept (later ones never change the result, so the
// loop stops there); a row that never accepts keeps d. a < 1 takes the boost
// G_a = G_{a+1} * U^(1/a) in log space with key fold_in(key, 8). Results
// below FLT_MIN flush to 0, as XLA's do.
__device__ __forceinline__ float gamma_draw(Key key, uint32_t k, float a) {
  const bool boost = a < 1.0f;
  const float a_eff = boost ? __fadd_rn(a, 1.0f) : a;
  const float d = __fsub_rn(a_eff, 0x1.555556p-2f);  // f32(1/3)
  const float c = __frcp_rn(__fsqrt_rn(__fmul_rn(9.0f, d)));
  float sample = d;
  for (int i = 0; i < GAMMA_ROUNDS; ++i) {
    const Key round_key = fold_in(key, (uint32_t)i);
    const float x = normal(random_bits(split(round_key, 0u), k));
    const float t = __fmaf_rn(c, x, 1.0f);
    const float v = __fmul_rn(__fmul_rn(t, t), t);
    if (!(v > 0.0f)) continue;
    const float u = uniform(random_bits(split(round_key, 1u), k), UNIFORM_LO, 1.0f);
    const float bound = __fadd_rn(__fmul_rn(__fmul_rn(0.5f, x), x),
                                  __fmul_rn(d, __fadd_rn(__fsub_rn(1.0f, v), log_xla(v))));
    if (log_xla(u) < bound) {
      sample = __fmul_rn(d, v);
      break;
    }
  }
  float log_sample = log_xla(sample);
  if (boost) {
    const float u = uniform(random_bits(fold_in(key, (uint32_t)GAMMA_ROUNDS), k), UNIFORM_LO, 1.0f);
    log_sample = __fadd_rn(log_sample, __fdiv_rn(log_xla(u), a));
  }
  const float g = expf(log_sample);
  return g < FLT_MIN_F32 ? 0.0f : g;
}

}  // namespace threefry
}  // namespace s2s
