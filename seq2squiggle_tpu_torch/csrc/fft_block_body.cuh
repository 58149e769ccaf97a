// One post-LN FFT block for one batch row, as device functions: the body that
// fft_block.cu's one-block and two-block kernels and fft_block_variants.cu's
// profiling kernels all call.
//
//   q/k/v = cast(x Wq + bq) ...   (compute-dtype operands, f32 accumulation)
//   ctx   = softmax(q kᵀ / √d_k) v   per head, 8 heads of d_k = 8
//   h1    = LN1(ctx Wf + bf + x)     (f32 statistics, f32 result)
//   out   = LN2(relu(cast(h1) W1 + b1) W2 + b2 + h1)
//
// A thread block of THREADS threads runs the stages in turn over shared
// memory: project_qkv (q, k, v of the whole row into three L x 64 buffers),
// the attention (one (head, query) item per thread, the (L, L) scores
// recomputed per query and never stored, ctx written over q), block_tail
// (fc + LN1 + FFN + LN2, one row per warp, the 256-wide hidden layer in one
// 256-entry buffer per warp). The ~49k weights are read through L1/L2, shared
// by every block. Input, residual and output rows are plain pointers: device
// memory for the one-block kernel, shared memory between the two blocks of
// the pair kernel. Every loop is bounded by L, so ragged L needs no padding.
//
// The softmax form is an argument: the exact row max (one more pass over the
// keys) or the per-head Cauchy–Schwarz bound ‖q_t‖·max_s‖k_s‖/√d_k; both are
// attn_common.cuh's attend_query. (As a template argument it ran no faster.)

#pragma once

#include "attn_common.cuh"

namespace s2s {

constexpr int DFF = 256;  // FFN width
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float LN_EPS = 1e-5f;
constexpr int TAIL_STAGE = 32;  // weights loaded ahead of their FMAs in block_tail

static_assert(WARPS == H, "the k-norm reduction uses one warp per head");

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

// The block's shared memory: q (then ctx, then cast(h1)), k, v, the hidden
// rows of the eight warps, max_s ‖k_s‖ per head; `rest` is what follows.
template <typename T>
struct BlockSmem {
  T* q; T* k; T* v; T* hid; float* kn; unsigned char* rest;
};

template <typename T>
__device__ __forceinline__ BlockSmem<T> carve_smem(unsigned char* smem, int L) {
  BlockSmem<T> s;
  s.q = reinterpret_cast<T*>(smem);
  s.k = s.q + (size_t)L * D;
  s.v = s.k + (size_t)L * D;
  s.hid = s.v + (size_t)L * D;
  s.kn = reinterpret_cast<float*>(s.hid + WARPS * DFF);
  s.rest = reinterpret_cast<unsigned char*>(s.kn + H);
  return s;
}

// Bytes of BlockSmem for sequence length L, plus `extra_rows` more L x 64
// compute-dtype buffers after it. ops/fft_block.py::shared_memory_bytes is the
// Python twin (extra_rows = 0), checked by the wrapper before a launch: change
// both together.
template <typename T>
inline size_t block_smem_bytes(int L, int extra_rows = 0) {
  return (3 + (size_t)extra_rows) * L * D * sizeof(T) + (size_t)WARPS * DFF * sizeof(T) +
         H * sizeof(float);
}

// LayerNorm of the 64 values held two per lane (columns lane, lane + 32).
__device__ __forceinline__ void layer_norm2(float& v0, float& v1, const float* scale,
                                            const float* bias, int lane) {
  const float mean = __fdiv_rn(warp_sum(__fadd_rn(v0, v1)), (float)D);
  const float d0 = __fsub_rn(v0, mean), d1 = __fsub_rn(v1, mean);
  const float var =
      __fdiv_rn(warp_sum(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1))), (float)D);
  const float rs = rsqrtf(__fadd_rn(var, LN_EPS));
  v0 = __fadd_rn(__fmul_rn(__fmul_rn(d0, rs), scale[lane]), bias[lane]);
  v1 = __fadd_rn(__fmul_rn(__fmul_rn(d1, rs), scale[lane + 32]), bias[lane + 32]);
}

// q, k, v projections of the L rows at xb: column j, rows tr, tr + 4, tr + 8,
// tr + 12 of each 16-row slab (x rows are warp broadcasts, weight columns
// coalesced). The caller synchronises before reading sQ, sK, sV.
template <typename T>
__device__ __forceinline__ void project_qkv(const T* xb, const BlockWeights<T>& w, int L,
                                            T* sQ, T* sK, T* sV) {
  const int tid = threadIdx.x;
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
        sQ[t * D + j] = from_f<T>(__fadd_rn(aq[m], bq));
        sK[t * D + j] = from_f<T>(__fadd_rn(ak[m], bk));
        sV[t * D + j] = from_f<T>(__fadd_rn(av[m], bv));
      }
    }
  }
}

// Per head, max over keys of ‖k_s‖ (warp = head) into sKn: the key half of
// the Cauchy–Schwarz shift. The caller synchronises before reading sKn.
template <typename T>
__device__ __forceinline__ void max_key_norms(const T* sK, int L, float* sKn) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float kn = warp_max_knorm<T, D>(sK + warp * DK, L, lane);
  if (lane == 0) sKn[warp] = kn;
}

// fc + LN1(· + residual) + FFN + LN2, one row per warp; lane holds columns
// lane and lane + 32 of the 64-wide rows and 8 of the 256 hidden units. ctx
// is read from sQ, which then holds cast(h1); the result goes to ob.
template <typename T>
__device__ __forceinline__ void block_tail(const T* res, T* ob, const BlockWeights<T>& w,
                                           int L, T* sQ, T* sHid) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* hid = sHid + warp * DFF;
  for (int t = warp; t < L; t += WARPS) {
    T* row = sQ + t * D;
    // Each product below first loads TAIL_STAGE weights into registers, then
    // runs their FMAs (in the same order per accumulator as a plain loop, so
    // the bits do not depend on it): the loads, served by L1/L2, are then in
    // flight together. Left as plain loops, where the compiler put them
    // changed with unrelated edits and moved the bf16 block's time by a tenth.
    float o0 = 0.f, o1 = 0.f;
    for (int c0 = 0; c0 < D; c0 += TAIL_STAGE / 2) {
      T wa[TAIL_STAGE / 2], wb[TAIL_STAGE / 2];
#pragma unroll
      for (int i = 0; i < TAIL_STAGE / 2; ++i) {
        wa[i] = w.wf[(c0 + i) * D + lane];
        wb[i] = w.wf[(c0 + i) * D + lane + 32];
      }
#pragma unroll
      for (int i = 0; i < TAIL_STAGE / 2; ++i) {
        const float cv = to_f(row[c0 + i]);
        o0 = fmaf(cv, to_f(wa[i]), o0);
        o1 = fmaf(cv, to_f(wb[i]), o1);
      }
    }
    o0 = __fadd_rn(__fadd_rn(o0, w.bf[lane]), to_f(res[t * D + lane]));
    o1 = __fadd_rn(__fadd_rn(o1, w.bf[lane + 32]), to_f(res[t * D + lane + 32]));
    layer_norm2(o0, o1, w.ln1s, w.ln1b, lane);  // o0, o1 now hold h1 (f32)
    __syncwarp();
    row[lane] = from_f<T>(o0);
    row[lane + 32] = from_f<T>(o1);
    __syncwarp();

    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j0 = 0; j0 < D; j0 += TAIL_STAGE / 8) {
      T ws[TAIL_STAGE / 8][8];
#pragma unroll
      for (int i = 0; i < TAIL_STAGE / 8; ++i)
#pragma unroll
        for (int m = 0; m < 8; ++m) ws[i][m] = w.w1[(j0 + i) * DFF + lane + 32 * m];
#pragma unroll
      for (int i = 0; i < TAIL_STAGE / 8; ++i) {
        const float hv = to_f(row[j0 + i]);
#pragma unroll
        for (int m = 0; m < 8; ++m) a[m] = fmaf(hv, to_f(ws[i][m]), a[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < 8; ++m)
      hid[lane + 32 * m] = from_f<T>(fmaxf(__fadd_rn(a[m], w.b1[lane + 32 * m]), 0.f));
    __syncwarp();

    float f0 = 0.f, f1 = 0.f;
    for (int n0 = 0; n0 < DFF; n0 += TAIL_STAGE / 2) {
      T wa[TAIL_STAGE / 2], wb[TAIL_STAGE / 2];
#pragma unroll
      for (int i = 0; i < TAIL_STAGE / 2; ++i) {
        wa[i] = w.w2[(n0 + i) * D + lane];
        wb[i] = w.w2[(n0 + i) * D + lane + 32];
      }
#pragma unroll
      for (int i = 0; i < TAIL_STAGE / 2; ++i) {
        const float hv = to_f(hid[n0 + i]);
        f0 = fmaf(hv, to_f(wa[i]), f0);
        f1 = fmaf(hv, to_f(wb[i]), f1);
      }
    }
    f0 = __fadd_rn(__fadd_rn(f0, w.b2[lane]), o0);
    f1 = __fadd_rn(__fadd_rn(f1, w.b2[lane + 32]), o1);
    layer_norm2(f0, f1, w.ln2s, w.ln2b, lane);
    ob[t * D + lane] = from_f<T>(f0);
    ob[t * D + lane + 32] = from_f<T>(f1);
    __syncwarp();  // hid is rewritten by the next row
  }
}

// The whole block: L rows at `in` (residual rows at `res`) -> L rows at `ob`.
// `exact` picks the exact row max, else the Cauchy–Schwarz shift. Every
// thread of the block calls it. The three pointers may lie in device or
// shared memory, and `ob` may be the rows of `in` and `res`: every input row
// is read before the first synchronisation, and a row's residual is read by
// the warp that then writes that row.
template <typename T>
__device__ __forceinline__ void fft_block_body(const T* in, const T* res, T* ob,
                                               const BlockWeights<T>& w, int L, float inv_temp,
                                               bool exact, const BlockSmem<T>& s) {
  project_qkv(in, w, L, s.q, s.k, s.v);
  __syncthreads();

  if (!exact) max_key_norms(s.k, L, s.kn);
  __syncthreads();

  // attention: one (head, query) item per thread; a warp shares the head, so
  // each k/v row read is a shared-memory broadcast.
  for (int it = threadIdx.x; it < H * L; it += THREADS) {
    const int h = it / L;
    const int t = it - h * L;
    float q[DK], num[DK], den;
    load8(s.q + t * D + h * DK, q);
    const float shift = exact ? 0.f : cs_shift(q, s.kn[h], inv_temp);
    attend_query<T, D>(q, s.k + h * DK, s.v + h * DK, L, inv_temp, exact, shift, num, den);
    // q[t, h] is read only by this item, so ctx overwrites it in place.
#pragma unroll
    for (int c = 0; c < DK; ++c) s.q[t * D + h * DK + c] = from_f<T>(__fdiv_rn(num[c], den));
  }
  __syncthreads();

  block_tail(res, ob, w, L, s.q, s.hid);
}

constexpr int MAX_DEVICES = 64;

// Opts a kernel into the device's largest dynamic shared memory, once per
// device (the attribute belongs to the device's context); each launch then
// asks for the size its L needs. One SharedMemoryOptIn per kernel; two
// threads racing here both set the same value. `limit` receives that size.
struct SharedMemoryOptIn {
  int limit[MAX_DEVICES] = {};
};

template <typename K>
inline cudaError_t opt_in_shared_memory(K kernel, SharedMemoryOptIn& state, size_t* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && state.limit[dev] > 0) {
    *limit = (size_t)state.limit[dev];
    return cudaSuccess;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES) state.limit[dev] = optin;
  *limit = (size_t)optin;
  return cudaSuccess;
}

}  // namespace s2s
