// Fused post-LN FFT block for Hopper (sm_90a): the port of the Pallas kernel
// seq2squiggle_tpu/ops/pallas/fft_block.py::fused_fft_block.
//
// One thread block runs one whole transformer block for one batch row:
//   q/k/v = cast(x Wq + bq) ...   (compute-dtype operands, f32 accumulation)
//   ctx   = softmax(q kᵀ / √d_k) v   per head, 8 heads of d_k = 8
//   h1    = LN1(ctx Wf + bf + x)     (f32 statistics, f32 result)
//   out   = LN2(relu(cast(h1) W1 + b1) W2 + b2 + h1)
//
// Bound: issue rate and shared-memory bandwidth of the f32 FMA loops (about
// 41 MFLOP per row at L = 250 against ~64 KB of activation traffic), not
// device memory. Design: q, k, v of the row live in shared memory; the
// (L, L) scores are recomputed per query from shared k and never stored;
// fc + LN1 + FFN + LN2 run one row per warp, so the 256-wide hidden layer
// needs only one 256-entry buffer per warp; the ~49k weights are read
// through L1/L2, shared by every block. Tensor cores are left to a later
// change. Ragged L and B need no padding: the grid has one block per row and
// every loop is bounded by L.
//
// Softmax (as the TPU kernel): exact row max for L <= 32, per-head
// Cauchy–Schwarz bound ‖q_t‖·max_s‖k_s‖/√d_k above; exp in f32, cast to the
// compute dtype before e·v, den summed from the cast values in f32 and
// clamped at 1e-30 (a row whose exps all underflow gives ctx = 0, not NaN),
// divide after the ctx product.
//
// C interface (loaded with ctypes by ops/_build.py): s2s_fft_block returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int D = 64;     // d_model
constexpr int H = 8;      // heads
constexpr int DK = 8;     // d_k
constexpr int DFF = 256;  // FFN width
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HEADLOOP_MAX_L = 32;
constexpr float LN_EPS = 1e-5f;

static_assert(D == H * DK, "head split");
static_assert(WARPS == H, "the k-norm reduction uses one warp per head");

template <typename T>
struct Weights {
  const T* wq; const float* bq;
  const T* wk; const float* bk;
  const T* wv; const float* bv;
  const T* wf; const float* bf;
  const float* ln1s; const float* ln1b;
  const T* w1; const float* b1;
  const T* w2; const float* b2;
  const float* ln2s; const float* ln2b;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
fft_block_kernel(const T* __restrict__ x, T* __restrict__ out, const Weights<T> w,
                 const int L, const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);           // q, then ctx, then cast(h1)
  T* sK = sQ + (size_t)L * D;
  T* sV = sK + (size_t)L * D;
  T* sHid = sV + (size_t)L * D;                  // WARPS x DFF hidden rows
  float* sKn = reinterpret_cast<float*>(sHid + WARPS * DFF);  // max_s ‖k_s‖ per head

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* xb = x + (size_t)blockIdx.x * L * D;
  T* ob = out + (size_t)blockIdx.x * L * D;
  const bool headloop = L <= HEADLOOP_MAX_L;

  // ---- q, k, v projections: column j, rows tr, tr + 4, tr + 8, tr + 12 of
  // each 16-row slab (x rows are warp broadcasts, weight columns coalesced).
  {
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
  __syncthreads();

  // ---- Cauchy–Schwarz shift: per head, max over keys of ‖k_s‖ (warp = head).
  if (!headloop) {
    float m2 = 0.f;
    for (int s = lane; s < L; s += 32) {
      float kv[DK];
      load8(sK + s * D + warp * DK, kv);
      m2 = fmaxf(m2, dot8(kv, kv));
    }
    m2 = warp_max(m2);
    if (lane == 0) sKn[warp] = sqrtf(m2);
  }
  __syncthreads();

  // ---- attention: one (head, query) item per thread; a warp shares the
  // head, so each k/v row read is a shared-memory broadcast.
  for (int it = tid; it < H * L; it += THREADS) {
    const int h = it / L;
    const int t = it - h * L;
    float q[DK];
    load8(sQ + t * D + h * DK, q);
    float shift = 0.f;
    if (headloop) {
      float m = -INFINITY;
      for (int s = 0; s < L; ++s) {
        float kv[DK];
        load8(sK + s * D + h * DK, kv);
        m = fmaxf(m, dot8(q, kv));
      }
      shift = m;
    } else {
      shift = __fmul_rn(__fmul_rn(sqrtf(dot8(q, q)), sKn[h]), inv_temp);
    }
    float num[DK] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float den = 0.f;
    for (int s = 0; s < L; ++s) {
      float kv[DK], vv[DK];
      load8(sK + s * D + h * DK, kv);
      const float sc = dot8(q, kv);
      const float arg = headloop ? __fmul_rn(__fsub_rn(sc, shift), inv_temp)
                                 : __fsub_rn(__fmul_rn(sc, inv_temp), shift);
      const float e = to_f(from_f<T>(expf(arg)));
      den = __fadd_rn(den, e);
      load8(sV + s * D + h * DK, vv);
#pragma unroll
      for (int c = 0; c < DK; ++c) num[c] = fmaf(e, vv[c], num[c]);
    }
    den = fmaxf(den, 1e-30f);
    // q[t, h] is read only by this item, so ctx overwrites it in place.
#pragma unroll
    for (int c = 0; c < DK; ++c) sQ[t * D + h * DK + c] = from_f<T>(__fdiv_rn(num[c], den));
  }
  __syncthreads();

  // ---- fc + LN1 + FFN + LN2, one row per warp; lane holds columns lane and
  // lane + 32 of the 64-wide rows and 8 of the 256 hidden units.
  T* hid = sHid + warp * DFF;
  for (int t = warp; t < L; t += WARPS) {
    T* row = sQ + t * D;
    float o0 = 0.f, o1 = 0.f;
    for (int c = 0; c < D; ++c) {
      const float cv = to_f(row[c]);
      o0 = fmaf(cv, to_f(w.wf[c * D + lane]), o0);
      o1 = fmaf(cv, to_f(w.wf[c * D + lane + 32]), o1);
    }
    o0 = __fadd_rn(__fadd_rn(o0, w.bf[lane]), to_f(xb[t * D + lane]));
    o1 = __fadd_rn(__fadd_rn(o1, w.bf[lane + 32]), to_f(xb[t * D + lane + 32]));
    layer_norm2(o0, o1, w.ln1s, w.ln1b, lane);  // o0, o1 now hold h1 (f32)
    __syncwarp();
    row[lane] = from_f<T>(o0);
    row[lane + 32] = from_f<T>(o1);
    __syncwarp();

    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < D; ++j) {
      const float hv = to_f(row[j]);
#pragma unroll
      for (int m = 0; m < 8; ++m) a[m] = fmaf(hv, to_f(w.w1[j * DFF + lane + 32 * m]), a[m]);
    }
#pragma unroll
    for (int m = 0; m < 8; ++m)
      hid[lane + 32 * m] = from_f<T>(fmaxf(__fadd_rn(a[m], w.b1[lane + 32 * m]), 0.f));
    __syncwarp();

    float f0 = 0.f, f1 = 0.f;
    for (int n = 0; n < DFF; ++n) {
      const float hv = to_f(hid[n]);
      f0 = fmaf(hv, to_f(w.w2[n * D + lane]), f0);
      f1 = fmaf(hv, to_f(w.w2[n * D + lane + 32]), f1);
    }
    f0 = __fadd_rn(__fadd_rn(f0, w.b2[lane]), o0);
    f1 = __fadd_rn(__fadd_rn(f1, w.b2[lane + 32]), o1);
    layer_norm2(f0, f1, w.ln2s, w.ln2b, lane);
    ob[t * D + lane] = from_f<T>(f0);
    ob[t * D + lane + 32] = from_f<T>(f1);
    __syncwarp();  // hid is rewritten by the next row
  }
}

constexpr int MAX_DEVICES = 64;

// Opts the kernel into the device's largest dynamic shared memory, once per
// device and dtype (the attribute belongs to the device's context); each
// launch then asks for the size its L needs. Two threads racing here both set
// the same value.
template <typename T>
cudaError_t opt_in_shared_memory() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fft_block_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <typename T>
int launch(const void* x, void* out, void* const* p, int B, int L, float inv_temp,
           cudaStream_t stream) {
  const size_t smem = 3 * (size_t)L * D * sizeof(T) + (size_t)WARPS * DFF * sizeof(T) +
                      H * sizeof(float);
  cudaError_t err = opt_in_shared_memory<T>();
  if (err != cudaSuccess) return (int)err;
  const Weights<T> w{
      static_cast<const T*>(p[0]),      static_cast<const float*>(p[1]),
      static_cast<const T*>(p[2]),      static_cast<const float*>(p[3]),
      static_cast<const T*>(p[4]),      static_cast<const float*>(p[5]),
      static_cast<const T*>(p[6]),      static_cast<const float*>(p[7]),
      static_cast<const float*>(p[8]),  static_cast<const float*>(p[9]),
      static_cast<const T*>(p[10]),     static_cast<const float*>(p[11]),
      static_cast<const T*>(p[12]),     static_cast<const float*>(p[13]),
      static_cast<const float*>(p[14]), static_cast<const float*>(p[15]),
  };
  fft_block_kernel<T><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), w, L, inv_temp);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, L, 64) contiguous, bf16 (dtype 0) or f32 (dtype 1). weights:
// 16 device pointers in the Pallas kernel's _WEIGHT_FIELDS order; matrices
// (in, out) row-major in x's dtype, biases and LayerNorm parameters f32.
extern "C" int s2s_fft_block(const void* x, void* out, void* const* weights, int B, int L,
                             int dtype, float inv_temp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(x, out, weights, B, L, inv_temp, s);
  if (dtype == 1) return launch<float>(x, out, weights, B, L, inv_temp, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* s2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
