// Fused post-LN FFT block for Hopper (sm_90a): the port of the Pallas kernels
// seq2squiggle_tpu/ops/pallas/fft_block.py::fused_fft_block (one block) and
// ::fused_fft_block_pair (two blocks in one kernel).
//
// One thread block runs the whole transformer block (fft_block_body.cuh's
// fft_block_body) for one batch row; the pair kernel runs it twice, the first
// block's output staying on the chip as compute-dtype values.
//
// Bound: issue rate and shared-memory bandwidth of the f32 FMA loops (about
// 41 MFLOP per row and block at L = 250 against ~64 KB of activation
// traffic), not device memory. Design: q, k, v of the row live in shared
// memory; the (L, L) scores are recomputed per query from shared k and never
// stored; fc + LN1 + FFN + LN2 run one row per warp; the ~49k weights are
// read through L1/L2, shared by every block. Tensor cores are left to a later
// change. Ragged L and B need no padding: the grid has one block per row and
// every loop is bounded by L.
//
// Softmax: the argument `exact` picks the exact row max (the TPU kernel's head
// loop), else the per-head Cauchy–Schwarz bound (its packed form); the caller
// decides (by default the exact max for L <= 32, as the TPU kernel).
//
// The pair keeps a fourth L x 64 buffer for the activation between the blocks
// (block 1 writes its k and v while its input must survive as the residual).
// Where four buffers exceed the device's shared memory (f32 beyond L = 218 on
// an H100), the same thread block stages that activation through its row of
// `out` in device memory instead: still one launch, the same bits.
//
// C interface (loaded with ctypes by ops/_build.py): each entry point returns
// cudaGetLastError() after the launch.

#include "fft_block_body.cuh"

namespace {

using namespace s2s;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fft_block_kernel(const T* __restrict__ x, T* __restrict__ out, const BlockWeights<T> w,
                 const int L, const float inv_temp, const int exact) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockSmem<T> s = carve_smem<T>(smem, L);
  const T* xb = x + (size_t)blockIdx.x * L * D;
  fft_block_body(xb, xb, out + (size_t)blockIdx.x * L * D, w, L, inv_temp, exact != 0, s);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fft_block_pair_kernel(const T* x, T* out, const BlockWeights<T> w0, const BlockWeights<T> w1,
                      const int L, const float inv_temp, const int exact,
                      const int mid_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockSmem<T> s = carve_smem<T>(smem, L);
  const T* xb = x + (size_t)blockIdx.x * L * D;
  T* ob = out + (size_t)blockIdx.x * L * D;
  // block 0's output, rounded to the compute dtype as the store to device
  // memory between two one-block launches rounds it
  T* mid = mid_in_smem ? reinterpret_cast<T*>(s.rest) : ob;
  fft_block_body(xb, xb, mid, w0, L, inv_temp, exact != 0, s);
  __syncthreads();  // every row of mid written before block 1 projects it
  fft_block_body(static_cast<const T*>(mid), static_cast<const T*>(mid), ob, w1, L, inv_temp,
                 exact != 0, s);
}

template <typename T>
int launch(const void* x, void* out, void* const* p, int B, int L, float inv_temp, int exact,
           cudaStream_t stream) {
  static SharedMemoryOptIn opted;
  size_t limit = 0;
  cudaError_t err = opt_in_shared_memory(fft_block_kernel<T>, opted, &limit);
  if (err != cudaSuccess) return (int)err;
  fft_block_kernel<T><<<B, THREADS, block_smem_bytes<T>(L), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), block_weights<T>(p), L, inv_temp, exact);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pair(const void* x, void* out, void* const* p, int B, int L, float inv_temp,
                int exact, cudaStream_t stream) {
  static SharedMemoryOptIn opted;
  size_t limit = 0;
  cudaError_t err = opt_in_shared_memory(fft_block_pair_kernel<T>, opted, &limit);
  if (err != cudaSuccess) return (int)err;
  const bool mid_in_smem = block_smem_bytes<T>(L, 1) <= limit;
  fft_block_pair_kernel<T><<<B, THREADS, block_smem_bytes<T>(L, mid_in_smem ? 1 : 0), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), block_weights<T>(p),
      block_weights<T>(p + 16), L, inv_temp, exact, mid_in_smem ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, L, 64) contiguous, bf16 (dtype 0) or f32 (dtype 1). weights:
// 16 device pointers in the Pallas kernel's _WEIGHT_FIELDS order; matrices
// (in, out) row-major in x's dtype, biases and LayerNorm parameters f32.
// exact: 1 for the exact row max, 0 for the Cauchy–Schwarz shift.
extern "C" int s2s_fft_block(const void* x, void* out, void* const* weights, int B, int L,
                             int dtype, float inv_temp, int exact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(x, out, weights, B, L, inv_temp, exact, s);
  if (dtype == 1) return launch<float>(x, out, weights, B, L, inv_temp, exact, s);
  return (int)cudaErrorInvalidValue;
}

// As s2s_fft_block with 32 weight pointers: block 0's sixteen, then block 1's.
extern "C" int s2s_fft_block_pair(const void* x, void* out, void* const* weights, int B, int L,
                                  int dtype, float inv_temp, int exact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_pair<__nv_bfloat16>(x, out, weights, B, L, inv_temp, exact, s);
  if (dtype == 1) return launch_pair<float>(x, out, weights, B, L, inv_temp, exact, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* s2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
