// Fused post-LN FFT block for Hopper (sm_90a): the port of the Pallas kernels
// seq2squiggle_tpu/ops/pallas/fft_block.py::fused_fft_block (one block) and
// ::fused_fft_block_pair (two blocks in one kernel).
//
// One thread block runs the whole transformer block for one batch row; the
// pair kernel runs it twice, the first block's output staying on the chip as
// compute-dtype values.
//
// Bound: operations (41.5 GFLOP per (1024, 250, 64) block: 0.042 ms at the
// tensor cores' 989 TFLOP/s) against ~66 MB of activations in and out (0.020
// ms at 3.35 TB/s). Design:
//   bf16  block_mma.cuh's tensor-core body, the one block_train.cu's training
//         forward runs too: a warp per 16-row slab of positions, every matrix
//         product `mma.sync` against weights staged in shared memory once per
//         thread block, the attention as the attention core's sweep (with the
//         exact form's max sweep before it), the 256-wide hidden layer in
//         register chunks. No dropout scales and no workspace stores.
//   f32   fft_block_body.cuh's CUDA-core body (f32 has no tensor-core form
//         while TF32 is off): q, k, v in shared memory, the (L, L) scores
//         recomputed per query, fc + LN1 + FFN + LN2 a row per warp with the
//         weights read through L1/L2.
// Ragged B needs nothing: the grid has one block per row.
//
// Softmax: the argument `exact` picks the exact row max (the TPU kernel's head
// loop), else the per-head Cauchy–Schwarz bound (its packed form); the caller
// decides (by default the exact max for L <= 32, as the TPU kernel).
//
// The pair keeps one more buffer for the activation between the blocks
// (block 1 writes its k and v while its input must survive as the residual):
// Lp rows of 72 values beside the bf16 body's layout (fits to L = 352 on an
// H100), L x 64 beside the f32 body's (to L = 218). Beyond that the same
// thread block stages the activation through its rows of `out` in device
// memory instead: still one launch, the same bits.
//
// C interface (loaded with ctypes by ops/_build.py): each entry point returns
// cudaGetLastError() after the launch.

#include "fft_block_body.cuh"

namespace {

using namespace s2s;

// ---- the CUDA-core body (f32) -----------------------------------------------

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

// ---- bf16 on the tensor cores ------------------------------------------------

// One block of the L rows at xb (ldx values apart) into the rows at ob (ldo
// apart); both in device or shared memory, and ob may be xb.
template <bool EXACT>
__device__ __forceinline__ void slab_block(const bf16* xb, int ldx, bf16* ob, int ldo,
                                           const BlockWeights<bf16>& w, int L, float inv_temp,
                                           unsigned char* smem) {
  block_rows_mma<EXACT, false, false>(
      xb, ldx, nullptr, nullptr, w, RowStores{}, L, inv_temp, smem,
      [&](const SlabLane& s, const float (&)[8][4], const float*, const float (&zh2)[8][4],
          const float*, const uint32_t*, const uint32_t (&)[8][2]) {
        uint32_t op[8][2];
        ln_affine_packed(op, zh2, w.ln2s, w.ln2b, s);
        store_packed(ob, ldo, op, s);
      });
}

template <bool EXACT>
__global__ void __launch_bounds__(THREADS)
fft_block_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                     const BlockWeights<bf16> w, const int L, const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)blockIdx.x * L * D;
  slab_block<EXACT>(x + base, D, out + base, D, w, L, inv_temp, smem);
}

// Bytes of the pair's activation between its blocks in shared memory.
inline size_t pair_mid_bytes(int L) { return (size_t)pad_tile(L) * LDA * sizeof(bf16); }

// x and out carry no __restrict__: where the activation between the blocks is
// staged through out, block 1 reads the rows block 0 wrote, and the loads must
// not take the read-only path.
template <bool EXACT>
__global__ void __launch_bounds__(THREADS)
fft_block_pair_mma_kernel(const bf16* x, bf16* out, const BlockWeights<bf16> w0,
                          const BlockWeights<bf16> w1, const int L, const float inv_temp,
                          const int mid_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)blockIdx.x * L * D;
  bf16* ob = out + base;
  // block 0's output, rounded to bf16 as the store to device memory between
  // two one-block launches rounds it
  bf16* mid = mid_in_smem ? reinterpret_cast<bf16*>(smem + slab_smem_bytes(L)) : ob;
  const int ldm = mid_in_smem ? LDA : D;
  slab_block<EXACT>(x + base, D, mid, ldm, w0, L, inv_temp, smem);
  __syncthreads();  // every row of mid written before block 1 projects it
  slab_block<EXACT>(mid, ldm, ob, D, w1, L, inv_temp, smem);
}

int launch_mma(const void* x, void* out, void* const* p, int B, int L, float inv_temp,
               int exact, cudaStream_t stream) {
  static SharedMemoryOptIn opted[2];
  const auto kernel = exact ? fft_block_mma_kernel<true> : fft_block_mma_kernel<false>;
  size_t limit = 0;
  cudaError_t err = opt_in_shared_memory(kernel, opted[exact ? 1 : 0], &limit);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, THREADS, slab_smem_bytes(L), stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), block_weights<bf16>(p), L,
      inv_temp);
  return (int)cudaGetLastError();
}

int launch_pair_mma(const void* x, void* out, void* const* p, int B, int L, float inv_temp,
                    int exact, cudaStream_t stream) {
  static SharedMemoryOptIn opted[2];
  const auto kernel = exact ? fft_block_pair_mma_kernel<true> : fft_block_pair_mma_kernel<false>;
  size_t limit = 0;
  cudaError_t err = opt_in_shared_memory(kernel, opted[exact ? 1 : 0], &limit);
  if (err != cudaSuccess) return (int)err;
  const bool mid_in_smem = slab_smem_bytes(L) + pair_mid_bytes(L) <= limit;
  kernel<<<B, THREADS, slab_smem_bytes(L) + (mid_in_smem ? pair_mid_bytes(L) : 0), stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), block_weights<bf16>(p),
      block_weights<bf16>(p + 16), L, inv_temp, mid_in_smem ? 1 : 0);
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
  if (dtype == 0) return launch_mma(x, out, weights, B, L, inv_temp, exact, s);
  if (dtype == 1) return launch<float>(x, out, weights, B, L, inv_temp, exact, s);
  return (int)cudaErrorInvalidValue;
}

// As s2s_fft_block with 32 weight pointers: block 0's sixteen, then block 1's.
extern "C" int s2s_fft_block_pair(const void* x, void* out, void* const* weights, int B, int L,
                                  int dtype, float inv_temp, int exact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_pair_mma(x, out, weights, B, L, inv_temp, exact, s);
  if (dtype == 1) return launch_pair<float>(x, out, weights, B, L, inv_temp, exact, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* s2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
