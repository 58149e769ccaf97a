// The Gamma dwell draw and its per-chunk key chain in one launch: the
// hand-written counterpart of runtime/predict.py's key chain
// fold_in(fold_in(fold_in(base, read_idx), chunk_off), 1) and of
// sampling.py::sample_gamma_durations, with _compute_durations' two
// clamp_min and its round half to even to int32.
//
// It replaces no TPU kernel: XLA fuses the JAX package's threefry and its
// Marsaglia–Tsang loop into a few kernels of its own, while eager PyTorch
// runs the same draw as ~10,000 launches a predict batch (B = 1024, K = 16),
// ~10 us of host time each.
//
// Bound: ~80 integer operations per threefry block and 8–10 blocks per
// element (3 for the key chain, 5 a round, 2 for the boost; ~96 % of draws
// accept in their first round), ~1.3e7 operations a batch, about a
// microsecond at the card's integer rate; the inputs and outputs are ~0.25
// MB. So the launch itself is the cost, and the design is one thread per
// (row, k-mer) element that derives its row's keys itself (the row's threads
// repeat that work rather than share it) and stops at its first accepted
// round.
//
// Numerics: threefry.cuh, prng.py's op for op.
//
// C interface (loaded with ctypes by ops/_build.py): the entry point returns
// cudaGetLastError() after the launch.

#include "threefry.cuh"

namespace {

using namespace s2s::threefry;

constexpr int THREADS = 256;

// Row keys come from keys_in (B, 2) where it is given, else from the chain on
// base_key, read_idx and chunk_off, whose chunk key (before the fold by 1)
// the row's first thread writes to keys_out. Without conc the launch writes
// the keys alone (K is then 1). Each element writes its draw / rate to draws
// and its clamped, rounded count to durations, where they are given.
__global__ void __launch_bounds__(THREADS)
gamma_draw_kernel(const long long* __restrict__ base_key, const int* __restrict__ read_idx,
                  const int* __restrict__ chunk_off, const long long* __restrict__ keys_in,
                  const float* __restrict__ conc, const float* __restrict__ rate,
                  long long* __restrict__ keys_out, float* __restrict__ draws,
                  int* __restrict__ durations, const int B, const int K,
                  const float min_duration) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * K) return;
  const int row = (int)(i / K), k = (int)(i % K);
  Key key;
  if (keys_in != nullptr) {
    key = {(uint32_t)keys_in[2 * row], (uint32_t)keys_in[2 * row + 1]};
  } else {
    const Key base = {(uint32_t)base_key[0], (uint32_t)base_key[1]};
    const Key chunk = fold_in(fold_in(base, (uint32_t)read_idx[row]), (uint32_t)chunk_off[row]);
    if (k == 0 && keys_out != nullptr) {
      keys_out[2 * row] = chunk.k0;
      keys_out[2 * row + 1] = chunk.k1;
    }
    if (conc == nullptr) return;
    key = fold_in(chunk, 1u);
  }
  float x = __fdiv_rn(gamma_draw(key, (uint32_t)k, conc[i]), rate[i]);
  if (draws != nullptr) draws[i] = x;
  if (durations != nullptr) {
    x = x < 1.0f ? 1.0f : x;  // clamp_min, which keeps a NaN
    x = x < min_duration ? min_duration : x;
    durations[i] = __float2int_rn(x);
  }
}

}  // namespace

// base_key: (2,) int64 words of prng.key; read_idx, chunk_off: (B,) int32;
// keys_in: (B, 2) int64 or null; conc, rate: (B, K) f32 or null (keys only,
// K = 1); keys_out (B, 2) int64, draws (B, K) f32, durations (B, K) int32:
// each null where not wanted. All contiguous on the stream's device.
extern "C" int s2s_gamma_draw(const void* base_key, const void* read_idx, const void* chunk_off,
                              const void* keys_in, const void* conc, const void* rate,
                              void* keys_out, void* draws, void* durations, int B, int K,
                              float min_duration, void* stream) {
  const long long n = (long long)B * K;
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  gamma_draw_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(base_key), static_cast<const int*>(read_idx),
      static_cast<const int*>(chunk_off), static_cast<const long long*>(keys_in),
      static_cast<const float*>(conc), static_cast<const float*>(rate),
      static_cast<long long*>(keys_out), static_cast<float*>(draws),
      static_cast<int*>(durations), B, K, min_duration);
  return (int)cudaGetLastError();
}
