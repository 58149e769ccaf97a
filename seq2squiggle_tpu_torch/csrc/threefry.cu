// The port's threefry draws on the card, one launch each: the Gamma dwell
// draw with its per-chunk key chain (predict), the dropout masks and scales
// of the train step, and the key derivations (fold_in, split) around them.
//
// -- The Gamma dwell draw (s2s_gamma_draw) --
//
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

// -- The dropout draw (s2s_dropout_draw) --
//
// jax.random.bernoulli(key, keep, shape) for the train step's eleven dropout
// draws: ops/attention.py::dropout_mask (a bool mask) and
// ops/block_train.py::make_dropout_scales ({1/keep, 0} in the compute
// dtype). Element g of the draw is uniform(random_bits(key, shape)[g]) < keep,
// with uniform at [0, 1): fma(f, 1, 0) is f exactly and the clamp never acts,
// so the mask is prng.bernoulli's bit for bit. The caller hands the value a
// kept element takes as raw bits (1 for a bool, the scale rounded to the
// output dtype by torch itself) and a dropped one takes 0, so the output is
// the plain path's bit for bit in any dtype of 1, 2 or 4 bytes.
//
// It replaces no TPU kernel: XLA fuses the JAX package's threefry into the
// step, while eager PyTorch runs one draw as ~190 launches.
//
// Bound: one threefry block (~80 integer operations) an element, 1-4 bytes
// written, no bytes read but the key: a (512, 250, 64) draw is 8.2 M blocks,
// ~40 us of the card's integer rate, against ~5-16 us of writes. One thread
// an element; a dp rank draws its own slab, elements [offset, offset + n) of
// the global draw (threefry is counter-based, so element g's bits depend on
// the key and g alone).

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
dropout_draw_kernel(const long long* __restrict__ key_words, T* __restrict__ out, const long long n,
                    const long long offset, const float keep, const T on) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Key key = {(uint32_t)key_words[0], (uint32_t)key_words[1]};
  // the flat counter wraps to 32 bits, as prng.threefry2x32 masks it
  const float u = uniform(random_bits(key, (uint32_t)(offset + i)), 0.0f, 1.0f);
  out[i] = u < keep ? on : T(0);
}

// -- Key derivation (s2s_threefry_keys) --
//
// fold_in and split for the step's dropout keys: jax.random.split(key, 4) of
// the step key, split(fold_in(key, i)) for each block of a stack, the
// duration heads' split. One thread an output key; eager PyTorch makes ~175
// launches of each.

__global__ void __launch_bounds__(THREADS)
threefry_keys_kernel(const long long* __restrict__ keys_in, long long* __restrict__ keys_out,
                     const int n_keys, const int n_fold, const uint32_t fold_data,
                     const int n_split) {
  const int folds = n_fold > 0 ? n_fold : 1, splits = n_split > 0 ? n_split : 1;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)n_keys * folds * splits) return;
  const int s = (int)(t % splits), f = (int)(t / splits % folds), j = (int)(t / splits / folds);
  Key k = {(uint32_t)keys_in[2 * j], (uint32_t)keys_in[2 * j + 1]};
  if (n_fold > 0) k = fold_in(k, fold_data + (uint32_t)f);
  if (n_split > 0) k = split(k, (uint32_t)s);
  keys_out[2 * t] = k.k0;
  keys_out[2 * t + 1] = k.k1;
}

}  // namespace

// key: (2,) int64 words of a prng key; out: n contiguous elements of
// elem_bytes (1, 2 or 4) on the stream's device; element i is the draw's
// element offset + i, `on_bits` where uniform < keep and 0 elsewhere.
extern "C" int s2s_dropout_draw(const void* key, void* out, long long n, long long offset,
                                float keep, unsigned on_bits, int elem_bytes, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto k = static_cast<const long long*>(key);
  switch (elem_bytes) {
    case 1:
      dropout_draw_kernel<<<blocks, THREADS, 0, s>>>(k, static_cast<uint8_t*>(out), n, offset,
                                                     keep, (uint8_t)on_bits);
      break;
    case 2:
      dropout_draw_kernel<<<blocks, THREADS, 0, s>>>(k, static_cast<uint16_t*>(out), n, offset,
                                                     keep, (uint16_t)on_bits);
      break;
    case 4:
      dropout_draw_kernel<<<blocks, THREADS, 0, s>>>(k, static_cast<uint32_t*>(out), n, offset,
                                                     keep, (uint32_t)on_bits);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// keys_in: (n_keys, 2) int64; keys_out: (n_keys, max(n_fold, 1),
// max(n_split, 1), 2) int64, both contiguous. With n_fold > 0 each key is
// first folded with fold_data + f for f < n_fold; with n_split > 0 each
// result is then split into n_split keys.
extern "C" int s2s_threefry_keys(const void* keys_in, void* keys_out, int n_keys, int n_fold,
                                 unsigned fold_data, int n_split, void* stream) {
  const long long n = (long long)n_keys * (n_fold > 0 ? n_fold : 1) * (n_split > 0 ? n_split : 1);
  if (n == 0) return (int)cudaSuccess;
  threefry_keys_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys_in), static_cast<long long*>(keys_out), n_keys, n_fold,
      fold_data, n_split);
  return (int)cudaGetLastError();
}
