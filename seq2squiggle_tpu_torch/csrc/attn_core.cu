// Training attention core for Hopper (sm_90a), forward and backward: the port
// of the Pallas kernel pair behind
// seq2squiggle_tpu/ops/pallas/attn_core.py::packed_attention_core
// (_core_fwd_call, _core_bwd_call). q, k, v, out and the gradients are all
// (B, L, 8·nh) with nh heads packed along the last axis (d_k = 8): the model's
// 8 heads (D = 64), or the nh = 8 / tp heads a tensor-parallel rank owns
// (nh = 1, 2 or 4; D = 32 at tp = 2). Each head's work is its own (its slices,
// its shift from its own norms, its sums), so nh changes only the row stride
// and the grid: the 4-head output is bit-equal to the 8-head kernel's on the
// same heads.
//
//   forward   ctx = softmax(q kᵀ/√d_k) v per head, with the Cauchy–Schwarz
//             shift ‖q_t‖·max_s‖k_s‖/√d_k; e = exp(..) rounded to the compute
//             dtype, num and den summed in f32 from it, ctx = num/den.
//   backward  nothing is saved but q, k, v: e and den are recomputed with the
//             forward's own code, then
//               ĝ  = cast(g/den)            g_a = ĝ·vᵀ (f32)
//               r  = (Σ_d ĝ·num)/den        dS  = cast(e·((g_a − r)/√d_k))
//               gq = dS·k    gk = dSᵀ·q    gv = eᵀ·ĝ   (f32 sums, cast once)
//             The shift is a constant of the softmax and gets no gradient.
//
// Bound: operations, not bytes. A call at B = 512, L = 250 moves 4 (forward)
// or 7 (backward) tensors of 16 MB in bf16, microseconds at 3.35 TB/s,
// against 2.6e8 (query, key) pairs, each with one exp forward and three
// backward. Both types: one thread block per (batch row, head), a grid of
// B·nh; the head's
// q, k, v slices (L x 8) live in shared memory, so device memory is read
// once; scores are recomputed and never stored.
//
// bf16 runs on the tensor cores with `mma.sync` (kernels *_mma_kernel below).
// A head's row is 8 bf16 = 16 bytes = one `ldmatrix` row, so the slices lie in
// shared memory as they come, zero rows padding L to a multiple of 16, and
// every operand loads with one `ldmatrix` (plain, or .trans where the product
// runs over the rows). A warp owns 16 queries and walks the keys 16 at a time:
//   S  = Q·Kᵀ      2 x m16n8k8   (depth d_k = 8, no zero padding of the depth)
//   e  on the accumulator fragment: one FFMA (scale and shift, log2(e) folded
//      in), ex2.approx, round to bf16 in pairs, keys >= L zeroed; two 16 x 8
//      tiles of e packed to bf16 pairs ARE the A operand of m16n8k16
//   num = E·V      m16n8k16 (V through ldmatrix.trans)
//   den = E·1      m16n8k16 against a tile of ones (row sums of the rounded e)
// The backward's first sweep repeats this (`exp_block_rows`, the forward's own
// code, so e is the forward's bit for bit), forms ĝ and r per query, then
// walks the keys again: g_a = Ĝ·Vᵀ (m16n8k8), dS on the fragment, gq = dS·K
// (m16n8k16). ĝ, the shift and r go to shared memory. Its second sweep gives
// each warp 16 KEYS and walks the queries in index order: Sᵀ = K·Qᵀ and
// g_aᵀ = V·Ĝᵀ (m16n8k8, roles swapped), e and dS recomputed with the stored
// per-query shift and r (fragment columns now), gk = dSᵀ·Q and gv = Eᵀ·Ĝ
// (m16n8k16 over the queries). That third exp per pair buys a fixed summation
// order without atomics: gradients are bit-equal from run to run. What holds
// the kernels is the special-function unit (16 exps a clock per SM: 0.064 ms
// forward, 0.193 backward at the train shape and 1980 MHz).
// Why mma.sync and not wgmma/TMA: wgmma wants a depth of 16 bf16 (half of it
// would be zeros for S and g_a), 64-row tiles and swizzled shared-memory
// operands, and its asynchronous pipeline pays where tiles stream from device
// memory; here a head's q, k, v (3 x 250 x 16 bytes) sit in shared memory
// after one load and the exp unit, not the tensor cores, is the limit.
// Measured at (512, 250, 64) on an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/profile_torch_attn_core.py, launches back to back): forward
// 0.105 ms, backward 0.347 ms, where the same design on the CUDA cores (one
// thread per query, as f32 below) took 0.60 and 2.07 ms and
// F.scaled_dot_product_attention takes 0.22 and 0.65; with libm's expf in
// place of ex2.approx 0.173 and 0.552 ms. PERF.md (section 6, B4) has the rest.
//
// f32 has no tensor-core form with TF32 off and keeps the CUDA-core kernels
// (attn_core_fwd_kernel, attn_core_bwd_kernel): one thread per query, each
// walking all L keys; gq is a sum over keys and needs no reduction; for gk
// and gv a second sweep gives one thread per KEY, which walks all queries in
// order with the per-query shift, r and ĝ that the first sweep left in
// shared memory. Ragged L needs no padding there: every loop is bounded by L.
//
// Shared memory per thread block (ops/attn_core.py::shared_memory_bytes is
// the Python twin of fwd_smem_bytes / bwd_smem_bytes below, checked by the
// wrapper before a launch): bf16 48 (forward) or 72 (backward) bytes per row
// of L rounded up to 16; f32 64 or 136 bytes per row of L.
//
// C interface (loaded with ctypes by ops/_build.py): each entry point returns
// cudaGetLastError() after its launch.

#include "row_mma.cuh"

#include <type_traits>

namespace {

using namespace s2s;

constexpr int THREADS = 256;

// A head's slice (L rows of 8, `ld` = 8·nh apart in device memory) into
// shared memory.
template <typename T>
__device__ __forceinline__ void load_head(T* dst, const T* src, int L, int ld, int tid) {
  for (int t = tid; t < L; t += THREADS) copy8(dst + t * DK, src + (size_t)t * ld);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_core_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, const int L,
                     const int nh, const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + (size_t)L * DK;

  const int tid = threadIdx.x, ld = nh * DK;
  const int b = blockIdx.x / nh, h = blockIdx.x - b * nh;
  const size_t base = (size_t)b * L * ld + h * DK;
  load_head(sK, k + base, L, ld, tid);
  load_head(sV, v + base, L, ld, tid);
  __syncthreads();
  const float knorm = warp_max_knorm<T, DK>(sK, L, tid & 31);

  for (int t = tid; t < L; t += THREADS) {
    float qv[DK], num[DK], den, ctx[DK];
    load8(q + base + (size_t)t * ld, qv);
    attend_query<T, DK>(qv, sK, sV, L, inv_temp, false, cs_shift(qv, knorm, inv_temp),
                        num, den);
#pragma unroll
    for (int c = 0; c < DK; ++c) ctx[c] = __fdiv_rn(num[c], den);
    store8(out + base + (size_t)t * ld, ctx);
  }
}

// TO is the gradients' type: T (rounded once on store), or float for the
// whole-block training backward, which wants the f32 sums themselves.
template <typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
attn_core_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     TO* __restrict__ gq, TO* __restrict__ gk, TO* __restrict__ gv,
                     const int L, const int nh, const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + (size_t)L * DK;
  T* sV = sK + (size_t)L * DK;
  T* sGh = sV + (size_t)L * DK;                       // ĝ = cast(g/den) per query
  float* sShift = reinterpret_cast<float*>(sGh + (size_t)L * DK);
  float* sR = sShift + L;                             // softmax-jacobian row dot

  const int tid = threadIdx.x, ld = nh * DK;
  const int b = blockIdx.x / nh, h = blockIdx.x - b * nh;
  const size_t base = (size_t)b * L * ld + h * DK;
  load_head(sQ, q + base, L, ld, tid);
  load_head(sK, k + base, L, ld, tid);
  load_head(sV, v + base, L, ld, tid);
  __syncthreads();
  const float knorm = warp_max_knorm<T, DK>(sK, L, tid & 31);

  // ---- sweep over queries: den, num, ĝ, r (kept for the key sweep), then gq.
  for (int t = tid; t < L; t += THREADS) {
    float qv[DK], num[DK], den, gh[DK];
    load8(sQ + t * DK, qv);
    const float shift = cs_shift(qv, knorm, inv_temp);
    attend_query<T, DK>(qv, sK, sV, L, inv_temp, false, shift, num, den);
    load8(g + base + (size_t)t * ld, gh);
    float r = 0.f;
#pragma unroll
    for (int c = 0; c < DK; ++c) {
      gh[c] = round_cd<T>(__fdiv_rn(gh[c], den));
      r = fmaf(gh[c], num[c], r);
    }
    r = __fdiv_rn(r, den);
    store8(sGh + t * DK, gh);  // exact: gh is already in the compute dtype
    sShift[t] = shift;
    sR[t] = r;

    float acc[DK] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < L; ++s) {
      float kv[DK], vv[DK];
      load8(sK + s * DK, kv);
      load8(sV + s * DK, vv);
      const float e = cs_exp<T>(dot8(qv, kv), shift, inv_temp);
      const float ds =
          round_cd<T>(__fmul_rn(e, __fmul_rn(__fsub_rn(dot8(gh, vv), r), inv_temp)));
#pragma unroll
      for (int c = 0; c < DK; ++c) acc[c] = fmaf(ds, kv[c], acc[c]);
    }
    store8(gq + base + (size_t)t * ld, acc);
  }
  __syncthreads();

  // ---- sweep over keys: gk and gv, summed over the queries in order.
  for (int s = tid; s < L; s += THREADS) {
    float kv[DK], vv[DK];
    load8(sK + s * DK, kv);
    load8(sV + s * DK, vv);
    float ak[DK] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float av[DK] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < L; ++t) {
      float qv[DK], gh[DK];
      load8(sQ + t * DK, qv);
      load8(sGh + t * DK, gh);
      const float e = cs_exp<T>(dot8(qv, kv), sShift[t], inv_temp);
      const float ds =
          round_cd<T>(__fmul_rn(e, __fmul_rn(__fsub_rn(dot8(gh, vv), sR[t]), inv_temp)));
#pragma unroll
      for (int c = 0; c < DK; ++c) {
        ak[c] = fmaf(ds, qv[c], ak[c]);
        av[c] = fmaf(e, gh[c], av[c]);
      }
    }
    store8(gk + base + (size_t)s * ld, ak);
    store8(gv + base + (size_t)s * ld, av);
  }
}

// ---- bf16 on the tensor cores ------------------------------------------------

// Threads a thread block of the tensor-core kernels: 256 beat 128 and 512 on
// the H100 (the history of PERF.md has the numbers).
constexpr int MMA_THREADS = 256;
constexpr int WARPS = MMA_THREADS / 32;

// The fragment loads, the mma steps, the exp on the fragment (`exp_pair`,
// `exp_block_rows`) and the sweep of 16 queries over all keys (`attend_tile`)
// are in row_mma.cuh: the whole-block training kernels run the same sweep.

// Two neighbouring values of dS = cast(e·((g_a − r)/√d_k)), packed.
__device__ __forceinline__ uint32_t ds_pair(uint32_t e, float ga0, float ga1, float r0,
                                            float r1, float inv_temp) {
  return pack2(__fmul_rn(lo_f(e), __fmul_rn(__fsub_rn(ga0, r0), inv_temp)),
               __fmul_rn(hi_f(e), __fmul_rn(__fsub_rn(ga1, r1), inv_temp)));
}

// A head's slice (L rows of 8, `ld` = 8·nh apart in device memory) into
// shared memory, rows L..Lp-1 zero.
__device__ __forceinline__ void load_head_padded(bf16* dst, const bf16* src, int L, int Lp,
                                                 int ld, int tid) {
  for (int t = tid; t < Lp; t += MMA_THREADS) {
    if (t < L) copy8(dst + t * DK, src + (size_t)t * ld);
    else *reinterpret_cast<uint4*>(dst + t * DK) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows g and g + 8 of an accumulator fragment to rows row0 + g, row0 + g + 8
// of a (L, ld) tensor's head slice, rounded once (or as they are for float).
template <typename TO>
__device__ __forceinline__ void store_tile(TO* dst, const float acc[4], int row0, int L,
                                           int ld, int lane) {
  const int r = row0 + (lane >> 2), c = 2 * (lane & 3);
  if (r < L) store2(dst + (size_t)r * ld + c, acc[0], acc[1]);
  if (r + 8 < L) store2(dst + (size_t)(r + 8) * ld + c, acc[2], acc[3]);
}

__global__ void __launch_bounds__(MMA_THREADS)
attn_core_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out, const int L,
                         const int nh, const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lp = pad_tile(L);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + (size_t)Lp * DK;
  bf16* sV = sK + (size_t)Lp * DK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, ld = nh * DK;
  const int b = blockIdx.x / nh, h = blockIdx.x - b * nh;
  const size_t base = (size_t)b * L * ld + h * DK;
  load_head_padded(sQ, q + base, L, Lp, ld, tid);
  load_head_padded(sK, k + base, L, Lp, ld, tid);
  load_head_padded(sV, v + base, L, Lp, ld, tid);
  __syncthreads();
  const float knorm = warp_max_knorm<bf16, DK>(sK, L, lane);
  const float scale2 = __fmul_rn(inv_temp, EXP_UNIT);

  for (int q0 = warp * TILE; q0 < Lp; q0 += WARPS * TILE) {
    uint32_t qa[2];
    load_a(qa, sQ, q0, lane);
    const float sh0 = row_shift2(qa[0], knorm, inv_temp);
    const float sh1 = row_shift2(qa[1], knorm, inv_temp);
    float num[4], den[4];
    attend_tile(num, den, qa, sK, sV, L, Lp, lane, scale2, sh0, sh1);
    const float d0 = fmaxf(den[0], DEN_MIN), d1 = fmaxf(den[2], DEN_MIN);
    const float ctx[4] = {__fdiv_rn(num[0], d0), __fdiv_rn(num[1], d0), __fdiv_rn(num[2], d1),
                          __fdiv_rn(num[3], d1)};
    store_tile(out + base, ctx, q0, L, ld, lane);
  }
}

// TO as in attn_core_bwd_kernel.
template <typename TO>
__global__ void __launch_bounds__(MMA_THREADS)
attn_core_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ g,
                         TO* __restrict__ gq, TO* __restrict__ gk, TO* __restrict__ gv,
                         const int L, const int nh, const float inv_temp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lp = pad_tile(L);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + (size_t)Lp * DK;
  bf16* sV = sK + (size_t)Lp * DK;
  bf16* sGh = sV + (size_t)Lp * DK;                  // ĝ = cast(g/den) per query
  float* sShift = reinterpret_cast<float*>(sGh + (size_t)Lp * DK);  // log2(e)·shift
  float* sR = sShift + Lp;                           // softmax-jacobian row dot

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, ld = nh * DK;
  const int row = lane >> 2, col = 2 * (lane & 3);
  const int b = blockIdx.x / nh, h = blockIdx.x - b * nh;
  const size_t base = (size_t)b * L * ld + h * DK;
  load_head_padded(sQ, q + base, L, Lp, ld, tid);
  load_head_padded(sK, k + base, L, Lp, ld, tid);
  load_head_padded(sV, v + base, L, Lp, ld, tid);
  __syncthreads();
  const float knorm = warp_max_knorm<bf16, DK>(sK, L, lane);
  const float scale2 = __fmul_rn(inv_temp, EXP_UNIT);

  // ---- sweep over queries: den, num, ĝ, r (kept for the key sweep), then gq.
  for (int q0 = warp * TILE; q0 < Lp; q0 += WARPS * TILE) {
    uint32_t qa[2];
    load_a(qa, sQ, q0, lane);
    const float sh0 = row_shift2(qa[0], knorm, inv_temp);
    const float sh1 = row_shift2(qa[1], knorm, inv_temp);
    float num[4], den[4];
    attend_tile(num, den, qa, sK, sV, L, Lp, lane, scale2, sh0, sh1);
    const float d0 = fmaxf(den[0], DEN_MIN), d1 = fmaxf(den[2], DEN_MIN);

    // ĝ in the accumulator's layout is the A operand of g_a = Ĝ·Vᵀ as it is.
    const int t0 = q0 + row, t1 = t0 + 8;
    uint32_t g0 = 0u, g1 = 0u;  // rows >= L: ĝ = 0, so r = 0 and dS = 0
    if (t0 < L) g0 = *reinterpret_cast<const uint32_t*>(g + base + (size_t)t0 * ld + col);
    if (t1 < L) g1 = *reinterpret_cast<const uint32_t*>(g + base + (size_t)t1 * ld + col);
    uint32_t gha[2];
    gha[0] = pack2(__fdiv_rn(lo_f(g0), d0), __fdiv_rn(hi_f(g0), d0));
    gha[1] = pack2(__fdiv_rn(lo_f(g1), d1), __fdiv_rn(hi_f(g1), d1));
    const float r0 = __fdiv_rn(
        quad_sum(fmaf(hi_f(gha[0]), num[1], __fmul_rn(lo_f(gha[0]), num[0]))), d0);
    const float r1 = __fdiv_rn(
        quad_sum(fmaf(hi_f(gha[1]), num[3], __fmul_rn(lo_f(gha[1]), num[2]))), d1);
    uint32_t* gh_words = reinterpret_cast<uint32_t*>(sGh) + q0 * (DK / 2) + lane;
    gh_words[0] = gha[0];
    gh_words[8 * (DK / 2)] = gha[1];
    if ((lane & 3) == 0) {
      sShift[t0] = sh0; sShift[t1] = sh1;
      sR[t0] = r0; sR[t1] = r1;
    }

    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < Lp; s0 += TILE) {
      uint32_t e[4], ds[4], vb0, vb1, kt0, kt1;
      exp_block_rows(e, qa, sK, s0, L, lane, scale2, sh0, sh1);
      load_rows(vb0, vb1, sV, s0, lane);
      float ga0[4] = {0.f, 0.f, 0.f, 0.f}, ga1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_k8(ga0, gha, vb0);
      mma_k8(ga1, gha, vb1);
      ds[0] = ds_pair(e[0], ga0[0], ga0[1], r0, r0, inv_temp);
      ds[1] = ds_pair(e[1], ga0[2], ga0[3], r1, r1, inv_temp);
      ds[2] = ds_pair(e[2], ga1[0], ga1[1], r0, r0, inv_temp);
      ds[3] = ds_pair(e[3], ga1[2], ga1[3], r1, r1, inv_temp);
      load_rows_t(kt0, kt1, sK, s0, lane);
      mma_k16(acc, ds, kt0, kt1);
    }
    store_tile(gq + base, acc, q0, L, ld, lane);
  }
  __syncthreads();

  // ---- sweep over keys: gk and gv, summed over the queries in order. The
  // fragments are keys x queries now; rows of keys >= L are computed and not
  // stored, and a query >= L adds nothing (its q, ĝ and r are 0, its e is 1).
  for (int s0 = warp * TILE; s0 < Lp; s0 += WARPS * TILE) {
    uint32_t ka[2], va[2];
    load_a(ka, sK, s0, lane);
    load_a(va, sV, s0, lane);
    float ak[4] = {0.f, 0.f, 0.f, 0.f}, av[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t0 = 0; t0 < Lp; t0 += TILE) {
      uint32_t e[4], ds[4], qb0, qb1, gb0, gb1, qt0, qt1, gt0, gt1;
      load_rows(qb0, qb1, sQ, t0, lane);
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_k8(c0, ka, qb0);
      mma_k8(c1, ka, qb1);
      const float2 shA = *reinterpret_cast<const float2*>(sShift + t0 + col);
      const float2 shB = *reinterpret_cast<const float2*>(sShift + t0 + 8 + col);
      e[0] = exp_pair(c0[0], c0[1], scale2, shA.x, shA.y);
      e[1] = exp_pair(c0[2], c0[3], scale2, shA.x, shA.y);
      e[2] = exp_pair(c1[0], c1[1], scale2, shB.x, shB.y);
      e[3] = exp_pair(c1[2], c1[3], scale2, shB.x, shB.y);
      load_rows(gb0, gb1, sGh, t0, lane);
      float ga0[4] = {0.f, 0.f, 0.f, 0.f}, ga1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_k8(ga0, va, gb0);
      mma_k8(ga1, va, gb1);
      const float2 rA = *reinterpret_cast<const float2*>(sR + t0 + col);
      const float2 rB = *reinterpret_cast<const float2*>(sR + t0 + 8 + col);
      ds[0] = ds_pair(e[0], ga0[0], ga0[1], rA.x, rA.y, inv_temp);
      ds[1] = ds_pair(e[1], ga0[2], ga0[3], rA.x, rA.y, inv_temp);
      ds[2] = ds_pair(e[2], ga1[0], ga1[1], rB.x, rB.y, inv_temp);
      ds[3] = ds_pair(e[3], ga1[2], ga1[3], rB.x, rB.y, inv_temp);
      load_rows_t(qt0, qt1, sQ, t0, lane);
      mma_k16(ak, ds, qt0, qt1);
      load_rows_t(gt0, gt1, sGh, t0, lane);
      mma_k16(av, e, gt0, gt1);
    }
    store_tile(gk + base, ak, s0, L, ld, lane);
    store_tile(gv + base, av, s0, L, ld, lane);
  }
}

// ---- host side -------------------------------------------------------------

// Dynamic shared memory of one thread block (Python twin:
// ops/attn_core.py::shared_memory_bytes).
template <typename T> size_t fwd_smem_bytes(int L) { return 2 * (size_t)L * DK * sizeof(T); }
template <> size_t fwd_smem_bytes<bf16>(int L) {
  return 3 * (size_t)pad_tile(L) * DK * sizeof(bf16);
}
template <typename T> size_t bwd_smem_bytes(int L) {
  return 4 * (size_t)L * DK * sizeof(T) + 2 * (size_t)L * sizeof(float);
}
template <> size_t bwd_smem_bytes<bf16>(int L) {
  return 4 * (size_t)pad_tile(L) * DK * sizeof(bf16) + 2 * (size_t)pad_tile(L) * sizeof(float);
}

// One thread block per (batch row, head): a grid of B·nh.
template <typename K, typename... Args>
int launch(K kernel, int threads, size_t smem, int blocks, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_shared_memory(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, int B, int L, int nh,
               float inv_temp, cudaStream_t stream) {
  const auto run = [&](auto kernel, int threads) {
    return launch(kernel, threads, fwd_smem_bytes<T>(L), B * nh, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(out), L, nh, inv_temp);
  };
  if constexpr (std::is_same<T, bf16>::value) return run(attn_core_fwd_mma_kernel, MMA_THREADS);
  else return run(attn_core_fwd_kernel<T>, THREADS);
}

template <typename T, typename TO>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* gq,
               void* gk, void* gv, int B, int L, int nh, float inv_temp, cudaStream_t stream) {
  const auto run = [&](auto kernel, int threads) {
    return launch(kernel, threads, bwd_smem_bytes<T>(L), B * nh, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(g), static_cast<TO*>(gq), static_cast<TO*>(gk),
                  static_cast<TO*>(gv), L, nh, inv_temp);
  };
  if constexpr (std::is_same<T, bf16>::value) return run(attn_core_bwd_mma_kernel<TO>, MMA_THREADS);
  else return run(attn_core_bwd_kernel<T, TO>, THREADS);
}

bool heads_ok(int nh) { return nh == 1 || nh == 2 || nh == 4 || nh == 8; }

}  // namespace

// The whole-block training backward's stage: the model's H heads.
int s2s::attn_core_bwd_f32(const void* q, const void* k, const void* v, const void* g,
                           float* gq, float* gk, float* gv, int B, int L, int dtype,
                           float inv_temp, cudaStream_t stream) {
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(q, k, v, g, gq, gk, gv, B, L, H, inv_temp, stream);
  if (dtype == 1)
    return launch_bwd<float, float>(q, k, v, g, gq, gk, gv, B, L, H, inv_temp, stream);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, out: (B, L, 8·nh) contiguous, nh in {1, 2, 4, 8}, bf16 (dtype 0)
// or f32 (dtype 1).
extern "C" int s2s_attn_core_fwd(const void* q, const void* k, const void* v, void* out,
                                 int B, int L, int nh, int dtype, float inv_temp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!heads_ok(nh)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_fwd<__nv_bfloat16>(q, k, v, out, B, L, nh, inv_temp, s);
  if (dtype == 1) return launch_fwd<float>(q, k, v, out, B, L, nh, inv_temp, s);
  return (int)cudaErrorInvalidValue;
}

// g: the gradient of the loss by out, in q's dtype; gq, gk, gv: as q.
extern "C" int s2s_attn_core_bwd(const void* q, const void* k, const void* v, const void* g,
                                 void* gq, void* gk, void* gv, int B, int L, int nh, int dtype,
                                 float inv_temp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!heads_ok(nh)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(q, k, v, g, gq, gk, gv, B, L, nh, inv_temp,
                                                     s);
  if (dtype == 1) return launch_bwd<float, float>(q, k, v, g, gq, gk, gv, B, L, nh, inv_temp, s);
  return (int)cudaErrorInvalidValue;
}
