"""Profiling kernels of the fused FFT block: the ports of the three Pallas
timing kernels under scripts/profiling/ of the JAX package,

  profile_abc.py::fused    -> fused_abc(x, block, n_head, variant)   a, b, c
  profile_d.py::fused      -> fused_d(x, block, n_head, variant)     b, d
  profile_parts2.py::fused -> fused_parts(x, block, n_head, stage)   proj ... full

and of the fused block's own `ablate` argument
(seq2squiggle_tpu/ops/pallas/fft_block.py::fused_fft_block, eight cuts that
each take one piece out of the block):

  fused_fft_block(x, block, n_head, packed, ablate) -> fused_ablate(...)

They time what each piece of the block costs (`scripts/profile_torch_block_
variants.py` and `scripts/profile_torch_attn_breakdown.py` run them on the
card); the model never calls them. Each is one launch of
`csrc/fft_block_variants.cu`. bfloat16 runs the fused block's own tensor-core
body (`csrc/block_mma.cuh`: weights staged in shared memory, a warp per
16-row slab for the projections and the tail, a warp per head for the
attention, every product `mma.sync`), so the differences between them are
differences of the block the predict path runs; float32 runs the CUDA-core
body (`csrc/fft_block_body.cuh`), as the float32 block does.

  a  softmax in f32 on the tempered scores, probabilities cast to the compute
     dtype, then probs·v cast: the form before the block's softmax was
     restructured. On the tensor cores three passes over the keys: the row
     max of the scores, the f32 sum of exp(s·τ − m), then p = cast(e / den)
     as the A operand of p·v
  b  the block's exact-max form (`fused_fft_block(packed=False)`): one exp
     pass cast to the compute dtype, den summed from the cast values, the
     divide after e·v. It launches the kernel of that form, bit-equal to the
     fused block's in both dtypes
  c  b with den as a ninth column of the e·v product (v extended by a column
     of ones). On the TPU that saves a matrix product; on this card den is
     already that column (bf16: an `mma.sync` of e against a tile of ones;
     f32: summed inside the e·v loop, fma(e, 1, den) rounding as den + e), so
     c's arithmetic is b's and the kernel is held bit-equal to b (in bf16 it
     launches b's kernel)
  d  the per-head Cauchy–Schwarz shift ‖q_t‖·max_s‖k_s‖/√d_k and den + 1e-30
     (the fused block's packed form clamps den at 1e-30 instead)
  stages  the block cut after proj, scores, max, exp, ctx or den; what was
     computed is folded into the output by the script's own sinks (q + k + v;
     the first d_k key columns of the scores, of scores + max, of e; num;
     cast(num / den)), summed over the heads in f32 in head order and tiled
     n_head times along D. `full` is b. From scores on a stage needs
     L >= d_k; on the tensor cores the sinks need an L x 8 f32 buffer per
     head in shared memory, so those stages take L <= 288 in bf16.

The cuts (ABLATIONS), each the function the Pallas kernel computes with that
`ablate` in interpret mode:

  noattn   ctx = q: no attention (both softmax forms)
  noffn    the output is cast(h1), LN1's output: no FFN and no LN2, W1 and
           W2 never staged (both softmax forms)
  ... and six that act only in the Cauchy–Schwarz form (`_attn_packed`); in
  the exact form (packed=False, or None at L <= 32) they are the identity, as
  `_attn_headloop` ignores `ablate`:
  noshift  shift = 0
  noexp    e = s·τ − shift, no exp, cast to the compute dtype. Then den <= 0
           is clamped to 1e-30 and ctx is near 1e30; LN1's variance
           overflows to inf and its output is its bias: finite, not NaN
  bf16exp  e = exp(cast(s·τ − shift)): the exp of the argument rounded to
           the compute dtype (in float32 the identity)
  nomask   padded key columns are not masked. The TPU kernel pads L to a
           multiple of 8 with zero rows, whose keys and values are the
           projections' biases; so keys below pad8(L) count here and the
           port's own padding to 16 rows stays masked. The shift's max‖k‖
           keeps its mask. The identity where L is a multiple of 8
  noden    ctx = cast(num): no den and no divide
  thin16   the score product contracts channels 0..15 only. The packed q's
           row block h keeps only head h's channels, so heads 0 and 1 score
           as before and heads 2..7 score 0 against every key: e =
           exp(−shift), constant over the real keys. On the tensor cores
           warps 2..7 skip their score `mma.sync`, so its time measures
           skipped score work, not a matrix-unit tile width

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, which follows the Pallas code step by step.
"""

from __future__ import annotations

import torch

from . import _build
from .attn_core import packed_attention_attend
from .fft_block import (
    N_HEAD, _mm, _padded, _weight_pointers, block_reference, check_input,
    cuda_core_shared_memory_bytes, exact_max_attention, launch_kernel, packed_default,
    slab_shared_memory_bytes,
)

ABC_VARIANTS = ("a", "b", "c")
D_VARIANTS = ("b", "d")
STAGES = ("proj", "scores", "max", "exp", "ctx", "den", "full")
SINK_STAGES = STAGES[1:-1]  # the stages that sum per-head sinks
ABLATIONS = ("noshift", "thin16", "noexp", "bf16exp", "nomask", "noden", "noattn", "noffn")
ATTENTION_CUTS = ABLATIONS[:6]  # the cuts inside the Cauchy–Schwarz attention

# kernel launches by entry point; chip_smoke.py reads and resets them
launches_abc = 0
launches_d = 0
launches_parts = 0
launches_ablate = 0


def _attn_a(q, k, v, inv_temp: float):
    probs = torch.softmax(_mm(q, k.transpose(-1, -2)) * inv_temp, dim=-1).to(q.dtype)
    return _mm(probs, v).to(q.dtype)


def _row_sums(e):
    """den as the script takes it: a product of e with a column of ones."""
    return _mm(e, torch.ones_like(e[..., :1]))


def _attn_b(q, k, v, inv_temp: float):
    """As fft_block.exact_max_attention without its clamp of den (den >= 1
    here), den taken as a product with a column of ones."""
    cd = q.dtype
    s = _mm(q, k.transpose(-1, -2))
    e = torch.exp((s - s.amax(dim=-1, keepdim=True)) * inv_temp).to(cd)
    return (_mm(e, v) / _row_sums(e)).to(cd)


def _attn_c(q, k, v, inv_temp: float):
    cd = q.dtype
    d_k = q.shape[-1]
    va = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    s = _mm(q, k.transpose(-1, -2))
    e = torch.exp((s - s.amax(dim=-1, keepdim=True)) * inv_temp).to(cd)
    nd = _mm(e, va)
    return (nd[..., :d_k] / nd[..., d_k:]).to(cd)


def _attn_d(q, k, v, inv_temp: float):
    cd = q.dtype
    qf, kf = q.float(), k.float()
    qn = (qf * qf).sum(-1, keepdim=True).sqrt()
    kn = (kf * kf).sum(-1, keepdim=True).amax(dim=-2, keepdim=True).sqrt()
    shift = qn * kn * inv_temp  # (B, H, L, 1), pre-tempered
    e = torch.exp(_mm(q, k.transpose(-1, -2)) * inv_temp - shift).to(cd)
    return (_mm(e, v) / (_row_sums(e) + 1e-30)).to(cd)


_ATTENTION = {"a": _attn_a, "b": _attn_b, "c": _attn_c, "d": _attn_d}


def _variant_reference(x, block, n_head, variant):
    return block_reference(x, block, n_head, _ATTENTION[variant]).to(x.dtype)


def fused_abc_reference(x: torch.Tensor, block: dict, n_head: int,
                        variant: str = "b") -> torch.Tensor:
    _check_choice(variant, ABC_VARIANTS, "variant")
    return _variant_reference(x, block, n_head, variant)


def fused_d_reference(x: torch.Tensor, block: dict, n_head: int,
                      variant: str = "b") -> torch.Tensor:
    _check_choice(variant, D_VARIANTS, "variant")
    return _variant_reference(x, block, n_head, variant)


def fused_parts_reference(x: torch.Tensor, block: dict, n_head: int,
                          stage: str = "full") -> torch.Tensor:
    """The block cut after `stage`, with profile_parts2.py's sinks."""
    _check_stage(stage, x.shape[1], x.shape[2] // n_head)
    if stage == "full":
        return _variant_reference(x, block, n_head, "b")
    out = []

    def sink(q, k, v, inv_temp):  # (B, H, L, d_k) each
        cd, d_k = q.dtype, q.shape[-1]
        if stage == "proj":
            out.append((q + k + v).transpose(1, 2).reshape(x.shape))
            return q
        acc = torch.zeros(q.shape[0], q.shape[2], d_k, device=q.device)
        for h in range(q.shape[1]):
            scores = _mm(q[:, h], k[:, h].transpose(-1, -2))  # (B, L, L) f32
            if stage == "scores":
                acc = acc + scores[:, :, :d_k]
                continue
            m = scores.amax(dim=-1, keepdim=True)
            if stage == "max":
                acc = acc + (scores[:, :, :d_k] + m)
                continue
            e = torch.exp((scores - m) * inv_temp).to(cd)
            if stage == "exp":
                acc = acc + e[:, :, :d_k].float()
                continue
            num = _mm(e, v[:, h])
            if stage == "ctx":
                acc = acc + num
                continue
            acc = acc + (num / _row_sums(e)).to(cd).float()
        out.append(torch.cat([acc.to(x.dtype)] * q.shape[1], dim=-1))
        return q

    block_reference(x, block, n_head, sink)  # the tail's result is dropped
    return out[0]


def _pad8(L: int) -> int:
    return -(-L // 8) * 8


def packed_cut_attention(q, k, v, inv_temp: float, ablate: str, L_real: int):
    """`_attn_packed` with one of ATTENTION_CUTS, on head-split (B, H, L,
    d_k) compute-dtype tensors whose keys from L_real on are padding.
    Returns ctx of the same shape and dtype."""
    cd, n_head, L = q.dtype, q.shape[1], q.shape[2]
    s = _mm(q, k.transpose(-1, -2))  # (B, H, L, L) f32, un-tempered
    if ablate == "thin16":  # channels 0..15: heads 0 and 1 only
        s = torch.where(torch.arange(n_head, device=s.device)[:, None, None] < 2, s, 0.0)
    if ablate == "noshift":
        shift = 0.0
    else:
        qn = q.float().square().sum(-1, keepdim=True).sqrt()
        kn = k[:, :, :L_real].float().square().sum(-1).amax(-1, keepdim=True).sqrt()[..., None]
        shift = qn * kn * inv_temp
    arg = s * inv_temp - shift
    if ablate == "noexp":
        e = arg
    elif ablate == "bf16exp":
        e = torch.exp(arg.to(cd)).float()
    else:
        e = torch.exp(arg)
    if ablate != "nomask" and L_real < L:
        e[..., L_real:] = 0.0
    e = e.to(cd)
    num = _mm(e, v)
    if ablate == "noden":
        return num.to(cd)
    return (num / e.float().sum(-1, keepdim=True).clamp_min(1e-30)).to(cd)


def fused_ablate_reference(x: torch.Tensor, block: dict, n_head: int,
                           packed: bool | None = None, ablate: str = "noattn") -> torch.Tensor:
    """The block with the cut `ablate` (one of ABLATIONS; module docstring)
    in plain PyTorch. x: (B, L, D) in the compute dtype -> x.dtype."""
    _check_choice(ablate, ABLATIONS, "ablate")
    L = x.shape[1]
    if packed is None:
        packed = packed_default(L)
    if ablate == "noattn":
        def attention(q, k, v, inv_temp):
            return q
    elif not packed:
        attention = exact_max_attention
    elif ablate == "noffn":
        attention = packed_attention_attend
    else:
        def attention(q, k, v, inv_temp):
            return packed_cut_attention(q, k, v, inv_temp, ablate, L)
    if packed and ablate == "nomask":  # the TPU kernel's zero rows up to pad8(L)
        x = torch.nn.functional.pad(x, (0, 0, 0, _pad8(L) - L))
    out = block_reference(x, block, n_head, attention, ffn=ablate != "noffn")
    return out[:, :L].to(x.dtype)


def _check_choice(value: str, choices, what: str) -> None:
    if value not in choices:
        raise ValueError(f"{what} must be one of {choices}, not {value!r}")


def _check_stage(stage: str, L: int, d_k: int) -> None:
    _check_choice(stage, STAGES, "stage")
    if stage not in ("proj", "full") and L < d_k:
        raise ValueError(f"stage {stage!r} sinks the first {d_k} key columns; got L={L}")


def shared_memory_bytes(L: int, dtype: torch.dtype, sink: bool = False) -> int:
    """Dynamic shared memory of one thread block of these kernels: the Python
    twin of variants_smem_bytes in csrc/fft_block_variants.cu. bfloat16: the
    tensor-core body's (`slab_shared_memory_bytes`), plus with `sink` (the
    stages of SINK_STAGES) an L x 8 f32 buffer per head, L padded to 16
    rows; float32: the CUDA-core body's."""
    if dtype == torch.bfloat16:
        return slab_shared_memory_bytes(L) + (N_HEAD * _padded(L) * 8 * 4 if sink else 0)
    return cuda_core_shared_memory_bytes(L, dtype)


def _launch(entry: str, x, block, n_head, option: int, sink: bool = False) -> torch.Tensor:
    check_input(x, n_head, entry)
    return launch_kernel(entry, x, _weight_pointers(block, x.dtype, x.device), option,
                         check=lambda L, dtype, name: _check_length(L, dtype, name, sink))


def _check_length(L: int, dtype: torch.dtype, entry: str, sink: bool = False) -> None:
    """The ceiling of `shared_memory_bytes`, with no way out to name: these
    kernels exist only to be timed."""
    _build.check_shared_memory(entry, L, dtype, lambda n: shared_memory_bytes(n, dtype, sink))


def fused_abc(x: torch.Tensor, block: dict, n_head: int, variant: str = "b") -> torch.Tensor:
    """One block with softmax ordering a, b or c (module docstring). x: (B, L, D)."""
    global launches_abc
    if not x.is_cuda:
        return fused_abc_reference(x, block, n_head, variant)
    _check_choice(variant, ABC_VARIANTS, "variant")
    out = _launch("s2s_fft_block_abc", x, block, n_head, ABC_VARIANTS.index(variant))
    if x.shape[0]:
        with _build.COUNT_LOCK:
            launches_abc += 1
    return out


def fused_d(x: torch.Tensor, block: dict, n_head: int, variant: str = "b") -> torch.Tensor:
    """One block with the exact row max (b) or the per-head Cauchy–Schwarz
    shift (d). x: (B, L, D)."""
    global launches_d
    if not x.is_cuda:
        return fused_d_reference(x, block, n_head, variant)
    _check_choice(variant, D_VARIANTS, "variant")
    out = _launch("s2s_fft_block_d", x, block, n_head, D_VARIANTS.index(variant))
    if x.shape[0]:
        with _build.COUNT_LOCK:
            launches_d += 1
    return out


def fused_parts(x: torch.Tensor, block: dict, n_head: int, stage: str = "full") -> torch.Tensor:
    """One block cut after `stage` (one of STAGES). x: (B, L, D)."""
    global launches_parts
    if not x.is_cuda:
        return fused_parts_reference(x, block, n_head, stage)
    _check_stage(stage, x.shape[1], x.shape[2] // n_head)
    out = _launch("s2s_fft_block_parts", x, block, n_head, STAGES.index(stage),
                  sink=stage in SINK_STAGES)
    if x.shape[0]:
        with _build.COUNT_LOCK:
            launches_parts += 1
    return out


def fused_ablate(x: torch.Tensor, block: dict, n_head: int, packed: bool | None = None,
                 ablate: str = "noattn") -> torch.Tensor:
    """One block with the cut `ablate` (one of ABLATIONS; module docstring),
    in the softmax form `packed` (None: by length, as the fused block).
    x: (B, L, D). `fused_fft_block(..., ablate=...)` calls this."""
    global launches_ablate
    if not x.is_cuda:
        return fused_ablate_reference(x, block, n_head, packed, ablate)
    _check_choice(ablate, ABLATIONS, "ablate")
    exact = not (packed_default(x.shape[1]) if packed is None else packed)
    # the C knob: 2·(cut index + 1) + exact
    out = _launch("s2s_fft_block_ablate", x, block, n_head,
                  2 * (ABLATIONS.index(ablate) + 1) + int(exact))
    if x.shape[0]:
        with _build.COUNT_LOCK:
            launches_ablate += 1
    return out


# the cuts that move the bf16 block's output by less than its bar (4 bf16 ULPs)
QUIET_CUTS = ("noshift", "bf16exp", "nomask", "thin16")


def check_cut_taken(cut: str, packed: bool, L: int, got, ref, uncut_got, uncut_ref):
    """Evidence that a bf16 cut kernel took its cut, where the output bar
    cannot show it (QUIET_CUTS). got, ref: the cut's kernel output and plain
    version; uncut_got, uncut_ref: the uncut block's, in the same softmax
    form, on the same x. Raises AssertionError where the evidence fails.

    - exact form: the attention cuts launch the uncut kernel: bit-equal to it;
    - noshift, bf16exp (a change of rounding only): not bit-equal to it;
    - thin16, and nomask where the biases' keys are 5 % of the keys or more
      (L = 37: 3 of 40; at L = 250, 6 of 256, the cut moves the output by
      less than the kernel's rounding): mean|got − ref| under half of
      mean|ref − uncut_ref|, so the kernel is nearer its own plain version
      than the uncut one. Returns that ratio (else None)."""
    if cut not in QUIET_CUTS:
        return None
    if not packed:
        if not torch.equal(got, uncut_got):
            raise AssertionError(f"{cut}, exact form: not bit-equal to the uncut block")
        return None
    if cut in ("noshift", "bf16exp"):
        if torch.equal(got, uncut_got):
            raise AssertionError(f"{cut}: bit-equal to the uncut block")
        return None
    pad = _pad8(L) - L
    if cut == "nomask" and 20 * pad < _pad8(L):
        return None
    moved = (ref.float() - uncut_ref.float()).abs().mean().item()
    off = (got.float() - ref.float()).abs().mean().item()
    if not off < 0.5 * moved:
        raise AssertionError(f"{cut} at L = {L}: mean|kernel - plain| {off:.3g} is not under "
                             f"half of the cut's mean move {moved:.3g}")
    return off / moved
