"""Profiling variants of the fused FFT block: the ports of the three Pallas
timing kernels under scripts/profiling/ of the JAX package,

  profile_abc.py::fused    -> fused_abc(x, block, n_head, variant)   a, b, c
  profile_d.py::fused      -> fused_d(x, block, n_head, variant)     b, d
  profile_parts2.py::fused -> fused_parts(x, block, n_head, stage)   proj ... full

They time what each piece of the attention costs inside the fused block
(`scripts/profile_torch_block_variants.py` runs them on the card); the model
never calls them. Each is one launch of `csrc/fft_block_variants.cu`: the
CUDA-core body's projections and tail (`csrc/fft_block_body.cuh`, the float32
fused block's) around another attention, one thread per query walking the
heads, in both dtypes. They are bound by the issue rate of f32 loops over
shared memory, not by device memory.

  a  softmax in f32 on the tempered scores, probabilities cast to the compute
     dtype, then probs·v cast: the form before the block's softmax was
     restructured
  b  the block's exact-max form (`fused_fft_block(packed=False)`, bit-equal
     to it in float32): one exp pass cast to the compute dtype, den summed
     from the cast values, the divide after e·v
  c  b with den as a ninth column of the e·v product (v extended by a column
     of ones). On the TPU that saves a matrix product; on this card den is
     already summed inside the e·v loop, so c's arithmetic is b's and the
     kernel is held bit-equal to b
  d  the per-head Cauchy–Schwarz shift ‖q_t‖·max_s‖k_s‖/√d_k and den + 1e-30
     (the fused block's packed form clamps den at 1e-30 instead)
  stages  the block cut after proj, scores, max, exp, ctx or den; what was
     computed is folded into the output by the script's own sinks (q + k + v;
     the first d_k key columns of the scores, of scores + max, of e; num;
     cast(num / den)), summed over the heads in f32 and tiled n_head times
     along D. `full` is b. From scores on a stage needs L >= d_k.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version, which follows the script's arithmetic line by line.
"""

from __future__ import annotations

import torch

from . import _build
from .fft_block import (
    _mm, _weight_pointers, block_reference, check_input, cuda_core_shared_memory_bytes,
    launch_kernel,
)

ABC_VARIANTS = ("a", "b", "c")
D_VARIANTS = ("b", "d")
STAGES = ("proj", "scores", "max", "exp", "ctx", "den", "full")

# kernel launches by entry point; chip_smoke.py reads and resets them
launches_abc = 0
launches_d = 0
launches_parts = 0


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


def _check_choice(value: str, choices, what: str) -> None:
    if value not in choices:
        raise ValueError(f"{what} must be one of {choices}, not {value!r}")


def _check_stage(stage: str, L: int, d_k: int) -> None:
    _check_choice(stage, STAGES, "stage")
    if stage not in ("proj", "full") and L < d_k:
        raise ValueError(f"stage {stage!r} sinks the first {d_k} key columns; got L={L}")


def _launch(entry: str, x, block, n_head, option: int) -> torch.Tensor:
    check_input(x, n_head, entry)
    return launch_kernel(entry, x, _weight_pointers(block, x.dtype, x.device), option,
                         check=_check_length)


def _check_length(L: int, dtype: torch.dtype, entry: str) -> None:
    """The CUDA-core body's ceiling (csrc/fft_block_body.cuh), with no way
    out to name: the variants exist only to be timed."""
    _build.check_shared_memory(entry, L, dtype,
                               lambda n: cuda_core_shared_memory_bytes(n, dtype))


def fused_abc(x: torch.Tensor, block: dict, n_head: int, variant: str = "b") -> torch.Tensor:
    """One block with softmax ordering a, b or c (module docstring). x: (B, L, D)."""
    global launches_abc
    if not x.is_cuda:
        return fused_abc_reference(x, block, n_head, variant)
    _check_choice(variant, ABC_VARIANTS, "variant")
    out = _launch("s2s_fft_block_abc", x, block, n_head, ABC_VARIANTS.index(variant))
    if x.shape[0]:
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
        launches_d += 1
    return out


def fused_parts(x: torch.Tensor, block: dict, n_head: int, stage: str = "full") -> torch.Tensor:
    """One block cut after `stage` (one of STAGES). x: (B, L, D)."""
    global launches_parts
    if not x.is_cuda:
        return fused_parts_reference(x, block, n_head, stage)
    _check_stage(stage, x.shape[1], x.shape[2] // n_head)
    out = _launch("s2s_fft_block_parts", x, block, n_head, STAGES.index(stage))
    if x.shape[0]:
        launches_parts += 1
    return out
