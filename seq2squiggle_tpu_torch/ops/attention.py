"""Post-LN FFT block in plain PyTorch: the port of seq2squiggle_tpu/ops/attention.py.

Inference only (no masks, no dropout): this is the block the model runs when
the fused kernel is not selected, i.e. float32 compute or `use_pallas: false`.

Numerics follow the JAX package: every product multiplies compute-dtype
operands and accumulates in float32 (the f32 matmul runs at full precision,
TF32 off; see device.py), the bias is added in float32 and the result is cast
to the compute dtype once. A bf16 `torch.matmul` would round before the bias
add, so `linear` multiplies the bf16-valued operands as float32: each product
is exact and only the summation order differs from XLA's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense layer; p = {"kernel": (in, out), "bias": (out,)}."""
    w = p["kernel"].to(x.dtype).float()
    y = torch.matmul(x.float(), w) + p["bias"].float()
    return y.to(x.dtype)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    out = normed * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def multi_head_attention(p: dict, x: torch.Tensor, n_head: int) -> torch.Tensor:
    """Self-attention with post-LN residual. x: (B, L, D)."""
    B, L, D = x.shape
    d_k = D // n_head
    q = linear(p["w_qs"], x).reshape(B, L, n_head, d_k).transpose(1, 2)
    k = linear(p["w_ks"], x).reshape(B, L, n_head, d_k).transpose(1, 2)
    v = linear(p["w_vs"], x).reshape(B, L, n_head, d_k).transpose(1, 2)
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = attn / math.sqrt(d_k)
    attn = torch.softmax(attn, dim=-1).to(x.dtype)
    out = torch.matmul(attn.float(), v.float()).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, L, D)
    out = linear(p["fc"], out)
    return layer_norm(p["ln"], out + x)


def positionwise_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(linear(p["w_1"], x))
    out = linear(p["w_2"], h)
    return layer_norm(p["ln"], out + x)


def fft_block(p: dict, x: torch.Tensor, n_head: int) -> torch.Tensor:
    x = multi_head_attention(p["attn"], x, n_head)
    return positionwise_ffn(p["ffn"], x)
