"""Post-LN FFT block in plain PyTorch: the port of seq2squiggle_tpu/ops/attention.py.

This is the block the model runs when the fused inference kernel is not
selected (float32 compute or `use_pallas: false`) and the block that trains:
with a dropout key it drops as the JAX package does (same threefry keys, same
masks), and `packed_core=True` swaps the softmax core for the hand-written
forward and backward attention-core kernels (ops/attn_core.py). Key-padding
masks are not ported (the predict and train paths pass none).

Under a mesh (parallel/mesh.py) with tp > 1 the block is Megatron's: the
weights are the rank's shards (q/k/v and w_1 column-parallel, so the rank owns
n_head / tp whole heads; fc and w_2 row-parallel, summed over tp before their
bias), and the dropout masks are drawn at the global batch's shape and cut to
the rank's dp slab, which is the JAX package's draw on its shard. The masks
follow fc and w_2, where every tp rank holds the whole width, so tp does not
cut them.

Numerics follow the JAX package: every product multiplies compute-dtype
operands and accumulates in float32 (the f32 matmul runs at full precision,
TF32 off; see device.py), the bias is added in float32 and the result is cast
to the compute dtype once. A bf16 `torch.matmul` would round before the bias
add, so `linear` multiplies the bf16-valued operands as float32: each product
is exact and only the summation order differs from XLA's.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import tracing
from ..parallel.mesh import copy_to_tp, global_rows, reduce_from_tp
from . import threefry


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense layer; p = {"kernel": (in, out), "bias": (out,)}."""
    w = p["kernel"].to(x.dtype).float()
    y = torch.matmul(x.float(), w) + p["bias"].float()
    return y.to(x.dtype)


def row_parallel_linear(p: dict, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """`linear` over a row-parallel shard: the f32 partial products summed
    over tp, then the (replicated) bias, then one cast."""
    w = p["kernel"].to(x.dtype).float()
    y = reduce_from_tp(torch.matmul(x.float(), w), mesh) + p["bias"].float()
    return y.to(x.dtype)


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    out = normed * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def dropout_mask(key: torch.Tensor, keep: float, shape, mesh=None) -> torch.Tensor:
    """jax.random.bernoulli(key, keep, shape) for the global batch, cut to
    this rank's dp slab of `shape[0]` rows (a `train.masks` span; one launch
    on the card, ops/threefry.py)."""
    rows, start = global_rows(mesh, shape[0])
    with tracing.span("train.masks"):
        return threefry.bernoulli(key, keep, shape, rows, start)


@functools.cache
def _keep_divisor(keep: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`keep` rounded to `dtype` (exact in float32) as a 0-dim float32 tensor
    on `device`, made once by `full`, a fill and no copy from host memory: a
    divisor on the device divides where a Python number would multiply by
    its reciprocal on the card, and the train step's CUDA graph holds it."""
    return torch.full((), float(torch.tensor(keep, dtype=dtype)), dtype=torch.float32,
                      device=device)


def _maybe_dropout(x: torch.Tensor, rate: float,
                   key: Optional[torch.Tensor], mesh=None) -> torch.Tensor:
    """Inverted dropout with jax.random.bernoulli's mask for `key`.

    The JAX package divides in the compute dtype, where its Python `keep` is
    rounded to that dtype first (0.8 -> 0.80078125 in bf16); so is it here."""
    if key is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = dropout_mask(key, keep, x.shape, mesh)
    keep_cd = _keep_divisor(keep, x.dtype, x.device)
    return torch.where(mask, (x.float() / keep_cd).to(x.dtype), torch.zeros_like(x))


def multi_head_attention(p: dict, x: torch.Tensor, n_head: int,
                         dropout_rate: float = 0.0,
                         dropout_key: Optional[torch.Tensor] = None,
                         packed_core: bool = False, mesh=None) -> torch.Tensor:
    """Self-attention with post-LN residual. x: (B, L, D).

    packed_core=True runs the core through ops.attn_core.PackedAttentionCore
    (hand-written forward and backward kernels on a CUDA tensor); projections,
    dropout and LayerNorm are the same in both branches. Under tp the rank
    runs its own heads: q, k, v and the core are (B, L, D / tp)."""
    B, L, D = x.shape
    n_local = n_head // (mesh.n_tp if mesh is not None else 1)
    d_k = D // n_head
    x_tp = copy_to_tp(x, mesh)
    if packed_core:
        from .attn_core import PackedAttentionCore

        out = PackedAttentionCore.apply(linear(p["w_qs"], x_tp), linear(p["w_ks"], x_tp),
                                        linear(p["w_vs"], x_tp), n_local)
    else:
        q = linear(p["w_qs"], x_tp).reshape(B, L, n_local, d_k).transpose(1, 2)
        k = linear(p["w_ks"], x_tp).reshape(B, L, n_local, d_k).transpose(1, 2)
        v = linear(p["w_vs"], x_tp).reshape(B, L, n_local, d_k).transpose(1, 2)
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = attn / math.sqrt(d_k)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn.float(), v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(B, L, n_local * d_k)
    out = row_parallel_linear(p["fc"], out, mesh)
    out = _maybe_dropout(out, dropout_rate, dropout_key, mesh)
    return layer_norm(p["ln"], out + x)


def positionwise_ffn(p: dict, x: torch.Tensor, dropout_rate: float = 0.0,
                     dropout_key: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    h = F.relu(linear(p["w_1"], copy_to_tp(x, mesh)))
    out = row_parallel_linear(p["w_2"], h, mesh)
    out = _maybe_dropout(out, dropout_rate, dropout_key, mesh)
    return layer_norm(p["ln"], out + x)


def fft_block(p: dict, x: torch.Tensor, n_head: int, dropout_rate: float = 0.0,
              dropout_key: Optional[torch.Tensor] = None,
              packed_core: bool = False, mesh=None) -> torch.Tensor:
    """dropout_key: the attention-out and FFN-out dropout keys (2, 2), the
    split of the block's key as the training path derives it (the JAX
    package's fft_block takes the block's key and splits it itself)."""
    key_a, key_f = (None, None) if dropout_key is None else dropout_key
    x = multi_head_attention(p["attn"], x, n_head, dropout_rate=dropout_rate,
                             dropout_key=key_a, packed_core=packed_core, mesh=mesh)
    return positionwise_ffn(p["ffn"], x, dropout_rate=dropout_rate, dropout_key=key_f,
                            mesh=mesh)
