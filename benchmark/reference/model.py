"""seq2squiggle's feed-forward transformer in plain PyTorch.

The architecture of the published model (seq2squiggle's config.yaml and
model code; FastSpeech's FFT blocks with post-LayerNorm):

  one-hot k-mers (B, K, k*5) -> src_emb -> ReLU -> pre_net x (Linear -> ReLU)   [emb]
    -> + sinusoid table -> encoder FFT blocks                                    [enc]
  heads on emb: noise stdev, Gamma concentration and rate, each
    Linear -> ReLU -> (Dropout) -> Linear -> Softplus
  frames (B, T, D) regulated from enc -> + sinusoid table -> decoder FFT blocks
    -> Linear(D -> 1) -> ReLU

An FFT block: multi-head self-attention (scores / sqrt(d_k), softmax),
output projection, dropout, residual, LayerNorm; then w_1 -> ReLU -> w_2,
dropout, residual, LayerNorm. No key-padding mask (the program passes none).

Parameters are a flat dict {"encoder/blocks/0/attn/w_qs/kernel": tensor, ...}
(kernels (in, out)), the layout of the weights files. `Precision` says where
values are rounded: at float32 nowhere; for a control, to a narrower type at
the points where a compute dtype applies (matrix operands and each linear's,
LayerNorm's and softmax's output), products accumulated in float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


class Precision:
    """Rounding to `dtype` (None: float32 throughout). The rounding is seen
    by the forward only: gradients pass it unchanged in float32, as a
    training step at that precision keeps them (scaled) above underflow."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        self.dtype = dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return x
        if self.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            lim = float(torch.finfo(self.dtype).max)
            x = x.clamp(-lim, lim)
        return x + (x.detach().to(self.dtype).float() - x.detach())


F32 = Precision()
PRECISIONS = {"float32": F32, "bfloat16": Precision(torch.bfloat16),
              "float8_e4m3": Precision(torch.float8_e4m3fn)}


def load_weights(path: str, device="cpu") -> Params:
    """A weights file (.npz of float32 arrays under slash paths)."""
    with np.load(path) as z:
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
                for k in z.files if z[k].dtype.kind == "f"}


def linear(P: Params, name: str, x: torch.Tensor, q: Precision) -> torch.Tensor:
    return q(q(x) @ q(P[name + "/kernel"]) + P[name + "/bias"])


def layer_norm(P: Params, name: str, x: torch.Tensor, q: Precision,
               eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return q((x - mu) * torch.rsqrt(var + eps) * P[name + "/scale"] + P[name + "/bias"])


def dropout(x: torch.Tensor, keep_mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    if keep_mask is None:
        return x
    return torch.where(keep_mask, x / (1.0 - rate), torch.zeros_like(x))


def fft_block(P: Params, name: str, x: torch.Tensor, n_head: int, q: Precision,
              masks=(None, None), rate: float = 0.0) -> torch.Tensor:
    B, L, D = x.shape
    dk = D // n_head
    a = name + "/attn/"
    heads = [linear(P, a + w, x, q).reshape(B, L, n_head, dk).transpose(1, 2)
             for w in ("w_qs", "w_ks", "w_vs")]
    qh, kh, vh = heads
    scores = (q(qh) @ q(kh).transpose(-1, -2)) / math.sqrt(dk)
    attn = q(torch.softmax(scores, dim=-1))
    ctx = q(attn @ q(vh)).transpose(1, 2).reshape(B, L, D)
    out = dropout(linear(P, a + "fc", ctx, q), masks[0], rate)
    x = layer_norm(P, a + "ln", out + x, q)
    f = name + "/ffn/"
    h = F.relu(linear(P, f + "w_1", x, q))
    out = dropout(linear(P, f + "w_2", h, q), masks[1], rate)
    return layer_norm(P, f + "ln", out + x, q)


def one_hot(codes: torch.Tensor, n_chars: int) -> torch.Tensor:
    """(B, K, k) base codes -> (B, K, k * n_chars); a code >= n_chars is all zero."""
    B, K, k = codes.shape
    return (codes.long()[..., None] == torch.arange(n_chars, device=codes.device)
            ).float().reshape(B, K, k * n_chars)


def embed(P: Params, x: torch.Tensor, cfg: dict, q: Precision) -> torch.Tensor:
    """The pre-positional tap that feeds the heads, (B, K, D)."""
    h = F.relu(linear(P, "encoder/src_emb", x, q))
    for i in range(cfg["pre_layers"]):
        h = F.relu(linear(P, f"encoder/pre_net/{i}", h, q))
    return h


def encode(P: Params, emb: torch.Tensor, cfg: dict, q: Precision,
           masks=None, rate: float = 0.0) -> torch.Tensor:
    h = q(emb + P["encoder/pos_enc"][: emb.shape[1]])
    for i in range(cfg["encoder_layers"]):
        m = masks[i] if masks is not None else (None, None)
        h = fft_block(P, f"encoder/blocks/{i}", h, cfg["encoder_heads"], q, m, rate)
    return h


def decode(P: Params, frames: torch.Tensor, cfg: dict, q: Precision,
           masks=None, rate: float = 0.0) -> torch.Tensor:
    """(B, T, D) regulated frames -> (B, T) current, >= 0 (the model's unit: pA / 165)."""
    h = q(frames + P["decoder/pos_enc"][: frames.shape[1]])
    for i in range(cfg["decoder_layers"]):
        m = masks[i] if masks is not None else (None, None)
        h = fft_block(P, f"decoder/blocks/{i}", h, cfg["decoder_heads"], q, m, rate)
    return F.relu(linear(P, "decoder/out_linear", h, q))[..., 0]


def head(P: Params, name: str, emb: torch.Tensor, keep_mask=None,
         rate: float = 0.0) -> torch.Tensor:
    """An MLP head in float32 (the program computes the heads in float32)."""
    h = dropout(F.relu(emb @ P[name + "/fc1/kernel"] + P[name + "/fc1/bias"]), keep_mask, rate)
    z = h @ P[name + "/fc2/kernel"] + P[name + "/fc2/bias"]
    return torch.logaddexp(z, torch.zeros_like(z))[..., 0]
