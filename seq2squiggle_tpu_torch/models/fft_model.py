"""FastSpeech-style feed-forward transformer: the port of
seq2squiggle_tpu/models/fft_model.py (inference only).

  one-hot k-mers (B, K, k*5)
    -> src_emb Linear -> ReLU -> pre_layers x (Linear -> ReLU)   [= emb_out]
    -> + sinusoid PE -> encoder_layers x FFT block                [= enc_out]
  noise head / duration head on emb_out (float32)
  decoder: + sinusoid PE -> decoder_layers x FFT block -> Linear(D->1) -> ReLU

Parameters are the JAX package's tree as torch tensors (models/weights.py).
`to_device` moves them to the run's device once and casts the FFT blocks'
matrices to the compute dtype there, so no call casts weights again.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from seq2squiggle_tpu.ops.positional import sinusoid_encoding_table

from .. import prng
from ..ops.attention import fft_block, linear
from ..ops.fft_block import fused_fft_block


def compute_dtype(config: dict) -> torch.dtype:
    return torch.bfloat16 if config.get("compute_dtype") == "bfloat16" else torch.float32


def _use_fused_blocks(config: dict, x: torch.Tensor) -> bool:
    """The hand-written block kernel is the bf16 path on the GPU; float32
    fidelity mode and the CPU take the plain blocks. `use_pallas: true`
    forces the kernel (any dtype), `false` forbids it."""
    mode = config.get("use_pallas", "auto")
    if mode is True:
        return True
    if mode == "auto":
        return x.dtype == torch.bfloat16 and x.is_cuda
    return False


def _check_kernel_knobs(config: dict) -> None:
    if config.get("pallas_pair", "auto") not in ("auto", False):
        raise NotImplementedError(
            "pallas_pair (both decoder blocks in one kernel) is not ported to "
            "the GPU yet: ROADMAP.md, kernel queue B5")
    if config.get("pallas_packed", "auto") != "auto":
        raise NotImplementedError(
            "pallas_packed is not a knob of the GPU block kernel: it picks the "
            "softmax shift by sequence length, as pallas_packed: auto does")


def _blocks(blocks, h: torch.Tensor, n_head: int, config: dict) -> torch.Tensor:
    if _use_fused_blocks(config, h):
        _check_kernel_knobs(config)
        for block in blocks:
            h = fused_fft_block(h, block, n_head)
        return h
    for block in blocks:
        h = fft_block(block, h, n_head)
    return h


# ---------------------------------------------------------------------------
# Initialisation (draw for draw with jax.random; see prng.py)
# ---------------------------------------------------------------------------


def _init_linear(key: torch.Tensor, d_in: int, d_out: int) -> dict:
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    k_key, b_key = prng.split(key)
    bound = 1.0 / np.sqrt(d_in)
    return {"kernel": prng.uniform(k_key, (d_in, d_out), -bound, bound),
            "bias": prng.uniform(b_key, (d_out,), -bound, bound)}


def _init_ln(d: int) -> dict:
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def _init_block(key: torch.Tensor, d_model: int, d_inner: int) -> dict:
    keys = prng.split(key, 6)
    return {
        "attn": {
            "w_qs": _init_linear(keys[0], d_model, d_model),
            "w_ks": _init_linear(keys[1], d_model, d_model),
            "w_vs": _init_linear(keys[2], d_model, d_model),
            "fc": _init_linear(keys[3], d_model, d_model),
            "ln": _init_ln(d_model),
        },
        "ffn": {
            "w_1": _init_linear(keys[4], d_model, d_inner),
            "w_2": _init_linear(keys[5], d_inner, d_model),
            "ln": _init_ln(d_model),
        },
    }


def _init_mlp_head(key: torch.Tensor, d: int) -> dict:
    k1, k2 = prng.split(key)
    return {"fc1": _init_linear(k1, d, d), "fc2": _init_linear(k2, d, 1)}


def init_params(config: dict, key: torch.Tensor) -> dict:
    """A fresh model, bit for bit the JAX package's init_params(config, key)."""
    d = config["dmodel"]
    dff = config["dff"]
    n_vocab = len(config["allowed_chars"]) * config["seq_kmer"]
    keys = prng.split(key, 16)
    encoder = {
        "src_emb": _init_linear(keys[0], n_vocab, d),
        "pre_net": [_init_linear(keys[1 + i], d, d) for i in range(config["pre_layers"])],
        "pos_enc": torch.from_numpy(sinusoid_encoding_table(config["max_dna_len"], d)),
        "blocks": [_init_block(keys[5 + i], d, dff)
                   for i in range(config["encoder_layers"])],
    }
    decoder = {
        "pos_enc": torch.from_numpy(sinusoid_encoding_table(config["max_signal_len"], d)),
        "blocks": [_init_block(keys[9 + i], d, dff)
                   for i in range(config["decoder_layers"])],
        "out_linear": _init_linear(keys[13], d, 1),
    }
    dur_keys = prng.split(keys[15])
    return {
        "encoder": encoder,
        "decoder": decoder,
        "noise_sampler": _init_mlp_head(keys[14], d),
        "duration_sampler": {"conc": _init_mlp_head(dur_keys[0], d),
                             "rate": _init_mlp_head(dur_keys[1], d)},
    }


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def count_params(params: dict) -> int:
    """Trainable scalars (positional tables excluded, as in the reference)."""
    return int(sum(v.numel() for p, v in _leaves(params) if "pos_enc" not in p))


def to_device(params: dict, device: torch.device, dtype: torch.dtype) -> dict:
    """Move the tree to `device` in float32, with the FFT blocks' matrices in
    the compute dtype `dtype` (what the block kernel reads)."""

    def conv(tree, in_block=False):
        if isinstance(tree, dict):
            return {k: (conv(v, in_block) if k != "kernel" or not in_block
                        else v.to(device=device, dtype=dtype).contiguous())
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v, in_block) for v in tree]
        return tree.to(device=device, dtype=torch.float32).contiguous()

    out = {}
    for name, sub in params.items():
        if name in ("encoder", "decoder"):
            out[name] = {k: conv(v, in_block=(k == "blocks")) for k, v in sub.items()}
        else:
            out[name] = conv(sub)
    return out


# ---------------------------------------------------------------------------
# Forward passes (inference)
# ---------------------------------------------------------------------------


def encoder_forward(params: dict, one_hot: torch.Tensor,
                    config: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """one_hot: (B, K, k*5). Returns (enc_out, emb_out), both (B, K, D);
    emb_out is the pre-positional-encoding tap that feeds the heads."""
    enc = params["encoder"]
    x = F.relu(linear(enc["src_emb"], one_hot))
    for pre in enc["pre_net"]:
        x = F.relu(linear(pre, x))
    emb_out = x
    h = x + enc["pos_enc"][: x.shape[1]].to(x.dtype)[None]
    return _blocks(enc["blocks"], h, config["encoder_heads"], config), emb_out


def decoder_forward(params: dict, x: torch.Tensor, config: dict) -> torch.Tensor:
    """x: (B, T, D) length-regulated frames. Returns (B, T, 1) current (>= 0)."""
    dec = params["decoder"]
    h = x + dec["pos_enc"][: x.shape[1]].to(x.dtype)[None]
    h = _blocks(dec["blocks"], h, config["decoder_heads"], config)
    return F.relu(linear(dec["out_linear"], h))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _mlp_head(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Linear -> ReLU -> Linear -> Softplus, squeezed to (B, K)."""
    h = F.relu(linear(p["fc1"], x))
    return _softplus(linear(p["fc2"], h).float())[..., 0]


def noise_head(params: dict, emb_out: torch.Tensor, config: dict) -> torch.Tensor:
    """Per-k-mer amplitude-noise stdev, (B, K) float32."""
    return _mlp_head(params["noise_sampler"], emb_out)


def duration_gamma_params(params: dict, emb_out: torch.Tensor, config: dict,
                          epsilon: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gamma (concentration, rate) per k-mer, each (B, K) float32, >= epsilon."""
    dur = params["duration_sampler"]
    conc = _mlp_head(dur["conc"], emb_out)
    rate = _mlp_head(dur["rate"], emb_out)
    return conc.clamp_min(epsilon), rate.clamp_min(epsilon)
