"""FastSpeech-style feed-forward transformer: the port of
seq2squiggle_tpu/models/fft_model.py (inference and training).

  one-hot k-mers (B, K, k*5)
    -> src_emb Linear -> ReLU -> pre_layers x (Linear -> ReLU)   [= emb_out]
    -> + sinusoid PE -> encoder_layers x FFT block                [= enc_out]
  noise head / duration head on emb_out (float32)
  decoder: + sinusoid PE -> decoder_layers x FFT block -> Linear(D->1) -> ReLU

Parameters are the JAX package's tree as torch tensors (models/weights.py).
For inference `to_device` moves them to the run's device once and casts the
FFT blocks' matrices to the compute dtype there, so no call casts weights
again. For training `to_train_params` keeps float32 master weights as leaf
tensors that require a gradient and every use casts them, as `linear` does; the forward passes then take
`train=True`, which keeps them off the fused inference kernel (its pointer
cache assumes read-only blocks) and picks the training rung from
`pallas_train` instead.

The training forwards take a `mesh` (parallel/mesh.py): under dp the rank's
activations are its slab of the batch and the dropout draws are the global
batch's, cut to the slab; under tp the blocks are Megatron's (ops/attention.py)
on the rank's weight shards. The rungs under tp follow the JAX package: `auto`
takes the plain blocks; `core` runs the attention-core kernels on the rank's
own heads (n_head / tp of them, packed at D = 8·n_head / tp); `block` runs the
whole-block kernels on the whole block on every tp rank, its weights gathered
over tp and each weight gradient kept as the rank's own slice (what pjit does
to a pallas_call it cannot shard).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import prng, tracing
from ..ops import threefry
from ..ops.attention import _maybe_dropout, fft_block, linear
from ..ops.block_train import fused_block_train, make_dropout_scales
from ..ops.fft_block import fused_fft_block, fused_fft_block_pair
from ..ops.positional import sinusoid_encoding_table
from ..parallel.mesh import gather_for_kernel


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


def _packed_mode(config: dict):
    """config 'pallas_packed' -> the fused block's `packed` argument: None
    for `auto` (the softmax form by sequence length), else the bool."""
    mode = config.get("pallas_packed", "auto")
    return None if mode == "auto" else bool(mode)


def _pair_mode(config: dict) -> bool:
    """config 'pallas_pair' -> run the decoder's two blocks in one kernel.
    `auto` means off, as in the JAX package: the pair saves one round trip of
    the activation through device memory and costs a fourth shared-memory
    buffer (PERF.md has its time beside two one-block launches)."""
    mode = config.get("pallas_pair", "auto")
    return False if mode == "auto" else bool(mode)


def _train_kernel_mode(config: dict, x: torch.Tensor,
                       on_cuda: Optional[bool] = None) -> str:
    """Which rung the training forward takes for activations x (B, L, D):
    "block" (the whole-block forward and backward kernels, ops/block_train.py),
    "core" (the attention-core kernels, ops/attn_core.py) or "plain" (PyTorch
    blocks). As the JAX package's _train_kernel_mode: short sequences
    (L <= 32, the encoder) stay plain; `pallas_train: true` or `block` takes
    the block rung, `core` the core rung, `false` the plain one; `auto` is
    the block rung in bfloat16 on a GPU and plain otherwise (float32 is the
    fidelity mode). There is no step down to another rung: a kernel that
    fails to build or launch raises. Under tensor parallelism (the config's
    `tensor_parallel` above 1) `auto` is plain, as in the JAX package."""
    if x.shape[1] <= 32:
        return "plain"
    mode = config.get("pallas_train", "auto")
    if mode is True or mode == "block":
        return "block"
    if mode == "core":
        return "core"
    if mode is False:
        return "plain"
    if mode == "auto":
        if on_cuda is None:
            on_cuda = x.is_cuda
        tp = int(config.get("tensor_parallel", 1)) > 1
        return "block" if x.dtype == torch.bfloat16 and on_cuda and not tp else "plain"
    raise ValueError(f"Unknown pallas_train: {mode!r}")


def _dropout_scales(key: torch.Tensor, rate: float, h: torch.Tensor, mesh) -> torch.Tensor:
    """make_dropout_scales at the global batch's shape, cut to the rank's
    slab (a `train.masks` span)."""
    with tracing.span("train.masks"):
        return make_dropout_scales(key, rate, h.shape, h.dtype, mesh)


def _train_blocks(blocks, h: torch.Tensor, n_head: int, config: dict, rate: float,
                  dropout_key: Optional[torch.Tensor], whole_block: bool,
                  mesh=None) -> torch.Tensor:
    """The training forward of a block stack: per-block key fold_in(key, i),
    split into the attention-out and FFN-out dropout keys (every block's in
    one launch on the card). `whole_block` is true for the decoder, which
    takes the block rung where the mode says so; the encoder takes the core
    rung there instead (as the JAX package)."""
    mode = _train_kernel_mode(config, h)
    keys = (threefry.fold_in_split(dropout_key, len(blocks))
            if dropout_key is not None and rate > 0.0 else [None] * len(blocks))
    if mode == "block" and whole_block:
        for block, pair in zip(blocks, keys):
            s_a = s_f = None
            if pair is not None:
                s_a = _dropout_scales(pair[0], rate, h, mesh)
                s_f = _dropout_scales(pair[1], rate, h, mesh)
            h = fused_block_train(h, gather_for_kernel(block, mesh), s_a, s_f, n_head)
        return h
    for block, pair in zip(blocks, keys):
        h = fft_block(block, h, n_head, dropout_rate=rate, dropout_key=pair,
                      packed_core=mode in ("core", "block"), mesh=mesh)
    return h


def _blocks(blocks, h: torch.Tensor, n_head: int, config: dict,
            may_pair: bool = False) -> torch.Tensor:
    """The inference forward of a block stack. `may_pair` is true for the
    decoder, which takes the two-block kernel when `pallas_pair` is on and it
    has exactly two blocks; the encoder never pairs (as the JAX package)."""
    if _use_fused_blocks(config, h):
        packed = _packed_mode(config)
        if may_pair and _pair_mode(config) and len(blocks) == 2:
            return fused_fft_block_pair(h, blocks[0], blocks[1], n_head, packed=packed)
        for block in blocks:
            h = fused_fft_block(h, block, n_head, packed=packed)
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


def to_train_params(params: dict, device: torch.device) -> dict:
    """The tree as float32 master weights on `device`, every leaf a tensor
    with requires_grad. That includes the two `pos_enc` tables: the JAX
    package differentiates its whole parameter tree, so its optimizer moves
    them too (and counts their gradient in the clipping norm), although
    `count_params` leaves them out as the upstream reference does. The port
    follows the JAX package, so that steps, checkpoints and optimizer states
    agree between the two."""

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        t = tree.detach().to(device=device, dtype=torch.float32).clone().contiguous()
        return t.requires_grad_(True)

    return conv(params)


def tree_leaves(params: dict):
    """[(path tuple, leaf)] in sorted-key order (lists in index order): the
    order jax.tree_util flattens the same tree in."""

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, path + (str(i),))
        else:
            yield path, tree

    return list(walk(params, ()))


def count_params(params: dict) -> int:
    """Trainable scalars (positional tables excluded, as in the reference)."""
    return int(sum(v.numel() for p, v in tree_leaves(params) if "pos_enc" not in p))


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
# Forward passes (dropout only when a dropout key is given; train=True takes
# the training rungs and never the fused inference kernel)
# ---------------------------------------------------------------------------


def encoder_forward(params: dict, one_hot: torch.Tensor, config: dict,
                    dropout_key: Optional[torch.Tensor] = None,
                    train: bool = False, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """one_hot: (B, K, k*5). Returns (enc_out, emb_out), both (B, K, D);
    emb_out is the pre-positional-encoding tap that feeds the heads."""
    enc = params["encoder"]
    x = F.relu(linear(enc["src_emb"], one_hot))
    for pre in enc["pre_net"]:
        x = F.relu(linear(pre, x))
    emb_out = x
    h = x + enc["pos_enc"][: x.shape[1]].to(x.dtype)[None]
    if train or dropout_key is not None:
        rate = config["encoder_dropout"] if dropout_key is not None else 0.0
        return _train_blocks(enc["blocks"], h, config["encoder_heads"], config, rate,
                             dropout_key, whole_block=False, mesh=mesh), emb_out
    return _blocks(enc["blocks"], h, config["encoder_heads"], config), emb_out


def decoder_forward(params: dict, x: torch.Tensor, config: dict,
                    dropout_key: Optional[torch.Tensor] = None,
                    train: bool = False, mesh=None) -> torch.Tensor:
    """x: (B, T, D) length-regulated frames. Returns (B, T, 1) current (>= 0)."""
    dec = params["decoder"]
    h = x + dec["pos_enc"][: x.shape[1]].to(x.dtype)[None]
    if train or dropout_key is not None:
        rate = config["decoder_dropout"] if dropout_key is not None else 0.0
        h = _train_blocks(dec["blocks"], h, config["decoder_heads"], config, rate,
                          dropout_key, whole_block=True, mesh=mesh)
    else:
        h = _blocks(dec["blocks"], h, config["decoder_heads"], config, may_pair=True)
    return F.relu(linear(dec["out_linear"], h))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _mlp_head(p: dict, x: torch.Tensor, dropout_rate: float = 0.0,
              dropout_key: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Linear -> ReLU -> (Dropout) -> Linear -> Softplus, squeezed to (B, K)."""
    h = _maybe_dropout(F.relu(linear(p["fc1"], x)), dropout_rate, dropout_key, mesh)
    return _softplus(linear(p["fc2"], h).float())[..., 0]


def noise_head(params: dict, emb_out: torch.Tensor, config: dict,
               dropout_key: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Per-k-mer amplitude-noise stdev, (B, K) float32."""
    rate = config["duration_dropout"] if dropout_key is not None else 0.0
    return _mlp_head(params["noise_sampler"], emb_out, rate, dropout_key, mesh)


def duration_gamma_params(params: dict, emb_out: torch.Tensor, config: dict,
                          dropout_key: Optional[torch.Tensor] = None,
                          epsilon: float = 1e-8, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gamma (concentration, rate) per k-mer, each (B, K) float32, >= epsilon."""
    dur = params["duration_sampler"]
    rate_drop = config["duration_dropout"] if dropout_key is not None else 0.0
    k1 = k2 = None
    if dropout_key is not None:
        k1, k2 = threefry.split(dropout_key)
    conc = _mlp_head(dur["conc"], emb_out, rate_drop, k1, mesh)
    rate = _mlp_head(dur["rate"], emb_out, rate_drop, k2, mesh)
    return conc.clamp_min(epsilon), rate.clamp_min(epsilon)
