"""Fused post-LN FFT block: the port of the Pallas kernel
seq2squiggle_tpu/ops/pallas/fft_block.py::fused_fft_block.

One launch of `csrc/fft_block.cu` runs a whole block (q/k/v projections,
8-head attention, fc, LN1(o + x), the 64 -> 256 -> 64 ReLU FFN, LN2(f + h1))
for one batch row per thread block, keeping the activation and q/k/v in
shared memory and computing the (L, L) scores on the fly.

What bounds it on the H100: not device memory. A decoder call at B=1024,
L=250 moves ~66 MB of activations (in and out, bf16), ~20 us at 3.35 TB/s,
but does ~42 GFLOP, and this first version runs them as f32 FMA loops on the
CUDA cores with d_k = 8 contractions, so it is bound by issue rate and
shared-memory bandwidth. The design keeps every intermediate (q, k, v, the
scores, the 256-wide hidden layer) on chip so that the only device-memory
traffic is one read of x and one write of the output, reads the ~49k weights
through L1/L2 (every block shares them), and leaves tensor cores (mma.sync /
wgmma for the projections and the FFN) to a later change.

Numerics are the TPU kernel's (`_apply_block`): compute-dtype operands with
f32 accumulation, q/k/v cast to the compute dtype, exp in f32 cast to the
compute dtype before e·v, den summed from those values in f32, the divide
after the ctx product, LN statistics in f32. The softmax shift is the exact
row max at L <= 32 (`_attn_headloop`) and the per-head Cauchy–Schwarz bound
‖q_t‖·max_s‖k_s‖/√d_k at L > 32 (`_attn_packed`), with den >= 1e-30 so that
a row whose exps all underflow gives ctx = 0, not NaN.

`fused_fft_block` launches the kernel for a CUDA tensor and raises if it
cannot; a CPU tensor takes `fused_fft_block_reference`, the plain version.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import _build
from .attention import layer_norm

# Block weight order passed to the kernel (as the Pallas kernel's _WEIGHT_FIELDS).
WEIGHT_FIELDS = (
    ("attn", "w_qs", "kernel"), ("attn", "w_qs", "bias"),
    ("attn", "w_ks", "kernel"), ("attn", "w_ks", "bias"),
    ("attn", "w_vs", "kernel"), ("attn", "w_vs", "bias"),
    ("attn", "fc", "kernel"), ("attn", "fc", "bias"),
    ("attn", "ln", "scale"), ("attn", "ln", "bias"),
    ("ffn", "w_1", "kernel"), ("ffn", "w_1", "bias"),
    ("ffn", "w_2", "kernel"), ("ffn", "w_2", "bias"),
    ("ffn", "ln", "scale"), ("ffn", "ln", "bias"),
)

D_MODEL, N_HEAD, D_FF = 64, 8, 256  # the widths the kernel is written for
HEADLOOP_MAX_L = 32  # longer sequences take the Cauchy–Schwarz shift

launches = 0  # kernel launches; chip_smoke.py reads and resets it


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compute-dtype operands, exact products, f32 accumulation."""
    return torch.matmul(a.float(), b.float())


def _attention(q, k, v, cd, inv_temp: float, headloop: bool):
    """q, k, v: (B, H, L, d_k) compute dtype -> ctx (B, H, L, d_k) compute dtype."""
    s = _mm(q, k.transpose(-1, -2))  # (B, H, L, L) f32, un-tempered
    if headloop:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp((s - m) * inv_temp)
    else:
        qn = q.float().square().sum(-1, keepdim=True).sqrt()  # (B, H, L, 1)
        kn = k.float().square().sum(-1).amax(-1, keepdim=True).sqrt()[..., None]
        shift = qn * kn * inv_temp
        e = torch.exp(s * inv_temp - shift)
    e = e.to(cd)
    num = _mm(e, v)
    den = e.float().sum(-1, keepdim=True).clamp_min(1e-30)
    return (num / den).to(cd)


def fused_fft_block_reference(x: torch.Tensor, block: dict, n_head: int) -> torch.Tensor:
    """The plain PyTorch version of the kernel, with the kernel's numerics.

    x: (B, L, D) in the compute dtype; returns (B, L, D) in x.dtype.
    """
    (wq, bq, wk, bk, wv, bv, wf, bf, ln1s, ln1b,
     w1, b1, w2, b2, ln2s, ln2b) = (_get(block, f) for f in WEIGHT_FIELDS)
    cd = x.dtype
    B, L, D = x.shape
    d_k = D // n_head
    inv_temp = 1.0 / math.sqrt(d_k)

    def proj(w, b):
        return (_mm(x, w.to(cd)) + b.float()).to(cd)

    def heads(t):
        return t.reshape(B, L, n_head, d_k).transpose(1, 2)

    q, k, v = heads(proj(wq, bq)), heads(proj(wk, bk)), heads(proj(wv, bv))
    ctx = _attention(q, k, v, cd, inv_temp, L <= HEADLOOP_MAX_L)
    ctx = ctx.transpose(1, 2).reshape(B, L, D)
    o = _mm(ctx, wf.to(cd)) + bf.float()
    h1 = layer_norm({"scale": ln1s, "bias": ln1b}, o + x.float())  # f32 in, f32 out
    f = torch.relu(_mm(h1.to(cd), w1.to(cd)) + b1.float()).to(cd)
    f = _mm(f, w2.to(cd)) + b2.float()
    return layer_norm({"scale": ln2s, "bias": ln2b}, f + h1).to(x.dtype)


_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

# id(block) -> (block, dtype, device, the 16 weight pointers), most recent
# last. A block's weights are checked once and their pointer array kept:
# blocks on the device are read-only (models.fft_model.to_device builds
# them). An entry holds its block, so the id is not reused while the
# pointers are kept; the oldest entries go beyond _PACKED_MAX (a model has
# 4 blocks per dtype).
_PACKED_MAX = 32
_packed: collections.OrderedDict = collections.OrderedDict()


def _weight_pointers(block: dict, dtype: torch.dtype, device: torch.device):
    hit = _packed.get(id(block))
    if hit is not None and hit[0] is block and hit[1] == dtype and hit[2] == device:
        _packed.move_to_end(id(block))
        return hit[3]
    weights = []
    for path in WEIGHT_FIELDS:
        w = _get(block, path)
        want = dtype if path[-1] == "kernel" else torch.float32
        if w.device != device or w.dtype != want or not w.is_contiguous():
            raise ValueError(f"block weight {'/'.join(path)} must be a contiguous "
                             f"{want} tensor on {device}; got {w.dtype} on {w.device}")
        weights.append(w)
    if _get(block, ("ffn", "w_1", "kernel")).shape != (D_MODEL, D_FF):
        raise ValueError(f"fused_fft_block is built for dff={D_FF}")
    ptrs = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
    _packed[id(block)] = (block, dtype, device, ptrs)
    _packed.move_to_end(id(block))
    while len(_packed) > _PACKED_MAX:
        _packed.popitem(last=False)
    return ptrs


def _launch(x: torch.Tensor, block: dict, n_head: int) -> torch.Tensor:
    global launches
    B, L, D = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_fft_block takes bfloat16 or float32, not {x.dtype}")
    if D != D_MODEL or n_head != N_HEAD:
        raise ValueError(f"fused_fft_block is built for d_model={D_MODEL}, "
                         f"{N_HEAD} heads; got d_model={D}, {n_head} heads")
    ptrs = _weight_pointers(block, x.dtype, x.device)
    x = x.contiguous()
    out = torch.empty_like(x)
    if B == 0:
        return out
    lib = _build.load()
    err = lib.s2s_fft_block(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()), ptrs,
        ctypes.c_int(B), ctypes.c_int(L), ctypes.c_int(_DTYPE_CODES[x.dtype]),
        ctypes.c_float(1.0 / math.sqrt(D_MODEL // N_HEAD)),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"fft_block kernel launch failed: {_build.error_string(err)}")
    launches += 1
    return out


def fused_fft_block(x: torch.Tensor, block: dict, n_head: int) -> torch.Tensor:
    """Apply one post-LN attention + FFN block. x: (B, L, D).

    A CUDA tensor runs the hand-written kernel (or raises); a CPU tensor runs
    the plain version. Block weight matrices are expected in x.dtype and
    biases / LayerNorm parameters in float32 (models.fft_model.to_device).
    """
    if x.is_cuda:
        return _launch(x, block, n_head)
    return fused_fft_block_reference(x, block, n_head)
