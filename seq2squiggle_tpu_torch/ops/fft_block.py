"""Fused post-LN FFT block: the port of the Pallas kernels
seq2squiggle_tpu/ops/pallas/fft_block.py::fused_fft_block (one block) and
::fused_fft_block_pair (the decoder's two blocks in one kernel).

One launch of `csrc/fft_block.cu` runs a whole block (q/k/v projections,
8-head attention, fc, LN1(o + x), the 64 -> 256 -> 64 ReLU FFN, LN2(f + h1))
for one batch row per thread block, keeping the activation and q/k/v in
shared memory and computing the (L, L) scores on the fly. The pair kernel
runs two blocks in that thread block and keeps the activation between them
on the chip, rounded to the compute dtype as the store between two one-block
launches rounds it: bit-equal to two `fused_fft_block` calls.

What bounds them on the H100: not device memory. A decoder call at B=1024,
L=250 moves ~66 MB of activations (in and out, bf16), ~20 us at 3.35 TB/s,
but does ~42 GFLOP per block, and this first version runs them as f32 FMA
loops on the CUDA cores with d_k = 8 contractions, so it is bound by issue
rate and shared-memory bandwidth. The design keeps every intermediate (q, k,
v, the scores, the 256-wide hidden layer) on chip so that the only
device-memory traffic is one read of x and one write of the output, reads the
~49k weights through L1/L2 (every block shares them), and leaves tensor cores
(mma.sync / wgmma for the projections and the FFN) to a later change. The
pair saves one more round trip of the activation (~20 us) and pays for it
with a fourth L x 64 shared-memory buffer, which leaves room for one thread
block per SM at L = 250 in bf16 where the one-block kernel has two.

Numerics are the TPU kernel's (`_apply_block`): compute-dtype operands with
f32 accumulation, q/k/v cast to the compute dtype, exp in f32 cast to the
compute dtype before e·v, den summed from those values in f32, the divide
after the ctx product, LN statistics in f32. The softmax shift is the
argument `packed`: False takes the exact row max (`_attn_headloop`), True the
per-head Cauchy–Schwarz bound ‖q_t‖·max_s‖k_s‖/√d_k (`_attn_packed`), with
den >= 1e-30 so that a row whose exps all underflow gives ctx = 0, not NaN;
None picks by length as the TPU kernel does (exact at L <= 32).

`fused_fft_block` and `fused_fft_block_pair` launch their kernel for a CUDA
tensor and raise if they cannot; a CPU tensor takes the plain versions,
`fused_fft_block_reference` and `fused_fft_block_pair_reference`.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import _build
from .attention import layer_norm
from .attn_core import packed_attention_attend

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

launches = 0  # one-block kernel launches; chip_smoke.py reads and resets it
pair_launches = 0  # two-block kernel launches


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compute-dtype operands, exact products, f32 accumulation."""
    return torch.matmul(a.float(), b.float())


def packed_default(L: int) -> bool:
    """The softmax form `packed=None` stands for: the Cauchy–Schwarz shift
    for L > 32, the exact row max below (the TPU kernel's _packed_default)."""
    return L > HEADLOOP_MAX_L


def exact_max_attention(q, k, v, inv_temp: float):
    """The head loop's attention (`_attn_headloop`). q, k, v: (B, H, L, d_k)
    compute dtype -> ctx (B, H, L, d_k) compute dtype."""
    cd = q.dtype
    s = _mm(q, k.transpose(-1, -2))  # (B, H, L, L) f32, un-tempered
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp((s - m) * inv_temp).to(cd)
    num = _mm(e, v)
    den = e.float().sum(-1, keepdim=True).clamp_min(1e-30)
    return (num / den).to(cd)


def block_reference(x: torch.Tensor, block: dict, n_head: int, attention) -> torch.Tensor:
    """One block in plain PyTorch around `attention(q, k, v, inv_temp)`, which
    maps (B, H, L, d_k) compute-dtype q, k, v to ctx of that shape and dtype.
    x: (B, L, D) in the compute dtype; returns (B, L, D) in float32 (the last
    LayerNorm's own dtype)."""
    (wq, bq, wk, bk, wv, bv, wf, bf, ln1s, ln1b,
     w1, b1, w2, b2, ln2s, ln2b) = (_get(block, f) for f in WEIGHT_FIELDS)
    cd = x.dtype
    B, L, D = x.shape
    d_k = D // n_head

    def proj(w, b):
        return (_mm(x, w.to(cd)) + b.float()).to(cd).reshape(B, L, n_head, d_k).transpose(1, 2)

    ctx = attention(proj(wq, bq), proj(wk, bk), proj(wv, bv), 1.0 / math.sqrt(d_k))
    ctx = ctx.transpose(1, 2).reshape(B, L, D)
    o = _mm(ctx, wf.to(cd)) + bf.float()
    h1 = layer_norm({"scale": ln1s, "bias": ln1b}, o + x.float())  # f32 in, f32 out
    f = torch.relu(_mm(h1.to(cd), w1.to(cd)) + b1.float()).to(cd)
    f = _mm(f, w2.to(cd)) + b2.float()
    return layer_norm({"scale": ln2s, "bias": ln2b}, f + h1)


def fused_fft_block_reference(x: torch.Tensor, block: dict, n_head: int,
                              packed: bool | None = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel, with the kernel's numerics.

    x: (B, L, D) in the compute dtype; returns (B, L, D) in x.dtype.
    """
    if packed is None:
        packed = packed_default(x.shape[1])
    attention = packed_attention_attend if packed else exact_max_attention
    return block_reference(x, block, n_head, attention).to(x.dtype)


def fused_fft_block_pair_reference(x: torch.Tensor, block0: dict, block1: dict, n_head: int,
                                   packed: bool | None = None) -> torch.Tensor:
    """The plain version of the pair: the one-block plain version twice, the
    activation cast to the compute dtype between the two."""
    h = fused_fft_block_reference(x, block0, n_head, packed)
    return fused_fft_block_reference(h, block1, n_head, packed)


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


def check_input(x: torch.Tensor, n_head: int, name: str) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes bfloat16 or float32, not {x.dtype}")
    if x.dim() != 3 or x.shape[2] != D_MODEL or n_head != N_HEAD:
        raise ValueError(f"{name} is built for (B, L, {D_MODEL}) inputs and {N_HEAD} heads; "
                         f"got shape {tuple(x.shape)}, {n_head} heads")


def shared_memory_bytes(L: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one thread block of the one-block kernel, the
    pair and the profiling variants: the Python twin of block_smem_bytes in
    csrc/fft_block_body.cuh (q, k, v rows, a 256-wide hidden row per warp,
    max‖k‖ per head). The pair's fourth buffer is optional there (beyond its
    room the activation is staged through the output), so it adds no ceiling."""
    size = torch.finfo(dtype).bits // 8
    return (3 * L * D_MODEL + 8 * D_FF) * size + N_HEAD * 4


def check_length(L: int, dtype: torch.dtype, name: str = "fused_fft_block") -> None:
    """Raise a ValueError if a batch row of length L does not fit."""
    _build.check_shared_memory(name, L, dtype, lambda n: shared_memory_bytes(n, dtype))


def launch_kernel(entry: str, x: torch.Tensor, ptrs, option: int) -> torch.Tensor:
    """Run the C entry point `entry` (s2s_fft_block's argument list) on x with
    the weight pointer array `ptrs`; `option` is its one integer knob. Raises
    if the sequence does not fit in shared memory or the launch is refused.
    The caller counts the launch."""
    B, L, _ = x.shape
    check_length(L, x.dtype, entry)
    x = x.contiguous()
    out = torch.empty_like(x)
    if B == 0:
        return out
    lib = _build.load()
    err = getattr(lib, entry)(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()), ptrs,
        ctypes.c_int(B), ctypes.c_int(L), ctypes.c_int(_DTYPE_CODES[x.dtype]),
        ctypes.c_float(1.0 / math.sqrt(D_MODEL // N_HEAD)), ctypes.c_int(option),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: {_build.error_string(err)}")
    return out


def _exact(packed: bool | None, L: int) -> int:
    return int(not (packed_default(L) if packed is None else packed))


def fused_fft_block(x: torch.Tensor, block: dict, n_head: int,
                    packed: bool | None = None) -> torch.Tensor:
    """Apply one post-LN attention + FFN block. x: (B, L, D).

    A CUDA tensor runs the hand-written kernel (or raises); a CPU tensor runs
    the plain version. Block weight matrices are expected in x.dtype and
    biases / LayerNorm parameters in float32 (models.fft_model.to_device).
    packed: the softmax form (module docstring); None picks it by length.
    """
    global launches
    if not x.is_cuda:
        return fused_fft_block_reference(x, block, n_head, packed)
    check_input(x, n_head, "fused_fft_block")
    ptrs = _weight_pointers(block, x.dtype, x.device)
    out = launch_kernel("s2s_fft_block", x, ptrs, _exact(packed, x.shape[1]))
    if x.shape[0]:  # an empty batch launches nothing
        launches += 1
    return out


def fused_fft_block_pair(x: torch.Tensor, block0: dict, block1: dict, n_head: int,
                         packed: bool | None = None) -> torch.Tensor:
    """Apply two blocks in one kernel launch, bit-equal to
    `fused_fft_block(fused_fft_block(x, block0), block1)`. x: (B, L, D).

    A CUDA tensor runs the pair kernel (or raises: it never steps down to two
    launches); a CPU tensor runs the plain version. The activation between the
    blocks stays in shared memory where a fourth L x 64 buffer fits beside
    q, k, v (bf16 to L = 440, f32 to L = 218 on an H100); beyond that the same
    thread block stages it through its rows of the output tensor in device
    memory, still in the one launch and with the same bits.
    """
    global pair_launches
    if not x.is_cuda:
        return fused_fft_block_pair_reference(x, block0, block1, n_head, packed)
    check_input(x, n_head, "fused_fft_block_pair")
    both = [*_weight_pointers(block0, x.dtype, x.device),
            *_weight_pointers(block1, x.dtype, x.device)]
    ptrs = (ctypes.c_void_p * len(both))(*both)
    out = launch_kernel("s2s_fft_block_pair", x, ptrs, _exact(packed, x.shape[1]))
    if x.shape[0]:  # an empty batch launches nothing
        pair_launches += 1
    return out
