"""Whole-FFT-block training kernels, forward and backward: the port of the
Pallas kernel pair behind
seq2squiggle_tpu/ops/pallas/block_train.py::fused_block_train
(_block_fwd_call :304, _block_bwd_call :335), the training path at
`pallas_train: block`.

    forward   q/k/v proj -> packed attention (Cauchy–Schwarz shift) -> fc ->
              ·s_a -> LN1(o + x) -> FFN(relu) -> ·s_f -> LN2(f + h1)
    backward  nothing saved but (x, the 16 weights, s_a, s_f): the block is
              recomputed, then walked back in f32 through LN2, the FFN, LN1,
              fc, the packed attention and the three projections, giving gx
              and the 16 weight gradients summed over all B·L positions.

x, s_a, s_f, out and gx are (B, L, D) in the compute dtype (bf16 or f32);
the weights are the f32 masters and are rounded to the compute dtype where
they enter a product. Dropout is a pre-sampled scale tensor (0 or 1/keep,
`make_dropout_scales`) drawn outside with the same keys the plain blocks
use, so the mask stream is the same whichever rung runs; in the block it is
a multiply.

`FusedBlockTrain` is a torch.autograd.Function. On a CUDA tensor both
directions launch the kernels of `csrc/block_train.cu` (or raise); on a CPU
tensor they run the two plain versions below, which step through the same
casts in tensor ops: the backward is written out by hand like the kernel's,
not taken from autograd, so CPU training goes through the arithmetic the card
runs.

What bounds the kernels on the H100: operations, as the fused inference
block. A forward call at (512, 250, 64) in bf16 moves four tensors of 16 MB
and does 20.7 GFLOP; the backward moves five and does about 62 GFLOP. The
forward is one kernel (plus a pass that rounds the weights once per call): one
thread block per batch row, q, k, v in shared memory, scores never stored.
The backward's live set does not fit in shared memory, so it is six launches
over a device-memory workspace (`BACKWARD_STAGES`): weights rounded; recompute
and walk back to the gradient of ctx; the attention-core backward per (row,
head) (csrc/attn_core.cu); gx and the projections' operands; the six Aᵀ·G
weight-gradient products split over a fixed 64 ranges of positions; and a
pass that adds the partial sums in index order. No atomics anywhere: every
sum has a fixed order that does not depend on the card, so the gradients are
bit-equal from run to run. In bfloat16 every matrix product runs on the
tensor cores (`mma.sync`): a warp owns a 16-row slab of positions and the
thread block stages its weights in shared memory once; float32 (TF32 stays
off) runs as f32 FMA loops on the CUDA cores, a warp per position. A sequence
too long for the per-batch-row kernels' shared memory (bf16: L > 464 in both
directions, q, k, v sitting beside Wq, Wk and Wv; f32: L > 289 forward,
L > 283 backward) is refused with a ValueError before any launch
(`shared_memory_bytes`) that names `pallas_train: core`, the rung that takes
longer sequences.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..parallel.mesh import global_rows
from . import _build, threefry
from .attn_core import (_heads, _mm, _packed, _softmax_terms,
                        packed_attention_backward_terms)
from .attn_core import shared_memory_bytes as attn_core_smem
from .fft_block import D_FF, D_MODEL, N_HEAD, WEIGHT_FIELDS, _get, slab_shared_memory_bytes

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
LN_EPS = 1e-5

launches_fwd = 0  # forward-kernel launches; chip_smoke.py reads and resets it
launches_bwd = 0  # backward launches (one per call, whatever its CUDA launches)


def make_dropout_scales(key, rate: float, shape, dtype, mesh=None):
    """The dropout draw of ops.attention._maybe_dropout as a scale tensor:
    bernoulli(key, 1 - rate, shape) -> {1/keep, 0}, built in float32 and then
    cast; under dp the global batch's draw cut to this rank's slab of
    `shape[0]` rows. One launch on the card (ops/threefry.py). None when
    there is no key or no dropout."""
    if key is None or rate <= 0.0:
        return None
    rows, start = global_rows(mesh, shape[0])
    return threefry.dropout_scales(key, 1.0 - rate, shape, dtype, rows, start)


def block_weights(block: dict):
    """The block's 16 weights in the kernels' order (WEIGHT_FIELDS)."""
    return [_get(block, path) for path in WEIGHT_FIELDS]


def _ln_fwd(z: torch.Tensor):
    """f32 LayerNorm statistics: (zhat, 1/sigma)."""
    mu = z.mean(dim=-1, keepdim=True)
    var = (z - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + LN_EPS)
    return (z - mu) * inv, inv


def _ln_bwd(gy, zhat, inv, scale):
    """Backward of y = zhat·scale + bias: (gz, dscale, dbias)."""
    gyh = gy * scale.float()
    gz = (gyh - gyh.mean(dim=-1, keepdim=True)
          - zhat * (gyh * zhat).mean(dim=-1, keepdim=True)) * inv
    return gz, (gy * zhat).sum(dim=(0, 1)), gy.sum(dim=(0, 1))


def _recompute(x, weights, s_a, s_f, n_head: int):
    """The forward with every intermediate the backward needs, cast where the
    kernel casts: q, k, v to the compute dtype after the f32 bias add; o f32
    through the scale, the residual and LN1; h1 f32 kept for the second
    residual while its cast feeds the FFN; f1 cast; LN2 on f32."""
    (wq, bq, wk, bk, wv, bv, wf, bf, ln1s, ln1b, w1, b1, w2, b2, _, _) = weights
    cd = x.dtype
    inv_temp = 1.0 / math.sqrt(x.shape[-1] // n_head)

    def proj(w, b):
        return _heads((_mm(x, w.to(cd)) + b.float()).to(cd), n_head)

    qh, kh, vh = proj(wq, bq), proj(wk, bk), proj(wv, bv)
    _, num, den = _softmax_terms(qh, kh, vh, inv_temp)
    ctx = _packed((num / den).to(cd))
    o = _mm(ctx, wf.to(cd)) + bf.float()
    if s_a is not None:
        o = o * s_a.float()
    zhat1, inv1 = _ln_fwd(o + x.float())
    h1 = zhat1 * ln1s.float() + ln1b.float()
    h1c = h1.to(cd)
    pre = _mm(h1c, w1.to(cd)) + b1.float()
    f1 = torch.relu(pre).to(cd)
    f2 = _mm(f1, w2.to(cd)) + b2.float()
    if s_f is not None:
        f2 = f2 * s_f.float()
    zhat2, inv2 = _ln_fwd(f2 + h1)
    return dict(qh=qh, kh=kh, vh=vh, ctx=ctx, zhat1=zhat1, inv1=inv1, h1c=h1c, pre=pre,
                f1=f1, zhat2=zhat2, inv2=inv2, inv_temp=inv_temp)


def fused_block_train_reference(x, weights, s_a, s_f, n_head: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel. x: (B, L, D) in the
    compute dtype; weights: the 16 tensors of `block_weights`; s_a, s_f:
    dropout scales like x, or None. One cast at the store."""
    r = _recompute(x, weights, s_a, s_f, n_head)
    ln2s, ln2b = weights[14], weights[15]
    return (r["zhat2"] * ln2s.float() + ln2b.float()).to(x.dtype)


def fused_block_train_backward_reference(x, weights, s_a, s_f, g, n_head: int):
    """Plain PyTorch version of the backward kernel, written out by hand as
    the kernel walks it: (gx in x's dtype, the 16 weight gradients in the
    weights' order and dtypes). g: the gradient by the output, in x's dtype.

    Matrix-gradient operands are the gradients rounded to the compute dtype
    (gf2c, gf1c, goc, gpc); the bias and LayerNorm gradients sum the f32
    values; the relu mask is pre > 0 on the f32 pre-activation."""
    (wq, _, wk, _, wv, _, wf, _, ln1s, _, w1, _, w2, _, ln2s, _) = weights
    cd = x.dtype
    r = _recompute(x, weights, s_a, s_f, n_head)

    def wgrad(a, gc):  # Aᵀ·G over all positions, f32 sums of exact products
        return _mm(a.reshape(-1, a.shape[-1]).transpose(0, 1), gc.reshape(-1, gc.shape[-1]))

    gy = g.float()
    gz2, d_ln2s, d_ln2b = _ln_bwd(gy, r["zhat2"], r["inv2"], ln2s)
    gf2 = gz2 * s_f.float() if s_f is not None else gz2
    gf2c = gf2.to(cd)
    d_b2 = gf2.sum(dim=(0, 1))
    d_w2 = wgrad(r["f1"], gf2c)
    gf1 = _mm(gf2c, w2.to(cd).transpose(0, 1))
    gf1 = torch.where(r["pre"] > 0, gf1, torch.zeros_like(gf1))
    gf1c = gf1.to(cd)
    d_b1 = gf1.sum(dim=(0, 1))
    d_w1 = wgrad(r["h1c"], gf1c)
    gh1 = gz2 + _mm(gf1c, w1.to(cd).transpose(0, 1))
    gz1, d_ln1s, d_ln1b = _ln_bwd(gh1, r["zhat1"], r["inv1"], ln1s)
    go = gz1 * s_a.float() if s_a is not None else gz1
    goc = go.to(cd)
    d_bf = go.sum(dim=(0, 1))
    d_wf = wgrad(r["ctx"], goc)
    gctx = _mm(goc, wf.to(cd).transpose(0, 1)).to(cd)

    terms = packed_attention_backward_terms(r["qh"], r["kh"], r["vh"], _heads(gctx, n_head),
                                            r["inv_temp"])
    gx = gz1
    proj_grads = []
    for w, gp in zip((wq, wk, wv), terms):
        gp = _packed(gp)  # (B, L, D) f32
        gpc = gp.to(cd)
        proj_grads += [wgrad(x, gpc), gp.sum(dim=(0, 1))]
        gx = gx + _mm(gpc, w.to(cd).transpose(0, 1))
    grads = [*proj_grads, d_wf, d_bf, d_ln1s, d_ln1b, d_w1, d_b1, d_w2, d_b2, d_ln2s, d_ln2b]
    return gx.to(cd), [gw.to(w.dtype) for gw, w in zip(grads, weights)]


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/block_train.cu)
# ---------------------------------------------------------------------------


def _check(x, weights, s_a, s_f, n_head: int, g=None) -> None:
    if not x.is_cuda:
        raise ValueError("the whole-block training kernels take CUDA tensors; a CPU tensor "
                         "goes through FusedBlockTrain, which runs the plain versions")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_block_train takes bfloat16 or float32, not {x.dtype}")
    if x.dim() != 3 or x.shape[-1] != D_MODEL or n_head != N_HEAD:
        raise ValueError(f"the whole-block training kernels are built for (B, L, {D_MODEL}) "
                         f"and {N_HEAD} heads; got {tuple(x.shape)}, {n_head} heads")
    if (s_a is None) != (s_f is None):
        raise ValueError("give both dropout scales or neither")
    for name, t in (("s_a", s_a), ("s_f", s_f), ("g", g)):
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype
                              or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous and share x's shape, dtype and device; "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if len(weights) != len(WEIGHT_FIELDS):
        raise ValueError(f"{len(weights)} weights, want {len(WEIGHT_FIELDS)}")
    for path, w in zip(WEIGHT_FIELDS, weights):
        d_in, d_out = ((D_FF if path[1] == "w_2" else D_MODEL),
                       (D_FF if path[1] == "w_1" else D_MODEL))
        want = (d_in, d_out) if path[-1] == "kernel" else (d_out,)
        if (tuple(w.shape) != want or w.dtype != torch.float32 or w.device != x.device
                or not w.is_contiguous()):
            raise ValueError(f"block weight {'/'.join(path)} must be a contiguous float32 "
                             f"{want} tensor on {x.device} (the training path keeps float32 "
                             f"masters); got {tuple(w.shape)} {w.dtype} on {w.device}")


def shared_memory_bytes(L: int, dtype: torch.dtype, backward: bool) -> int:
    """Dynamic shared memory of one thread block of the per-batch-row kernels:
    the Python twin of rows_mma_smem (bfloat16) and row_kernel_smem (float32)
    in csrc/block_train.cu. bfloat16: csrc/block_mma.cuh's body (q with L
    padded to 16-row slabs, rows of 64 + 8 values; a region that holds k, v
    and the projections' weights and later, k and v being dead, the tail's
    weights), then, backward, the 640 vector sums. float32: q, k, v rows, per
    warp a 64- and a 256-wide scratch row and, backward, a second 64-wide
    one; then max‖k‖ per head and the same sums. The backward also runs the
    attention-core backward, which needs less."""
    n_sums = (6 * D_MODEL + D_FF) if backward else 0
    if dtype == torch.bfloat16:
        rows = slab_shared_memory_bytes(L) + n_sums * 4
    else:
        size, warps = torch.finfo(dtype).bits // 8, 8
        rows = ((3 * L * D_MODEL + warps * (D_MODEL + D_FF + (D_MODEL if backward else 0))) * size
                + (N_HEAD + n_sums) * 4)
    return max(rows, attn_core_smem(L, dtype, True)) if backward else rows


def check_length(L: int, dtype: torch.dtype, backward: bool) -> None:
    """Raise a ValueError if a batch row of length L does not fit."""
    _build.check_shared_memory(
        f"fused_block_train {'backward' if backward else 'forward'}", L, dtype,
        lambda n: shared_memory_bytes(n, dtype, backward),
        hint="`pallas_train: core` trains longer sequences")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _weight_pointers(weights):
    return (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))


def _workspace(lib, x):
    """(rounded weights, compute-dtype workspace, f32 workspace) element
    counts for a backward at x's shape; the forward needs only the first."""
    sizes = (ctypes.c_longlong * 3)()
    lib.s2s_block_train_workspace(x.shape[0], x.shape[1], sizes)
    return tuple(sizes)


def _launch_fwd(x, weights, s_a, s_f, n_head: int, lib=None) -> torch.Tensor:
    """lib: another build of csrc/block_train.cu than the package's (the
    profiling script's, `_build.build_variants`)."""
    global launches_fwd
    _check(x, weights, s_a, s_f, n_head)
    B, L, D = x.shape
    check_length(L, x.dtype, backward=False)
    out = torch.empty_like(x)
    if B == 0 or L == 0:
        return out
    lib = lib or _build.load()
    wc = torch.empty(_workspace(lib, x)[0], dtype=x.dtype, device=x.device)
    err = lib.s2s_block_train_fwd(
        _ptr(x), _ptr(s_a), _ptr(s_f), _ptr(out), _weight_pointers(weights), _ptr(wc),
        B, L, _DTYPE_CODES[x.dtype], 1.0 / math.sqrt(D // n_head),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"block-train forward launch failed: {_build.error_string(err, lib)}")
    with _build.COUNT_LOCK:
        launches_fwd += 1
    return out


def _grad_views(gw: torch.Tensor, weights):
    """The 16 gradients as views of the kernel's flat output: the six
    matrices first, then the ten vectors, each group in the weights' order."""
    n_matrix = sum(w.numel() for w in weights if w.dim() == 2)
    offsets = {2: 0, 1: n_matrix}
    views = []
    for w in weights:
        start = offsets[w.dim()]
        views.append(gw[start:start + w.numel()].view(w.shape))
        offsets[w.dim()] = start + w.numel()
    return views


# The backward's CUDA launches in order; bit i of the entry point's `stages`.
BACKWARD_STAGES = ("round_weights", "rows", "attention", "input", "wgrad", "reduce")
_ALL_STAGES = (1 << len(BACKWARD_STAGES)) - 1


def _launch_bwd(x, weights, s_a, s_f, g, n_head: int, lib=None, stage_launchers=None):
    """stage_launchers: a dict to fill with {stage name: function that makes
    that one launch again on this call's buffers}, for timing the stages
    (each reads what the earlier ones left in the workspace); those launches
    are not counted."""
    global launches_bwd
    _check(x, weights, s_a, s_f, n_head, g)
    B, L, D = x.shape
    check_length(L, x.dtype, backward=True)
    gx = torch.empty_like(x)
    n_gw = sum(w.numel() for w in weights)
    if B == 0 or L == 0:
        return gx, _grad_views(torch.zeros(n_gw, device=x.device), weights)
    gw = torch.empty(n_gw, dtype=torch.float32, device=x.device)
    lib = lib or _build.load()
    n_wc, n_cd, n_f32 = _workspace(lib, x)
    wc = torch.empty(n_wc, dtype=x.dtype, device=x.device)
    ws_cd = torch.empty(n_cd, dtype=x.dtype, device=x.device)
    ws_f32 = torch.empty(n_f32, dtype=torch.float32, device=x.device)

    def launch(stages: int) -> None:
        err = lib.s2s_block_train_bwd(
            _ptr(x), _ptr(s_a), _ptr(s_f), _ptr(g), _ptr(gx), _ptr(gw),
            _weight_pointers(weights), _ptr(wc), _ptr(ws_cd), _ptr(ws_f32),
            B, L, _DTYPE_CODES[x.dtype], 1.0 / math.sqrt(D // n_head), stages,
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
        if err != 0:
            raise RuntimeError(f"block-train backward launch failed: {_build.error_string(err, lib)}")

    launch(_ALL_STAGES)
    with _build.COUNT_LOCK:
        launches_bwd += 1
    if stage_launchers is not None:
        for i, name in enumerate(BACKWARD_STAGES):
            stage_launchers[name] = lambda bit=1 << i: launch(bit)
    return gx, _grad_views(gw, weights)


def fused_block_train_forward(x, weights, s_a, s_f, n_head: int) -> torch.Tensor:
    """The forward alone (no graph): the kernel for CUDA tensors, else plain."""
    if x.is_cuda:
        with torch.cuda.device(x.device):
            return _launch_fwd(x, weights, s_a, s_f, n_head)
    return fused_block_train_reference(x, weights, s_a, s_f, n_head)


def fused_block_train_backward(x, weights, s_a, s_f, g, n_head: int):
    """The backward alone: the kernels for CUDA tensors, else plain."""
    g = g.to(x.dtype).contiguous()
    if x.is_cuda:
        with torch.cuda.device(x.device):
            return _launch_bwd(x, weights, s_a, s_f, g, n_head)
    return fused_block_train_backward_reference(x, weights, s_a, s_f, g, n_head)


class FusedBlockTrain(torch.autograd.Function):
    """One post-LN attention + FFN block, forward and backward by the
    hand-written kernels (CUDA) or their plain versions (CPU). Arguments:
    x, s_a, s_f, n_head, then the 16 weights of `block_weights`. Saves only
    x, the weights and the two scales; the scales get no gradient."""

    @staticmethod
    def forward(ctx, x, s_a, s_f, n_head: int, *weights):
        x = x.contiguous()
        weights = [w.contiguous() for w in weights]
        s_a = None if s_a is None else s_a.contiguous()
        s_f = None if s_f is None else s_f.contiguous()
        ctx.save_for_backward(x, s_a, s_f, *weights)
        ctx.n_head = n_head
        return fused_block_train_forward(x, weights, s_a, s_f, n_head)

    @staticmethod
    def backward(ctx, g):
        x, s_a, s_f, *weights = ctx.saved_tensors
        gx, gws = fused_block_train_backward(x, weights, s_a, s_f, g, ctx.n_head)
        return (gx, None, None, None, *gws)


def fused_block_train(x, block: dict, s_a, s_f, n_head: int) -> torch.Tensor:
    """Apply one block on the training path, differentiable by x and by the
    block's weights. s_a, s_f: dropout scales for the attention-out and
    FFN-out dropouts (`make_dropout_scales`), or None for no dropout."""
    return FusedBlockTrain.apply(x, s_a, s_f, n_head, *block_weights(block))
