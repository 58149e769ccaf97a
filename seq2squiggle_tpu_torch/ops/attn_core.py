"""Head-packed attention core with a hand-written backward: the port of the
Pallas kernel pair seq2squiggle_tpu/ops/pallas/attn_core.py::packed_attention_core
(_core_fwd_call :184, _core_bwd_call :205), the training path at
`pallas_train: core`.

    ctx = softmax(q·kᵀ/√d_k)·v   per head; q, k, v, ctx all (B, L, D) with
                                  the heads packed along D

`PackedAttentionCore.apply(q, k, v, n_head)` is a torch.autograd.Function
that saves only (q, k, v): the backward recomputes e and den as the forward
does. On a CUDA tensor both directions launch the kernels of
`csrc/attn_core.cu` (or raise); on a CPU tensor they run the two plain
versions below, which step through the same casts in tensor ops, so CPU
training goes through the same hand-derived backward the card runs.

What bounds the kernels on the H100: operations. A call at (512, 250, 64) in
bf16 moves 4 tensors of 16 MB forward and 7 backward (microseconds at
3.35 TB/s) but evaluates 2.6e8 (query, key) pairs, each with one exp forward
and three backward. In bf16 the products run on the tensor cores: d_k = 8 is
the depth of `mma.sync` m16n8k8 (scores, g_a), and the products over keys or
queries take m16n8k16, whose A operand is the accumulator fragment of e or dS
packed to bf16 pairs in registers; what is left per pair is the exp, so the
special-function unit is the limit (times: PERF.md section 6). f32 has no
tensor-core form with TF32 off and stays on the CUDA cores. Both keep each
head's q, k, v in shared memory, recompute scores instead of storing them,
and sum gk and gv per key over the queries in order (no atomics), so
gradients are bit-equal from run to run. A sequence whose head slices do not
fit in shared memory is refused with a ValueError before any launch
(`shared_memory_bytes`).

Numerics (the TPU kernels'): shift = ‖q_t‖·max_s‖k_s‖/√d_k per head
(Cauchy–Schwarz, no row max); e = exp(q·k/√d_k − shift) in f32, rounded to
the compute dtype; num = Σ e·v and den = max(Σ e, 1e-30) in f32 from the
rounded e; ctx = num/den rounded once. Backward: ĝ = g/den rounded;
g_a = ĝ·vᵀ; r = (Σ_d ĝ·num)/den; dS = e·((g_a − r)/√d_k) rounded;
gq = dS·k, gk = dSᵀ·q, gv = eᵀ·ĝ with f32 sums, rounded on store. The shift
is a constant of the softmax and gets no gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

D_MODEL, N_HEAD = 64, 8  # the widths the kernels are written for
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

launches_fwd = 0  # forward-kernel launches; chip_smoke.py reads and resets it
launches_bwd = 0  # backward-kernel launches


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compute-dtype operands, exact products, f32 accumulation."""
    return torch.matmul(a.float(), b.float())


def _heads(t: torch.Tensor, n_head: int) -> torch.Tensor:
    B, L, D = t.shape
    return t.reshape(B, L, n_head, D // n_head).transpose(1, 2)  # (B, H, L, d_k)


def _packed(t: torch.Tensor) -> torch.Tensor:
    B, H, L, d_k = t.shape
    return t.transpose(1, 2).reshape(B, L, H * d_k)


def _softmax_terms(q, k, v, inv_temp: float):
    """q, k, v: (B, H, L, d_k) compute dtype -> (e compute dtype, num f32, den f32)."""
    s = _mm(q, k.transpose(-1, -2))  # (B, H, L, L) f32, un-tempered
    qn = q.float().square().sum(-1, keepdim=True).sqrt()  # (B, H, L, 1)
    kn = k.float().square().sum(-1).amax(-1, keepdim=True).sqrt()[..., None]
    e = torch.exp(s * inv_temp - qn * kn * inv_temp).to(q.dtype)
    num = _mm(e, v)
    den = e.float().sum(-1, keepdim=True).clamp_min(1e-30)
    return e, num, den


def packed_attention_attend(q, k, v, inv_temp: float) -> torch.Tensor:
    """The packed softmax on head-split tensors: (B, H, L, d_k) -> ctx, same
    shape and dtype. Shared with the fused inference block's plain version."""
    _, num, den = _softmax_terms(q, k, v, inv_temp)
    return (num / den).to(q.dtype)


def packed_attention_core_reference(q, k, v, n_head: int) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel. q, k, v: (B, L, D)."""
    inv_temp = 1.0 / math.sqrt(q.shape[-1] // n_head)
    return _packed(packed_attention_attend(_heads(q, n_head), _heads(k, n_head),
                                           _heads(v, n_head), inv_temp))


def packed_attention_backward_terms(qh, kh, vh, gh, inv_temp: float):
    """The backward on head-split tensors (B, H, L, d_k), gh already in the
    compute dtype: (gq, gk, gv) as float32 sums, before their cast. Shared
    with the whole-block training backward (ops/block_train.py), which sums
    the float32 values into the bias gradients."""
    cd = qh.dtype
    e, num, den = _softmax_terms(qh, kh, vh, inv_temp)
    g_n = (gh.float() / den).to(cd)                          # ĝ
    g_a = _mm(g_n, vh.transpose(-1, -2))                     # (B, H, L, L)
    r = (g_n.float() * num).sum(-1, keepdim=True) / den
    ds = (e.float() * ((g_a - r) * inv_temp)).to(cd)
    return _mm(ds, kh), _mm(ds.transpose(-1, -2), qh), _mm(e.transpose(-1, -2), g_n)


def packed_attention_core_backward_reference(q, k, v, g, n_head: int):
    """Plain PyTorch version of the backward kernel: (gq, gk, gv), each
    (B, L, D) in q's dtype, for the output gradient g (already in q's dtype)."""
    inv_temp = 1.0 / math.sqrt(q.shape[-1] // n_head)
    terms = packed_attention_backward_terms(*(_heads(t, n_head) for t in (q, k, v, g)),
                                            inv_temp)
    return tuple(_packed(t.to(q.dtype)) for t in terms)


def _check(n_head: int, *tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"packed_attention_core takes bfloat16 or float32, not {q.dtype}")
    if q.dim() != 3 or q.shape[-1] != D_MODEL or n_head != N_HEAD:
        raise ValueError(f"the attention-core kernels are built for (B, L, {D_MODEL}) "
                         f"and {N_HEAD} heads; got {tuple(q.shape)}, {n_head} heads")
    for t in tensors[1:]:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v (and g) must share shape, dtype and device; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device} beside "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")


def shared_memory_bytes(L: int, dtype: torch.dtype, backward: bool) -> int:
    """Dynamic shared memory of one thread block: the Python twin of
    fwd_smem_bytes / bwd_smem_bytes in csrc/attn_core.cu. bf16 keeps q, k, v
    (and ĝ) padded to 16-row tiles plus, backward, a shift and an r per row;
    f32 keeps k, v (q, k, v, ĝ backward) unpadded."""
    if dtype == torch.bfloat16:
        rows = -(-L // 16) * 16
        return rows * (4 * 16 + 2 * 4 if backward else 3 * 16)
    return L * (4 * 32 + 2 * 4 if backward else 2 * 32)


def check_length(L: int, dtype: torch.dtype, backward: bool) -> None:
    """Raise a ValueError if a head's slices at length L do not fit."""
    _build.check_shared_memory(
        f"packed_attention_core {'backward' if backward else 'forward'}", L, dtype,
        lambda n: shared_memory_bytes(n, dtype, backward))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch_fwd(q, k, v, n_head: int) -> torch.Tensor:
    global launches_fwd
    _check(n_head, q, k, v)
    B, L, D = q.shape
    check_length(L, q.dtype, backward=False)
    out = torch.empty_like(q)
    if B == 0 or L == 0:
        return out
    err = _build.load().s2s_attn_core_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(out), B, L, _DTYPE_CODES[q.dtype],
        1.0 / math.sqrt(D // n_head),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"attention-core forward launch failed: {_build.error_string(err)}")
    launches_fwd += 1
    return out


def _launch_bwd(q, k, v, g, n_head: int):
    global launches_bwd
    _check(n_head, q, k, v, g)
    B, L, D = q.shape
    check_length(L, q.dtype, backward=True)
    gq, gk, gv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    if B == 0 or L == 0:
        return gq, gk, gv
    err = _build.load().s2s_attn_core_bwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(g), _ptr(gq), _ptr(gk), _ptr(gv), B, L,
        _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(D // n_head),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"attention-core backward launch failed: {_build.error_string(err)}")
    launches_bwd += 1
    return gq, gk, gv


def packed_attention_core_forward(q, k, v, n_head: int) -> torch.Tensor:
    """The forward alone (no graph): the kernel for CUDA tensors, else plain."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.is_cuda:
        with torch.cuda.device(q.device):
            return _launch_fwd(q, k, v, n_head)
    return packed_attention_core_reference(q, k, v, n_head)


def packed_attention_core_backward(q, k, v, g, n_head: int):
    """The backward alone: the kernel for CUDA tensors, else plain."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    g = g.to(q.dtype).contiguous()
    if q.is_cuda:
        with torch.cuda.device(q.device):
            return _launch_bwd(q, k, v, g, n_head)
    return packed_attention_core_backward_reference(q, k, v, g, n_head)


class PackedAttentionCore(torch.autograd.Function):
    """ctx = softmax(q·kᵀ/√d_k)·v per head, heads packed along D; forward and
    backward by the hand-written kernels (CUDA) or their plain versions (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, n_head: int):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v)
        ctx.n_head = n_head
        return packed_attention_core_forward(q, k, v, n_head)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        gq, gk, gv = packed_attention_core_backward(q, k, v, g, ctx.n_head)
        return gq, gk, gv, None
