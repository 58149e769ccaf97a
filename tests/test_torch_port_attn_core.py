"""The port's attention core (ops/attn_core.py) against the JAX package's
Pallas kernel pair, which runs in interpret mode on the CPU backend, as
tests/test_pallas.py runs it. On the CPU the port's autograd.Function takes
its two plain versions, whose arithmetic the CUDA kernels repeat step by step
(chip_smoke.py holds the kernels against them on the card).

Bars: forward float32 rtol/atol 1e-5, bfloat16 within 4 bf16 ULPs of
max|ref|; gradients float32 rtol 1e-4 / atol 1e-5, bfloat16 within 8 bf16
ULPs of max(1, max|ref|) (tests/test_pallas.py:184-230); the hand-derived
backward against torch.autograd through the plain forward at the float32 bar,
and against central finite differences (float32, eps 1e-2, atol 2e-3).
L = 1, 16 and 17 sit at the edges of the bfloat16 CUDA kernels' 16-row tiles:
the plain versions those kernels are held to are held to the Pallas kernel
there too.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu.ops.pallas.attn_core import packed_attention_core as jax_core
from seq2squiggle_tpu_torch.ops import attn_core as tcore

H = 8
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def qkvw(B, L, seed, D=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(4)]


def to_jax(arrs, jd):
    return [jnp.asarray(a).astype(jd) for a in arrs]


def to_torch(arrs, td):
    return [torch.from_numpy(a).to(td) for a in arrs]


def f32(x):
    return np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L", [(3, 37), (2, 50), (3, 1), (3, 16), (3, 17)])
def test_core_forward_matches_pallas(dtype, B, L):
    jd, td = DTYPES[dtype]
    arrs = qkvw(B, L, seed=L)
    ref = f32(jax_core(*to_jax(arrs[:3], jd), H))
    q, k, v = to_torch(arrs[:3], td)
    got = tcore.packed_attention_core_reference(q, k, v, H)
    assert got.dtype == td and got.shape == (B, L, 64)
    via_fn = tcore.PackedAttentionCore.apply(q, k, v, H)
    assert torch.equal(via_fn, got)  # a CPU tensor takes the plain version
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(f32(got) - ref).max() <= 4 * 2.0 ** -8 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L", [(3, 37), (2, 50), (3, 1), (3, 16), (3, 17)])
def test_core_backward_matches_pallas_grad(dtype, B, L):
    jd, td = DTYPES[dtype]
    arrs = qkvw(B, L, seed=100 + L)
    jq, jk, jv, jw = to_jax(arrs, jd)
    wf = jw.astype(jnp.float32)
    ref = jax.grad(lambda a, b, c: jnp.sum(jax_core(a, b, c, H).astype(jnp.float32) * wf),
                   argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v, w = to_torch(arrs, td)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tcore.PackedAttentionCore.apply(q, k, v, H)
    got = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    direct = tcore.packed_attention_core_backward_reference(
        q.detach(), k.detach(), v.detach(), w, H)
    for name, a, b, c in zip("qkv", ref, got, direct):
        assert b.dtype == td and torch.equal(b, c)
        a = f32(a)
        if dtype == "float32":
            np.testing.assert_allclose(f32(b), a, rtol=1e-4, atol=1e-5, err_msg=f"grad_{name}")
        else:
            tol = 8 * 2.0 ** -8 * max(1.0, np.abs(a).max())
            assert np.abs(f32(b) - a).max() <= tol, f"grad_{name}"


@pytest.mark.parametrize("B,L", [(3, 37), (2, 50)])
def test_hand_backward_matches_autograd_through_plain_forward(B, L):
    q, k, v, w = to_torch(qkvw(B, L, seed=7), torch.float32)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ref = torch.autograd.grad(
        (tcore.packed_attention_core_reference(q, k, v, H) * w).sum(), (q, k, v))
    got = tcore.packed_attention_core_backward_reference(q.detach(), k.detach(), v.detach(),
                                                         w, H)
    for name, a, b in zip("qkv", ref, got):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5, msg=f"grad_{name}")


def test_hand_backward_matches_finite_differences():
    """The autograd.Function's analytic gradient against central differences
    of its own forward at (2, 10, 16), H = 2, as torch.autograd.gradcheck
    does it, but in float32 (the plain versions accumulate in float32):
    eps 1e-2, loss summed in float64, atol 2e-3 on gradients of order 1."""
    q, k, v, w = to_torch(qkvw(2, 10, seed=11, D=16), torch.float32)

    def loss(a, b, c):
        return (tcore.PackedAttentionCore.apply(a, b, c, 2).double() * w.double()).sum()

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    analytic = torch.autograd.grad(loss(*leaves), leaves)
    rng = np.random.default_rng(0)
    eps = 1e-2
    for i, (name, grad) in enumerate(zip("qkv", analytic)):
        for flat in rng.choice(grad.numel(), 40, replace=False):
            args = [t.clone() for t in (q, k, v)]
            args[i].view(-1)[flat] += eps
            up = loss(*args).item()
            args[i].view(-1)[flat] -= 2 * eps
            down = loss(*args).item()
            np.testing.assert_allclose(grad.view(-1)[flat].item(), (up - down) / (2 * eps),
                                       atol=2e-3, err_msg=f"grad_{name}[{flat}]")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_underflow_input_gives_finite_output_and_gradients(dtype):
    """tests/test_pallas.py:111-137's input: huge, near-orthogonal rows make
    every exp of a row underflow under the Cauchy–Schwarz shift; den's clamp
    keeps the forward at 0 and the backward finite."""
    td = DTYPES[dtype][1]
    rng = np.random.default_rng(3)
    d = np.zeros((2, 64), np.float32)
    d[0, ::2] = 1.0
    d[1, 1::2] = 1.0
    x = d[np.tile([0, 1], 25)] * 3e3 + rng.standard_normal((50, 64)) * 1e-2
    x = torch.from_numpy(np.broadcast_to(x, (2, 50, 64)).astype(np.float32).copy()).to(td)
    q, k, v = (x.clone().requires_grad_() for _ in range(3))
    out = tcore.PackedAttentionCore.apply(q, k, v, H)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(g).all() for g in grads)


def test_function_saves_only_the_primals_and_casts_the_gradient():
    q, k, v, w = to_torch(qkvw(2, 40, seed=5), torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tcore.PackedAttentionCore.apply(q.transpose(0, 1).transpose(0, 1), k, v, H)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(s.shape == q.shape and s.is_contiguous() for s in saved)
    # a float32 cotangent is cast to q's dtype first (attn_core.py:243-246)
    got = torch.autograd.grad(out.float().mul(w.float()).sum(), (q, k, v))
    want = tcore.packed_attention_core_backward_reference(q.detach(), k.detach(), v.detach(),
                                                          w, H)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cuda_wrapper_refuses_what_the_kernels_do_not_take():
    q = torch.zeros(2, 10, 16)
    with pytest.raises(ValueError, match="8 heads"):
        tcore._check(2, q, q, q)
    x = torch.zeros(2, 10, 64)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tcore._check(8, x.double())
    with pytest.raises(ValueError, match="share shape"):
        tcore._check(8, x, x[:1], x)
    tcore._check(8, x, x, x, x)


@pytest.mark.gpu
def test_core_kernels_match_plain_on_the_card():
    """The CUDA kernels against the plain versions, float32 and bfloat16, at
    the lengths of chip_smoke.py phase 5 (which runs the same comparison, and
    L = 250 at the training batch): the edges of the 16-row tiles, a ragged
    last tile in both axes, more than 16 tiles. Bars as chip_smoke.py's; the
    backward bit-equal from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for td in (torch.float32, torch.bfloat16):
        for L in (1, 15, 16, 17, 37, 250, 256, 283):
            q, k, v, w = (t.to(dev) for t in to_torch(qkvw(3, L, seed=L), td))
            out = tcore.packed_attention_core_forward(q, k, v, H)
            grads = tcore.packed_attention_core_backward(q, k, v, w, H)
            again = tcore.packed_attention_core_backward(q, k, v, w, H)
            ref = tcore.packed_attention_core_reference(q, k, v, H)
            refs = tcore.packed_attention_core_backward_reference(q, k, v, w, H)
            assert all(torch.equal(a, b) for a, b in zip(grads, again)), (td, L)
            if td == torch.float32:
                torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
                for a, b in zip(grads, refs):
                    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
            else:
                err = (out.float() - ref.float()).abs().max().item()
                assert err <= 4 * 2.0 ** -8 * ref.float().abs().max().item(), (L, err)
                for a, b in zip(grads, refs):
                    err = (a.float() - b.float()).abs().max().item()
                    assert err <= 8 * 2.0 ** -8 * max(1.0, b.float().abs().max().item()), (L, err)
