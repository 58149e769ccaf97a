"""The port's whole-block training rung (ops/block_train.py) against the JAX
package's Pallas kernel pair `fused_block_train`, which runs in interpret
mode on the CPU backend, as tests/test_pallas.py runs it. On the CPU the
port's autograd.Function takes its two plain versions, whose arithmetic the
CUDA kernels repeat step by step (chip_smoke.py holds the kernels against
them on the card).

Inputs come from numpy seeds and cross as numpy arrays; the block's weights
are the JAX package's init (seed 0). Bars:
  - dropout scales: bit-equal to the JAX package's, float32 and bfloat16;
  - forward: float32 rtol/atol 1e-5; bfloat16 within 8 bf16 ULPs of
    max(1, max|ref|) (tests/test_pallas.py:362, :409);
  - backward against jax.grad through the Pallas pair: float32 gx rtol 1e-3 /
    atol 1e-5, each of the 16 weight gradients rtol 2e-3 / atol
    1e-4·max(1, max|ref|) (tests/test_pallas.py:374-388: the LayerNorm-adjacent
    gradients are near-cancelling sums); bfloat16 every gradient within 8 bf16
    ULPs of max(1, max|ref|);
  - the hand-written backward against torch.autograd through the port's plain
    `ops.attention.fft_block` with the same masks: the float32 bars above;
  - central finite differences at (1, 10, 64) along random unit directions:
    atol/rtol 5e-2 (tests/test_pallas.py:432).
"""

from __future__ import annotations

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.models import fft_model as jmodel
from seq2squiggle_tpu.ops.pallas import block_train as jblock
from seq2squiggle_tpu_torch import prng
from seq2squiggle_tpu_torch.models.weights import params_from_jax
from seq2squiggle_tpu_torch.ops import attention as tattention
from seq2squiggle_tpu_torch.ops import block_train as tblock

H = 8
RATE = 0.2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def blocks():
    """(the JAX decoder blocks, the same blocks as torch tensors)."""
    jparams = jmodel.init_params(load_config(None), jax.random.key(0))
    return jparams["decoder"]["blocks"], params_from_jax(jparams)["decoder"]["blocks"]


def f32(x):
    return np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") else x.float().numpy()


def both_scales(shape, jd, td, seed=5):
    ra, rf = jax.random.split(jax.random.key(seed))
    ta, tf = prng.split(prng.key(seed))
    return ([jblock.make_dropout_scales(k, RATE, shape, jd) for k in (ra, rf)],
            [tblock.make_dropout_scales(k, RATE, shape, td) for k in (ta, tf)])


def jax_grads(jb, x, w, scales, jd):
    """jax.grad of sum(out · w) through the Pallas pair: (gx, {path: leaf})."""
    wf = jnp.asarray(w)

    def loss(xx, p):
        return jnp.sum(jblock.fused_block_train(xx, p, *scales, H).astype(jnp.float32) * wf)

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x).astype(jd), jb)
    return f32(gx), {tuple(str(k.key) for k in kp): np.asarray(v)
                     for kp, v in jax.tree_util.tree_leaves_with_path(gp)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_scales_bit_equal_to_jax(dtype):
    jd, td = DTYPES[dtype]
    jscales, tscales = both_scales((3, 37, 64), jd, td)
    for a, b in zip(jscales, tscales):
        assert b.dtype == td and tuple(b.shape) == (3, 37, 64)
        np.testing.assert_array_equal(f32(b), f32(a))
        assert set(np.unique(f32(b))) == {0.0, 1.25}


def test_dropout_scales_none_cases():
    assert tblock.make_dropout_scales(None, RATE, (2, 3), torch.float32) is None
    assert tblock.make_dropout_scales(prng.key(1), 0.0, (2, 3), torch.float32) is None


def test_forward_matches_pallas_with_dropout(blocks):
    jb, tb = blocks[0][0], blocks[1][0]
    x = np.random.default_rng(21).standard_normal((3, 37, 64)).astype(np.float32)
    jscales, tscales = both_scales(x.shape, jnp.float32, torch.float32)
    ref = np.asarray(jblock.fused_block_train(jnp.asarray(x), jb, *jscales, H))
    xt = torch.from_numpy(x)
    got = tblock.fused_block_train_reference(xt, tblock.block_weights(tb), *tscales, H)
    assert torch.equal(tblock.fused_block_train(xt, tb, *tscales, H), got)  # CPU: plain
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_pallas_without_dropout(blocks, dtype):
    jd, td = DTYPES[dtype]
    jb, tb = blocks[0][1], blocks[1][1]
    x = np.random.default_rng(22).standard_normal((2, 50, 64)).astype(np.float32)
    ref = f32(jblock.fused_block_train(jnp.asarray(x).astype(jd), jb, None, None, H))
    got = tblock.fused_block_train(torch.from_numpy(x).to(td), tb, None, None, H)
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(f32(got) - ref).max() <= 8 * ULP * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("dtype,dropout", [("float32", True), ("float32", False),
                                           ("bfloat16", True)])
def test_backward_matches_pallas_grad(blocks, dtype, dropout):
    jd, td = DTYPES[dtype]
    jb, tb = blocks[0][0], blocks[1][0]
    rng = np.random.default_rng(23)
    x = rng.standard_normal((3, 37, 64)).astype(np.float32)
    w = rng.standard_normal((3, 37, 64)).astype(np.float32)
    jscales, tscales = both_scales(x.shape, jd, td) if dropout else ([None] * 2, [None] * 2)
    ref_gx, ref_gw = jax_grads(jb, x, w, jscales, jd)

    weights = [t.clone().requires_grad_() for t in tblock.block_weights(tb)]
    xt = torch.from_numpy(x).to(td).requires_grad_()
    out = tblock.FusedBlockTrain.apply(xt, *tscales, H, *weights)
    gx, *gws = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), (xt, *weights))
    direct = tblock.fused_block_train_backward_reference(
        xt.detach(), [t.detach() for t in weights], *tscales,
        torch.from_numpy(w).to(td), H)
    assert torch.equal(gx, direct[0]) and all(torch.equal(a, b) for a, b in zip(gws, direct[1]))
    assert gx.dtype == td and all(g.dtype == torch.float32 for g in gws)

    if dtype == "float32":
        np.testing.assert_allclose(f32(gx), ref_gx, rtol=1e-3, atol=1e-5, err_msg="gx")
    else:
        assert np.abs(f32(gx) - ref_gx).max() <= 8 * ULP * max(1.0, np.abs(ref_gx).max())
    assert len(ref_gw) == len(gws) == 16
    for path, g in zip(tblock.WEIGHT_FIELDS, gws):
        ref = ref_gw[path]
        scale = max(1.0, np.abs(ref).max())
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), ref, rtol=2e-3, atol=1e-4 * scale,
                                       err_msg="/".join(path))
        else:
            assert np.abs(g.numpy() - ref).max() <= 8 * ULP * scale, "/".join(path)


SLAB_EDGES = [1, 15, 16, 17, 37]  # around the CUDA kernels' 16-row slabs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", SLAB_EDGES)
def test_forward_matches_pallas_at_slab_edges(blocks, L, dtype):
    """The plain forward at the lengths where the bfloat16 CUDA kernels' 16-row
    slabs are ragged: the reference those kernels are held against on the card
    (chip_smoke.py phase 8 runs the same lengths). B = 2, dropout on."""
    jd, td = DTYPES[dtype]
    jb, tb = blocks[0][0], blocks[1][0]
    x = np.random.default_rng(30 + L).standard_normal((2, L, 64)).astype(np.float32)
    jscales, tscales = both_scales(x.shape, jd, td)
    ref = f32(jblock.fused_block_train(jnp.asarray(x).astype(jd), jb, *jscales, H))
    got = f32(tblock.fused_block_train(torch.from_numpy(x).to(td), tb, *tscales, H))
    assert got.shape == (2, L, 64)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() <= 4 * ULP * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", SLAB_EDGES)
def test_backward_matches_pallas_grad_at_slab_edges(blocks, L, dtype):
    """The hand-written plain backward against jax.grad through the Pallas pair
    at the same lengths, B = 2, dropout on; bars of
    test_backward_matches_pallas_grad."""
    jd, td = DTYPES[dtype]
    jb, tb = blocks[0][0], blocks[1][0]
    rng = np.random.default_rng(40 + L)
    x = rng.standard_normal((2, L, 64)).astype(np.float32)
    w = rng.standard_normal((2, L, 64)).astype(np.float32)
    jscales, tscales = both_scales(x.shape, jd, td)
    ref_gx, ref_gw = jax_grads(jb, x, w, jscales, jd)
    gx, gws = tblock.fused_block_train_backward(
        torch.from_numpy(x).to(td), tblock.block_weights(tb), *tscales,
        torch.from_numpy(w).to(td), H)
    if dtype == "float32":
        np.testing.assert_allclose(f32(gx), ref_gx, rtol=1e-3, atol=1e-5, err_msg="gx")
    else:
        assert np.abs(f32(gx) - ref_gx).max() <= 8 * ULP * max(1.0, np.abs(ref_gx).max())
    for path, g in zip(tblock.WEIGHT_FIELDS, gws):
        ref = ref_gw[path]
        scale = max(1.0, np.abs(ref).max())
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), ref, rtol=2e-3, atol=1e-4 * scale,
                                       err_msg="/".join(path))
        else:
            assert np.abs(g.numpy() - ref).max() <= 8 * ULP * scale, "/".join(path)


@pytest.mark.parametrize("dropout", [True, False])
def test_hand_backward_matches_autograd_through_plain_block(blocks, dropout):
    """The same masks through ops.attention.fft_block (the plain rung, under
    torch.autograd) and through the hand-written backward."""
    tb = blocks[1][0]
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.standard_normal((2, 40, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 40, 64)).astype(np.float32))
    key = prng.key(5) if dropout else None
    scales = [tblock.make_dropout_scales(k, RATE, x.shape, x.dtype)
              for k in (prng.split(key) if dropout else (None, None))]

    leaves = [t.clone().requires_grad_() for t in tblock.block_weights(tb)]
    tree: dict = {}
    for path, leaf in zip(tblock.WEIGHT_FIELDS, leaves):
        tree.setdefault(path[0], {}).setdefault(path[1], {})[path[2]] = leaf
    xr = x.clone().requires_grad_()
    out = tattention.fft_block(tree, xr, H, dropout_rate=RATE if dropout else 0.0,
                               dropout_key=prng.split(key) if dropout else None)
    ref_gx, *ref_gw = torch.autograd.grad((out * w).sum(), (xr, *leaves))

    gx, gws = tblock.fused_block_train_backward_reference(
        x, [t.detach() for t in leaves], *scales, w, H)
    torch.testing.assert_close(gx, ref_gx, rtol=1e-3, atol=1e-5)
    for path, a, b in zip(tblock.WEIGHT_FIELDS, gws, ref_gw):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=1e-4 * max(1.0, b.abs().max().item()),
                                   msg=lambda m, p=path: f"{'/'.join(p)}: {m}")


def test_hand_backward_matches_finite_differences(blocks):
    """Central differences of the Function's own forward at (1, 10, 64),
    float32, as jax.test_util.check_grads does it: for x and for each of the
    16 weights, the derivative along a random unit direction (eps 1e-2, the
    loss summed in float64) against the analytic gradient's projection."""
    tb = blocks[1][0]
    rng = np.random.default_rng(25)
    x = torch.from_numpy(rng.standard_normal((1, 10, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 10, 64)))
    s_a, s_f = (tblock.make_dropout_scales(k, RATE, x.shape, x.dtype)
                for k in prng.split(prng.key(2)))
    primals = [x, *tblock.block_weights(tb)]

    def loss(xx, *ws):
        return (tblock.FusedBlockTrain.apply(xx, s_a, s_f, H, *ws).double() * w).sum()

    leaves = [t.clone().requires_grad_() for t in primals]
    analytic = torch.autograd.grad(loss(*leaves), leaves)
    eps = 1e-2
    for i, grad in enumerate(analytic):
        direction = torch.from_numpy(rng.standard_normal(tuple(grad.shape)).astype(np.float32))
        direction /= direction.norm()
        up, down = (loss(*(t + sign * eps * direction if j == i else t
                           for j, t in enumerate(primals))).item() for sign in (1, -1))
        np.testing.assert_allclose((grad * direction).sum().item(), (up - down) / (2 * eps),
                                   atol=5e-2, rtol=5e-2, err_msg=f"primal {i}")


@pytest.mark.parametrize("dropout", [True, False])
def test_function_saves_only_x_weights_and_scales(blocks, dropout):
    tb = blocks[1][0]
    x = torch.from_numpy(np.random.default_rng(26).standard_normal((2, 40, 64)))
    x = x.to(torch.bfloat16).requires_grad_()
    scales = [tblock.make_dropout_scales(k, RATE, x.shape, x.dtype) if dropout else None
              for k in prng.split(prng.key(3))]
    weights = [t.clone().requires_grad_() for t in tblock.block_weights(tb)]
    out = tblock.FusedBlockTrain.apply(x, *scales, H, *weights)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 19  # x, the two scales (or None), the 16 weights
    assert saved[0].shape == x.shape and saved[0].dtype == torch.bfloat16
    assert all((s is None) != dropout for s in saved[1:3])
    assert [tuple(s.shape) for s in saved[3:]] == [tuple(t.shape) for t in weights]
    # a float32 cotangent is cast to x's dtype first; the scales get no gradient
    w = torch.ones(2, 40, 64)
    grads = torch.autograd.grad((out.float() * w).sum(), (x, *weights))
    want = tblock.fused_block_train_backward_reference(
        x.detach(), [t.detach() for t in weights], *scales, w.to(torch.bfloat16), H)
    assert torch.equal(grads[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(grads[1:], want[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_underflow_input_gives_finite_output_and_gradients(blocks, dtype):
    """tests/test_pallas.py:111-137's input: huge, near-orthogonal rows make
    every exp of a row underflow under the Cauchy–Schwarz shift; den's clamp
    keeps the forward and the backward finite."""
    td = DTYPES[dtype][1]
    rng = np.random.default_rng(3)
    d = np.zeros((2, 64), np.float32)
    d[0, ::2] = 1.0
    d[1, 1::2] = 1.0
    x = d[np.tile([0, 1], 25)] * 3e3 + rng.standard_normal((50, 64)) * 1e-2
    x = torch.from_numpy(np.broadcast_to(x, (2, 50, 64)).astype(np.float32).copy()).to(td)
    # identity projections, so that q, k, v are the huge rows themselves
    weights = [t.clone() for t in tblock.block_weights(blocks[1][0])]
    for i in (0, 2, 4):
        weights[i] = torch.eye(64)
        weights[i + 1] = torch.zeros(64)
    out = tblock.fused_block_train_forward(x, weights, None, None, H)
    gx, gws = tblock.fused_block_train_backward(x, weights, None, None, torch.ones_like(x), H)
    assert torch.isfinite(out).all() and torch.isfinite(gx).all()
    assert all(torch.isfinite(g).all() for g in gws)


def test_cuda_entries_raise_on_cpu_tensors(blocks):
    """_launch_* never falls back to the plain version."""
    weights = tblock.block_weights(blocks[1][0])
    x = torch.zeros(2, 40, 64)
    before = (tblock.launches_fwd, tblock.launches_bwd)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tblock._launch_fwd(x, weights, None, None, H)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tblock._launch_bwd(x, weights, None, None, x, H)
    assert (tblock.launches_fwd, tblock.launches_bwd) == before


def test_grad_views_cover_the_flat_buffer_once(blocks):
    """The kernel writes one flat f32 buffer, matrices first; the 16
    gradients are views of it in the weights' shapes, none overlapping."""
    weights = tblock.block_weights(blocks[1][0])
    n = sum(w.numel() for w in weights)
    views = tblock._grad_views(torch.arange(n, dtype=torch.float32), weights)
    assert [v.shape for v in views] == [w.shape for w in weights]
    assert sorted(torch.cat([v.reshape(-1) for v in views]).tolist()) == list(range(n))
    assert views[0].reshape(-1)[0] == 0 and views[2].reshape(-1)[0] == 64 * 64
    assert views[1].reshape(-1)[0] == 4 * 64 * 64 + 2 * 64 * 256  # vectors after matrices


@pytest.mark.gpu
def test_block_kernels_match_plain_on_the_card(blocks):
    """The CUDA kernels against the plain versions (chip_smoke.py phase 8
    runs the same comparison at the training shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    weights = [t.to(dev) for t in tblock.block_weights(blocks[1][0])]
    rng = np.random.default_rng(1)
    x, g = (torch.from_numpy(rng.standard_normal((3, 37, 64)).astype(np.float32)).to(dev)
            for _ in range(2))
    torch.testing.assert_close(tblock.fused_block_train_forward(x, weights, None, None, H),
                               tblock.fused_block_train_reference(x, weights, None, None, H),
                               rtol=1e-4, atol=1e-5)
    gx, gws = tblock.fused_block_train_backward(x, weights, None, None, g, H)
    rx, rws = tblock.fused_block_train_backward_reference(x, weights, None, None, g, H)
    torch.testing.assert_close(gx, rx, rtol=1e-3, atol=1e-5 * max(1.0, rx.abs().max().item()))
    for a, b in zip(gws, rws):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=1e-4 * max(1.0, b.abs().max().item()))
    # bfloat16, the tensor-core kernels, ragged in their 16-row slabs
    xb, gb = x.bfloat16(), g.bfloat16()
    ref = tblock.fused_block_train_reference(xb, weights, None, None, H).float()
    out = tblock.fused_block_train_forward(xb, weights, None, None, H).float()
    assert (out - ref).abs().max() <= 4 * ULP * max(1.0, ref.abs().max().item())
    gx, gws = tblock.fused_block_train_backward(xb, weights, None, None, gb, H)
    rx, rws = tblock.fused_block_train_backward_reference(xb, weights, None, None, gb, H)
    assert ((gx.float() - rx.float()).abs().max()
            <= 8 * ULP * max(1.0, rx.float().abs().max().item()))
    for a, b in zip(gws, rws):
        assert (a - b).abs().max() <= 2e-2 * max(1.0, b.abs().max().item())
