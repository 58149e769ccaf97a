"""The port's ops against the JAX package on the JAX CPU backend:
ops/regulator.py, ops/attention.py and ops/fft_block.py (the plain version of
the hand-written block kernel, held against the Pallas kernel in interpret
mode, as tests/test_pallas.py runs it).

Bars (stated per test): the regulator is bit-equal, truncation included;
the plain f32 block within rtol/atol 1e-5 of seq2squiggle_tpu.ops.attention;
the fused block's plain version within rtol 1e-4 / atol 1e-5 of the Pallas
kernel in f32 and within 4 bf16 ULPs of max|ref| in bf16; finite output on
the Cauchy–Schwarz underflow input of test_pallas.py.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.models.fft_model import init_params
from seq2squiggle_tpu.ops import regulator as jreg
from seq2squiggle_tpu.ops.attention import fft_block as jax_fft_block
from seq2squiggle_tpu.ops.pallas.fft_block import fused_fft_block as jax_fused
from seq2squiggle_tpu_torch.models.fft_model import to_device
from seq2squiggle_tpu_torch.models.weights import params_from_jax
from seq2squiggle_tpu_torch.ops import _build
from seq2squiggle_tpu_torch.ops import fft_block as tfused
from seq2squiggle_tpu_torch.ops import regulator as treg
from seq2squiggle_tpu_torch.ops.attention import fft_block as torch_fft_block


@pytest.fixture(scope="module")
def blocks():
    cfg = load_config(None)
    jp = init_params(cfg, jax.random.key(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp["encoder"]["blocks"][0], tp["encoder"]["blocks"][0]


# ---------------------------------------------------------------- regulator


@pytest.mark.parametrize("dur_hi", [3, 20, 40])  # 40: sums exceed T=250
def test_segment_map_and_regulate_bit_equal(dur_hi):
    rng = np.random.default_rng(dur_hi)
    B, K, T, D = 6, 16, 250, 64
    dur = rng.integers(0, dur_hi, (B, K)).astype(np.int32)
    x = rng.standard_normal((B, K, D)).astype(np.float32)
    xn = rng.random((B, K, 1)).astype(np.float32)
    jparts = jreg.segment_map(jnp.asarray(dur), T)
    tparts = treg.segment_map(torch.from_numpy(dur), T)
    for a, b in zip(jparts, tparts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jx, jn = jreg.regulate_from_seg(jnp.asarray(x), jparts[2], x_noise=jnp.asarray(xn))
    tx, tn = treg.regulate_from_seg(torch.from_numpy(x), tparts[2],
                                    x_noise=torch.from_numpy(xn))
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())


def test_regulate_bf16_bit_equal():
    rng = np.random.default_rng(1)
    dur = rng.integers(1, 30, (4, 16)).astype(np.int32)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    seg = jreg.segment_map(jnp.asarray(dur), 250)[2]
    jx, _ = jreg.regulate_from_seg(xb, seg)
    tx, _ = treg.regulate_from_seg(torch.from_numpy(x).bfloat16(),
                                   torch.from_numpy(np.array(seg)))
    np.testing.assert_array_equal(np.asarray(jx).astype(np.float32), tx.float().numpy())


# ------------------------------------------------------------- plain block


@pytest.mark.parametrize("L", [16, 250])
def test_plain_fft_block_f32(blocks, L):
    jb, tb = blocks
    x = np.random.default_rng(L).standard_normal((3, L, 64)).astype(np.float32)
    ref = np.asarray(jax_fft_block(jb, jnp.asarray(x), n_head=8))
    got = torch_fft_block(tb, torch.from_numpy(x), 8).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- fused block, plain version


def _bf16_tol(ref):
    return 4 * 2.0 ** -8 * max(1.0, float(np.max(np.abs(ref))))


@pytest.mark.parametrize("L,B", [(16, 5), (250, 3)])  # head loop / packed
def test_fused_reference_matches_pallas_f32(blocks, L, B):
    jb, tb = blocks
    x = np.random.default_rng(L + 1).standard_normal((B, L, 64)).astype(np.float32)
    ref = np.asarray(jax_fused(jnp.asarray(x), jb, n_head=8, interpret=True, tile_b=2))
    got = tfused.fused_fft_block_reference(torch.from_numpy(x), tb, 8).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("L,B", [(16, 5), (250, 3)])
def test_fused_reference_matches_pallas_bf16(blocks, L, B):
    jb, tb = blocks
    x = np.random.default_rng(L + 2).standard_normal((B, L, 64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_fused(xb, jb, n_head=8, interpret=True, tile_b=2)).astype(np.float32)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    got = tfused.fused_fft_block_reference(xt, tb, 8)
    assert got.dtype == torch.bfloat16
    assert float(np.max(np.abs(got.float().numpy() - ref))) <= _bf16_tol(ref)


def test_fused_reference_underflow_is_finite(blocks):
    """test_pallas.py:111-137's input: huge-norm rows along two orthogonal
    directions, so the Cauchy–Schwarz shift overshoots every score by far
    more than 88 nats; den >= 1e-30 keeps ctx at 0 instead of NaN."""
    _, tb = blocks
    rng = np.random.default_rng(3)
    d = np.zeros((2, 64), np.float32)
    d[0, ::2] = 1.0
    d[1, 1::2] = 1.0
    x = d[np.tile([0, 1], 125)] * 3e3 + rng.standard_normal((250, 64)) * 1e-2
    x = np.broadcast_to(x, (2, 250, 64)).astype(np.float32)
    out = tfused.fused_fft_block_reference(torch.from_numpy(x.copy()), tb, 8)
    assert torch.isfinite(out).all()


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch(blocks):
    _, tb = blocks
    x = torch.from_numpy(
        np.random.default_rng(7).standard_normal((2, 16, 64)).astype(np.float32))
    before = tfused.launches
    out = tfused.fused_fft_block(x, tb, 8)
    assert tfused.launches == before
    torch.testing.assert_close(out, tfused.fused_fft_block_reference(x, tb, 8),
                               rtol=0, atol=0)


def test_weight_pointers_checked_once_per_block_and_dtype(blocks):
    """The launch path checks a block's weights once and keeps their pointer
    array; the same block asked for in another dtype is checked again and
    refused."""
    _, tb = blocks
    cpu = torch.device("cpu")
    blk = to_device({"encoder": {"blocks": [tb]}}, cpu, torch.bfloat16)["encoder"]["blocks"][0]
    ptrs = tfused._weight_pointers(blk, torch.bfloat16, cpu)
    assert tfused._weight_pointers(blk, torch.bfloat16, cpu) is ptrs
    assert list(ptrs) == [tfused._get(blk, f).data_ptr() for f in tfused.WEIGHT_FIELDS]
    with pytest.raises(ValueError, match="w_qs/kernel"):
        tfused._weight_pointers(blk, torch.float32, cpu)


def test_kernels_build_inside_the_checkout():
    root = pathlib.Path(__file__).resolve().parents[1]
    assert _build.BUILD_DIR == root / "build" / "torch_kernels"


def test_weight_pointer_cache_is_bounded(blocks):
    _, tb = blocks
    cpu = torch.device("cpu")
    for _ in range(tfused._PACKED_MAX + 5):
        blk = to_device({"encoder": {"blocks": [tb]}}, cpu, torch.float32)["encoder"]["blocks"][0]
        tfused._weight_pointers(blk, torch.float32, cpu)
    assert len(tfused._packed) == tfused._PACKED_MAX
    assert next(reversed(tfused._packed.values()))[0] is blk
