"""The two-block kernel's plain version and the `packed` argument of the fused
block (ops/fft_block.py), and the decoder and predict step at
`pallas_pair: true`, against the JAX package on the JAX CPU backend with its
Pallas kernels in interpret mode (as tests/test_pallas.py runs them).

Bars: float32 rtol 2e-3 / atol 2e-4 (test_pallas.py:26-39), bfloat16 within 4
bf16 ULPs of max(1, max|ref|) (test_pallas.py:43-65); the pair bit-equal to
the plain one-block version applied twice, in both dtypes and both softmax
forms; the predict step at `pallas_pair: true` in float32 with counts equal
to the JAX package's and samples within 1 count on all but 0.1 %, and equal
bit for bit to the port's own `pallas_pair: false`.
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.models import fft_model as jmodel
from seq2squiggle_tpu.models.fft_model import init_params
from seq2squiggle_tpu.models.torch_import import load_checkpoint as jax_load_checkpoint
from seq2squiggle_tpu.ops.pallas import fft_block as jfused
from seq2squiggle_tpu.runtime.predict import PredictKnobs as JaxKnobs
from seq2squiggle_tpu.runtime.predict import make_predict_fn
from seq2squiggle_tpu_torch import prng
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.models.weights import params_from_jax
from seq2squiggle_tpu_torch.ops import fft_block as tfused
from seq2squiggle_tpu_torch.runtime import predict as tpredict

R10 = str(pathlib.Path(__file__).resolve().parents[1] / "assets" / "bench-weights-R10.npz")


@pytest.fixture(scope="module")
def blocks():
    """Two different blocks of a seed-0 model, as both packages hold them."""
    jp = init_params(load_config(None), jax.random.key(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return ((jp["encoder"]["blocks"][0], jp["decoder"]["blocks"][0]),
            (tp["encoder"]["blocks"][0], tp["decoder"]["blocks"][0]))


def _to(x: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array of `dtype`."""
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)))
    return xj, xt.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _cast_block(block, dtype):
    """A block as models.fft_model.to_device hands it to the kernel wrapper."""
    tree = {"encoder": {"blocks": [block]}}
    return tmodel.to_device(tree, torch.device("cpu"), dtype)["encoder"]["blocks"][0]


def _hold(got: torch.Tensor, ref, dtype: str):
    ref = np.asarray(ref).astype(np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
    else:
        tol = 4 * 2.0 ** -8 * max(1.0, float(np.max(np.abs(ref))))
        assert float(np.max(np.abs(got - ref))) <= tol


# ------------------------------------------------------------------ the pair


@pytest.mark.parametrize("shape", [(4, 250, 64), (3, 16, 64)], ids=["4x250", "ragged3x16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_reference_matches_pallas_pair(blocks, shape, dtype):
    (jb0, jb1), (tb0, tb1) = blocks
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    xj, xt = _to(x, dtype)
    ref = jfused.fused_fft_block_pair(xj, jb0, jb1, n_head=8, interpret=True, tile_b=2)
    got = tfused.fused_fft_block_pair_reference(xt, tb0, tb1, 8)
    assert got.dtype == xt.dtype
    _hold(got, ref, dtype)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_bit_equal_to_two_blocks(blocks, dtype, packed):
    """The pair (wrapper on a CPU tensor and plain version) against the plain
    one-block version applied twice: no tolerance."""
    _, (tb0, tb1) = blocks
    x = np.random.default_rng(5).standard_normal((3, 40, 64)).astype(np.float32)
    _, xt = _to(x, dtype)
    b0, b1 = _cast_block(tb0, xt.dtype), _cast_block(tb1, xt.dtype)
    seq = tfused.fused_fft_block_reference(
        tfused.fused_fft_block_reference(xt, b0, 8, packed), b1, 8, packed)
    before = tfused.pair_launches, tfused.launches
    pair = tfused.fused_fft_block_pair(xt, b0, b1, 8, packed=packed)
    assert (tfused.pair_launches, tfused.launches) == before  # a CPU tensor launches nothing
    assert pair.dtype == xt.dtype
    assert torch.equal(pair, seq)
    assert torch.equal(tfused.fused_fft_block_pair_reference(xt, b0, b1, 8, packed), seq)


def test_jax_block_pair_round_trips_into_the_pair(blocks):
    """params_from_jax carries a JAX block pair across unchanged: the 32
    arrays the pair reads are the JAX package's, in its kernel's order."""
    (jb0, jb1), (tb0, tb1) = blocks
    for jb, tb in ((jb0, tb0), (jb1, tb1)):
        for path in tfused.WEIGHT_FIELDS:
            assert path in jfused._WEIGHT_FIELDS
            np.testing.assert_array_equal(np.asarray(jfused._get(jb, path)),
                                          tfused._get(tb, path).numpy())
    assert tfused.WEIGHT_FIELDS == tuple(jfused._WEIGHT_FIELDS)


# --------------------------------------------------------- the packed argument


@pytest.mark.parametrize("L,packed", [(250, False), (16, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_argument_matches_pallas(blocks, L, packed, dtype):
    """The two (length, softmax form) cases that `packed=None` never picks."""
    (jb, _), (tb, _) = blocks
    x = np.random.default_rng(L).standard_normal((3, L, 64)).astype(np.float32)
    xj, xt = _to(x, dtype)
    ref = jfused.fused_fft_block(xj, jb, n_head=8, interpret=True, tile_b=2, packed=packed)
    got = tfused.fused_fft_block_reference(xt, tb, 8, packed)
    _hold(got, ref, dtype)
    assert not torch.equal(got, tfused.fused_fft_block_reference(xt, tb, 8, not packed))


def test_packed_none_picks_the_form_by_length(blocks):
    _, (tb, _) = blocks
    for L, packed in ((16, False), (32, False), (33, True)):
        x = torch.from_numpy(
            np.random.default_rng(L).standard_normal((2, L, 64)).astype(np.float32))
        assert tfused.packed_default(L) is packed
        assert torch.equal(tfused.fused_fft_block(x, tb, 8),
                           tfused.fused_fft_block_reference(x, tb, 8, packed))


@pytest.mark.parametrize("pair", [False, True])
def test_packed_underflow_input_is_finite(blocks, pair):
    """test_pallas.py:111-137's input with `packed=True`: the Cauchy–Schwarz
    shift overshoots every score by far more than 88, every exp underflows,
    and den >= 1e-30 keeps ctx at 0 instead of NaN."""
    _, (tb0, tb1) = blocks
    rng = np.random.default_rng(3)
    d = np.zeros((2, 64), np.float32)
    d[0, ::2] = 1.0
    d[1, 1::2] = 1.0
    x = d[np.tile([0, 1], 125)] * 3e3 + rng.standard_normal((250, 64)) * 1e-2
    x = torch.from_numpy(np.broadcast_to(x, (2, 250, 64)).astype(np.float32).copy())
    if pair:
        out = tfused.fused_fft_block_pair(x, tb0, tb1, 8, packed=True)
    else:
        out = tfused.fused_fft_block(x, tb0, 8, packed=True)
    assert torch.isfinite(out).all()


def test_wrappers_refuse_other_widths_on_the_launch_path(blocks):
    _, (tb0, _) = blocks
    with pytest.raises(ValueError, match="64"):
        tfused.check_input(torch.zeros(2, 16, 32), 8, "fused_fft_block_pair")
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfused.check_input(torch.zeros(2, 16, 64, dtype=torch.float16), 8, "fused_fft_block")


# ------------------------------------------------------------- model level


@pytest.fixture(scope="module")
def r10():
    jp, _ = jax_load_checkpoint(R10)
    return jp, params_from_jax(jp)


@pytest.fixture
def interpreted(monkeypatch):
    """The JAX package's fused kernels in interpret mode: its model calls them
    without the argument, which only lowers on a TPU."""
    for name in ("fused_fft_block", "fused_fft_block_pair"):
        monkeypatch.setattr(jfused, name, functools.partial(getattr(jfused, name),
                                                            interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", ["auto", False])
def test_decoder_forward_with_pallas_pair(r10, interpreted, dtype, packed):
    jp, tp = r10
    cfg = dict(load_config(None), compute_dtype=dtype, use_pallas=True, pallas_pair=True,
               pallas_packed=packed)
    x = np.random.default_rng(6).standard_normal((2, 250, 64)).astype(np.float32)
    xj, xt = _to(x, dtype)
    tpd = tmodel.to_device(tp, torch.device("cpu"), xt.dtype)
    got = tmodel.decoder_forward(tpd, xt, cfg)
    ref = np.asarray(jmodel.decoder_forward(jp, xj, cfg)).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=2e-4)
    else:
        tol = 4 * 2.0 ** -8 * max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(got.float().numpy() - ref).max()) <= tol
    # the port's own two launches give the same bits
    assert torch.equal(got, tmodel.decoder_forward(tpd, xt, dict(cfg, pallas_pair=False)))
    assert torch.equal(got, tmodel.decoder_forward(tpd, xt, dict(cfg, pallas_pair="auto")))


def test_pair_mode_and_packed_mode_read_the_knobs():
    assert tmodel._pair_mode({}) is False and tmodel._pair_mode({"pallas_pair": "auto"}) is False
    assert tmodel._pair_mode({"pallas_pair": True}) is True
    assert tmodel._packed_mode({}) is None
    assert tmodel._packed_mode({"pallas_packed": False}) is False
    assert tmodel._packed_mode({"pallas_packed": True}) is True


def test_pair_is_taken_only_by_a_two_block_decoder(r10, monkeypatch):
    """The decoder pairs exactly when the knob is on and it has two blocks;
    the encoder never does."""
    _, tp = r10
    tpd = tmodel.to_device(tp, torch.device("cpu"), torch.float32)
    calls = []
    real_pair, real_one = tmodel.fused_fft_block_pair, tmodel.fused_fft_block
    monkeypatch.setattr(tmodel, "fused_fft_block_pair",
                        lambda *a, **k: calls.append("pair") or real_pair(*a, **k))
    monkeypatch.setattr(tmodel, "fused_fft_block",
                        lambda *a, **k: calls.append("one") or real_one(*a, **k))
    cfg = dict(load_config(None), compute_dtype="float32", use_pallas=True, pallas_pair=True)
    x = torch.zeros(1, 40, 64)
    tmodel.decoder_forward(tpd, x, cfg)
    assert calls == ["pair"]
    calls.clear()
    three = dict(tpd, decoder=dict(tpd["decoder"], blocks=(tpd["decoder"]["blocks"] * 2)[:3]))
    tmodel.decoder_forward(three, x, cfg)
    assert calls == ["one"] * 3
    calls.clear()
    tmodel.encoder_forward(tpd, torch.zeros(1, 16, 45), cfg)
    assert calls == ["one"] * 2
    calls.clear()
    tmodel.decoder_forward(tpd, x, dict(cfg, pallas_pair="auto"))
    assert calls == ["one"] * 2


def test_predict_step_with_pallas_pair(r10, interpreted):
    jp, tp = r10
    cfg = dict(load_config(None), compute_dtype="float32", use_pallas=True, pallas_pair=True)
    knob_kw = dict(duration_sampling=False, dwell_std=0.0, dwell_mean=12.0)
    rng = np.random.default_rng(2)
    B = 8
    codes = rng.integers(1, 5, (B, 24)).astype(np.uint8)
    ridx = np.arange(B, dtype=np.int32)
    ridx[-1] = -1
    coff = rng.integers(0, 40, B).astype(np.int32)
    nk = np.full(B, 16, np.uint8)
    nk[2] = 7
    js, jc = make_predict_fn(cfg, JaxKnobs(**knob_kw))(
        jp, jnp.asarray(codes), jnp.asarray(ridx), jnp.asarray(coff),
        jax.random.key(5), jnp.asarray(nk))
    args = [torch.from_numpy(a) for a in (codes, ridx, coff)]
    tpd = tmodel.to_device(tp, torch.device("cpu"), torch.float32)

    def step(config):
        return tpredict.predict_step(tpd, *args, prng.key(5), torch.from_numpy(nk),
                                     config=config, knobs=tpredict.PredictKnobs(**knob_kw))

    ts, tc = step(cfg)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    valid = np.arange(ts.shape[1])[None] < np.asarray(jc)[:, None]
    d = np.abs(ts.numpy().astype(np.int64) - np.asarray(js).astype(np.int64))[valid]
    assert d.max() <= 1 and (d == 1).mean() <= 0.001
    ts2, tc2 = step(dict(cfg, pallas_pair=False))
    assert torch.equal(ts, ts2) and torch.equal(tc, tc2)
