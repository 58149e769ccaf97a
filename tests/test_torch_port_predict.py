"""The port's device step (runtime/predict.py::predict_step, raw int16 wire;
the packed tiers are held in test_torch_port_wire.py) against
seq2squiggle_tpu.runtime.predict on the JAX CPU backend, with the committed
R10 weights.

Bars:
  - float32, samplers on: durations equal on >= 99.9 % of chunks; on those
    chunks counts are equal and int16 samples equal except |Δ| <= 1 on
    <= 0.1 % of samples;
  - bfloat16, samplers off: counts equal; |Δsample| <= ceil(4 · 2^-8 ·
    max|dec| · 165 · digitisation / range) + 1 ADC counts (4 bf16 ULPs of
    the decoder output, scaled to counts, plus the rounding step).
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.models import fft_model as jmodel
from seq2squiggle_tpu.models.torch_import import load_checkpoint as jax_load_checkpoint
from seq2squiggle_tpu.runtime.predict import PredictKnobs as JaxKnobs
from seq2squiggle_tpu.runtime.predict import _compute_durations as jax_durations
from seq2squiggle_tpu.runtime.predict import make_predict_fn
from seq2squiggle_tpu.sampling import per_chunk_keys
from seq2squiggle_tpu_torch import prng
from seq2squiggle_tpu_torch.models.fft_model import compute_dtype, to_device
from seq2squiggle_tpu_torch.models.weights import params_from_jax
from seq2squiggle_tpu_torch.runtime import predict as tpredict

R10 = str(pathlib.Path(__file__).resolve().parents[1] / "assets" / "bench-weights-R10.npz")
SEED = 5


@pytest.fixture(scope="module")
def weights():
    jp, _ = jax_load_checkpoint(R10)
    return jp, params_from_jax(jp)


def _batch(B=48, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(1, 5, (B, 16 + 9 - 1)).astype(np.uint8)
    codes[3, 4] = 5  # an unknown base
    ridx = np.arange(B, dtype=np.int32)
    ridx[-3:] = -1  # padding rows
    coff = rng.integers(0, 40, B).astype(np.int32)
    nk = np.full(B, 16, np.uint8)
    nk[5], nk[6] = 7, 1
    return codes, ridx, coff, nk


def _run(weights, cfg, knob_kw, batch):
    jp, tp = weights
    codes, ridx, coff, nk = batch
    js, jc = make_predict_fn(cfg, JaxKnobs(**knob_kw))(
        jp, jnp.asarray(codes), jnp.asarray(ridx), jnp.asarray(coff),
        jax.random.key(SEED), jnp.asarray(nk))
    ts, tc = tpredict.predict_step(
        to_device(tp, torch.device("cpu"), compute_dtype(cfg)),
        torch.from_numpy(codes), torch.from_numpy(ridx), torch.from_numpy(coff),
        prng.key(SEED), torch.from_numpy(nk), config=cfg,
        knobs=tpredict.PredictKnobs(**knob_kw))
    assert ts.dtype == torch.int16 and tc.dtype == torch.int32
    return np.asarray(js), np.asarray(jc), ts.numpy(), tc.numpy()


def _durations(weights, cfg, knob_kw, batch):
    """Both ports' dwell counts for the batch, from the same embeddings."""
    jp, tp = weights
    codes, ridx, coff, nk = batch
    k, K = 9, 16
    kmers = np.stack([codes[:, j:j + K] for j in range(k)], -1)
    kmers = np.where((np.arange(K)[None] < nk[:, None])[..., None], kmers, 0)
    oh = (kmers[..., None] == np.arange(5)).astype(np.float32).reshape(len(codes), K, -1)
    _, emb = jmodel.encoder_forward(jp, jnp.asarray(oh), cfg)
    emb = np.asarray(emb).astype(np.float32)
    keys = jax.vmap(lambda c, o: jax.random.fold_in(jax.random.fold_in(c, o), 1))(
        per_chunk_keys(jax.random.key(SEED), jnp.asarray(ridx)), jnp.asarray(coff))
    jd = np.asarray(jax_durations(jp, jnp.asarray(emb), keys, JaxKnobs(**knob_kw), cfg))
    _, td = tpredict._keys_and_durations(to_device(tp, torch.device("cpu"), torch.float32),
                                         torch.from_numpy(emb), prng.key(SEED),
                                         torch.from_numpy(ridx), torch.from_numpy(coff),
                                         tpredict.PredictKnobs(**knob_kw), cfg)
    td = td.numpy()
    return jd, td


def _f32_bar(js, jc, ts, tc, dur_equal):
    assert dur_equal.mean() >= 0.999
    assert (jc[dur_equal] == tc[dur_equal]).all()
    T = js.shape[1]
    valid = (np.arange(T)[None] < jc[:, None]) & dur_equal[:, None]
    d = np.abs(js.astype(np.int64) - ts.astype(np.int64))[valid]
    assert d.max(initial=0) <= 1
    assert (d == 1).mean() <= 0.001


@pytest.mark.parametrize("knob_kw", [
    dict(dwell_mean=10.0),  # Gamma durations + sampled noise
    dict(duration_sampling=False, dwell_std=4.0, dwell_mean=9.0, noise_sampling=False),
])
def test_predict_step_f32_samplers_on(weights, knob_kw):
    cfg = dict(load_config(None), compute_dtype="float32")
    batch = _batch()
    jd, td = _durations(weights, cfg, knob_kw, batch)
    dur_equal = (jd == td).all(axis=1)
    js, jc, ts, tc = _run(weights, cfg, knob_kw, batch)
    _f32_bar(js, jc, ts, tc, dur_equal)
    assert (tc[-3:] == 0).all() and (tc[:-3] > 0).all()


def test_predict_step_bf16_samplers_off(weights):
    cfg = dict(load_config(None), compute_dtype="bfloat16")
    knob_kw = dict(duration_sampling=False, dwell_std=0.0, noise_std=0.0, dwell_mean=12.0)
    batch = _batch(seed=1)
    js, jc, ts, tc = _run(weights, cfg, knob_kw, batch)
    np.testing.assert_array_equal(jc, tc)

    # max|dec| from the step's own decoder output on this batch
    _, tp = weights
    k = tpredict.PredictKnobs(**knob_kw)
    dec = tpredict.decoder_output(
        to_device(tp, torch.device("cpu"), torch.bfloat16),
        *(torch.from_numpy(a) for a in batch[:3]), prng.key(SEED),
        torch.from_numpy(batch[3]), config=cfg, knobs=k)[0]
    max_dec = dec.float().abs().max().item()
    bar = math.ceil(4 * 2.0 ** -8 * max_dec * k.scaling_max_value * k.digitisation
                    / k.signal_range) + 1
    valid = np.arange(js.shape[1])[None] < jc[:, None]
    d = np.abs(js.astype(np.int64) - ts.astype(np.int64))[valid]
    assert d.max() <= bar


def test_stable_front_compact():
    vals = torch.arange(12, dtype=torch.int16).reshape(2, 6)
    keep = torch.tensor([[1, 0, 1, 1, 0, 0], [0, 0, 0, 0, 0, 1]], dtype=torch.bool)
    out = tpredict._stable_front_compact(vals, keep)
    assert out.tolist() == [[0, 2, 3, 1, 4, 5], [11, 6, 7, 8, 9, 10]]


def test_packed_wire_formats_are_not_ported(weights):
    """The packed formats are ported now (the name is kept from when they
    raised): an 8-bit predict_step unpacks to the raw step's rows, and its
    framed buffer splits into the same arrays."""
    from seq2squiggle_tpu_torch.runtime.wire import unframe_wire, unpack_wire

    _, tp = weights
    batch = [torch.from_numpy(a) for a in _batch(B=8)]
    params = to_device(tp, torch.device("cpu"), torch.float32)
    cfg = dict(load_config(None), compute_dtype="float32")

    def step(bits, framed=False):
        return tpredict.predict_step(params, *batch[:3], prng.key(0), batch[3], config=cfg,
                                     knobs=tpredict.PredictKnobs(wire_bits=bits),
                                     framed=framed)

    sig, counts = (t.numpy() for t in step(16))
    outs = [t.numpy() for t in step(8)]
    np.testing.assert_array_equal(outs[4], counts)
    got = unpack_wire(*outs[:4], bits=8)
    live = np.arange(sig.shape[1])[None] < counts[:, None]
    np.testing.assert_array_equal(got[live], sig[live])
    for a, b in zip(unframe_wire(step(8, framed=True).numpy(), 8, 250, 16), outs):
        np.testing.assert_array_equal(a, b)
