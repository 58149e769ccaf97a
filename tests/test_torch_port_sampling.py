"""The port's sampling (seq2squiggle_tpu_torch/sampling.py) against
seq2squiggle_tpu/sampling.py on the JAX CPU backend, and the Gamma dwell
kernel's two paths (ops/threefry.py): the plain one on the CPU, the kernel
against it on the card (`gpu`).

Bars: per-chunk keys bit-equal; normals within 1 f32 ULP; Gamma draws
within rtol 1e-5 on >= 99.9 % of draws and equal after round() on
>= 99.9 % (XLA's and torch's exp may differ by ULPs; XLA flushes subnormals).
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu import sampling as jsampling
from seq2squiggle_tpu_torch import prng, tracing
from seq2squiggle_tpu_torch import sampling as tsampling
from seq2squiggle_tpu_torch.config import load_config
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.ops import threefry as tthreefry
from seq2squiggle_tpu_torch.runtime import predict as tpredict


def _keys(seed, n):
    idx = np.arange(n, dtype=np.int32) * 7 + 1
    jk = jsampling.per_chunk_keys(jax.random.key(seed), jnp.asarray(idx))
    tk = tsampling.per_chunk_keys(prng.key(seed), torch.from_numpy(idx))
    return jk, tk


def test_per_chunk_keys_bit_equal():
    jk, tk = _keys(3, 64)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jk)).astype(np.int64), tk.numpy())


def test_sample_normal_within_one_ulp():
    jk, tk = _keys(5, 32)
    ref = np.asarray(jsampling.sample_normal(jk, (250,)))
    got = tsampling.sample_normal(tk, (250,)).numpy()
    assert got.shape == (32, 250)
    ulps = np.abs(ref.view(np.int32).astype(np.int64) - got.view(np.int32))
    assert ulps.max() <= 1


@pytest.mark.parametrize("lo,hi", [(0.01, 1.0), (0.5, 60.0)])
def test_sample_gamma_durations(lo, hi):
    rng = np.random.default_rng(0)
    B, K = 1024, 16
    conc = np.exp(rng.uniform(np.log(lo), np.log(hi), (B, K))).astype(np.float32)
    rate = np.exp(rng.uniform(np.log(0.05), np.log(5.0), (B, K))).astype(np.float32)
    jk, tk = _keys(11, B)
    ref = np.asarray(jax.jit(jsampling.sample_gamma_durations)(
        jk, jnp.asarray(conc), jnp.asarray(rate)))
    got = tsampling.sample_gamma_durations(
        tk, torch.from_numpy(conc), torch.from_numpy(rate)).numpy()
    assert np.isfinite(got).all()
    assert np.isclose(got, ref, rtol=1e-5, atol=0).mean() >= 0.999
    assert (np.round(got) == np.round(ref)).mean() >= 0.999


# ---- the Gamma dwell kernel's two paths (ops/threefry.py) ----
# On the CPU the draw takes the plain path, the torch ops above; the kernel
# (csrc/threefry.cu) runs on the card only, where the `gpu` tests hold it
# against that path.

HEADER = pathlib.Path(tthreefry.__file__).resolve().parents[1] / "csrc" / "threefry.cuh"


def _f32s(values):
    return [float(np.float32(v)) for v in values]


def _header_constants(name: str) -> list:
    """The hex float literals of one device function of threefry.cuh, or of
    one constexpr line ("NAME ="), in source order."""
    text = HEADER.read_text()
    if name.endswith("="):
        start = text.index(name)
        end = text.index("\n", start)
    else:
        start = text.index(f" {name}(")
        end = text.index("\n}\n", start)
    return [float.fromhex(h[:-1])
            for h in re.findall(r"-?0x[0-9a-fA-F.]+p[-+]?\d+f", text[start:end])]


@pytest.mark.parametrize("fn,want", [
    ("log_xla", _f32s([0.707106781186547524, *(prng._LOG_P[i] for i in (0, 1, 3, 4, 6, 7, 2, 5, 8)),
                       -2.12194440e-4, 0.693359375])),
    ("log1p_xla", _f32s([0.41421356237309504880, *prng._LOG1P_NUM, *prng._LOG1P_DEN[1:]])),
    ("erfinv_xla", _f32s([c for pair in zip(prng._ERFINV_SMALL, prng._ERFINV_LARGE) for c in pair])),
    ("normal", _f32s([prng._SQRT2, prng._NORMAL_LO])),
    ("gamma_draw", _f32s([1.0 / 3.0])),
    ("UNIFORM_LO =", _f32s([1e-37])),
    ("FLT_MIN_F32 =", [tsampling._FLT_MIN]),
])
def test_kernel_constants_are_prngs(fn, want):
    """The kernel's constants are prng.py's and sampling.py's, rounded to
    f32 as they round them, in the order their plain versions use them."""
    assert _header_constants(fn) == want


def _chain_inputs(B=64, K=16, seed=2 ** 32 - 99):  # the widest seed jax takes without x64
    rng = np.random.default_rng(0)
    read_idx = rng.integers(0, 2 ** 31 - 1, B).astype(np.int32)
    read_idx[-5:] = -1  # padding rows
    chunk_off = rng.integers(0, 400, B).astype(np.int32)
    conc = np.exp(rng.uniform(np.log(0.01), np.log(60.0), (B, K))).astype(np.float32)
    rate = np.exp(rng.uniform(np.log(0.05), np.log(5.0), (B, K))).astype(np.float32)
    return seed, read_idx, chunk_off, conc, rate


@pytest.fixture
def counting(monkeypatch):
    """The span recorder on and empty; both restored afterwards."""
    monkeypatch.setenv(tracing.ENV, "1")
    tracing.switch_from_env()
    tracing.reset()
    yield
    monkeypatch.delenv(tracing.ENV, raising=False)
    tracing.switch_from_env()
    tracing.reset()


def test_chunk_keys_match_jax(counting):
    """The key chain of either path is the JAX package's, padding rows (read
    index -1, wrapped to uint32) included."""
    seed, read_idx, chunk_off, _, _ = _chain_inputs()
    ref = jax.vmap(jax.random.fold_in)(
        jsampling.per_chunk_keys(jax.random.key(seed), jnp.asarray(read_idx)),
        jnp.asarray(chunk_off))
    got = tthreefry.chunk_keys(prng.key(seed), torch.from_numpy(read_idx),
                               torch.from_numpy(chunk_off))
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(ref)).astype(np.int64),
                                  got.numpy())
    assert tracing.totals().counts == {}  # keys alone draw nothing


def test_cpu_draw_takes_the_plain_path(counting):
    """On the CPU the keys and counts are prng.py's and sampling.py's ops bit
    for bit, counted as plain rows; no kernel launches."""
    seed, read_idx, chunk_off, conc, rate = _chain_inputs()
    launches = tthreefry.launches
    keys, dur = tthreefry.chunk_keys_and_durations(
        prng.key(seed), torch.from_numpy(read_idx), torch.from_numpy(chunk_off),
        torch.from_numpy(conc), torch.from_numpy(rate), 3)
    want_keys = prng.fold_in(tsampling.per_chunk_keys(prng.key(seed), torch.from_numpy(read_idx)),
                             torch.from_numpy(chunk_off))
    draws = tsampling.sample_gamma_durations(prng.fold_in(want_keys, 1), torch.from_numpy(conc),
                                             torch.from_numpy(rate))
    want_dur = torch.round(draws.clamp_min(1.0).clamp_min(3.0)).to(torch.int32)
    assert torch.equal(keys, want_keys) and dur.dtype == torch.int32
    assert torch.equal(dur, want_dur) and (dur >= 3).all()
    got = tthreefry.sample_gamma_durations(prng.fold_in(keys, 1), torch.from_numpy(conc),
                                           torch.from_numpy(rate))
    assert torch.equal(got.view(torch.int32), draws.view(torch.int32))
    assert tracing.totals().counts == {"sampling.gamma_plain": 2 * len(read_idx)}
    assert tthreefry.launches == launches


def test_cpu_predict_step_counts_plain_rows(counting):
    """The predict step on the CPU draws every row on the plain path, inside
    its one `sampling` span."""
    cfg = dict(load_config(None), compute_dtype="float32")
    params = tmodel.init_params(cfg, prng.key(3))
    B = 6
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(1, 5, (B, 16 + 9 - 1)).astype(np.uint8))
    read_idx = torch.tensor([0, 1, 2, 3, -1, -1], dtype=torch.int32)
    tpredict.decoder_output(params, codes, read_idx, torch.zeros(B, dtype=torch.int32),
                            prng.key(9), config=cfg, knobs=tpredict.PredictKnobs())
    got = tracing.totals()
    assert got.counts == {"sampling.gamma_plain": B}
    assert got.spans["sampling"][0] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1024, 37])
def test_gamma_kernel_against_the_plain_path(B):
    """chip_smoke.py phase 18's bars: the kernel's chunk keys bit-equal to the
    plain path's on the card, its draws within rtol 1e-5 on >= 99.9 %, its
    rounded durations equal on >= 99.9 %, padding rows included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    got = chip_smoke.hold_gamma_kernel(torch.device("cuda"), B)
    assert got["close_share"] >= 0.999 and got["durations_equal"] >= 0.999
