"""The port's sampling (seq2squiggle_tpu_torch/sampling.py) against
seq2squiggle_tpu/sampling.py on the JAX CPU backend.

Bars: per-chunk keys bit-equal; normals within 1 f32 ULP; Gamma draws
within rtol 1e-5 on >= 99.9 % of draws and equal after round() on
>= 99.9 % (XLA's and torch's exp may differ by ULPs; XLA flushes subnormals).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu import sampling as jsampling
from seq2squiggle_tpu_torch import prng
from seq2squiggle_tpu_torch import sampling as tsampling


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
