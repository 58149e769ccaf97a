"""The port's threefry generator (seq2squiggle_tpu_torch/prng.py) against
jax.random on the JAX CPU backend.

Bars: keys, fold_in, split and 32-bit bits are bit-equal; uniform draws are
bit-equal; normal draws are within 1 f32 ULP (the port mirrors XLA's FMA
contraction, log1p and erfinv, and is bit-equal in practice).
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu_torch import prng


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5])
def test_key_fold_in_split_bit_equal(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(_kd(jk), tk.numpy())
    for data in (0, 1, 7, 123456, 2**32 - 1):
        np.testing.assert_array_equal(
            _kd(jax.random.fold_in(jk, data)), prng.fold_in(tk, data).numpy())
    np.testing.assert_array_equal(_kd(jax.random.split(jk, 5)),
                                  prng.split(tk, 5).numpy())
    np.testing.assert_array_equal(_kd(jax.random.split(jk)), prng.split(tk).numpy())


def test_batched_fold_in_matches_vmap():
    idx = np.array([0, 3, -1, 99, 2**20], np.int32)
    jk = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(9), i))(jnp.asarray(idx))
    tk = prng.fold_in(prng.key(9), torch.from_numpy(idx))
    np.testing.assert_array_equal(_kd(jk), tk.numpy())


@pytest.mark.parametrize("shape", [(5,), (3, 7), (250,), (64, 256)])
def test_bits_bit_equal(shape):
    jk = jax.random.key(11)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64),
        prng.random_bits(prng.key(11), shape).numpy())


@pytest.mark.parametrize("lo,hi,shape", [
    (0.0, 1.0, (4096,)),
    (1e-37, 1.0, (4096,)),
    (-1 / np.sqrt(576.0), 1 / np.sqrt(576.0), (576, 64)),
    (-1 / np.sqrt(64.0), 1 / np.sqrt(64.0), (64, 256)),
])
def test_uniform_bit_equal(lo, hi, shape):
    ref = np.asarray(jax.random.uniform(jax.random.key(3), shape, jnp.float32, lo, hi))
    got = prng.uniform(prng.key(3), shape, lo, hi).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [1, 42])
def test_normal_within_one_ulp(seed):
    ref = np.asarray(jax.random.normal(jax.random.key(seed), (200_000,), jnp.float32))
    got = prng.normal(prng.key(seed), (200_000,)).numpy()
    ulps = np.abs(ref.view(np.int32).astype(np.int64) - got.view(np.int32))
    assert ulps.max() <= 1


def test_batched_normal_rows_are_independent_streams():
    """normal((B, 2) keys, (T,)) equals vmap(normal) over the row keys."""
    keys = jax.random.split(jax.random.key(4), 6)
    ref = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (250,)))(keys))
    got = prng.normal(torch.from_numpy(_kd(keys)), (250,)).numpy()
    ulps = np.abs(ref.view(np.int32).astype(np.int64) - got.view(np.int32))
    assert ulps.max() <= 1


def test_log_xla_bit_equal():
    x = np.concatenate([np.linspace(1.2e-38, 1.0, 50_001),
                        np.linspace(1.0, 1e4, 50_001)]).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    np.testing.assert_array_equal(prng.log_xla(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("p,shape", [(0.8, (3, 50, 64)), (0.5, (4097,)), (0.2, (16, 64))])
def test_bernoulli_bit_equal(p, shape):
    """Dropout masks: jax.random.bernoulli(key, p, shape), mask for mask."""
    ref = np.asarray(jax.random.bernoulli(jax.random.key(6), p, shape))
    got = prng.bernoulli(prng.key(6), p, shape)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert abs(ref.mean() - p) < 0.05
