"""Threefry-2x32 counter-based random numbers, draw for draw with jax.random.

The JAX package derives every random number on the predict path from
threefry keys: `jax.random.key(seed)`, `fold_in` by read index and chunk
offset, `split`, then `uniform` / `normal` (sampling.py, runtime/predict.py,
models/fft_model.init_params). This module reproduces those calls in torch
integer ops so the port simulates the same reads from the same `--seed`.

Conventions (jax 0.9.0, `jax_threefry_partitionable` on, its default):
  - a key is an int64 tensor of shape (..., 2) holding two uint32 words;
  - `fold_in(key, d)` = threefry2x32(key, (0, d));
  - `split(key, n)[i]` = threefry2x32(key, (0, i));
  - the i-th 32-bit word of `random_bits(key, shape)` (row-major flat
    index i) is x0 ^ x1 of threefry2x32(key, (0, i));
  - `uniform` maps bits >> 9 into [1, 2), subtracts 1 and scales in f32;
  - `normal` is sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1)) with XLA's
    single-precision erfinv polynomial (not `torch.erfinv`).

uint32 values live in int64 tensors and are masked with 0xFFFFFFFF after
every add and shift, so the same code runs on CPU and CUDA. The C++ copy in
seq2squiggle_tpu/io/native/slow5_codec.cc (threefry2x32, fold_in,
erfinv_f32, bits_to_normal) is the written spec.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2 = np.float32(np.sqrt(2.0))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

IntLike = Union[int, torch.Tensor]


def _u32(x: IntLike, device: torch.device) -> IntLike:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & MASK
    return int(x) & MASK


def threefry2x32(k0, k1, x0, x1):
    """One Threefry-2x32-20 block; all arguments broadcastable int64."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK
    return x0, x1


def key(seed: int, device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """jax.random.key(seed) for a non-negative Python int, shape (2,)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """jax.random.fold_in; key (..., 2), data an int or a tensor broadcastable
    to key[..., 0] (int32 values wrap to uint32 as in jax)."""
    d = _u32(data, key.device)
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], 0, d)
    return torch.stack([o0, o1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split: key (..., 2) -> (..., num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(i), i)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.bits (32-bit): key (..., 2) -> (..., *shape) int64 uint32
    values. Each leading key index draws its own independent stream."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(i), i)
    return (o0 ^ o1).reshape(key.shape[:-1] + shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): mantissa from the top 23 bits."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def fma(a, b, c) -> torch.Tensor:
    """f32 fused multiply-add, as XLA's CPU backend contracts `a * b + c`.

    Arguments are f32 tensors or f32-valued Python floats (see _f32). The f32
    product is exact in f64, so one f64 add and one rounding to f32 reproduce
    the single rounding of a hardware FMA (up to double rounding, which never
    showed in millions of draws)."""
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else v

    return (f64(a) * f64(b) + f64(c)).float()


def f32(x: float) -> float:
    """x rounded to float32, as a Python float: a constant that mixes with
    tensors on any device without a host-to-device copy."""
    return float(np.float32(x))


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def log_xla(x: torch.Tensor) -> torch.Tensor:
    """f32 natural log as XLA's CPU backend computes it (Cephes/Eigen plog
    with FMA contraction), bit for bit on positive normal inputs."""
    xi = x.view(torch.int32)
    e = ((xi >> 23) & 0xFF).float() - 126.0
    m = ((xi & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < f32(0.707106781186547524)
    tmp = torch.where(small, m, torch.zeros_like(m))
    m = m - 1.0
    e = e - small.float()
    m = m + tmp
    x2 = m * m
    x3 = x2 * m
    p = [f32(c) for c in _LOG_P]
    y = fma(m, p[0], p[1])
    y1 = fma(m, p[3], p[4])
    y2 = fma(m, p[6], p[7])
    y = fma(y, m, p[2])
    y1 = fma(y1, m, p[5])
    y2 = fma(y2, m, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * f32(-2.12194440e-4))
    m = fma(x2, -0.5, m)
    m = m + y
    return fma(e, f32(0.693359375), m)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma(p, x, f32(c))
    return p


def log1p_xla(x: torch.Tensor, one_plus_x: torch.Tensor = None) -> torch.Tensor:
    """f32 log1p as XLA's elemental emitter computes it: a Cephes rational
    for |x| < sqrt(2) - 1, log(1 + x) otherwise. `one_plus_x` overrides
    1 + x where XLA contracted it with the op that produced x."""
    x2 = x * x
    r = _poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)
    small = x + fma(x2, -0.5, (x * x2) * r)
    if one_plus_x is None:
        one_plus_x = x + 1.0
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       log_xla(one_plus_x))


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = _bits_to_unit(random_bits(key, shape))
    return fma(f, float(hi - lo), float(lo)).clamp_min(float(lo))


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision erfinv (Giles' polynomial), for |x| < 1."""
    w = -log1p_xla(-x * x)
    small = w < 5.0
    # torch's vectorised f32 sqrt on the CPU is not correctly rounded
    w = torch.where(small, w - 2.5, w.double().sqrt().float() - 3.0)
    p = None
    for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        c = torch.where(small, f32(a), f32(b))
        p = c if p is None else fma(p, w, c)
    return p * x


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.normal(key, shape, float32)."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return float(_SQRT2) * erfinv_xla(u)
