"""Threefry-2x32 counter-based random numbers as jax.random draws them.

The program derives every random number of its predict and train paths from
threefry keys (`key(seed)`, `fold_in`, `split`, `uniform`, `normal`,
`bernoulli`, with jax's partitionable counter layout). This is a plain
rewrite from the published algorithm (Salmon et al., SC'11, 20 rounds) and
jax's conventions:

  - a key is an int64 tensor (..., 2) of two uint32 words;
  - fold_in(key, d) = threefry(key, (0, d)); split(key, n)[i] = threefry(key, (0, i));
  - the i-th 32-bit word of bits(key, shape) is x0 ^ x1 of threefry(key, (0, i));
  - uniform maps bits >> 9 into [1, 2) and subtracts 1;
  - normal is sqrt(2) * erfinv(u), u uniform in (nextafter(-1, 0), 1).

uint32 values live in int64 tensors, masked after every add and shift, so the
same code runs on the CPU and on a card. `erfinv` is torch's in float64,
rounded once to float32: it may differ from XLA's single-precision polynomial
in the last bit, which the comparisons tolerate.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds; arguments broadcastable int64 tensors or ints."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & M32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & M32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        data = data.to(device=k.device, dtype=torch.int64) & M32
    else:
        data = int(data) & M32
    o0, o1 = threefry(k[..., 0], k[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(o0, o1), dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    o0, o1 = threefry(k[..., 0, None], k[..., 1, None], torch.zeros_like(i), i)
    return torch.stack([o0, o1], dim=-1)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """(..., *shape) uint32 words in int64, one stream per leading key."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    o0, o1 = threefry(k[..., 0, None], k[..., 1, None], torch.zeros_like(i), i)
    return (o0 ^ o1).reshape(k.shape[:-1] + shape)


def uniform(k: torch.Tensor, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    f = ((bits(k, shape) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo32, hi32 = float(np.float32(lo)), float(np.float32(hi))
    span = float(np.float32(hi32 - lo32))
    return (f.double() * span + lo32).float().clamp_min(lo32)


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0)
    return (np.sqrt(2.0) * torch.erfinv(u.double())).float()


def bernoulli(k: torch.Tensor, p: float, shape) -> torch.Tensor:
    return uniform(k, shape) < float(np.float32(p))


GAMMA_ROUNDS = 8


def gamma(keys: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Gamma(a, 1), one key per row of a (B, K): Marsaglia and Tsang's method
    with a fixed number of rounds, as the program's sampler draws it. Round i
    takes its (normal, uniform) pair from split(fold_in(key, i)) and the first
    accepted proposal wins; a row that never accepts keeps the mode d. For
    a < 1 the sample of a + 1 is boosted by U^(1/a), U from fold_in(key, 8)."""
    a = a.float()
    K = a.shape[-1]
    boost = a < 1.0
    a1 = torch.where(boost, a + 1.0, a)
    d = a1 - float(np.float32(1.0 / 3.0))
    c = 1.0 / torch.sqrt(9.0 * d)
    sample = d.clone()
    done = torch.zeros_like(boost)
    for i in range(GAMMA_ROUNDS):
        kn_ku = split(fold_in(keys, i))
        x = normal(kn_ku[..., 0, :], (K,))
        t = 1.0 + c * x
        v = t * t * t
        u = uniform(kn_ku[..., 1, :], (K,), 1e-37, 1.0)
        ok = v > 0.0
        log_v = torch.log(torch.where(ok, v, torch.ones_like(v)))
        accept = ok & (torch.log(u) < 0.5 * x * x + d * (1.0 - v + log_v))
        sample = torch.where(accept & ~done, d * v, sample)
        done = done | accept
    u_boost = uniform(fold_in(keys, GAMMA_ROUNDS), (K,), 1e-37, 1.0)
    log_s = torch.log(sample) + torch.where(boost, torch.log(u_boost) / a, torch.zeros_like(a))
    g = torch.exp(log_s)
    return torch.where(g < float(np.finfo(np.float32).tiny), torch.zeros_like(g), g)
