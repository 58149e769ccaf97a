"""Per-chunk counter-based sampling: the port of seq2squiggle_tpu/sampling.py.

Every chunk row carries its own threefry key (see prng.py), so simulated
signals do not depend on batch size, and they reproduce the JAX package's
draws from the same seed: threefry bits, uniforms and normals bit for bit,
Gamma draws to float rounding (XLA and torch differ in `exp` by an ULP).
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import prng

_GAMMA_ROUNDS = 8  # acceptance ~96%/round; P(no accept in 8) < 1e-11
_FLT_MIN = 1.1754943508222875e-38


def per_chunk_keys(base_key: torch.Tensor, chunk_idx: torch.Tensor) -> torch.Tensor:
    """One key per chunk from the run key. chunk_idx: (B,) int -> (B, 2)."""
    return prng.fold_in(base_key, chunk_idx)


def sample_gamma(keys: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Gamma(a, 1) with exactly 8 Marsaglia–Tsang rounds, one key per row.

    keys: (B, 2); a: (B, K). Round i draws with fold_in(key, i) split into
    (normal, uniform) keys and keeps the first accepted proposal; rows that
    never accept fall back to `d` (the mode). a < 1 uses the boost
    G_a = G_{a+1} * U^(1/a) in log space with key fold_in(key, 8).
    """
    a = a.float()
    K = a.shape[-1]
    boost_needed = a < 1.0
    a_eff = torch.where(boost_needed, a + 1.0, a)
    d = a_eff - prng.f32(1.0 / 3.0)
    c = 1.0 / torch.sqrt(9.0 * d)

    sample = d
    done = torch.zeros_like(boost_needed)
    for i in range(_GAMMA_ROUNDS):
        kn_ku = prng.split(prng.fold_in(keys, i))
        x = prng.normal(kn_ku[..., 0, :], (K,))
        t = prng.fma(c, x, torch.ones_like(x))
        v = t * t * t
        u = prng.uniform(kn_ku[..., 1, :], (K,), 1e-37, 1.0)
        ok_v = v > 0.0
        log_v = prng.log_xla(torch.where(ok_v, v, torch.ones_like(v)))
        accept = ok_v & (prng.log_xla(u) < 0.5 * x * x + d * (1.0 - v + log_v))
        take = accept & ~done
        sample = torch.where(take, d * v, sample)
        done = done | accept

    u_boost = prng.uniform(prng.fold_in(keys, _GAMMA_ROUNDS), (K,), 1e-37, 1.0)
    log_sample = prng.log_xla(sample) + torch.where(
        boost_needed, prng.log_xla(u_boost) / a, torch.zeros_like(a)
    )
    g = torch.exp(log_sample)
    # XLA flushes f32 subnormals to zero; so does the port
    return torch.where(g < _FLT_MIN, torch.zeros_like(g), g)


def sample_gamma_durations(keys: torch.Tensor, conc: torch.Tensor,
                           rate: torch.Tensor) -> torch.Tensor:
    """Gamma(concentration, rate) dwell times; keys (B, 2), conc/rate (B, K)."""
    return sample_gamma(keys, conc) / rate


def sample_normal(keys: torch.Tensor, shape_per_row: Sequence[int]) -> torch.Tensor:
    """Standard normals, one independent stream per row: (B, *shape)."""
    return prng.normal(keys, shape_per_row)
