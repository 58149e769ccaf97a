"""The per-batch device step: the port of seq2squiggle_tpu/runtime/predict.py
for the raw int16 wire format.

  windowed base codes -> k-mers -> one-hot -> encoder -> noise head
    -> duration draw (Gamma head sample | static normal | constant)
    -> segment map + gather regulation -> decoder -> x scaling_max_value
    -> amplitude noise on non-zero frames -> clamp >= 0
    -> int16 digitisation + stable front-compaction of the kept samples

Shapes are static: (B, K + k - 1) base windows in, (B, T) int16 samples and
(B,) counts out. The packed wire tiers (2/4/8/12 bits) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import prng
from ..models.fft_model import (
    compute_dtype,
    decoder_forward,
    duration_gamma_params,
    encoder_forward,
    noise_head,
)
from ..ops.regulator import regulate_from_seg, segment_map
from ..sampling import per_chunk_keys, sample_gamma_durations, sample_normal


@dataclasses.dataclass(frozen=True)
class PredictKnobs:
    """Inference-time controls (reference CLI: --dwell-mean/std, --noise-std,
    --noise-sampler/--duration-sampler, --min_noise, --min_duration), as
    seq2squiggle_tpu.runtime.predict.PredictKnobs."""

    dwell_mean: float = 12.5
    dwell_std: float = 0.0
    noise_std: float = 2.0
    noise_sampling: bool = True
    duration_sampling: bool = True
    min_noise: float = 0.0
    min_duration: int = 3
    scaling_max_value: float = 165.0
    # digitisation (from the chemistry profile)
    digitisation: float = 2048.0
    signal_range: float = 281.345551
    offset_mean: float = -127.5655735
    # Device->host wire width; the port has the raw int16 rows (16) only.
    wire_bits: int = 16


def _compute_durations(params: dict, emb_out: torch.Tensor, keys: torch.Tensor,
                       knobs: PredictKnobs, config: dict) -> torch.Tensor:
    """Integer dwell counts per k-mer, (B, K) int32."""
    B, K = emb_out.shape[:2]
    if knobs.duration_sampling:
        conc, rate = duration_gamma_params(params, emb_out, config)
        dur = sample_gamma_durations(keys, conc, rate)
        dur = dur.clamp_min(1.0).clamp_min(float(knobs.min_duration))
    elif knobs.dwell_std > 0:
        noise = sample_normal(keys, (K,))
        dur = prng.fma(noise, prng.f32(knobs.dwell_std), prng.f32(knobs.dwell_mean))
        dur = dur.clamp_min(float(knobs.min_duration))
    else:
        dur = torch.full((B, K), knobs.dwell_mean, dtype=torch.float32,
                         device=emb_out.device)
    return torch.round(dur).to(torch.int32)  # round half to even


def _stable_front_compact(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Move each row's kept values to its front, order preserved; dropped
    values follow, also in order (a stable partition)."""
    kept_rank = torch.cumsum(keep, dim=1) - 1
    n_keep = kept_rank[:, -1:] + 1
    drop_rank = torch.cumsum(~keep, dim=1) - 1 + n_keep
    dest = torch.where(keep, kept_rank, drop_rank)
    return torch.empty_like(values).scatter_(1, dest, values)


def decoder_output(
    params: dict,
    codes: torch.Tensor,
    read_idx: torch.Tensor,
    chunk_off: torch.Tensor,
    base_key: torch.Tensor,
    n_kmers: Optional[torch.Tensor] = None,
    *,
    config: dict,
    knobs: PredictKnobs,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step up to the decoder (arguments as `predict_step`).

    Returns (dec (B, T) in the compute dtype, before the x scaling_max_value;
    the regulated noise stdev (B, T) float32; the per-chunk keys (B, 2)).
    """
    cd = compute_dtype(config)
    dev = codes.device
    if codes.ndim == 2:
        k = int(config["seq_kmer"])
        K = codes.shape[1] - k + 1
        kmers = torch.stack([codes[:, j: j + K] for j in range(k)], dim=-1)
        if n_kmers is not None:
            valid = (torch.arange(K, device=dev)[None, :]
                     < n_kmers.to(torch.int64)[:, None])
            kmers = torch.where(valid[..., None], kmers, torch.zeros_like(kmers))
        codes = kmers
    B, K, k = codes.shape
    T = int(config["max_signal_len"])
    n_chars = len(config["allowed_chars"])

    # code n_chars (unknown base) gives the all-zero row
    one_hot = (codes.long()[..., None]
               == torch.arange(n_chars, device=dev)).to(cd).reshape(B, K, k * n_chars)

    enc_out, emb_out = encoder_forward(params, one_hot, config)
    emb32 = emb_out.float()
    noise_stdev = noise_head(params, emb32, config)  # (B, K)

    chunk_keys = prng.fold_in(per_chunk_keys(base_key, read_idx), chunk_off)
    durations = _compute_durations(params, emb32, prng.fold_in(chunk_keys, 1),
                                   knobs, config)

    seg = segment_map(durations, T)[2]
    expanded, noise_ext = regulate_from_seg(enc_out, seg, x_noise=noise_stdev[..., None])

    dec = decoder_forward(params, expanded, config)[..., 0]  # (B, T)
    return dec, noise_ext[..., 0], chunk_keys


def predict_step(
    params: dict,
    codes: torch.Tensor,  # (B, K+k-1) base windows, or (B, K, k) k-mer codes
    read_idx: torch.Tensor,  # (B,) global read index (-1 = padding row)
    chunk_off: torch.Tensor,  # (B,) chunk offset within the read
    base_key: torch.Tensor,  # (2,) run key, prng.key(seed)
    n_kmers: Optional[torch.Tensor] = None,  # (B,) valid k-mers per window row
    *,
    config: dict,
    knobs: PredictKnobs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (signal_compact (B, T) int16, counts (B,) int32).

    The kept samples (non-zero after noise and clamp, on non-padding rows)
    are stably compacted to the front of each row; the host slices
    row[:count].
    """
    if knobs.wire_bits != 16:
        raise NotImplementedError(
            f"wire_bits={knobs.wire_bits}: the packed wire formats are not "
            "ported to the GPU yet (ROADMAP.md, module queue A8)")
    dec, noise_stdev, chunk_keys = decoder_output(
        params, codes, read_idx, chunk_off, base_key, n_kmers, config=config, knobs=knobs)
    pred = dec.float() * knobs.scaling_max_value

    if knobs.noise_std > 0:
        non_zero = pred != 0.0
        gauss = sample_normal(prng.fold_in(chunk_keys, 2), (pred.shape[1],))
        if knobs.noise_sampling:
            std = noise_stdev.clamp_min(knobs.min_noise)
            std = std * knobs.noise_std * knobs.scaling_max_value
        else:
            std = prng.f32(knobs.noise_std)
        pred = torch.where(non_zero, prng.fma(gauss, std, pred), pred)
    pred = pred.clamp_min(0.0)

    # round(sig * dig / range - offset), half to even, saturated to int16
    signal_raw = torch.round(
        pred * knobs.digitisation / knobs.signal_range - knobs.offset_mean
    ).clamp(-32768.0, 32767.0).to(torch.int16)

    keep = (pred != 0.0) & (read_idx[:, None] >= 0)
    counts = keep.sum(dim=1, dtype=torch.int32)
    return _stable_front_compact(signal_raw, keep), counts
