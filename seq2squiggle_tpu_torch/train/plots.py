"""Validation plots: the port of seq2squiggle_tpu/train/plots.py (reference
generate_validation_plots / plot_signal, src/seq2squiggle/utils.py:779-926).

For the first validation batch, per-sequence PNGs comparing the reference
signal against three simulation ablations (sampled durations + noise, no
noise, ground-truth durations), with k-mer boundary markers, saved under
<log_dir>/epoch_<N>/. The arrays are computed on the device the parameters
live on, in float32 (so the blocks are the plain PyTorch ones, as the JAX
package takes XLA's there), with the JAX package's keys: the same
parameters, batch and key draw the same durations and noise.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import numpy as np
import torch

from ..models.fft_model import (
    decoder_forward,
    duration_gamma_params,
    encoder_forward,
    noise_head,
)
from ..ops.regulator import length_regulate
from ..ops.threefry import sample_gamma_durations
from ..sampling import per_chunk_keys, sample_normal

logger = logging.getLogger("seq2squiggle_tpu_torch")

_INT_TO_CHAR = "_ACGT"


def _decode_kmers(chunk_one_hot: np.ndarray) -> list:
    """(K, k, 5) one-hot -> k-mer strings (argmax decode)."""
    idx = chunk_one_hot.argmax(-1)
    blank = chunk_one_hot.sum(-1) == 0
    out = []
    for row, brow in zip(idx, blank):
        out.append(
            "".join("N" if b else _INT_TO_CHAR[i] for i, b in zip(row, brow))
        )
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@torch.no_grad()
def validation_arrays(params: dict, config: dict, batch: Dict, rng_key: torch.Tensor,
                      max_sequences: int = 12) -> Dict[str, np.ndarray]:
    """The plots' arrays for the first `max_sequences` rows of `batch`
    (numpy arrays or tensors), on the device of `params` (a key on another
    device is moved there). Returns host arrays: `chunks` (B, K, k*5),
    `targets` and the three predictions (B, T) in pA, `lengths` (B, K) and
    the sampled durations `sampled_dur` (B, K) int32."""
    device = params["decoder"]["out_linear"]["kernel"].device
    scaling = config["scaling_max_value"]
    B = min(max_sequences, batch["chunks"].shape[0])
    chunks = _host(batch["chunks"][:B])
    targets = _host(batch["targets"][:B]) * scaling
    data_ls = _host(batch["chunks_lengths"][:B])

    K = chunks.shape[1]
    data = torch.as_tensor(chunks.reshape(B, K, -1), dtype=torch.float32, device=device)
    cfg = dict(config, compute_dtype="float32")

    enc_out, emb_out = encoder_forward(params, data, cfg)
    noise_std = noise_head(params, emb_out, cfg)
    conc, rate = duration_gamma_params(params, emb_out, cfg)
    keys = per_chunk_keys(rng_key.to(device),
                          torch.arange(B, dtype=torch.int32, device=device))
    sampled_dur = torch.round(
        torch.clamp(sample_gamma_durations(keys, conc, rate), min=1.0)).to(torch.int32)

    T = config["max_signal_len"]
    # ground-truth durations (ideal-time), no noise
    exp_gt, _, _ = length_regulate(enc_out, torch.as_tensor(data_ls, device=device), T)
    pred_idealtime = _host(decoder_forward(params, exp_gt, cfg))[..., 0] * scaling
    # sampled durations, no noise (ideal-amp)
    exp_s, noise_ext, _ = length_regulate(enc_out, sampled_dur, T,
                                          x_noise=noise_std[..., None])
    pred_idealamp = _host(decoder_forward(params, exp_s, cfg))[..., 0] * scaling
    # sampled durations + sampled noise on non-zero frames
    gauss = _host(sample_normal(keys, (T,)))
    std_ext = _host(noise_ext)[..., 0] * scaling
    pred_full = pred_idealamp.copy()
    nz = pred_full != 0
    pred_full[nz] += (gauss * std_ext)[nz]
    return {"chunks": chunks, "targets": targets, "lengths": data_ls,
            "sampled_dur": _host(sampled_dur), "pred_idealtime": pred_idealtime,
            "pred_idealamp": pred_idealamp, "pred_full": pred_full}


def generate_validation_plots(
    params: dict,
    config: dict,
    batch: Dict,
    epoch: int,
    log_dir: str,
    rng_key: torch.Tensor,
    max_sequences: int = 12,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    arrays = validation_arrays(params, config, batch, rng_key, max_sequences)
    chunks, targets, data_ls = arrays["chunks"], arrays["targets"], arrays["lengths"]
    pred_idealtime, pred_idealamp = arrays["pred_idealtime"], arrays["pred_idealamp"]
    pred_full = arrays["pred_full"]

    out_dir = os.path.join(log_dir, f"epoch_{epoch}")
    os.makedirs(out_dir, exist_ok=True)

    for b in range(chunks.shape[0]):
        kmers = _decode_kmers(np.asarray(chunks[b]))
        reflens = data_ls[b]
        actual = int(reflens.sum())
        target_sig = targets[b].reshape(-1)[:actual]

        fig, ax = plt.subplots(figsize=(12, 6))
        ax.set_xlabel("Signal Points")
        ax.set_ylabel("Current (pA)")
        ax.grid(which="major", linestyle="solid")
        ax.plot(range(actual), target_sig, label="Reference Signal")
        ax.plot(range(actual), pred_idealtime[b][:actual],
                label="Simulated (no noise + no sampled duration)", color="C3")
        cum = 0
        top = max(float(target_sig.max()), 1.0)
        for kmer, rl in zip(kmers, reflens):
            ax.axvline(x=cum, color="#404040", linestyle="--", linewidth=0.8,
                       alpha=0.8)
            ax.text(cum + rl / 2, top * 0.95, kmer, ha="center", va="bottom",
                    fontsize=4, rotation=90)
            cum += rl
        ax.legend(loc="upper right", fontsize=10)
        ax.set_title(f"Reference Signal with k-mers - Batch {b}")
        ax.set_ylim(bottom=-10, top=top * 1.3)
        fig.savefig(os.path.join(out_dir, f"batch_{b}_reference.png"), dpi=200,
                    bbox_inches="tight")
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(12, 6))
        ax.set_xlabel("Signal Points")
        ax.set_ylabel("Current (pA)")
        full = targets[b].reshape(-1)
        ax.plot(range(len(full)), full, label="Reference Signal")
        ax.plot(range(len(full)), pred_full[b], label="Simulated Signal")
        ax.plot(range(len(full)), pred_idealamp[b], label="Simulated (no noise)")
        ax.plot(range(len(full)), pred_idealtime[b],
                label="Simulated (no noise + no sampled duration)")
        ax.legend(loc="upper right", fontsize=10)
        ax.set_title(f"All Signals Prediction - Batch {b}")
        fig.savefig(os.path.join(out_dir, f"batch_{b}_all_signals.png"), dpi=200,
                    bbox_inches="tight")
        plt.close(fig)
    logger.debug(f"Validation plots written to {out_dir}")
