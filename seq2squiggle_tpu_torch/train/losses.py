"""Training losses: the port of seq2squiggle_tpu/train/losses.py (reference
get_loss, src/seq2squiggle/model.py:419-480):

total = MSE(signal) + 0.0005 * mean(-Gamma.log_prob(|durations|)) + MSE(noise)

All terms take a per-sample mask so padded rows of the final batch do not
contribute. Under data parallelism a rank holds a slab of the batch and
passes `n_valid`, the global batch's count of valid rows: each term is then
the slab's share of the global mean, and the ranks' terms (and gradients) sum
to the global batch's. `torch.lgamma` stands for `gammaln`; XLA's float32 lgamma and
torch's agree to about 5e-4 relative.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

DURATION_LOSS_SCALE = 0.0005


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, n_valid=None) -> torch.Tensor:
    """Mean over elements whose sample row is valid. x: (B, ...), mask: (B,);
    n_valid: the valid rows the mean is over, when not mask's own."""
    m = mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    per_elem = math.prod(x.shape[1:]) if x.dim() > 1 else 1
    total = (x * m).sum()
    count = (mask.sum() if n_valid is None else n_valid) * per_elem
    return total / count.clamp_min(1.0)


def gamma_log_prob(conc: torch.Tensor, rate: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """log pdf of Gamma(concentration, rate) (torch.distributions.Gamma)."""
    return (conc * torch.log(rate) + (conc - 1.0) * torch.log(x) - rate * x
            - torch.lgamma(conc))


def total_loss(
    prediction: torch.Tensor,  # (B, T, 1)
    targets: torch.Tensor,  # (B, T, 1)
    conc: torch.Tensor,  # (B, K)
    rate: torch.Tensor,  # (B, K)
    data_ls: torch.Tensor,  # (B, K) ground-truth durations (int)
    noise_std_prediction: torch.Tensor,  # (B, K)
    noise_std_target: torch.Tensor,  # (B, K), already / scaling_max_value
    sample_mask: torch.Tensor,  # (B,)
    n_valid: torch.Tensor = None,  # the global batch's valid rows (dp), or None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    signal_loss = _masked_mean((prediction - targets).square(), sample_mask, n_valid)

    # durations: abs + map zeros to 1 (model.py:465)
    x = data_ls.float().abs()
    x = x + (data_ls == 0).float()
    nll = -gamma_log_prob(conc, rate, x)
    duration_loss = _masked_mean(nll, sample_mask, n_valid) * DURATION_LOSS_SCALE

    noise_loss = _masked_mean((noise_std_target - noise_std_prediction).square(),
                              sample_mask, n_valid)

    total = signal_loss + duration_loss + noise_loss
    return total, {
        "signal_loss": signal_loss,
        "duration_loss": duration_loss,
        "noise_loss": noise_loss,
        "total_loss": total,
    }
