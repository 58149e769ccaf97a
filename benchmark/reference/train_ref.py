"""seq2squiggle's training step in plain PyTorch.

The loss of the published model (its get_loss): the mean squared error of
the decoded signal against the target frames, plus 0.0005 times the mean
negative Gamma log-likelihood of the true dwell times (a dwell of 0 counted
as 1) under the duration head's concentration and rate, plus the mean
squared error of the noise head against the per-k-mer stdevs; each mean over
the batch's valid rows. The heads read the embedding detached from the
encoder. The decoder's frames are the encoder's rows repeated by the true
dwell times, up to T.

Dropout (rate 0.2 everywhere) draws its masks from the step's threefry key
as the program does: key = fold_in(run key, step), split four ways into the
encoder's, the noise head's, the duration heads' (split again, for the
concentration and the rate) and the decoder's; block i of a stack takes
split(fold_in(stack key, i)) for the masks after attention and after the
FFN; a mask keeps where uniform < 0.8.

The optimizer is optax's chain as the configuration states it: gradients
clipped to a global norm of 1 (scaled by 1 / norm where the norm is 1 or
more), Adam (0.9, 0.999, eps 1e-7 outside the square root) with bias
correction, and the learning rate of `warmup_cosine` (linear from 0 over
the first 1 % of the steps, cosine decay after), the first step at rate 0.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import threefry as tf
from .model import F32, Params, Precision, decode, embed, encode, head


def _stack_masks(k: torch.Tensor, n: int, shape, keep: float):
    out = []
    for i in range(n):
        ka, kf = tf.split(tf.fold_in(k, i)).unbind(-2)
        out.append((tf.bernoulli(ka, keep, shape), tf.bernoulli(kf, keep, shape)))
    return out


def loss(P: Params, batch: Dict[str, torch.Tensor], mask: torch.Tensor, cfg: dict,
         key: torch.Tensor, q: Precision = F32, signal_weight: float = 1.0) -> torch.Tensor:
    x = batch["chunks"]
    B, K = x.shape[:2]
    T, D = int(cfg["max_signal_len"]), int(cfg["dmodel"])
    x = q(x.reshape(B, K, -1).float())
    rate = float(cfg["encoder_dropout"])
    keep = 1.0 - rate
    k_enc, k_noise, k_dur, k_dec = tf.split(key, 4).unbind(-2)
    emb = embed(P, x, cfg, q)
    enc = encode(P, emb, cfg, q, _stack_masks(k_enc, int(cfg["encoder_layers"]), (B, K, D), keep),
                 rate)
    e = emb.detach()
    hrate = float(cfg["duration_dropout"])
    hkeep = 1.0 - hrate
    noise_pred = head(P, "noise_sampler", e, tf.bernoulli(k_noise, hkeep, (B, K, D)), hrate)
    k_conc, k_rate = tf.split(k_dur).unbind(-2)
    conc = head(P, "duration_sampler/conc", e, tf.bernoulli(k_conc, hkeep, (B, K, D)),
                hrate).clamp_min(1e-8)
    drate = head(P, "duration_sampler/rate", e, tf.bernoulli(k_rate, hkeep, (B, K, D)),
                 hrate).clamp_min(1e-8)

    dur = batch["chunks_lengths"].long()
    ends = torch.cumsum(dur, 1)
    t = torch.arange(T, device=x.device)
    seg = (ends[:, None, :] <= t[None, :, None]).sum(-1)
    frames = torch.cat([enc, torch.zeros_like(enc[:, :1])], 1)
    frames = torch.gather(frames, 1, seg[..., None].expand(-1, -1, D))
    drop = float(cfg["decoder_dropout"])
    pred = decode(P, frames, cfg, q,
                  _stack_masks(k_dec, int(cfg["decoder_layers"]), (B, T, D), 1.0 - drop), drop)

    n = mask.sum().clamp_min(1.0)
    sig = (((pred - batch["targets"][..., 0]) ** 2).mean(1) * mask).sum() / n
    xd = dur.float().abs() + (dur == 0).float()
    nll = -(conc * torch.log(drate) + (conc - 1.0) * torch.log(xd) - drate * xd
            - torch.lgamma(conc))
    dl = (nll.mean(1) * mask).sum() / n * 0.0005
    nl = (((batch["stdevs"] - noise_pred) ** 2).mean(1) * mask).sum() / n
    return signal_weight * sig + dl + nl


def lr_at(cfg: dict, total_steps: int, count: int) -> float:
    lr = float(cfg["lr"])
    warm = int(total_steps * float(cfg["warmup_ratio"]))
    total = max(total_steps, warm + 1)
    if count < warm:
        return lr * count / warm
    c = min(count - warm, total - warm)
    return lr * 0.5 * (1 + math.cos(math.pi * c / (total - warm)))


class Adam:
    def __init__(self, P: Params, cfg: dict, total_steps: int):
        self.cfg, self.total = cfg, total_steps
        self.mu = {k: torch.zeros_like(v) for k, v in P.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in P.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, P: Params, grads: Params) -> Params:
        """Updates P in place; returns the clipped gradients."""
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
        clip = float(self.cfg["gradient_clip_val"])
        scale = clip / norm if norm >= clip else 1.0
        g = {k: v * scale for k, v in grads.items()}
        lr = lr_at(self.cfg, self.total, self.count)
        self.count += 1
        for k in P:
            self.mu[k].mul_(0.9).add_(g[k], alpha=0.1)
            self.nu[k].mul_(0.999).add_(g[k] * g[k], alpha=0.001)
            mh = self.mu[k] / (1 - 0.9 ** self.count)
            nh = self.nu[k] / (1 - 0.999 ** self.count)
            P[k].sub_(lr * mh / (nh.sqrt() + 1e-7))
        return g


FAULTS = ("half_batch", "altered_loss")


def run_steps(P0: Params, batches: List, cfg: dict, total_steps: int, base_key: torch.Tensor,
              first_step: int = 0, q: Precision = F32, fault: str = ""):
    """Steps from P0 over (batch, mask) pairs. Returns (losses, the first
    step's clipped gradients, the parameters after the last step).
    `fault` plants a fault in the steps: "half_batch" drops the second half
    of each batch, the mean taken over the rest; "altered_loss" takes the
    signal term 10 % high."""
    if fault and fault not in FAULTS:
        raise ValueError(fault)
    P = {k: v.detach().clone().float() for k, v in P0.items()}
    opt = Adam(P, cfg, total_steps)
    losses, g0 = [], None
    for i, (batch, mask) in enumerate(batches):
        if fault == "half_batch":
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = 0.0
        leaves = {k: v.requires_grad_(True) for k, v in P.items()}
        value = loss(leaves, batch, mask, cfg, tf.fold_in(base_key, first_step + i), q,
                     1.1 if fault == "altered_loss" else 1.0)
        grads = torch.autograd.grad(value, list(leaves.values()))
        for v in P.values():
            v.requires_grad_(False)
        g = opt.step(P, dict(zip(leaves.keys(), grads)))
        losses.append(float(value.detach()))
        if g0 is None:
            g0 = {k: v.clone() for k, v in g.items()}
    return losses, g0, P
