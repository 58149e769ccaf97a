"""Length regulation: the port of seq2squiggle_tpu/ops/regulator.py.

Frame t copies k-mer j iff cum[j-1] <= t < cum[j] (cum[-1] := 0); frames at
or past the (T-capped) total duration fall in the tail segment K and are
zero. The JAX package contracts a (B, T, K) one-hot with an einsum; each
output frame sums exactly one term, so the gather below, which zero-fills
the tail segment, gives the same bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def segment_map(durations: torch.Tensor, max_signal_len: int):
    """durations: (B, K) integer dwell counts. Returns (ends, starts_ext, seg,
    is_start) as the JAX package's segment_map:
      ends       (B, K)   int32 cumulative event boundaries, capped at T
      starts_ext (B, K+1) int32 start frame of each segment (+1 tail entry)
      seg        (B, T)   int32 segment id per frame in [0, K] (K = tail)
      is_start   (B, T)   bool, True on each segment's first frame
    """
    B, K = durations.shape
    dev = durations.device
    ends = torch.clamp(torch.cumsum(durations.to(torch.int32), dim=1,
                                    dtype=torch.int32), max=max_signal_len)
    t = torch.arange(max_signal_len, dtype=torch.int32, device=dev)
    # seg(t) = number of boundaries <= t
    seg = torch.searchsorted(ends.contiguous(), t.expand(B, -1).contiguous(),
                             right=True).to(torch.int32)
    starts_ext = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int32, device=dev), ends], dim=1)
    is_start = torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev),
         seg[:, 1:] != seg[:, :-1]], dim=1)
    return ends, starts_ext, seg, is_start


def _gather_frames(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """out[b, t] = x[b, seg[b, t]] for seg < K, zeros in the tail segment."""
    B, K, C = x.shape
    padded = torch.cat([x, x.new_zeros((B, 1, C))], dim=1)  # row K = tail
    idx = seg.long()[..., None].expand(-1, -1, C)
    return torch.gather(padded, 1, idx)


def regulate_from_seg(
    x: torch.Tensor,
    seg: torch.Tensor,
    x_noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Expand (B, K, D) k-mer frames to (B, T, D) with a precomputed segment
    map; x_noise (B, K, C) expands alongside in float32."""
    out = _gather_frames(x, seg)
    out_noise = None
    if x_noise is not None:
        out_noise = _gather_frames(x_noise.float(), seg)
    return out, out_noise
