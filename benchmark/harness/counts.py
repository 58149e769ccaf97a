"""Operations and bytes of the model's work, from shapes alone, and the
chip's peaks.

Counts are the benchmark's own, the same whatever computes the work: a
product of (m, k) by (k, n) is 2mkn operations; a kernel's bytes are its
inputs read once and its outputs written once. Peaks are NVIDIA's data
sheet for the H100 SXM (dense, no sparsity), which assume the 700 W limit.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def block_flops(rows: int, L: int, d: int, dff: int) -> float:
    """One FFT block's forward over (rows, L, d): q, k, v and the output
    projection, the two attention products, the two FFN products."""
    return rows * L * (8.0 * d * d + 4.0 * L * d + 4.0 * d * dff)


def block_bytes(rows: int, L: int, d: int, dff: int, act_bytes: int = 2) -> float:
    """An inference block kernel's activation in and out, and its weights."""
    weights = (4 * d * d + 2 * d * dff) * act_bytes + (6 * d + dff + 4 * d) * 4
    return 2.0 * rows * L * d * act_bytes + weights


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of compute and memory."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def block_bound_s(rows: int, L: int, d: int, dff: int, passes: float = 1.0) -> float:
    """Bound of a block call; `passes` = 2 for a backward (the products of
    the input and of the weight gradients), whose bytes are the forward's
    in and out and the gradient's in and out."""
    return bound_s(passes * block_flops(rows, L, d, dff), passes * block_bytes(rows, L, d, dff))


def model_forward_flops(cfg: dict) -> float:
    """The model's forward over one chunk (K k-mers, T frames): embedding and
    pre-net, the encoder's blocks at K, the three heads at K, the decoder's
    blocks at T and its output layer. The length regulator copies rows and
    counts nothing."""
    K, T = int(cfg["max_dna_len"]), int(cfg["max_signal_len"])
    d, dff = int(cfg["dmodel"]), int(cfg["dff"])
    width = len(cfg["allowed_chars"]) * int(cfg["seq_kmer"])
    emb = 2.0 * K * (width * d + int(cfg["pre_layers"]) * d * d)
    enc = int(cfg["encoder_layers"]) * block_flops(1, K, d, dff)
    heads = 3 * 2.0 * K * (d * d + d)
    dec = int(cfg["decoder_layers"]) * block_flops(1, T, d, dff) + 2.0 * T * d
    return emb + enc + heads + dec
