"""The fused FFT-block kernels' share of their bound on the predict path:
the least time the chip needs for the traced job's block calls (the
encoder's at K rows, the decoder's at T, the batch's rows each; bound
per call in harness/counts.py) over the device time of the kernels named
below."""

import re

from benchmark.harness.counts import block_bound_s

KERNELS = ("fft_block_mma_kernel", "fft_block_pair_mma_kernel", "fft_block_kernel",
           "fft_block_pair_kernel")
_NAMED = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")


def read(run):
    tr, cfg = run["trace"], run["config"]
    if not tr or not tr.get("batches"):
        return None
    seconds = sum(v for k, v in tr["kernel_s"].items() if _NAMED.search(k))
    if seconds <= 0:
        return None
    rows, d, dff = int(run["traffic"]["batch"]), int(cfg["dmodel"]), int(cfg["dff"])
    per_batch = (int(cfg["encoder_layers"]) * block_bound_s(rows, int(cfg["max_dna_len"]), d, dff)
                 + int(cfg["decoder_layers"]) * block_bound_s(rows, int(cfg["max_signal_len"]), d, dff))
    return 100.0 * per_batch * tr["batches"] / seconds
