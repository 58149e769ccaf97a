"""The whole-block training kernels' share of their bound: each of the
decoder's blocks runs a forward and a backward a step at (batch, T, d); the
backward's bound counts twice the forward's operations and bytes (the
input's and the weights' gradients). Time is the device time of the
kernels named below, which only these calls launch on the `block` rung."""

import re

from benchmark.harness.counts import block_bound_s

KERNELS = ("round_weights_kernel", "block_train_fwd_mma_kernel", "block_train_fwd_kernel",
           "bwd_rows_mma_kernel", "bwd_rows_kernel", "attn_core_bwd_mma_kernel",
           "bwd_input_mma_kernel", "bwd_input_kernel", "wgrad_mma_kernel", "wgrad_kernel",
           "reduce_partials_kernel")
_NAMED = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")


def read(run):
    tr, cfg = run["trace"], run["config"]
    if not tr or not tr.get("steps"):
        return None
    seconds = sum(v for k, v in tr["kernel_s"].items() if _NAMED.search(k))
    if seconds <= 0:
        return None
    rows, T = int(run["traffic"]["batch"]), int(cfg["max_signal_len"])
    d, dff = int(cfg["dmodel"]), int(cfg["dff"])
    per_step = int(cfg["decoder_layers"]) * (block_bound_s(rows, T, d, dff)
                                             + block_bound_s(rows, T, d, dff, passes=2))
    return 100.0 * per_step * tr["steps"] / seconds
