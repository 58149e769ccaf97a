"""The whole training step's share of the chip's bf16 peak: three times the
model's forward operations a chunk (forward and backward), times the valid
chunks of the untraced steps, over their wall time (the traced steps and
the reduction of their trace left out) and the peak."""

from benchmark.harness.counts import PEAK_BF16_FLOPS, model_forward_flops


def read(run):
    tr = run["trace"]
    chunks, wall = run["chunks"], run["wall_s"]
    if tr:
        chunks -= tr["steps"] * int(run["traffic"]["batch"])
        wall -= run["traced_wall_s"]
    if wall <= 0 or chunks <= 0:
        return None
    return 100.0 * 3.0 * model_forward_flops(run["config"]) * chunks / (wall * PEAK_BF16_FLOPS)
