"""The whole predict step's share of the chip's bf16 peak: the model's
forward operations of every chunk of the untraced jobs (harness/counts.py,
the same whatever computes them) over those jobs' wall times and the peak."""

from benchmark.harness.counts import PEAK_BF16_FLOPS, model_forward_flops


def read(run):
    walls = run["untraced"]
    wall = sum(w for w, _ in walls)
    chunks = sum(c for _, c in walls)
    if wall <= 0 or not chunks:
        return None
    return 100.0 * model_forward_flops(run["config"]) * chunks / (wall * PEAK_BF16_FLOPS)
