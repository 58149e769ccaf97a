"""Host milliseconds a training step in the dropout draws: the program's
`train.masks` spans inside each of the window's untraced `train.step`
spans, summed a step, averaged over those steps."""

from benchmark.harness.spans import window_steps


def read(run):
    steps = window_steps(run)
    if not steps:
        return None
    return 1e3 * sum(sum(m.seconds for m in masks) for _, masks in steps) / len(steps)
