"""Host milliseconds a training step: the mean wall of the program's
`train.step` spans (each call of the step object, which launches its work
and returns) over the window's untraced steps."""

from benchmark.harness.spans import window_steps


def read(run):
    steps = window_steps(run)
    if not steps:
        return None
    return 1e3 * sum(s.seconds for s in steps) / len(steps)
