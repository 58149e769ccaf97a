"""Milliseconds a batch that the launching thread waits for the producer
(the `dispatch.input_wait` spans around its get from the h2d queue, the
stage timer `input_wait`), over the window's untraced jobs."""


def read(run):
    t, batches = run["timers"], run["batches"]
    if "input_wait" not in t or not batches:
        return None
    return 1e3 * t["input_wait"] / batches
