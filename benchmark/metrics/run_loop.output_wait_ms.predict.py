"""Milliseconds a batch that the launching thread waits for room in the
fetch queue (the `dispatch.output_wait` spans around its put, the stage
timer `output_wait`), over the window's untraced jobs."""


def read(run):
    t, batches = run["timers"], run["batches"]
    if "output_wait" not in t or not batches:
        return None
    return 1e3 * t["output_wait"] / batches
