"""Milliseconds a batch that the launching thread is off the CPU outside its
two queue waits: the `dispatch` spans' wall less their thread CPU and less
the waits' wall (the stage timer `dispatch_offcpu`): the interpreter lock
that the other threads hold, and driver calls that block. Over the window's
untraced jobs."""


def read(run):
    t, batches = run["timers"], run["batches"]
    if "dispatch_offcpu" not in t or not batches:
        return None
    return 1e3 * t["dispatch_offcpu"] / batches
