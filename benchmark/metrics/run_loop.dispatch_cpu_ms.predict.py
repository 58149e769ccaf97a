"""CPU milliseconds a batch of the run loop's launching thread (the stage
timer `dispatch_cpu`, a thread_time), over the window's untraced jobs."""


def read(run):
    t, batches = run["timers"], run["batches"]
    if "dispatch_cpu" not in t or not batches:
        return None
    return 1e3 * t["dispatch_cpu"] / batches
