"""Host milliseconds a batch in the samplers: the Gamma dwell draws and the
normal noise draws with their threefry (the program's `sampling` spans, the
stage timer `sampling`: the launching threads' wall in them), over the
window's untraced jobs."""


def read(run):
    t, batches = run["timers"], run["batches"]
    if "sampling" not in t or not batches:
        return None
    return 1e3 * t["sampling"] / batches
