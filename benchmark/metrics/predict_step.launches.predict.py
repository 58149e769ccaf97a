"""Kernel launches a batch, from the profiler's host runtime events
(cudaLaunchKernel and its kin) over the traced job's batches."""


def read(run):
    tr = run["trace"]
    if not tr or not tr.get("batches") or not tr["launches"]:
        return None
    return tr["launches"] / tr["batches"]
