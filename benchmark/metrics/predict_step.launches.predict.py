"""Launches a batch, from the profiler's host runtime events over the
traced job's batches: of kernels (cudaLaunchKernel and its kin) and of
CUDA graphs (cudaGraphLaunch: a replay is one)."""


def read(run):
    tr = run["trace"]
    if not tr or not tr.get("batches") or not tr["launches"]:
        return None
    return tr["launches"] / tr["batches"]
