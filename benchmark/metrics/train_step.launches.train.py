"""Launches a training step, from the profiler's host runtime events over
the traced steps: of kernels (cudaLaunchKernel and its kin) and of CUDA
graphs (cudaGraphLaunch: a replayed step is one)."""


def read(run):
    tr = run["trace"]
    if not tr or not tr.get("steps") or not tr["launches"]:
        return None
    return tr["launches"] / tr["steps"]
