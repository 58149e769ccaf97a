"""Device kernels a training step, from the profiler's device events over
the traced steps: each kernel a graph's replay ran, and any the host
launched beside it; copies and sets are not counted. Nothing where the
trace holds no device work."""


def read(run):
    tr = run["trace"]
    if not tr or not tr.get("steps") or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["steps"]
