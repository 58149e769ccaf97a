"""Device kernels a batch, from the profiler's device events over the
traced job's batches (copies and sets are not counted). Nothing where the
trace holds no device work."""


def read(run):
    tr = run["trace"]
    if not tr or not tr.get("batches") or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["batches"]
