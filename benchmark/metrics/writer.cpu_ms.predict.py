"""CPU milliseconds a batch of the output writer's thread (the stage timer
`writer_write_cpu`: record encoding, compression and the file writes)."""


def read(run):
    t, batches = run["timers"], run["batches"]
    if "writer_write_cpu" not in t or not batches:
        return None
    return 1e3 * t["writer_write_cpu"] / batches
