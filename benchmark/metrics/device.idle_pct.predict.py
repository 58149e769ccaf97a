"""Share of the traced job's wall in which no kernel, copy or set ran on the
card (1 - the union of their intervals over the traced window)."""


def read(run):
    tr = run["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
