"""Milliseconds a packed batch in the host's wire decode: the sum of the
stage timers decode_t<bits> over the sum of n_t<bits>, every tier."""


def read(run):
    t = run["timers"]
    n = sum(v for k, v in t.items() if k.startswith("n_t"))
    if not n:
        return None
    return 1e3 * sum(v for k, v in t.items() if k.startswith("decode_t")) / n
