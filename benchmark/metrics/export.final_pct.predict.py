"""Percent of a job's samples that wait for `finalize` to reach the writer:
the counter `export.final_samples` over it and `export.behind_samples`, the
samples handed to the writer while the run loop still ran, over the
window's untraced jobs. Nothing where neither counter is recorded."""


def read(run):
    t = run["timers"]
    if "export.final_samples" not in t and "export.behind_samples" not in t:
        return None
    final = t.get("export.final_samples", 0.0)
    total = final + t.get("export.behind_samples", 0.0)
    return 100.0 * final / total if total else None
