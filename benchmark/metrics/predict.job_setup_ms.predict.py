"""Milliseconds a job from `simulate_run`'s entry to the start of the run
loop's threads (the `job.setup` span, the stage timer `job_setup`: weights,
replicas and their synchronize, reads, writer), over the window's untraced
jobs."""


def read(run):
    t, jobs = run["timers"], len(run["untraced"])
    if "job_setup" not in t or not jobs:
        return None
    return 1e3 * t["job_setup"] / jobs
