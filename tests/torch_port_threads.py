"""One share of the host's cores for torch's CPU ops in each test worker.

The port's test files import this module first. When pytest-xdist runs the
suite, several workers share the host's cores, and torch's default intra-op
pool takes every core in each of them: six workers on eight cores then run
48 spinning threads, and a test that takes 18 s alone takes minutes. Each
worker keeps `usable cores // workers` threads instead (at least one), and
sets OMP_NUM_THREADS to the same number so that the processes the tests
start (ranks, commands) inherit it. A file run without workers keeps
torch's default.
"""

import os

import torch


if "PYTEST_XDIST_WORKER" in os.environ:
    _WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    THREADS = max(1, len(os.sched_getaffinity(0)) // _WORKERS)
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
