"""A bounded part of a run under torch.profiler, reduced to numbers.

`Traced` profiles the CPU (every thread's operations, so the program's own
threads are seen) and the card. `reduce` turns its events into what the
per-layer metrics read: the device's busy time (the union of its kernel,
copy and set intervals), the traced window, the host's launches (of a
kernel or of a CUDA graph: a graph's replay is one launch), the kernels
the device ran (a graph's each; copies and sets are not kernels), device
time by kernel name, and the longest idle gaps of the device, each named
by the innermost host operation that was running at the gap's middle.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import torch

LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch")
NOT_KERNELS = ("Memcpy", "Memset")  # the profiler's names of the device's copies and sets


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Traced:
    """with Traced() as t: ...  then t.summary (a dict, see `reduce`)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.summary = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts, experimental_config=torch._C._profiler.
                             _ExperimentalConfig(profile_all_threads=True))
        self._prof.start()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self._t0
        self._prof.stop()
        if exc[0] is None:
            self.summary = reduce(self._prof.profiler.kineto_results.events(), window)
            self.summary["reduce_s"] = time.perf_counter() - self._t0 - window
        return False


def reduce(events, window_s: float) -> Dict:
    device, host = [], []
    launches = kernels = 0
    by_kernel: Dict[str, float] = defaultdict(float)
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s = e.start_ns() * 1e-9
            d = e.duration_ns() * 1e-9
            device.append((s, s + d))
            by_kernel[name] += d
            if not name.startswith(NOT_KERNELS):
                kernels += 1
        else:
            if name in LAUNCH_NAMES:
                launches += 1
            s = e.start_ns() * 1e-9
            host.append((s, s + e.duration_ns() * 1e-9, name))
    busy = union_seconds(device)
    gaps = []
    spans = merged(device)
    for (s0, e0), (s1, _) in zip(spans, spans[1:]):
        gaps.append((s1 - e0, e0, s1))
    gaps.sort(reverse=True)
    host.sort()
    starts = [h[0] for h in host]
    idle = []
    for length, g0, g1 in gaps[:10]:
        mid = 0.5 * (g0 + g1)
        best, last = None, None
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            hs, he, hn = host[j]
            if he >= mid and (best is None or he - hs < best[1] - best[0]):
                best = (hs, he, hn)
            if he < mid and (last is None or he > last[1]):
                last = (hs, he, hn)
            if mid - hs > 0.5:  # an operation that covers the gap began shortly before it
                break
        label = (best[2] if best else f"after {last[2]}" if last else "no host operation")
        idle.append([label, length])
    top = sorted(by_kernel.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"busy_s": busy, "window_s": window_s, "launches": launches, "kernels": kernels,
            "kernel_s": dict(by_kernel),
            "device_ops": [[short_name(k), v] for k, v in top], "idle_gaps": idle}


def short_name(kernel: str) -> str:
    """A kernel's name without its parameter list and with the innermost
    functor of an elementwise template named, at most 120 characters."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # drop the trailing (parameter list)
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    name = name[:cut]
    functors = re.findall(r"(\w+Functor\w*|\w+_kernel_cuda|direct_copy_kernel_cuda)", name)
    head = name.split("<", 1)[0]
    if functors:
        name = f"{head}<{functors[-1]}>"
    return name[:120]
