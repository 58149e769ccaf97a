"""The port's span recorder: where a run's wall time goes, stage by stage.

A span is a named interval on one thread: its start and end
(`perf_counter_ns`), the thread, the span that encloses it on that thread,
an id (a predict batch's index in its job, a training step's call count)
and, where asked, the thread's CPU time over it. The recorder keeps running
totals by name, from which `simulate_run` builds `stats["timers"]`, and a
ring of the last RING spans, which the benchmark's train-step metrics read.

    with tracing.span("decode", i, cpu=True):
        ...
    tracing.count("n_t2")

The switch is SEQ2SQUIGGLE_TPU_TIMERS, read when a run starts
(`simulate_run`, `make_train_step`), not at import. Off, `span` checks one
module-level bool and returns a shared no-op: no clock is read and nothing
is allocated. On, while a torch.profiler runs, every span also opens a
profiler range of its name with its id as the keyword argument `id` (shown
where the profiler records inputs: `record_shapes=True`, in a profile of
the calling thread alone): the program's stages then sit in the profiler's
events and its chrome trace on the device trace's clock, on every thread
the profiler records.

There is one recorder a process: every thread of a run records into it,
and readers take differences of `totals()` around what they time.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

ENV = "SEQ2SQUIGGLE_TPU_TIMERS"
RING = 65536  # spans kept: a long run's memory stays flat

_on = False
_seq = itertools.count()
_lock = threading.Lock()  # the ring, the totals and the counts
_local = threading.local()  # .top: the innermost open span of this thread
_ring: "collections.deque[Record]" = collections.deque(maxlen=RING)
_totals: Dict[str, List[int]] = {}  # name -> [spans, wall ns, CPU ns]
_counts: Dict[str, float] = {}


class Record(NamedTuple):
    """One finished span."""

    seq: int  # its place in the process's order of span starts
    name: str
    id: Optional[int]
    start_ns: int  # perf_counter_ns
    end_ns: int
    cpu_ns: Optional[int]  # the thread's CPU over the span, where asked
    thread: str
    parent: Optional[int]  # seq of the enclosing span on the same thread
    profiled: bool  # a torch.profiler was running when the span started

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def switch_from_env() -> bool:
    """Turn recording on or off from SEQ2SQUIGGLE_TPU_TIMERS (set and not
    empty: on); returns the switch."""
    global _on
    _on = bool(os.environ.get(ENV))
    return _on


def enabled() -> bool:
    return _on


def _profiler_range(name: str, id: Optional[int]):
    """torch.profiler.record_function's fast form, which takes keyword
    inputs (its `args` string is not recorded as an input)."""
    rng = torch._C._profiler._RecordFunctionFast(name, [], {} if id is None else {"id": int(id)})
    rng.__enter__()
    return rng


class _Span:
    __slots__ = ("name", "id", "cpu", "seq", "parent", "range", "t0", "c0", "seconds")

    def __init__(self, name: str, id: Optional[int], cpu: bool):
        self.name, self.id, self.cpu = name, id, cpu

    def __enter__(self):
        self.seq = next(_seq)
        self.parent = getattr(_local, "top", None)
        _local.top = self
        self.range = (_profiler_range(self.name, self.id)
                      if _autograd_profiler._is_profiler_enabled else None)
        self.t0 = time.perf_counter_ns()  # the CPU reads lie inside the wall's
        self.c0 = time.thread_time_ns() if self.cpu else 0
        return self

    def __exit__(self, *exc):
        c1 = time.thread_time_ns() if self.cpu else 0
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _local.top = self.parent
        wall, cpu = t1 - self.t0, c1 - self.c0
        self.seconds = wall * 1e-9
        rec = Record(self.seq, self.name, self.id, self.t0, t1, cpu if self.cpu else None,
                     threading.current_thread().name,
                     None if self.parent is None else self.parent.seq, self.range is not None)
        with _lock:
            _ring.append(rec)
            total = _totals.setdefault(self.name, [0, 0, 0])
            total[0] += 1
            total[1] += wall
            total[2] += cpu
        return False


class _Off:
    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, id: Optional[int] = None, cpu: bool = False):
    """A context manager that records `name` over its block (see the
    module's docstring); its `seconds` is the block's wall once it ends."""
    if not _on:
        return _OFF
    return _Span(name, id, cpu)


def count(name: str, n: float = 1) -> None:
    """Add `n` to the counter `name`."""
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


class Totals:
    """The recorder's running totals at one moment; `minus` gives what was
    recorded between two."""

    def __init__(self, spans: Dict[str, tuple], counts: Dict[str, float]):
        self.spans, self.counts = spans, counts

    def minus(self, before: "Totals") -> "Totals":
        zero = (0, 0, 0)
        spans = {k: tuple(a - b for a, b in zip(v, before.spans.get(k, zero)))
                 for k, v in self.spans.items()}
        counts = {k: v - before.counts.get(k, 0) for k, v in self.counts.items()}
        return Totals({k: v for k, v in spans.items() if v[0]},
                      {k: v for k, v in counts.items() if v})

    def wall(self, name: str) -> float:
        """Seconds inside spans of `name`, summed over them."""
        return self.spans.get(name, (0, 0, 0))[1] * 1e-9

    def cpu(self, name: str) -> float:
        """CPU seconds of their threads inside spans of `name` (asked with cpu=True)."""
        return self.spans.get(name, (0, 0, 0))[2] * 1e-9


def totals() -> Totals:
    with _lock:
        return Totals({k: tuple(v) for k, v in _totals.items()}, dict(_counts))


def records() -> List[Record]:
    """The ring's spans, oldest first."""
    with _lock:
        return list(_ring)


def reset() -> None:
    """Forget every span and count (the switch stays as it is)."""
    with _lock:
        _ring.clear()
        _totals.clear()
        _counts.clear()
