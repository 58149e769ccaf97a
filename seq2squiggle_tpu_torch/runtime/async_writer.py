"""Background-thread writer wrapper: overlap export with device compute.

Round-1 profiling (BASELINE.md) showed BLOW5 record encoding + compression
running synchronously inside the drain loop, stalling device batches at
every flush — throughput sagged 37% between 10k- and 50k-read runs. This
wrapper moves `write_batch` (svb-zd encode, zlib/zstd compress, file write —
all GIL-releasing work in the native codec / zlib) onto one worker thread
fed by a small bounded queue, so flushes overlap the next batches' compute
and D2H transfer.

This is the TPU-build equivalent of the reference's C-threaded
`write_record_batch(threads=ncpu, batchsize=500)` (pyslow5,
src/seq2squiggle/signal_io.py:167-171).

Error contract: a failure on the worker is re-raised on the caller's next
write_batch()/close() call. The bounded queue applies back-pressure so
memory stays flat when the writer is slower than the device.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Optional

import numpy as np

from .. import tracing

logger = logging.getLogger("seq2squiggle_tpu_torch")

_SENTINEL = object()


class AsyncWriter:
    """Wrap a BLOW5/POD5 writer; write_batch() enqueues, a worker drains."""

    def __init__(self, writer, max_queued_batches: int = 8):
        self._writer = writer
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queued_batches)
        self._error: Optional[BaseException] = None
        self._writes = 0  # the id of the worker's next `write` span
        self._thread = threading.Thread(
            target=self._run, name="seq2squiggle-export", daemon=True
        )
        self._thread.start()

    @property
    def filename(self):
        return self._writer.filename

    def _run(self):
        while True:
            item = self._queue.get()
            try:
                if item is _SENTINEL:
                    return
                if self._error is None:
                    with tracing.span("write", self._writes, cpu=True):
                        if isinstance(item, tuple) and item[0] == "__flat__":
                            self._writer.write_flat(item[1], item[2], item[3])
                        else:
                            self._writer.write_batch(item)
                    self._writes += 1
            except BaseException as exc:  # re-raised on the caller thread
                self._error = exc
            finally:
                self._queue.task_done()

    def _check(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def write_batch(self, reads: Dict[str, np.ndarray]):
        self._check()
        self._queue.put(reads)

    def write_flat(self, read_ids, flat: np.ndarray, sample_off: np.ndarray):
        """Flat-layout enqueue (see writers._WriterBase.write_flat). Falls
        back to the dict form when the wrapped writer lacks a flat path."""
        self._check()
        if hasattr(self._writer, "write_flat"):
            self._queue.put(("__flat__", read_ids, flat, sample_off))
            return
        sample_off = np.asarray(sample_off)
        self._queue.put({
            rid: flat[sample_off[i]:sample_off[i + 1]]
            for i, rid in enumerate(read_ids)
        })

    def close(self):
        self._queue.put(_SENTINEL)
        self._thread.join()
        self._check()
        self._writer.close()
