"""Streaming read assembly and export.

Replaces the reference's export_and_clear_results / keep-last heuristic
(src/seq2squiggle/model.py:242-307): instead of guessing that only the most
recent dict key may be incomplete, the batcher's Segment records say exactly
when a read has produced its last chunk, so flushes always export complete
reads and never hold back more than the reads still in flight.

Samples arrive from the device already digitised (int16) and front-packed
per row (zeros stripped on device — equivalent to the reference's
`tensor[tensor.nonzero()]`), with per-row counts; per-read slices come from
the cumulative counts.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from .. import tracing
from .batcher import Segment

logger = logging.getLogger("seq2squiggle_tpu_torch")


class StreamingExporter:
    """Accumulate per-read signal pieces; flush complete reads to a writer.

    export_every_n_chunks mirrors the reference's export_every_n_samples
    (which counts chunks, model.py:247-250): the most chunks added between
    two flushes. All writers — BLOW5 and the streaming POD5 container alike
    — flush on this cadence; float('inf') remains available to defer
    everything to finalize(). A caller may also flush between them
    (simulate.py's write-behind). The samples handed to the writer go to the
    counters `export.behind_samples` (before finalize) and
    `export.final_samples` (in it), tracing.py.
    """

    def __init__(self, writer, export_every_n_chunks: float = 1_000_000):
        self.writer = writer
        self.export_every_n_chunks = export_every_n_chunks
        self._pieces: Dict[str, List[np.ndarray]] = {}
        self._order: List[str] = []
        self._ready: List[str] = []
        self._chunks_since_flush = 0
        self.total_chunks = 0
        self.total_samples = 0
        self.total_reads = 0

    def add_batch(
        self,
        signal_compact: np.ndarray,  # (B, T) int16, kept samples front-packed
        counts: np.ndarray,  # (B,) per-row kept-sample counts
        segments: List[Segment],
    ):
        T = signal_compact.shape[1]
        flat = signal_compact[np.arange(T)[None, :] < counts[:, None]]
        self.add_flat(flat, counts, segments)

    def add_flat(
        self,
        flat: np.ndarray,  # kept samples, row-major concatenated
        counts: np.ndarray,  # (B,) per-row kept-sample counts
        segments: List[Segment],
    ):
        counts = counts.astype(np.int64)
        offsets = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        for seg in segments:
            a = offsets[seg.start_row]
            b = offsets[seg.start_row + seg.n_rows]
            piece = flat[a:b]
            if seg.read_id not in self._pieces:
                self._pieces[seg.read_id] = []
                self._order.append(seg.read_id)
            self._pieces[seg.read_id].append(piece)
            if seg.read_done:
                self._ready.append(seg.read_id)
            self._chunks_since_flush += seg.n_rows
            self.total_chunks += seg.n_rows
        self.total_samples += int(flat.size)
        if self._chunks_since_flush >= self.export_every_n_chunks:
            self.flush()

    def flush(self, counter: str = "export.behind_samples"):
        """Write all complete reads, preserving stream order, and add their
        samples to `counter`."""
        self._chunks_since_flush = 0
        if not self._ready:
            return
        ready_set = set(self._ready)
        if getattr(self.writer, "write_flat", None) is not None:
            # Flat path: ONE concatenation of every ready read's pieces +
            # prefix offsets, handed to the writer as-is (the BLOW5 batch
            # encoder consumes this layout directly — no per-read arrays,
            # no dict, no second concat in the writer).
            ids: List[str] = []
            pieces: List[np.ndarray] = []
            lens: List[int] = []
            remaining_order = []
            for read_id in self._order:
                if read_id in ready_set:
                    ps = self._pieces.pop(read_id)
                    ids.append(read_id)
                    pieces.extend(ps)
                    lens.append(sum(int(p.size) for p in ps))
                else:
                    remaining_order.append(read_id)
            self._order = remaining_order
            self._ready = []
            self.total_reads += len(ids)
            flat = (np.concatenate(pieces) if pieces
                    else np.zeros(0, np.int16))
            off = np.zeros(len(ids) + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            self.writer.write_flat(ids, flat, off)
            tracing.count(counter, int(flat.size))
            logger.debug(
                f"Flushed {len(ids)} reads to {self.writer.filename}"
            )
            return
        out: Dict[str, np.ndarray] = {}
        remaining_order = []
        for read_id in self._order:
            if read_id in ready_set:
                out[read_id] = np.concatenate(self._pieces.pop(read_id))
            else:
                remaining_order.append(read_id)
        self._order = remaining_order
        self._ready = []
        self.total_reads += len(out)
        self.writer.write_batch(out)
        tracing.count(counter, sum(int(a.size) for a in out.values()))
        logger.debug(f"Flushed {len(out)} reads to {self.writer.filename}")

    def finalize(self):
        """Flush everything (any read still open is treated as complete)."""
        ready = set(self._ready)
        self._ready.extend(r for r in self._order if r not in ready)
        self.flush("export.final_samples")
        self.writer.close()
