"""Whether a predict job's output is correct: its reads against the plain
reference's.

A read's signal is its chunks' kept samples end to end. Two sound
computations differ in two ways: each sample by rounding (the program's
bfloat16 against the reference's float32, a few ADC counts), and now and
then a chunk by a sample or two where a Gamma dwell time lies so close to
the rounding boundary that the two precisions round it apart. Such a flip
shifts the rest of its chunk by a frame; the noise is drawn per frame, so
after the flip only the frames at event boundaries differ much.

So the program's read is aligned to the reference's chunk by chunk: a
dynamic program over each chunk's start offset (a drift of at most
`drift_window(n)` samples over a read of n samples, at most `MAX_STEP` per
chunk) that minimises the truncated mean gap, frame against frame, within
each chunk. The flips lean one way (the program's reads come out a little longer), so
the drift grows with the read: up to 1.7e-4 samples a sample on sound reads
of 50k samples or more, 53 samples on a read of 410k. The window therefore
grows with the read too: `DRIFT_FLOOR` samples, plus `DRIFT_RATE` of the
read's length, about twice the steepest drift that sound runs showed. A
window narrower than the drift leaves the read's tail unaligned and its
gaps those of unrelated frames.
The numbers compared are then
  - `reads_missing`: reads the reference draws that the file lacks or
    holds twice, and reads the file holds that the reference does not draw;
  - `length_gap`: the judged reads' sum of |n_program - n_reference| over
    the sum of n_reference (the longest read weighs most; a flip or two in
    a short read moves it little);
  - `gap_p99_counts`: the 99th percentile of |program - reference| in ADC
    counts over every aligned sample of the judged reads.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np

DRIFT_FLOOR = 48
DRIFT_RATE = 3e-4
MAX_STEP = 4
_CAP = 64.0  # counts: a frame's cost in the alignment is truncated here


def drift_window(n_samples: int) -> int:
    """The widest drift, in samples, that the alignment follows over a read
    of `n_samples` reference samples."""
    return DRIFT_FLOOR + math.ceil(DRIFT_RATE * n_samples)


def align(prog: np.ndarray, ref: np.ndarray, chunk_counts: Sequence[int]) -> np.ndarray:
    """|program - reference| at every aligned frame of one read (float64);
    a reference frame with no program frame against it counts `_CAP`."""
    p = prog.astype(np.float64)
    r = ref.astype(np.float64)
    counts = np.asarray(chunk_counts, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n_c, n_r = len(counts), len(r)
    max_drift = drift_window(n_r)
    shifts = np.arange(-max_drift, max_drift + 1)
    cost = np.empty((n_c, len(shifts)))
    idx = np.arange(n_r)
    for j, s in enumerate(shifts):
        src = idx + s
        ok = (src >= 0) & (src < len(p))
        gap = np.full(n_r, _CAP)
        gap[ok] = np.minimum(np.abs(p[src[ok]] - r[ok]), _CAP)
        cs = np.concatenate([[0.0], np.cumsum(gap)])
        cost[:, j] = (cs[starts + counts] - cs[starts]) / np.maximum(counts, 1)
    total = np.full_like(cost, np.inf)
    back = np.zeros(cost.shape, np.int64)
    zero = max_drift
    total[0, zero] = cost[0, zero]  # the first chunk starts where the read does
    for c in range(1, n_c):
        prev = total[c - 1]
        best = np.full(len(shifts), np.inf)
        arg = np.zeros(len(shifts), np.int64)
        for d in range(-MAX_STEP, MAX_STEP + 1):
            cand = np.full(len(shifts), np.inf)
            if d >= 0:
                cand[d:] = prev[:len(shifts) - d]
            else:
                cand[:d] = prev[-d:]
            better = cand < best
            best[better] = cand[better]
            arg[better] = (np.arange(len(shifts)) - d)[better]
        total[c] = best + cost[c]
        back[c] = arg
    path = np.empty(n_c, np.int64)
    path[-1] = int(np.argmin(total[-1]))
    for c in range(n_c - 1, 0, -1):
        path[c - 1] = back[c, path[c]]
    gaps = []
    for c in range(n_c):
        start_p = starts[c] + shifts[path[c]]
        end_p = starts[c + 1] + shifts[path[c + 1]] if c + 1 < n_c else len(p)
        lo, hi = max(start_p, 0), min(end_p, len(p))
        n = int(min(counts[c], max(hi - lo, 0)))
        r0 = starts[c] + lo - start_p
        if n > 0:
            gaps.append(np.abs(p[lo:lo + n] - r[r0:r0 + n]))
        # reference frames with no program frame against them
        gaps.append(np.full(max(int(counts[c]) - n, 0), _CAP))
    return np.concatenate(gaps) if gaps else np.zeros(0)


def judged_reads(n_reads: int, lengths: Sequence[int], seed: int, n_judged: int) -> list:
    """Indices of the reads judged: the longest, and others drawn from the seed."""
    longest = int(np.argmax(lengths))
    rng = np.random.default_rng([int(seed), 0x5EED])
    others = [int(i) for i in rng.permutation(n_reads) if int(i) != longest]
    return sorted([longest] + others[:max(n_judged - 1, 0)])


def compare(program: Dict[int, np.ndarray], reference: Dict[int, Tuple[np.ndarray, np.ndarray]],
            n_drawn: int) -> Dict[str, float]:
    """The numbers compared, from the program's reads by index, the
    reference's (signal, chunk counts) of the judged reads, and the number
    of reads the reference draws."""
    missing = len(set(range(n_drawn)) ^ set(program))
    off = total = 0
    gaps = []
    for i, (ref, chunk_counts) in reference.items():
        prog = program.get(i, np.zeros(0, np.int16))
        off += abs(len(prog) - len(ref))
        total += len(ref)
        gaps.append(align(prog, ref, chunk_counts))
    allgaps = np.concatenate(gaps) if gaps else np.zeros(1)
    return {"reads_missing": float(missing), "length_gap": off / max(total, 1),
            "gap_p99_counts": float(np.percentile(allgaps, 99)) if allgaps.size else 0.0}
