"""Denormalize uncalled4 >=4.1 event tables back to pA.

Parity with the reference's standalone standardize-events.py
(src/seq2squiggle/standardize-events.py:5-107): given an events.tsv whose
`samples` column is z-normalised and a sigtk stats file providing pa_mean
and pa_std, rewrite samples as sample*pa_std + pa_mean, recompute
event_stdv as the stdev (ddof=1) of the denormalised samples, and drop
events longer than --filter_length samples. Streaming with pandas chunks
instead of polars lazy frames.

Runs as `python -m seq2squiggle_tpu_torch.tools.standardize_events` (the port
adds no console entry; the JAX package exposes its original as
`seq2squiggle-tpu-standardize-events`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import pandas as pd


def parse_sigtk_file(sigtk_file):
    """Extract pa_mean and pa_std from a sigtk stats file (columns 2 and 5
    of the first line, as in the reference)."""
    if not sigtk_file or not os.path.exists(sigtk_file):
        return 0.0, 0.0
    with open(sigtk_file, "r") as f:
        parts = f.readline().strip().split()
    return float(parts[2]), float(parts[5])


def _transform_chunk(df: pd.DataFrame, pa_mean: float, pa_std: float,
                     filter_length: int) -> pd.DataFrame:
    keep = (df["end_idx"].astype(np.int64) - df["start_idx"].astype(np.int64)
            ) <= filter_length
    df = df[keep].copy()
    if len(df) == 0 or not (pa_mean != 0 and pa_std != 0):
        return df

    samples = df["samples"].astype(str)
    counts = (samples.str.count(",") + 1).to_numpy(np.int64)
    flat = np.array(samples.str.cat(sep=",").split(","), dtype=np.float64)
    flat = flat * pa_std + pa_mean

    ends = np.cumsum(counts)
    starts = ends - counts
    # per-event sample stdev with ddof=1 (polars list.std default), 0 for n=1
    sums = np.add.reduceat(flat, starts)
    sqs = np.add.reduceat(flat * flat, starts)
    n = counts.astype(np.float64)
    var = np.where(n > 1, (sqs - sums * sums / n) / (n - 1), 0.0)
    stdv = np.sqrt(np.maximum(var, 0.0))

    joined = ",".join(map(repr, flat.tolist()))
    pieces = joined.split(",")
    new_samples = [
        ",".join(pieces[a:b]) for a, b in zip(starts, ends)
    ]
    df["samples"] = new_samples
    df["event_stdv"] = stdv
    return df


def standardize_and_write_chunks(input_file, output_file, chunk_size,
                                 pa_mean, pa_std, filter_length=70):
    reader = pd.read_csv(input_file, sep="\t", chunksize=chunk_size)
    first = True
    for df in reader:
        out = _transform_chunk(df, pa_mean, pa_std, filter_length)
        out.to_csv(output_file, sep="\t", index=False, header=first,
                   mode="w" if first else "a")
        first = False


def main():
    parser = argparse.ArgumentParser(
        description="Standardize the event_stdv column of a large events TSV."
    )
    parser.add_argument("input_file", type=str)
    parser.add_argument("output_file", type=str)
    parser.add_argument("--sigtk", type=str,
                        help="sigtk stats file with pa_mean and pa_std")
    parser.add_argument("--chunk_size", type=int, default=25000)
    parser.add_argument("--filter_length", type=int, default=70,
                        help="Maximal event length; longer events are dropped.")
    args = parser.parse_args()

    pa_mean, pa_std = parse_sigtk_file(args.sigtk)
    standardize_and_write_chunks(
        args.input_file, args.output_file, args.chunk_size, pa_mean, pa_std,
        args.filter_length,
    )


if __name__ == "__main__":
    main()
