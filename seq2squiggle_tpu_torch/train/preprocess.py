"""events.tsv -> training .npy chunks.

Capability parity with the reference preprocessor
(src/seq2squiggle/preprocess.py:613-645 and the helpers it calls): read an
uncalled4/f5c events.tsv, sort by read/position, drop all-N model k-mers,
split the per-event signal into 16-k-mer training chunks with <=250-sample
targets, filter atypical chunks, shuffle, and save
chunks-/targets-/chunks_lengths-/targets_lengths-/stdevs- .npy files that the
training dataloader memmaps.

The reference uses polars; this build streams the TSV with pandas'
C-engine chunked reader and vectorises the per-event "samples" CSV split
with numpy (np.char/str.split + fromstring was the reference's cost center).

Note: the reference's non-batched path crashes on a keyword typo
(preprocess.py:539, `parition_by=`); both paths work here.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import pandas as pd

logger = logging.getLogger("seq2squiggle_tpu_torch")

_REQUIRED_COLUMNS = ["read_name", "position", "model_kmer", "start_idx",
                     "end_idx", "event_stdv", "samples"]


def _one_hot_kmers(kmers: List[str], k: int) -> np.ndarray:
    """Vectorised one-hot of k-mer strings -> (N, k, 5) float16
    ('_ACGT' vocabulary; unknown characters become all-zero rows, matching
    reference utils.py:56-89)."""
    joined = "".join(kmers).encode("ascii")
    raw = np.frombuffer(joined, np.uint8).reshape(len(kmers), k)
    lut = np.full(256, 5, np.uint8)
    for i, ch in enumerate("_ACGT"):
        lut[ord(ch)] = i
    codes = lut[raw]
    out = np.zeros((len(kmers), k, 5), np.float16)
    rows, cols = np.nonzero(codes < 5)
    out[rows, cols, codes[rows, cols]] = 1
    return out


def _split_samples_column(samples: pd.Series, reverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Explode the per-event comma-separated 'samples' strings into one flat
    float32 array + per-event sample counts. For RNA, each event's samples
    are reversed (reference: preprocess.py:401-407)."""
    counts = (samples.str.count(",") + 1).to_numpy(np.int64)
    # Parse once as a single giant CSV buffer (C-speed), then reverse each
    # event's span in-place for RNA.
    joined = samples.str.cat(sep=",")
    flat = np.array(joined.split(","), dtype=np.float32)
    if reverse:
        cum = np.cumsum(counts)
        starts = cum - counts
        rev_index = np.repeat(cum - 1 + starts, counts) - np.arange(len(flat))
        flat = flat[rev_index]
    return flat, counts


def process_event_frame(
    df: pd.DataFrame, config: dict, rna: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Reference process_df (preprocess.py:372-438): sort, filter N-k-mers,
    flatten signal, pad the k-mer stream to a multiple of max_dna_len."""
    k = config["seq_kmer"]
    max_dna_len = config["max_dna_len"]

    df = df.sort_values(["position"], kind="stable")
    df = df[df["model_kmer"] != "N" * k]
    if len(df) == 0:
        raise ValueError("events table contains no usable rows")

    signal_len = (df["end_idx"].to_numpy(np.int64)
                  - df["start_idx"].to_numpy(np.int64))
    dna_seq = df["model_kmer"].tolist()
    stdevs = df["event_stdv"].to_numpy(np.float32)
    flat, counts = _split_samples_column(df["samples"].astype(str), rna)
    # The sample strings are authoritative for per-event length (the
    # reference uses end-start for `signal_len` but slices the flattened
    # samples with dna2signal indices derived from it; we use the actual
    # counts, which agree for well-formed tables).
    signal_len = counts.astype(np.int64)

    # Pad the k-mer stream to a multiple of max_dna_len
    remain = max_dna_len - (len(dna_seq) % max_dna_len)
    if remain != max_dna_len:
        dna_seq.extend(["_" * k] * remain)
        flat = np.append(flat, np.zeros(remain, np.float32))
        stdevs = np.append(stdevs, np.zeros(remain, np.float32))
        signal_len = np.append(signal_len, np.ones(remain, np.int64))
    else:
        remain = 0

    kmer_len = len(dna_seq[0])
    encoded = _one_hot_kmers(dna_seq, kmer_len)
    return encoded, flat, signal_len, stdevs, np.cumsum(signal_len)


def chunk_event_arrays(
    encoded: np.ndarray,
    flat_signal: np.ndarray,
    signal_len: np.ndarray,
    stdevs: np.ndarray,
    cum: np.ndarray,
    config: dict,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (dna_chunk, signal_chunk, len_chunk, stdev_chunk) per 16-k-mer
    block (reference get_chunks, preprocess.py:266-306)."""
    max_dna_len = config["max_dna_len"]
    n = len(encoded)
    starts = np.arange(0, n - max_dna_len + 1, max_dna_len)
    for i in starts:
        j = i + max_dna_len
        sig_a = cum[i - 1] if i > 0 else 0
        sig_b = cum[j - 1]
        yield (
            encoded[i:j],
            flat_signal[sig_a:sig_b],
            signal_len[i:j],
            stdevs[i:j],
        )


def build_chunkset(
    df: pd.DataFrame, config: dict, rna: bool, partition_by: bool,
    num_chunks: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """events frame -> padded chunk arrays dict."""
    max_signal_len = config["max_signal_len"]

    def frames():
        if partition_by:
            for _, group in df.groupby("read_name", sort=False):
                yield group
        else:
            yield df.sort_values(["read_name"], kind="stable")

    chunks, targets, c_lens, stdevs = [], [], [], []
    for frame in frames():
        arrays = process_event_frame(frame, config, rna)
        for dna, sig, lens, stds in chunk_event_arrays(*arrays, config):
            chunks.append(dna)
            targets.append(sig)
            c_lens.append(lens)
            stdevs.append(stds)
            if num_chunks is not None and len(chunks) >= num_chunks:
                break
        if num_chunks is not None and len(chunks) >= num_chunks:
            break

    logger.info(f"Total processed chunks: {len(chunks)}")
    t_lengths = np.array([len(t) for t in targets], np.int16)
    padded = np.zeros((len(targets), max_signal_len), np.float32)
    for row, t in zip(padded, targets):
        row[: min(len(t), max_signal_len)] = t[:max_signal_len]
    return {
        "chunks": np.stack(chunks).astype(np.float16),
        "targets": padded,
        "chunks_lengths": np.stack(c_lens).astype(np.int16),
        "targets_lengths": t_lengths,
        "stdevs": np.stack(stdevs).astype(np.float32),
    }


def typical_indices(t_lengths: np.ndarray, max_signal_len: int,
                    n: float = 2.5) -> np.ndarray:
    """Keep chunks with usable target lengths (reference preprocess.py:100-131)."""
    x = np.asarray(t_lengths)
    if max_signal_len <= 0:
        mu, sd = np.mean(x), np.std(x)
        (idx,) = np.where((mu - n * sd < x) & (x < mu + n * sd))
    else:
        (idx,) = np.where((0 < x) & (x <= max_signal_len))
    logger.info(
        f"Indices outside the range: {len(x) - len(idx)} out of {len(x)}"
    )
    return idx


def _filter_and_shuffle(data: Dict[str, np.ndarray], config: dict):
    idx = typical_indices(data["targets_lengths"], config["max_signal_len"])
    perm = np.random.permutation(idx)
    return {key: value[perm] for key, value in data.items()}


def save_chunkset(data: Dict[str, np.ndarray], outdir: str, counter: int):
    os.makedirs(outdir, exist_ok=True)
    for name, arr in data.items():
        path = os.path.join(outdir, f"{name}-{counter:04d}.npy")
        np.save(path, arr)
        logger.debug(f"  - {os.path.basename(path)} with shape {arr.shape}")
    logger.debug(f"> data written to: {outdir}")


def preprocess_run(
    events_path: str,
    outdir: str,
    batches: bool,
    chunksize: int,
    partition_by: bool,
    rna: bool,
    config: dict,
) -> None:
    max_chunks = config["max_dna_len"] * config["max_chunks_train"]

    if str(events_path).endswith(".gz"):
        logger.warning("Compressed events.tsv is read in streaming mode too.")

    if not batches:
        df = pd.read_csv(events_path, sep="\t", usecols=lambda c: True)
        data = build_chunkset(df, config, rna, partition_by, max_chunks)
        data = _filter_and_shuffle(data, config)
        save_chunkset(data, outdir, 0)
        return

    reader = pd.read_csv(events_path, sep="\t", chunksize=chunksize)
    for counter, df in enumerate(reader):
        logger.info(f"Processing batch {counter}")
        data = build_chunkset(df, config, rna, partition_by)
        data = _filter_and_shuffle(data, config)
        save_chunkset(data, outdir, counter)
