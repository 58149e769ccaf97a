"""The `predict` pipeline on one GPU: the port of
seq2squiggle_tpu/runtime/simulate.py for the raw int16 wire format.

Reads stream from the host modules (io.reads.get_reads, batcher.iter_batches)
into fixed-size chunk batches; each batch goes to the device through pinned
host memory, runs `predict_step`, and comes back as (B, T) int16 samples plus
per-row counts; StreamingExporter assembles reads and the AsyncWriter thread
encodes and writes BLOW5/SLOW5 records. While batch N's results copy back,
the host prepares batch N+1 and queues its step, so the device stays busy.

Every output format (BLOW5, SLOW5, POD5), profile (R10, R9, RNA) and read
mode (reads, reference with -n or -c, whole contigs) of the JAX package runs
through this loop. There is no first-batch kernel ladder: a kernel that fails
raises. Not ported yet (each raises NotImplementedError): --num-shards > 1,
--trace-dir, and the packed wire formats (--wire-format other than auto or
raw; on the port auto means raw).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import prng
from ..device import resolve_device
from ..config import check_model_config
from ..io.reads import get_reads
from ..io.writers import BLOW5Writer, POD5Writer
from ..models.fft_model import compute_dtype, count_params, init_params, to_device
from ..models.weights import load_checkpoint
from ..profiles import get_profile, update_config_for_profile, update_profile
from ..utils import tune_host_allocator
from .async_writer import AsyncWriter
from .batcher import iter_batches
from .exporter import StreamingExporter
from .predict import PredictKnobs, predict_step

logger = logging.getLogger("seq2squiggle_tpu_torch")

WIRE_FORMATS = ("auto", "raw")


def get_writer(out, profile_dict, ideal_mode, profile_name, preserve_read_ids,
               rng, slow5_press="zstd"):
    """Choose the writer by extension: BLOW5/SLOW5 or POD5, both streaming."""
    out = str(out)
    if not out.endswith((".blow5", ".slow5", ".pod5")):
        raise ValueError("Output file must have .pod5, .slow5, or .blow5 extension.")
    out_dir = os.path.dirname(out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(out):
        logger.warning(f"Output file {out} already exists. File will be deleted.")
        os.remove(out)
    if out.endswith(".pod5"):
        return POD5Writer(out, profile_dict, ideal_mode, profile_name, preserve_read_ids, rng)
    return BLOW5Writer(out, profile_dict, ideal_mode, profile_name,
                       preserve_read_ids, rng, slow5_press=slow5_press)


def resolve_weights(saved_weights: Optional[str], config: dict, seed: int,
                    profile_name: str = "dna-r10-prom"):
    """Checkpoint params, or fresh ones for --model random (the JAX package's
    init_params draws, bit for bit)."""
    if saved_weights is None:
        from ..io.weights import resolve_pretrained

        logger.info("Weights file path is not provided.")
        return load_checkpoint(resolve_pretrained(profile_name))
    if str(saved_weights) == "random":
        logger.warning("Using randomly initialised weights (--model random).")
        return init_params(config, prng.key(seed)), dict(config)
    return load_checkpoint(str(saved_weights))


def _check_supported(num_shards: int, trace_dir, wire_format: str) -> None:
    if num_shards > 1:
        raise NotImplementedError(
            "--num-shards > 1 is not ported to the GPU yet (ROADMAP.md, module "
            "queue A10)")
    if trace_dir:
        raise NotImplementedError(
            "--trace-dir is not ported to the GPU yet (ROADMAP.md, module "
            "queue A13)")
    if str(wire_format) not in WIRE_FORMATS:
        raise NotImplementedError(
            f"--wire-format {wire_format}: the packed wire formats are not "
            "ported to the GPU yet (ROADMAP.md, module queue A8); use auto or raw")


def simulate_run(
    *,
    config: dict,
    saved_weights: Optional[str],
    fasta: str,
    read_input: bool,
    n: int,
    r: int,
    c: int,
    out: str,
    profile: str,
    dwell_mean: Optional[float],
    dwell_std: float,
    noise_std: float,
    noise_sampling: bool,
    duration_sampling: bool,
    distr: str,
    predict_batch_size: int,
    export_every_n_samples: int,
    sample_rate: Optional[int] = None,
    bps: Optional[int] = None,
    digitisation: Optional[int] = None,
    range_val: Optional[float] = None,
    offset_mean: Optional[float] = None,
    offset_std: Optional[float] = None,
    median_before_mean: Optional[float] = None,
    median_before_std: Optional[float] = None,
    min_noise: float = 0.0,
    min_duration: int = 3,
    min_read_len: int = 30,
    preserve_read_ids: bool = False,
    seed: int = 42,
    show_progress: bool = True,
    num_shards: int = 1,
    shard_index: int = 0,
    trace_dir: Optional[str] = None,
    wire_format: str = "auto",
    slow5_press: str = "zstd",
    device: torch.device = torch.device("cuda"),
) -> dict:
    """Run the simulation on `device` (a CUDA device that is not there
    raises); returns a stats dict (reads, chunks, samples, seconds,
    ksamples_per_s)."""
    _check_supported(num_shards, trace_dir, wire_format)
    device = resolve_device(device)
    tune_host_allocator()
    profile_dict = update_profile(
        get_profile(profile),
        sample_rate=sample_rate, bps=bps, digitisation=digitisation,
        range=range_val, offset_mean=offset_mean, offset_std=offset_std,
        median_before_mean=median_before_mean,
        median_before_std=median_before_std,
    )
    if dwell_mean is None:
        dwell_mean = profile_dict["sample_rate"] / profile_dict["bps"]
    config = update_config_for_profile(profile, config)
    ideal_mode = not (duration_sampling or dwell_std > 0)

    writer_rng = np.random.default_rng(seed)
    writer = get_writer(out, profile_dict, ideal_mode, profile, preserve_read_ids,
                        writer_rng, slow5_press=slow5_press)

    params, ckpt_config = resolve_weights(saved_weights, config, seed, profile)
    check_model_config(ckpt_config, config)
    logger.info(f"Model parameters: {count_params(params):,}")
    params = to_device(params, device, compute_dtype(config))

    knobs = PredictKnobs(
        dwell_mean=float(dwell_mean),
        dwell_std=float(dwell_std),
        noise_std=float(noise_std),
        noise_sampling=bool(noise_sampling),
        duration_sampling=bool(duration_sampling),
        min_noise=float(min_noise),
        min_duration=int(min_duration),
        scaling_max_value=float(config["scaling_max_value"]),
        digitisation=float(profile_dict["digitisation"]),
        signal_range=float(profile_dict["range"]),
        offset_mean=float(profile_dict["offset_mean"]),
    )
    base_key = prng.key(seed, device)

    reads, total_chunks = get_reads(
        fasta, read_input, n, r, c, config, distr, seed, profile, min_read_len
    )

    if export_every_n_samples != float("inf"):
        writer = AsyncWriter(writer)
    exporter = StreamingExporter(writer, export_every_n_samples)

    progress = None
    if show_progress:
        try:
            from tqdm import tqdm

            progress = tqdm(total=total_chunks, unit="chunk", smoothing=0.05)
        except ImportError:  # pragma: no cover
            progress = None

    on_gpu = device.type == "cuda"

    def to_dev(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if on_gpu:
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def to_host(t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=on_gpu)
        return h.copy_(t, non_blocking=True)

    def drain(entry):
        done, signal_h, counts_h, segments = entry
        if done is not None:
            done.synchronize()
        exporter.add_batch(signal_h.numpy(), counts_h.numpy(), segments)
        if progress is not None:
            progress.update(sum(s.n_rows for s in segments))

    t0 = time.perf_counter()
    pending = None
    with torch.inference_mode():
        for batch in iter_batches(reads, predict_batch_size, config["seq_kmer"],
                                  config["max_dna_len"]):
            signal, counts = predict_step(
                params, to_dev(batch.codes), to_dev(batch.read_idx),
                to_dev(batch.chunk_off), base_key, to_dev(batch.n_kmers),
                config=config, knobs=knobs,
            )
            signal_h, counts_h = to_host(signal), to_host(counts)
            done = None
            if on_gpu:
                done = torch.cuda.Event()
                done.record()
            # export the previous batch while this one computes and copies
            if pending is not None:
                drain(pending)
            pending = (done, signal_h, counts_h, batch.segments)
        if pending is not None:
            drain(pending)
    exporter.finalize()
    elapsed = time.perf_counter() - t0
    if progress is not None:
        progress.close()

    stats = {
        "reads": exporter.total_reads,
        "chunks": exporter.total_chunks,
        "samples": exporter.total_samples,
        "seconds": elapsed,
        "ksamples_per_s": exporter.total_samples / elapsed / 1e3 if elapsed else 0.0,
    }
    logger.info(
        f"Simulated {stats['reads']} reads / {stats['samples']:,} samples in "
        f"{elapsed:.2f}s ({stats['ksamples_per_s']:.1f} kSamples/s)"
    )
    return stats
