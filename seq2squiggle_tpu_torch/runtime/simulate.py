"""The `predict` pipeline: the port of seq2squiggle_tpu/runtime/simulate.py.

Reads stream from the host modules (io.reads.get_reads, batcher.iter_batches)
into fixed-size chunk batches; each batch goes to the device through pinned
host memory, runs `predict_step` at the run's wire tier, and comes back as one
framed uint8 buffer (runtime/predict.wire_layout) in one pinned copy;
runtime/wire.py decodes it (the event tiers regenerate the amplitude noise on
the host), StreamingExporter assembles reads and the AsyncWriter thread
encodes and writes BLOW5/SLOW5 records.

The run is the JAX package's pipeline of host threads, on a card and on the
CPU alike: `seq2squiggle-h2d` prepares batches, pins them and copies them to
the device on a stream of its own (an event marks each copy); the calling
thread reads the tier once a batch, launches the step (waiting on that event)
and starts the copy back into pinned memory; `seq2squiggle-fetch` waits for
the copy; `seq2squiggle-decode` decodes, probes, recomputes raw, steps down
and exports, the only thread that touches the exporter and the decoders;
`seq2squiggle-export` (the AsyncWriter) writes. Queues of H2D_DEPTH and
PIPELINE_DEPTH batches join them. The first failure of any stage stops
them all and is raised once every thread has been joined.

Wire tiers, as the JAX package picks them: `auto` and `ulp` start at the
2-bit ULP event tier under bf16 compute with T <= 255, `event` (and `auto`
elsewhere) at the 4-bit event tier where T is even and <= 255, then 8-bit
deltas; `8`, `12` and `raw` pin their tier. A batch that overflows its
tier's budget is recomputed raw, and after four such batches the run steps
down 2 -> 4 -> 8 -> 12 -> 16; the first ULP batch also checks its escape
budgets. This ladder is about data a format cannot hold, not about a kernel
that fails: a kernel that fails raises.

Every output format (BLOW5, SLOW5, POD5), profile (R10, R9, RNA) and read
mode (reads, reference with -n or -c, whole contigs) of the JAX package runs
through this loop, as do --num-shards / --shard-index (round-robin reads, one
output file a shard), --trace-dir (a torch.profiler trace) and the stages'
spans (SEQ2SQUIGGLE_TPU_TIMERS=1, tracing.py: `timers` in the returned stats
is made of them; under a profiler they are named ranges on every thread).

Device-level data parallelism, as the JAX package's: with several devices
(`device` as a list, or `--device cuda` with no index: every visible card) and a batch
size that divides by their number, each batch's rows split shard-major over
them (runtime/predict.predict_step_sharded), each device with its own replica
of the parameters and its own packers, each shard launched from its own
thread (predict.ShardLaunchers); the framed rows come back in shard order,
the ULP tier's decoder takes the per-shard flat buffers (`dp_shards`), and
its first-batch probe judges the worst shard. There is no
collective, and the output is bit-identical to one device's. A batch size
that does not divide runs on the first device alone. A device may appear
more than once: several shards on one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import prng, tracing
from ..device import resolve_device, resolve_devices
from ..config import check_model_config
from ..io.reads import get_reads
from ..io.slow5 import Slow5FileWriter
from ..io.writers import BLOW5Writer, POD5Writer
from ..models.fft_model import compute_dtype, count_params, init_params, to_device
from ..models.weights import load_checkpoint
from ..profiles import get_profile, update_config_for_profile, update_profile
from ..utils import tune_host_allocator
from .async_writer import AsyncWriter
from .batcher import iter_batches
from .exporter import StreamingExporter
from .predict import (
    WIRE_ESC_NIB_PER_ROW, PredictKnobs, ShardLaunchers, launching, predict_step_sharded,
)
from .wire import EventWireDecoder, delta_native, unframe_wire, unpack_wire

logger = logging.getLogger("seq2squiggle_tpu_torch")

WIRE_FORMATS = ("auto", "ulp", "event", "8", "12", "raw")
_START_BITS = {"auto": 2, "ulp": 2, "event": 4, "8": 8, "12": 12, "raw": 16}
_NEXT_BITS = {2: 4, 4: 8, 8: 12, 12: 16}
_TIER_NAMES = {4: "the 4-bit event tier", 8: "8-bit deltas", 12: "12-bit deltas",
               16: "raw int16"}
# A batch that overflows its tier is recomputed raw; the run steps down a
# tier only once this many batches have overflowed at it (one stray row in
# millions must not widen every later batch).
_DOWNGRADE_AFTER = 4
# The JAX package's queue depths (its simulate.py:277, :535): batches prepared
# ahead of the dispatch loop, and batches between dispatch and fetch and
# between fetch and decode. The AsyncWriter holds 8 more.
H2D_DEPTH = 6
PIPELINE_DEPTH = 12
_POLL_S = 0.05  # how often a stage blocked on a queue looks for another's failure


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


def start_wire_bits(wire_format: str, config: dict) -> int:
    """The run's first wire tier (JAX simulate.py:168-193): the ULP tier
    needs bf16 compute and T <= 255, else the event tier; the event tier
    needs an even T <= 255, else 8-bit deltas."""
    if str(wire_format) not in WIRE_FORMATS:
        raise ValueError(f"--wire-format must be one of {', '.join(WIRE_FORMATS)}")
    bits = _START_BITS[str(wire_format)]
    T = int(config["max_signal_len"])
    if bits == 2 and not (T <= 255 and config.get("compute_dtype") == "bfloat16"):
        logger.info("ULP wire tier needs bfloat16 compute and < 256 frames; "
                    "starting at the 4-bit event tier instead.")
        bits = 4
    if bits == 4 and not (T % 2 == 0 and T <= 255):
        logger.info("Event wire tier needs an even frame budget < 256; "
                    "starting at 8-bit deltas instead.")
        bits = 8
    return bits


def ulp_budget_short(arrs, dp_shards: int = 1) -> Optional[str]:
    """The first ULP batch's escape-budget check (JAX simulate.py:356-405):
    the name of a flat buffer with less than 8 sigma of Poisson headroom over
    this batch's use of it, or None. Each of `dp_shards` device shards packs
    its own buffers with its own caps, so the use is the worst shard's (rows
    are shard-major): an unbalanced batch can overflow one shard while the
    batch's mean looks roomy."""
    stream, _, lvl_d, _, _, esc = arrs[:6]
    B_s = stream.shape[0] // dp_shards
    byte_vals = np.arange(256, dtype=np.uint16)
    esc_lut = sum((((byte_vals >> (2 * j)) & 3) == 3).astype(np.int64) for j in range(4))

    def worst(used):  # the largest per-shard total
        return int(np.asarray(used, np.int64).reshape(dp_shards, -1).sum(axis=1).max())

    usage = [
        (worst(esc_lut[stream]), B_s * WIRE_ESC_NIB_PER_ROW, "escape"),
        # nibble 8 marks wides; unused escape slots are 0, never 8
        (worst(((esc & 0xF) == 8).astype(np.int64) + ((esc >> 4) == 8)), max(B_s // 4, 1),
         "wide-jump"),
        (worst(lvl_d == np.int8(-127)), B_s, "level-escape"),
    ]
    for n, cap, name in usage:
        if n + 8.0 * np.sqrt(n) > cap:
            return f"{n}/{cap} {name} slots"
    return None


def stage_timers(got: tracing.Totals, decoders: dict, writer) -> dict:
    """A job's `stats["timers"]` from its spans (tracing.py): seconds a job,
    a stage's wall or, where the key ends in `_cpu`, its thread's CPU;
    `n_t<bits>` counts the batches decoded at each tier."""
    timers = {
        "d2h_wait": got.wall("fetch.wait"),
        "decode": got.wall("decode"), "decode_cpu": got.cpu("decode"),
        "export": got.wall("export"), "export_cpu": got.cpu("export"),
        "dispatch": got.wall("dispatch.loop"), "dispatch_cpu": got.cpu("dispatch.loop"),
        "h2d_cpu": got.cpu("h2d.loop"),
        "finalize": got.wall("finalize"),
        # the launching thread's waits for the producer and for room in the
        # fetch queue, and its other time off the CPU in its batches (the
        # interpreter lock, driver calls that block)
        "input_wait": got.wall("dispatch.input_wait"),
        "output_wait": got.wall("dispatch.output_wait"),
        "dispatch_offcpu": (got.wall("dispatch") - got.cpu("dispatch")
                            - got.wall("dispatch.input_wait") - got.wall("dispatch.output_wait")),
        "sampling": got.wall("sampling"),
        "job_setup": got.wall("job.setup"),
    }
    timers.update(got.counts)  # n_t<bits>, decode_t<bits>
    for bits, dec in decoders.items():
        for stage, name in dec.spans.items():
            timers[f"event{bits}_{stage}"] = got.wall(name)
        timers[f"event{bits}_rebuild_cpu"] = got.cpu(dec.spans["rebuild"])
    if isinstance(writer, AsyncWriter):
        timers["writer_write"], timers["writer_write_cpu"] = got.wall("write"), got.cpu("write")
    if isinstance(getattr(getattr(writer, "_writer", writer), "_file", None), Slow5FileWriter):
        for stage in ("prep", "encode", "fwrite"):
            timers[f"slow5_{stage}_cpu"] = got.cpu(f"slow5.{stage}")
    return timers


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
    device=torch.device("cuda"),
) -> dict:
    """Run the simulation on `device`: a device or its name (see
    device.resolve_devices: `cuda` is every visible card), or a list of
    devices to shard each batch over; a CUDA device that is not there
    raises. Returns a stats dict (reads, chunks, samples, seconds,
    ksamples_per_s; wire_bits, the tier the run ended at; wire_decode, the
    packed batches the C++ and the numpy decoders decoded; dp_shards, the
    device shards of each batch; and with SEQ2SQUIGGLE_TPU_TIMERS set,
    timers)."""
    timing = tracing.switch_from_env()
    before = tracing.totals()
    with tracing.span("job.setup"):  # to the start of the run loop's threads
        if num_shards > 1 and not (0 <= shard_index < num_shards):
            raise ValueError("shard_index must be in [0, num_shards)")
        devices = ([resolve_device(d) for d in device] if isinstance(device, (list, tuple))
                   else resolve_devices(device))
        if len(devices) > 1 and predict_batch_size % len(devices):
            logger.info(f"Batch size {predict_batch_size} does not divide over {len(devices)} "
                        f"devices; predicting on {devices[0]} alone")
            devices = devices[:1]
        elif len(devices) > 1:
            logger.info(f"Data-parallel prediction over {len(devices)} devices")
        dp_shards = len(devices)
        device = devices[0]
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
        wire_bits = start_wire_bits(wire_format, config)

        writer_rng = np.random.default_rng(seed)
        writer = get_writer(out, profile_dict, ideal_mode, profile, preserve_read_ids,
                            writer_rng, slow5_press=slow5_press)

        params, ckpt_config = resolve_weights(saved_weights, config, seed, profile)
        check_model_config(ckpt_config, config)
        logger.info(f"Model parameters: {count_params(params):,}")
        replicas = {d: to_device(params, d, compute_dtype(config)) for d in dict.fromkeys(devices)}

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
            wire_bits=wire_bits,
        )
        base_keys = {d: prng.key(seed, d) for d in replicas}

        reads, total_chunks = get_reads(
            fasta, read_input, n, r, c, config, distr, seed, profile, min_read_len
        )

        # Round-robin read sharding over processes: the keys derive from GLOBAL
        # read indices, so each read's signal is the same however many shards
        # simulate the set; each shard writes its own file, numbering reads by
        # global index so that indexed UUIDs never collide when files merge.
        read_idx_start, read_idx_step = 0, 1
        if num_shards > 1:
            all_reads = reads
            reads = (item for i, item in enumerate(all_reads) if i % num_shards == shard_index)
            total_chunks //= num_shards
            read_idx_start, read_idx_step = shard_index, num_shards
            writer.read_index_start, writer.read_index_step = read_idx_start, read_idx_step

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
        T_row = int(config["max_signal_len"])
        K_row = int(config["max_dna_len"])
        if on_gpu:  # the replicas and keys, made on this thread's stream, before others read them
            for d in replicas:
                torch.cuda.synchronize(d)

    def pinned(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.pin_memory() if on_gpu else t

    def host_inputs(batch):
        return tuple(pinned(a) for a in (batch.codes, batch.read_idx, batch.chunk_off,
                                          batch.n_kmers))

    def to_host(t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=on_gpu)
        return h.copy_(t, non_blocking=True)

    launchers = ShardLaunchers(devices) if dp_shards > 1 else None

    def step(inputs, k: PredictKnobs, ready=None) -> torch.Tensor:
        codes, read_idx, chunk_off, n_kmers = inputs
        return predict_step_sharded(
            replicas, codes, read_idx, chunk_off, base_keys, n_kmers, config=config, knobs=k,
            devices=devices, launchers=launchers, ready=ready)

    # The tier of the NEXT dispatch. Each in-flight buffer carries the bits
    # of the step that made it, so a step-down never decodes a buffer with
    # another tier's layout.
    state = {"knobs": knobs, "ulp_probed": False}
    overflow_counts = dict.fromkeys(_NEXT_BITS, 0)
    decoders = {}
    decoded_by = {"native": 0, "numpy": 0}  # packed batches, by decoder

    def downgrade(exc, bits, batch):
        """Recompute one batch raw (on the decode thread's stream); step the
        run down a tier once overflows at the current one recur."""
        raw = to_host(step(host_inputs(batch), dataclasses.replace(knobs, wire_bits=16)))
        if on_gpu:
            torch.cuda.current_stream(device).synchronize()
        cur = state["knobs"]
        if bits == cur.wire_bits:
            overflow_counts[bits] += 1
            if overflow_counts[bits] < _DOWNGRADE_AFTER:
                logger.warning(
                    f"{exc} — recomputed this batch raw ({overflow_counts[bits]}/"
                    f"{_DOWNGRADE_AFTER} overflows before the {bits}-bit tier downgrades).")
            else:
                nxt = _NEXT_BITS[bits]
                logger.warning(f"{exc} — downgrading wire format to {_TIER_NAMES[nxt]}.")
                state["knobs"] = dataclasses.replace(cur, wire_bits=nxt)
        return unframe_wire(raw.numpy(), 16, T_row, K_row)

    def decode(buf: np.ndarray, batch, bits: int):
        """(flat samples, counts) for the event tiers, else ((B, T) signal,
        counts)."""
        arrs = unframe_wire(buf, bits, T_row, K_row)
        if bits == 2 and not state["ulp_probed"]:
            state["ulp_probed"] = True
            short = ulp_budget_short(arrs, dp_shards)
            if short and state["knobs"].wire_bits == 2:
                logger.info(f"ULP-tier probe: batch 0's worst shard used {short} (< 8 "
                            "sigma headroom); switching to the 4-bit event tier "
                            "proactively.")
                state["knobs"] = dataclasses.replace(state["knobs"], wire_bits=4)
        try:
            if bits in (2, 4):
                if bits not in decoders:
                    decoders[bits] = EventWireDecoder(
                        dataclasses.replace(knobs, wire_bits=bits), base_keys[device], frames=T_row,
                        dp_shards=dp_shards)
                out = decoders[bits](arrs, batch.read_idx, batch.chunk_off)
                decoded_by["native" if decoders[bits].native_used else "numpy"] += 1
                return out, True
            if bits in (8, 12):
                lo, exc_pos, exc_val, n_exc, counts = arrs
                out = unpack_wire(lo, exc_pos, exc_val, n_exc, bits=bits)
                decoded_by["native" if delta_native(lo, bits) is not None else "numpy"] += 1
                return (out, counts), False
        except RuntimeError as exc:
            return downgrade(exc, bits, batch), False
        return arrs, False

    def drain(i, buf_h, batch, bits):
        with tracing.span("decode", i, cpu=True) as decoding:
            (out, counts), flat = decode(buf_h.numpy(), batch, bits)
        tracing.count(f"n_t{bits}")
        tracing.count(f"decode_t{bits}", decoding.seconds)
        with tracing.span("export", i, cpu=True):
            if flat:
                exporter.add_flat(out, counts, batch.segments)
            else:
                exporter.add_batch(out, counts, batch.segments)
        if progress is not None:
            progress.update(sum(s.n_rows for s in batch.segments))

    # The JAX package's pipeline (simulate.py:474-650): a producer thread
    # prepares batches and copies them to the device, this thread launches
    # each step and starts its copy back, a fetch thread waits for that copy
    # and a decode thread decodes and exports; the AsyncWriter's thread
    # writes. The bounded queues cap the batches in flight. A stage that
    # fails stops every stage (no put or get outlasts the failure), and
    # simulate_run raises the first failure once all have stopped.
    h2d_queue = queue.Queue(H2D_DEPTH)
    fetch_queue = queue.Queue(PIPELINE_DEPTH)
    decode_queue = queue.Queue(PIPELINE_DEPTH)
    errors = []
    failed = threading.Event()

    def put(q, item) -> bool:
        while not failed.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def get(q):
        """The next item, or None at the end or once a stage has failed."""
        while not failed.is_set():
            try:
                return q.get(timeout=_POLL_S)
            except queue.Empty:
                pass
        return None

    def items(q):
        while (item := get(q)) is not None:
            yield item

    def stage(body):
        def run():
            try:
                body()
            except BaseException as exc:  # raised again by simulate_run
                errors.append(exc)
                failed.set()
        return run

    def new_stream():
        return torch.cuda.Stream(device) if on_gpu else None

    # Every stage records its batches as spans (tracing.py), batch i of the
    # job with id i, as each stage takes the batches in order.
    def produce():
        with tracing.span("h2d.loop", cpu=True):
            copy_stream = new_stream()
            with launching(device, copy_stream):
                batches = iter_batches(reads, predict_batch_size, config["seq_kmer"],
                                       config["max_dna_len"], read_idx_start=read_idx_start,
                                       read_idx_step=read_idx_step)
                for i, batch in enumerate(batches):
                    with tracing.span("h2d", i):
                        inputs, ready = host_inputs(batch), None
                        if on_gpu:
                            inputs = tuple(t.to(device, non_blocking=True) for t in inputs)
                            ready = torch.cuda.Event()
                            ready.record(copy_stream)
                        if not put(h2d_queue, (batch, inputs, ready)):
                            return
        put(h2d_queue, None)

    def dispatch():
        """The launching thread. Its last `dispatch` span, id n after the
        job's n batches, is the wait for the end of the batches."""
        with tracing.span("dispatch.loop", cpu=True), launching(device, new_stream()):
            for i in itertools.count():
                with tracing.span("dispatch", i, cpu=True):
                    with tracing.span("dispatch.input_wait", i):
                        item = get(h2d_queue)
                    if item is None:
                        break
                    batch, inputs, ready = item
                    k = state["knobs"]
                    buf_h = to_host(step(inputs, k, ready))
                    done = None
                    if on_gpu:
                        done = torch.cuda.Event()
                        done.record()
                    with tracing.span("dispatch.output_wait", i):
                        if not put(fetch_queue, (done, buf_h, batch, k.wire_bits)):
                            return
        put(fetch_queue, None)

    def fetch():
        for i, (done, *rest) in enumerate(items(fetch_queue)):
            with tracing.span("fetch.wait", i):
                if done is not None:
                    done.synchronize()
            if not put(decode_queue, rest):
                return
        put(decode_queue, None)

    def decode_all():
        with launching(device, new_stream()):
            for i, item in enumerate(items(decode_queue)):
                drain(i, *item)

    prof = None
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu else [])
        # every thread's ops, not only this one's: the stages launch too
        prof = profile(activities=activities, experimental_config=torch._C._profiler.
                       _ExperimentalConfig(profile_all_threads=True))
        prof.start()

    t0 = time.perf_counter()
    t0_proc = time.process_time()
    threads = [threading.Thread(target=stage(body), name=name, daemon=True)
               for body, name in ((produce, "seq2squiggle-h2d"), (fetch, "seq2squiggle-fetch"),
                                  (decode_all, "seq2squiggle-decode"))]
    try:
        for thread in threads:
            thread.start()
        stage(dispatch)()
        for thread in threads:
            thread.join()
    finally:
        if launchers is not None:
            launchers.close()
        if prof is not None:
            prof.stop()
        if progress is not None:
            progress.close()
    try:
        if errors:
            raise errors[0]
        with tracing.span("finalize"):
            exporter.finalize()
    except BaseException:
        with contextlib.suppress(Exception):  # end the writer's thread; the first error wins
            writer.close()
        raise
    elapsed = time.perf_counter() - t0
    if prof is not None:
        trace = os.path.join(trace_dir, "predict.pt.trace.json")
        prof.export_chrome_trace(trace)
        logger.info(f"Profiler trace written to {trace}")

    stats = {
        "reads": exporter.total_reads,
        "chunks": exporter.total_chunks,
        "samples": exporter.total_samples,
        "seconds": elapsed,
        "ksamples_per_s": exporter.total_samples / elapsed / 1e3 if elapsed else 0.0,
        "wire_bits": state["knobs"].wire_bits,
        "wire_decode": decoded_by,
        "dp_shards": dp_shards,
    }
    if timing:
        timers = stage_timers(tracing.totals().minus(before), decoders, writer)
        timers["process_cpu"] = time.process_time() - t0_proc
        logger.warning("stage timers: " + ", ".join(
            f"{k}={v}" if isinstance(v, int) else f"{k}={v:.2f}s" for k, v in timers.items()))
        stats["timers"] = timers
    logger.info(
        f"Simulated {stats['reads']} reads / {stats['samples']:,} samples in "
        f"{elapsed:.2f}s ({stats['ksamples_per_s']:.1f} kSamples/s)"
    )
    return stats
