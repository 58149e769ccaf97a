"""Command line of the port: `python -m seq2squiggle_tpu_torch
predict|preprocess|train|sweep|version ...`.

The commands, flags and defaults are the JAX package's (`_SharedParams` and
`advanced_options` are the port's copies of seq2squiggle_tpu/cli.py:24 and
:67), plus the hidden `--device` (default cuda) on the commands that run the
model: `predict`, `train` and `sweep`. `--device cuda` means every visible
card for `predict` (its batches split over them) and the current card for
`train` and `sweep`; in a multi-process run (torchrun's variables or the JAX
package's JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID;
parallel/distributed.py) it is each rank's own card, and `predict` writes one
shard of the reads a rank, `train` a ('dp', 'tp') mesh over the ranks.
"""

from __future__ import annotations

import logging
import os
import pathlib

import click

from . import __version__
from .config import load_config
from .utils import set_seeds, setup_logging

logger = logging.getLogger("seq2squiggle_tpu_torch")


class _SharedParams(click.Command):
    """Options shared between most commands."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.params += [
            click.Option(
                ("-s", "--seed"),
                help="Set the seed value for reproducibility",
                type=int,
                default=0,
            ),
            click.Option(
                ("-m", "--model"),
                help="The model weights (.ckpt from the reference, .npz native, "
                "or 'random' for an untrained model).",
                type=str,
            ),
            click.Option(
                ("-y", "--config"),
                help="The YAML configuration file overriding the default options.",
            ),
            click.Option(
                ("-v", "--verbosity"),
                help="Set the verbosity of console logging messages.",
                type=click.Choice(
                    ["debug", "info", "warning", "error"], case_sensitive=False
                ),
                default="info",
            ),
        ]


@click.group(context_settings=dict(help_option_names=["-h", "--help"]))
def main():
    """seq2squiggle-tpu on PyTorch/CUDA: nanopore signal simulation on a GPU.

    The port of the JAX package's commands. `predict` writes BLOW5, SLOW5 or
    POD5; --wire-format auto starts at the ULP tier under bf16 compute and
    steps down on overflow, as in the JAX package; --num-shards and
    --trace-dir work. `preprocess` turns an events.tsv into training chunks,
    `train` and `sweep` train on them. Several devices work as in the JAX
    package: `predict` splits each batch over every visible card, and several
    processes (torchrun, or JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
    JAX_PROCESS_ID) shard `predict`'s reads (one <out>.shard<i> file a rank)
    and train data- and tensor-parallel (`train --tp`).
    """


def advanced_options(f):
    opts = [
        click.option("--noise-sampler", default=True, type=bool, show_default=True,
                     hidden=True, help="Enable or disable the noise sampler."),
        click.option("--duration-sampler", default=True, type=bool,
                     show_default=True, hidden=True,
                     help="Enable or disable the duration sampler."),
        click.option("--dwell-mean", default=None, type=float, show_default=True,
                     hidden=True,
                     help="Mean dwell time (signal points per k-mer); used only "
                     "when the duration sampler is off."),
        click.option("--dwell-std", default=0.0, type=float, show_default=True,
                     hidden=True,
                     help="Stdev of the dwell time; used only when the duration "
                     "sampler is off."),
        click.option("--noise-std", default=2.0, type=float, show_default=True,
                     hidden=True, help="Standard deviation for amplitude noise."),
        click.option("--distr", default="expon",
                     type=click.Choice(["expon", "beta", "gamma"]),
                     show_default=True, hidden=True,
                     help="Distribution for read-length sampling."),
        click.option("--predict-batch-size", default=1024, type=int,
                     show_default=True, hidden=True,
                     help="Batch size (chunks) for prediction."),
        click.option("--export-every-n-samples", default=1000000, type=int,
                     show_default=True, hidden=True,
                     help="Streaming export threshold (chunks)."),
        click.option("--sample-rate", default=None, type=int, show_default=True,
                     hidden=True, help="Override the profile sampling rate."),
        click.option("--bps", default=None, type=int, show_default=True,
                     hidden=True, help="Override the translocation speed."),
        click.option("--digitisation", default=None, type=int, show_default=True,
                     hidden=True, help="Override the digitisation."),
        click.option("--range_val", default=None, type=float, show_default=True,
                     hidden=True, help="Override the range value."),
        click.option("--offset_mean", default=None, type=float, show_default=True,
                     hidden=True, help="Override the offset mean."),
        click.option("--offset_std", default=None, type=float, show_default=True,
                     hidden=True, help="Override the offset stdev."),
        click.option("--median_before_mean", default=None, type=float,
                     show_default=True, hidden=True,
                     help="Override the median-before mean."),
        click.option("--median_before_std", default=None, type=float,
                     show_default=True, hidden=True,
                     help="Override the median-before stdev."),
        click.option("--min_noise", default=0.0, type=float, show_default=True,
                     hidden=True, help="Minimum stdev for the noise sampler."),
        click.option("--min_duration", default=3, type=int, show_default=True,
                     hidden=True, help="Minimum event duration."),
        click.option("--min_read_len", default=30, type=int, show_default=True,
                     hidden=True, help="Minimum read length in reference mode."),
        click.option("--preserve-read-ids", is_flag=True, default=False,
                     show_default=True,
                     help="Preserve input read IDs instead of indexed UUIDs."),
        click.option("--num-shards", default=1, type=int, show_default=True,
                     hidden=True,
                     help="Shard reads round-robin over this many processes; "
                     "each shard writes its own output file."),
        click.option("--shard-index", default=0, type=int, show_default=True,
                     hidden=True, help="This process's shard index."),
        click.option("--trace-dir", default=None, type=str, show_default=True,
                     hidden=True,
                     help="Write a torch.profiler trace of the run here."),
        click.option("--wire-format", default="auto",
                     type=click.Choice(["auto", "ulp", "event", "8", "12",
                                        "raw"]),
                     show_default=True, hidden=True,
                     help="Device->host wire format: auto starts at the "
                     "ULP tier (bf16 event levels + 2-bit ULP deltas; "
                     "amplitude noise is regenerated host-side from the "
                     "same per-chunk keys - deterministic, bit-identical "
                     "to raw for noise-free runs, within 1 ADC count "
                     "otherwise) and downgrades ulp -> event -> 8 -> "
                     "12-bit -> raw int16 on exception overflow; a fixed "
                     "value pins the starting tier ('8' is the narrowest "
                     "unconditionally bit-lossless one, 'raw' disables "
                     "packing)."),
        click.option("--slow5-press", default="zstd",
                     type=click.Choice(["zstd", "zlib", "none"]),
                     show_default=True,
                     help="BLOW5 record compression (signal blobs are "
                     "always svb-zd). zstd is ~4x cheaper to encode than "
                     "zlib at the same output size and is a standard "
                     "BLOW5 method readable by slow5lib/slow5tools "
                     "release builds; zlib matches the reference's "
                     "pyslow5 default byte-for-byte."),
    ]
    for opt in reversed(opts):
        f = opt(f)
    return f


@main.command(cls=_SharedParams, context_settings={"ignore_unknown_options": True})
@click.argument("fasta", required=False,
                type=click.Path(exists=False, file_okay=True, dir_okay=False,
                                path_type=pathlib.Path))
@click.option("--read-input", default=False, is_flag=True, show_default=True,
              help="Read mode: simulate signals 1:1 from basecalled reads in a "
              "FASTA/FASTQ instead of sampling from a reference genome. "
              "Combine with -n to resample.")
@click.option("-n", "--num-reads", type=int, default=-1,
              help="Desired number of generated reads.")
@click.option("-r", "--read-length", type=int, default=1000, show_default=True,
              help="Desired average read length. 0/-1 simulates whole contigs.")
@click.option("-c", "--coverage", type=int, default=-1,
              help="Desired genome coverage.")
@click.option("-o", "--out", required=False,
              type=click.Path(file_okay=True, dir_okay=False,
                              path_type=pathlib.Path),
              help="Path to the output SLOW5/BLOW5 file.")
@click.option("--profile", default="dna-r10-prom", show_default=True,
              type=click.Choice(["dna-r10-prom", "dna-r10-min", "dna-r9-prom",
                                 "dna-r9-min", "rna-004-prom", "rna-004-min"]),
              help="Chemistry profile (digitisation, sample rate, range, "
              "offset and median-before statistics).")
@click.option("--show-advanced-options", is_flag=True, default=False,
              help="Show advanced options for signal prediction.")
@click.option("--device", default="cuda", show_default=True, hidden=True,
              help="Torch device to run on: cuda (every visible card; a "
              "rank's own card in a multi-process run), cuda:N or cpu. A "
              "cuda device that is not there is an error.")
@advanced_options
@click.pass_context
def predict(ctx, fasta, read_input, num_reads, read_length, coverage, out,
            profile, show_advanced_options, device, noise_sampler,
            duration_sampler, dwell_mean, dwell_std, noise_std, distr,
            predict_batch_size, export_every_n_samples, sample_rate, bps,
            digitisation, range_val, offset_mean, offset_std,
            median_before_mean, median_before_std, min_noise, min_duration,
            min_read_len, preserve_read_ids, num_shards, shard_index,
            trace_dir, wire_format, slow5_press, seed, model, config,
            verbosity):
    """Generate sequencing signals from a genome or read FASTA file.

    FASTA must be a .fasta/.fastq file with the genome or reads to simulate.
    --wire-format auto starts at the ULP tier under bf16 compute, as in the
    JAX package; --num-shards and --trace-dir work.
    """
    if show_advanced_options:
        for param in ctx.command.params:
            param.hidden = False
        click.echo(ctx.get_help())
        ctx.exit()

    if not fasta or not out:
        logger.error("FASTA file and Output file are required for prediction.")
        ctx.exit(1)

    setup_logging(verbosity)
    logger.info("seq2squiggle-tpu (PyTorch port) version %s", __version__)

    from .device import resolve_devices
    from .parallel.distributed import maybe_init_distributed, world
    from .runtime.simulate import simulate_run

    # Multi-process: each rank simulates its round-robin shard of the reads
    # (keys from global read indices, so the shard files' union is the
    # single run's) and writes its own file, as the JAX package does.
    if maybe_init_distributed(device) and num_shards == 1:
        num_shards, shard_index = world()
        root, ext = os.path.splitext(str(out))
        out = f"{root}.shard{shard_index}{ext}"
        logger.info(f"Multi-process predict: rank {shard_index}/{num_shards} writing {out}")
    devices = resolve_devices(device)
    logger.info(f"Devices: {', '.join(map(str, devices))}")
    cfg = load_config(config)
    resolved_seed = set_seeds(seed)
    simulate_run(
        config=cfg,
        saved_weights=model,
        fasta=str(fasta),
        read_input=read_input,
        n=num_reads,
        r=read_length,
        c=coverage,
        out=out,
        profile=profile,
        dwell_mean=dwell_mean,
        dwell_std=dwell_std,
        noise_std=noise_std,
        noise_sampling=noise_sampler,
        duration_sampling=duration_sampler,
        distr=distr,
        predict_batch_size=predict_batch_size,
        export_every_n_samples=export_every_n_samples,
        sample_rate=sample_rate,
        bps=bps,
        digitisation=digitisation,
        range_val=range_val,
        offset_mean=offset_mean,
        offset_std=offset_std,
        median_before_mean=median_before_mean,
        median_before_std=median_before_std,
        min_noise=min_noise,
        min_duration=min_duration,
        min_read_len=min_read_len,
        preserve_read_ids=preserve_read_ids,
        seed=resolved_seed,
        num_shards=num_shards,
        shard_index=shard_index,
        trace_dir=trace_dir,
        wire_format=wire_format,
        slow5_press=slow5_press,
        device=devices,
    )
    logger.info("Prediction done.")


@main.command(cls=_SharedParams)
@click.argument("events_path", required=True,
                type=click.Path(exists=True, dir_okay=False))
@click.argument("outdir", required=True,
                type=click.Path(dir_okay=True, file_okay=False))
@click.option("--no_batches", is_flag=True, default=False, show_default=True,
              help="Process the events.tsv in one shot instead of batches.")
@click.option("--chunksize", type=int, show_default=True, default=10000000,
              help="Rows per batch when reading the events.tsv.")
@click.option("--partition_by", is_flag=True, show_default=True, default=False,
              help="Partition the events.tsv by read name before chunking.")
@click.option("--rna", is_flag=True, show_default=True, default=False,
              help="Process and order the events.tsv for RNA data.")
def preprocess(events_path, outdir, no_batches, chunksize, partition_by, rna,
               seed, model, config, verbosity):
    """Preprocess uncalled4/f5c events.tsv into training .npy chunks.

    EVENTS_PATH must be an events.tsv from uncalled4 or f5c.
    OUTDIR is the output directory.
    """
    setup_logging(verbosity)
    logger.info("seq2squiggle-tpu (PyTorch port) version %s", __version__)
    logger.info(f"Preprocessing events.tsv in {'RNA' if rna else 'DNA'} mode.")
    set_seeds(seed)
    cfg = load_config(config)

    from .train.preprocess import preprocess_run

    preprocess_run(
        events_path=events_path,
        outdir=outdir,
        batches=not no_batches,
        chunksize=chunksize,
        partition_by=partition_by,
        rna=rna,
        config=cfg,
    )
    logger.info("Preprocessing done.")


@main.command(cls=_SharedParams)
@click.argument("train_dir", required=True,
                type=click.Path(exists=True, dir_okay=True))
@click.argument("valid_dir", type=click.Path(exists=True, dir_okay=True),
                default=None, required=False)
@click.option("--save_valid_plots", default=True, type=bool,
              help="Save validation plots during training.")
@click.option("--resume", is_flag=True, default=False, show_default=True,
              help="Resume from the train_state.npz next to the model path "
              "(restores optimizer state and epoch).")
@click.option("--tp", "tensor_parallel", type=int, default=None,
              help="Tensor-parallel degree over the ('dp','tp') mesh of the "
              "run's processes (shards the FFN hidden dim and the attention "
              "heads; processes/tp become data-parallel). Default 1 (config "
              "key: tensor_parallel).")
@click.option("--device", default="cuda", show_default=True, hidden=True,
              help="Torch device to run on: cuda (the current card; a rank's "
              "own card in a multi-process run), cuda:N or cpu. A cuda device "
              "that is not there is an error.")
def train(train_dir, valid_dir, save_valid_plots, resume, tensor_parallel, device,
          seed, model, config, verbosity):
    """Train the model with preprocessed .npy chunks.

    TRAIN_DIR must contain the .npy files from the preprocess command. The
    config's `pallas_train` picks the decoder's rung: `block` or `true`
    (hand-written whole-block kernels; what the default `auto` takes in
    bfloat16 on a GPU), `core` (hand-written attention-core kernels) or
    `false` (plain blocks). Several processes (torchrun, or the JAX
    package's JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID)
    train over a ('dp', 'tp') mesh, tp from --tp; rank 0 writes the files.
    """
    setup_logging(verbosity)
    logger.info("seq2squiggle-tpu (PyTorch port) version %s", __version__)

    from .device import resolve_device
    from .parallel.distributed import maybe_init_distributed
    from .train.loop import train_run

    maybe_init_distributed(device)
    torch_device = resolve_device(device)
    logger.info(f"Device: {torch_device}")
    resolved_seed = set_seeds(seed)
    cfg = load_config(config)
    if tensor_parallel is not None:
        cfg["tensor_parallel"] = int(tensor_parallel)
    logger.info("Config parameters:")
    for key in cfg:
        logger.info(f" {key}: {cfg[key]}")
    train_run(
        train_dir=train_dir,
        valid_dir=valid_dir,
        config=cfg,
        model_path=model,
        save_valid_plots=save_valid_plots,
        seed=resolved_seed,
        resume=resume,
        device=torch_device,
    )
    logger.info("Training done.")


@main.command(cls=_SharedParams)
@click.option("--sweep-id", type=str, required=True,
              help="Sweep id ('user/project/id' for wandb, or a local YAML "
              "search-space file for offline sweeps).")
@click.option("--count", type=int, default=200, show_default=True,
              help="Number of sweep trials.")
@click.option("--device", default="cuda", show_default=True, hidden=True,
              help="Torch device to run on (cuda, cuda:N or cpu). A cuda "
              "device that is not there is an error.")
def sweep(sweep_id, count, device, seed, model, config, verbosity):
    """Run a hyperparameter sweep (wandb agent, or offline random search)."""
    setup_logging(verbosity)
    logger.info("seq2squiggle-tpu (PyTorch port) version %s", __version__)

    from .device import resolve_device
    from .train.sweep import sweep_run

    torch_device = resolve_device(device)
    logger.info(f"Device: {torch_device}")
    resolved_seed = set_seeds(seed)
    cfg = load_config(config)
    sweep_run(sweep_id=sweep_id, count=count, config=cfg, seed=resolved_seed,
              device=torch_device)


@main.command()
def version():
    """Get the version of seq2squiggle-tpu (PyTorch port), of torch and CUDA,
    of its core dependencies, and the CUDA devices by name. It only reports:
    no device work, and no GPU is needed."""
    setup_logging("info")
    import importlib.metadata as _md

    import torch

    logger.info(f"seq2squiggle-tpu (PyTorch port): {__version__}")
    logger.info(f"torch: {torch.__version__}")
    logger.info(f"CUDA: {torch.version.cuda or 'not built with CUDA'}")
    for dep in ("numpy", "pyarrow", "zstandard"):
        try:
            logger.info(f"{dep}: {_md.version(dep)}")
        except Exception:
            logger.info(f"{dep}: not installed")
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        logger.info(f"devices: {names}")
    else:
        logger.info("devices: no CUDA device")


if __name__ == "__main__":
    main()
