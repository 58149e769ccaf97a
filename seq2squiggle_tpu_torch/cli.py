"""Command line of the port: `python -m seq2squiggle_tpu_torch predict|train ...`.

The flags are the JAX package's (`_SharedParams` and `advanced_options` are
the port's copies of seq2squiggle_tpu/cli.py:24 and :67), plus the hidden
`--device` (default cuda). `predict` and `train` are ported so far.
"""

from __future__ import annotations

import logging
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

    The port of the JAX package's `predict` and `train` commands. `predict`
    writes BLOW5, SLOW5 or POD5. On the port --wire-format auto means raw
    int16 rows (the packed formats are not ported yet, and a packed value is
    an error); --num-shards above 1 and --trace-dir are not ported yet and
    are errors too.
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
                     help="Write a profiler trace of the run here."),
        click.option("--wire-format", default="auto",
                     type=click.Choice(["auto", "ulp", "event", "8", "12",
                                        "raw"]),
                     show_default=True, hidden=True,
                     help="Device->host wire format. On the port auto and "
                     "raw both ship raw int16 rows; the packed tiers (ulp, "
                     "event, 8, 12) are not ported yet and are an error, so "
                     "auto does not start at the ULP tier and steps down "
                     "nowhere, as it does in the JAX package. The records "
                     "written are the same either way."),
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
              help="Torch device to run on (cuda, cuda:N or cpu). A cuda "
              "device that is not there is an error.")
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
    The port takes --wire-format auto or raw only; both ship raw int16 rows.
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

    from .device import resolve_device
    from .runtime.simulate import simulate_run

    torch_device = resolve_device(device)
    logger.info(f"Device: {torch_device}")
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
        device=torch_device,
    )
    logger.info("Prediction done.")


@main.command(cls=_SharedParams)
@click.argument("train_dir", required=True,
                type=click.Path(exists=True, dir_okay=True))
@click.argument("valid_dir", type=click.Path(exists=True, dir_okay=True),
                default=None, required=False)
@click.option("--save_valid_plots", default=False, type=bool,
              help="Save validation plots during training (not ported yet: "
              "true is an error).")
@click.option("--resume", is_flag=True, default=False, show_default=True,
              help="Resume from the train_state.npz next to the model path "
              "(restores optimizer state and epoch).")
@click.option("--tp", "tensor_parallel", type=int, default=None,
              help="Tensor-parallel degree (config key: tensor_parallel). "
              "Not ported yet: anything above 1 is an error.")
@click.option("--device", default="cuda", show_default=True, hidden=True,
              help="Torch device to run on (cuda, cuda:N or cpu). A cuda "
              "device that is not there is an error.")
def train(train_dir, valid_dir, save_valid_plots, resume, tensor_parallel, device,
          seed, model, config, verbosity):
    """Train the model with preprocessed .npy chunks.

    TRAIN_DIR must contain the .npy files from the preprocess command. The
    config's `pallas_train` picks the decoder's rung: `block` or `true`
    (hand-written whole-block kernels; what the default `auto` takes in
    bfloat16 on a GPU), `core` (hand-written attention-core kernels) or
    `false` (plain blocks).
    """
    setup_logging(verbosity)
    logger.info("seq2squiggle-tpu (PyTorch port) version %s", __version__)

    from .device import resolve_device
    from .train.loop import train_run

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


if __name__ == "__main__":
    main()
