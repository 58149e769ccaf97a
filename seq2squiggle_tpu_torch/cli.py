"""Command line of the port: `python -m seq2squiggle_tpu_torch predict ...`.

The flags are the JAX package's (`_SharedParams` and `advanced_options` come
from seq2squiggle_tpu.cli, which imports no jax), plus the hidden
`--device` (default cuda). Only `predict` is ported so far.
"""

from __future__ import annotations

import logging
import pathlib

import click

from seq2squiggle_tpu.cli import _SharedParams, advanced_options
from seq2squiggle_tpu.utils import set_seeds, setup_logging

from . import __version__
from .host import load_config

logger = logging.getLogger("seq2squiggle_tpu")


@click.group(context_settings=dict(help_option_names=["-h", "--help"]))
def main():
    """seq2squiggle-tpu on PyTorch/CUDA: nanopore signal simulation on a GPU.

    The port of the JAX package's `predict` command. On the port,
    --wire-format auto means raw int16 rows (the packed formats are not
    ported yet); POD5 output, --num-shards and --trace-dir are not ported.
    """


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


if __name__ == "__main__":
    main()
