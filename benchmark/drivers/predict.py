"""Predict traffic: jobs of `simulate_run` back to back (a closed loop).

Every job is what `seq2squiggle-tpu predict` does with the traffic file's
settings: in reference mode (`input` "genome") reads drawn from a genome,
in read mode (`input` "reads") every record of a read file, cut into
chunks, simulated in fixed-size batches through the run loop's threads,
written to BLOW5. Set-up writes the genome from the seed (and, in read
mode, a FASTA of reads drawn from it), and runs one short job with the same
settings, so every shape and tier of the window is built and loaded before
it opens. The window starts jobs until `seconds` have passed and ends when
the last job started ends; in a traced run the first job that starts past
`traced_after` of it runs under the profiler. Each job has a seed of its
own, derived from the run's seed and the job's index; its output file is
deleted once counted, except that of the judged job, drawn from the seed
among the first jobs.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from ..harness import judge_predict, slow5_reader


def derived_seed(seed: int, *index: int) -> int:
    """A 31-bit seed for sub-stream `index` of the run's seed."""
    return int(np.random.SeedSequence([int(seed), *index]).generate_state(1)[0]) & 0x7FFFFFFF


def write_genome(path: str, seed: int, n_bp: int) -> None:
    rng = np.random.default_rng([int(seed), 1])
    bases = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n_bp)]
    with open(path, "wb") as fh:
        fh.write(b">synthetic\n" + bases.tobytes() + b"\n")


def write_reads(path: str, reads) -> None:
    with open(path, "w") as fh:
        fh.writelines(f">read{i}\n{r}\n" for i, r in enumerate(reads))


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic = ctx.traffic
        self.cfg = ctx.model_config
        self.work = ctx.workdir
        self.genome = os.path.join(self.work, "genome.fasta")
        self.read_mode = {"genome": False, "reads": True}[ctx.traffic.get("input", "genome")]
        self.reads_file = os.path.join(self.work, "reads.fasta")
        self.kept = None  # (job index, job seed, path, stats) of the judged job
        self.bytes_written = 0
        self.log = []  # (job, chunks, samples, wall s) of the window's jobs
        self.result_fields = {}  # put in the result line

    def _job(self, index: int, seed: int, n_reads: int, reads_file: str = ""):
        """One job over `n_reads` reads drawn from the genome, or in read
        mode over every record of `reads_file` (by default the run's)."""
        from seq2squiggle_tpu_torch.runtime.simulate import simulate_run

        t = self.traffic
        out = os.path.join(self.work, f"job{index}.blow5")
        fasta, n = (reads_file or self.reads_file, -1) if self.read_mode else (self.genome, n_reads)
        stats = simulate_run(
            config=dict(self.ctx.program_config), saved_weights=self.ctx.weights,
            fasta=fasta, read_input=self.read_mode, n=n, r=int(t["mean_read_len"]), c=-1,
            out=out, profile=self.ctx.profile["name"], dwell_mean=None, dwell_std=0.0,
            noise_std=float(t["noise_std"]), noise_sampling=bool(t["noise_sampler"]),
            duration_sampling=bool(t["duration_sampler"]), distr=t["length_distribution"],
            predict_batch_size=int(t["batch"]),
            export_every_n_samples=int(t["export_every_n_samples"]),
            min_noise=float(t["min_noise"]), min_duration=int(t["min_duration"]),
            seed=seed, show_progress=False, wire_format=str(t["wire_format"]),
            slow5_press=str(t["press"]), device=self.ctx.device)
        return out, stats

    def _drawn_reads(self, seed: int):
        from ..reference import predict_ref

        t = self.traffic
        return predict_ref.sample_reads(predict_ref.read_genome(self.genome),
                                        int(t["reads_per_job"]), int(t["mean_read_len"]), seed,
                                        distr=str(t["length_distribution"]))

    def setup(self):
        t = self.traffic
        write_genome(self.genome, self.ctx.seed, int(t["genome_bp"]))
        if self.read_mode:
            self.reads = self._drawn_reads(derived_seed(self.ctx.seed, 1 << 21))
            write_reads(self.reads_file, self.reads)
        # one short job with the window's settings builds and loads everything
        n_warm = max(4, int(t["reads_per_job"]) // 10)
        warm = os.path.join(self.work, "warmup.fasta")
        if self.read_mode:
            write_reads(warm, self.reads[:n_warm])
        out, _ = self._job(-1, derived_seed(self.ctx.seed, 1 << 20), n_warm, warm)
        os.remove(out)

    def window(self, seconds: float, trace: bool) -> Dict:
        from ..harness.trace import Traced

        t = self.traffic
        judged = int(np.random.default_rng([self.ctx.seed, 7]).integers(int(t["judged_job_choices"])))
        pending = bool(trace)  # one job is traced: the first to start past `traced_after` of the window
        samples = chunks = batches = 0
        walls, summary = [], None
        timers: Dict[str, float] = {}
        t0 = time.perf_counter()
        index = 0
        while index == 0 or time.perf_counter() - t0 < seconds or pending:
            seed = derived_seed(self.ctx.seed, index)
            tj = time.perf_counter()
            if pending and index > 0 and tj - t0 >= float(t["traced_after"]) * seconds:
                pending = False
                with Traced(self.ctx.device) as tr:
                    out, stats = self._job(index, seed, int(t["reads_per_job"]))
                summary = tr.summary
                summary["batches"] = -(-stats["chunks"] // int(t["batch"]))
                summary["chunks"] = stats["chunks"]
            else:
                out, stats = self._job(index, seed, int(t["reads_per_job"]))
                walls.append((time.perf_counter() - tj, stats["chunks"]))
                # stage timers of the untraced jobs only: the profiler slows its job
                batches += -(-stats["chunks"] // int(t["batch"]))
                for k, v in stats.get("timers", {}).items():
                    timers[k] = timers.get(k, 0.0) + float(v)
            self.log.append((index, stats["chunks"], stats["samples"], time.perf_counter() - tj))
            self.bytes_written += os.path.getsize(out)
            samples += stats["samples"]
            chunks += stats["chunks"]
            if index <= judged:
                if self.kept is not None:
                    os.remove(self.kept[2])
                self.kept = (index, seed, out, stats)
            else:
                os.remove(out)
            index += 1
        wall = time.perf_counter() - t0
        return {"wall_s": wall, "samples": samples, "chunks": chunks,
                "batches": batches, "timers": timers, "trace": summary,
                "untraced": walls, "attempted": index, "failed": 0,
                "e2e": {"predict_ksamples_per_s": samples / wall / 1e3}}

    def check(self, control: str = "") -> Dict[str, float]:
        """The judged job's reads against the reference's. Runs after the
        window, once the program's state is gone. `control` names a
        precision at which the reference is put in the program's place for
        the judged reads (model.PRECISIONS)."""
        from ..reference import model, predict_ref

        index, seed, path, stats = self.kept
        # the compression the writer used: zstd falls back to zlib where
        # python-zstandard is missing
        self.result_fields = {"blow5_record_press": slow5_reader.record_press(path)}
        program = slow5_reader.signals_by_index(path)
        file_samples = sum(len(s) for s in program.values())
        t = self.traffic
        dev = self.ctx.device
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        reads = (predict_ref.read_genome(self.reads_file) if self.read_mode
                 else self._drawn_reads(seed))
        pick = judge_predict.judged_reads(len(reads), [len(r) for r in reads], seed,
                                          int(t["judged_reads"]))
        P = model.load_weights(self.ctx.weights, dev)
        run = dict(seed=seed, noise_std=t["noise_std"], min_noise=t["min_noise"],
                   min_duration=t["min_duration"], **self.ctx.signal_settings)
        judged = {i: reads[i] for i in pick}
        ref = predict_ref.read_signals(P, self.cfg, run, judged, dev)
        if control:
            stand_in = predict_ref.read_signals(P, self.cfg, run, judged, dev,
                                                model.PRECISIONS[control])
            program.update({i: sig for i, (sig, _) in stand_in.items()})
        numbers = judge_predict.compare(program, ref, len(reads))
        numbers["samples_mismatch"] = float(abs(file_samples - int(stats["samples"])))
        return numbers
