"""Profile the PyTorch port's main path (`simulate_run`, raw wire) on one GPU.

    python scripts/profile_torch_port.py [--reads 300] [--out-dir build/profile]

Runs in one process, with the committed R10 weights, the default bf16 config
and batch 1024, over a synthetic 200 kb genome made from numpy seed 7 in
reference mode (the input of chip_smoke.py's main path):

  1. a warm-up run of 30 reads (kernel build, CUDA context, allocator);
  2. unprofiled runs of --reads and of 1000 reads: wall seconds, kSamples/s;
  3. the --reads run under torch.profiler: cudaLaunchKernel and
     cudaStreamSynchronize calls, host CPU self time, device busy time (the
     union of kernel and copy intervals) against the run's wall clock, and
     the fused block kernel's launches and device time; the table goes to
     <out-dir>/profile.txt;
  4. the --reads run under cProfile (on Python 3.12 it sees the writer
     thread too): the top host functions by cumulative time go to
     <out-dir>/cprofile.txt.

Prints the card as nvidia-smi names it, one line per run, and as its last
line one JSON object with every number above.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pathlib
import pstats
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from seq2squiggle_tpu_torch.host import load_config  # noqa: E402
from seq2squiggle_tpu_torch.ops import fft_block  # noqa: E402
from seq2squiggle_tpu_torch.runtime.simulate import simulate_run  # noqa: E402

R10 = ROOT / "assets" / "bench-weights-R10.npz"
SEED = 7
BATCH = 1024


def run(fasta: pathlib.Path, out: pathlib.Path, n_reads: int) -> dict:
    return simulate_run(
        config=load_config(None), saved_weights=str(R10), fasta=str(fasta),
        read_input=False, n=n_reads, r=1000, c=-1, out=str(out),
        profile="dna-r10-prom", dwell_mean=None, dwell_std=0.0, noise_std=2.0,
        noise_sampling=True, duration_sampling=True, distr="expon",
        predict_batch_size=BATCH, export_every_n_samples=1_000_000, seed=SEED,
        show_progress=False, device=torch.device("cuda"),
    )


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_run(fasta, out, n_reads, out_dir: pathlib.Path) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stats = run(fasta, out, n_reads)
    torch.cuda.synchronize()
    avg = prof.key_averages()

    def dev_total(e) -> float:
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    calls = {e.key: e.count for e in avg}
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    block = [e for e in device if "fft_block_kernel" in e.name]
    busy_s = _union_us((e.time_range.start, e.time_range.end) for e in device) / 1e6
    sort = ("self_device_time_total" if hasattr(avg[0], "self_device_time_total")
            else "self_cuda_time_total")
    (out_dir / "profile.txt").write_text(avg.table(sort_by=sort, row_limit=40))
    return {
        "reads": stats["reads"], "chunks": stats["chunks"], "samples": stats["samples"],
        "wall_s": stats["seconds"],
        "cudaLaunchKernel": calls.get("cudaLaunchKernel", 0),
        "cudaStreamSynchronize": calls.get("cudaStreamSynchronize", 0),
        "host_cpu_self_s": sum(e.self_cpu_time_total for e in avg) / 1e6,
        "device_self_s": sum(dev_total(e) for e in avg) / 1e6,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / stats["seconds"],
        "fft_block_launches": len(block),
        "fft_block_device_s": sum(e.time_range.elapsed_us() for e in block) / 1e6,
    }


def cprofile_run(fasta, out, n_reads, out_dir: pathlib.Path) -> dict:
    prof = cProfile.Profile()
    prof.enable()
    stats = run(fasta, out, n_reads)
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(40)
    (out_dir / "cprofile.txt").write_text(text.getvalue())
    return {"wall_s": stats["seconds"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=300)
    ap.add_argument("--out-dir", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        fasta = pathlib.Path(tmp) / "genome.fasta"
        rng = np.random.default_rng(SEED)
        fasta.write_text(">synthetic\n" + "".join(rng.choice(list("ACGT"), 200_000)) + "\n")
        out = pathlib.Path(tmp) / "out.blow5"
        for name, n in (("warm", 30), ("steady", args.reads), ("steady_1000", 1000)):
            fft_block.launches = 0
            stats = run(fasta, out, n)
            stats["fft_block_launches"] = fft_block.launches
            print(name, stats, flush=True)
            result[name] = stats
        result["profiled"] = profile_run(fasta, out, args.reads, out_dir)
        print("profiled", result["profiled"], flush=True)
        result["cprofiled"] = cprofile_run(fasta, out, args.reads, out_dir)
        print("cprofiled", result["cprofiled"], flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
