"""Profile the PyTorch port's main paths on one GPU: `simulate_run` (raw
wire) or, with --train, the train step.

    python scripts/profile_torch_port.py [--reads 300] [--out-dir build/profile]
    python scripts/profile_torch_port.py --train [--out-dir build/profile]

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

With --train: the default config at full width (bf16, batch 512, Adam,
dropout on) on chip_smoke.py's synthetic chunks; 5 warm-up steps, then 10
steps each at `pallas_train: block` (what the default `auto` picks), `core`
and `false` timed in turns by the host clock around
torch.cuda.synchronize(), then 5 steps each at block and at core under
torch.profiler: device time by kernel group (the whole-block kernels' stages,
the attention-core kernels, matrix products, everything else), kernel
launches per step, device busy time; the block rung's kernel table goes to
<out-dir>/train_profile.txt.

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

from seq2squiggle_tpu_torch.config import load_config  # noqa: E402
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


def train_profile(out_dir: pathlib.Path) -> dict:
    import time

    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.train.loop import make_train_step
    from seq2squiggle_tpu_torch.train.optimizers import build_optimizer

    dev = torch.device("cuda")
    base = load_config(None)
    B = int(base["train_batch_size"])
    batches = []
    for i in range(4):
        batch, mask = chip_smoke._train_batch(base, B, seed=i)
        batches.append(({k: v.to(dev) for k, v in batch.items()}, mask.to(dev)))

    def make(mode):
        cfg = dict(base, pallas_train=mode)
        params = fft_model.to_train_params(fft_model.init_params(cfg, prng.key(SEED)), dev)
        opt = build_optimizer(cfg, 1000)
        state = opt.init([v for _, v in fft_model.tree_leaves(params)])
        step = make_train_step(cfg, opt)
        n = [0]

        def run(count):
            for _ in range(count):
                batch, mask = batches[n[0] % len(batches)]
                step(params, state, batch, mask, prng.fold_in(prng.key(SEED, dev), n[0]))
                n[0] += 1
            torch.cuda.synchronize()

        return run

    runs = {"block": make("auto"), "core": make("core"), "plain": make(False)}
    for run in runs.values():
        run(5)
    ms = {name: [] for name in runs}
    for name in ("plain", "core", "block", "block", "core", "plain"):
        t0 = time.perf_counter()
        runs[name](5)
        ms[name].append((time.perf_counter() - t0) / 5 * 1e3)

    # device kernels by the first fragment of their name that matches
    fragments = ["block_train_fwd", "bwd_rows", "bwd_input", "wgrad", "reduce_partials",
                 "round_weights", "attn_core_fwd", "attn_core_bwd"]
    steps = 5
    result = {"batch": B, "profiled_steps": steps,
              **{f"step_ms_{name}": times for name, times in ms.items()}}
    for name in ("block", "core"):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runs[name](steps)
        wall = time.perf_counter() - t0
        avg = prof.key_averages()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        groups = dict.fromkeys([*fragments, "gemm", "other"], 0.0)
        for e in device:
            kernel = e.name.lower()
            key = next((f for f in fragments if f in kernel), None) or (
                "gemm" if any(w in kernel for w in ("gemm", "cutlass", "cublas")) else "other")
            groups[key] += e.time_range.elapsed_us() / 1e3 / steps
        busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in device) / 1e3
        if name == "block":
            sort = ("self_device_time_total" if hasattr(avg[0], "self_device_time_total")
                    else "self_cuda_time_total")
            (out_dir / "train_profile.txt").write_text(avg.table(sort_by=sort, row_limit=40))
        calls = {e.key: e.count for e in avg}
        result[name] = {
            "profiled_wall_ms_per_step": wall / steps * 1e3,
            "device_ms_per_step_by_group": {k: v for k, v in groups.items() if v},
            "device_busy_ms_per_step": busy_ms / steps,
            "device_kernels_per_step": len(device) / steps,
            "cudaLaunchKernel_per_step": calls.get("cudaLaunchKernel", 0) / steps,
        }
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=300)
    ap.add_argument("--out-dir", default=str(ROOT / "build" / "profile"))
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the predict path")
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
    if args.train:
        result["train"] = train_profile(out_dir)
        print(json.dumps(result), flush=True)
        return 0
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
