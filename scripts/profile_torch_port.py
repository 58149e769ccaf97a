"""Profile the PyTorch port's main paths on one GPU: `simulate_run` (at the
default --wire-format auto, the ULP tier in bf16) or, with --train, the
train step.

    python scripts/profile_torch_port.py [--reads 300] [--pair] [--wire] [--shards N]
        [--out-dir build/profile]
    python scripts/profile_torch_port.py --against CHECKOUT [--rounds 3] [--shards N]
    python scripts/profile_torch_port.py --train [--out-dir build/profile]

Runs in one process, with the committed R10 weights, the default bf16 config
and batch 1024, over a synthetic 200 kb genome made from numpy seed 7 in
reference mode (the input of chip_smoke.py's main path), on cuda:0, or on
--shards N shards of cuda:0 (each batch split N ways, each shard launched
from its own thread); it prints the devices it ran on:

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

With --pair, step 2 also runs --reads with `pallas_pair: true` (the decoder's
two blocks in one launch) between two runs without it, before any profiler is
attached, and step 3 is repeated with it, so that the rates, the launch
counts, the device time of the block kernels and the device-busy share of
both settings come from one process on one card; that table goes to
<out-dir>/profile_pair.txt.

With --wire, step 2 runs --reads at --wire-format raw and at auto in turns
(raw, auto, auto, raw, raw, auto) with the stage timers on
(SEQ2SQUIGGLE_TPU_TIMERS: decode, export, d2h_wait seconds), and steps 3
and 4 are repeated at raw, so that both tiers' rates, launches per batch,
device-busy shares and host functions come from one process on one card;
those go to <out-dir>/profile_raw.txt and <out-dir>/cprofile_raw.txt.

With --against CHECKOUT (a `git archive` of another commit, unpacked): this
tree's predict run and that checkout's alternate in subprocess rounds on the
same input (this, other; other, this; ...), each round a fresh process per
tree with a 30-read warm-up and then --reads at auto and at raw (in turns),
the stage timers on; the first round also profiles one auto run of each
tree. Reported per tree and tier: kSamples/s of every round, their median
and spread (max - min), the device idle share and cudaLaunchKernel calls a
batch (the profiled run), and CPU seconds a batch by thread: the stage
timers' *_cpu (the producer's h2d_cpu, the dispatch loop's dispatch_cpu,
the decode thread's decode_cpu + export_cpu, the writer's), the shard
threads' (around each predict_step), and the whole process's.

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
import os
import pathlib
import pstats
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
# --tree TREE: import the port from another checkout (a child of --against)
TREE = (pathlib.Path(sys.argv[sys.argv.index("--tree") + 1]).resolve() if "--tree" in sys.argv
        else ROOT)
sys.path.insert(0, str(TREE))

from seq2squiggle_tpu_torch.config import load_config  # noqa: E402
from seq2squiggle_tpu_torch.ops import fft_block  # noqa: E402
from seq2squiggle_tpu_torch.runtime.simulate import simulate_run  # noqa: E402

R10 = ROOT / "assets" / "bench-weights-R10.npz"
SEED = 7
BATCH = 1024


def run(fasta: pathlib.Path, out: pathlib.Path, n_reads: int, pair: bool = False,
        wire: str = "auto", shards: int = 1) -> dict:
    return simulate_run(
        config=dict(load_config(None), pallas_pair=pair), saved_weights=str(R10),
        fasta=str(fasta),
        read_input=False, n=n_reads, r=1000, c=-1, out=str(out),
        profile="dna-r10-prom", dwell_mean=None, dwell_std=0.0, noise_std=2.0,
        noise_sampling=True, duration_sampling=True, distr="expon",
        predict_batch_size=BATCH, export_every_n_samples=1_000_000, seed=SEED,
        show_progress=False, wire_format=wire, device=[torch.device("cuda", 0)] * shards,
    )


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_run(fasta, out, n_reads, out_dir: pathlib.Path, pair: bool = False,
                wire: str = "auto", shards: int = 1) -> dict:
    from torch.profiler import ProfilerActivity, profile

    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=every_thread) as prof:
        stats = run(fasta, out, n_reads, pair, wire, shards)
    torch.cuda.synchronize()
    avg = prof.key_averages()

    def dev_total(e) -> float:
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    calls = {e.key: e.count for e in avg}
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    # the one-block and pair kernels of csrc/fft_block.cu: fft_block_kernel<T> and
    # fft_block_pair_kernel<T> (f32), fft_block_mma_kernel<EXACT> and
    # fft_block_pair_mma_kernel<EXACT> (bf16)
    block = [e for e in device if re.search(r"fft_block(_mma)?_kernel", e.name)]
    pairs = [e for e in device if re.search(r"fft_block_pair(_mma)?_kernel", e.name)]
    busy_s = _union_us((e.time_range.start, e.time_range.end) for e in device) / 1e6
    sort = ("self_device_time_total" if hasattr(avg[0], "self_device_time_total")
            else "self_cuda_time_total")
    table = "profile_pair.txt" if pair else f"profile{'' if wire == 'auto' else '_' + wire}.txt"
    (out_dir / table).write_text(avg.table(sort_by=sort, row_limit=40))
    batches = -(-stats["chunks"] // BATCH)
    return {
        "reads": stats["reads"], "chunks": stats["chunks"], "samples": stats["samples"],
        "wall_s": stats["seconds"], "wire_bits": stats["wire_bits"], "batches": batches,
        "cudaLaunchKernel": calls.get("cudaLaunchKernel", 0),
        "cudaLaunchKernel_per_batch": calls.get("cudaLaunchKernel", 0) / batches,
        "cudaStreamSynchronize": calls.get("cudaStreamSynchronize", 0),
        "host_cpu_self_s": sum(e.self_cpu_time_total for e in avg) / 1e6,
        "device_self_s": sum(dev_total(e) for e in avg) / 1e6,
        "device_busy_s": busy_s,
        "device_idle_share": 1.0 - busy_s / stats["seconds"],
        "fft_block_launches": len(block),
        "fft_block_device_s": sum(e.time_range.elapsed_us() for e in block) / 1e6,
        "fft_block_pair_launches": len(pairs),
        "fft_block_pair_device_s": sum(e.time_range.elapsed_us() for e in pairs) / 1e6,
    }


def cprofile_run(fasta, out, n_reads, out_dir: pathlib.Path, wire: str = "auto",
                 shards: int = 1) -> dict:
    prof = cProfile.Profile()
    prof.enable()
    stats = run(fasta, out, n_reads, wire=wire, shards=shards)
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(40)
    (out_dir / f"cprofile{'' if wire == 'auto' else '_' + wire}.txt").write_text(text.getvalue())
    return {"wall_s": stats["seconds"]}


def thread_cpu_tally() -> dict:
    """Wrap the port's predict_step so that each call adds its thread's CPU
    seconds (the launches' host side) to a tally by thread name."""
    from seq2squiggle_tpu_torch.runtime import predict

    tally = {}
    inner = predict.predict_step

    def timed(*args, **kw):
        t = time.thread_time()
        try:
            return inner(*args, **kw)
        finally:
            name = threading.current_thread().name
            tally[name] = tally.get(name, 0.0) + time.thread_time() - t

    predict.predict_step = timed
    return tally


def child(args, fasta, out, out_dir: pathlib.Path) -> dict:
    """One --against round of one tree: a warm-up, then one run per tier of
    --child in that order (and with --profiled one profiled run of the
    first), stage timers on."""
    os.environ["SEQ2SQUIGGLE_TPU_TIMERS"] = "1"
    tally = thread_cpu_tally()
    run(fasta, out, 30, shards=args.shards)
    result = {"tree": str(TREE), "shards": args.shards}
    wires = args.child.split(",")
    for wire in wires:
        tally.clear()
        stats = run(fasta, out, args.reads, wire=wire, shards=args.shards)
        batches = -(-stats["chunks"] // BATCH)
        cpu = {k: v / batches for k, v in stats["timers"].items() if k.endswith("_cpu")}
        cpu.update({f"predict_step@{k}": v / batches for k, v in tally.items()})
        result[wire] = {"ksamples_per_s": stats["ksamples_per_s"], "seconds": stats["seconds"],
                        "wire_bits": stats["wire_bits"], "batches": batches,
                        "cpu_s_per_batch": cpu}
    if args.profiled:
        got = profile_run(fasta, out, args.reads, out_dir, wire=wires[0], shards=args.shards)
        result["profiled"] = {k: got[k] for k in ("wire_bits", "wall_s", "device_busy_s",
                                                  "device_idle_share",
                                                  "cudaLaunchKernel_per_batch")}
    return result


def against(args, out_dir: pathlib.Path) -> dict:
    """This tree and --against CHECKOUT in alternating subprocess rounds."""
    trees = {"this": ROOT, "against": pathlib.Path(args.against).resolve()}
    rounds = {name: [] for name in trees}
    for r in range(args.rounds):
        for name in (list(trees) if r % 2 == 0 else list(trees)[::-1]):
            cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
                   "--tree", str(trees[name]), "--child", "auto,raw" if r % 2 == 0 else "raw,auto",
                   "--reads", str(args.reads), "--shards", str(args.shards),
                   "--out-dir", str(out_dir / name)] + (["--profiled"] if r == 0 else [])
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                raise RuntimeError(f"{name}'s round {r} failed")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            print(f"round {r} {name}:", json.dumps(got), flush=True)
            rounds[name].append(got)
    summary = {}
    for name, runs in rounds.items():
        for wire in ("auto", "raw"):
            rates = [g[wire]["ksamples_per_s"] for g in runs]
            keys = sorted({k for g in runs for k in g[wire]["cpu_s_per_batch"]})
            summary[f"{name} {wire}"] = {
                "ksamples_per_s": rates, "median": statistics.median(rates),
                "spread": max(rates) - min(rates),
                "median_cpu_s_per_batch": {k: statistics.median(
                    g[wire]["cpu_s_per_batch"].get(k, 0.0) for g in runs) for k in keys}}
        summary[f"{name} profiled"] = runs[0]["profiled"]
    for wire in ("auto", "raw"):
        this, other = summary[f"this {wire}"]["median"], summary[f"against {wire}"]["median"]
        print(f"{wire}: this tree {this:.1f} kSamples/s (spread "
              f"{summary[f'this {wire}']['spread']:.1f}), the other {other:.1f} (spread "
              f"{summary[f'against {wire}']['spread']:.1f}): {100 * (this / other - 1):+.1f} %",
              flush=True)
    return {"trees": {k: str(v) for k, v in trees.items()}, "rounds": args.rounds,
            "shards": args.shards, "summary": summary}


def train_profile(out_dir: pathlib.Path) -> dict:
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
    ap.add_argument("--pair", action="store_true",
                    help="repeat the steady and the profiled run with pallas_pair: true")
    ap.add_argument("--wire", action="store_true",
                    help="repeat the steady and the profiled run at --wire-format raw")
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the predict path")
    ap.add_argument("--shards", type=int, default=1,
                    help="split each batch over this many shards of cuda:0")
    ap.add_argument("--against", metavar="CHECKOUT",
                    help="alternate this tree's predict runs with that checkout's")
    ap.add_argument("--rounds", type=int, default=3, help="--against rounds")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # read before the imports
    ap.add_argument("--child", help=argparse.SUPPRESS)  # one --against round: the tiers
    ap.add_argument("--profiled", action="store_true", help=argparse.SUPPRESS)
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
    devices = [f"cuda:0 ({torch.cuda.get_device_name(0)})"] * args.shards
    print(card, "; devices", devices, flush=True)
    result = {"card": card, "devices": devices, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    if args.against:
        result["against"] = against(args, out_dir)
        print(json.dumps(result), flush=True)
        return 0
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
        if args.child:
            print(json.dumps(child(args, fasta, out, out_dir)), flush=True)
            return 0
        runs = [("warm", 30, False, "auto"), ("steady", args.reads, False, "auto")]
        if args.pair:  # in turns, and before a profiler slows the launches
            runs += [("pair_steady", args.reads, True, "auto"),
                     ("steady_again", args.reads, False, "auto")]
        if args.wire:
            os.environ["SEQ2SQUIGGLE_TPU_TIMERS"] = "1"
            runs = [runs[0], ("raw_steady", args.reads, False, "raw"), *runs[1:],
                    ("auto_steady_2", args.reads, False, "auto"),
                    ("raw_steady_2", args.reads, False, "raw"),
                    ("raw_steady_3", args.reads, False, "raw"),
                    ("auto_steady_3", args.reads, False, "auto")]
        for name, n, pair, wire in [*runs, ("steady_1000", 1000, False, "auto")]:
            if name == "steady_1000":
                os.environ.pop("SEQ2SQUIGGLE_TPU_TIMERS", None)
            fft_block.launches = fft_block.pair_launches = 0
            stats = run(fasta, out, n, pair, wire, args.shards)
            stats["fft_block_launches"] = fft_block.launches
            stats["fft_block_pair_launches"] = fft_block.pair_launches
            print(name, stats, flush=True)
            result[name] = stats
        result["profiled"] = profile_run(fasta, out, args.reads, out_dir, shards=args.shards)
        print("profiled", result["profiled"], flush=True)
        result["cprofiled"] = cprofile_run(fasta, out, args.reads, out_dir,
                                           shards=args.shards)
        print("cprofiled", result["cprofiled"], flush=True)
        if args.pair:
            result["pair_profiled"] = profile_run(fasta, out, args.reads, out_dir, pair=True,
                                                  shards=args.shards)
            print("pair profiled", result["pair_profiled"], flush=True)
        if args.wire:
            result["raw_profiled"] = profile_run(fasta, out, args.reads, out_dir, wire="raw",
                                                 shards=args.shards)
            print("raw profiled", result["raw_profiled"], flush=True)
            result["raw_cprofiled"] = cprofile_run(fasta, out, args.reads, out_dir, wire="raw",
                                                   shards=args.shards)
            print("raw cprofiled", result["raw_cprofiled"], flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
