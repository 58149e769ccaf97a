"""Time the profiling variants of the fused FFT block on one GPU: the
counterpart of scripts/profiling/profile_abc.py, profile_d.py and
profile_parts2.py for the PyTorch port.

    python scripts/profile_torch_block_variants.py [--rounds 4] [--batch 2048]

In one process, at (batch, 250, 64) bfloat16 with the committed R10 decoder
block 0 and inputs from numpy seed 0 (0.1 · standard normal, as the three
scripts), every kernel is first held against its plain version on a slice of
the batch (a run that disagrees raises), then timed in interleaved rounds:
each round times every kernel once (CUDA events around 8 launches after one
warm-up launch), so slow drift of the card hits all of them alike. Reported
per kernel: the minimum over the rounds, in ms per block, and the rounds.

  a, b, c        softmax orderings (ops/fft_block_variants.py::fused_abc)
  d              the per-head Cauchy–Schwarz shift (fused_d)
  block exact    the fused block itself with the exact row max
  block shift    the fused block with its Cauchy–Schwarz shift (its default
                 at this length)
  proj ... full  the block cut after each stage (fused_parts), each with the
                 difference to the stage before it

bfloat16 runs on the fused block's tensor-core body (csrc/block_mma.cuh).

Prints the card as nvidia-smi names it, one line per kernel, and as its last
line one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from seq2squiggle_tpu_torch.models.fft_model import to_device  # noqa: E402
from seq2squiggle_tpu_torch.models.weights import load_checkpoint  # noqa: E402
from seq2squiggle_tpu_torch.ops import fft_block_variants as tv  # noqa: E402
from seq2squiggle_tpu_torch.ops.fft_block import fused_fft_block  # noqa: E402

R10 = ROOT / "assets" / "bench-weights-R10.npz"
N_HEAD = 8
LAUNCHES = 8  # per timed reading


def kernels(block) -> dict:
    """name -> function of x, in the order they are reported."""
    fns = {v: (lambda x, v=v: tv.fused_abc(x, block, N_HEAD, v)) for v in tv.ABC_VARIANTS}
    fns["d"] = lambda x: tv.fused_d(x, block, N_HEAD, "d")
    fns["block exact"] = lambda x: fused_fft_block(x, block, N_HEAD, packed=False)
    fns["block shift"] = lambda x: fused_fft_block(x, block, N_HEAD, packed=True)
    for stage in tv.STAGES:
        fns[stage] = lambda x, s=stage: tv.fused_parts(x, block, N_HEAD, s)
    return fns


def plain_versions(block) -> dict:
    refs = {v: (lambda x, v=v: tv.fused_abc_reference(x, block, N_HEAD, v))
            for v in tv.ABC_VARIANTS}
    refs["d"] = lambda x: tv.fused_d_reference(x, block, N_HEAD, "d")
    for stage in tv.STAGES:
        refs[stage] = lambda x, s=stage: tv.fused_parts_reference(x, block, N_HEAD, s)
    return refs


def time_ms(fn, x) -> float:
    fn(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def setup(batch: int = 2048, L: int = 250, check_rows: int = 8):
    """The inputs and every kernel, each held against its plain version on
    the first check_rows rows (raises where one disagrees, or where c is
    not bit-equal to b). Returns (x, {name: function of x}, {name: max|err|})."""
    dev = torch.device("cuda")
    host, _ = load_checkpoint(str(R10))
    block = to_device(host, dev, torch.bfloat16)["decoder"]["blocks"][0]
    x = torch.from_numpy(
        (np.random.default_rng(0).standard_normal((batch, L, 64)) * 0.1).astype(np.float32)
    ).to(dev, torch.bfloat16)
    fns = kernels(block)

    errs = {}
    head = x[:check_rows]
    for name, ref_fn in plain_versions(block).items():
        ref = ref_fn(head)
        got = fns[name](head)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = 4 * 2.0 ** -8 * max(1.0, ref.float().abs().max().item())
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{name}: max|kernel - plain| {err} > {tol}")
        errs[name] = err
    if not torch.equal(fns["c"](head), fns["b"](head)):
        raise AssertionError("variant c is not bit-equal to b")
    return x, fns, errs


def timed(x, fns: dict, rounds: int) -> dict:
    """Every kernel in interleaved rounds: {"ms": {name: min}, "rounds":
    {name: [...]}, "stage_delta_ms": {stage: ms}}."""
    readings = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            readings[name].append(time_ms(fn, x))
    ms = {name: min(times) for name, times in readings.items()}
    deltas, prev = {}, 0.0
    for stage in tv.STAGES:
        deltas[stage] = ms[stage] - prev
        prev = ms[stage]
    return {"ms": ms, "rounds": readings, "stage_delta_ms": deltas}


def profile(rounds: int = 4, batch: int = 2048, L: int = 250) -> dict:
    x, fns, errs = setup(batch, L)
    return {"shape": [batch, L, 64], "dtype": "bfloat16", "launches_per_reading": LAUNCHES,
            "max_abs_err": errs, **timed(x, fns, rounds)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = profile(args.rounds, args.batch)
    for name, best in result["ms"].items():
        rounds = ", ".join(f"{t:.3f}" for t in result["rounds"][name])
        delta = (f"  (+{result['stage_delta_ms'][name]:7.3f})"
                 if name in result["stage_delta_ms"] else "")
        print(f"{name:23s}: min {best:7.3f} ms/block{delta}  (rounds: {rounds})", flush=True)
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                      **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
