"""Stage costs of the fused FFT block on one GPU from its eight profiling cuts:
the counterpart of scripts/profiling/profile_attn_breakdown.py for the
PyTorch port.

    python scripts/profile_torch_attn_breakdown.py [--rounds 4] [--batch 2048]

Each tag is `fused_fft_block(x, block, 8, packed=True, ablate=tag)` (the full
block for "full"; ops/fft_block_variants.py says what each cut takes out) run
on the two decoder blocks of assets/bench-weights-R10.npz one after the other,
at (batch, 250, 64) bfloat16 in the Cauchy–Schwarz form, inputs 0.1·N(0, 1)
from numpy seed 0, as that script. Every tag is first held against its plain
version on a slice of the batch (within 4 bf16 ULPs of max(1, max|plain|);
a tag that disagrees raises), then all are timed in interleaved rounds: CUDA
events around 8 calls of the two blocks after one warm-up call, so slow drift
of the card hits all of them alike. Reported per tag: the minimum over the
rounds in ms per two blocks, the rounds, and full − cut, what the cut takes
out:

  noexp    the exp                      noshift  the shift's machinery
  bf16exp  rounding the exp's argument  nomask   the padded-key mask
           (negative: it adds work)     noden    den's product and the divide
  noffn    the FFN and LN2              noattn   the whole attention
  thin16   the score products of heads 2..7

Prints the card as nvidia-smi names it, one line per tag, and as its last line
one JSON object with every number.
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
from seq2squiggle_tpu_torch.ops import fft_block as fb  # noqa: E402

R10 = ROOT / "assets" / "bench-weights-R10.npz"
N_HEAD = 8
LAUNCHES = 8  # calls of the two blocks per timed reading
# the tags of profile_attn_breakdown.py, "" (the full block) first
ABLATIONS = ("", "noexp", "bf16exp", "noshift", "nomask", "noden", "noffn", "noattn", "thin16")


def two_blocks(blocks, tag: str, plain: bool = False):
    """x -> both decoder blocks with the cut `tag`, the kernels or plain."""
    fn = fb.fused_fft_block_reference if plain else fb.fused_fft_block
    b0, b1 = blocks
    return lambda x: fn(fn(x, b0, N_HEAD, True, tag), b1, N_HEAD, True, tag)


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
    """The inputs and the two blocks of every tag, each held against its
    plain version on the first check_rows rows (raises where one disagrees).
    Returns (x, {tag or "full": function of x}, {tag or "full": max|err|})."""
    dev = torch.device("cuda")
    host, _ = load_checkpoint(str(R10))
    blocks = to_device(host, dev, torch.bfloat16)["decoder"]["blocks"]
    x = torch.from_numpy(
        (np.random.default_rng(0).standard_normal((batch, L, 64)) * 0.1).astype(np.float32)
    ).to(dev, torch.bfloat16)
    fns, errs = {}, {}
    head = x[:check_rows]
    for tag in ABLATIONS:
        name = tag or "full"
        fns[name] = two_blocks(blocks, tag)
        got, ref = fns[name](head), two_blocks(blocks, tag, plain=True)(head)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = 4 * 2.0 ** -8 * max(1.0, ref.float().abs().max().item())
        if not (err <= tol and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{name}: max|kernel - plain| {err} > {tol}")
        errs[name] = err
    return x, fns, errs


def timed(x, fns: dict, rounds: int) -> dict:
    """Every tag in interleaved rounds: {"ms": {tag: min}, "rounds": {tag:
    [...]}, "full_minus_cut_ms": {tag: ms}}."""
    readings = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            readings[name].append(time_ms(fn, x))
    ms = {name: min(times) for name, times in readings.items()}
    return {"ms": ms, "rounds": readings,
            "full_minus_cut_ms": {name: ms["full"] - t for name, t in ms.items()
                                  if name != "full"}}


def profile(rounds: int = 4, batch: int = 2048, L: int = 250) -> dict:
    x, fns, errs = setup(batch, L)
    return {"shape": [batch, L, 64], "dtype": "bfloat16", "blocks": 2, "packed": True,
            "launches_per_reading": LAUNCHES, "max_abs_err": errs, **timed(x, fns, rounds)}


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
        rounds = ", ".join(f"{t:.4f}" for t in result["rounds"][name])
        delta = (f"  full - cut {result['full_minus_cut_ms'][name]:+8.4f}"
                 if name in result["full_minus_cut_ms"] else "")
        print(f"{name:8s}: min {best:8.4f} ms/2blocks{delta}  (rounds: {rounds})", flush=True)
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                      **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
