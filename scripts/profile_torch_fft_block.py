"""Time the fused FFT block and its pair (csrc/fft_block.cu) on one GPU, bf16,
back to back.

    python scripts/profile_torch_fft_block.py [--rounds 4] [--batch 1024] [--against CHECKOUT]

"as built" is the package's own library: bf16 through csrc/block_mma.cuh (a
warp per 16-row slab, `mma.sync` against weights staged in shared memory once
per thread block). With --against, CHECKOUT's csrc/fft_block.cu is built alone
as that tree's package builds it, into build/torch_kernels/variants/
(`_build.build_variants`), and timed in the same rounds as "as built,
<CHECKOUT's directory name>", to compare two trees on one card.

With the decoder blocks of assets/bench-weights-R10.npz and inputs standard
normal from numpy seed 0, each build is first held against the plain
versions of ops/fft_block.py (within 4 bf16 ULPs of max(1, max|plain|); the
pair bit-equal to two one-block launches; a build that disagrees raises), and
then timed in interleaved rounds: CUDA events around 20 launches after one
warm-up launch. Timed: one block at (batch, 250, 64) with the default
softmax form (the Cauchy–Schwarz shift) and with the exact row max, one block
at (batch, 16, 64) (default: the exact row max; the encoder's shape), and the
pair at (batch, 250, 64). Reported: the minimum over the rounds and the
rounds, ms.

Prints the card as nvidia-smi names it, one line per reading, and as its last
line one JSON object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

N_HEAD = 8
LAUNCHES = 20  # per timed reading
ULP = 2.0 ** -8


def libraries(_build, against: pathlib.Path | None = None) -> dict:
    """name -> ctypes library: the package's, and `against`'s fft_block.cu
    as built."""
    libs = {"as built": _build.load()}
    if against is not None:
        name = f"as built, {against.name}"
        libs.update(_build.build_variants({name: (_build.sources(["fft_block.cu"], against), [])}))
    return libs


def time_ms(fn) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def profile(rounds: int = 4, batch: int = 1024, against: pathlib.Path | None = None) -> dict:
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.models.weights import load_checkpoint
    from seq2squiggle_tpu_torch.ops import _build
    from seq2squiggle_tpu_torch.ops import fft_block as fb

    dev = torch.device("cuda", torch.cuda.current_device())  # the blocks' own device
    host, _ = load_checkpoint(str(ROOT / "assets" / "bench-weights-R10.npz"))
    b0, b1 = fft_model.to_device(host, dev, torch.bfloat16)["decoder"]["blocks"]
    p0, p1 = (fb._weight_pointers(b, torch.bfloat16, dev) for b in (b0, b1))
    both = (ctypes.c_void_p * 32)(*p0, *p1)
    rng = np.random.default_rng(0)
    x250, x16 = (torch.from_numpy(rng.standard_normal((batch, L, 64)).astype(np.float32))
                 .to(dev, torch.bfloat16) for L in (250, 16))

    def run(lib, entry, x, ptrs, exact):
        return fb.launch_kernel(entry, x, ptrs, int(exact), lib=lib)

    # (what, x, exact)
    one_block = [("one block 250 shift", x250, False), ("one block 250 exact", x250, True),
                 ("one block 16 exact", x16, True)]
    refs = {what: fb.fused_fft_block_reference(x, b0, N_HEAD, packed=not exact)
            for what, x, exact in one_block}
    pair_ref = fb.fused_fft_block_pair_reference(x250, b0, b1, N_HEAD, packed=True)
    libs = libraries(_build, against)
    errors, fns = {}, {}
    for name, lib in libs.items():
        errs = {}
        for what, x, exact in one_block:
            got = run(lib, "s2s_fft_block", x, p0, exact)
            torch.cuda.synchronize()
            errs[what] = hold(f"{name}: {what}", got, refs[what])
            fns[f"{what}: {name}"] = (
                lambda lib=lib, x=x, exact=exact: run(lib, "s2s_fft_block", x, p0, exact))
        pair = run(lib, "s2s_fft_block_pair", x250, both, False)
        two = run(lib, "s2s_fft_block", run(lib, "s2s_fft_block", x250, p0, False), p1, False)
        torch.cuda.synchronize()
        if not torch.equal(pair, two):
            raise AssertionError(f"{name}: the pair is not bit-equal to two one-block launches")
        errs["pair 250 shift"] = hold(f"{name}: pair", pair, pair_ref)
        errors[name] = errs
        fns[f"pair 250 shift: {name}"] = lambda lib=lib: run(lib, "s2s_fft_block_pair", x250,
                                                             both, False)
    del refs, pair_ref
    readings = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            readings[name].append(time_ms(fn))
    return {"batch": batch, "dtype": "bfloat16", "launches_per_reading": LAUNCHES,
            "ms": {name: min(times) for name, times in readings.items()}, "rounds": readings,
            "errors": errors}


def hold(what: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    err = (got.float() - ref.float()).abs().max().item()
    bar = 4 * ULP * max(1.0, ref.float().abs().max().item())
    if not (bool(torch.isfinite(got).all()) and err <= bar):
        raise AssertionError(f"{what}: max|kernel - plain| {err} > {bar}")
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--against", type=pathlib.Path,
                    help="a checkout whose csrc/fft_block.cu is built and timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = profile(args.rounds, args.batch,
                     args.against.resolve() if args.against else None)
    for name, best in result["ms"].items():
        rounds = ", ".join(f"{t:.4f}" for t in result["rounds"][name])
        print(f"{name:36s}: min {best:8.4f} ms  (rounds: {rounds})", flush=True)
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                      **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
