"""Time the whole-block training kernels of the PyTorch port on one GPU: the
forward, the backward and each of the backward's six launches, back to back.

    python scripts/profile_torch_block_train.py [--rounds 4] [--batch 512] [--against CHECKOUT]
    python scripts/profile_torch_block_train.py --relu-flips [--batch 512] [--length 250]

"as built" is the package's own library: bfloat16 on the tensor cores, a warp
per 16-row slab, the weights staged in shared memory once per block
(csrc/block_mma.cuh's body). With --against, CHECKOUT's csrc/block_train.cu
and csrc/attn_core.cu (the backward runs the attention-core backward as one
stage) are built together as that tree's package builds them (its C
interface must be this tree's), into build/torch_kernels/variants/
(`_build.build_variants`), and timed in the same rounds as "as built,
<CHECKOUT's directory name>", to compare two trees on one card.

At (batch, 250, 64) bfloat16 with dropout scales (rate 0.2), inputs standard
normal from numpy seed 0, the block's weights the model's init from seed 7,
every build is first held against the plain versions of ops/block_train.py
(forward within 4 bf16 ULPs of max(1, max|plain|); gx within 8 on all but
1e-4 of its entries; each weight gradient within 2e-2·max(1, max|plain|); a
build that disagrees raises) and then timed in interleaved rounds: CUDA
events around 20 launches after one warm-up launch. A stage of the backward
is launched alone on the buffers a whole call left (each reads what the
earlier ones wrote). Reported: the minimum over the rounds and the rounds, ms.

--relu-flips times nothing. For the package's library it counts the entries
of the 256-wide hidden layer whose relu mask differs between the kernel (f1 >
0 in the backward's workspace) and the plain version (pre > 0): a pre-activation
that lands on the other side of 0 moves that position's W1, b1 and upstream
gradients by a whole term. It prints the count, the positions that hold one,
the largest |pre| of the plain version at such an entry (a flip is a
pre-activation near 0; a large one would be a fault), and the error of the W1
and b1 gradients and of the worst gradient, as a share of max(1, max|plain|),
first as they are and then with g set to 0 at the positions that hold a flip
in both the kernel and the plain version (the hidden layer is per position, so
those positions then add nothing to either). What is left is the error that
does not come from flipped masks.

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

N_HEAD = 8
RATE = 0.2
LAUNCHES = 20  # per timed reading
ULP = 2.0 ** -8


def libraries(_build, against: pathlib.Path | None = None) -> dict:
    """name -> ctypes library: the package's, and `against`'s block_train.cu
    + attn_core.cu as built."""
    libs = {"as built": _build.load()}
    if against is not None:
        name = f"as built, {against.name}"
        srcs = _build.sources(("block_train.cu", "attn_core.cu"), against)
        libs.update(_build.build_variants({name: (srcs, [])}))
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


def inputs(bt, batch: int, L: int, dtype):
    """(x, g, [s_a, s_f], the block's 16 weights) on the card."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x, g = (torch.from_numpy(rng.standard_normal((batch, L, 64)).astype(np.float32))
            .to(dev, dtype) for _ in range(2))
    scales = [bt.make_dropout_scales(k, RATE, x.shape, dtype)
              for k in prng.split(prng.key(batch, dev))]
    block = fft_model.init_params(load_config(None), prng.key(7))["decoder"]["blocks"][0]
    return x, g, scales, [w.to(dev).contiguous() for w in bt.block_weights(block)]


def interleaved(fns: dict, rounds: int) -> dict:
    readings = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            readings[name].append(time_ms(fn))
    return readings


def hold(name, bt, lib, x, g, scales, weights, ref, refs) -> dict:
    """One build against the plain versions; raises where it disagrees."""
    out = bt._launch_fwd(x, weights, *scales, N_HEAD, lib=lib)
    gx, gws = bt._launch_bwd(x, weights, *scales, g, N_HEAD, lib=lib)
    torch.cuda.synchronize()
    f_err = (out.float() - ref.float()).abs().max().item()
    if not f_err <= 4 * ULP * max(1.0, ref.float().abs().max().item()):
        raise AssertionError(f"{name}: forward max|kernel - plain| {f_err}")
    rx, rws = refs
    x_max = max(1.0, rx.float().abs().max().item())
    x_out = ((gx.float() - rx.float()).abs() > 8 * ULP * x_max).float().mean().item()
    w_err = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                for a, b in zip(gws, rws))
    if not (x_out <= 1e-4 and w_err <= 2e-2):
        raise AssertionError(f"{name}: gx outside 8 ULPs on {x_out:.2e} of its entries, a "
                             f"weight gradient off by {w_err} of max(1, max|plain|)")
    return {"fwd": f_err, "gx_share_outside": x_out, "weights": w_err}


def profile(rounds: int = 4, batch: int = 512, L: int = 250,
            against: pathlib.Path | None = None) -> dict:
    from seq2squiggle_tpu_torch.ops import _build
    from seq2squiggle_tpu_torch.ops import block_train as bt

    x, g, scales, weights = inputs(bt, batch, L, torch.bfloat16)
    libs = libraries(_build, against)
    ref = bt.fused_block_train_reference(x, weights, *scales, N_HEAD)
    refs = bt.fused_block_train_backward_reference(x, weights, *scales, g, N_HEAD)
    errs, fns = {}, {}
    for name, lib in libs.items():
        errs[name] = hold(name, bt, lib, x, g, scales, weights, ref, refs)
        fns[f"fwd {name}"] = lambda lib=lib: bt._launch_fwd(x, weights, *scales, N_HEAD, lib=lib)
        fns[f"bwd {name}"] = lambda lib=lib: bt._launch_bwd(x, weights, *scales, g, N_HEAD,
                                                            lib=lib)
        stages = {}
        bt._launch_bwd(x, weights, *scales, g, N_HEAD, lib=lib, stage_launchers=stages)
        for stage, fn in stages.items():
            fns[f"bwd {name}: {stage}"] = fn
    del ref, refs
    readings = interleaved(fns, rounds)
    return {"shape": [batch, L, 64], "dtype": "bfloat16", "dropout_scales": True,
            "launches_per_reading": LAUNCHES,
            "ms": {name: min(times) for name, times in readings.items()}, "rounds": readings,
            "errors": errs}


def backward_keeping_f1(bt, lib, x, weights, scales, g):
    """A whole backward through the C interface on this function's own
    buffers: (gx, the 16 gradients, f1 as the rows stage left it, (B, L, 256)).
    The compute-dtype workspace is eleven (B·L, 64) buffers, then f1, then gf1c
    (`Workspace` in csrc/block_train.cu)."""
    B, L, D = x.shape
    n_wc, n_cd, n_f32 = bt._workspace(lib, x)
    wc = torch.empty(n_wc, dtype=x.dtype, device=x.device)
    ws_cd = torch.empty(n_cd, dtype=x.dtype, device=x.device)
    ws_f32 = torch.empty(n_f32, dtype=torch.float32, device=x.device)
    gx = torch.empty_like(x)
    gw = torch.empty(sum(w.numel() for w in weights), dtype=torch.float32, device=x.device)
    err = lib.s2s_block_train_bwd(
        bt._ptr(x), bt._ptr(scales[0]), bt._ptr(scales[1]), bt._ptr(g), bt._ptr(gx), bt._ptr(gw),
        bt._weight_pointers(weights), bt._ptr(wc), bt._ptr(ws_cd), bt._ptr(ws_f32),
        B, L, bt._DTYPE_CODES[x.dtype], 1.0 / (D // N_HEAD) ** 0.5, bt._ALL_STAGES,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    torch.cuda.synchronize()
    if err != 0:
        raise RuntimeError(f"backward launch failed: {err}")
    f1 = ws_cd[11 * B * L * D:][:B * L * 4 * D].view(B, L, 4 * D).clone()
    return gx, bt._grad_views(gw, weights), f1


def relu_flips(rounds: int = 0, batch: int = 512, L: int = 250) -> dict:
    """Flipped relu masks, kernel against plain, and what they do to the
    weight gradients (see the module's text)."""
    from seq2squiggle_tpu_torch.ops import _build
    from seq2squiggle_tpu_torch.ops import block_train as bt

    x, g, scales, weights = inputs(bt, batch, L, torch.bfloat16)
    libs = libraries(_build)
    pre = bt._recompute(x, weights, *scales, N_HEAD)["pre"]
    i_w1, i_b1 = (bt.WEIGHT_FIELDS.index(("ffn", "w_1", leaf)) for leaf in ("kernel", "bias"))

    def errors(gws, rws):
        share = [(a - b).abs().max().item() / max(1.0, b.abs().max().item())
                 for a, b in zip(gws, rws)]
        return {"w1": share[i_w1], "b1": share[i_b1], "worst": max(share),
                "worst_leaf": "/".join(bt.WEIGHT_FIELDS[share.index(max(share))])}

    _, rws = bt.fused_block_train_backward_reference(x, weights, *scales, g, N_HEAD)
    out = {}
    for name, lib in libs.items():
        _, gws, f1 = backward_keeping_f1(bt, lib, x, weights, scales, g)
        flipped = (f1 > 0) != (pre > 0)
        rows = flipped.any(dim=-1)
        g_kept = g * (~rows)[..., None].to(g.dtype)
        _, gws_kept, _ = backward_keeping_f1(bt, lib, x, weights, scales, g_kept)
        _, rws_kept = bt.fused_block_train_backward_reference(x, weights, *scales, g_kept, N_HEAD)
        out[name] = {
            "flipped_entries": int(flipped.sum()), "entries": flipped.numel(),
            "positions_with_a_flip": int(rows.sum()), "positions": rows.numel(),
            "max_abs_pre_at_a_flip": pre[flipped].abs().max().item() if flipped.any() else 0.0,
            "max_abs_pre": pre.abs().max().item(),
            "errors": errors(gws, rws), "errors_without_those_positions":
                errors(gws_kept, rws_kept)}
    return {"shape": [batch, L, 64], "dtype": "bfloat16", "dropout_scales": True,
            "relu_flips": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--relu-flips", action="store_true",
                    help="count the relu masks that differ from the plain version's, and the "
                         "weight gradients' error with and without their positions")
    ap.add_argument("--length", type=int, default=250)
    ap.add_argument("--against", type=pathlib.Path,
                    help="a checkout whose two files are built and timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.relu_flips:
        result = relu_flips(args.rounds, args.batch, args.length)
    else:
        result = profile(args.rounds, args.batch, args.length,
                         args.against.resolve() if args.against else None)
    for name, r in result.get("relu_flips", {}).items():
        e, k = r["errors"], r["errors_without_those_positions"]
        print(f"{name:24s}: {r['flipped_entries']} of {r['entries']} masks flipped, at "
              f"{r['positions_with_a_flip']} of {r['positions']} positions; largest |pre| at a "
              f"flip {r['max_abs_pre_at_a_flip']:.3g} (of all {r['max_abs_pre']:.3g}); error / "
              f"max(1, max|plain|): W1 {e['w1']:.3g}, b1 {e['b1']:.3g}, worst {e['worst']:.3g} "
              f"({e['worst_leaf']}); without those positions: W1 {k['w1']:.3g}, b1 {k['b1']:.3g}, "
              f"worst {k['worst']:.3g} ({k['worst_leaf']})", flush=True)
    for name, best in result.get("ms", {}).items():
        rounds = ", ".join(f"{t:.4f}" for t in result["rounds"][name])
        print(f"{name:44s}: min {best:8.4f} ms  (rounds: {rounds})", flush=True)
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
