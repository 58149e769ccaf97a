"""Time the attention-core kernels of the PyTorch port on one GPU, with the
two compile-time choices of csrc/attn_core.cu turned the other way beside
them, and the exp floor that holds the bfloat16 kernels.

    python scripts/profile_torch_attn_core.py [--rounds 4] [--batch 512]

csrc/attn_core.cu is built on its own (it needs no other source) once per
variant, all nvcc runs started together, into build/torch_kernels/variants/:

  as built     the file as the package builds it: ex2.approx on base-2
               exponents, 256 threads per thread block
  expf         -DS2S_ATTN_CORE_EXPF=1: libm's expf on natural exponents
  128 threads, 512 threads
               -DS2S_ATTN_CORE_MMA_THREADS=...: 4 or 16 warps per (batch
               row, head)

At (batch, 250, 64) bfloat16, inputs standard normal from numpy seed 0, every
variant's forward and backward are first held against the plain versions of
ops/attn_core.py (forward within 4 bf16 ULPs of max|plain|, gradients within
8 of max(1, max|plain|); a variant that disagrees raises) and then timed in
interleaved rounds (CUDA events around 20 launches after one warm-up launch),
with F.scaled_dot_product_attention and its backward, the yardstick, in the
same rounds. Reported: the minimum over the rounds and the rounds, in ms.

The exp floor: (batch · 8 heads · ceil16(L)² pairs) × (1 exp forward, 3
backward) ÷ (SMs × 16 exps a clock × the card's highest SM clock, as
`nvidia-smi --query-gpu=clocks.max.sm` gives it).

Prints the card as nvidia-smi names it, one line per reading, and as its last
line one JSON object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from seq2squiggle_tpu_torch.ops import _build  # noqa: E402
from seq2squiggle_tpu_torch.ops import attn_core as ac  # noqa: E402

VARIANTS = {
    "as built": [],
    "expf": ["-DS2S_ATTN_CORE_EXPF=1"],
    "128 threads": ["-DS2S_ATTN_CORE_MMA_THREADS=128"],
    "512 threads": ["-DS2S_ATTN_CORE_MMA_THREADS=512"],
}
N_HEAD = 8
LAUNCHES = 20  # per timed reading
MUFU_PER_CLOCK = 16  # exps a clock per SM (four schedulers, four lanes each)


def build_variants() -> dict:
    """name -> the ctypes library of csrc/attn_core.cu built with its flags."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = next(s for s in _build.sources() if s.name == "attn_core.cu")
    jobs = {}
    for name, flags in VARIANTS.items():
        lib = out_dir / f"attn_core-{name.replace(' ', '_')}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", str(src), "-o", str(lib)]
        jobs[name] = (lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, cmd, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{' '.join(cmd)}\n{log}")
        ptr, c_int = ctypes.c_void_p, ctypes.c_int
        cdll = ctypes.CDLL(str(lib))
        cdll.s2s_attn_core_fwd.restype = cdll.s2s_attn_core_bwd.restype = c_int
        cdll.s2s_attn_core_fwd.argtypes = [ptr] * 4 + [c_int] * 3 + [ctypes.c_float, ptr]
        cdll.s2s_attn_core_bwd.argtypes = [ptr] * 7 + [c_int] * 3 + [ctypes.c_float, ptr]
        libs[name] = cdll
    return libs


def _call(fn, tensors, B, L):
    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in tensors), B, L, 0,
             1.0 / math.sqrt(64 // N_HEAD),
             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")


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


def exp_floor_ms(B: int, L: int) -> dict:
    """The least time the special-function units could take for the exps."""
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pairs = B * N_HEAD * (math.ceil(L / 16) * 16) ** 2
    per_exp = 1e3 / (sms * MUFU_PER_CLOCK * clock_mhz * 1e6)
    return {"sm_clock_mhz": clock_mhz, "sms": sms, "pairs_padded": pairs,
            "fwd": pairs * per_exp, "bwd": 3 * pairs * per_exp}


def profile(rounds: int = 4, batch: int = 512, L: int = 250) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((batch, L, 64)).astype(np.float32))
                  .to(dev, torch.bfloat16) for _ in range(4))
    out, gq, gk, gv = (torch.empty_like(q) for _ in range(4))
    libs = build_variants()

    ref = ac.packed_attention_core_reference(q, k, v, N_HEAD)
    refs = ac.packed_attention_core_backward_reference(q, k, v, g, N_HEAD)
    ulp = 2.0 ** -8
    errs, fns = {}, {}
    for name, lib in libs.items():
        fns[f"fwd {name}"] = lambda lib=lib: _call(lib.s2s_attn_core_fwd, (q, k, v, out),
                                                   batch, L)
        fns[f"bwd {name}"] = lambda lib=lib: _call(lib.s2s_attn_core_bwd,
                                                   (q, k, v, g, gq, gk, gv), batch, L)
        fns[f"fwd {name}"]()
        fns[f"bwd {name}"]()
        torch.cuda.synchronize()
        f_err = (out.float() - ref.float()).abs().max().item()
        if not f_err <= 4 * ulp * ref.float().abs().max().item():
            raise AssertionError(f"{name}: forward max|kernel - plain| {f_err}")
        b_err = 0.0
        for got, want in zip((gq, gk, gv), refs):
            err = (got.float() - want.float()).abs().max().item()
            if not err <= 8 * ulp * max(1.0, want.float().abs().max().item()):
                raise AssertionError(f"{name}: gradient max|kernel - plain| {err}")
            b_err = max(b_err, err)
        errs[name] = {"fwd": f_err, "bwd": b_err}
    del ref, refs

    def heads(t):
        return t.view(batch, L, N_HEAD, 64 // N_HEAD).transpose(1, 2)

    qh, kh, vh = (heads(t).detach().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qh, kh, vh)
    fns["fwd library"] = lambda: F.scaled_dot_product_attention(qh, kh, vh)
    fns["bwd library"] = lambda: torch.autograd.grad(sdpa, (qh, kh, vh), heads(g),
                                                     retain_graph=True)

    readings = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            readings[name].append(time_ms(fn))
    return {"shape": [batch, L, 64], "dtype": "bfloat16", "launches_per_reading": LAUNCHES,
            "ms": {name: min(times) for name, times in readings.items()}, "rounds": readings,
            "max_abs_err": errs, "exp_floor_ms": exp_floor_ms(batch, L)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--batch", type=int, default=512)
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
        print(f"{name:16s}: min {best:7.4f} ms  (rounds: {rounds})", flush=True)
    floor = result["exp_floor_ms"]
    print(f"exp floor at {floor['sm_clock_mhz']:.0f} MHz on {floor['sms']} SMs: forward "
          f"{floor['fwd']:.4f} ms, backward {floor['bwd']:.4f} ms", flush=True)
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                      **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
