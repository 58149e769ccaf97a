"""On-card smoke test of the PyTorch/CUDA port (seq2squiggle_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: the card's name and power limit, torch and CUDA versions, and
     the kernel build from csrc/ (nvcc, sm_90a) with its time;
  2. kernel vs plain: the hand-written fused FFT-block kernel against its
     plain PyTorch version on the same inputs, at the predict path's shapes
     (1024 x 16 and 1024 x 250, d_model 64) plus a ragged batch of 3, in
     bf16 (<= 4 bf16 ULPs of max|plain|) and f32 (rtol 1e-4, atol 1e-5), and
     the Cauchy–Schwarz underflow input (finite output); median times of
     both with CUDA events after warm-up;
  3. whole step: predict_step in f32 on the GPU against the same step on the
     CPU (counts equal on >= 99.9 % of rows, samples within 1 count on all
     but <= 0.1 % of those rows), then the bf16 step through the kernel against the
     bf16 step through the plain blocks, samplers off (counts equal, samples
     within 4 bf16 ULPs of the decoder output in counts, plus 1);
  4. main path: `simulate_run` on the GPU with the committed R10 weights, the
     default bf16 config and batch size 1024, reference mode over a
     synthetic genome made from a fixed seed; the BLOW5 is read back and the
     kernel must have been launched 4 times per batch.

The line before the last is a JSON object with each kernel's route, source,
launches on the main path, error and times; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
KERNEL_SOURCE = "seq2squiggle_tpu_torch/csrc/fft_block.cu"
TPU_KERNEL = "seq2squiggle_tpu/ops/pallas/fft_block.py:403"
R10 = ROOT / "assets" / "bench-weights-R10.npz"
BATCH = 1024
SEED = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def median_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_tol(ref: torch.Tensor) -> float:
    return 4 * 2.0 ** -8 * max(1.0, ref.float().abs().max().item())


def phase_device():
    from seq2squiggle_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernel(params_by_dtype, dev):
    from seq2squiggle_tpu_torch.ops.fft_block import (
        fused_fft_block, fused_fft_block_reference,
    )

    gen = torch.Generator().manual_seed(SEED)
    worst_bf16 = 0.0
    times = {}
    for dtype, params in params_by_dtype.items():
        block = params["decoder"]["blocks"][0]
        for B, L in ((BATCH, 16), (BATCH, 250), (3, 16), (3, 250)):
            x = torch.randn(B, L, 64, generator=gen).to(dev, dtype)
            got = fused_fft_block(x, block, 8)
            torch.cuda.synchronize()
            ref = fused_fft_block_reference(x, block, 8)
            err = (got.float() - ref.float()).abs().max().item()
            check(bool(torch.isfinite(got).all()), f"non-finite kernel output {dtype} {B}x{L}")
            if dtype == torch.bfloat16:
                check(err <= bf16_tol(ref), f"bf16 {B}x{L}: err {err} > {bf16_tol(ref)}")
                worst_bf16 = max(worst_bf16, err) if B == BATCH else worst_bf16
            else:
                torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
            msg = f"kernel vs plain {str(dtype)[6:]:8s} B={B:4d} L={L:3d}: max|err| {err:.3g}"
            if B == BATCH:
                k_ms = median_ms(lambda: fused_fft_block(x, block, 8))
                p_ms = median_ms(lambda: fused_fft_block_reference(x, block, 8))
                times[(dtype, L)] = (k_ms, p_ms)
                msg += f", kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms"
            log(msg)
        # test_pallas.py:111-137's underflow input: finite, not NaN
        d = torch.zeros(2, 64)
        d[0, ::2] = 1.0
        d[1, 1::2] = 1.0
        x = d[torch.tensor([0, 1] * 125)] * 3e3 + torch.randn(250, 64, generator=gen) * 1e-2
        x = x.expand(2, 250, 64).contiguous().to(dev, dtype)
        out = fused_fft_block(x, block, 8)
        check(bool(torch.isfinite(out).all()), f"underflow input gave non-finite {dtype}")
        log(f"underflow input {str(dtype)[6:]}: finite")
    return worst_bf16, times


def _batch(B, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(1, 5, (B, 24)).astype(np.uint8)
    ridx = np.arange(B, dtype=np.int32)
    ridx[-5:] = -1
    coff = rng.integers(0, 60, B).astype(np.int32)
    nk = np.full(B, 16, np.uint8)
    nk[::17] = 5
    return [torch.from_numpy(a) for a in (codes, ridx, coff, nk)]


def _step(params, batch, dev, cfg, knobs, key_seed=SEED):
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.runtime.predict import predict_step

    codes, ridx, coff, nk = (t.to(dev) for t in batch)
    with torch.inference_mode():
        s, c = predict_step(params, codes, ridx, coff, prng.key(key_seed, dev), nk,
                            config=cfg, knobs=knobs)
    return s.cpu().numpy(), c.cpu().numpy()


def phase_step(host_params, dev):
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.host import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.runtime.predict import PredictKnobs, decoder_output

    # f32 on the GPU against the CPU, samplers on
    cfg32 = dict(load_config(None), compute_dtype="float32")
    knobs = PredictKnobs(dwell_mean=10.0)
    batch = _batch(BATCH, 1)
    gs, gc = _step(fft_model.to_device(host_params, dev, torch.float32), batch, dev,
                   cfg32, knobs)
    cs, cc = _step(fft_model.to_device(host_params, torch.device("cpu"), torch.float32),
                   batch, torch.device("cpu"), cfg32, knobs)
    same = gc == cc
    check(same.mean() >= 0.999, f"f32 step: counts equal on only {same.mean():.4f}")
    valid = (np.arange(gs.shape[1])[None] < cc[:, None]) & same[:, None]
    d = np.abs(gs.astype(np.int64) - cs.astype(np.int64))[valid]
    check(d.max(initial=0) <= 1 and (d == 1).mean() <= 0.001,
          f"f32 step: max|Δ| {d.max(initial=0)}, share at 1: {(d == 1).mean():.5f}")
    log(f"f32 step GPU vs CPU: counts equal {same.mean():.4f}, "
        f"samples exact {(d == 0).mean():.5f}, max|Δ| {d.max(initial=0)}")

    # bf16 through the kernel against bf16 through the plain blocks
    cfg16 = dict(load_config(None), compute_dtype="bfloat16")
    knobs = PredictKnobs(duration_sampling=False, dwell_std=0.0, noise_std=0.0,
                         dwell_mean=12.0)
    p16 = fft_model.to_device(host_params, dev, torch.bfloat16)
    batch = _batch(BATCH, 2)
    ks, kc = _step(p16, batch, dev, dict(cfg16, use_pallas="auto"), knobs)
    ps, pc = _step(p16, batch, dev, dict(cfg16, use_pallas=False), knobs)
    check((kc == pc).all(), "bf16 step: counts differ between kernel and plain blocks")
    with torch.inference_mode():  # max|dec| of the plain path, for the bar
        dec = decoder_output(p16, *(t.to(dev) for t in batch[:3]), prng.key(SEED, dev),
                             batch[3].to(dev), config=dict(cfg16, use_pallas=False),
                             knobs=knobs)[0]
        max_dec = dec.float().abs().max().item()
    bar = math.ceil(4 * 2.0 ** -8 * max_dec * knobs.scaling_max_value
                    * knobs.digitisation / knobs.signal_range) + 1
    valid = np.arange(ks.shape[1])[None] < pc[:, None]
    d = np.abs(ks.astype(np.int64) - ps.astype(np.int64))[valid]
    check(d.max() <= bar, f"bf16 step: max|Δ| {d.max()} > bar {bar}")
    log(f"bf16 step kernel vs plain: counts equal, max|Δ| {d.max()} <= {bar} counts, "
        f"samples exact {(d == 0).mean():.4f}")


def phase_main_path(dev):
    from seq2squiggle_tpu_torch.host import load_config, read_slow5
    from seq2squiggle_tpu_torch.ops import fft_block
    from seq2squiggle_tpu_torch.runtime.simulate import simulate_run

    n_reads = 300
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        rng = np.random.default_rng(SEED)
        fasta = pathlib.Path(tmp) / "genome.fasta"
        fasta.write_text(">synthetic\n" + "".join(rng.choice(list("ACGT"), 200_000)) + "\n")
        out = pathlib.Path(tmp) / "out.blow5"
        cfg = load_config(None)  # bf16 compute, use_pallas auto
        fft_block.launches = 0
        stats = simulate_run(
            config=cfg, saved_weights=str(R10), fasta=str(fasta), read_input=False,
            n=n_reads, r=1000, c=-1, out=str(out), profile="dna-r10-prom",
            dwell_mean=None, dwell_std=0.0, noise_std=2.0, noise_sampling=True,
            duration_sampling=True, distr="expon", predict_batch_size=BATCH,
            export_every_n_samples=1_000_000, seed=SEED, show_progress=False,
            device=dev,
        )
        launches = fft_block.launches
        _, recs = read_slow5(str(out))
    n_batches = math.ceil(stats["chunks"] / BATCH)
    check(len(recs) == stats["reads"] >= 0.9 * n_reads,
          f"main path: {len(recs)} records for {stats['reads']} reads")
    check(all(len(r["signal"]) > 0 for r in recs), "main path: empty signal")
    check(sum(len(r["signal"]) for r in recs) == stats["samples"], "sample count")
    check(launches == 4 * n_batches,
          f"kernel launched {launches} times for {n_batches} batches (want 4 per batch)")
    log(f"main path: {stats['reads']} reads, {stats['chunks']} chunks in {n_batches} "
        f"batches, {stats['samples']} samples in {stats['seconds']:.3f} s "
        f"({stats['ksamples_per_s']:.1f} kSamples/s), fused_fft_block launches {launches}")
    return launches


def main() -> int:
    if not (ROOT / "seq2squiggle_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from seq2squiggle_tpu_torch.device import resolve_device
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.models.weights import load_checkpoint

    dev = resolve_device("cuda")
    phase_device()
    host_params, _ = load_checkpoint(str(R10))
    params = {dt: fft_model.to_device(host_params, dev, dt)
              for dt in (torch.bfloat16, torch.float32)}
    worst_bf16, times = phase_kernel(params, dev)
    phase_step(host_params, dev)
    launches = phase_main_path(dev)

    # per batch the path runs the kernel twice at L=16 and twice at L=250
    k_ms = 2 * (times[(torch.bfloat16, 16)][0] + times[(torch.bfloat16, 250)][0])
    p_ms = 2 * (times[(torch.bfloat16, 16)][1] + times[(torch.bfloat16, 250)][1])
    kernels = {"kernels": [{
        "name": "fused_fft_block",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": worst_bf16,
        "ms": k_ms,
        "plain_ms": p_ms,
        "ms_by_shape": {f"{str(dt)[6:]} {BATCH}x{L}x64": {"ms": k, "plain_ms": p}
                        for (dt, L), (k, p) in times.items()},
    }]}
    check("jax" not in sys.modules, "the port imported jax")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
