"""On-card smoke test of the PyTorch/CUDA port (seq2squiggle_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: the card's name and power limit, torch and CUDA versions, and
     the kernel build from csrc/ (one nvcc per source, sm_90a) with its time;
  2. fused block vs plain: the hand-written fused FFT-block kernel against
     its plain PyTorch version on the same inputs, at the predict path's
     shapes (1024 x 16 and 1024 x 250, d_model 64) plus a ragged batch of 3,
     in bf16 (<= 4 bf16 ULPs of max|plain|) and f32 (rtol 1e-4, atol 1e-5),
     and the Cauchy–Schwarz underflow input (finite output); median times of
     both with CUDA events after warm-up;
  3. whole predict step: predict_step in f32 on the GPU against the same step
     on the CPU (counts equal on >= 99.9 % of rows, samples within 1 count on
     all but <= 0.1 % of those rows), then the bf16 step through the kernel
     against the bf16 step through the plain blocks, samplers off (counts
     equal, samples within 4 bf16 ULPs of the decoder output in counts, + 1);
  4. predict main path: `simulate_run` on the GPU with the committed R10
     weights, the default bf16 config and batch size 1024, reference mode
     over a synthetic genome made from a fixed seed; the BLOW5 is read back
     and the kernel must have been launched 4 times per batch (and the pair
     kernel never);
  5. attention-core kernels vs plain: forward and backward at the training
     shape (512, 250, 64) and, at batch 3, every length of CORE_LENGTHS (the
     edges of the bf16 kernels' 16-row tiles, and the longest L the f32
     whole-block backward takes), 8 heads, f32 (forward rtol/atol 1e-5,
     gradients rtol 1e-4 / atol 1e-5) and bf16 (forward within 4 bf16 ULPs of
     max|plain|, gradients within 8 of max(1, max|plain|)); the underflow
     input finite in both directions; the backward run twice bit-equal at
     each; a digest of the f32 outputs (to compare two trees: `python3
     chip_smoke.py --core-f32-digest TREE`); median times of each kernel, its
     plain version and F.scaled_dot_product_attention (timed and printed only);
  6. one train step: f32, `pallas_train: core`, dropout on, the same batch,
     parameters and key on the GPU through the kernels and on the CPU
     through the plain versions (loss rtol 1e-4, every gradient leaf rtol
     2e-3 / atol 2e-4); then bf16 on the card, kernels against
     `pallas_train: false` (loss within 1e-2 relative);
  7. train path at `pallas_train: core`: chunk files written from seed 7,
     then the `train` command at full width (bf16, batch 512), one epoch of
     10 steps; core forward launches must be 2 x (train + valid steps) and
     backward launches 2 x train steps, every logged loss finite, the
     checkpoint files present, model.npz validating at the logged loss and
     running one predict_step;
  8. whole-block training kernels vs plain: forward and backward at
     (512, 250, 64) and, at batch 3, every other length of BLOCK_LENGTHS (the
     edges of the bf16 kernels' 16-row slabs), then at batch 64 the longest L
     the backward takes in each dtype (both directions) and the longest the
     forward takes (forward only); 8 heads, with dropout scales (rate 0.2)
     and without, weights from seed 7. f32: forward rtol 1e-4 / atol 1e-5, gx
     rtol 1e-3 / atol 1e-5·max(1, max|plain|), each weight gradient rtol 2e-3
     / atol 1e-4·max(1, max|plain|). bf16: forward within 4 bf16 ULPs of
     max(1, max|plain|), gx within 8, each weight gradient within
     2e-2·max(1, max|plain|). Above 1000 positions a pre-activation within
     rounding of 0 can flip its relu mask between two summation orders, which
     moves that row's gradients by a whole term: there gx may miss its bar on
     <= 1e-4 of its entries and an f32 weight gradient on <= 2 % of a leaf,
     every entry staying within 0.25·max(1, max|plain|) (gx) and
     1e-2·max(1, max|plain|) (weights); at the short shapes every entry meets
     the bar. The underflow input finite in both directions; the backward run
     twice bit-equal; median times of each kernel and its plain version in
     both dtypes, of the backward's six launches one by one, and the peak of
     allocated device memory around one backward call;
  9. one train step at `pallas_train: block`: as phase 6, with block launches
     exactly (2, 2) and no core launch; then bf16 on the card, `auto` (which
     must pick the block rung) against `pallas_train: false`;
 10. train main path: the `train` command with the default config and no
     `pallas_train` override (bf16, batch 512, Adam, warmup_cosine, clip 1.0,
     dropout 0.2), two epochs of 20 steps + 2 validation steps; block forward
     launches must be 2 x (train + valid steps), backward launches 2 x train
     steps and core launches 0, every logged loss finite, the validation loss
     lower at the end than for the initial parameters, the checkpoint files
     present, model.npz loading and running one predict_step, and `--resume`
     running exactly the third epoch;
 11. pair and `packed` vs plain: the two-block kernel against its plain
     version (bars of phase 2) and against two one-block launches (bit-equal)
     at 1024 x 250 and a ragged (3, 37), bf16 and f32, both softmax forms (f32
     at L = 250 does not fit four buffers in shared memory and stages the
     activation between the blocks through the output rows, in the same
     launch); the one-block kernel at `packed=False`, L = 250 and
     `packed=True`, L = 16 against plain; the underflow input finite through
     the pair; median times of the pair, of two one-block launches and of the
     plain version;
 12. profiling variants vs plain: every variant (a, b, c, d) and stage (proj
     ... full) of ops/fft_block_variants.py at (2048, 250, 64) bf16 and a
     ragged (3, 37) f32 against its plain version (bars of phase 2; the
     stages' f32 atol scaled by max(1, max|plain|), their sinks being
     unnormalised sums), c bit-equal to b and b to the fused block's exact
     form; then scripts/profile_torch_block_variants.py's interleaved timing
     (2 rounds), launches counted, the stage differences printed;
 13. predict main path at `pallas_pair: true`: phase 4's run with that knob;
     per batch 2 one-block launches (the encoder) and 1 pair launch, the
     BLOW5 equal record for record to phase 4's; then a small POD5 run (where
     the machine has pyarrow and zstandard, which the POD5 writer needs on the
     host; reported as not made otherwise) and a small R9-profile (k = 6) run
     on the card, each read back.

The line before the last is a JSON object with each kernel's route, source,
launches on its main path, error, times and bound (the least time the card
could take: bytes over 3.35 TB/s against operations over the peak of their
type, 989 TFLOP/s bf16 and 67 TFLOP/s f32, NVIDIA's H100 SXM data sheet);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
R10 = ROOT / "assets" / "bench-weights-R10.npz"
BATCH = 1024  # predict batch (chunks)
TRAIN_BATCH = 512
TRAIN_STEPS = 20  # per epoch on the train main path
CORE_STEPS = 10  # the one epoch of the `pallas_train: core` path
VALID_STEPS = 2
SEED = 7
CORE_LENGTHS = (1, 15, 16, 17, 37, 250, 256, 283)  # phase 5; 250 at the train batch
BLOCK_LENGTHS = (1, 15, 16, 17, 37, 250)  # phase 8; 250 at the train batch

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, dense FLOP/s by type.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


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


def outside(got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float) -> float:
    """The share of entries with |got - ref| > atol + rtol·|ref|."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs() > atol + rtol * ref.abs()).float().mean().item()


def bf16_tol(ref: torch.Tensor) -> float:
    return 4 * 2.0 ** -8 * max(1.0, ref.float().abs().max().item())


def bound(n_bytes: float, flops: float, dtype: torch.dtype):
    """(least ms the card could take, what bounds it) for work that must move
    n_bytes (inputs read once, outputs written once) and do `flops` on dtype."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def fused_block_work(B: int, L: int, dtype: torch.dtype):
    """Bytes and FLOPs of one fused FFT block call: x in, out, the weights
    once; q/k/v/fc (4 x 64x64), scores and e.v (256 L per position), FFN."""
    size = torch.finfo(dtype).bits // 8
    n_bytes = 2 * B * L * 64 * size + (4 * 64 * 64 + 2 * 64 * 256) * size + (6 * 64 + 256) * 4
    flops = B * L * (2 * 4 * 64 * 64 + 256 * L + 2 * 2 * 64 * 256)
    return n_bytes, flops


def core_work(B: int, L: int, dtype: torch.dtype, backward: bool):
    """Bytes and FLOPs of one attention-core call: 4 tensors and two L x L x 8
    products per head forward; 7 tensors and six products backward (scores
    and num recomputed, g_a, gq, gk, gv)."""
    size = torch.finfo(dtype).bits // 8
    tensors, products = (7, 6) if backward else (4, 2)
    return tensors * B * L * 64 * size, products * 2 * B * L * L * 64


def block_train_work(B: int, L: int, dtype: torch.dtype, backward: bool):
    """Bytes and FLOPs of one whole-block training call. Forward: x, s_a, s_f,
    out and the f32 master weights once; the fused block's products. Backward:
    x, g, s_a, s_f, gx, the weights and their gradients; the recompute plus
    two products for every forward product."""
    size = torch.finfo(dtype).bits // 8
    n_weights = 4 * 64 * 64 + 2 * 64 * 256 + 9 * 64 + 256
    forward_flops = fused_block_work(B, L, dtype)[1]
    if backward:
        return 5 * B * L * 64 * size + 2 * n_weights * 4, 3 * forward_flops
    return 4 * B * L * 64 * size + n_weights * 4, forward_flops


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
    kernel = "?"
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_name(line.split("'")[1])
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {kernel}: {line.replace('ptxas info    :', '').strip()}")
    return smi


def _kernel_name(mangled: str) -> str:
    """`name template-arguments` out of a mangled kernel symbol: the name is
    the run of [a-z0-9_] ending in _kernel that its own length precedes."""
    for run in re.finditer(r"\d+", mangled):
        for start in range(run.start(), run.end()):
            end = run.end() + int(mangled[start:run.end()])
            name = mangled[run.end():end]
            if name.endswith("_kernel") and re.fullmatch(r"[a-z0-9_]+", name):
                rest = mangled[end:]
                args = rest[:rest.find("Ev")] if rest.startswith("I") and "Ev" in rest else ""
                return f"{name} {args}".strip()
    return mangled


def underflow_input(gen, L: int = 250) -> torch.Tensor:
    """tests/test_pallas.py:111-137: huge rows along two orthogonal directions,
    so the Cauchy–Schwarz shift overshoots every score by far more than 88."""
    d = torch.zeros(2, 64)
    d[0, ::2] = 1.0
    d[1, 1::2] = 1.0
    x = d[torch.tensor([0, 1] * (L // 2))] * 3e3 + torch.randn(L, 64, generator=gen) * 1e-2
    return x.expand(2, L, 64).contiguous()


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
        out = fused_fft_block(underflow_input(gen).to(dev, dtype), block, 8)
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
    from seq2squiggle_tpu_torch.config import load_config
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


def _predict_run(dev, out_name, n_reads, config=None, weights=R10, **over):
    """One `simulate_run` on the card over the synthetic genome of SEED;
    returns (stats, one-block launches, pair launches, the records read back
    from the output as (read id, signal) pairs)."""
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.ops import fft_block
    from seq2squiggle_tpu_torch.runtime.simulate import simulate_run

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        rng = np.random.default_rng(SEED)
        fasta = pathlib.Path(tmp) / "genome.fasta"
        fasta.write_text(">synthetic\n" + "".join(rng.choice(list("ACGT"), 200_000)) + "\n")
        out = pathlib.Path(tmp) / out_name
        kwargs = dict(
            config=config or load_config(None),  # bf16 compute, use_pallas auto
            saved_weights=str(weights), fasta=str(fasta), read_input=False,
            n=n_reads, r=1000, c=-1, out=str(out), profile="dna-r10-prom",
            dwell_mean=None, dwell_std=0.0, noise_std=2.0, noise_sampling=True,
            duration_sampling=True, distr="expon", predict_batch_size=BATCH,
            export_every_n_samples=1_000_000, seed=SEED, show_progress=False,
            device=dev,
        )
        kwargs.update(over)
        fft_block.launches = fft_block.pair_launches = 0
        stats = simulate_run(**kwargs)
        launches, pair_launches = fft_block.launches, fft_block.pair_launches
        if out_name.endswith(".pod5"):
            from seq2squiggle_tpu_torch.io.pod5_native import read_pod5

            recs = [(r["read_id"], np.asarray(r["signal"])) for r in read_pod5(str(out))["reads"]]
        else:
            from seq2squiggle_tpu_torch.io.slow5 import read_slow5

            recs = [(r["read_id"], np.asarray(r["signal"])) for r in read_slow5(str(out))[1]]
    return stats, launches, pair_launches, recs


def _check_records(what, stats, recs, n_reads):
    check(len(recs) == stats["reads"] >= 0.9 * n_reads,
          f"{what}: {len(recs)} records for {stats['reads']} reads")
    check(all(len(sig) > 0 for _, sig in recs), f"{what}: empty signal")
    check(sum(len(sig) for _, sig in recs) == stats["samples"], f"{what}: sample count")


def phase_main_path(dev, pair: bool):
    """Phases 4 and 13: `simulate_run` at full width with the launch counters
    reset just before and read just after. Returns (one-block launches, pair
    launches, the records read back)."""
    from seq2squiggle_tpu_torch.config import load_config

    n_reads = 100
    what = "main path at pallas_pair: true" if pair else "main path"
    cfg = dict(load_config(None), pallas_pair=True) if pair else None
    stats, launches, pair_launches, recs = _predict_run(dev, "out.blow5", n_reads, cfg)
    n_batches = math.ceil(stats["chunks"] / BATCH)
    _check_records(what, stats, recs, n_reads)
    want = (2 * n_batches, n_batches) if pair else (4 * n_batches, 0)
    check((launches, pair_launches) == want,
          f"{what}: (one-block, pair) launches {(launches, pair_launches)} for {n_batches} "
          f"batches, want {want}")
    log(f"{what}: {stats['reads']} reads, {stats['chunks']} chunks in {n_batches} "
        f"batches, {stats['samples']} samples in {stats['seconds']:.3f} s "
        f"({stats['ksamples_per_s']:.1f} kSamples/s), fused_fft_block launches {launches}, "
        f"fused_fft_block_pair launches {pair_launches}")
    return launches, pair_launches, recs


def phase_other_modes(dev):
    """The tail of phase 13: POD5 output and the R9 (k = 6) profile on the card.
    The POD5 container is written on the host with pyarrow and zstandard; on a
    machine that lacks either, that run is reported as not made (the device
    step under it is the BLOW5 run's; the CPU tests hold the POD5 output
    against the JAX package's)."""
    import importlib.util

    missing = [m for m in ("pyarrow", "zstandard") if importlib.util.find_spec(m) is None]
    for what, out_name, kw in (
            ("POD5 run", "out.pod5", {}),
            ("R9 run", "out.blow5", dict(weights=ROOT / "assets" / "bench-weights-R9.npz",
                                         profile="dna-r9-prom"))):
        if out_name.endswith(".pod5") and missing:
            log(f"{what}: NOT MADE, this machine has no {' and no '.join(missing)} "
                "(host libraries of the POD5 writer)")
            continue
        stats, launches, _, recs = _predict_run(dev, out_name, 20, **kw)
        _check_records(what, stats, recs, 20)
        check(launches == 4 * math.ceil(stats["chunks"] / BATCH), f"{what}: {launches} launches")
        log(f"{what}: {stats['reads']} reads, {stats['samples']} samples read back from "
            f"{out_name}, fused_fft_block launches {launches}")


def phase_pair(params_by_dtype, dev):
    """Phase 11: the pair kernel and the `packed` argument against plain."""
    from seq2squiggle_tpu_torch.ops import fft_block as fb

    gen = torch.Generator().manual_seed(SEED)
    result = {}

    def hold(what, got, ref, dtype):
        err = (got.float() - ref.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        if dtype == torch.bfloat16:
            check(err <= bf16_tol(ref), f"{what}: err {err} > {bf16_tol(ref)}")
        else:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
        return err

    for dtype, params in params_by_dtype.items():
        name = str(dtype)[6:]
        b0, b1 = params["decoder"]["blocks"]
        for B, L in ((3, 37), (BATCH, 250)):
            x = torch.randn(B, L, 64, generator=gen).to(dev, dtype)
            for packed in (False, True):
                what = f"pair {name} {B}x{L} packed={packed}"
                pair = fb.fused_fft_block_pair(x, b0, b1, 8, packed=packed)
                two = fb.fused_fft_block(fb.fused_fft_block(x, b0, 8, packed=packed), b1, 8,
                                         packed=packed)
                torch.cuda.synchronize()
                check(torch.equal(pair, two), f"{what}: not bit-equal to two one-block launches")
                err = hold(what, pair, fb.fused_fft_block_pair_reference(x, b0, b1, 8, packed),
                           dtype)
                msg = f"{what}: bit-equal to two launches, vs plain max|err| {err:.3g}"
                if B == BATCH and packed and dtype == torch.bfloat16:
                    times = {
                        "pair": median_ms(lambda: fb.fused_fft_block_pair(x, b0, b1, 8)),
                        "two_launches": median_ms(lambda: fb.fused_fft_block(
                            fb.fused_fft_block(x, b0, 8), b1, 8)),
                        "plain": median_ms(
                            lambda: fb.fused_fft_block_pair_reference(x, b0, b1, 8)),
                        "one_block_exact": median_ms(
                            lambda: fb.fused_fft_block(x, b0, 8, packed=False)),
                        "one_block_shift": median_ms(lambda: fb.fused_fft_block(x, b0, 8)),
                    }
                    result = dict(times, err=err)
                    msg += "; ms " + ", ".join(f"{k} {t:.3f}" for k, t in times.items())
                log(msg)
        for B, L, packed in ((BATCH, 250, False), (BATCH, 16, True), (3, 250, False),
                             (3, 16, True)):
            x = torch.randn(B, L, 64, generator=gen).to(dev, dtype)
            err = hold(f"packed={packed} {name} {B}x{L}", fb.fused_fft_block(x, b0, 8, packed),
                       fb.fused_fft_block_reference(x, b0, 8, packed), dtype)
            log(f"one block {name} B={B:4d} L={L:3d} packed={packed}: vs plain max|err| {err:.3g}")
        out = fb.fused_fft_block_pair(underflow_input(gen).to(dev, dtype), b0, b1, 8, packed=True)
        check(bool(torch.isfinite(out).all()), f"pair: underflow input gave non-finite {name}")
        log(f"pair underflow input {name}: finite")
    return result


def phase_variants(params_by_dtype, dev):
    """Phase 12: the profiling variants against plain, then the timing script."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import profile_torch_block_variants as script

    from seq2squiggle_tpu_torch.ops import fft_block as fb
    from seq2squiggle_tpu_torch.ops import fft_block_variants as tv

    gen = torch.Generator().manual_seed(SEED)
    calls = ([("abc", v, tv.fused_abc, tv.fused_abc_reference) for v in tv.ABC_VARIANTS]
             + [("d", v, tv.fused_d, tv.fused_d_reference) for v in tv.D_VARIANTS]
             + [("parts", st, tv.fused_parts, tv.fused_parts_reference) for st in tv.STAGES])
    worst = {"abc": 0.0, "d": 0.0, "parts": 0.0}
    times = {}
    for dtype, (B, L) in ((torch.float32, (3, 37)), (torch.bfloat16, (2048, 250))):
        name = str(dtype)[6:]
        block = params_by_dtype[dtype]["decoder"]["blocks"][0]
        x = (torch.randn(B, L, 64, generator=gen) * 0.5).to(dev, dtype)
        b = tv.fused_abc(x, block, 8, "b")
        check(torch.equal(tv.fused_abc(x, block, 8, "c"), b), f"variant c != b ({name})")
        check(torch.equal(fb.fused_fft_block(x, block, 8, packed=False), b),
              f"variant b != the fused block's exact form ({name})")
        errs = []
        for group, choice, fn, ref_fn in calls:
            got, ref = fn(x, block, 8, choice), ref_fn(x, block, 8, choice)
            torch.cuda.synchronize()
            what = f"fused_{group} {choice} {name} {B}x{L}"
            err = (got.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
            if dtype == torch.bfloat16:
                check(err <= 4 * 2.0 ** -8 * scale, f"{what}: err {err}")
                worst[group] = max(worst[group], err)
            else:
                partial = group == "parts" and choice != "full"
                torch.testing.assert_close(got, ref, rtol=1e-4,
                                           atol=1e-5 * (scale if partial else 1.0))
            errs.append(f"{choice} {err:.3g}")
            if dtype == torch.bfloat16 and (group, choice) in (("abc", "b"), ("d", "d"),
                                                                ("parts", "full")):
                times[group] = (median_ms(lambda: fn(x, block, 8, choice)),
                                median_ms(lambda: ref_fn(x, block, 8, choice), iters=5))
            del got, ref
        log(f"variants vs plain {name} {B}x{L}: c bit-equal to b, b to the fused block's exact "
            f"form; max|err| " + ", ".join(errs))
    tv.launches_abc = tv.launches_d = tv.launches_parts = 0
    prof = script.profile(rounds=2)
    launches = {"abc": tv.launches_abc, "d": tv.launches_d, "parts": tv.launches_parts}
    check(all(n > 0 for n in launches.values()), f"variant launches {launches}")
    log("variants, ms per block at (2048, 250, 64) bf16, min of 2 interleaved rounds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in prof["ms"].items()))
    log("stage differences, ms: "
        + ", ".join(f"{k} +{v:.3f}" for k, v in prof["stage_delta_ms"].items()))
    return {g: {"launches": launches[g], "err": worst[g], "ms": times[g][0],
                "plain_ms": times[g][1]} for g in worst}, prof


def core_f32_digest(dev) -> str:
    """sha256 over the f32 attention-core kernels' outputs (forward, then gq,
    gk, gv) at (3, 37, 64) and (512, 250, 64) on inputs from SEED: two trees
    whose f32 kernels agree bit for bit print the same digest."""
    import hashlib

    from seq2squiggle_tpu_torch.ops import attn_core as ac

    gen = torch.Generator().manual_seed(SEED)
    digest = hashlib.sha256()
    for B, L in ((3, 37), (TRAIN_BATCH, 250)):
        q, k, v, g = (torch.randn(B, L, 64, generator=gen).to(dev) for _ in range(4))
        outs = (ac.packed_attention_core_forward(q, k, v, 8),
                *ac.packed_attention_core_backward(q, k, v, g, 8))
        for t in outs:
            digest.update(t.cpu().numpy().tobytes())
    return digest.hexdigest()


def phase_core_kernels(dev):
    """Phase 5: the attention-core kernels against their plain versions."""
    import torch.nn.functional as F

    from seq2squiggle_tpu_torch.ops import attn_core as ac

    gen = torch.Generator().manual_seed(SEED)
    result = {}
    log(f"core kernels f32 digest at (3, 37) and ({TRAIN_BATCH}, 250): {core_f32_digest(dev)}")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for B, L in ((TRAIN_BATCH if L == 250 else 3, L) for L in CORE_LENGTHS):
            q, k, v, g = (torch.randn(B, L, 64, generator=gen).to(dev, dtype) for _ in range(4))
            out = ac.packed_attention_core_forward(q, k, v, 8)
            grads = ac.packed_attention_core_backward(q, k, v, g, 8)
            again = ac.packed_attention_core_backward(q, k, v, g, 8)
            torch.cuda.synchronize()
            ref = ac.packed_attention_core_reference(q, k, v, 8)
            refs = ac.packed_attention_core_backward_reference(q, k, v, g, 8)
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"core backward {name} {B}x{L}: two runs differ")
            f_err = (out.float() - ref.float()).abs().max().item()
            b_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(grads, refs))
            if dtype == torch.float32:
                torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
                for a, b in zip(grads, refs):
                    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
            else:
                tol = 4 * 2.0 ** -8 * ref.float().abs().max().item()
                check(f_err <= tol, f"core forward bf16 {B}x{L}: err {f_err} > {tol}")
                for n, a, b in zip("qkv", grads, refs):
                    err = (a.float() - b.float()).abs().max().item()
                    check(err <= 2 * bf16_tol(b), f"core g{n} bf16 {B}x{L}: err {err}")
            msg = (f"core kernels vs plain {name:8s} B={B:4d} L={L:3d}: forward max|err| "
                   f"{f_err:.3g}, gradients max|err| {b_err:.3g}, backward bit-equal twice")
            if B == TRAIN_BATCH:
                def heads(t):
                    return t.view(B, L, 8, 8).transpose(1, 2)

                qh, kh, vh = (heads(t).detach().requires_grad_() for t in (q, k, v))
                sdpa = F.scaled_dot_product_attention(qh, kh, vh)
                times = {
                    "fwd": median_ms(lambda: ac.packed_attention_core_forward(q, k, v, 8)),
                    "fwd_plain": median_ms(
                        lambda: ac.packed_attention_core_reference(q, k, v, 8)),
                    "fwd_library": median_ms(
                        lambda: F.scaled_dot_product_attention(qh, kh, vh)),
                    "bwd": median_ms(lambda: ac.packed_attention_core_backward(q, k, v, g, 8)),
                    "bwd_plain": median_ms(
                        lambda: ac.packed_attention_core_backward_reference(q, k, v, g, 8)),
                    "bwd_library": median_ms(lambda: torch.autograd.grad(
                        sdpa, (qh, kh, vh), heads(g), retain_graph=True)),
                    "fwd_bwd_library": median_ms(lambda: torch.autograd.grad(
                        F.scaled_dot_product_attention(qh, kh, vh), (qh, kh, vh), heads(g))),
                }
                result[dtype] = dict(times, fwd_err=f_err, bwd_err=b_err)
                msg += "; ms " + ", ".join(f"{k} {t:.3f}" for k, t in times.items())
            log(msg)
            del ref, refs
        x = underflow_input(gen).to(dev, dtype)
        out = ac.packed_attention_core_forward(x, x, x, 8)
        grads = ac.packed_attention_core_backward(x, x, x, torch.ones_like(x), 8)
        check(bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(t).all())
                                                     for t in grads),
              f"core kernels: underflow input gave non-finite values ({name})")
        log(f"core underflow input {name}: forward and gradients finite")
    return result


def phase_block_kernels(dev):
    """Phase 8: the whole-block training kernels against their plain versions."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.ops import block_train as bt

    from seq2squiggle_tpu_torch.ops import _build

    block = fft_model.init_params(load_config(None), prng.key(SEED))["decoder"]["blocks"][0]
    weights = [w.to(dev).contiguous() for w in bt.block_weights(block)]
    gen = torch.Generator().manual_seed(SEED)
    result = {}
    ulp = 2.0 ** -8

    def ceiling(dtype, backward):
        fits = 250
        while bt.shared_memory_bytes(fits + 1, dtype, backward) <= _build.SHARED_MEMORY_MAX:
            fits += 1
        return fits

    def hold(dtype, B, L, scales, x, g, backward):
        """One shape, with or without dropout scales, against the plain versions."""
        name = str(dtype)[6:]
        what = (f"block kernels {name} {B}x{L} dropout "
                f"{'on' if scales[0] is not None else 'off'}")
        out = bt.fused_block_train_forward(x, weights, *scales, 8)
        torch.cuda.synchronize()
        ref = bt.fused_block_train_reference(x, weights, *scales, 8)
        check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
        f_err = (out.float() - ref.float()).abs().max().item()
        f_max = max(1.0, ref.float().abs().max().item())
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
        else:
            check(f_err <= 4 * ulp * f_max, f"{what}: forward err {f_err}")
        if not backward:
            log(f"{what}: forward max|err| {f_err:.3g} (forward only: past the backward's "
                "ceiling)")
            return f_err, None
        gx, gws = bt.fused_block_train_backward(x, weights, *scales, g, 8)
        gx2, gws2 = bt.fused_block_train_backward(x, weights, *scales, g, 8)
        torch.cuda.synchronize()
        rx, rws = bt.fused_block_train_backward_reference(x, weights, *scales, g, 8)
        check(torch.equal(gx, gx2) and all(torch.equal(a, b) for a, b in zip(gws, gws2)),
              f"{what}: two backward runs differ")
        x_max = max(1.0, rx.float().abs().max().item())
        x_err = (gx.float() - rx.float()).abs().max().item()
        # per weight gradient: error as a share of max(1, max|plain|)
        w_errs = [(a - b).abs().max().item() / max(1.0, b.abs().max().item())
                  for a, b in zip(gws, rws)]
        w_err = max(w_errs)
        worst = "/".join(bt.WEIGHT_FIELDS[w_errs.index(w_err)])
        # A pre-activation that lands on the other side of 0 flips its relu
        # mask, and that row's gradients move by a whole term: a few rows in
        # 128,000 do (scripts/profile_torch_block_train.py --relu-flips counts
        # them), none in 111. So above 1000 positions a small share of entries
        # may miss the tight bar, and every entry meets a loose one.
        flips = B * L > 1000
        if dtype == torch.float32:
            x_out = outside(gx, rx, 1e-3, 1e-5 * x_max)
            w_out = max(outside(a, b, 2e-3, 1e-4 * max(1.0, b.abs().max().item()))
                        for a, b in zip(gws, rws))
            check(w_out <= (2e-2 if flips else 0.0) and w_err <= 1e-2,
                  f"{what}: weight gradients outside the tight bar on up to {w_out:.2e} "
                  f"of a leaf, {worst} off by {w_err} of max(1, max|plain|)")
        else:
            x_out = outside(gx, rx, 0.0, 8 * ulp * x_max)
            w_out = 0.0
            check(w_err <= 2e-2, f"{what}: {worst} off by {w_err} of max(1, max|plain|)")
        check(x_out <= (1e-4 if flips else 0.0) and x_err <= 0.25 * x_max,
              f"{what}: gx outside its bar on {x_out:.2e} of the entries, max|err| {x_err}")
        log(f"{what}: forward max|err| {f_err:.3g}; gx max|err| {x_err:.3g} of max|gx| "
            f"{rx.float().abs().max().item():.3g}, outside the tight bar {x_out:.2e}; "
            f"weight gradients max|err|/max(1, max|plain|) {w_err:.3g} ({worst}), "
            f"outside the tight bar {w_out:.2e}; backward bit-equal twice")
        return f_err, x_err

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        top_bwd, top_fwd = ceiling(dtype, True), ceiling(dtype, False)
        shapes = [(TRAIN_BATCH if L == 250 else 3, L, True) for L in BLOCK_LENGTHS]
        shapes += [(64, top_bwd, True)] + ([(64, top_fwd, False)] if top_fwd > top_bwd else [])
        log(f"block kernels {name}: the longest L that fits is {top_fwd} forward, "
            f"{top_bwd} backward")
        for B, L, backward in shapes:
            x, g = (torch.randn(B, L, 64, generator=gen).to(dev, dtype) for _ in range(2))
            drawn = [bt.make_dropout_scales(k, 0.2, x.shape, dtype)
                     for k in prng.split(prng.key(B, dev))]
            f_err, x_err = [hold(dtype, B, L, scales, x, g, backward)
                            for scales in (drawn, [None, None])][0]  # kept: dropout on
            if B != TRAIN_BATCH:
                continue
            times = {
                "fwd": median_ms(lambda: bt.fused_block_train_forward(x, weights, *drawn, 8)),
                "fwd_plain": median_ms(
                    lambda: bt.fused_block_train_reference(x, weights, *drawn, 8)),
                "bwd": median_ms(
                    lambda: bt.fused_block_train_backward(x, weights, *drawn, g, 8)),
                "bwd_plain": median_ms(lambda: bt.fused_block_train_backward_reference(
                    x, weights, *drawn, g, 8)),
            }
            result[dtype] = dict(times, fwd_err=f_err, bwd_err=x_err)
            log(f"block kernels {name} {B}x{L} dropout on, ms: "
                + ", ".join(f"{k} {t:.3f}" for k, t in times.items()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            stages = {}
            bt._launch_bwd(x, weights, *drawn, g, 8, stage_launchers=stages)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            log(f"block backward {name} {B}x{L}, its six launches one by one, ms: "
                + ", ".join(f"{k} {median_ms(fn):.3f}" for k, fn in stages.items())
                + f"; device memory allocated {before / 2**20:.0f} MiB before the call, peak "
                f"{peak / 2**20:.0f} MiB during it")
            del stages
        x = underflow_input(gen).to(dev, dtype)
        out = bt.fused_block_train_forward(x, weights, None, None, 8)
        gx, gws = bt.fused_block_train_backward(x, weights, None, None, torch.ones_like(x), 8)
        check(all(bool(torch.isfinite(t).all()) for t in (out, gx, *gws)),
              f"block kernels: underflow input gave non-finite values ({name})")
        log(f"block underflow input {name}: output and all 17 gradients finite")
    return result


def _train_batch(cfg, B, seed):
    """One training batch as train/data.py serves it, from a numpy seed."""
    rng = np.random.default_rng(seed)
    K, T = cfg["max_dna_len"], cfg["max_signal_len"]
    chunks, targets, lengths, stdevs = make_chunks(rng, B, cfg)
    scale = cfg["scaling_max_value"]
    batch = {"chunks": chunks.astype(np.float32), "targets": (targets / scale)[..., None],
             "chunks_lengths": lengths.astype(np.int32), "stdevs": stdevs / scale}
    assert batch["chunks"].shape[:2] == (B, K) and batch["targets"].shape == (B, T, 1)
    return {k: torch.from_numpy(v) for k, v in batch.items()}, torch.ones(B)


def make_chunks(rng, n, cfg):
    """Synthetic training chunks a model can learn: each k-mer's level is a
    fixed linear function of its one-hot, held for its dwell and blurred by
    noise of its own stdev. Returns (one-hot (n, K, k*5) f16, targets (n, T)
    f32 in pA, dwells (n, K) i16, stdevs (n, K) f32)."""
    K, k, T = cfg["max_dna_len"], cfg["seq_kmer"], cfg["max_signal_len"]
    table = np.random.default_rng(SEED).standard_normal(k * 5).astype(np.float32)
    table -= table.mean()  # levels centred on 90 pA
    codes = rng.integers(0, 4, (n, K, k))
    one_hot = np.eye(5, dtype=np.float16)[codes].reshape(n, K, k * 5)
    level = 90.0 + 12.0 * (one_hot.astype(np.float32) @ table)  # (n, K) pA
    dwell = rng.integers(4, 24, (n, K)).astype(np.int16)
    stdev = (1.0 + 2.0 * rng.random((n, K))).astype(np.float32)
    ends = np.minimum(np.cumsum(dwell, axis=1), T)
    seg = (np.arange(T)[None, :, None] >= ends[:, None, :]).sum(-1)  # (n, T) in [0, K]
    pad = np.concatenate([level, np.zeros((n, 1), np.float32)], axis=1)
    pad_sd = np.concatenate([stdev, np.zeros((n, 1), np.float32)], axis=1)
    rows = np.arange(n)[:, None]
    targets = pad[rows, seg] + pad_sd[rows, seg] * rng.standard_normal((n, T)).astype(np.float32)
    return one_hot, targets.astype(np.float32), dwell, stdev


def _launch_counts():
    """(block forward, block backward, core forward, core backward) launches."""
    from seq2squiggle_tpu_torch.ops import attn_core as ac
    from seq2squiggle_tpu_torch.ops import block_train as bt

    return (bt.launches_fwd, bt.launches_bwd, ac.launches_fwd, ac.launches_bwd)


def _reset_launch_counts():
    from seq2squiggle_tpu_torch.ops import attn_core as ac
    from seq2squiggle_tpu_torch.ops import block_train as bt

    bt.launches_fwd = bt.launches_bwd = ac.launches_fwd = ac.launches_bwd = 0


def phase_train_step(dev, mode, bf16_mode):
    """Phases 6 and 9: one whole train step at `pallas_train: mode`, kernels
    against plain versions; then bf16 on the card at `bf16_mode` against
    `pallas_train: false`."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.train.loop import loss_fn

    base = dict(load_config(None), pallas_train=mode)
    host = fft_model.init_params(base, prng.key(SEED))
    cpu = torch.device("cpu")
    want = (2, 2, 0, 0) if mode == "block" else (0, 0, 2, 2)  # the decoder's two blocks

    def loss_and_grads(cfg, device, batch, mask):
        params = fft_model.to_train_params(host, device)
        paths, leaves = zip(*fft_model.tree_leaves(params))
        _reset_launch_counts()
        loss, _ = loss_fn(params, {k: v.to(device) for k, v in batch.items()},
                          mask.to(device), cfg, prng.key(9, device))
        grads = torch.autograd.grad(loss, leaves)
        return loss.item(), paths, [g.cpu() for g in grads]

    cfg32 = dict(base, compute_dtype="float32")
    batch, mask = _train_batch(cfg32, 64, seed=1)
    g_loss, paths, g_grads = loss_and_grads(cfg32, dev, batch, mask)
    check(_launch_counts() == want, f"f32 train step at {mode}: launches (block forward, "
          f"block backward, core forward, core backward) {_launch_counts()}, want {want}")
    c_loss, _, c_grads = loss_and_grads(cfg32, cpu, batch, mask)
    check(abs(g_loss - c_loss) <= 1e-4 * abs(c_loss), f"f32 step loss {g_loss} vs {c_loss}")
    worst = 0.0
    for path, a, b in zip(paths, g_grads, c_grads):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4, msg=lambda m: f"{path}: {m}")
        worst = max(worst, (a - b).abs().max().item())
    log(f"f32 train step at {mode}, GPU kernels vs CPU plain: loss {g_loss:.6f} vs "
        f"{c_loss:.6f}, {len(paths)} gradient leaves within rtol 2e-3 / atol 2e-4 "
        f"(max|Δ| {worst:.3g}); launches {want}")

    base16 = dict(base, pallas_train=bf16_mode)
    batch, mask = _train_batch(base16, TRAIN_BATCH, seed=2)
    k_loss, _, _ = loss_and_grads(base16, dev, batch, mask)
    check(_launch_counts() == want,
          f"bf16 train step at {bf16_mode}: launches {_launch_counts()}, want {want}")
    p_loss, _, _ = loss_and_grads(dict(base, pallas_train=False), dev, batch, mask)
    check(_launch_counts() == (0, 0, 0, 0), "pallas_train: false launched a training kernel")
    check(abs(k_loss - p_loss) <= 1e-2 * abs(p_loss), f"bf16 step loss {k_loss} vs {p_loss}")
    log(f"bf16 train step at {bf16_mode} vs plain blocks: loss {k_loss:.6f} vs {p_loss:.6f}")


def _write_chunk_dir(path: pathlib.Path, rng, n_files: int, per_file: int, cfg) -> None:
    path.mkdir(parents=True)
    for i in range(n_files):
        one_hot, targets, dwell, stdev = make_chunks(rng, per_file, cfg)
        arrays = {"chunks": one_hot, "targets": targets, "chunks_lengths": dwell,
                  "targets_lengths": np.minimum(dwell.sum(1), cfg["max_signal_len"])
                  .astype(np.int16), "stdevs": stdev}
        for name, arr in arrays.items():
            np.save(path / f"{name}-{i:04d}.npy", arr)


def phase_train_main_path(dev, mode, epochs, steps, resume):
    """Phases 7 and 10: the `train` command at full width, launches counted.
    mode: the `pallas_train` override, or None for the default config (which
    takes the block rung in bf16 on a GPU). Returns the run's launch counts."""
    import yaml

    from seq2squiggle_tpu_torch import cli, prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.models.weights import load_checkpoint
    from seq2squiggle_tpu_torch.runtime.predict import PredictKnobs
    from seq2squiggle_tpu_torch.train.data import ChunkDataset, epoch_batches, load_file_groups
    from seq2squiggle_tpu_torch.train.loop import load_train_state, make_valid_step

    over = {"max_epochs": epochs, "train_batch_size": TRAIN_BATCH}
    if mode is not None:
        over["pallas_train"] = mode
    cfg = dict(load_config(None), **over)  # bf16 compute, Adam, warmup_cosine, clip 1.0
    name = f"pallas_train: {cfg['pallas_train']}"
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = pathlib.Path(tmp)
        rng = np.random.default_rng(SEED)
        _write_chunk_dir(tmp / "train", rng, 4, steps * TRAIN_BATCH // 4, cfg)
        _write_chunk_dir(tmp / "valid", rng, 1, VALID_STEPS * TRAIN_BATCH, cfg)
        (tmp / "cfg.yaml").write_text(yaml.safe_dump(over))
        (tmp / "cfg_more.yaml").write_text(yaml.safe_dump(dict(over, max_epochs=epochs + 1)))
        model = tmp / "ckpt" / "model.npz"

        def valid_loss(host_params):
            params = fft_model.to_train_params(host_params, dev)
            _, files = load_file_groups(str(tmp / "train"), str(tmp / "valid"), 0.9, SEED)
            ds = ChunkDataset(files, cfg["max_chunks_valid"], cfg)
            step, total, n = make_valid_step(cfg), 0.0, 0
            for batch, mask in epoch_batches(ds, TRAIN_BATCH, rng, shuffle=False, prefetch=0):
                batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
                total += step(params, batch, torch.from_numpy(mask).to(dev))["total_loss"].item()
                n += 1
            check(n == VALID_STEPS, f"{n} validation batches, want {VALID_STEPS}")
            return total / n

        loss0 = valid_loss(fft_model.init_params(cfg, prng.key(SEED)))

        args = ["train", str(tmp / "train"), str(tmp / "valid"), "-m", str(model),
                "-s", str(SEED), "-v", "warning"]
        _reset_launch_counts()
        t0 = time.perf_counter()
        cli.main([*args, "-y", str(tmp / "cfg.yaml")], standalone_mode=False)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts()

        n_train, n_valid = epochs * steps, epochs * VALID_STEPS
        ran = (2 * (n_train + n_valid), 2 * n_train)
        want = (0, 0, *ran) if mode == "core" else (*ran, 0, 0)
        check(counts == want,
              f"{name}: launches (block forward, block backward, core forward, core backward) "
              f"{counts} for {n_train} train and {n_valid} valid steps, want {want}")
        last = epochs - 1
        for file in ("model.npz", f"model-epoch{last}.npz", "train_state.npz", "metrics.jsonl"):
            check((tmp / "ckpt" / file).exists(), f"{name}: {file} missing")
        rows = [json.loads(line) for line in open(tmp / "ckpt" / "metrics.jsonl")]
        losses = [v for r in rows for k, v in r.items() if k.endswith("_loss")]
        check(len(losses) >= 4 * epochs and all(math.isfinite(v) for v in losses),
              f"{name}: logged losses {losses}")
        logged = [r["valid_total_loss"] for r in rows if "valid_total_loss" in r]

        host_params, ckpt_cfg = load_checkpoint(str(model))
        loss1 = valid_loss(host_params)
        check(abs(loss1 - logged[-1]) <= 1e-3 * abs(loss1),
              f"model.npz validates at {loss1}, the run logged {logged[-1]}")
        if resume:  # the run that is long enough to have learnt something
            check(loss1 < loss0, f"validation loss did not fall: {loss0} -> {loss1}")
        signal, n_samples = _step(fft_model.to_device(host_params, dev, torch.bfloat16),
                                  _batch(BATCH, 3), dev, ckpt_cfg,
                                  PredictKnobs(dwell_mean=10.0))
        check(signal.shape == (BATCH, 250) and n_samples.shape == (BATCH,)
              and (n_samples >= 0).all() and n_samples.max() > 0,
              "trained checkpoint: predict_step output")

        check(load_train_state(str(tmp / "ckpt" / "train_state.npz"))["epoch"] == last,
              f"train_state.npz does not record epoch {last}")
        if resume:
            _reset_launch_counts()
            cli.main([*args, "-y", str(tmp / "cfg_more.yaml"), "--resume"],
                     standalone_mode=False)
            check(load_train_state(str(tmp / "ckpt" / "train_state.npz"))["epoch"] == epochs
                  and (tmp / "ckpt" / f"model-epoch{epochs}.npz").exists()
                  and _launch_counts()[1] == 2 * steps,
                  f"--resume did not run exactly epoch {epochs} "
                  f"({_launch_counts()[1]} backward launches)")
    log(f"train path at {name}: {n_train} train + {n_valid} valid steps of {TRAIN_BATCH} "
        f"chunks in {seconds:.3f} s ({n_train / seconds:.2f} steps/s, "
        f"{n_train * TRAIN_BATCH / seconds:.0f} chunks/s, wall time of the whole command "
        f"with data loading, validation and checkpoints); validation loss {loss0:.5f} -> "
        f"{loss1:.5f}; launches (block forward, block backward, core forward, core backward) "
        f"{counts}" + (f"; --resume ran epoch {epochs}" if resume else ""))
    return counts


def main() -> int:
    if not (ROOT / "seq2squiggle_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    if len(sys.argv) == 3 and sys.argv[1] == "--core-f32-digest":
        # the port as it is in another tree (its kernels build there), this script's inputs
        sys.path.insert(0, str(pathlib.Path(sys.argv[2]).resolve()))
        print(core_f32_digest(torch.device("cuda")))
        return 0
    sys.path.insert(0, str(ROOT))
    from seq2squiggle_tpu_torch.device import resolve_device
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.models.weights import load_checkpoint

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    smi = phase_device()
    host_params, _ = load_checkpoint(str(R10))
    params = {dt: fft_model.to_device(host_params, dev, dt)
              for dt in (torch.bfloat16, torch.float32)}
    worst_bf16, times = phase_kernel(params, dev)
    phase_step(host_params, dev)
    launches, _, recs = phase_main_path(dev, pair=False)
    core = phase_core_kernels(dev)[torch.bfloat16]
    phase_train_step(dev, "core", "core")
    _, _, core_fwd_launches, core_bwd_launches = phase_train_main_path(
        dev, "core", epochs=1, steps=CORE_STEPS, resume=False)
    block = phase_block_kernels(dev)[torch.bfloat16]
    phase_train_step(dev, "block", "auto")
    block_fwd_launches, block_bwd_launches, _, _ = phase_train_main_path(
        dev, None, epochs=2, steps=TRAIN_STEPS, resume=True)
    pair = phase_pair(params, dev)
    variants, variant_profile = phase_variants(params, dev)
    _, pair_launches, pair_recs = phase_main_path(dev, pair=True)
    check(len(pair_recs) == len(recs)
          and all(a[0] == b[0] and np.array_equal(a[1], b[1]) for a, b in zip(recs, pair_recs)),
          "pallas_pair: true wrote other records than pallas_pair: false")
    log(f"main path at pallas_pair: true: {len(pair_recs)} records equal to phase 4's")
    phase_other_modes(dev)

    # per predict batch the path runs the fused block twice at L=16 and twice at L=250
    bf16 = torch.bfloat16
    k_ms = 2 * (times[(bf16, 16)][0] + times[(bf16, 250)][0])
    p_ms = 2 * (times[(bf16, 16)][1] + times[(bf16, 250)][1])
    fused_bound = [bound(*fused_block_work(BATCH, L, bf16), bf16) for L in (16, 250)]

    def entry(name, source, replaces, launches, got, direction, work):
        bound_ms, bound_by = bound(*work(TRAIN_BATCH, 250, bf16, direction == "bwd"), bf16)
        return {"name": name, "route": "cuda",
                "source": f"seq2squiggle_tpu_torch/csrc/{source}",
                "replaces": f"seq2squiggle_tpu/ops/pallas/{replaces}", "launches": launches,
                "max_abs_err": got[f"{direction}_err"], "ms": got[direction],
                "plain_ms": got[f"{direction}_plain"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": got.get(f"{direction}_library")}

    pair_bound = bound(2 * BATCH * 250 * 64 * 2 + 2 * fused_block_work(0, 250, bf16)[0],
                       2 * fused_block_work(BATCH, 250, bf16)[1], bf16)
    variant_bound = bound(*fused_block_work(2048, 250, bf16), bf16)

    def variant_entry(group, replaces, names):
        got = variants[group]
        return {"ms_per_block_interleaved": {n: variant_profile["ms"][n] for n in names},
                "name": f"fused_{group}", "route": "cuda",
                "source": "seq2squiggle_tpu_torch/csrc/fft_block_variants.cu",
                "replaces": f"scripts/profiling/{replaces}", "launches": got["launches"],
                "max_abs_err": got["err"], "ms": got["ms"], "plain_ms": got["plain_ms"],
                "bound_ms": variant_bound[0], "bound_by": variant_bound[1], "library_ms": None}

    kernels = {"kernels": [{
        "name": "fused_fft_block",
        "route": "cuda",
        "source": "seq2squiggle_tpu_torch/csrc/fft_block.cu",
        "replaces": "seq2squiggle_tpu/ops/pallas/fft_block.py:403",
        "launches": launches,
        "max_abs_err": worst_bf16,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": 2 * sum(b for b, _ in fused_bound),
        "bound_by": fused_bound[1][1],
        "library_ms": None,
        "ms_by_shape": {f"{str(dt)[6:]} {BATCH}x{L}x64": {"ms": k, "plain_ms": p}
                        for (dt, L), (k, p) in times.items()},
    },
        entry("packed_attention_core_fwd", "attn_core.cu", "attn_core.py:184",
              core_fwd_launches, core, "fwd", core_work),
        entry("packed_attention_core_bwd", "attn_core.cu", "attn_core.py:205",
              core_bwd_launches, core, "bwd", core_work),
        entry("fused_block_train_fwd", "block_train.cu", "block_train.py:304",
              block_fwd_launches, block, "fwd", block_train_work),
        entry("fused_block_train_bwd", "block_train.cu", "block_train.py:335",
              block_bwd_launches, block, "bwd", block_train_work),
        {"name": "fused_fft_block_pair", "route": "cuda",
         "source": "seq2squiggle_tpu_torch/csrc/fft_block.cu",
         "replaces": "seq2squiggle_tpu/ops/pallas/fft_block.py:466", "launches": pair_launches,
         "max_abs_err": pair["err"], "ms": pair["pair"], "plain_ms": pair["plain"],
         "bound_ms": pair_bound[0], "bound_by": pair_bound[1], "library_ms": None,
         "two_launches_ms": pair["two_launches"]},
        variant_entry("abc", "profile_abc.py:130", ("a", "b", "c")),
        variant_entry("d", "profile_d.py:95", ("b", "d", "block exact", "block shift")),
        dict(variant_entry("parts", "profile_parts2.py:109", variant_profile["stage_delta_ms"]),
             stage_delta_ms=variant_profile["stage_delta_ms"]),
    ]}
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "seq2squiggle_tpu"))
    check(not loaded, f"the port imported {loaded}")
    log(f"chip_smoke.py: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
