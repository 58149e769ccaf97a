"""On-card smoke test of the PyTorch/CUDA port (seq2squiggle_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: the card's name and power limit, torch and CUDA versions, and
     the kernel build from csrc/ (one nvcc per source, sm_90a) with its time,
     beside it the wire decoders' C++ codec (io/native, g++);
  2. fused block vs plain: the hand-written fused FFT-block kernel against
     its plain PyTorch version on the same inputs, at the predict path's
     shapes (1024 x 16 and 1024 x 250, d_model 64), at batch 3 at L = 16,
     250 and the slab edges of EDGE_LENGTHS in both softmax forms, and at
     batch 16 at each dtype's ceiling (bf16 464, f32 291), in bf16 (<= 4 bf16
     ULPs of max(1, max|plain|)) and f32 (rtol 1e-4, atol 1e-5), and the
     Cauchy–Schwarz underflow input (finite output); median times of both
     with CUDA events after warm-up; sha256 digests of the fused block and
     pair outputs in f32 and bf16, of the bf16 whole-block training kernels'
     outputs and of the f32 attention-core kernels' (to compare two trees:
     `python3 chip_smoke.py --digests TREE`);
  3. whole predict step: predict_step in f32 on the GPU against the same step
     on the CPU (counts equal on >= 99.9 % of rows, samples within 1 count on
     all but <= 0.1 % of those rows), then the bf16 step through the kernel
     against the bf16 step through the plain blocks, samplers off (counts
     equal, samples within 4 bf16 ULPs of the decoder output in counts, + 1);
  4. predict main path: `simulate_run` on the GPU with the committed R10
     weights, the default bf16 config and batch size 1024, reference mode
     over a synthetic genome made from a fixed seed, at the default
     --wire-format auto (the ULP tier in bf16); the BLOW5 is read back
     and the kernel must have been launched 4 times per batch (and the pair
     kernel never);
  5. attention-core kernels vs plain: forward and backward at the training
     shape (512, 250, 64) and, at batch 3, every length of CORE_LENGTHS (the
     edges of the bf16 kernels' 16-row tiles, and the longest L the f32
     whole-block backward takes), 8 heads, f32 (forward rtol/atol 1e-5,
     gradients rtol 1e-4 / atol 1e-5) and bf16 (forward within 4 bf16 ULPs of
     max|plain|, gradients within 8 of max(1, max|plain|)); the underflow
     input finite in both directions; the backward run twice bit-equal at
     each; a digest of the f32 outputs (also one of phase 2's digests);
     median times of each kernel, its
     plain version and F.scaled_dot_product_attention (timed and printed only);
  6. one train step: f32, `pallas_train: core`, dropout on, the same batch,
     parameters and key on the GPU through the kernels and on the CPU
     through the plain versions (loss rtol 1e-4, every gradient leaf rtol
     2e-3 / atol 2e-4); then bf16 on the card, kernels against
     `pallas_train: false` (loss within 1e-2 relative);
  7. train path at `pallas_train: core`: chunk files written from seed 7,
     then the `train` command at full width (bf16, batch 512), one epoch of
     10 steps (--save_valid_plots false: phase 10 makes the plots); core
     launches 2 forward and 2 backward a step (counted as the note after
     phase 20 says) and 2 forward a validation step, every logged loss finite, the
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
     dropout 0.2), two epochs of 20 steps + 2 validation steps; block
     launches 2 forward and 2 backward a step (the note after phase 20) and 2
     forward a validation step, core launches 0, every logged loss finite, the validation loss
     lower at the end than for the initial parameters, the checkpoint files
     present, model.npz loading and running one predict_step, and `--resume`
     running the third epoch, its launches counted alike; at the default --save_valid_plots
     true the run writes each epoch's validation plots (on the plain f32
     blocks, so the launch counts stay exact), which phase 15 checks;
 11. pair and `packed` vs plain: the two-block kernel against its plain
     version (bars of phase 2) and against two one-block launches (bit-equal)
     at 1024 x 250, a ragged (3, 37) and, at batch 16, on both sides of the
     length past which the activation between the blocks no longer fits in
     shared memory and is staged through the output rows in the same launch
     (bf16 352 / 353, f32 218 / 219) and at the ceiling (bf16 464, f32 291),
     bf16 and f32, both softmax forms; the one-block kernel at
     `packed=False`, L = 250 and `packed=True`, L = 16 against plain; the
     underflow input finite through the pair; median times of the pair, of
     two one-block launches and of the plain version;
 12. the fused block's profiling kernels vs plain: each of the eight
     `ablate` cuts (`fused_fft_block(..., ablate=...)`) in both softmax forms
     at (2048, 250, 64) bf16, (3, 37) f32 and bf16 at L = 15, 16, 17 and 37
     (slab edges; 37 pads to 40 on the TPU and to 48 here), in bf16 with the
     evidence that the four cuts the bar cannot see were taken
     (`fft_block_variants.check_cut_taken`: thin16 and nomask nearer their
     own plain version than the uncut block's, noshift and bf16exp not
     bit-equal to the uncut kernel, the exact form's attention cuts bit-equal
     to it), and every variant
     (a, b, c, d) and stage (proj ... full) of ops/fft_block_variants.py at
     the same shapes (bars of phase 2; the stages' f32 atol scaled by
     max(1, max|plain|), their sinks being unnormalised sums), c and b
     bit-equal to the fused block's exact form in both dtypes; median times
     at (2048, 250) bf16; then scripts/profile_torch_block_variants.py's
     interleaved timing of the variants and scripts/profile_torch_attn_
     breakdown.py's of the cuts on two blocks (2 rounds each), the launches
     of their timed rounds counted, the stage differences and full − cut
     printed;
 13. predict main path at `pallas_pair: true`: phase 4's run with that knob;
     per batch 2 one-block launches (the encoder) and 1 pair launch, the
     BLOW5 equal record for record to phase 4's; then a small POD5 run (where
     the machine has pyarrow and zstandard, which the POD5 writer needs on the
     host; reported as not made otherwise) and a small R9-profile (k = 6) run
     on the card, each read back;
 14. wire formats on the card: each packed tier's packer (2, 4, 8, 12 bits)
     on the card against the same packer on the CPU fed the card's inputs
     (bit-equal framed bytes); phase 4's run again at raw and at auto, with
     the default noise (same reads and sample counts, every sample within 1
     count, >= 90 % equal; phase 4's records equal to this auto run's) and
     with --noise-std 0 (bit-equal); 8 and 12 bits bit-equal to raw; a run
     whose noise (--noise-std 20) overflows int8 deltas, started at 8 bits,
     steps down to 12 or 16 (its log: for each tier it leaves, three batches
     recomputed raw, then the step-down) and equals its raw run; every packed batch
     decoded by the C++ codec; the tier each run settled on, bytes per row,
     the stage timers per batch at auto and raw and each run's kSamples/s
     printed beside the card's name and power limit;
 15. the rest of training and the command line, at full width (the default
     config, bf16, batch 512): phase 10's PNGs (batch_{b}_reference.png and
     _all_signals.png for b < 12 in epoch_0..2, no "Validation plots failed";
     "PNGs NOT MADE: no matplotlib" where the machine lacks it), the plot
     arrays of 12 sequences on the card against the same call on the CPU
     (same parameters, batch and key: the sampled durations equal, every
     array within rtol 2e-3 / atol 2e-4 x 165 pA) and one epoch's plots
     timed; the `train` command with `optimizer: AdaFactor` for one epoch of
     10 steps + 2 validation steps (phase 10's checks, block launches exact,
     254 optimizer leaves in train_state.npz), three AdaFactor updates of the
     default config's 84 leaf shapes plus a factored (130, 136) leaf on the
     card against the CPU from the same f32 parameters and gradients (rtol
     1e-4 / atol 1e-7), and the train step's ms with Adam and with AdaFactor
     (interleaved); `sweep --sweep-id grid.yaml --count 2` (two trials of one
     epoch of 3 steps + 2 validation steps: 2 rows with finite
     valid_total_loss, block launches counted as in phase 10); and
     `version` naming the card;
 16. the parallel layer on the one card (no second card exists here): (a)
     phase 4's run with device=[cuda:0, cuda:0] (two shards of 512 rows a
     batch) at auto, its records equal one for one to phase 4's, the ULP
     tier kept to the end with dp_shards 2 and every batch decoded by the C++
     codec, 8 one-block launches a batch; the same at raw against a
     one-device raw run; (b) the `train` command as two processes on the
     card over gloo (torchrun's variables; the backend rule gives gloo to two
     ranks on one card), one epoch of 4 steps + 2 validation steps at batch
     512, against the same command in one process: at the default config
     (bf16, the block rung) and at float32 with `pallas_train: block`, each
     rank's whole-block launches exact for its slab (a dp run is eager), the
     one-process run's counted as in phase 10, rank 1's model path
     empty, the step-0 losses (from the same parameters) within rtol 1e-5;
     at f32 every later loss within rtol 1e-5 and every parameter leaf of
     model.npz within rtol 1e-4 / atol 1e-6; at bf16, where each step's
     forward rounds the gradient sum's other order (two slabs' sums added)
     up to bf16 steps, the later losses within 1e-2 (phase 6's bf16 bar) of
     the one-process run and the leaves' gap printed as the witness, and
     every loss and leaf at the f32 bars against one process that sums the
     two slabs' gradients in rank order (_slab_order_steps: the same
     command with loop.make_train_step and make_valid_step replaced, its
     block launches exactly twice the one-slab run's; bit-equal entries
     counted); (c) the attention core at 4
     heads (D = 32, a tp = 2 rank's heads) against its plain version at
     phase 5's bars and bit-equal to the 8-head kernel on the same heads,
     forward and backward, bf16 and f32, with its times at (512, 250, 32)
     bf16 beside the 8-head kernel's, its plain version's and
     F.scaled_dot_product_attention's on the 4 heads; then `train --tp 2` at `pallas_train:
     core` as two processes on the card (4 steps + 2 validation steps), each
     rank's core launches exact, every logged loss within 1e-2 relative of
     the one-process run's (bf16), and its
     train_state.npz holding whole leaves in optax's order (the count and
     shapes of the one-process file of (b));
 17. the run loop's host threads on the card: (a) phase 4's run again, its
     records equal one for one to phase 4's, seq2squiggle-h2d, -fetch and
     -decode seen alive during it (from a wrapped iter_batches) and no
     seq2squiggle-* thread after it, stats["timers"] holding h2d_cpu,
     dispatch_cpu and d2h_wait, 4 fused-block launches a batch; (b) the same
     run with the decode slowed (its first batch held PIPELINE_HOLD_S, then
     PIPELINE_SLOW_S a batch), at the run's queue depths, where all 6 batches
     go in, and with them cut to 1, where they fill: records equal to phase
     4's, the batches in flight past the one the decode holds exactly the two
     queues' depths plus the batch the fetch thread holds and the one
     launched (or all the others), the peak of allocated device memory
     beside (a)'s; (c) phase 14's step-down run (--noise-std 20 from
     8 bits) with the decode slowed: more than four batches launched at 8
     bits (in flight when it steps down), records equal to its raw run's,
     three raw recomputes logged for each tier it leaves, then the step-down; (d) phase 16(a)'s two shards of the card:
     each shard launched from its own thread (seq2squiggle-shard0_0 and
     -shard1_0) on its own stream, not the default one (handles recorded by
     a wrapped predict_step), records equal to phase 4's, 8 one-block
     launches a batch, and kSamples/s against one device in 3 alternating
     rounds; each run's kSamples/s and stage timers per batch printed beside
     the card's name and power limit;
 18. the Gamma dwell kernel (ops/threefry.py, csrc/threefry.cu) against its
     plain version, the torch ops of prng.py and sampling.py on the card, at
     (1024, 16) and a ragged (37, 16), `a` log-uniform over [0.01, 60] (the
     boost below 1), rate over [0.05, 5], an eighth of the rows padding
     (read index -1): the chunk keys bit-equal (from the draw's launch and
     from the keys-only one), the draws within rtol 1e-5 on >= 99.9 % and
     finite, the rounded durations equal on >= 99.9 % and equal to the
     kernel's own draws clamped and rounded; the share of draws equal bit for
     bit printed; median times of one launch and of the plain version at
     (1024, 16); then phase 4's run again with the spans on: one launch a
     batch, `sampling.gamma_plain` absent and `sampling.gamma_kernel` the
     batches' rows, its records equal one for one to phase 4's;
 19. the train step's threefry kernels (ops/threefry.py, csrc/threefry.cu)
     against the torch ops of prng.py on the card: fold_in, split and
     split(fold_in) of one key and of a batch of keys, and the dropout draw's
     bool mask and bf16 and f32 scales at keep 0.8 and 0.9, bit-equal, at
     (512, 250, 64), (512, 16, 64), a ragged (37, 250, 64) and a dp rank's
     slab (rows 256..383 of a 512-row draw); one `make_train_step` call at
     the default config (bf16, the block rung, batch 512) through the
     kernels and through the torch ops: loss and every gradient bit-equal;
     median times of one (512, 250, 64) bf16 draw and of one step's 11
     draws, kernel and plain, beside their bound; then the `train` command
     (one epoch of 20 steps, no plots) with the spans on: 16 threefry
     launches a step (11 draws, 5 key derivations, one of them the step
     key's fold_in in train_run), counted as the note after phase 20 says,
     `train.masks_plain` absent and `train.masks_kernel` the 11 draws'
     elements and 11 `train.masks` spans for each step whose draws the host
     issues: the eager warm-up and the capture;
 20. the train step as a CUDA graph (train/loop.py::TrainStep): for each
     run of GRAPH_CASES (the `block`, `core` and `false` rungs, bf16 and
     f32, and the six optimizers under five schedules), 6 steps at batch 512
     and 3 at 256 from one start through the step (eager warm-up, capture,
     replays, and again at the new shape and where RAdam's branch flips)
     and through `TrainStep.eager` on a copy: parameters, the optimizer's
     state and every metric bit-equal, the eager steps, captures and
     replays the graph keys call for, the counts as the note below says,
     and from a profile of 3 more replays a replayed step's kernels; the
     default Adam on the card, dividing by its device scalars, at least as
     close to the CPU's update (which tests/test_torch_port_train.py holds
     to optax's) as the update with Python numbers, values differing and
     largest |difference| printed; the default step's host time to
     return, its wall with a synchronize and, from a profile of 5 steps,
     the card's busy time, device events, kernel and graph launches a step,
     graphed and eager in interleaved rounds; phase 19's `train` command as
     1 eager step, 1 capture and 19 replays;
 21. the predict output written behind the loop: one job over the
     `r10-predict-genome` cell's settings (a 48,502 bp genome from a seed,
     WRITE_BEHIND_READS reads of mean 5 kb, batch 1024, samplers on, auto
     wire, BLOW5, the default export threshold) with the spans on, its
     counters `export.behind_samples` and `export.final_samples`, the share
     left for `finalize` and the `finalize` and `write` timers printed,
     some samples written behind, and its BLOW5 records (ids, signals and
     every field) equal to those of the same job at
     `export_every_n_samples=inf` (one flush in `finalize`, no writer
     thread).

On one card the train step is a CUDA graph, so the `train` command (and
`sweep`) runs each TrainStep's first step eagerly, captures the second and
replays the rest. The wrappers' launch counters (ops/block_train.py,
ops/attn_core.py, ops/threefry.py) count what the host issues: eager
steps and captures. So phases 7, 10, 15, 16 and 19 hold them at the
counts above for each eager step and capture, plus the validation's, and
hold every step to have run once, as an eager step or a replay. In phases
7, 10, 15 (its AdaFactor run) and 19, torch.profiler also records the
card's kernels from the capture on. Device kernel events are counted by
name (`block_train_fwd`, `bwd_rows`, `attn_core_fwd`, `attn_core_bwd`
less the block backward's own, `dropout_draw_kernel`,
`threefry_keys_kernel`). The kernels the host issued in that window are
taken off, and the rest divided by the replays: a replayed step must
have run the counts above. The kernels line reports this as
`launches_per_replayed_step`.

Beside the kernels (phases 2, 8, 11, 12), one library call that computes the
same function is timed and held against the plain version at phase 2's bf16
bar, not required to meet it, with a note of what ran
(`aten::_transformer_encoder_layer_fwd` or the unfused layer): a
torch.nn.TransformerEncoderLayer holding the block's weights (the fused
block at 1024 x 16 and 1024 x 250, and at 2048 x 250 for P1's b and c and
P2's d), two of them in a torch.nn.TransformerEncoder (the pair), and the
layer's forward and backward under autograd at (512, 250, 64) (the
whole-block training kernels at unit dropout scales). Nothing in the port
calls them.

The line before the last is a JSON object with each kernel's route, source,
launches on its main path (the host's; for the training kernels, those of
a replayed step beside them; for the profiling kernels: in their timing
scripts' timed rounds), error, times and bound (the least time the card could
take: bytes over 3.35 TB/s against operations over the peak of their type,
989 TFLOP/s bf16 and 67 TFLOP/s f32, NVIDIA's H100 SXM data sheet; for the
cuts, the slowest cut's time at (2048, 250, 64) bf16 and that cut's work);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import logging
import socket
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

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
EDGE_LENGTHS = (1, 15, 16, 17, 31, 32, 33, 37)  # phase 2: 16-row slabs, packed_default
VARIANT_EDGES = (15, 16, 17, 37)  # phase 12: 16-row slabs; 37 pads to 40 on the TPU, 48 here

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, dense FLOP/s by type.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# 32-bit integer operations: 64 lanes an SM (the Hopper architecture white
# paper) x 132 SMs x 1980 MHz
PEAK_INT32_OPS = 64 * 132 * 1.98e9
GAMMA_K = 16  # phase 18: k-mers a chunk row
GAMMA_RAGGED = 37  # phase 18: a batch that fills no whole 256-thread block
THREEFRY_OPS = 80  # integer operations of one threefry block (csrc/threefry.cuh)
# phase 19: (shape, rows of the global draw or None, first row); the last a dp rank's slab
MASK_CASES = (((512, 250, 64), None, 0), ((512, 16, 64), None, 0), ((37, 250, 64), None, 0),
              ((128, 250, 64), 512, 256))
MASK_KEEPS = (0.8, 0.9)
GRAPH_STEPS = 6  # phase 20: steps at the train batch before the batch of half its rows
WRITE_BEHIND_READS = 30  # phase 21: the cell's job of 100 reads, cut to save time


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


def core_work(B: int, L: int, dtype: torch.dtype, backward: bool, D: int = 64):
    """Bytes and FLOPs of one attention-core call on D / 8 heads: 4 tensors
    and two L x L x 8 products per head forward; 7 tensors and six products
    backward (scores and num recomputed, g_a, gq, gk, gv)."""
    size = torch.finfo(dtype).bits // 8
    tensors, products = (7, 6) if backward else (4, 2)
    return tensors * B * L * D * size, products * 2 * B * L * L * D


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
    import threading

    from seq2squiggle_tpu_torch.io.native.build import load_native

    codec = {}

    def build_codec():  # the wire decoders' C++, beside nvcc's builds
        t = time.perf_counter()
        codec["lib"], codec["s"] = load_native(), time.perf_counter() - t

    thread = threading.Thread(target=build_codec)
    thread.start()
    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s)")
    thread.join()
    check(codec["lib"] is not None, "the C++ codec (io/native/slow5_codec.cc) did not build")
    log(f"C++ codec build (g++, nvcc's host compiler): {codec['s']:.2f} s")
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


def ceiling(dtype) -> int:
    """The longest L the fused block takes in `dtype` (its shared memory)."""
    from seq2squiggle_tpu_torch.ops import _build
    from seq2squiggle_tpu_torch.ops import fft_block as fb

    fits = 16
    while fb.shared_memory_bytes(fits + 1, dtype) <= _build.SHARED_MEMORY_MAX:
        fits += 1
    return fits


def hold_block(what, got, ref, dtype) -> float:
    """A fused-block output against its plain version: finite; bf16 within 4
    bf16 ULPs of max(1, max|plain|), f32 rtol 1e-4 / atol 1e-5. Returns
    max|err|."""
    err = (got.float() - ref.float()).abs().max().item()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    if dtype == torch.bfloat16:
        check(err <= bf16_tol(ref), f"{what}: err {err} > {bf16_tol(ref)}")
    else:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    return err


def library_layer(block, dtype, dev):
    """torch.nn.TransformerEncoderLayer holding `block`'s weights: the same
    post-LN block (q/k/v with biases, 1/sqrt(d_k), fc, LN1(o + x), the ReLU
    FFN, LN2(f + h1)) at dropout 0. Timed beside the kernels, used nowhere in
    the port."""
    from seq2squiggle_tpu_torch.ops.fft_block import WEIGHT_FIELDS, _get

    (wq, bq, wk, bk, wv, bv, wf, bf, ln1s, ln1b,
     w1, b1, w2, b2, ln2s, ln2b) = (_get(block, f).detach().float().cpu() for f in WEIGHT_FIELDS)
    layer = torch.nn.TransformerEncoderLayer(
        64, 8, 256, dropout=0.0, activation="relu", batch_first=True, norm_first=False,
        layer_norm_eps=1e-5)
    with torch.no_grad():
        for param, value in (
                (layer.self_attn.in_proj_weight, torch.cat([wq.T, wk.T, wv.T])),
                (layer.self_attn.in_proj_bias, torch.cat([bq, bk, bv])),
                (layer.self_attn.out_proj.weight, wf.T), (layer.self_attn.out_proj.bias, bf),
                (layer.norm1.weight, ln1s), (layer.norm1.bias, ln1b),
                (layer.linear1.weight, w1.T), (layer.linear1.bias, b1),
                (layer.linear2.weight, w2.T), (layer.linear2.bias, b2),
                (layer.norm2.weight, ln2s), (layer.norm2.bias, ln2b)):
            param.copy_(value.reshape(param.shape))
    return layer.to(dev, dtype).eval()


def hold_library(what, module, x, ref):
    """One library call (`module(x)` under inference mode) against the plain
    version at phase 2's bf16 bar (4 bf16 ULPs of max(1, max|plain|)), not
    required to meet it; its median time; and whether the fused op
    (aten::_transformer_encoder_layer_fwd) ran or the layer's unfused path."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        err = (module(x).float() - ref.float()).abs().max().item()
        ms = median_ms(lambda: module(x))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            module(x)
    fused = any(e.key == "aten::_transformer_encoder_layer_fwd" for e in prof.key_averages())
    got = {"ms": ms, "max_abs_err": err, "within_bar": err <= bf16_tol(ref),
           "ran": "aten::_transformer_encoder_layer_fwd" if fused else "the unfused layer"}
    log(f"library {what}: {ms:.3f} ms, max|err| against plain {err:.3g} "
        f"({'within' if got['within_bar'] else 'OUTSIDE'} phase 2's bf16 bar), ran "
        f"{got['ran']}")
    return got


def phase_kernel(params_by_dtype, dev):
    from seq2squiggle_tpu_torch.ops.fft_block import (
        fused_fft_block, fused_fft_block_reference,
    )

    gen = torch.Generator().manual_seed(SEED)
    worst_bf16 = 0.0
    times, library = {}, {}
    for dtype, params in params_by_dtype.items():
        name = str(dtype)[6:]
        block = params["decoder"]["blocks"][0]
        for B, L in ((BATCH, 16), (BATCH, 250), (3, 16), (3, 250)):
            x = torch.randn(B, L, 64, generator=gen).to(dev, dtype)
            got = fused_fft_block(x, block, 8)
            torch.cuda.synchronize()
            ref = fused_fft_block_reference(x, block, 8)
            err = hold_block(f"{name} {B}x{L}", got, ref, dtype)
            if dtype == torch.bfloat16 and B == BATCH:
                worst_bf16 = max(worst_bf16, err)
            msg = f"kernel vs plain {name:8s} B={B:4d} L={L:3d}: max|err| {err:.3g}"
            if B == BATCH:
                k_ms = median_ms(lambda: fused_fft_block(x, block, 8))
                p_ms = median_ms(lambda: fused_fft_block_reference(x, block, 8))
                times[(dtype, L)] = (k_ms, p_ms)
                msg += f", kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms"
            log(msg)
            if B == BATCH and dtype == torch.bfloat16:
                library[L] = hold_library(f"layer bf16 {B}x{L}",
                                          library_layer(block, dtype, dev), x, ref)
        top = ceiling(dtype)
        errs = []
        for B, L in [(3, L) for L in EDGE_LENGTHS] + [(16, top)]:
            x = torch.randn(B, L, 64, generator=gen).to(dev, dtype)
            for packed in (False, True):
                got = fused_fft_block(x, block, 8, packed=packed)
                torch.cuda.synchronize()
                ref = fused_fft_block_reference(x, block, 8, packed)
                errs.append(hold_block(f"{name} {B}x{L} packed={packed}", got, ref, dtype))
        log(f"kernel vs plain {name} at batch 3, L = {', '.join(map(str, EDGE_LENGTHS))}, and "
            f"batch 16 at the ceiling L = {top}, both softmax forms: max|err| {max(errs):.3g}")
        out = fused_fft_block(underflow_input(gen).to(dev, dtype), block, 8)
        check(bool(torch.isfinite(out).all()), f"underflow input gave non-finite {dtype}")
        log(f"underflow input {name}: finite")
    return worst_bf16, times, library


def digests(dev) -> dict:
    """sha256 over outputs on inputs from SEED: the fused block (both softmax
    forms) and pair (both forms) at (3, 37) and (1024, 250) with the
    committed R10 decoder blocks, f32 and bf16; the bf16 whole-block training
    kernels' forward output, gx and the 16 weight gradients at (3, 37) and
    (512, 250) with dropout scales; the f32 attention-core kernels
    (`core_f32_digest`). Two trees whose kernels agree bit for bit print the
    same digests."""
    import hashlib

    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.models.weights import load_checkpoint
    from seq2squiggle_tpu_torch.ops import block_train as bt
    from seq2squiggle_tpu_torch.ops import fft_block as fb

    gen = torch.Generator().manual_seed(SEED)
    host, _ = load_checkpoint(str(R10))
    fused = {}
    for dtype in (torch.float32, torch.bfloat16):
        b0, b1 = fft_model.to_device(host, dev, dtype)["decoder"]["blocks"]
        fused[dtype] = hashlib.sha256()
        for B, L in ((3, 37), (BATCH, 250)):
            x = torch.randn(B, L, 64, generator=gen).to(dev, dtype)
            for packed in (False, True):
                for out in (fb.fused_fft_block(x, b0, 8, packed), fb.fused_fft_block_pair(
                        x, b0, b1, 8, packed)):
                    fused[dtype].update(out.float().cpu().numpy().tobytes())
    block = fft_model.init_params(load_config(None), prng.key(SEED))["decoder"]["blocks"][0]
    weights = [w.to(dev).contiguous() for w in bt.block_weights(block)]
    train = hashlib.sha256()
    for B, L in ((3, 37), (TRAIN_BATCH, 250)):
        x, g = (torch.randn(B, L, 64, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
        scales = [bt.make_dropout_scales(k, 0.2, x.shape, torch.bfloat16)
                  for k in prng.split(prng.key(B, dev))]
        gx, gws = bt.fused_block_train_backward(x, weights, *scales, g, 8)
        for t in (bt.fused_block_train_forward(x, weights, *scales, 8), gx, *gws):
            train.update(t.float().cpu().numpy().tobytes())
    return {"fused_block_and_pair_f32": fused[torch.float32].hexdigest(),
            "fused_block_and_pair_bf16": fused[torch.bfloat16].hexdigest(),
            "block_train_bf16": train.hexdigest(), "core_f32": core_f32_digest(dev)}


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
    launches, the records read back, the run's stats)."""
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
    return launches, pair_launches, recs, stats


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


def hold_packers(host_params, dev, B: int = BATCH) -> dict:
    """Phase 14's packer check: each packed tier's framed bytes from the card
    against the same packer on the CPU, fed the card's inputs copied to the
    host (the bf16 decoder output, the x 165 prediction, the stdevs, the
    segment map, the read indices; the raw step's rows for the delta tiers).
    Bar: bit-equal bytes. Returns {bits: bytes per row}."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.runtime import predict as tpredict

    cfg = load_config(None)  # bf16, the ULP tier's compute
    knobs = tpredict.PredictKnobs()
    params = fft_model.to_device(host_params, dev, torch.bfloat16)
    batch = [t.to(dev) for t in _batch(B, 3)]
    with torch.inference_mode():
        dec, _, _, noise_stdev, seg_parts = tpredict.decoder_output(
            params, *batch[:3], prng.key(SEED, dev), batch[3], config=cfg, knobs=knobs)
        sig, counts = tpredict.predict_step(params, *batch[:3], prng.key(SEED, dev), batch[3],
                                            config=cfg, knobs=knobs)
        card = dict(dec=dec, pred=dec.float() * knobs.scaling_max_value, std=noise_stdev,
                    seg=seg_parts, ridx=batch[1], sig=sig, counts=counts)
        cpu = {k: tuple(t.cpu() for t in v) if isinstance(v, tuple) else v.cpu()
               for k, v in card.items()}

        def framed(bits, x):
            if bits == 2:
                outs = tpredict._pack_event_wire_ulp(x["dec"], x["seg"], x["std"], x["ridx"], knobs)
            elif bits == 4:
                outs = tpredict._pack_event_wire(x["pred"], x["seg"], x["std"], x["ridx"], knobs)
            else:
                outs = tpredict._pack_wire(x["sig"], x["counts"], bits) + (x["counts"],)
            return tpredict._frame_outputs(outs).cpu()

        widths = {}
        for bits in (2, 4, 8, 12):
            got, want = framed(bits, card), framed(bits, cpu)
            check(got.dtype == torch.uint8 and torch.equal(got, want),
                  f"{bits}-bit packer: the card's bytes differ from the CPU's on "
                  f"{(got != want).any(dim=1).sum().item()} of {B} rows")
            widths[bits] = got.shape[1]
    return widths


def _tier_runs_match(what, got, want, exact: bool) -> float:
    """Records `got` against `want`: the same read ids and lengths; equal
    samples (exact) or every sample within 1 count and >= 90 % equal.
    Returns the share of equal samples."""
    check([r for r, _ in got] == [r for r, _ in want], f"{what}: other read ids")
    check(all(len(a) == len(b) for (_, a), (_, b) in zip(got, want)),
          f"{what}: sample counts differ from the raw run's")
    d = np.abs(np.concatenate([a.astype(np.int64) - b for (_, a), (_, b) in zip(got, want)]))
    share = float((d == 0).mean())
    if exact:
        check(d.max() == 0, f"{what}: {int((d != 0).sum())} samples differ from raw")
    else:
        check(d.max() <= 1 and share >= 0.9,
              f"{what}: max|Δ| {d.max()}, equal {share:.4f} against raw")
    return share


def timers_per_batch(stats) -> str:
    """A run's stage timers (SEQ2SQUIGGLE_TPU_TIMERS=1) in ms per batch."""
    t = stats["timers"]
    n = sum(v for k, v in t.items() if k.startswith("n_t"))
    per = {k: round(v / n * 1e3, 3) for k, v in t.items()
           if not k.startswith("n_t") and isinstance(v, float)}
    return f"ms per batch over {n} batches: {json.dumps(per)}"


def phase_wire(host_params, dev, main_stats, main_recs, smi, n_reads: int = 100):
    """Phase 14, the wire formats on the card: the packers against the CPU;
    phase 4's run (auto: the ULP tier) against raw with and without noise;
    the 8- and 12-bit tiers bit-equal to raw; a run whose noise overflows
    int8 logs its recomputes and steps down from 8, and still equals raw;
    every packed batch decoded by the C++ codec; bytes per row, stage timers
    per batch and kSamples/s at auto and raw printed beside the card."""
    import os

    from seq2squiggle_tpu_torch.io.native.build import load_native
    from seq2squiggle_tpu_torch.runtime.predict import row_bytes

    widths = hold_packers(host_params, dev)
    check(load_native() is not None, "the C++ codec did not build on this host")
    log("wire packers on the card: framed bytes equal to the CPU's at 2, 4, 8 and 12 bits; "
        "bytes per row " + ", ".join(f"{b}: {w}" for b, w in widths.items())
        + f", raw: {row_bytes(16, 250, 16)} [{smi}]")
    check(main_stats["wire_bits"] == 2, f"main path ended at {main_stats['wire_bits']} bits")

    os.environ["SEQ2SQUIGGLE_TPU_TIMERS"] = "1"
    try:
        runs = {}
        for name, over in (("raw", dict(wire_format="raw")), ("auto", {}),
                           ("raw noise 0", dict(wire_format="raw", noise_std=0.0)),
                           ("auto noise 0", dict(noise_std=0.0)),
                           ("8", dict(wire_format="8")), ("12", dict(wire_format="12"))):
            stats, _, _, recs = _predict_run(dev, "out.blow5", n_reads, **over)
            _check_records(f"wire run {name}", stats, recs, n_reads)
            packed = name.split()[0] != "raw"
            check(not packed or (stats["wire_decode"]["numpy"] == 0
                                 and stats["wire_decode"]["native"] > 0),
                  f"wire run {name}: decoded {stats['wire_decode']}, want the C++ codec only")
            runs[name] = (stats, recs)
        # the ladder: ~40 sigma-20 pA noise deltas a row overflow int8's 24 slots;
        # the port's log says what its overflow path did
        ladder = {}
        warnings = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = lambda record: warnings.append(record.getMessage())
        port_log = logging.getLogger("seq2squiggle_tpu_torch")
        for name in ("raw", "8"):
            port_log.addHandler(handler)
            try:
                ladder[name] = _predict_run(dev, "out.blow5", 30, wire_format=name,
                                            noise_std=20.0, predict_batch_size=256)
            finally:
                port_log.removeHandler(handler)
    finally:
        del os.environ["SEQ2SQUIGGLE_TPU_TIMERS"]

    raw_recs = runs["raw"][1]
    check(main_recs is not None and len(main_recs) == len(runs["auto"][1]), "phase 4 records")
    share = _tier_runs_match("auto (ULP) against raw", runs["auto"][1], raw_recs, exact=False)
    _tier_runs_match("phase 4 against this auto run", main_recs, runs["auto"][1], exact=True)
    _tier_runs_match("auto against raw, noise 0", runs["auto noise 0"][1],
                     runs["raw noise 0"][1], exact=True)
    for bits in ("8", "12"):
        _tier_runs_match(f"{bits}-bit against raw", runs[bits][1], raw_recs, exact=True)
    stats8 = ladder["8"][0]
    check(stats8["wire_bits"] in (12, 16), f"ladder run ended at {stats8['wire_bits']} bits")
    # each tier it left: three batches recomputed raw, the fourth steps down
    steps = [w for w in warnings if "downgrading wire format to" in w]
    recomputes = sum("recomputed this batch raw" in w for w in warnings)
    check(steps and "downgrading wire format to 12-bit deltas" in steps[0]
          and len(steps) == (1 if stats8["wire_bits"] == 12 else 2)
          and recomputes == 3 * len(steps),
          f"ladder run logged {len(steps)} step-downs and {recomputes} raw recomputes: {steps}")
    _tier_runs_match("ladder run against raw", ladder["8"][3], ladder["raw"][3], exact=True)
    for name, (stats, _) in runs.items():
        log(f"wire run {name}: settled on {stats['wire_bits']} bits, {stats['samples']} samples "
            f"in {stats['seconds']:.3f} s ({stats['ksamples_per_s']:.1f} kSamples/s), "
            f"decoded {stats['wire_decode']} [{smi}]")
    log(f"wire: auto against raw with noise, samples equal {share:.4f}, all within 1 count; "
        f"noise 0, 8 and 12 bits bit-equal to raw; ladder from 8 bits logged {recomputes} raw "
        f"recomputes and {len(steps)} step-downs, settled on {stats8['wire_bits']} bits with "
        f"records equal to raw")
    for name in ("auto", "raw"):
        log(f"stage timers at {name}, {timers_per_batch(runs[name][0])} [{smi}]")
    return {name: stats["ksamples_per_s"] for name, (stats, _) in runs.items()}


def phase_pair(params_by_dtype, dev):
    """Phase 11: the pair kernel and the `packed` argument against plain."""
    from seq2squiggle_tpu_torch.ops import fft_block as fb

    gen = torch.Generator().manual_seed(SEED)
    result = {}
    for dtype, params in params_by_dtype.items():
        name = str(dtype)[6:]
        b0, b1 = params["decoder"]["blocks"]
        on_chip = max(L for L in range(1, 600) if fb.pair_keeps_activation_on_chip(L, dtype))
        for B, L in ((3, 37), (BATCH, 250), (16, on_chip), (16, on_chip + 1),
                     (16, ceiling(dtype))):
            x = torch.randn(B, L, 64, generator=gen).to(dev, dtype)
            where = ("in shared memory" if fb.pair_keeps_activation_on_chip(L, dtype)
                     else "staged through the output rows")
            for packed in (False, True):
                what = f"pair {name} {B}x{L} packed={packed}"
                pair = fb.fused_fft_block_pair(x, b0, b1, 8, packed=packed)
                two = fb.fused_fft_block(fb.fused_fft_block(x, b0, 8, packed=packed), b1, 8,
                                         packed=packed)
                torch.cuda.synchronize()
                check(torch.equal(pair, two), f"{what}: not bit-equal to two one-block launches")
                err = hold_block(what, pair,
                                 fb.fused_fft_block_pair_reference(x, b0, b1, 8, packed), dtype)
                msg = (f"{what}: activation {where}, bit-equal to two launches, vs plain "
                       f"max|err| {err:.3g}")
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
                if B == BATCH and packed and dtype == torch.bfloat16:
                    pair_layers = torch.nn.TransformerEncoder(
                        library_layer(b0, dtype, dev), 2, enable_nested_tensor=False)
                    pair_layers.layers = torch.nn.ModuleList(
                        [library_layer(b, dtype, dev) for b in (b0, b1)])
                    result["library"] = hold_library(
                        f"two-layer encoder bf16 {B}x{L}", pair_layers.eval(), x,
                        fb.fused_fft_block_pair_reference(x, b0, b1, 8, packed))
        for B, L, packed in ((BATCH, 250, False), (BATCH, 16, True), (3, 250, False),
                             (3, 16, True)):
            x = torch.randn(B, L, 64, generator=gen).to(dev, dtype)
            err = hold_block(f"packed={packed} {name} {B}x{L}",
                             fb.fused_fft_block(x, b0, 8, packed),
                             fb.fused_fft_block_reference(x, b0, 8, packed), dtype)
            log(f"one block {name} B={B:4d} L={L:3d} packed={packed}: vs plain max|err| {err:.3g}")
        out = fb.fused_fft_block_pair(underflow_input(gen).to(dev, dtype), b0, b1, 8, packed=True)
        check(bool(torch.isfinite(out).all()), f"pair: underflow input gave non-finite {name}")
        log(f"pair underflow input {name}: finite")
    return result


def cut_work(B: int, L: int, dtype: torch.dtype, cut: str):
    """Bytes and FLOPs of one fused-block call with a profiling cut: the
    block's (fused_block_work) less the products the cut takes out (noattn
    the scores and e·v, noffn the FFN, thin16 the scores of 6 of 8 heads)."""
    n_bytes, flops = fused_block_work(B, L, dtype)
    less = {"noattn": 256 * L, "noffn": 2 * 2 * 64 * 256, "thin16": 6 * 2 * L * 8}
    return n_bytes, flops - B * L * less.get(cut, 0)


def phase_variants(params_by_dtype, dev):
    """Phase 12: the fused block's profiling kernels (the eight `ablate` cuts,
    the variants a ... d and the stages) against plain, then the two timing
    scripts with the launches of their timed rounds counted."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import profile_torch_attn_breakdown as breakdown
    import profile_torch_block_variants as script

    from seq2squiggle_tpu_torch.ops import fft_block as fb
    from seq2squiggle_tpu_torch.ops import fft_block_variants as tv

    gen = torch.Generator().manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    timing = (2048, 250)
    shapes = [(f32, (3, 37)), (bf16, timing)] + [(bf16, (3, L)) for L in VARIANT_EDGES]

    # the cuts, both softmax forms
    worst = {"ablate": 0.0, "abc": 0.0, "d": 0.0, "parts": 0.0}
    cut_times = {}
    for dtype, (B, L) in shapes:
        name = str(dtype)[6:]
        block = params_by_dtype[dtype]["decoder"]["blocks"][0]
        x = torch.randn(B, L, 64, generator=gen).to(dev, dtype)
        errs, taken = [], []
        for packed in (False, True):
            uncut = (fb.fused_fft_block(x, block, 8, packed),
                     fb.fused_fft_block_reference(x, block, 8, packed))
            for cut in tv.ABLATIONS:
                got = fb.fused_fft_block(x, block, 8, packed, cut)
                ref = fb.fused_fft_block_reference(x, block, 8, packed, cut)
                torch.cuda.synchronize()
                what = f"cut {cut} {name} {B}x{L} packed={packed}"
                err = hold_block(what, got, ref, dtype)
                if dtype == bf16:  # the bar holds four cuts without showing them
                    worst["ablate"] = max(worst["ablate"], err)
                    try:
                        ratio = tv.check_cut_taken(cut, packed, L, got, ref, *uncut)
                    except AssertionError as exc:
                        raise AssertionError(f"{what}: {exc}") from None
                    if ratio is not None:
                        taken.append(f"{cut} {ratio:.2g}")
                errs.append(err)
                del ref
                if (B, L) == timing and packed:
                    cut_times[cut] = (
                        median_ms(lambda: fb.fused_fft_block(x, block, 8, True, cut)),
                        median_ms(lambda: fb.fused_fft_block_reference(x, block, 8, True, cut),
                                  iters=5))
                del got
        log(f"cuts vs plain {name} {B}x{L}, both softmax forms: max|err| {max(errs):.3g}"
            + (f"; taken (mean|kernel - plain| / the cut's mean move): {', '.join(taken)}; "
               "noshift and bf16exp not bit-equal to the uncut block, the exact form's "
               "attention cuts bit-equal to it" if dtype == bf16 else ""))

    # a, b, c, d and the stages
    calls = ([("abc", v, tv.fused_abc, tv.fused_abc_reference) for v in tv.ABC_VARIANTS]
             + [("d", v, tv.fused_d, tv.fused_d_reference) for v in tv.D_VARIANTS]
             + [("parts", st, tv.fused_parts, tv.fused_parts_reference) for st in tv.STAGES])
    times = {}
    for dtype, (B, L) in shapes:
        name = str(dtype)[6:]
        block = params_by_dtype[dtype]["decoder"]["blocks"][0]
        x = (torch.randn(B, L, 64, generator=gen) * 0.5).to(dev, dtype)
        b = tv.fused_abc(x, block, 8, "b")
        check(torch.equal(tv.fused_abc(x, block, 8, "c"), b), f"variant c != b ({name} {B}x{L})")
        check(torch.equal(fb.fused_fft_block(x, block, 8, packed=False), b),
              f"variant b != the fused block's exact form ({name} {B}x{L})")
        errs = []
        for group, choice, fn, ref_fn in calls:
            got, ref = fn(x, block, 8, choice), ref_fn(x, block, 8, choice)
            torch.cuda.synchronize()
            what = f"fused_{group} {choice} {name} {B}x{L}"
            err = (got.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
            if dtype == bf16:
                check(err <= 4 * 2.0 ** -8 * scale, f"{what}: err {err}")
                worst[group] = max(worst[group], err)
            else:
                partial = group == "parts" and choice != "full"
                torch.testing.assert_close(got, ref, rtol=1e-4,
                                           atol=1e-5 * (scale if partial else 1.0))
            errs.append(f"{choice} {err:.3g}")
            if (B, L) == timing and (group, choice) in (("abc", "b"), ("d", "d"),
                                                        ("parts", "full")):
                times[group] = (median_ms(lambda: fn(x, block, 8, choice)),
                                median_ms(lambda: ref_fn(x, block, 8, choice), iters=5))
            del got, ref
        log(f"variants vs plain {name} {B}x{L}: c and b bit-equal to the fused block's exact "
            "form; max|err| " + ", ".join(errs))

    # B2's function as one library call at the timing shape (P1's b and c, P2's d)
    block = params_by_dtype[bf16]["decoder"]["blocks"][0]
    x = torch.randn(*timing, 64, generator=torch.Generator().manual_seed(SEED + 1)).to(dev, bf16)
    library = hold_library(f"layer bf16 {timing[0]}x{timing[1]} (P1 b and c, P2 d)",
                           library_layer(block, bf16, dev), x,
                           fb.fused_fft_block_reference(x, block, 8))

    # the timing scripts: launches counted over their timed rounds only
    x, fns, _ = script.setup()
    tv.launches_abc = tv.launches_d = tv.launches_parts = 0
    prof = script.timed(x, fns, rounds=2)
    launches = {"abc": tv.launches_abc, "d": tv.launches_d, "parts": tv.launches_parts}
    x, fns, _ = breakdown.setup()
    tv.launches_ablate = 0
    cuts = breakdown.timed(x, fns, rounds=2)
    launches["ablate"] = tv.launches_ablate
    del x, fns
    check(all(n > 0 for n in launches.values()), f"profiling kernel launches {launches}")
    log("variants, ms per block at (2048, 250, 64) bf16, min of 2 interleaved rounds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in prof["ms"].items()))
    log("stage differences, ms: "
        + ", ".join(f"{k} {v:+.3f}" for k, v in prof["stage_delta_ms"].items()))
    log("cuts, ms per two blocks at (2048, 250, 64) bf16, min of 2 interleaved rounds: "
        + ", ".join(f"{k} {v:.3f}" for k, v in cuts["ms"].items()))
    log("full - cut, ms per two blocks: "
        + ", ".join(f"{k} {v:+.3f}" for k, v in cuts["full_minus_cut_ms"].items()))
    log(f"profiling kernel launches in the timed rounds: {launches}")
    slowest = max(cut_times, key=lambda c: cut_times[c][0])
    result = {g: {"launches": launches[g], "err": worst[g], "ms": times[g][0],
                  "plain_ms": times[g][1]} for g in ("abc", "d", "parts")}
    result["ablate"] = {"launches": launches["ablate"], "err": worst["ablate"],
                        "cut": slowest, "ms": cut_times[slowest][0],
                        "plain_ms": cut_times[slowest][1],
                        "ms_by_cut": {c: t[0] for c, t in cut_times.items()},
                        "plain_ms_by_cut": {c: t[1] for c, t in cut_times.items()}}
    result["library"] = library
    return result, prof, cuts


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


def library_train(block, x, g, weights, dev) -> dict:
    """B3's library call: the layer's forward and its backward (gx and the
    weight gradients) under autograd at dropout 0, which is the whole-block
    kernels at unit dropout scales; the forward held against the plain
    version at phase 2's bf16 bar and gx at phase 8's (8 bf16 ULPs of
    max(1, max|plain|)), not required to meet them."""
    from seq2squiggle_tpu_torch.ops import block_train as bt

    layer = library_layer(block, x.dtype, dev)
    xg = x.detach().requires_grad_()
    out = layer(xg)
    ref = bt.fused_block_train_reference(x, weights, None, None, 8)
    rx, _ = bt.fused_block_train_backward_reference(x, weights, None, None, g, 8)
    gx = torch.autograd.grad(out, xg, g, retain_graph=True)[0]
    f_err = (out.float() - ref.float()).abs().max().item()
    x_err = (gx.float() - rx.float()).abs().max().item()
    params = [xg, *layer.parameters()]
    got = {"fwd_library": median_ms(lambda: layer(xg)),
           "bwd_library": median_ms(lambda: torch.autograd.grad(out, params, g,
                                                                retain_graph=True)),
           "fwd_library_err": f_err, "bwd_library_err": x_err,
           "library_within_bar": (f_err <= bf16_tol(ref)
                                  and x_err <= 8 * 2.0 ** -8 * max(1.0, rx.float().abs().max().item()))}
    log(f"library layer bf16 {tuple(x.shape)} under autograd (B3's): forward "
        f"{got['fwd_library']:.3f} ms, backward {got['bwd_library']:.3f} ms; max|err| against "
        f"plain: forward {f_err:.3g}, gx {x_err:.3g} "
        f"({'within' if got['library_within_bar'] else 'OUTSIDE'} the bars)")
    return got


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
            if dtype == torch.bfloat16:
                result[dtype].update(library_train(block, x, g, weights, dev))
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
    noise of its own stdev. Returns (one-hot (n, K, k, 5) f16, as preprocess
    writes it, targets (n, T) f32 in pA, dwells (n, K) i16, stdevs (n, K)
    f32). The dwells of a row sum to at most T (<= 15 x 16 = 240), as
    preprocess keeps only such chunks (the validation plots need it)."""
    K, k, T = cfg["max_dna_len"], cfg["seq_kmer"], cfg["max_signal_len"]
    table = np.random.default_rng(SEED).standard_normal(k * 5).astype(np.float32)
    table -= table.mean()  # levels centred on 90 pA
    codes = rng.integers(0, 4, (n, K, k))
    one_hot = np.eye(5, dtype=np.float16)[codes]
    level = 90.0 + 12.0 * (one_hot.reshape(n, K, k * 5).astype(np.float32) @ table)  # (n, K) pA
    dwell = rng.integers(4, 16, (n, K)).astype(np.int16)
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


class _Logged(logging.Handler):
    """Collects the port's log messages at `level` and above while a command
    runs."""

    def __init__(self, level=logging.WARNING):
        super().__init__(level)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("seq2squiggle_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("seq2squiggle_tpu_torch").removeHandler(self)


def phase_train_main_path(dev, mode, epochs, steps, resume, optimizer=None, plots=True):
    """Phases 7 and 10 (and phase 15's AdaFactor run): the `train` command at
    full width, launches counted. mode: the `pallas_train` override, or None
    for the default config (which takes the block rung in bf16 on a GPU);
    optimizer: the config's, or None for its default (Adam); plots: the
    default (--save_valid_plots true) or false. Returns the run's counts
    (`_counted`, profiled), the PNG files under each epoch_<n>/ and the
    port's warnings."""
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
    if optimizer is not None:
        over["optimizer"] = optimizer
    cfg = dict(load_config(None), **over)  # bf16 compute, Adam, warmup_cosine, clip 1.0
    name = f"pallas_train: {cfg['pallas_train']}, {cfg['optimizer']}"
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
        if not plots:
            args += ["--save_valid_plots", "false"]
        t0 = time.perf_counter()
        with _Logged() as warned:
            _, counted = _counted(lambda: cli.main([*args, "-y", str(tmp / "cfg.yaml")],
                                                   standalone_mode=False), profile=True)
        seconds = time.perf_counter() - t0

        n_train, n_valid = epochs * steps, epochs * VALID_STEPS
        core = mode == "core"
        per_step = ((0, 0, 2, 2) if core else (2, 2, 0, 0)) + (15,)

        def valid(n):  # the validation's forward launches
            return (0, 0, 2 * n, 0, None) if core else (2 * n, 0, 0, 0, None)

        check_train_counts(name, counted, n_train, per_step, valid(n_valid),
                           steps_a_graph=n_train)
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

        state = load_train_state(str(tmp / "ckpt" / "train_state.npz"))
        check(state["epoch"] == last, f"train_state.npz does not record epoch {last}")
        if cfg["optimizer"] == "AdaFactor":  # optax's flattening of its state
            check(len(state["opt_leaves"]) == 254,
                  f"AdaFactor's train state has {len(state['opt_leaves'])} leaves, want 254")
        if resume:
            with warned:
                _, resumed = _counted(lambda: cli.main(
                    [*args, "-y", str(tmp / "cfg_more.yaml"), "--resume"],
                    standalone_mode=False))
            check(load_train_state(str(tmp / "ckpt" / "train_state.npz"))["epoch"] == epochs
                  and (tmp / "ckpt" / f"model-epoch{epochs}.npz").exists(),
                  f"--resume did not run epoch {epochs}")
            check_train_counts(f"{name} --resume", resumed, steps, per_step,
                               valid(VALID_STEPS), steps_a_graph=steps)
        pngs = {int(d.name.split("_")[1]): sorted(f.name for f in d.iterdir())
                for d in (tmp / "ckpt").glob("epoch_*")}
    schedule = tuple(counted["counts"][f"train.{k}"]
                     for k in ("eager_steps", "graph_captures", "graph_replays"))
    log(f"train path at {name}: {n_train} train + {n_valid} valid steps of {TRAIN_BATCH} "
        f"chunks in {seconds:.3f} s ({n_train / seconds:.2f} steps/s, "
        f"{n_train * TRAIN_BATCH / seconds:.0f} chunks/s, wall time of the whole command "
        f"with data loading, validation, plots and checkpoints, under torch.profiler from the "
        f"capture on); validation loss {loss0:.5f} -> {loss1:.5f}; (eager steps, captures, "
        f"replays) {schedule}; "
        f"the host issued (block forward, block backward, core forward, core backward, "
        f"threefry) {counted['host']}, a replayed step ran {counted['replayed']} "
        f"({counted['short']} launches short of records)"
        + (f"; --resume ran epoch {epochs}" if resume else ""))
    return counted, pngs, warned.messages


def _adafactor_updates(device, n_updates: int = 3):
    """AdaFactor at the default config's 84 leaf shapes plus one factored
    (130, 136) leaf, from the same f32 parameters and gradients (seed 7,
    gradient norms on both sides of the clip): the parameters after each
    update, and the state's leaves at the end, on the host."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.train.optimizers import build_optimizer, factored_dims

    cfg = dict(load_config(None), optimizer="AdaFactor")
    shapes = [tuple(v.shape) for _, v in
              fft_model.tree_leaves(fft_model.init_params(cfg, prng.key(SEED)))]
    shapes.append((130, 136))
    assert factored_dims(shapes[-1]) is not None and not any(map(factored_dims, shapes[:-1]))
    rng = np.random.default_rng(SEED)
    params = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(device)
              for sh in shapes]
    opt = build_optimizer(cfg, 10)
    state = opt.init(params)
    out = []
    for scale in (0.002, 0.5, 0.02)[:n_updates]:
        grads = [torch.from_numpy((rng.standard_normal(sh) * scale).astype(np.float32))
                 .to(device) for sh in shapes]
        opt.update(grads, state, params)
        out.append([p.detach().clone().cpu() for p in params])
    return out, opt.state_leaves(state)


def _train_step_ms(dev, optimizer: str, rounds: int = 3, steps: int = 5) -> float:
    """The median ms of the default config's train step (bf16, batch 512,
    the block rung) with `optimizer`, host clock around synchronize."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.train.loop import make_train_step
    from seq2squiggle_tpu_torch.train.optimizers import build_optimizer

    cfg = dict(load_config(None), optimizer=optimizer)
    params = fft_model.to_train_params(fft_model.init_params(cfg, prng.key(SEED)), dev)
    opt = build_optimizer(cfg, 1000)
    state = opt.init([v for _, v in fft_model.tree_leaves(params)])
    step = make_train_step(cfg, opt)
    batch, mask = _train_batch(cfg, TRAIN_BATCH, seed=5)
    batch, mask = {k: v.to(dev) for k, v in batch.items()}, mask.to(dev)
    times = []
    for r in range(rounds + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step(params, state, batch, mask, prng.fold_in(prng.key(SEED, dev), r * steps + i))
        torch.cuda.synchronize()
        if r:  # the first round warms up
            times.append((time.perf_counter() - t0) * 1e3 / steps)
    return statistics.median(times)


def phase_train_rest(dev, smi, pngs, warnings):
    """Phase 15: the rest of training and the command line at full width."""
    import importlib.util

    import yaml

    from seq2squiggle_tpu_torch import cli, prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.train.plots import generate_validation_plots, validation_arrays

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    # -- the plots of phase 10's run (two epochs and the resumed third)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    if has_mpl:
        want = sorted(f"batch_{b}_{kind}.png" for b in range(12)
                      for kind in ("reference", "all_signals"))
        check(sorted(pngs) == [0, 1, 2] and all(pngs[e] == want for e in pngs),
              f"phase 10's plots: {pngs}")
        check(not [w for w in warnings if "Validation plots failed" in w],
              f"phase 10 logged {warnings}")
        log(f"plots: phase 10 wrote {sum(map(len, pngs.values()))} PNGs in epoch_0..2, "
            "no plot failed")
    else:
        log("PNGs NOT MADE: no matplotlib")
    # -- the plot arrays on the card against the same call on the CPU
    cfg = load_config(None)
    host = fft_model.init_params(cfg, prng.key(SEED))
    batch, _ = _train_batch(cfg, TRAIN_BATCH, seed=3)
    key = prng.fold_in(prng.key(SEED), 10_000)
    card_params = fft_model.to_train_params(host, dev)
    validation_arrays(card_params, cfg, batch, key.to(dev))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = validation_arrays(card_params, cfg, batch, key.to(dev))
    arrays_s = time.perf_counter() - t0  # ends in the copies to the host
    on_cpu = validation_arrays(fft_model.to_train_params(host, cpu), cfg, batch, key)
    check(np.array_equal(on_card["sampled_dur"], on_cpu["sampled_dur"]),
          "plots: the card sampled other durations than the CPU")
    worst = 0.0
    for name in ("pred_idealtime", "pred_idealamp", "pred_full"):
        a, b = on_card[name], on_cpu[name]
        bar = 2e-3 * np.abs(b) + 2e-4 * cfg["scaling_max_value"]
        check(a.shape == (12, cfg["max_signal_len"]) and bool(np.all(np.abs(a - b) <= bar)),
              f"plots: {name} on the card misses the CPU's by {np.abs(a - b).max()}")
        worst = max(worst, float(np.abs(a - b).max()))
    log(f"plots: arrays of 12 sequences on the card vs the CPU: durations equal, "
        f"max|Δ| {worst:.3g} pA (bar rtol 2e-3 / atol 2e-4 x 165); on the card in "
        f"{arrays_s:.4f} s ({smi})")
    if has_mpl:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            t0 = time.perf_counter()
            generate_validation_plots(card_params, cfg,
                                      {k: v.to(dev) for k, v in batch.items()}, 0, tmp,
                                      key.to(dev))
            plot_s = time.perf_counter() - t0
            check(len(list(pathlib.Path(tmp, "epoch_0").iterdir())) == 24, "plots: 24 PNGs")
        log(f"plots: one epoch's 24 PNGs in {plot_s:.2f} s ({smi})")

    # -- AdaFactor: the train command (phase 10's checks), updates vs the CPU, step time
    counts, _, _ = phase_train_main_path(dev, None, epochs=1, steps=CORE_STEPS, resume=False,
                                         optimizer="AdaFactor", plots=False)
    (card, card_state), (host_upd, host_state) = (_adafactor_updates(dev),
                                                  _adafactor_updates(cpu))
    for i, (a_list, b_list) in enumerate(zip(card, host_upd)):
        for j, (a, b) in enumerate(zip(a_list, b_list)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7,
                                       msg=lambda m: f"AdaFactor update {i} leaf {j}: {m}")
    for j, (a, b) in enumerate(zip(card_state, host_state)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7, err_msg=f"state leaf {j}")
    log(f"AdaFactor: 3 updates of 85 leaves (one factored, (130, 136)) on the card vs the "
        f"CPU within rtol 1e-4 / atol 1e-7; state {len(card_state)} leaves")
    ms = {}
    for name in ("Adam", "AdaFactor", "AdaFactor", "Adam"):  # interleaved
        ms.setdefault(name, []).append(_train_step_ms(dev, name))
    ms = {k: statistics.median(v) for k, v in ms.items()}
    log(f"train step at batch {TRAIN_BATCH}, bf16, block rung: Adam {ms['Adam']:.2f} ms, "
        f"AdaFactor {ms['AdaFactor']:.2f} ms (median of 2 x 3 rounds of 5 steps, host clock "
        f"around synchronize; {smi})")

    # -- sweep: a grid of two trials, one epoch each, launches counted
    steps, n_trials = 3, 2
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = pathlib.Path(tmp)
        rng = np.random.default_rng(SEED + 1)
        _write_chunk_dir(tmp / "train", rng, steps, TRAIN_BATCH, cfg)
        _write_chunk_dir(tmp / "valid", rng, 1, VALID_STEPS * TRAIN_BATCH, cfg)
        (tmp / "cfg.yaml").write_text(yaml.safe_dump({"max_epochs": 1,
                                                       "train_batch_size": TRAIN_BATCH}))
        (tmp / "grid.yaml").write_text(yaml.safe_dump({
            "train_dir": str(tmp / "train"), "valid_dir": str(tmp / "valid"),
            "method": "grid", "parameters": {"lr": {"values": [5e-4, 1e-3]}}}))
        cwd = pathlib.Path.cwd()
        os.chdir(tmp)  # a trial without a model path writes ./logs-<log_name>/
        try:
            t0 = time.perf_counter()
            _, counted = _counted(lambda: cli.main(
                ["sweep", "--sweep-id", str(tmp / "grid.yaml"), "--count", str(n_trials),
                 "-y", str(tmp / "cfg.yaml"), "-s", str(SEED), "-v", "warning"],
                standalone_mode=False))
            sweep_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        counts = counted["host"]
        rows = [json.loads(line) for line in open(tmp / "sweep_results.jsonl")]
    check_train_counts("sweep", counted, n_trials * steps, (2, 2, 0, 0, 15),
                       (2 * n_trials * VALID_STEPS, 0, 0, 0, None), steps_a_graph=steps)
    check(len(rows) == n_trials and all(math.isfinite(r["metrics"]["valid_total_loss"])
                                        for r in rows), f"sweep rows {rows}")
    check([r["params"]["lr"] for r in rows] == [5e-4, 1e-3], "sweep: the grid's order")
    log(f"sweep: grid of {n_trials} trials in {sweep_s:.2f} s, valid_total_loss "
        + ", ".join(f"{r['metrics']['valid_total_loss']:.5f}" for r in rows)
        + f"; launches {counts}")

    # -- version: reports the card
    with _Logged(logging.INFO) as seen:
        cli.main(["version"], standalone_mode=False)
    check(any(torch.cuda.get_device_name(0) in m for m in seen.messages),
          f"version did not name the card: {seen.messages}")
    log(f"version: {[m for m in seen.messages if m.startswith('devices')]}")
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")


PARALLEL_STEPS = 4  # train steps of each phase 16 run


def _rank_env(world: int) -> list:
    """torchrun's variables for `world` ranks of this host, on a free port."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    return [dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(r),
                 WORLD_SIZE=str(world), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world))
            for r in range(world)]


def rank_train(out: str, args) -> int:
    """One rank of a phase 16 `train` (`chip_smoke.py --rank-train OUT ARGS`):
    the command, with the launch counts reset just before and read just
    after, written to OUT with the rank and the group's backend."""
    import torch.distributed as dist

    from seq2squiggle_tpu_torch import cli
    from seq2squiggle_tpu_torch.parallel.distributed import world

    _reset_launch_counts()
    cli.main(list(args), standalone_mode=False)
    torch.cuda.synchronize()
    counts = _launch_counts()
    n, rank = world()
    pathlib.Path(out).write_text(json.dumps({"rank": rank, "world": n,
                                             "backend": dist.get_backend(),
                                             "launches": counts}))
    dist.destroy_process_group()
    return 0


def _two_ranks(tmp: pathlib.Path, args_by_rank, timeout: int = 300) -> list:
    """Run `train` as two processes on the card; their rank_train records."""
    procs = []
    for r, env in enumerate(_rank_env(2)):
        out = tmp / f"rank{r}.json"
        procs.append((out, subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank-train", str(out),
             *args_by_rank[r]], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    records = []
    try:
        for out, proc in procs:
            text = proc.communicate(timeout=timeout)[0]
            check(proc.returncode == 0, f"a rank failed ({proc.returncode}):\n{text[-4000:]}")
            records.append(json.loads(out.read_text()))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return records


def _slab_order_steps(n_slabs: int):
    """Stand-ins for train/loop.py's make_train_step and make_valid_step in a
    one-process run that takes each step as `n_slabs` dp ranks take it: the
    batch cut into their slabs, each slab's loss over the whole batch's valid
    rows with its rows of the global dropout draw (a layout made without a
    process group), and the slabs' gradients and loss terms summed in f32 in
    rank order, as gloo sums them over two ranks. Against a dp run this
    leaves one difference out: the order of the gradient sum."""
    from seq2squiggle_tpu_torch.parallel.mesh import make_mesh
    from seq2squiggle_tpu_torch.train import loop

    slabs = [make_mesh(n_slabs, 1, world=n_slabs, rank=r) for r in range(n_slabs)]

    def slab_terms(params, batch, mask, config, key):
        n_valid = mask.sum()
        for mesh in slabs:
            rows = mesh.local_rows(mask.shape[0])
            slab = {k: v[rows] for k, v in batch.items()}
            prediction, conc, rate, noise = loop.model_forward_train(params, slab, config,
                                                                     key, mesh)
            yield loop.total_loss(prediction, slab["targets"], conc, rate,
                                  slab["chunks_lengths"], noise, slab["stdevs"], mask[rows],
                                  n_valid)[1]

    def summed(a, b):
        return b if a is None else {k: a[k] + b[k] for k in b}

    def make_train_step(config, optimizer, mesh=None):
        def step(params, opt_state, batch, mask, key):
            paths, leaves = zip(*loop.tree_leaves(params))
            grads = metrics = None
            for terms in slab_terms(params, batch, mask, config, key):
                g = torch.autograd.grad(terms["total_loss"], leaves)
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                metrics = summed(metrics, {k: v.detach() for k, v in terms.items()})
            squares = loop.leaf_square_sums(grads)
            metrics["grad_norm"] = torch.sqrt(sum(squares.unbind()))
            metrics.update({f"grad_norm/{'/'.join(p)}": n
                            for p, n in zip(paths, squares.sqrt().unbind())})
            optimizer.update(grads, opt_state, leaves)
            return metrics

        return step

    def make_valid_step(config, mesh=None):
        def step(params, batch, mask):
            metrics = None
            with torch.no_grad():
                for terms in slab_terms(params, batch, mask, config, None):
                    metrics = summed(metrics, terms)
            return metrics

        return step

    return make_train_step, make_valid_step


def _losses(path: pathlib.Path) -> dict:
    return {(r["step"], k): v for line in open(path) for r in [json.loads(line)]
            for k, v in r.items() if k.endswith("_loss")}


def phase_parallel(dev, main_recs):
    """Phase 16: the parallel layer on the one card. Returns the 4-head
    attention core's errors, times and launches."""
    import torch.nn.functional as F
    import yaml

    from seq2squiggle_tpu_torch import cli
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.models.weights import load_checkpoint
    from seq2squiggle_tpu_torch.ops import attn_core as ac
    from seq2squiggle_tpu_torch.train import loop
    from seq2squiggle_tpu_torch.train.loop import load_train_state

    t_phase = time.perf_counter()
    # -- (a) predict: two shards of each batch on the one card
    two = [dev, dev]
    stats, launches, _, recs = _predict_run(dev, "out.blow5", 100, device=two)
    n_batches = math.ceil(stats["chunks"] / BATCH)
    check(stats["dp_shards"] == 2 and stats["wire_bits"] == 2
          and stats["wire_decode"] == {"native": n_batches, "numpy": 0},
          f"two shards at auto: {stats}")
    check(launches == 8 * n_batches, f"two shards: {launches} launches for {n_batches} batches")
    _tier_runs_match("two shards at auto against phase 4", recs, main_recs, exact=True)
    raw1, _, _, raw1_recs = _predict_run(dev, "raw.blow5", 100, wire_format="raw")
    raw2, raw2_launches, _, raw2_recs = _predict_run(dev, "raw.blow5", 100, wire_format="raw",
                                                     device=two)
    check(raw2["dp_shards"] == 2 and raw2_launches == 8 * n_batches, f"two shards raw: {raw2}")
    _tier_runs_match("two shards at raw against one device", raw2_recs, raw1_recs, exact=True)
    log(f"predict over two shards on the card: auto {len(recs)} records equal to phase 4's "
        f"({stats['ksamples_per_s']:.1f} kSamples/s, dp_shards 2, the ULP tier throughout, "
        f"{n_batches} batches by the C++ codec), raw equal to one device's "
        f"({raw2['ksamples_per_s']:.1f} against {raw1['ksamples_per_s']:.1f} kSamples/s); "
        f"fused_fft_block launches {launches} and {raw2_launches} (8 a batch)")

    # -- (c, first) the attention core at 4 heads: a tp = 2 rank's heads
    gen = torch.Generator().manual_seed(SEED)
    core4 = {}
    for dtype, shapes in ((torch.bfloat16, ((TRAIN_BATCH, 250), (3, 37))),
                          (torch.float32, ((64, 250), (3, 37)))):
        for B, L in shapes:
            q, k, v, g = (torch.randn(B, L, 64, generator=gen).to(dev, dtype) for _ in range(4))
            out8 = ac.packed_attention_core_forward(q, k, v, 8)
            grads8 = ac.packed_attention_core_backward(q, k, v, g, 8)
            f_err = b_err = 0.0
            for first in (0, 4):
                cols = slice(8 * first, 8 * first + 32)
                part = [t[..., cols].contiguous() for t in (q, k, v, g)]
                out4 = ac.packed_attention_core_forward(*part[:3], 4)
                grads4 = ac.packed_attention_core_backward(*part, 4)
                torch.cuda.synchronize()
                check(torch.equal(out4, out8[..., cols])
                      and all(torch.equal(a, b[..., cols]) for a, b in zip(grads4, grads8)),
                      f"core at 4 heads {dtype} {B}x{L}: not bit-equal to the 8-head kernel")
                ref = ac.packed_attention_core_reference(*part[:3], 4)
                refs = ac.packed_attention_core_backward_reference(*part, 4)
                f_err = max(f_err, (out4.float() - ref.float()).abs().max().item())
                if dtype == torch.float32:
                    torch.testing.assert_close(out4, ref, rtol=1e-5, atol=1e-5)
                    for a, b in zip(grads4, refs):
                        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
                else:
                    tol = 4 * 2.0 ** -8 * ref.float().abs().max().item()
                    check(f_err <= tol, f"core at 4 heads bf16 {B}x{L}: forward err {f_err}")
                for a, b in zip(grads4, refs):
                    err = (a.float() - b.float()).abs().max().item()
                    check(dtype == torch.float32 or err <= 2 * bf16_tol(b),
                          f"core at 4 heads bf16 {B}x{L}: gradient err {err}")
                    b_err = max(b_err, err)
            msg = (f"core at 4 heads vs plain {str(dtype)[6:]:8s} B={B:4d} L={L:3d}: forward "
                   f"max|err| {f_err:.3g}, gradients {b_err:.3g}, both halves bit-equal to "
                   "the 8-head kernel")
            if dtype == torch.bfloat16 and B == TRAIN_BATCH:
                q4, k4, v4, g4 = (t[..., :32].contiguous() for t in (q, k, v, g))
                core4 = {"fwd_err": f_err, "bwd_err": b_err}
                for _ in range(2):  # 8 heads and 4 in turns
                    for name, fn in (
                            ("fwd8", lambda: ac.packed_attention_core_forward(q, k, v, 8)),
                            ("fwd", lambda: ac.packed_attention_core_forward(q4, k4, v4, 4)),
                            ("bwd8", lambda: ac.packed_attention_core_backward(q, k, v, g, 8)),
                            ("bwd", lambda: ac.packed_attention_core_backward(q4, k4, v4, g4,
                                                                              4))):
                        core4.setdefault(name, []).append(median_ms(fn))
                core4 = {k: (min(t) if isinstance(t, list) else t) for k, t in core4.items()}
                core4["fwd_plain"] = median_ms(
                    lambda: ac.packed_attention_core_reference(q4, k4, v4, 4))
                core4["bwd_plain"] = median_ms(
                    lambda: ac.packed_attention_core_backward_reference(q4, k4, v4, g4, 4))
                def heads4(t):
                    return t.view(B, L, 4, 8).transpose(1, 2)

                qh, kh, vh = (heads4(t).detach().requires_grad_() for t in (q4, k4, v4))
                sdpa = F.scaled_dot_product_attention(qh, kh, vh)
                core4["fwd_library"] = median_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
                core4["bwd_library"] = median_ms(lambda: torch.autograd.grad(
                    sdpa, (qh, kh, vh), heads4(g4), retain_graph=True))
                for d in ("fwd", "bwd"):
                    core4[f"{d}_bound"] = bound(*core_work(TRAIN_BATCH, 250, dtype, d == "bwd",
                                                           D=32), dtype)
                msg += "; ms " + ", ".join(f"{k} {v:.3f}" for k, v in core4.items()
                                           if not isinstance(v, tuple) and "err" not in k)
            log(msg)

    # -- (b) `train` over two processes (dp = 2) against one process
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = pathlib.Path(tmp)
        cfg = dict(load_config(None), max_epochs=1, train_batch_size=TRAIN_BATCH)
        rng = np.random.default_rng(SEED)
        _write_chunk_dir(tmp / "train", rng, 4, PARALLEL_STEPS * TRAIN_BATCH // 4, cfg)
        _write_chunk_dir(tmp / "valid", rng, 1, VALID_STEPS * TRAIN_BATCH, cfg)
        base = {"max_epochs": 1, "train_batch_size": TRAIN_BATCH}
        for name, over in (("bf16", {}), ("f32", {"compute_dtype": "float32",
                                                  "pallas_train": "block"}),
                           ("tp", {"pallas_train": "core"})):
            (tmp / f"{name}.yaml").write_text(yaml.safe_dump(dict(base, **over)))

        def args(yaml_name, model, *extra):
            return ["train", str(tmp / "train"), str(tmp / "valid"), "-y", str(tmp / yaml_name),
                    "-m", str(model), "-s", str(SEED), "-v", "warning",
                    "--save_valid_plots", "false", *extra]

        steps = (2 * (PARALLEL_STEPS + VALID_STEPS), 2 * PARALLEL_STEPS)
        one_state = None
        for name in ("bf16", "f32"):
            t0 = time.perf_counter()
            ranks = _two_ranks(tmp, [args(f"{name}.yaml", tmp / f"{name}{r}" / "model.npz")
                                     for r in range(2)])
            dp_s = time.perf_counter() - t0
            for rec in ranks:
                check(rec["world"] == 2 and rec["backend"] == "gloo"
                      and tuple(rec["launches"]) == (*steps, 0, 0),
                      f"dp = 2 {name}: rank {rec['rank']} ran {rec}, want block launches {steps}")
            check(not any((tmp / f"{name}1").iterdir()), f"dp = 2 {name}: rank 1 wrote files")
            t0 = time.perf_counter()
            _, counted = _counted(lambda: cli.main(
                args(f"{name}.yaml", tmp / f"one_{name}" / "model.npz"), standalone_mode=False))
            one_s = time.perf_counter() - t0
            check_train_counts(f"one process {name}", counted, PARALLEL_STEPS, (2, 2, 0, 0, 15),
                               (2 * VALID_STEPS, 0, 0, 0, None), steps_a_graph=PARALLEL_STEPS)
            got = _losses(tmp / f"{name}0" / "metrics.jsonl")
            p2 = fft_model.tree_leaves(load_checkpoint(str(tmp / f"{name}0" / "model.npz"))[0])

            def against(ref: str):
                """(step-0 losses' worst relative error, later ones', entries
                outside rtol 1e-4 / atol 1e-6, leaves' max|Δ|, entries not
                bit-equal) of the dp run against the one-process run `ref`."""
                want = _losses(tmp / ref / "metrics.jsonl")
                check(set(got) == set(want) and len(got) >= 8, f"logged losses {sorted(got)}")
                err = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
                p1 = fft_model.tree_leaves(load_checkpoint(str(tmp / ref / "model.npz"))[0])
                pairs = [(a, b) for (_, a), (_, b) in zip(p2, p1)]
                return (max(e for (step, _), e in err.items() if step == 0),
                        max(e for (step, _), e in err.items() if step > 0),
                        sum(int(((a - b).abs() > 1e-6 + 1e-4 * b.abs()).sum()) for a, b in pairs),
                        max((a - b).abs().max().item() for a, b in pairs),
                        sum(int((a != b).sum()) for a, b in pairs))

            first, later, outside_bar, worst, unequal = against(f"one_{name}")
            # the step-0 loss comes from the same parameters: the step bar
            # (the JAX package's tests/test_parallel.py: loss rtol 1e-5, leaves
            # rtol 1e-4 / atol 1e-6).
            check(first <= 1e-5, f"dp = 2 {name}: step-0 losses {got} against one process")
            if name == "f32":
                check(later <= 1e-5, f"dp = 2 f32: later losses within {later} of one process's")
                check(outside_bar == 0, f"dp = 2 f32: {outside_bar} parameters outside "
                      f"rtol 1e-4 / atol 1e-6 of one process's (max|Δ| {worst})")
                one_state = load_train_state(str(tmp / "one_f32" / "train_state.npz"))
                held = ""
            else:
                # After step 0 the dp run sums each gradient as two slabs' sums,
                # and the bf16 forwards round that other order up to bf16 steps.
                # One process summing the same two slabs in the same order is
                # the reference at the step bars; the plain one-process run
                # is printed beside it as the witness of what the order moves.
                check(later <= 1e-2, f"dp = 2 bf16: later losses within {later} of one "
                      "process's")
                slab_steps = _slab_order_steps(2)
                _reset_launch_counts()
                with mock.patch.multiple(loop, make_train_step=slab_steps[0],
                                         make_valid_step=slab_steps[1]):
                    cli.main(args(f"{name}.yaml", tmp / "slabs_bf16" / "model.npz"),
                             standalone_mode=False)
                torch.cuda.synchronize()
                check(_launch_counts() == (*(2 * s for s in steps), 0, 0),
                      f"one process over two slabs: {_launch_counts()}")
                s_first, s_later, s_outside, s_worst, s_unequal = against("slabs_bf16")
                check(max(s_first, s_later) <= 1e-5, f"dp = 2 bf16: losses within "
                      f"{max(s_first, s_later)} of one process summing the two slabs")
                check(s_outside == 0, f"dp = 2 bf16: {s_outside} parameters outside rtol "
                      f"1e-4 / atol 1e-6 of one process summing the two slabs (max|Δ| "
                      f"{s_worst})")
                held = (f"; against one process summing the two slabs' gradients in rank "
                        f"order every loss within {max(s_first, s_later):.2g} relative, "
                        f"leaves max|Δ| {s_worst:.3g}, {s_outside} entries outside the bars, "
                        f"{s_unequal} not bit-equal")
            log(f"train over two processes on the card (dp = 2, gloo, {name}, "
                f"{'default config' if name == 'bf16' else 'pallas_train: block'}, "
                f"{PARALLEL_STEPS} + {VALID_STEPS} steps of {TRAIN_BATCH}): block launches "
                f"{steps} on each rank, rank 1 wrote nothing; against one process the step-0 "
                f"losses within {first:.2g} relative, later ones within {later:.2g}; of "
                f"{len(p2)} leaves max|Δ| {worst:.3g}, {outside_bar} entries outside rtol 1e-4 "
                f"/ atol 1e-6, {unequal} not bit-equal{held}; wall {dp_s:.1f} s (two "
                f"processes, start-up included) against {one_s:.1f} s in this one")

        # -- (c) `train --tp 2` at the core rung: each rank its 4 heads
        t0 = time.perf_counter()
        ranks = _two_ranks(tmp, [args("tp.yaml", tmp / f"tp{r}" / "model.npz", "--tp", "2")
                                 for r in range(2)])
        tp_s = time.perf_counter() - t0
        for rec in ranks:
            check(rec["world"] == 2 and rec["backend"] == "gloo"
                  and tuple(rec["launches"]) == (0, 0, *steps),
                  f"tp = 2: rank {rec['rank']} ran {rec}, want core launches {steps}")
        check(not any((tmp / "tp1").iterdir()), "tp = 2: rank 1 wrote files")
        losses = _losses(tmp / "tp0" / "metrics.jsonl")
        cli.main(args("tp.yaml", tmp / "one_tp" / "model.npz"), standalone_mode=False)
        want = _losses(tmp / "one_tp" / "metrics.jsonl")
        check(set(losses) == set(want) and all(math.isfinite(v) for v in losses.values()),
              f"tp = 2: logged losses {losses}")
        tp_err = max(abs(losses[k] - want[k]) / abs(want[k]) for k in want)
        # the row-parallel products sum their two halves in another order, and
        # bf16 rounds that: phase 6's bf16 bar
        check(tp_err <= 1e-2, f"tp = 2: losses {losses} against one process's {want}")
        state = load_train_state(str(tmp / "tp0" / "train_state.npz"))
        check([np.shape(x) for x in state["opt_leaves"]]
              == [np.shape(x) for x in one_state["opt_leaves"]],
              "tp = 2: train_state.npz does not hold the whole leaves")
        core4["launches_fwd"], core4["launches_bwd"] = ranks[0]["launches"][2:]
        log(f"train --tp 2 at pallas_train: core over two processes on the card: core "
            f"launches {steps} on each rank (4 heads each), rank 1 wrote nothing, losses "
            f"within {tp_err:.2g} relative of one process's, "
            f"{len(state['opt_leaves'])} whole optimizer leaves; wall {tp_s:.1f} s")
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return core4


# phase 17's slowed decode: its first batch held long enough for the dispatch
# loop (~0.15 s a batch) to fill the queues behind it, then each batch slowed
PIPELINE_HOLD_S = 2.0
PIPELINE_SLOW_S = 0.03


def _stage_threads() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate() if t.name.startswith("seq2squiggle-"))


def gamma_inputs(B: int, seed: int, dev):
    """Phase 18's inputs: the run key of a seed that fills both words, conc
    log-uniform over [0.01, 60] (a < 1 takes the boost), rate over
    [0.05, 5], read indices with the last eighth of the rows padding (-1)
    and chunk offsets, all on `dev`."""
    from seq2squiggle_tpu_torch import prng

    rng = np.random.default_rng(seed)
    K = GAMMA_K
    conc = np.exp(rng.uniform(np.log(0.01), np.log(60.0), (B, K))).astype(np.float32)
    rate = np.exp(rng.uniform(np.log(0.05), np.log(5.0), (B, K))).astype(np.float32)
    read_idx = rng.integers(0, 2 ** 31 - 1, B).astype(np.int32)
    read_idx[B - max(1, B // 8):] = -1
    chunk_off = rng.integers(0, 400, B).astype(np.int32)
    on_dev = [torch.from_numpy(a).to(dev) for a in (read_idx, chunk_off, conc, rate)]
    return (prng.key((seed << 32) + 2 ** 31 + seed, dev), *on_dev)


def hold_gamma_kernel(dev, B: int, seed: int = SEED, min_duration: float = 3.0) -> dict:
    """Phase 18's bars at batch B: the Gamma dwell kernel against its plain
    version on the card (keys bit-equal, draws rtol 1e-5 on >= 99.9 %,
    rounded durations equal on >= 99.9 %). Returns the shares."""
    from seq2squiggle_tpu_torch import prng, sampling
    from seq2squiggle_tpu_torch.ops import threefry

    base, read_idx, chunk_off, conc, rate = gamma_inputs(B, seed, dev)
    keys, dur = threefry.chunk_keys_and_durations(base, read_idx, chunk_off, conc, rate,
                                                  min_duration)
    ref_keys = threefry.chunk_keys_reference(base, read_idx, chunk_off)
    ref_dur = threefry.durations_reference(prng.fold_in(ref_keys, 1), conc, rate, min_duration)
    draws = threefry.sample_gamma_durations(prng.fold_in(keys, 1), conc, rate)
    ref = sampling.sample_gamma_durations(prng.fold_in(ref_keys, 1), conc, rate)
    own = torch.round(draws.clamp_min(1.0).clamp_min(min_duration)).to(torch.int32)
    torch.cuda.synchronize(dev)
    check(torch.equal(keys, ref_keys), f"gamma kernel B={B}: chunk keys differ")
    check(torch.equal(threefry.chunk_keys(base, read_idx, chunk_off), ref_keys),
          f"gamma kernel B={B}: the keys-only launch's keys differ")
    check(bool(torch.isfinite(draws).all()), f"gamma kernel B={B}: non-finite draws")
    got = {
        "B": B,
        "exact_share": (draws.view(torch.int32) == ref.view(torch.int32)).float().mean().item(),
        "close_share": 1.0 - outside(draws, ref, 1e-5, 0.0),
        "durations_equal": (dur == ref_dur).float().mean().item(),
        "max_rel_err": ((draws - ref).abs() / ref.abs().clamp_min(1e-30)).max().item(),
    }
    check(got["close_share"] >= 0.999, f"gamma kernel B={B}: draws within rtol 1e-5 on only "
          f"{got['close_share']:.5f}")
    check(got["durations_equal"] >= 0.999, f"gamma kernel B={B}: durations equal on only "
          f"{got['durations_equal']:.5f}")
    check(torch.equal(dur, own), f"gamma kernel B={B}: durations are not its draws rounded")
    return got


def gamma_work(B: int, K: int, boosted: int):
    """Bytes and integer operations the Gamma dwell draw needs at least: conc
    and rate in, the counts and chunk keys out, the indices in; 3 threefry
    blocks of key chain and 5 of a first round an element, 2 more for each
    boosted element (a < 1)."""
    n_bytes = B * K * (4 + 4 + 4) + B * (4 + 4 + 16) + 16
    return n_bytes, (8 * B * K + 2 * boosted) * THREEFRY_OPS


def phase_gamma(dev, main_recs, smi) -> dict:
    """Phase 18: the Gamma dwell kernel against its plain version, its time,
    and the main path through it. Returns what it measured."""
    from seq2squiggle_tpu_torch import prng, tracing
    from seq2squiggle_tpu_torch.ops import threefry

    t_phase = time.perf_counter()
    held = {B: hold_gamma_kernel(dev, B) for B in (BATCH, GAMMA_RAGGED)}
    for B, got in held.items():
        log(f"phase 18 gamma kernel vs plain B={B:4d} K={GAMMA_K}: keys bit-equal, draws "
            f"exact {got['exact_share']:.6f}, within rtol 1e-5 {got['close_share']:.6f} "
            f"(max rel err {got['max_rel_err']:.3g}), durations equal "
            f"{got['durations_equal']:.6f}")

    base, read_idx, chunk_off, conc, rate = gamma_inputs(BATCH, SEED, dev)
    ms = median_ms(lambda: threefry.chunk_keys_and_durations(
        base, read_idx, chunk_off, conc, rate, 3.0))

    def plain():
        keys = threefry.chunk_keys_reference(base, read_idx, chunk_off)
        return keys, threefry.durations_reference(prng.fold_in(keys, 1), conc, rate, 3.0)

    plain_ms = median_ms(plain, iters=5, warmup=1)
    n_bytes, ops = gamma_work(BATCH, GAMMA_K, int((conc < 1.0).sum().item()))
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, ops / PEAK_INT32_OPS * 1e3
    bound_ms, bound_by = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
    log(f"phase 18 gamma kernel ({BATCH}, {GAMMA_K}): {ms:.4f} ms a launch, plain version "
        f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}) [{smi}]")

    os.environ["SEQ2SQUIGGLE_TPU_TIMERS"] = "1"
    try:
        threefry.launches = 0
        stats, _, _, recs = _predict_run(dev, "out.blow5", 100)
        launches = threefry.launches
    finally:
        del os.environ["SEQ2SQUIGGLE_TPU_TIMERS"]
        tracing.switch_from_env()
    n_batches = math.ceil(stats["chunks"] / BATCH)
    timers = stats["timers"]
    check(launches == n_batches, f"phase 18: {launches} gamma launches for {n_batches} batches")
    check("sampling.gamma_plain" not in timers
          and timers.get("sampling.gamma_kernel") == BATCH * n_batches,
          f"phase 18: rows drawn {timers.get('sampling.gamma_kernel')} by the kernel, "
          f"{timers.get('sampling.gamma_plain')} by the plain path, for {n_batches} batches")
    _tier_runs_match("phase 18 against phase 4", recs, main_recs, exact=True)
    log(f"phase 18 main path: {launches} gamma launches for {n_batches} batches, "
        f"{timers['sampling.gamma_kernel']} rows by the kernel and none by the plain path, "
        f"records equal to phase 4's; sampling {1e3 * timers['sampling'] / n_batches:.3f} ms "
        f"a batch, {stats['ksamples_per_s']:.1f} kSamples/s [{smi}]")
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return {"held": held, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "launches": launches}


def mask_key(dev, seed: int = SEED):
    """Phase 19's key: a seed that fills both words."""
    from seq2squiggle_tpu_torch import prng

    return prng.key((seed << 32) + 2 ** 31 + seed, dev)


def hold_key_kernel(dev, seed: int = SEED) -> int:
    """Phase 19's key bars: fold_in, split and split(fold_in) through the
    kernel bit-equal to prng.py's torch ops on the card, for one key and a
    batch of 37. Returns the number of keys held."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.ops import threefry

    key = mask_key(dev, seed)
    batch = prng.split(key, 37)
    pairs = [(threefry.fold_in(k, d), prng.fold_in(k, d))
             for k in (key, batch) for d in (0, 1, 7, 10_000, 2 ** 32 - 1)]
    pairs += [(threefry.split(k, n), prng.split(k, n)) for k in (key, batch) for n in (2, 4)]
    pairs += [(threefry.fold_in_split(k, n), threefry.fold_in_split_reference(k, n))
              for k in (key, batch) for n in (1, 2)]
    torch.cuda.synchronize(dev)
    for i, (got, ref) in enumerate(pairs):
        check(got.shape == ref.shape and torch.equal(got, ref), f"key derivation {i} differs")
    return sum(ref.numel() // 2 for _, ref in pairs)


def hold_mask_kernel(dev, shape, rows=None, start: int = 0, seed: int = SEED) -> dict:
    """Phase 19's mask bars at one shape (rows [start, start + shape[0]) of a
    draw of `rows`): the bool mask and the bf16 and f32 scales through the
    kernel bit-equal to prng.py's torch ops on the card, at each keep of
    MASK_KEEPS. Returns the kept shares and the largest absolute difference
    between the kernel's masks or scales and the plain path's (0 when they
    are bit-equal)."""
    from seq2squiggle_tpu_torch.ops import threefry

    key, kept, err = mask_key(dev, seed), {}, 0.0
    for keep in MASK_KEEPS:
        got = threefry.bernoulli(key, keep, shape, rows, start)
        ref = threefry.bernoulli_reference(key, keep, shape, rows, start)
        err = max(err, (got.int() - ref.int()).abs().max().item())
        check(got.dtype == torch.bool and torch.equal(got, ref),
              f"mask {shape} rows {rows} start {start} keep {keep}: differs")
        for dt, bits in ((torch.bfloat16, torch.int16), (torch.float32, torch.int32)):
            got_s = threefry.dropout_scales(key, keep, shape, dt, rows, start)
            ref_s = threefry.dropout_scales_reference(key, keep, shape, dt, rows, start)
            err = max(err, (got_s.float() - ref_s.float()).abs().max().item())
            check(got_s.dtype == dt and torch.equal(got_s.view(bits), ref_s.view(bits)),
                  f"scales {dt} {shape} rows {rows} start {start} keep {keep}: differ")
        kept[keep] = got.float().mean().item()
    return {"kept": kept, "max_abs_err": err}


def _plain_draws():
    """The train step's threefry through prng.py's torch ops on any device."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.ops import threefry

    return mock.patch.multiple(threefry, fold_in=prng.fold_in, split=prng.split,
                               fold_in_split=threefry.fold_in_split_reference,
                               bernoulli=threefry.bernoulli_reference,
                               dropout_scales=threefry.dropout_scales_reference)


def hold_train_step(dev, B: int = TRAIN_BATCH) -> dict:
    """One `make_train_step` call at the default config (bf16, the block
    rung) through the kernels and through prng.py's torch ops, from the same
    parameters, batch and key: the loss and every gradient bit-equal.
    Returns the loss and the leaves held."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.train.loop import make_train_step
    from seq2squiggle_tpu_torch.train.optimizers import build_optimizer

    cfg = load_config(None)
    host = fft_model.init_params(cfg, prng.key(SEED))
    batch, mask = _train_batch(cfg, B, seed=6)
    batch, mask = {k: v.to(dev) for k, v in batch.items()}, mask.to(dev)

    def one_step():
        params = fft_model.to_train_params(host, dev)
        opt = build_optimizer(cfg, 100)
        state = opt.init([v for _, v in fft_model.tree_leaves(params)])
        seen = []
        update = opt.update
        opt.update = lambda grads, *a: (seen.extend(g.clone() for g in grads), update(grads, *a))
        metrics = make_train_step(cfg, opt)(params, state, batch, mask,
                                            prng.fold_in(prng.key(SEED, dev), 3))
        return metrics["total_loss"], seen

    loss, grads = one_step()
    with _plain_draws():
        plain_loss, plain_grads = one_step()
    torch.cuda.synchronize(dev)
    check(len(grads) == len(plain_grads) > 0, "train step: no gradients seen")
    check(torch.equal(loss, plain_loss), f"train step loss {loss.item()} vs plain "
          f"{plain_loss.item()}")
    differ = [i for i, (a, b) in enumerate(zip(grads, plain_grads)) if not torch.equal(a, b)]
    check(not differ, f"train step: gradients {differ} differ from the plain draws'")
    return {"loss": loss.item(), "leaves": len(grads)}


def step_draws(cfg: dict, B: int) -> list:
    """The 11 dropout draws of one default train step: (kind, shape), the
    encoder's 4 and the heads' 3 masks at (B, K, D), the decoder's 4 scales
    at (B, T, D)."""
    K, T, D = cfg["max_dna_len"], cfg["max_signal_len"], cfg["dmodel"]
    return [("mask", (B, K, D))] * 7 + [("scales", (B, T, D))] * 4


def phase_masks(dev, smi) -> dict:
    """Phase 19: the train step's threefry kernels against prng.py's torch
    ops, a train step through each, their times, and the `train` command
    through the kernels. Returns what it measured."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.ops import threefry

    t_phase = time.perf_counter()
    n_keys = hold_key_kernel(dev)
    log(f"phase 19 keys: {n_keys} keys from fold_in, split and split(fold_in) bit-equal to "
        f"prng.py's on the card")
    held = {}
    for shape, rows, start in MASK_CASES:
        held[str(shape) + (f" rows {start}..{start + shape[0] - 1} of {rows}" if rows else "")] = \
            got = hold_mask_kernel(dev, shape, rows, start)
        log(f"phase 19 masks {shape} rows {rows or shape[0]} from {start}: bool, bf16 and f32 "
            f"bit-equal to prng.py's at keep {MASK_KEEPS} (max abs err {got['max_abs_err']}), "
            f"kept shares {got['kept']}")
    step = hold_train_step(dev)
    log(f"phase 19 train step (bf16, block, batch {TRAIN_BATCH}): loss {step['loss']:.6f} and "
        f"{step['leaves']} gradient leaves bit-equal, kernels against prng.py's torch ops")

    cfg = load_config(None)
    key = mask_key(dev)
    draws = step_draws(cfg, TRAIN_BATCH)
    keys = prng.split(key, len(draws))

    def run(bernoulli, scales):
        for (kind, shape), k in zip(draws, keys):
            if kind == "mask":
                bernoulli(k, 0.8, shape)
            else:
                scales(k, 0.8, shape, torch.bfloat16)

    big = (TRAIN_BATCH, cfg["max_signal_len"], cfg["dmodel"])
    times = {
        "draw_ms": median_ms(lambda: threefry.dropout_scales(key, 0.8, big, torch.bfloat16)),
        "draw_plain_ms": median_ms(
            lambda: threefry.dropout_scales_reference(key, 0.8, big, torch.bfloat16),
            iters=5, warmup=1),
        "step_draws_ms": median_ms(lambda: run(threefry.bernoulli, threefry.dropout_scales)),
        "step_draws_plain_ms": median_ms(
            lambda: run(threefry.bernoulli_reference, threefry.dropout_scales_reference),
            iters=5, warmup=1),
    }
    n_elems = sum(math.prod(shape) for _, shape in draws)
    out_bytes = sum(math.prod(shape) * (1 if kind == "mask" else 2) for kind, shape in draws)
    for name, n, n_bytes in (("draw", math.prod(big), 2 * math.prod(big)),
                             ("step_draws", n_elems, out_bytes)):
        by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, n * THREEFRY_OPS / PEAK_INT32_OPS * 1e3
        times[f"{name}_bound_ms"], times[f"{name}_bound_by"] = (
            (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations"))
    log(f"phase 19 times: one {big} bf16 draw {times['draw_ms']:.4f} ms (plain "
        f"{times['draw_plain_ms']:.3f} ms, bound {times['draw_bound_ms']:.5f} ms "
        f"{times['draw_bound_by']}); one step's 11 draws {times['step_draws_ms']:.4f} ms "
        f"(plain {times['step_draws_plain_ms']:.3f} ms, bound {times['step_draws_bound_ms']:.5f} "
        f"ms {times['step_draws_bound_by']}) [{smi}]")

    # the `train` command through the kernels, the spans and counters on
    import yaml

    from seq2squiggle_tpu_torch import cli

    over = {"max_epochs": 1, "train_batch_size": TRAIN_BATCH}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = pathlib.Path(tmp)
        rng = np.random.default_rng(SEED)
        _write_chunk_dir(tmp / "train", rng, 4, TRAIN_STEPS * TRAIN_BATCH // 4, cfg)
        _write_chunk_dir(tmp / "valid", rng, 1, VALID_STEPS * TRAIN_BATCH, cfg)
        (tmp / "cfg.yaml").write_text(yaml.safe_dump(over))
        _, got = _counted(lambda: cli.main(
            ["train", str(tmp / "train"), str(tmp / "valid"), "-m",
             str(tmp / "ckpt" / "model.npz"), "-s", str(SEED), "-v", "warning",
             "--save_valid_plots", "false", "-y", str(tmp / "cfg.yaml")],
            standalone_mode=False), profile=True)
    # 15 threefry launches in the step's body, the step key's fold_in in train_run
    eager, captures, replays = check_train_counts(
        "phase 19 train", got, TRAIN_STEPS, (2, 2, 0, 0, 15),
        (2 * VALID_STEPS, 0, 0, 0, TRAIN_STEPS), steps_a_graph=TRAIN_STEPS)
    hosted, counts, launches = eager + captures, got["counts"], got["host"][4]
    check("train.masks_plain" not in counts
          and counts.get("train.masks_kernel") == hosted * n_elems,
          f"phase 19 train: elements drawn {counts} for {hosted} eager steps and captures of "
          f"{n_elems}")
    check(got["masks_spans"] == 11 * hosted,
          f"phase 19 train: {got['masks_spans']} train.masks spans for {hosted} eager steps "
          "and captures (a replayed step issues no draw from the host)")
    masks_ms = 1e3 * got["totals"].wall("train.masks") / TRAIN_STEPS
    step_ms = 1e3 * got["totals"].wall("train.step") / TRAIN_STEPS
    log(f"phase 19 train path: {TRAIN_STEPS} steps, {eager} eager, {captures} capture, "
        f"{replays} replays; the host issued {launches} threefry launches (15 a step into the "
        f"eager step and the capture, the step keys' {TRAIN_STEPS}), "
        f"{counts['train.masks_kernel']} elements by the kernel and none by the plain path; "
        f"a replayed step ran {got['replayed'][4]:.0f} threefry kernels and (block forward, "
        f"block backward, core forward, core backward) {got['replayed'][:4]} (torch.profiler "
        f"from the capture on; {got['short']} of {replays} launches short of records); "
        f"train.masks {masks_ms:.3f} ms a step of train.step {step_ms:.2f} ms (host spans); "
        f"host block launches {got['host'][:4]}")
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return {"held": held, "keys": n_keys, "step": step, **times, "launches": launches,
            "masks_ms": masks_ms, "step_ms": step_ms, "train_counts": counts,
            "block_launches": got["host"][:4], "replayed": got["replayed"]}


# device kernels by the wrapper counter they answer to: (group, part of the kernel's name)
KERNEL_GROUPS = (("block_fwd", "block_train_fwd"), ("block_bwd", "bwd_rows"),
                 ("core_fwd", "attn_core_fwd"), ("attn_core_bwd", "attn_core_bwd"),
                 ("dropout_draw", "dropout_draw_kernel"), ("threefry_keys", "threefry_keys_kernel"))


def _kernel_counts(names) -> tuple:
    """Device kernel events counted by the names of the wrappers' counters:
    (block forward, block backward, core forward, core backward, threefry),
    `_host_counts`' order. The core's backward kernel also runs in the
    block backward's attention stage, once a call, which is taken off;
    threefry is the dropout draws and key derivations, as threefry.launches
    counts them in a train step."""
    n = dict.fromkeys((g for g, _ in KERNEL_GROUPS), 0)
    for name in names:
        for group, part in KERNEL_GROUPS:
            if part in name:
                n[group] += 1
    return (n["block_fwd"], n["block_bwd"], n["core_fwd"], n["attn_core_bwd"] - n["block_bwd"],
            n["dropout_draw"] + n["threefry_keys"])


GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def _graph_kernels(events) -> dict:
    """The graph launches in a profile's kineto events and the device
    kernels each ran (a kernel a graph ran carries its launch's correlation
    id): `launches`; `by_launch`, {(device events, `_kernel_counts`): the
    launches, in order}; `kernels`, the counts of the launches most alike,
    which is what every launch of one graph runs; `short`, the launches
    with fewer events, none more in any group: records the profiler lost
    (seen once in a whole chip_smoke.py run, never in a process of its own)."""
    events = list(events)
    graphs = sorted(e.correlation_id() for e in events if e.name() in GRAPH_LAUNCHES)
    ran = {g: [] for g in graphs}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.correlation_id() in ran:
            ran[e.correlation_id()].append(e.name())
    by_launch = {}
    for i, g in enumerate(graphs):
        by_launch.setdefault((len(ran[g]), _kernel_counts(ran[g])), []).append(i)
    if not by_launch:
        return {"launches": 0, "by_launch": {}, "kernels": None, "short": 0}
    (n, kernels), _ = max(by_launch.items(), key=lambda item: len(item[1]))
    short = [i for (m, k), idx in by_launch.items() if (m, k) != (n, kernels)
             and m < n and all(a <= b for a, b in zip(k, kernels)) for i in idx]
    check(len(short) + len(by_launch[n, kernels]) == len(graphs),
          f"graph launches ran different kernels: {by_launch}")
    return {"launches": len(graphs), "by_launch": by_launch, "kernels": kernels,
            "short": len(short)}


def _host_counts() -> tuple:
    """The wrappers' launch counters: `_launch_counts` and threefry.launches."""
    from seq2squiggle_tpu_torch.ops import threefry

    return (*_launch_counts(), threefry.launches)


def _counted(run, profile: bool = False):
    """run() with the span recorder on and every launch counter at 0. Returns
    run's result and what was counted: the recorder's `counts`, its
    `train.masks` spans and its `totals`; `host`, the wrappers' counters
    (`_host_counts`), which count the launches the host issues, on eager
    steps and into captures. Where `profile`, torch.profiler records the host and the
    card from the end of the run's first capture of a train step (a
    capture is never profiled; run only one TrainStep), in which all the
    replays fall: `replayed` is, by `_kernel_counts`' groups, the kernels
    a graph launch ran, a replayed step's kernels; `graph_launches` their
    number, `by_launch` and `short` as `_graph_kernels` gives them."""
    from torch.profiler import ProfilerActivity, profile as profiler

    from seq2squiggle_tpu_torch import tracing
    from seq2squiggle_tpu_torch.ops import threefry
    from seq2squiggle_tpu_torch.train import loop

    window = {}
    real = loop.TrainStep._capture

    def capture(self, *args, **kw):
        graph = real(self, *args, **kw)
        if profile and "prof" not in window:
            torch.cuda.synchronize()
            window["prof"] = profiler(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
            window["prof"].start()
        return graph

    os.environ[tracing.ENV] = "1"
    tracing.switch_from_env()
    tracing.reset()
    threefry.launches = 0
    _reset_launch_counts()
    try:
        with mock.patch.object(loop.TrainStep, "_capture", capture):
            out = run()
        torch.cuda.synchronize()
        if "prof" in window:
            window["prof"].stop()
        got = tracing.totals()
    finally:
        del os.environ[tracing.ENV]
        tracing.switch_from_env()
        tracing.reset()
    info = {"counts": dict(got.counts), "masks_spans": got.spans.get("train.masks", (0,))[0],
            "host": _host_counts(), "totals": got}
    if "prof" in window:
        graphs = _graph_kernels(window["prof"].profiler.kineto_results.events())
        info["graph_launches"], info["by_launch"] = graphs["launches"], graphs["by_launch"]
        info["replayed"], info["short"] = graphs["kernels"], graphs["short"]
    return out, info


def check_train_counts(what, got, n_train, per_step, host_extra, steps_a_graph=None):
    """The counts of a run of one or more TrainSteps on one card: every one
    of n_train steps ran once, as an eager step or a replay, with one
    capture for each graph; the wrappers counted `per_step` launches
    (`_host_counts`' order) for each step the host issued (eager steps and
    captures) plus `host_extra` (validation, the step keys; None: not
    checked); where profiled, a replayed step ran `per_step` kernels. steps_a_graph: the
    steps of each TrainStep, where each has one batch shape (one eager
    step, one capture). Returns (eager steps, captures, replays)."""
    c = got["counts"]
    eager, captures, replays = (c.get(f"train.{k}", 0)
                                for k in ("eager_steps", "graph_captures", "graph_replays"))
    check(eager + replays == n_train and captures > 0 and eager <= 2 * captures,
          f"{what}: {eager} eager steps, {captures} captures and {replays} replays for "
          f"{n_train} steps")
    if steps_a_graph is not None:
        check(eager == captures == n_train // steps_a_graph,
              f"{what}: {eager} eager steps and {captures} captures, want one each for each "
              f"{steps_a_graph} steps")
    want = tuple(None if x is None else s * (eager + captures) + x
                 for s, x in zip(per_step, host_extra))
    check(all(w is None or h == w for h, w in zip(got["host"], want)),
          f"{what}: the host issued (block forward, block backward, core forward, core "
          f"backward, threefry) {got['host']}, want {want} for {eager} eager steps and "
          f"{captures} captures")
    if "replayed" in got:
        check(got["graph_launches"] == replays and got["replayed"] == per_step
              and got["short"] <= max(1, replays // 10),
              f"{what}: {got['graph_launches']} graph launches for {replays} replays ran "
              f"{got['replayed']} kernels a replay, want {per_step}, {got['short']} launches "
              f"short of records ((device events, kernels) of each launch {got['by_launch']})")
    return eager, captures, replays


# phase 20: (pallas_train, compute dtype, optimizer, lr schedule) of each run
GRAPH_CASES = (("block", "bfloat16", "Adam", "warmup_cosine"),
               ("core", "bfloat16", "Adam", "warmup_cosine"),
               (False, "bfloat16", "Adam", "warmup_cosine"),
               ("block", "float32", "Adam", "warmup_cosine"),
               (False, "float32", "Adam", "warmup_cosine"),
               ("block", "bfloat16", "AdamW", "one_cycle"),
               ("block", "bfloat16", "RAdam", "constant"),
               ("block", "bfloat16", "SGD", "warmup_constant"),
               ("block", "bfloat16", "RMSProp", "warmup_cosine_restarts"),
               ("block", "bfloat16", "AdaFactor", "warmup_cosine"))


def _graph_schedule(keys) -> tuple:
    """(eager steps, captures, replays, the calls the host issued) of
    TrainStep calls with these graph keys in turn: a key's first call
    eager, its second a capture (and its replay), later ones replays, until
    the key changes."""
    eager = captures = replays = 0
    graph = warmed = None
    hosted = []
    for i, k in enumerate(keys):
        if k == graph:
            replays += 1
            continue
        if k != warmed:
            warmed, eager = k, eager + 1
        else:
            graph, captures, replays = k, captures + 1, replays + 1
        hosted.append(i)
    return eager, captures, replays, hosted


def hold_graphed_step(dev, mode="block", dtype: str = "bfloat16", optimizer: str = "Adam",
                      schedule: str = "warmup_cosine", steps: int = GRAPH_STEPS) -> dict:
    """Phase 20's bars for one run of GRAPH_CASES: `steps` default steps at
    batch TRAIN_BATCH, then 3 at half of it, from one start, through the
    step (an eager warm-up, a capture, replays; again at the new shape, and
    where RAdam's branch flips, which it does at its 6th update) and through
    its `eager` on a copy: parameters, the optimizer's state and every
    metric bit-equal; the eager steps, captures and replays that the graph
    keys call for; the wrappers' launches (16 threefry launches a step, the
    step key's fold_in as train_run derives it among them) for each step
    the host issued, and `train.masks` spans and drawn elements on those
    steps only. Then, from a profile of 3 more replays, a replayed step's
    kernels by `_kernel_counts`' groups and its launches. Returns the
    graphed run's counts and the replays' kernels."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.ops import threefry
    from seq2squiggle_tpu_torch.train.loop import make_train_step
    from seq2squiggle_tpu_torch.train.optimizers import build_optimizer, radam_rectifier

    cfg = dict(load_config(None), pallas_train=mode, compute_dtype=dtype, optimizer=optimizer,
               lr_schedule=schedule, warmup_ratio=0.2)
    host = fft_model.init_params(cfg, prng.key(SEED))
    base = prng.key(SEED, dev)
    shapes = [TRAIN_BATCH] * steps + [TRAIN_BATCH // 2] * 3
    feeds = []
    for i, B in enumerate(shapes):
        batch, mask = _train_batch(cfg, B, seed=40 + i)
        feeds.append(({k: v.to(dev) for k, v in batch.items()}, mask.to(dev)))
    n = len(feeds)

    def run(graphed):
        params = fft_model.to_train_params(host, dev)
        opt = build_optimizer(cfg, n)  # the schedule's whole course, warm-up's end included
        state = opt.init([v for _, v in fft_model.tree_leaves(params)])
        step = make_train_step(cfg, opt)
        metrics, got = _counted(lambda: [
            (step if graphed else step.eager)(params, state, batch, mask,
                                              threefry.fold_in(base, i))
            for i, (batch, mask) in enumerate(feeds)])
        return step, opt, params, state, metrics, got

    what = f"graphed steps at {mode}, {dtype}, {optimizer}, {schedule}"
    (step, opt, p1, s1, m1, c1), (_, _, p2, s2, m2, c2) = run(True), run(False)
    leaves = [(a, b) for (_, a), (_, b) in zip(fft_model.tree_leaves(p1),
                                               fft_model.tree_leaves(p2))]
    differ = [i for i, (a, b) in enumerate(leaves) if not torch.equal(a, b)]
    differ += [f"state {i}" for i, (a, b) in enumerate(zip(opt.state_leaves(s1),
                                                          opt.state_leaves(s2)))
               if not (a.dtype == b.dtype and a.tobytes() == b.tobytes())]
    check(not differ, f"{what}: parameters or state {differ} differ from the eager steps'")
    bad = [(i, k) for i, (a, b) in enumerate(zip(m1, m2)) for k in b
           if not torch.equal(a[k], b[k])]
    check(all(a.keys() == b.keys() for a, b in zip(m1, m2)) and not bad,
          f"{what}: metrics {bad[:5]} differ")
    rectified = [radam_rectifier(i + 1) is not None if optimizer == "RAdam" else None
                 for i in range(n)]
    eager, captures, replays, hosted = _graph_schedule(list(zip(shapes, rectified)))
    got = [c1["counts"].get(f"train.{k}") for k in ("eager_steps", "graph_captures",
                                                    "graph_replays")]
    check(got == [eager, captures, replays],
          f"{what}: (eager, captures, replays) {got}, want {[eager, captures, replays]}")
    # an eager step's launches, the step key's fold_in among threefry's
    rung = {"block": (2, 2, 0, 0), "core": (0, 0, 2, 2)}.get(mode, (0, 0, 0, 0))
    per_step = (*rung, c2["host"][4] // n - 1)
    check(c2["counts"]["train.eager_steps"] == n
          and not [k for k in c2["counts"] if k.startswith("train.graph")]
          and c2["host"] == tuple(s * n for s in rung) + ((per_step[4] + 1) * n,)
          and (mode not in ("block", "core") or per_step[4] == 15),
          f"eager steps at {what}: {c2}")
    check_train_counts(what, c1, n, per_step, (0, 0, 0, 0, n))
    # the draws: as many spans a step, elements in proportion to its rows
    rows, rows_hosted = sum(shapes), sum(shapes[i] for i in hosted)
    elems, spans = (c2["counts"].get("train.masks_kernel", 0), c2["masks_spans"])
    check("train.masks_plain" not in c1["counts"] and spans % n == 0
          and c1["masks_spans"] == spans // n * len(hosted)
          and c1["counts"].get("train.masks_kernel", 0) * rows == elems * rows_hosted,
          f"{what}: train.masks spans {c1['masks_spans']} graphed, {spans} eager; elements "
          f"{c1['counts'].get('train.masks_kernel')} graphed, {elems} eager")

    batch, mask = feeds[-1]
    keys = [threefry.fold_in(base, n + i) for i in range(3)]
    traced = _device_trace(lambda: [step(p1, s1, batch, mask, k) for k in keys])
    graphs = traced["graphs"]
    replayed = graphs["kernels"]
    check(traced["graph_launches"] == graphs["launches"] == 3 and replayed == per_step
          and graphs["short"] <= 1,
          f"{what}: 3 more replays ran {traced['graph_launches']} graphs and kernels "
          f"{graphs['by_launch']}, want {per_step}; all the window's kernels "
          f"{traced['kernels']}")
    return {"counts": c1["counts"], "host": c1["host"], "eager_host": c2["host"],
            "schedule": (eager, captures, replays), "leaves": len(leaves), "per_step": per_step,
            "replayed": replayed, "replay_launches": traced["launches"] / 3,
            "replay_device_events": traced["device_events"] / 3,
            "loss": [float(m["total_loss"]) for m in m1]}


def _old_adam_update(opt, grads, state, params) -> None:
    """The default Adam update as it was before its scalars were device
    tensors: Python numbers, which torch on the card multiplies by as
    reciprocals where they divide."""
    from seq2squiggle_tpu_torch.train.optimizers import _update_moments, clip_by_global_norm

    with torch.no_grad():
        grads = clip_by_global_norm(grads, opt.clip)
        lr = opt.schedule(state["sched_count"])
        state["sched_count"] += 1
        state["count"] += 1
        count = state["count"]
        for g, p, mu, nu in zip(grads, params, state["mu"], state["nu"]):
            _update_moments(g, mu, nu, 0.9, 0.999)
            mu_hat = mu / (1 - 0.9 ** count)
            nu_hat = nu / (1 - 0.999 ** count)
            p.add_((mu_hat / (nu_hat.sqrt() + 1e-7)) * -lr)


def adam_division_inputs(n_updates: int = 5):
    """The inputs of `hold_adam_division`: the default config, f32
    parameters at its 84 leaf shapes and n_updates gradients (seed 7), every
    gradient norm below the clip (1.0), so that no reduction's order enters
    the update."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model

    cfg = load_config(None)
    shapes = [tuple(v.shape) for _, v in
              fft_model.tree_leaves(fft_model.init_params(cfg, prng.key(SEED)))]
    rng = np.random.default_rng(SEED)
    p0 = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
             for scale in (0.001, 0.0005, 0.0015, 0.001, 0.0008)[:n_updates]]
    return cfg, p0, grads


def hold_adam_division(dev, n_updates: int = 5) -> dict:
    """The default Adam (warmup_cosine, clip 1.0) on `adam_division_inputs`
    for n_updates: the port's update on the CPU, which
    tests/test_torch_port_train.py holds to the JAX package's optax update
    on these inputs, against the port's update on the card, which divides
    by the bias corrections, and against the update as it was
    (`_old_adam_update`) on the card. Returns, for each card form, the
    values of the parameters and moments that differ from the CPU's after
    each update and the largest |difference|; the dividing form must be at
    least as close on both counts."""
    from seq2squiggle_tpu_torch.train.optimizers import build_optimizer

    cfg, p0, grads = adam_division_inputs(n_updates)
    runs = {}
    for form, device in (("cpu", torch.device("cpu")), ("card", dev), ("card_old", dev)):
        opt = build_optimizer(cfg, 100)
        params = [torch.from_numpy(p.copy()).to(device) for p in p0]
        state = opt.init(params)
        after = []
        for g in grads:
            g = [torch.from_numpy(x).to(device) for x in g]
            check(float(torch.sqrt(sum((x.double() ** 2).sum() for x in g))) < opt.clip,
                  "Adam division: a gradient norm reached the clip")
            if form == "card_old":
                _old_adam_update(opt, g, state, params)
            else:
                opt.update(g, state, params)
            after.append([t.detach().cpu().clone() for t in (*params, *state["mu"],
                                                              *state["nu"])])
        runs[form] = after
    out = {}
    for form in ("card", "card_old"):
        out[form] = {"differ": [], "max_abs": []}
        for got, ref in zip(runs[form], runs["cpu"]):
            out[form]["differ"].append(sum(int((a != b).sum()) for a, b in zip(got, ref)))
            out[form]["max_abs"].append(max(float((a - b).abs().max()) for a, b in zip(got, ref)))
    out["values"] = sum(t.numel() for t in runs["cpu"][0])
    new, old = out["card"], out["card_old"]
    check(sum(new["differ"]) <= sum(old["differ"]) and max(new["max_abs"]) <= max(old["max_abs"]),
          f"Adam on the card: the dividing update is further from the CPU's than the old one: "
          f"{new} against {old}")
    return out


def _device_trace(run) -> dict:
    """run() under torch.profiler (CPU and CUDA): the card's busy time (the
    union of its kernel, copy and set intervals), the device events, the
    host's kernel launches and graph launches, and the kernels by
    `_kernel_counts`' groups, all and those the graph launches ran."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device, names, launches, graphs = [], [], 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            names.append(e.name())
        elif e.name() in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx"):
            launches += 1
        elif e.name() in GRAPH_LAUNCHES:
            graphs += 1
    busy, end = 0, None
    for a, b in sorted(device):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return {"busy_ms": busy * 1e-6, "device_events": len(device), "launches": launches,
            "graph_launches": graphs, "kernels": _kernel_counts(names),
            "graphs": _graph_kernels(prof.profiler.kineto_results.events())}


def time_graphed_step(dev, steps: int = 20, rounds: int = 3) -> dict:
    """The default train step (bf16, block rung, batch TRAIN_BATCH) through
    the graph and eagerly, in interleaved rounds of `steps`: the host's ms
    until a call returns, the wall ms a step with a synchronize at the end,
    and from a profile of 5 steps the card's busy ms, its device events and
    the host's launches a step."""
    from seq2squiggle_tpu_torch import prng
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.models import fft_model
    from seq2squiggle_tpu_torch.train.loop import make_train_step
    from seq2squiggle_tpu_torch.train.optimizers import build_optimizer

    cfg = load_config(None)
    batch, mask = _train_batch(cfg, TRAIN_BATCH, seed=5)
    batch, mask = {k: v.to(dev) for k, v in batch.items()}, mask.to(dev)
    base = prng.key(SEED, dev)
    ways = {}
    for graphed in (True, False):
        params = fft_model.to_train_params(fft_model.init_params(cfg, prng.key(SEED)), dev)
        opt = build_optimizer(cfg, 100_000)
        state = opt.init([v for _, v in fft_model.tree_leaves(params)])
        step = make_train_step(cfg, opt)
        call = step if graphed else step.eager
        keys = [prng.fold_in(base, i) for i in range(steps)]
        for k in keys[:3]:  # the warm-up and the capture
            call(params, state, batch, mask, k)
        ways["graph" if graphed else "eager"] = (call, params, state, keys)
    got = {w: {"host_ms": [], "wall_ms": []} for w in ways}
    for _ in range(rounds):
        for w, (call, params, state, keys) in ways.items():
            torch.cuda.synchronize()
            t0, host = time.perf_counter(), 0.0
            for k in keys:
                h0 = time.perf_counter()
                call(params, state, batch, mask, k)
                host += time.perf_counter() - h0
            torch.cuda.synchronize()
            got[w]["host_ms"].append(1e3 * host / steps)
            got[w]["wall_ms"].append(1e3 * (time.perf_counter() - t0) / steps)
    out = {}
    for w, (call, params, state, keys) in ways.items():
        traced = _device_trace(lambda: [call(params, state, batch, mask, k) for k in keys[:5]])
        kernels, graphs = traced.pop("kernels"), traced.pop("graphs")
        out[w] = {"host_ms": statistics.median(got[w]["host_ms"]),
                  "wall_ms": statistics.median(got[w]["wall_ms"]),
                  **{k: v / 5 for k, v in traced.items()},
                  "kernels": tuple(n / 5 for n in kernels), "graph_kernels": graphs["kernels"]}
    return out


def phase_graph(dev, smi, masks: dict) -> dict:
    """Phase 20: the train step as a CUDA graph against its eager steps for
    each run of GRAPH_CASES, the default Adam's division on the card
    against the CPU's, the step's times both ways, and phase 19's `train`
    command as replays. Returns what it measured."""
    t_phase = time.perf_counter()
    held = {}
    for case in GRAPH_CASES:
        held[case] = got = hold_graphed_step(dev, *case)
        mode, dtype, optimizer, schedule = case
        log(f"phase 20 at {mode}, {dtype}, {optimizer}, {schedule}: {GRAPH_STEPS} steps at "
            f"batch {TRAIN_BATCH} and 3 at {TRAIN_BATCH // 2} through the graph and eagerly "
            f"from one start: {got['leaves']} parameters, the optimizer's state and every "
            f"metric bit-equal; (eager steps, captures, replays) {got['schedule']}; the host "
            f"issued (block forward, block backward, core forward, core backward, threefry) "
            f"{got['host']} graphed, {got['eager_host']} eager; 3 more replays: a step ran "
            f"{got['replayed']} kernels, {got['replay_device_events']:.1f} device events, "
            f"{got['replay_launches']:.1f} kernel launches")
    division = hold_adam_division(dev)
    for form, what in (("card", "dividing by the device scalars"),
                       ("card_old", "as before, Python numbers")):
        log(f"phase 20 Adam at the default leaves on the card, {what}: values of the "
            f"parameters and moments differing from the CPU's update after each of "
            f"{len(division[form]['differ'])} updates {division[form]['differ']} of "
            f"{division['values']}, max |diff| {division[form]['max_abs']}")
    times = time_graphed_step(dev)
    for w, t in times.items():
        log(f"phase 20 step ({w}, bf16, block, batch {TRAIN_BATCH}): host {t['host_ms']:.3f} ms "
            f"to return, wall {t['wall_ms']:.3f} ms a step, card busy {t['busy_ms']:.3f} ms, "
            f"{t['device_events']:.1f} device events, {t['launches']:.1f} kernel launches and "
            f"{t['graph_launches']:.1f} graph launches a step [{smi}]")
    check(times["graph"]["device_events"] > 0,
          f"phase 20: the profiler saw no device work in the graphed steps: {times['graph']}")
    counts = masks["train_counts"]
    n = TRAIN_STEPS
    check(counts.get("train.eager_steps") == 1 and counts.get("train.graph_captures") == 1
          and counts.get("train.graph_replays") == n - 1,
          f"phase 20: the train command counted {counts} for {n} steps, want 1 eager step, "
          f"1 capture and {n - 1} replays")
    log(f"phase 20 train command (phase 19's run): {n} steps, 1 eager, 1 capture, "
        f"{n - 1} replays; a replayed step ran {masks['replayed']} kernels (block forward, "
        f"block backward, core forward, core backward, threefry)")
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return {"replayed": {"/".join(map(str, c)): g["replayed"] for c, g in held.items()},
            "division": division, "times": times}


def phase_write_behind(dev, smi) -> dict:
    """Phase 21: one job at the predict cell's settings written behind the
    loop, against the same job with every read written in `finalize`.
    Returns the write-behind job's counters and timers."""
    from seq2squiggle_tpu_torch.config import load_config
    from seq2squiggle_tpu_torch.io.slow5 import read_slow5
    from seq2squiggle_tpu_torch.runtime.simulate import simulate_run

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    runs = {}
    os.environ["SEQ2SQUIGGLE_TPU_TIMERS"] = "1"
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            rng = np.random.default_rng(SEED)
            fasta = pathlib.Path(tmp) / "genome.fasta"
            fasta.write_text(">synthetic\n" + "".join(rng.choice(list("ACGT"), 48_502)) + "\n")
            for every in (1_000_000, float("inf")):
                out = pathlib.Path(tmp) / f"out-{every}.blow5"
                stats = simulate_run(
                    config=load_config(None), saved_weights=str(R10), fasta=str(fasta),
                    read_input=False, n=WRITE_BEHIND_READS, r=5000, c=-1, out=str(out),
                    profile="dna-r10-prom", dwell_mean=None, dwell_std=0.0, noise_std=2.0,
                    noise_sampling=True, duration_sampling=True, distr="expon",
                    predict_batch_size=BATCH, export_every_n_samples=every, min_noise=0.0,
                    min_duration=3, seed=SEED, show_progress=False, wire_format="auto",
                    slow5_press="zstd", device=dev)
                runs[every] = stats, read_slow5(str(out))[1]
    finally:
        del os.environ["SEQ2SQUIGGLE_TPU_TIMERS"]
    (stats, recs), (one_stats, one) = runs[1_000_000], runs[float("inf")]
    t = stats["timers"]
    behind, final = t.get("export.behind_samples", 0), t.get("export.final_samples", 0)
    check(behind + final == stats["samples"] == one_stats["samples"],
          f"phase 21: {behind} + {final} samples counted for {stats['samples']} simulated")
    check(behind > 0, "phase 21: no sample was written behind the loop")
    _check_records("phase 21", stats, [(r["read_id"], r["signal"]) for r in recs],
                   WRITE_BEHIND_READS)
    same = len(recs) == len(one) and all(
        a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) if k == "signal" else a[k] == b[k]
                                     for k in a) for a, b in zip(recs, one))
    check(same, "phase 21: the records written behind differ from one flush's")
    got = {"behind_samples": behind, "final_samples": final,
           "final_pct": 100.0 * final / stats["samples"],
           "batches": -(-stats["chunks"] // BATCH),
           "finalize_ms": 1e3 * t["finalize"], "one_flush_finalize_ms":
           1e3 * one_stats["timers"]["finalize"],
           "writer_write_ms": 1e3 * t["writer_write"],
           "writer_write_cpu_ms": 1e3 * t["writer_write_cpu"],
           "seconds": stats["seconds"], "one_flush_seconds": one_stats["seconds"]}
    log(f"phase 21: {len(recs)} records equal to one flush's; {json.dumps(got)} "
        f"[{smi}] ({time.perf_counter() - t_phase:.1f} s)")
    return got


def phase_pipeline(dev, main_recs, smi) -> dict:
    """Phase 17: the run loop's host threads and the per-shard launching
    threads on the card. Returns what it measured."""
    import threading

    from seq2squiggle_tpu_torch.runtime import predict as tpredict
    from seq2squiggle_tpu_torch.runtime import simulate as tsim

    t_phase = time.perf_counter()
    stages = {"seq2squiggle-h2d", "seq2squiggle-fetch", "seq2squiggle-decode"}
    got = {}

    def report(what, stats):
        log(f"phase 17 {what}: {stats['samples']} samples in {stats['seconds']:.3f} s "
            f"({stats['ksamples_per_s']:.1f} kSamples/s); stage timers "
            f"{timers_per_batch(stats)} [{smi}]")

    def slowed(depths=None, **run):
        """A run whose decode holds its first batch PIPELINE_HOLD_S and
        sleeps PIPELINE_SLOW_S a batch, counting how far the dispatch loop
        runs ahead of it (batches launched, this one included, less those
        the decode has started) and the tier of every batch it launched."""
        unframe, step = tsim.unframe_wire, tsim.predict_step_sharded
        decoded, ahead, tiers = [], [], []

        def slow_unframe(*args, **kw):
            if threading.current_thread().name == "seq2squiggle-decode":
                decoded.append(1)
            time.sleep(PIPELINE_HOLD_S if decoded == [1] else PIPELINE_SLOW_S)
            return unframe(*args, **kw)

        def counted(*args, **kw):
            if threading.current_thread().name != "seq2squiggle-decode":  # not a recompute
                tiers.append(kw["knobs"].wire_bits)
                ahead.append(len(tiers) - len(decoded))
            return step(*args, **kw)

        patches = [mock.patch.object(tsim, "unframe_wire", slow_unframe),
                   mock.patch.object(tsim, "predict_step_sharded", counted)]
        if depths:
            patches += [mock.patch.object(tsim, "H2D_DEPTH", depths[0]),
                        mock.patch.object(tsim, "PIPELINE_DEPTH", depths[1])]
        torch.cuda.reset_peak_memory_stats(dev)
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            result = _predict_run(dev, "out.blow5", **run)
        check(not _stage_threads(), f"threads left after a slowed run: {_stage_threads()}")
        return result, max(ahead), tiers, torch.cuda.max_memory_allocated(dev)

    os.environ["SEQ2SQUIGGLE_TPU_TIMERS"] = "1"
    try:
        # -- (a) phase 4's run: the named threads, the timers, the launches
        seen = set()
        batches = tsim.iter_batches

        def watched(*args, **kw):
            for batch in batches(*args, **kw):
                seen.update(t.name for t in threading.enumerate())
                yield batch

        torch.cuda.reset_peak_memory_stats(dev)
        with mock.patch.object(tsim, "iter_batches", watched):
            stats, launches, _, recs = _predict_run(dev, "out.blow5", 100)
        peak = torch.cuda.max_memory_allocated(dev)
        n_batches = math.ceil(stats["chunks"] / BATCH)
        check(stages <= seen, f"(a): threads seen during the run {sorted(seen)}")
        check(not _stage_threads(), f"(a): threads left after the run: {_stage_threads()}")
        check({"h2d_cpu", "dispatch_cpu", "d2h_wait"} <= set(stats["timers"]),
              f"(a): timers {sorted(stats['timers'])}")
        check(launches == 4 * n_batches, f"(a): {launches} launches for {n_batches} batches")
        _tier_runs_match("phase 17 (a) against phase 4", recs, main_recs, exact=True)
        log(f"phase 17 (a): records equal to phase 4's; threads seen {sorted(seen & stages)}, "
            f"none left after; fused_fft_block launches {launches} for {n_batches} batches; "
            f"peak device memory allocated {peak / 2**20:.1f} MiB")
        report("(a)", stats)
        got["a"] = {"ksamples_per_s": stats["ksamples_per_s"], "peak_mib": peak / 2**20}

        # -- (b) the decode slowed: at the run's queue depths, where the 6
        # batches all go in, and with the depths cut to 1, where the queues fill
        for depths in (None, (1, 1)):
            (stats, _, _, recs), ahead, _, peak_b = slowed(depths, n_reads=100)
            # the fetch and decode queues, the batch the fetch thread holds, the one
            # launched; or every batch but the one the decode holds
            limit = 2 * (depths or (0, tsim.PIPELINE_DEPTH))[1] + 2
            what = f"(b) depths {depths or (tsim.H2D_DEPTH, tsim.PIPELINE_DEPTH)}"
            want = min(limit, n_batches - 1)
            check(ahead == want, f"{what}: {ahead} batches in flight, want {want}")
            _tier_runs_match(f"phase 17 {what} against phase 4", recs, main_recs, exact=True)
            log(f"phase 17 {what}, decode held {PIPELINE_HOLD_S} s, then slowed "
                f"{PIPELINE_SLOW_S} s a batch: records equal to phase 4's; {ahead} batches in "
                f"flight at most (the limit {limit}, {n_batches} batches); peak device memory "
                f"allocated {peak_b / 2**20:.1f} MiB against (a)'s {peak / 2**20:.1f}")
            report(what, stats)
            got[f"b{'' if depths is None else '_cut'}"] = {
                "max_in_flight": ahead, "limit": limit, "peak_mib": peak_b / 2**20}

        # -- (c) phase 14's step-down run with the decode slowed
        ladder = dict(n_reads=30, noise_std=20.0, predict_batch_size=256)
        _, _, _, raw_recs = _predict_run(dev, "raw.blow5", wire_format="raw", **ladder)
        warnings = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = lambda record: warnings.append(record.getMessage())
        port_log = logging.getLogger("seq2squiggle_tpu_torch")
        port_log.addHandler(handler)
        try:
            (stats, _, _, recs), ahead, tiers, _ = slowed(wire_format="8", **ladder)
        finally:
            port_log.removeHandler(handler)
        steps = [w for w in warnings if "downgrading wire format to" in w]
        recomputes = sum("recomputed this batch raw" in w for w in warnings)
        check(stats["wire_bits"] in (12, 16) and steps
              and len(steps) == (1 if stats["wire_bits"] == 12 else 2)
              and recomputes == 3 * len(steps),
              f"(c): {len(steps)} step-downs and {recomputes} raw recomputes logged: {steps}")
        _tier_runs_match("phase 17 (c) against its raw run", recs, raw_recs, exact=True)
        by_tier = {b: tiers.count(b) for b in sorted(set(tiers))}
        check(by_tier.get(8, 0) > 4, f"(c): batches launched by tier {by_tier}: no more than "
              "the four the step-down counts were in flight at 8 bits")
        log(f"phase 17 (c): the ladder from 8 bits with the decode slowed logged {recomputes} "
            f"raw recomputes and {len(steps)} step-downs, settled on {stats['wire_bits']} bits, "
            f"records equal to raw; batches launched by tier {by_tier} (at most {ahead} in "
            "flight)")
        report("(c)", stats)
        got["c"] = {"batches_by_tier": by_tier, "max_in_flight": ahead}

        # -- (d) two shards of the card: a thread and a stream each
        calls = []
        inner = tpredict.predict_step

        def watched_step(*args, **kw):
            calls.append((threading.current_thread().name,
                          torch.cuda.current_stream(dev).cuda_stream))
            return inner(*args, **kw)

        with mock.patch.object(tpredict, "predict_step", watched_step):
            stats, launches, _, recs = _predict_run(dev, "out.blow5", 100, device=[dev, dev])
        threads = {name: {stream for n, stream in calls if n == name} for name, _ in calls}
        default = torch.cuda.default_stream(dev).cuda_stream
        check(set(threads) == {"seq2squiggle-shard0_0", "seq2squiggle-shard1_0"}
              and all(len(s) == 1 for s in threads.values())
              and len(set().union(*threads.values()) - {default}) == 2,
              f"(d): shard threads and streams {threads}")
        check(launches == 8 * n_batches, f"(d): {launches} launches for {n_batches} batches")
        _tier_runs_match("phase 17 (d) against phase 4", recs, main_recs, exact=True)
        log(f"phase 17 (d): each shard launched from its own thread on its own stream "
            f"({ {n: hex(next(iter(s))) for n, s in threads.items()} }); records equal to "
            f"phase 4's; fused_fft_block launches {launches} (8 a batch)")
        rates = {"one device": [], "two shards": []}
        for r in range(3):
            order = ("one device", "two shards") if r % 2 == 0 else ("two shards", "one device")
            for name in order:
                devices = [dev] if name == "one device" else [dev, dev]
                stats, launches, _, recs = _predict_run(dev, "out.blow5", 100, device=devices)
                _tier_runs_match(f"phase 17 (d) {name} against phase 4", recs, main_recs,
                                 exact=True)
                check(launches == 4 * len(devices) * n_batches, f"(d) {name}: {launches} launches")
                rates[name].append(stats["ksamples_per_s"])
                report(f"(d) round {r} {name}", stats)
        one, two = (statistics.median(v) for v in rates.values())
        log(f"phase 17 (d): kSamples/s in 3 alternating rounds, one device {rates['one device']} "
            f"(median {one:.1f}), two shards {rates['two shards']} (median {two:.1f}, "
            f"{100 * (two / one - 1):+.1f} %) [{smi}]")
        got["d"] = rates
    finally:
        del os.environ["SEQ2SQUIGGLE_TPU_TIMERS"]
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    log("phase 17 summary: " + json.dumps(got))
    return got


def main() -> int:
    if not (ROOT / "seq2squiggle_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    if len(sys.argv) > 2 and sys.argv[1] == "--rank-train":  # a phase 16 rank
        sys.path.insert(0, str(ROOT))
        return rank_train(sys.argv[2], sys.argv[3:])
    if len(sys.argv) == 3 and sys.argv[1] == "--digests":
        # the port as it is in another tree (its kernels build there), this script's inputs
        sys.path.insert(0, str(pathlib.Path(sys.argv[2]).resolve()))
        print(json.dumps(digests(torch.device("cuda"))))
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
    worst_bf16, times, library = phase_kernel(params, dev)
    log(f"digests: {json.dumps(digests(dev))}")
    phase_step(host_params, dev)
    launches, _, recs, main_stats = phase_main_path(dev, pair=False)
    core = phase_core_kernels(dev)[torch.bfloat16]
    phase_train_step(dev, "core", "core")
    core_run, _, _ = phase_train_main_path(dev, "core", epochs=1, steps=CORE_STEPS,
                                           resume=False, plots=False)
    block = phase_block_kernels(dev)[torch.bfloat16]
    phase_train_step(dev, "block", "auto")
    block_run, pngs, warnings = phase_train_main_path(dev, None, epochs=2, steps=TRAIN_STEPS,
                                                      resume=True)
    pair = phase_pair(params, dev)
    variants, variant_profile, cut_profile = phase_variants(params, dev)
    _, pair_launches, pair_recs, _ = phase_main_path(dev, pair=True)
    check(len(pair_recs) == len(recs)
          and all(a[0] == b[0] and np.array_equal(a[1], b[1]) for a, b in zip(recs, pair_recs)),
          "pallas_pair: true wrote other records than pallas_pair: false")
    log(f"main path at pallas_pair: true: {len(pair_recs)} records equal to phase 4's")
    phase_other_modes(dev)
    phase_wire(host_params, dev, main_stats, recs, smi)
    phase_train_rest(dev, smi, pngs, warnings)
    core4 = phase_parallel(dev, recs)
    phase_pipeline(dev, recs, smi)
    gamma = phase_gamma(dev, recs, smi)
    masks = phase_masks(dev, smi)
    phase_graph(dev, smi, masks)
    phase_write_behind(dev, smi)

    # per predict batch the path runs the fused block twice at L=16 and twice at L=250
    bf16 = torch.bfloat16
    k_ms = 2 * (times[(bf16, 16)][0] + times[(bf16, 250)][0])
    p_ms = 2 * (times[(bf16, 16)][1] + times[(bf16, 250)][1])
    fused_bound = [bound(*fused_block_work(BATCH, L, bf16), bf16) for L in (16, 250)]

    def entry(name, source, replaces, run, i, got, direction, work):
        bound_ms, bound_by = bound(*work(TRAIN_BATCH, 250, bf16, direction == "bwd"), bf16)
        extra = {}
        if name.startswith("packed_attention_core"):  # phase 16: a tp = 2 rank's 4 heads
            extra = {"four_heads_tp2": {
                "ms": core4[direction], "eight_heads_ms_same_rounds": core4[f"{direction}8"],
                "plain_ms": core4[f"{direction}_plain"], "max_abs_err": core4[f"{direction}_err"],
                "library_ms": core4[f"{direction}_library"],
                "bound_ms": core4[f"{direction}_bound"][0],
                "bound_by": core4[f"{direction}_bound"][1],
                "launches_per_rank": core4[f"launches_{direction}"],
                "shape": f"bf16 {TRAIN_BATCH}x250x32"}}
        elif name.startswith("fused_block_train"):  # the layer under autograd
            extra = {"library": {"call": "nn.TransformerEncoderLayer under autograd",
                                 "max_abs_err": got[f"{direction}_library_err"],
                                 "within_bar": got["library_within_bar"]}}
        return {"name": name, "route": "cuda",
                "source": f"seq2squiggle_tpu_torch/csrc/{source}",
                "replaces": f"seq2squiggle_tpu/ops/pallas/{replaces}", "launches": run["host"][i],
                "launches_per_replayed_step": run["replayed"][i],
                "max_abs_err": got[f"{direction}_err"], "ms": got[direction],
                "plain_ms": got[f"{direction}_plain"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": got.get(f"{direction}_library"), **extra}

    pair_bound = bound(2 * BATCH * 250 * 64 * 2 + 2 * fused_block_work(0, 250, bf16)[0],
                       2 * fused_block_work(BATCH, 250, bf16)[1], bf16)
    variant_bound = bound(*fused_block_work(2048, 250, bf16), bf16)

    def variant_entry(group, replaces, names):
        got = variants[group]
        # b, c (P1) and d (P2) compute B2's function; the stages (P3) have no library call
        lib = variants["library"] if group in ("abc", "d") else None
        return {"ms_per_block_interleaved": {n: variant_profile["ms"][n] for n in names},
                "name": f"fused_{group}", "route": "cuda",
                "source": "seq2squiggle_tpu_torch/csrc/fft_block_variants.cu",
                "replaces": f"scripts/profiling/{replaces}", "launches": got["launches"],
                "max_abs_err": got["err"], "ms": got["ms"], "plain_ms": got["plain_ms"],
                "bound_ms": variant_bound[0], "bound_by": variant_bound[1],
                "library_ms": lib and lib["ms"], "library": lib}

    def ablate_entry():
        got = variants["ablate"]
        cut_bound = bound(*cut_work(2048, 250, bf16, got["cut"]), bf16)
        return {"name": "fused_fft_block_ablate", "route": "cuda",
                "source": "seq2squiggle_tpu_torch/csrc/fft_block_variants.cu",
                "replaces": "seq2squiggle_tpu/ops/pallas/fft_block.py:403 (ablate=)",
                "launches": got["launches"], "max_abs_err": got["err"], "ms": got["ms"],
                "plain_ms": got["plain_ms"], "bound_ms": cut_bound[0], "bound_by": cut_bound[1],
                "library_ms": None, "ms_cut": got["cut"], "ms_by_cut": got["ms_by_cut"],
                "plain_ms_by_cut": got["plain_ms_by_cut"],
                "ms_per_two_blocks_interleaved": cut_profile["ms"],
                "full_minus_cut_ms": cut_profile["full_minus_cut_ms"]}

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
        "library_ms": 2 * (library[16]["ms"] + library[250]["ms"]),
        "library_by_shape": {f"bf16 {BATCH}x{L}x64": got for L, got in library.items()},
        "ms_by_shape": {f"{str(dt)[6:]} {BATCH}x{L}x64": {"ms": k, "plain_ms": p}
                        for (dt, L), (k, p) in times.items()},
    },
        entry("packed_attention_core_fwd", "attn_core.cu", "attn_core.py:184",
              core_run, 2, core, "fwd", core_work),
        entry("packed_attention_core_bwd", "attn_core.cu", "attn_core.py:205",
              core_run, 3, core, "bwd", core_work),
        entry("fused_block_train_fwd", "block_train.cu", "block_train.py:304",
              block_run, 0, block, "fwd", block_train_work),
        entry("fused_block_train_bwd", "block_train.cu", "block_train.py:335",
              block_run, 1, block, "bwd", block_train_work),
        {"name": "fused_fft_block_pair", "route": "cuda",
         "source": "seq2squiggle_tpu_torch/csrc/fft_block.cu",
         "replaces": "seq2squiggle_tpu/ops/pallas/fft_block.py:466", "launches": pair_launches,
         "max_abs_err": pair["err"], "ms": pair["pair"], "plain_ms": pair["plain"],
         "bound_ms": pair_bound[0], "bound_by": pair_bound[1],
         "library_ms": pair["library"]["ms"], "library": pair["library"],
         "two_launches_ms": pair["two_launches"]},
        variant_entry("abc", "profile_abc.py:130", ("a", "b", "c")),
        variant_entry("d", "profile_d.py:95", ("b", "d", "block exact", "block shift")),
        dict(variant_entry("parts", "profile_parts2.py:109", variant_profile["stage_delta_ms"]),
             stage_delta_ms=variant_profile["stage_delta_ms"]),
        ablate_entry(),
        {"name": "gamma_draw", "route": "cuda",
         "source": "seq2squiggle_tpu_torch/csrc/threefry.cu",
         "replaces": "no TPU kernel: seq2squiggle_tpu_torch/sampling.py:26 and the key chain "
                     "of runtime/predict.py's decoder_output in torch ops",
         "launches": gamma["launches"],
         "max_abs_err": None, "max_rel_err": max(g["max_rel_err"] for g in gamma["held"].values()),
         "ms": gamma["ms"], "plain_ms": gamma["plain_ms"], "bound_ms": gamma["bound_ms"],
         "bound_by": gamma["bound_by"], "library_ms": None,
         "shares_by_batch": {str(B): {k: v for k, v in g.items() if k != "B"}
                             for B, g in gamma["held"].items()}},
        {"name": "dropout_draw", "route": "cuda",
         "source": "seq2squiggle_tpu_torch/csrc/threefry.cu",
         "replaces": "no TPU kernel: prng.bernoulli in ops/attention.py::dropout_mask and "
                     "ops/block_train.py::make_dropout_scales, and prng.fold_in / split of "
                     "the train step's keys, in torch ops",
         "launches": masks["launches"], "launches_per_replayed_step": masks["replayed"][4],
         "max_abs_err": max(g["max_abs_err"] for g in masks["held"].values()),
         "ms": masks["draw_ms"], "plain_ms": masks["draw_plain_ms"],
         "bound_ms": masks["draw_bound_ms"], "bound_by": masks["draw_bound_by"],
         "library_ms": None, "step_draws_ms": masks["step_draws_ms"],
         "step_draws_plain_ms": masks["step_draws_plain_ms"],
         "step_draws_bound_ms": masks["step_draws_bound_ms"],
         "kept_shares": {k: g["kept"] for k, g in masks["held"].items()}},
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
