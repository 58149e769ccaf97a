"""The ceilings of the port's CUDA kernels on sequence length, checked on the
CPU. Each kernel keeps a batch row's (or a head's) working set in shared
memory; its wrapper computes the bytes from the same formula as its .cu file
(`shared_memory_bytes`, the Python twin of rows_mma_smem and row_kernel_smem
in csrc/block_train.cu, fwd_smem_bytes / bwd_smem_bytes in csrc/attn_core.cu and
block_smem_bytes in csrc/fft_block_body.cuh) against the 232,448 bytes a
thread block can opt into on an H100, and raises a ValueError that names L,
the dtype, the bytes and the largest L that fits, before any launch. The
check touches no device, so these tests call it directly.

The expected ceilings are worked out here from the layouts, not read from
the wrappers: the largest L with bytes(L) <= 232,448, bytes being
  attention core, bf16   48 (forward) or 72 (backward) per row of ceil16(L)
  attention core, f32    64 or 136 per row of L
  whole block, f32       forward 3·64·L·4 + 8·(64 + 256)·4 + 8·4
                         backward 3·64·L·4 + 8·(2·64 + 256)·4 + (8 + 640)·4
  whole block, bf16      q in rows of 64 + 8 values, L padded to 16-row slabs:
                         72·ceil16(L)·2; a region that holds first k, v and
                         Wq, Wk, Wv (2·72·ceil16(L)·2 + 27,648) and then the
                         tail's weights (Wf and W2 in rows of 72, W1 in rows
                         of 264: 79,872), so the larger of the two; then 8·4
                         (forward) or (8 + 640)·4 (backward)
  fused block and pair   3·64·L·size + 8·256·size + 8·4
"""

from __future__ import annotations

import re

import pytest
import torch

from seq2squiggle_tpu_torch.ops import _build
from seq2squiggle_tpu_torch.ops import attn_core as ac
from seq2squiggle_tpu_torch.ops import block_train as bt
from seq2squiggle_tpu_torch.ops import fft_block as fb

BF16, F32 = torch.bfloat16, torch.float32
LIMIT = 232_448

CHECKS = {
    "core_fwd": (lambda L, dt: ac.check_length(L, dt, backward=False),
                 lambda L, dt: ac.shared_memory_bytes(L, dt, False),
                 "packed_attention_core forward"),
    "core_bwd": (lambda L, dt: ac.check_length(L, dt, backward=True),
                 lambda L, dt: ac.shared_memory_bytes(L, dt, True),
                 "packed_attention_core backward"),
    "block_fwd": (lambda L, dt: bt.check_length(L, dt, backward=False),
                  lambda L, dt: bt.shared_memory_bytes(L, dt, False),
                  "fused_block_train forward"),
    "block_bwd": (lambda L, dt: bt.check_length(L, dt, backward=True),
                  lambda L, dt: bt.shared_memory_bytes(L, dt, True),
                  "fused_block_train backward"),
    "fft_block": (lambda L, dt: fb.check_length(L, dt),
                  lambda L, dt: fb.shared_memory_bytes(L, dt),
                  "fused_fft_block"),
    "fft_block_pair": (lambda L, dt: fb.check_length(L, dt, "fused_fft_block_pair"),
                       lambda L, dt: fb.shared_memory_bytes(L, dt),
                       "fused_fft_block_pair"),
}

# the bf16 whole-block kernels' weights in shared memory, 2 bytes a value: the
# tail's, (64 + 256) rows of 72 values (Wf, W2) and 64 rows of 264 (W1), and
# the projections', 3·64 rows of 72
TAIL_WEIGHTS = ((64 + 256) * 72 + 64 * 264) * 2
PROJECTION_WEIGHTS = 3 * 64 * 72 * 2
# ... and the whole-block kernels' way out, named after the ceiling
HINT = " (`pallas_train: core` trains longer sequences)"

# (wrapper, dtype) -> (the largest L that fits, its bytes)
CEILINGS = [
    ("core_fwd", BF16, 4832, 48 * 4832),
    ("core_fwd", F32, 3632, 64 * 3632),
    ("core_bwd", BF16, 3216, 72 * 3216),
    ("core_bwd", F32, 1709, 136 * 1709),
    ("block_fwd", BF16, 464, 3 * 72 * 464 * 2 + PROJECTION_WEIGHTS + 32),
    ("block_fwd", F32, 289, 192 * 289 * 4 + 8 * 320 * 4 + 32),
    ("block_bwd", BF16, 464, 3 * 72 * 464 * 2 + PROJECTION_WEIGHTS + 648 * 4),
    ("block_bwd", F32, 283, 192 * 283 * 4 + 8 * 384 * 4 + 648 * 4),
    ("fft_block", BF16, 594, 192 * 594 * 2 + 8 * 256 * 2 + 32),
    ("fft_block", F32, 291, 192 * 291 * 4 + 8 * 256 * 4 + 32),
    ("fft_block_pair", BF16, 594, 192 * 594 * 2 + 8 * 256 * 2 + 32),
    ("fft_block_pair", F32, 291, 192 * 291 * 4 + 8 * 256 * 4 + 32),
]


@pytest.mark.parametrize("wrapper,dtype,ceiling,n_bytes", CEILINGS,
                         ids=[f"{w}-{str(d)[6:]}" for w, d, _, _ in CEILINGS])
def test_ceiling_and_message(wrapper, dtype, ceiling, n_bytes):
    check, need, name = CHECKS[wrapper]
    assert _build.SHARED_MEMORY_MAX == LIMIT
    assert need(ceiling, dtype) == n_bytes <= LIMIT
    check(ceiling, dtype)  # fits: no error
    check(250, dtype)  # the training and decoding length is inside every ceiling
    for too_long in (ceiling + 1, 4 * ceiling):
        with pytest.raises(ValueError) as err:
            check(too_long, dtype)
        assert str(err.value) == (
            f"{name}: a sequence of L = {too_long} in {str(dtype)[6:]} needs "
            f"{need(too_long, dtype)} bytes of shared memory per thread block, more than the "
            f"{LIMIT} an H100 gives one; the largest L that fits is {ceiling}"
            + (HINT if wrapper.startswith("block_") else ""))
        assert need(too_long, dtype) > LIMIT


def test_f32_whole_block_backward_takes_283_and_refuses_284():
    bt.check_length(283, F32, backward=True)
    with pytest.raises(ValueError, match=re.escape("the largest L that fits is 283")):
        bt.check_length(284, F32, backward=True)


def test_bf16_whole_block_fits_the_training_length_in_both_directions():
    """L = 250 (padded to 256 rows): q, k, v and Wq, Wk, Wv need more than q
    and the tail's weights, and set the size."""
    assert TAIL_WEIGHTS == 79_872 and PROJECTION_WEIGHTS == 27_648
    assert 2 * 72 * 256 * 2 + PROJECTION_WEIGHTS > TAIL_WEIGHTS
    assert bt.shared_memory_bytes(250, BF16, False) == 3 * 72 * 256 * 2 + 27_648 + 32 == 138_272
    assert bt.shared_memory_bytes(250, BF16, True) == 138_272 + 640 * 4 <= LIMIT
    bt.check_length(250, BF16, backward=False)
    bt.check_length(250, BF16, backward=True)


def test_bf16_whole_block_ceiling_moves_in_slabs_of_16():
    """449..464 need the same, and both directions take them; a short row
    needs q and the tail's weights."""
    for backward in (False, True):
        assert (bt.shared_memory_bytes(449, BF16, backward)
                == bt.shared_memory_bytes(464, BF16, backward))
        assert (bt.shared_memory_bytes(1, BF16, backward)
                == bt.shared_memory_bytes(16, BF16, backward)
                == 72 * 16 * 2 + TAIL_WEIGHTS + (648 * 4 if backward else 32))
        bt.check_length(464, BF16, backward=backward)
        with pytest.raises(ValueError, match="largest L that fits is 464"):
            bt.check_length(465, BF16, backward=backward)


def test_bf16_core_ceiling_moves_in_tiles_of_16():
    """The bfloat16 kernels pad L to 16-row tiles: 3201..3216 need the same."""
    assert ac.shared_memory_bytes(3201, BF16, True) == ac.shared_memory_bytes(3216, BF16, True)
    assert ac.shared_memory_bytes(1, BF16, False) == 48 * 16
    ac.check_length(3216, BF16, backward=True)
    with pytest.raises(ValueError, match="largest L that fits is 3216"):
        ac.check_length(3217, BF16, backward=True)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bfloat16", "float32"])
def test_wrappers_check_before_they_touch_a_device(dtype, monkeypatch):
    """The launch paths refuse a long sequence before they allocate an output
    or load the kernel library: with CPU tensors (which the public functions
    would send to the plain versions) the private launchers raise the
    ValueError, and the library loader is never called."""
    def no_load():
        raise AssertionError("the kernel library was loaded before the length check")

    monkeypatch.setattr(_build, "load", no_load)
    x = torch.zeros(1, 5000, 64, dtype=dtype)
    with pytest.raises(ValueError, match="packed_attention_core forward: a sequence of L = 5000"):
        ac._launch_fwd(x, x, x, 8)
    with pytest.raises(ValueError, match="packed_attention_core backward: a sequence of L = 5000"):
        ac._launch_bwd(x, x, x, x, 8)
    with pytest.raises(ValueError, match="s2s_fft_block_pair: a sequence of L = 5000"):
        fb.launch_kernel("s2s_fft_block_pair", x, None, 0)
