"""The ceilings of the port's CUDA kernels on sequence length, checked on the
CPU. Each kernel keeps a batch row's (or a head's) working set in shared
memory; its wrapper computes the bytes from the same formula as its .cu file
(`shared_memory_bytes`, the Python twin of rows_mma_smem and row_kernel_smem
in csrc/block_train.cu, fwd_smem_bytes / bwd_smem_bytes in csrc/attn_core.cu,
slab_smem_bytes in csrc/block_mma.cuh and block_smem_bytes in
csrc/fft_block_body.cuh) against the 232,448 bytes a
thread block can opt into on an H100, and raises a ValueError that names L,
the dtype, the bytes and the largest L that fits, before any launch. The
check touches no device, so these tests call it directly.

The expected ceilings are worked out here from the layouts, not read from
the wrappers: the largest L with bytes(L) <= 232,448, bytes being
  attention core, bf16   48 (forward) or 72 (backward) per row of ceil16(L)
  attention core, f32    64 or 136 per row of L
  whole block, f32       forward 3·64·L·4 + 8·(64 + 256)·4 + 8·4
                         backward 3·64·L·4 + 8·(2·64 + 256)·4 + (8 + 640)·4
  bf16 slab body         q in rows of 64 + 8 values, L padded to 16-row slabs:
                         72·ceil16(L)·2; a region that holds first k, v and
                         Wq, Wk, Wv (2·72·ceil16(L)·2 + 27,648) and then the
                         tail's weights (Wf and W2 in rows of 72, W1 in rows
                         of 264: 79,872), so the larger of the two
  whole block, bf16      the slab body, then nothing (forward) or 640·4
                         (backward)
  fused block and pair,  the slab body (the pair stages its activation
  bf16                   through the output rows where one more 72·ceil16(L)·2
                         buffer does not fit: past L = 352)
  fused block and pair,  3·64·L·4 + 8·256·4 + 8·4 (the CUDA-core body; the
  f32                    pair's fourth L x 64 buffer fits to L = 218)
  profiling kernels      bf16 the slab body, plus for the partial stages
  (variants, cuts)       from scores to den an L x 8 f32 sink per head, L
                         padded to 16 rows: 8·ceil16(L)·8·4; f32 the
                         CUDA-core body, 3·64·L·4 + 8·256·4 + 8·4
"""

from __future__ import annotations

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

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
# ... and each wrapper's way out, named after the ceiling
HINTS = {"block": " (`pallas_train: core` trains longer sequences)",
         "fft": " (`use_pallas: false` runs longer sequences through the plain blocks)",
         "core": ""}

# (wrapper, dtype) -> (the largest L that fits, its bytes)
CEILINGS = [
    ("core_fwd", BF16, 4832, 48 * 4832),
    ("core_fwd", F32, 3632, 64 * 3632),
    ("core_bwd", BF16, 3216, 72 * 3216),
    ("core_bwd", F32, 1709, 136 * 1709),
    ("block_fwd", BF16, 464, 3 * 72 * 464 * 2 + PROJECTION_WEIGHTS),
    ("block_fwd", F32, 289, 192 * 289 * 4 + 8 * 320 * 4 + 32),
    ("block_bwd", BF16, 464, 3 * 72 * 464 * 2 + PROJECTION_WEIGHTS + 640 * 4),
    ("block_bwd", F32, 283, 192 * 283 * 4 + 8 * 384 * 4 + 648 * 4),
    ("fft_block", BF16, 464, 3 * 72 * 464 * 2 + PROJECTION_WEIGHTS),
    ("fft_block", F32, 291, 192 * 291 * 4 + 8 * 256 * 4 + 32),
    ("fft_block_pair", BF16, 464, 3 * 72 * 464 * 2 + PROJECTION_WEIGHTS),
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
            + HINTS[wrapper.split("_")[0]])
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
    assert bt.shared_memory_bytes(250, BF16, False) == 3 * 72 * 256 * 2 + 27_648 == 138_240
    assert bt.shared_memory_bytes(250, BF16, True) == 138_240 + 640 * 4 <= LIMIT
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
                == 72 * 16 * 2 + TAIL_WEIGHTS + (640 * 4 if backward else 0))
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


def test_bf16_fused_block_shares_the_training_body():
    """The bf16 fused block runs csrc/block_mma.cuh's body, as the whole-block
    training forward does: the same bytes at every length, so the same
    ceiling (464, down from the CUDA-core body's 594)."""
    for L in (1, 16, 17, 250, 352, 449, 464, 465):
        assert (fb.shared_memory_bytes(L, BF16) == bt.shared_memory_bytes(L, BF16, False)
                == fb.slab_shared_memory_bytes(L))
    assert fb.cuda_core_shared_memory_bytes(594, BF16) <= LIMIT
    assert fb.cuda_core_shared_memory_bytes(595, BF16) > LIMIT


@pytest.mark.parametrize("dtype,last_on_chip", [(BF16, 352), (F32, 218)],
                         ids=["bfloat16", "float32"])
def test_pair_keeps_its_activation_on_chip_up_to_its_threshold(dtype, last_on_chip):
    """The pair's activation between its blocks stays in shared memory while
    one more buffer fits (bf16: L padded to 16 rows of 72 values; f32: L x
    64), and is staged through the output rows beyond: one launch either way,
    so the pair's ceiling is the one-block kernel's."""
    row = 72 * 2 if dtype == BF16 else 64 * 4
    rows = (lambda n: -(-n // 16) * 16) if dtype == BF16 else (lambda n: n)
    decoder = 250  # the decoding length: on the chip in bf16, staged in f32
    for L in (1, 16, last_on_chip) + ((decoder,) if decoder <= last_on_chip else ()):
        assert fb.pair_keeps_activation_on_chip(L, dtype)
        assert fb.shared_memory_bytes(L, dtype) + rows(L) * row <= LIMIT
    for L in (last_on_chip + 1, 464 if dtype == BF16 else 291) + (
            (decoder,) if decoder > last_on_chip else ()):
        assert not fb.pair_keeps_activation_on_chip(L, dtype)
        assert fb.shared_memory_bytes(L, dtype) + rows(L) * row > LIMIT
        fb.check_length(L, dtype, "fused_fft_block_pair")  # staged, still one launch


@pytest.mark.parametrize("dtype,ceiling", [(BF16, 464), (F32, 291)], ids=["bfloat16", "float32"])
def test_fused_block_error_names_use_pallas_false(dtype, ceiling):
    """Past the fused block's ceiling the wrappers' ValueError names the way
    out: the plain blocks take any length. The profiling kernels, on the same
    bodies (bf16 the tensor-core one, to 464), name none."""
    for name in ("s2s_fft_block", "s2s_fft_block_pair"):
        with pytest.raises(ValueError, match=re.escape(
                f"the largest L that fits is {ceiling} (`use_pallas: false` runs longer "
                "sequences through the plain blocks)")):
            fb.check_length(ceiling + 1, dtype, name)
    from seq2squiggle_tpu_torch.ops import fft_block_variants as tv

    variants_ceiling = 464 if dtype == BF16 else 291
    tv._check_length(variants_ceiling, dtype, "s2s_fft_block_abc")
    with pytest.raises(ValueError) as err:
        tv._check_length(variants_ceiling + 1, dtype, "s2s_fft_block_abc")
    assert str(err.value).endswith(f"the largest L that fits is {variants_ceiling}")


@pytest.mark.parametrize("dtype,ceiling,n_bytes", [
    (BF16, 288, 3 * 72 * 288 * 2 + PROJECTION_WEIGHTS + 8 * 288 * 8 * 4),
    (F32, 291, 192 * 291 * 4 + 8 * 256 * 4 + 32),
], ids=["bfloat16", "float32"])
def test_profiling_stage_sinks_ceiling(dtype, ceiling, n_bytes):
    """The partial stages from scores to den (fused_parts) keep a per-head
    L x 8 f32 sink beside the bf16 slab body: 203,776 bytes at L = 250, and
    the largest L that fits is 288 (variants_smem_bytes in
    csrc/fft_block_variants.cu is the twin). proj, full, a ... d and the
    cuts need the body alone; f32 keeps the CUDA-core body's ceiling."""
    from seq2squiggle_tpu_torch.ops import fft_block_variants as tv

    assert tv.shared_memory_bytes(ceiling, dtype, sink=True) == n_bytes <= LIMIT
    assert tv.shared_memory_bytes(ceiling + 1, dtype, sink=True) > LIMIT
    assert tv.shared_memory_bytes(250, BF16, sink=True) == 138_240 + 65_536 == 203_776
    for L in (1, 250, 464):
        assert tv.shared_memory_bytes(L, dtype) == fb.shared_memory_bytes(L, dtype)
    tv._check_length(ceiling, dtype, "s2s_fft_block_parts", sink=True)
    with pytest.raises(ValueError, match=re.escape(f"the largest L that fits is {ceiling}")):
        tv._check_length(ceiling + 1, dtype, "s2s_fft_block_parts", sink=True)
