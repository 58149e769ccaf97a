"""The train step's threefry (ops/threefry.py): key derivations and dropout
draws, on their plain path on the CPU and through csrc/threefry.cu on the
card (`gpu`).

Bars: everything bit-equal to prng.py's torch ops, the spec. On the CPU the
dispatch takes those ops themselves; the card's kernels compute the same
integers and the same f32 comparison (uniform in [0, 1) is f exactly, with
no fused multiply-add to round), so there is no tolerance anywhere.
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import pathlib
import re

import numpy as np
import pytest
import torch

from seq2squiggle_tpu_torch import prng, tracing
from seq2squiggle_tpu_torch.config import load_config
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.ops import block_train as tblock
from seq2squiggle_tpu_torch.ops import threefry as tthreefry
from seq2squiggle_tpu_torch.train import loop as tloop
from seq2squiggle_tpu_torch.train import optimizers as topt

CSRC = pathlib.Path(tthreefry.__file__).resolve().parents[1] / "csrc"
SEED = (7 << 32) + 2 ** 31 + 7  # fills both words of the key


@pytest.fixture
def counting(monkeypatch):
    """The span recorder on and empty; both restored afterwards."""
    monkeypatch.setenv(tracing.ENV, "1")
    tracing.switch_from_env()
    tracing.reset()
    yield
    monkeypatch.delenv(tracing.ENV, raising=False)
    tracing.switch_from_env()
    tracing.reset()


# ---- the kernel's constants are prng.py's ----

def _cuh() -> str:
    return (CSRC / "threefry.cuh").read_text()


def test_kernel_rotations_are_prngs():
    """threefry2x32's five rounds of four rotations alternate prng._ROT's
    two rows."""
    rounds = re.findall(r"mix4<(\d+), (\d+), (\d+), (\d+)>", _cuh())
    assert [tuple(map(int, r)) for r in rounds] == [prng._ROT[g % 2] for g in range(5)]


def test_kernel_key_schedule_is_prngs():
    """After round g the key words ks[(g + 1) % 3] and ks[(g + 2) % 3] + g + 1
    are injected, with k2 = k0 ^ k1 ^ the parity constant of prng.py."""
    text = _cuh()
    injected = re.findall(r"x0 \+= k(\d); x1 \+= k(\d) \+ (\d)u;", text)
    assert [tuple(map(int, r)) for r in injected] == [((g + 1) % 3, (g + 2) % 3, g + 1)
                                                      for g in range(5)]
    parity = int(re.search(r"k2 = key\.k0 \^ key\.k1 \^ (0x[0-9A-F]+)u", text).group(1), 16)
    for k0, k1 in ((0x12345678, 0x9ABCDEF0), (0, 0), (0xFFFFFFFF, 1)):
        x0, _ = prng.threefry2x32(torch.tensor(k0), torch.tensor(k1), 0, 0)
        assert x0.item() == _threefry_host(k0, k1, parity)


def _threefry_host(k0: int, k1: int, parity: int) -> int:
    """x0 of threefry2x32((k0, k1), (0, 0)) in Python ints, with the header's
    rotations, schedule and `parity`: the kernel's arithmetic off the card."""
    m = 0xFFFFFFFF
    ks = (k0, k1, k0 ^ k1 ^ parity)
    x0, x1 = k0, k1
    for g in range(5):
        for r in prng._ROT[g % 2]:
            x0 = (x0 + x1) & m
            x1 = (((x1 << r) | (x1 >> (32 - r))) & m) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & m
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & m
    return x0


def test_kernel_uniform_is_prngs():
    """uniform keeps the top 23 bits under the exponent of 1.0 and subtracts
    1, as prng._bits_to_unit; the dropout draw compares it with keep at
    [0, 1)."""
    text = _cuh()
    body = text[text.index(" uniform("):text.index("\n}\n", text.index(" uniform("))]
    assert "__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f)" in body
    bits = torch.tensor([0, 511, 512, 2 ** 31, 2 ** 32 - 1])
    assert prng._bits_to_unit(bits).tolist() == [0.0, 0.0, 2.0 ** -23, 0.5, 1 - 2.0 ** -23]
    draw = (CSRC / "threefry.cu").read_text()
    assert "uniform(random_bits(key, (uint32_t)(offset + i)), 0.0f, 1.0f)" in draw
    assert "u < keep ? on : T(0)" in draw


# ---- the plain path on the CPU ----

KEYS = [prng.key(SEED), prng.split(prng.key(3), 5)]  # one key, and a batch of five


@pytest.mark.parametrize("key", KEYS, ids=["one", "batch"])
@pytest.mark.parametrize("data", [0, 1, 10_000, 2 ** 32 - 1, 2 ** 32 + 5])
def test_fold_in_on_the_cpu_is_prngs(key, data):
    assert torch.equal(tthreefry.fold_in(key, data), prng.fold_in(key, data))


@pytest.mark.parametrize("key", KEYS, ids=["one", "batch"])
@pytest.mark.parametrize("num", [2, 4])
def test_split_on_the_cpu_is_prngs(key, num):
    assert torch.equal(tthreefry.split(key, num), prng.split(key, num))


@pytest.mark.parametrize("key", KEYS, ids=["one", "batch"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_fold_in_split_on_the_cpu_is_the_old_chain(key, n):
    """split(fold_in(key, i)) for each block, as _train_blocks derived it."""
    got = tthreefry.fold_in_split(key, n)
    assert got.shape == (*key.shape[:-1], n, 2, 2)
    for i in range(n):
        assert torch.equal(got[..., i, :, :], prng.split(prng.fold_in(key, i)))


MASK_CASES = [((37, 25, 64), None, 0), ((8, 16, 64), None, 0), ((4, 25, 64), 16, 8),
              ((3, 7), 12, 9)]


@pytest.mark.parametrize("shape,rows,start", MASK_CASES)
@pytest.mark.parametrize("keep", [0.8, 0.5])
def test_bernoulli_on_the_cpu_is_prngs(counting, shape, rows, start, keep):
    """The mask is prng.bernoulli's over the global rows, cut to the slab;
    the plain path draws the global rows and counts them."""
    key = prng.key(SEED)
    n_rows = rows or shape[0]
    got = tthreefry.bernoulli(key, keep, shape, rows, start)
    want = prng.bernoulli(key, keep, (n_rows, *shape[1:]))[start:start + shape[0]]
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert tracing.totals().counts == {"train.masks_plain": n_rows * int(np.prod(shape[1:]))}


@pytest.mark.parametrize("shape,rows,start", MASK_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dropout_scales_on_the_cpu_are_the_old_formula(shape, rows, start, dtype):
    """{1/keep, 0} built in f32 from prng.bernoulli's mask, then cast: the
    formula make_dropout_scales used before the dispatch, bit for bit."""
    key, keep = prng.key(SEED), 0.8
    n_rows = rows or shape[0]
    mask = prng.bernoulli(key, keep, (n_rows, *shape[1:]))[start:start + shape[0]]
    want = (mask.to(torch.float32) * (1.0 / keep)).to(dtype)
    got = tthreefry.dropout_scales(key, keep, shape, dtype, rows, start)
    assert got.dtype == dtype and torch.equal(got, want)


def test_cpu_draws_launch_nothing(counting):
    """The CPU path takes no kernel launch and counts no kernel elements."""
    launches = tthreefry.launches
    key = prng.key(SEED)
    tthreefry.split(tthreefry.fold_in(key, 3), 4)
    tthreefry.fold_in_split(key, 2)
    tthreefry.dropout_scales(key, 0.8, (2, 5, 8), torch.bfloat16)
    tthreefry.bernoulli(key, 0.8, (2, 5, 8))
    assert tthreefry.launches == launches
    assert tracing.totals().counts == {"train.masks_plain": 160}


@pytest.mark.parametrize("call", [
    lambda: tthreefry._derive(prng.key(1).to(torch.int32), 0, 1, 0),
    lambda: tthreefry._derive(torch.zeros(3, dtype=torch.int64), 0, 1, 0),
    lambda: tthreefry._draw(prng.split(prng.key(1)), 0.8, (2, 3), 2, 0, torch.bool, 1),
    lambda: tthreefry._draw(prng.key(1), 0.8, (2, 3), 2, 0, torch.float64, 0),
    lambda: tthreefry._draw(prng.key(1), 0.8, (2, 3), 3, 2, torch.bool, 1),
], ids=["int32 key", "odd key", "two keys", "float64", "slab past the rows"])
def test_kernel_wrappers_refuse_what_they_cannot_draw(call):
    """The launch wrappers check keys, dtypes and slabs before any launch."""
    with pytest.raises(ValueError):
        call()


def test_make_dropout_scales_on_a_dp_slab_is_the_global_draws_rows():
    from seq2squiggle_tpu_torch.parallel import mesh as tmesh

    key, shape = prng.key(SEED), (4, 10, 8)
    whole = tblock.make_dropout_scales(key, 0.2, (8, 10, 8), torch.bfloat16)
    for r in range(2):
        got = tblock.make_dropout_scales(key, 0.2, shape, torch.bfloat16,
                                         tmesh.make_mesh(2, 1, world=2, rank=r))
        assert torch.equal(got, whole[4 * r:4 * r + 4])


def test_cpu_train_step_draws_its_eleven_masks_on_the_plain_path(counting):
    """One train step on the CPU: 11 `train.masks` spans, every element on the
    plain path (the encoder's 4 and the heads' 3 draws at (B, K, D), the
    decoder's 4 at (B, T, D)), no kernel launch, an eager step."""
    cfg = dict(load_config(None), compute_dtype="float32", max_signal_len=40)
    B, K, T, D = 3, cfg["max_dna_len"], cfg["max_signal_len"], cfg["dmodel"]
    rng = np.random.default_rng(0)
    batch = {
        "chunks": torch.from_numpy(np.eye(5, dtype=np.float32)[
            rng.integers(0, 5, (B, K, cfg["seq_kmer"]))]),
        "targets": torch.from_numpy(rng.random((B, T, 1)).astype(np.float32)),
        "chunks_lengths": torch.from_numpy(rng.integers(1, 3, (B, K)).astype(np.int32)),
        "stdevs": torch.from_numpy((rng.random((B, K)) * 0.1).astype(np.float32)),
    }
    params = tmodel.to_train_params(tmodel.init_params(cfg, prng.key(2)), torch.device("cpu"))
    opt = topt.build_optimizer(cfg, 10)
    state = opt.init([v for _, v in tmodel.tree_leaves(params)])
    launches = tthreefry.launches
    tloop.make_train_step(cfg, opt)(params, state, batch, torch.ones(B), prng.key(SEED))
    got = tracing.totals()
    assert got.spans["train.masks"][0] == 11 and got.spans["train.step"][0] == 1
    assert got.counts == {"train.masks_plain": 7 * B * K * D + 4 * B * T * D,
                          "train.eager_steps": 1}
    assert tthreefry.launches == launches


# ---- the kernels on the card ----

@pytest.mark.gpu
@pytest.mark.parametrize("shape,rows,start", [
    ((512, 250, 64), None, 0), ((512, 16, 64), None, 0), ((37, 250, 64), None, 0),
    ((128, 250, 64), 512, 256)], ids=["decoder", "encoder", "ragged", "dp slab"])
def test_kernel_masks_and_scales_are_prngs(shape, rows, start):
    """chip_smoke.py phase 19's bars: the bool mask and the bf16 and f32
    scales through the kernel bit-equal to prng.py's torch ops on the card,
    at keep 0.8 and 0.9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    got = chip_smoke.hold_mask_kernel(torch.device("cuda"), shape, rows, start)
    kept = got["kept"]
    assert got["max_abs_err"] == 0.0
    assert abs(kept[0.8] - 0.8) < 0.01 and abs(kept[0.9] - 0.9) < 0.01


@pytest.mark.gpu
def test_kernel_keys_are_prngs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    assert chip_smoke.hold_key_kernel(torch.device("cuda")) > 0


@pytest.mark.gpu
def test_train_step_through_the_kernels_is_the_plain_draws_step():
    """One make_train_step call at the default config on the card: the loss
    and every gradient bit-equal with the kernels and with prng.py's ops."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    assert chip_smoke.hold_train_step(torch.device("cuda"))["leaves"] == 84
