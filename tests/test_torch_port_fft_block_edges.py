"""The fused block's and the pair's plain versions (ops/fft_block.py) against
the JAX package's Pallas kernels in interpret mode (as tests/test_pallas.py
runs them), at the lengths where the bf16 kernels' 16-row slabs and the
default softmax form change: L = 1, 15, 16, 17 (one slab, full, one row
over), 31, 32, 33 (the last exact-max length and the first Cauchy–Schwarz
one, two and three slabs) and 37, both softmax forms, float32 and bfloat16.
The plain versions are what the CUDA kernels are held against on the card
(chip_smoke.py phases 2 and 11; `test_kernels_match_plain_on_the_card` below
where there is a GPU).

Bars (test_pallas.py:26-65): float32 rtol 2e-3 / atol 2e-4; bfloat16 within
4 bf16 ULPs of max(1, max|ref|). Each Pallas call costs a compile of its own
shape, so a module fixture makes all 64 at once, four compiles at a time.
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.models.fft_model import init_params
from seq2squiggle_tpu.ops.pallas import fft_block as jfused
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.models.weights import params_from_jax
from seq2squiggle_tpu_torch.ops import fft_block as tfused

EDGES = (1, 15, 16, 17, 31, 32, 33, 37)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def blocks():
    """The decoder's two blocks of a seed-0 model, as both packages hold them."""
    jp = init_params(load_config(None), jax.random.key(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp["decoder"]["blocks"], tp["decoder"]["blocks"]


def _inputs(L: int, dtype: str):
    """The same (2, L, 64) values as a JAX and a torch array of `dtype`."""
    jd, td = DTYPES[dtype]
    xj = jnp.asarray(np.random.default_rng(L).standard_normal((2, L, 64)), jd)
    return xj, torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(td)


CASES = [(kind, L, packed, dtype) for kind in ("block", "pair") for L in EDGES
         for packed in (False, True) for dtype in DTYPES]


@pytest.fixture(scope="module")
def pallas(blocks):
    """(kind, L, packed, dtype) -> the Pallas kernel's output in interpret mode
    on `_inputs(L, dtype)`, as float32 numpy."""
    (jb0, jb1), _ = blocks

    def run(case):
        kind, L, packed, dtype = case
        xj, _ = _inputs(L, dtype)
        if kind == "block":
            out = jfused.fused_fft_block(xj, jb0, n_head=8, interpret=True, tile_b=2,
                                         packed=packed)
        else:
            out = jfused.fused_fft_block_pair(xj, jb0, jb1, n_head=8, interpret=True, tile_b=2,
                                              packed=packed)
        return np.asarray(out.astype(jnp.float32))

    with ThreadPoolExecutor(min(4, os.cpu_count() or 1)) as pool:
        return dict(zip(CASES, pool.map(run, CASES)))


def _hold(got: torch.Tensor, ref, dtype: str):
    ref = np.asarray(ref).astype(np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
    else:
        tol = 4 * 2.0 ** -8 * max(1.0, float(np.max(np.abs(ref))))
        assert float(np.max(np.abs(got - ref))) <= tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("packed", [False, True], ids=["exact", "shift"])
@pytest.mark.parametrize("L", EDGES)
def test_block_reference_matches_pallas_at_slab_edges(blocks, pallas, L, packed, dtype):
    _, (tb, _) = blocks
    _, xt = _inputs(L, dtype)
    got = tfused.fused_fft_block_reference(xt, tb, 8, packed)
    assert got.dtype == xt.dtype
    _hold(got, pallas["block", L, packed, dtype], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("packed", [False, True], ids=["exact", "shift"])
@pytest.mark.parametrize("L", EDGES)
def test_pair_reference_matches_pallas_pair_at_slab_edges(blocks, pallas, L, packed, dtype):
    _, (tb0, tb1) = blocks
    _, xt = _inputs(L, dtype)
    got = tfused.fused_fft_block_pair_reference(xt, tb0, tb1, 8, packed)
    assert got.dtype == xt.dtype
    _hold(got, pallas["pair", L, packed, dtype], dtype)


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card(blocks):
    """The CUDA kernels against the plain versions at the same lengths, and
    the pair on both sides of the length past which it stages its activation
    through the output rows (chip_smoke.py phases 2 and 11 run the same, with
    the predict path's shapes): bars as above, the pair bit-equal to two
    one-block launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    _, (tb0, tb1) = blocks
    for td in (torch.float32, torch.bfloat16):
        b0, b1 = tmodel.to_device({"decoder": {"blocks": [tb0, tb1]}}, dev, td)["decoder"]["blocks"]
        on_chip = max(L for L in range(1, 600) if tfused.pair_keeps_activation_on_chip(L, td))
        for L in (*EDGES, on_chip, on_chip + 1):
            x = torch.from_numpy(np.random.default_rng(L).standard_normal((3, L, 64))
                                 .astype(np.float32)).to(dev, td)
            for packed in (False, True):
                pair = tfused.fused_fft_block_pair(x, b0, b1, 8, packed)
                two = tfused.fused_fft_block(tfused.fused_fft_block(x, b0, 8, packed), b1, 8,
                                             packed)
                assert torch.equal(pair, two), (td, L, packed)
                for got, ref in ((tfused.fused_fft_block(x, b0, 8, packed),
                                  tfused.fused_fft_block_reference(x, b0, 8, packed)),
                                 (pair, tfused.fused_fft_block_pair_reference(x, b0, b1, 8,
                                                                             packed))):
                    _hold(got.cpu(), ref.float().cpu().numpy(), str(td)[6:])
