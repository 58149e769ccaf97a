"""The fused block's eight profiling cuts (`fused_fft_block(..., ablate=...)`,
ops/fft_block_variants.py::fused_ablate) against the Pallas kernel with the
same `ablate` in interpret mode, on the JAX CPU backend.

Output level: the port's plain `fused_fft_block(x, block, 8, packed, ablate)`
against seq2squiggle_tpu.ops.pallas.fft_block.fused_fft_block(...,
interpret=True, ablate=...) with the committed R10 decoder block 0 and x =
0.5·N(0, 1) from numpy seed 0: every cut in float32 and bfloat16 in both
softmax forms at (2, 37, 64) (L = 37 pads to 40 on the TPU and to 48 on the
port, the shape where `nomask` differs between the two paddings), and every
cut in bfloat16 in the Cauchy–Schwarz form at (2, 250, 64). Bars are the
fused block's (tests/test_pallas.py): float32 rtol 2e-3 / atol 2e-4,
bfloat16 within 4 bf16 ULPs of max(1, max|ref|).

Four of the cuts (noshift, bf16exp, nomask, thin16) move the block's output by
less than that bar, so the output alone cannot show that they were taken.
Attention level: the port's plain packed attention with each cut against the
JAX package's `_attn_packed(..., ablate)` called directly (a plain jnp
function) at the attention core's bar, float32 rtol / atol 1e-5, at L = 40
with 37 real keys (for noexp the atol scales with max|ref|: its ctx is
num·1e30, and num an unnormalised sum of terms of both signs that the two
frameworks add in different orders); and thin16, nomask, noden and noexp move
ctx by more than that bar.

One module fixture makes the 40 Pallas calls, four compiles at a time.
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import math
import os
import pathlib
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu.models.torch_import import load_checkpoint as jax_load_checkpoint
from seq2squiggle_tpu.ops.pallas import fft_block as jfused
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.models.weights import params_from_jax
from seq2squiggle_tpu_torch.ops import fft_block as tfused
from seq2squiggle_tpu_torch.ops import fft_block_variants as tv

ROOT = pathlib.Path(__file__).resolve().parents[1]
R10 = str(ROOT / "assets" / "bench-weights-R10.npz")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CASES = ([(cut, dtype, packed, 37) for cut in tv.ABLATIONS for dtype in DTYPES
          for packed in (False, True)]
         + [(cut, "bfloat16", True, 250) for cut in tv.ABLATIONS])


@pytest.fixture(scope="module")
def block():
    jp, _ = jax_load_checkpoint(R10)
    return jp["decoder"]["blocks"][0], params_from_jax(jp)["decoder"]["blocks"][0]


def _inputs(L: int, dtype: str):
    """The same (2, L, 64) values as a JAX and a torch array of `dtype`."""
    jd, td = DTYPES[dtype]
    x = (np.random.default_rng(0).standard_normal((2, L, 64)) * 0.5).astype(np.float32)
    xj = jnp.asarray(x, jd)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(td)


@pytest.fixture(scope="module")
def pallas(block):
    """(cut, dtype, packed, L) -> the Pallas kernel's output in interpret
    mode with that `ablate`, as float32 numpy."""
    jb, _ = block

    def run(case):
        cut, dtype, packed, L = case
        xj, _ = _inputs(L, dtype)
        out = jfused.fused_fft_block(xj, jb, n_head=8, interpret=True, tile_b=2, packed=packed,
                                     ablate=cut)
        return np.asarray(out.astype(jnp.float32))

    with ThreadPoolExecutor(min(4, os.cpu_count() or 1)) as pool:
        return dict(zip(CASES, pool.map(run, CASES)))


def _hold(got: torch.Tensor, ref, dtype: str):
    ref = np.asarray(ref).astype(np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
    else:
        tol = 4 * 2.0 ** -8 * max(1.0, float(np.max(np.abs(ref))))
        assert float(np.max(np.abs(got - ref))) <= tol


@pytest.mark.parametrize("cut,dtype,packed,L", CASES,
                         ids=[f"{c}-{d}-{'shift' if p else 'exact'}-{L}" for c, d, p, L in CASES])
def test_cut_matches_pallas_ablate(block, pallas, cut, dtype, packed, L):
    _, tb = block
    _, xt = _inputs(L, dtype)
    got = tfused.fused_fft_block(xt, tb, 8, packed=packed, ablate=cut)
    assert got.dtype == xt.dtype
    _hold(got, pallas[cut, dtype, packed, L], dtype)


# ---- the attention itself ---------------------------------------------------

L_PAD, L_REAL = 40, 37  # the TPU kernel's padding of L = 37


@pytest.fixture(scope="module")
def qkv():
    """f32 q, k, v of (2·40, 64) from numpy seed 1, as the JAX kernel takes
    them (rows of the two batch rows one after the other)."""
    rng = np.random.default_rng(1)
    return [rng.standard_normal((2 * L_PAD, 64)).astype(np.float32) for _ in range(3)]


def _jax_ctx(qkv, ablate: str) -> np.ndarray:
    q, k, v = (jnp.asarray(t) for t in qkv)
    ctx = jfused._attn_packed(q, k, v, 2, L_PAD, 8, 8, 1.0 / math.sqrt(8), jnp.float32, L_REAL,
                              ablate)
    return np.asarray(ctx)


def _port_ctx(qkv, ablate: str) -> np.ndarray:
    q, k, v = (torch.from_numpy(t).reshape(2, L_PAD, 8, 8).transpose(1, 2) for t in qkv)
    ctx = tv.packed_cut_attention(q, k, v, 1.0 / math.sqrt(8), ablate, L_REAL)
    return ctx.transpose(1, 2).reshape(2 * L_PAD, 64).numpy()


@pytest.mark.parametrize("cut", tv.ATTENTION_CUTS)
def test_cut_attention_matches_attn_packed(qkv, cut):
    ref = _jax_ctx(qkv, cut)
    got = _port_ctx(qkv, cut)
    scale = max(1.0, float(np.abs(ref).max())) if cut == "noexp" else 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)
    if cut in ("thin16", "nomask", "noden", "noexp"):  # taken: ctx is not the uncut one
        uncut = _jax_ctx(qkv, "")
        assert not np.allclose(got, uncut, rtol=1e-5, atol=1e-5)
    if cut == "noexp":  # every e <= 0, so den is clamped to 1e-30
        assert np.abs(got).max() > 1e25 and np.isfinite(got).all()


# ---- bookkeeping ------------------------------------------------------------

def test_exact_form_ignores_the_attention_cuts(block):
    """In the exact form (packed=False, or None at L <= 32) the six attention
    cuts are the identity, as `_attn_headloop` ignores `ablate`; noattn and
    noffn still cut."""
    _, tb = block
    _, x = _inputs(16, "float32")
    exact = tfused.fused_fft_block(x, tb, 8)
    for cut in tv.ATTENTION_CUTS:
        assert torch.equal(tfused.fused_fft_block(x, tb, 8, ablate=cut), exact)
        assert torch.equal(tfused.fused_fft_block_reference(x, tb, 8, False, cut), exact)
    for cut in ("noattn", "noffn"):
        assert not torch.allclose(tfused.fused_fft_block(x, tb, 8, ablate=cut), exact)


def test_unknown_cut_raises_and_the_cpu_launches_nothing(block):
    _, tb = block
    x = torch.zeros(2, 16, 64)
    before = tv.launches_ablate
    for fn in (tfused.fused_fft_block, tfused.fused_fft_block_reference, tv.fused_ablate):
        with pytest.raises(ValueError, match="ablate"):
            fn(x, tb, 8, None, "noscores")
    assert tfused.fused_fft_block(x, tb, 8, ablate="noffn").shape == x.shape
    assert tv.fused_ablate(x, tb, 8, True, "nomask").shape == x.shape
    assert tv.launches_ablate == before


@pytest.fixture(scope="module")
def quiet_cuts(block):
    """bf16 (3, 37, 64) x from numpy seed 37, the block in bf16, and its plain
    outputs: {cut: out} in the Cauchy–Schwarz form ("" the uncut block)."""
    _, tb = block
    b = tmodel.to_device({"decoder": {"blocks": [tb]}}, torch.device("cpu"),
                         torch.bfloat16)["decoder"]["blocks"][0]
    x = torch.from_numpy(np.random.default_rng(37).standard_normal((3, 37, 64))
                         .astype(np.float32)).to(torch.bfloat16)
    outs = {cut: tfused.fused_fft_block_reference(x, b, 8, True, cut)
            for cut in ("", *tv.QUIET_CUTS)}
    return x, b, outs


@pytest.mark.parametrize("cut", tv.QUIET_CUTS)
def test_check_cut_taken_refuses_a_skipped_cut(quiet_cuts, cut):
    """The card's evidence for the four cuts inside the bf16 bar passes the
    plain version of the cut and refuses the uncut block in its place."""
    _, _, outs = quiet_cuts
    uncut = outs[""]
    ratio = tv.check_cut_taken(cut, True, 37, outs[cut], outs[cut], uncut, uncut)
    assert ratio in (None, 0.0)
    with pytest.raises(AssertionError):
        tv.check_cut_taken(cut, True, 37, uncut, outs[cut], uncut, uncut)


def test_check_cut_taken_refuses_a_wrong_cut(quiet_cuts):
    """nomask counting the keys up to the port's padding to 16 rows (48 at
    L = 37) instead of the TPU kernel's 8 (40); and an attention cut that
    changes the exact form, where it must launch the uncut block."""
    x, b, outs = quiet_cuts
    x48 = torch.nn.functional.pad(x, (0, 0, 0, 48 - 37))
    pad16 = tfused.fused_fft_block_reference(x48, b, 8, True, "nomask")[:, :37]
    with pytest.raises(AssertionError):
        tv.check_cut_taken("nomask", True, 37, pad16, outs["nomask"], outs[""], outs[""])
    exact = tfused.fused_fft_block_reference(x, b, 8, False)
    assert tv.check_cut_taken("thin16", False, 37, exact, exact, exact, exact) is None
    with pytest.raises(AssertionError):
        tv.check_cut_taken("thin16", False, 37, outs["thin16"], exact, exact, exact)


@pytest.mark.gpu
def test_cut_kernels_match_plain_on_the_card(block):
    """Each cut's kernel against its plain version at the slab edges and at
    L = 37 and 250, both softmax forms and dtypes (chip_smoke.py phase 12 runs
    the same at the timing shape): bars as above; in bf16, where the bar
    cannot show a cut, `fft_block_variants.check_cut_taken`'s evidence that
    the kernel took it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    _, tb = block
    for td in (torch.float32, torch.bfloat16):
        b = tmodel.to_device({"decoder": {"blocks": [tb]}}, dev, td)["decoder"]["blocks"][0]
        for L in (15, 16, 17, 37, 250):
            x = torch.from_numpy(np.random.default_rng(L).standard_normal((3, L, 64))
                                 .astype(np.float32)).to(dev, td)
            for packed in (False, True):
                uncut = (tfused.fused_fft_block(x, b, 8, packed),
                         tfused.fused_fft_block_reference(x, b, 8, packed))
                for cut in tv.ABLATIONS:
                    got = tfused.fused_fft_block(x, b, 8, packed, cut)
                    ref = tfused.fused_fft_block_reference(x, b, 8, packed, cut)
                    _hold(got.cpu(), ref.float().cpu().numpy(), str(td)[6:])
                    if td == torch.bfloat16:
                        tv.check_cut_taken(cut, packed, L, got, ref, *uncut)
