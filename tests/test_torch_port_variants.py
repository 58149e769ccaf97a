"""The plain versions of the fused block's profiling variants
(ops/fft_block_variants.py: fused_abc, fused_d, fused_parts) against the three
Pallas timing kernels they port, scripts/profiling/profile_abc.py,
profile_d.py and profile_parts2.py, on the JAX CPU backend.

The scripts are not a package and their `pallas_call`s take no `interpret`
argument, so each is loaded from its path and handed a `pl` whose
`pallas_call` interprets; nothing in those files changes. Loading one runs
its module-level set-up (logging, the compile cache, seeds, the committed R10
weights), which the fixture undoes.

Bars, at (4, 250, 64) with `tile_b=2`, the committed R10 decoder block 0: the
whole-block variants a, b, c, d and stage `full` at the fused block's bars
(float32 rtol 2e-3 / atol 2e-4, bfloat16 within 4 bf16 ULPs of
max(1, max|ref|)); the partial stages float32 rtol 1e-4 / atol
1e-5·max(1, max|ref|), bfloat16 within 4 bf16 ULPs of max(1, max|ref|);
variant c bit-equal to b. The stages' atol scales with the largest value
because their sinks are unnormalised float32 sums (250 products per head,
eight heads, |values| up to ~120 here) that the two frameworks add in
different orders: an entry near 0 carries the rounding of its large terms.
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import functools
import importlib.util
import logging
import os
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from seq2squiggle_tpu.models.torch_import import load_checkpoint as jax_load_checkpoint
from seq2squiggle_tpu_torch.models.weights import params_from_jax
from seq2squiggle_tpu_torch.ops import fft_block_variants as tv

ROOT = pathlib.Path(__file__).resolve().parents[1]
R10 = str(ROOT / "assets" / "bench-weights-R10.npz")
SHAPE = (4, 250, 64)


def _load_script(name: str):
    """scripts/profiling/<name>.py as a module whose kernels interpret."""
    path = ROOT / "scripts" / "profiling" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_profiling_{name}", path)
    module = importlib.util.module_from_spec(spec)
    root = logging.getLogger()
    warn = logging.getLogger("py.warnings")
    saved = (root.level, list(root.handlers), list(warn.handlers), list(sys.path),
             os.environ.get("PYTHONHASHSEED"), jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        spec.loader.exec_module(module)
    finally:
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]
        warn.handlers[:] = saved[2]
        logging.captureWarnings(False)
        sys.path[:] = saved[3]
        if saved[4] is None:
            os.environ.pop("PYTHONHASHSEED", None)
        else:
            os.environ["PYTHONHASHSEED"] = saved[4]
        jax.config.update("jax_compilation_cache_dir", saved[5])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[6])
    module.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    return module


@pytest.fixture(scope="module")
def scripts():
    try:
        return {name: _load_script(name)
                for name in ("profile_abc", "profile_d", "profile_parts2")}
    except Exception as exc:  # a script that cannot load here fails the tests, with the reason
        pytest.fail(f"could not load a profiling script: {exc!r}")


@pytest.fixture(scope="module")
def block():
    jp, _ = jax_load_checkpoint(R10)
    return jp["decoder"]["blocks"][0], params_from_jax(jp)["decoder"]["blocks"][0]


def _inputs(dtype: str, seed: int = 0):
    x = (np.random.default_rng(seed).standard_normal(SHAPE) * 0.5).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)))
    return xj, xt.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _hold(got: torch.Tensor, ref, dtype: str, rtol: float, atol: float, scaled: bool):
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.max(np.abs(ref))))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * (scale if scaled else 1.0))
    else:
        tol = 4 * 2.0 ** -8 * scale
        assert float(np.max(np.abs(got - ref))) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", tv.ABC_VARIANTS)
def test_fused_abc_matches_profile_abc(scripts, block, variant, dtype):
    jb, tb = block
    xj, xt = _inputs(dtype)
    ref = scripts["profile_abc"].fused(xj, jb, 8, tile_b=2, variant=variant)
    _hold(tv.fused_abc(xt, tb, 8, variant), ref, dtype, 2e-3, 2e-4, scaled=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", tv.D_VARIANTS)
def test_fused_d_matches_profile_d(scripts, block, variant, dtype):
    jb, tb = block
    xj, xt = _inputs(dtype, seed=1)
    ref = scripts["profile_d"].fused(xj, jb, 8, tile_b=2, variant=variant)
    _hold(tv.fused_d(xt, tb, 8, variant), ref, dtype, 2e-3, 2e-4, scaled=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage", tv.STAGES)
def test_fused_parts_matches_profile_parts2(scripts, block, stage, dtype):
    jb, tb = block
    assert tv.STAGES == scripts["profile_parts2"].STAGES
    xj, xt = _inputs(dtype, seed=2)
    ref = scripts["profile_parts2"].fused(xj, jb, 8, tile_b=2, stage=stage)
    rtol, atol = (2e-3, 2e-4) if stage == "full" else (1e-4, 1e-5)
    _hold(tv.fused_parts(xt, tb, 8, stage), ref, dtype, rtol, atol, scaled=stage != "full")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_variant_c_is_bit_equal_to_b(block, dtype):
    """den as a ninth column of e·v sums the same values in the same order."""
    _, tb = block
    _, xt = _inputs(dtype, seed=3)
    b = tv.fused_abc(xt, tb, 8, "b")
    assert torch.equal(tv.fused_abc(xt, tb, 8, "c"), b)
    assert torch.equal(tv.fused_d(xt, tb, 8, "b"), b)
    assert torch.equal(tv.fused_parts(xt, tb, 8, "full"), b)


def test_variants_check_their_arguments_and_count_no_cpu_launch(block):
    _, tb = block
    x = torch.zeros(2, 16, 64)
    before = (tv.launches_abc, tv.launches_d, tv.launches_parts)
    with pytest.raises(ValueError, match="variant"):
        tv.fused_abc(x, tb, 8, "d")
    with pytest.raises(ValueError, match="variant"):
        tv.fused_d(x, tb, 8, "a")
    with pytest.raises(ValueError, match="stage"):
        tv.fused_parts(x, tb, 8, "softmax")
    with pytest.raises(ValueError, match="key columns"):
        tv.fused_parts(torch.zeros(2, 5, 64), tb, 8, "max")
    assert tv.fused_parts(torch.zeros(2, 5, 64), tb, 8, "proj").shape == (2, 5, 64)
    assert tv.fused_parts(x, tb, 8, "den").shape == (2, 16, 64)
    assert (tv.launches_abc, tv.launches_d, tv.launches_parts) == before
