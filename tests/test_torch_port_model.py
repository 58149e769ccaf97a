"""The port's model (models/fft_model.py, models/weights.py) against
seq2squiggle_tpu/models on the JAX CPU backend.

Bars: init_params through the port's threefry (`-m random`) is bit-equal;
checkpoint loading (.npz and reference .ckpt) is bit-equal; encoder, decoder
and heads are within rtol 1e-4 / atol 1e-5 in float32 and within 4 bf16 ULPs
of max|ref| in bfloat16.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.models import fft_model as jmodel
from seq2squiggle_tpu.models.torch_import import load_checkpoint as jax_load_checkpoint
from seq2squiggle_tpu_torch import prng
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.models.weights import load_checkpoint, params_from_jax

R10 = str(pathlib.Path(__file__).resolve().parents[1] / "assets" / "bench-weights-R10.npz")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.numpy() if hasattr(tree, "numpy") else tree)}


def _assert_trees_equal(jtree, ttree):
    a, b = _flat(jtree), _flat(ttree)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k].astype(np.float32), b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_bit_equal(seed):
    cfg = load_config(None)
    jp = jmodel.init_params(cfg, jax.random.key(seed))
    tp = tmodel.init_params(cfg, prng.key(seed))
    _assert_trees_equal(jp, tp)
    assert tmodel.count_params(tp) == jmodel.count_params(jp)


def test_load_npz_checkpoint_bit_equal():
    jp, jcfg = jax_load_checkpoint(R10)
    tp, tcfg = load_checkpoint(R10)
    assert tcfg == jcfg
    _assert_trees_equal(jp, tp)


def _state_dict(p):
    """The reference's state_dict for a parameter tree (inverse of
    models/torch_import.params_from_state_dict)."""
    sd = {}

    def lin(name, q):
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(q["kernel"]).T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(q["bias"]))

    def ln(name, q):
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(q["scale"]))
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(q["bias"]))

    def block(prefix, b):
        for n in ("w_qs", "w_ks", "w_vs", "fc"):
            lin(f"{prefix}.slf_attn.{n}", b["attn"][n])
        ln(f"{prefix}.slf_attn.layer_norm", b["attn"]["ln"])
        lin(f"{prefix}.pos_ffn.w_1", b["ffn"]["w_1"])
        lin(f"{prefix}.pos_ffn.w_2", b["ffn"]["w_2"])
        ln(f"{prefix}.pos_ffn.layer_norm", b["ffn"]["ln"])

    enc, dec = p["encoder"], p["decoder"]
    lin("encoders.src_emb", enc["src_emb"])
    for i, q in enumerate(enc["pre_net"]):
        lin(f"encoders.pre_net_stack.{i}", q)
    sd["encoders.position_enc"] = torch.from_numpy(np.asarray(enc["pos_enc"]))[None]
    for i, b in enumerate(enc["blocks"]):
        block(f"encoders.layer_stack.{i}", b)
    sd["decoders.position_enc"] = torch.from_numpy(np.asarray(dec["pos_enc"]))[None]
    for i, b in enumerate(dec["blocks"]):
        block(f"decoders.layer_stack_FFT.{i}", b)
    lin("decoders.out_linear", dec["out_linear"])
    for name, head in (("noise_sampler.stdv_layer", p["noise_sampler"]),
                       ("length_regulator.duration_sampler.conc_layer",
                        p["duration_sampler"]["conc"]),
                       ("length_regulator.duration_sampler.rate_layer",
                        p["duration_sampler"]["rate"])):
        lin(f"{name}.0", head["fc1"])
        lin(f"{name}.3", head["fc2"])
    return sd


def test_load_reference_ckpt_bit_equal(tmp_path):
    jp, cfg = jax_load_checkpoint(R10)
    path = tmp_path / "ref.ckpt"
    torch.save({"state_dict": _state_dict(jp), "hyper_parameters": {"config": cfg}}, path)
    jp2, jcfg = jax_load_checkpoint(str(path))
    tp, tcfg = load_checkpoint(str(path))
    assert tcfg == jcfg
    _assert_trees_equal(jp2, tp)
    _assert_trees_equal(jp, tp)


@pytest.fixture(scope="module")
def r10():
    jp, _ = jax_load_checkpoint(R10)
    return jp, params_from_jax(jp)


def _compare(ref, got, dtype):
    ref = np.asarray(ref).astype(np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    else:
        tol = 4 * 2.0 ** -8 * max(1.0, float(np.max(np.abs(ref))))
        assert float(np.max(np.abs(got - ref))) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_heads_decoder(r10, dtype):
    jp, tp = r10
    cfg = load_config(None)
    cfg["compute_dtype"] = dtype
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = tmodel.compute_dtype(cfg)
    tpd = tmodel.to_device(tp, torch.device("cpu"), tdt)
    rng = np.random.default_rng(0)
    B, K, k = 4, 16, 9
    codes = rng.integers(0, 6, (B, K, k))
    one_hot = (codes[..., None] == np.arange(5)).astype(np.float32).reshape(B, K, k * 5)

    j_enc, j_emb = jmodel.encoder_forward(jp, jnp.asarray(one_hot, jdt), cfg)
    t_enc, t_emb = tmodel.encoder_forward(tpd, torch.from_numpy(one_hot).to(tdt), cfg)
    _compare(j_emb, t_emb, dtype)
    _compare(j_enc, t_enc, dtype)

    emb32 = np.asarray(j_emb).astype(np.float32)
    _compare(jmodel.noise_head(jp, jnp.asarray(emb32), cfg),
             tmodel.noise_head(tpd, torch.from_numpy(emb32), cfg), "float32")
    for a, b in zip(jmodel.duration_gamma_params(jp, jnp.asarray(emb32), cfg),
                    tmodel.duration_gamma_params(tpd, torch.from_numpy(emb32), cfg)):
        _compare(a, b, "float32")

    x = rng.standard_normal((2, 250, 64)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(np.asarray(xj).astype(np.float32)).to(tdt)
    _compare(jmodel.decoder_forward(jp, xj, cfg), tmodel.decoder_forward(tpd, xt, cfg),
             dtype)


def test_to_device_casts_block_matrices_only(r10):
    _, tp = r10
    tpd = tmodel.to_device(tp, torch.device("cpu"), torch.bfloat16)
    blk = tpd["decoder"]["blocks"][0]
    assert blk["attn"]["w_qs"]["kernel"].dtype == torch.bfloat16
    assert blk["ffn"]["w_1"]["kernel"].dtype == torch.bfloat16
    assert blk["attn"]["w_qs"]["bias"].dtype == torch.float32
    assert blk["ffn"]["ln"]["scale"].dtype == torch.float32
    assert tpd["encoder"]["src_emb"]["kernel"].dtype == torch.float32
    assert tpd["noise_sampler"]["fc1"]["kernel"].dtype == torch.float32


def test_pallas_pair_is_not_ported(r10):
    _, tp = r10
    cfg = dict(load_config(None), use_pallas=True, pallas_pair=True)
    tpd = tmodel.to_device(tp, torch.device("cpu"), torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodel.decoder_forward(tpd, torch.zeros(1, 250, 64), cfg)
