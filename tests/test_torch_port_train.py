"""The port's training path against the JAX package on its CPU backend.

Inputs come from numpy seeds and cross as numpy arrays. Tolerances:
  - total_loss: rtol 1e-5 (masked means in another order); gamma_log_prob
    rtol 2e-3 (XLA's float32 lgamma against torch's, tests/test_train.py:35);
  - schedules over 20 steps and optimizers over 5 steps vs optax: rtol 1e-5
    (the port evaluates schedules in Python floats, optax in float32);
  - loss_fn at max_signal_len 50, float32, dropout key 9, pallas_train False,
    "core", "block" and True: loss rtol 1e-4, every gradient leaf rtol 2e-3 /
    atol 2e-4 (the JAX package's own bar between its rungs,
    tests/test_pallas.py:303-317);
  - three Adam steps at "core" and at "block" from carried-across parameters:
    parameters rtol 1e-4 (atol 1e-6 for entries near zero);
  - checkpoints and train states: exact round trip between the packages.
"""

from __future__ import annotations

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.models import fft_model as jmodel
from seq2squiggle_tpu.models.torch_import import load_native_checkpoint as jax_load_native
from seq2squiggle_tpu.train import loop as jloop
from seq2squiggle_tpu.train import losses as jlosses
from seq2squiggle_tpu.train import optimizers as jopt
from seq2squiggle_tpu_torch import cli, prng
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.models.weights import load_checkpoint, params_from_jax, params_to_jax
from seq2squiggle_tpu_torch.ops import attn_core, block_train
from seq2squiggle_tpu_torch.train import loop as tloop
from seq2squiggle_tpu_torch.train import losses as tlosses
from seq2squiggle_tpu_torch.train import optimizers as topt

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

CPU = torch.device("cpu")


def tiny_config(**over):
    cfg = load_config(None)
    cfg.update(dict(compute_dtype="float32", train_batch_size=8, max_epochs=2,
                    max_chunks_valid=100, warmup_ratio=0.1, max_signal_len=50))
    cfg.update(over)
    return cfg


def make_batch(cfg, B, seed):
    """A training batch as train/data.py serves it, from a numpy seed."""
    rng = np.random.default_rng(seed)
    K, k, T = cfg["max_dna_len"], cfg["seq_kmer"], cfg["max_signal_len"]
    codes = rng.integers(0, 5, (B, K, k))
    chunks = np.eye(5, dtype=np.float32)[codes]  # (B, K, k, 5)
    lengths = rng.integers(0, 6, (B, K)).astype(np.int32)
    lengths[0, :] = 1  # a row shorter than T
    batch = {
        "chunks": chunks,
        "targets": rng.random((B, T, 1)).astype(np.float32),
        "chunks_lengths": lengths,
        "targets_lengths": lengths.sum(1).astype(np.int32),
        "stdevs": (rng.random((B, K)) * 0.1).astype(np.float32),
    }
    mask = np.ones(B, np.float32)
    mask[-1] = 0.0
    return batch, mask


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


def torch_leaves(tree):
    return {"/".join(p): v for p, v in tmodel.tree_leaves(tree)}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def test_gamma_log_prob_matches_jax():
    rng = np.random.default_rng(0)
    conc = (rng.random((4, 16)) * 8 + 0.1).astype(np.float32)
    rate = (rng.random((4, 16)) * 3 + 0.1).astype(np.float32)
    x = rng.integers(1, 30, (4, 16)).astype(np.float32)
    ref = np.asarray(jlosses.gamma_log_prob(jnp.asarray(conc), jnp.asarray(rate),
                                            jnp.asarray(x)))
    got = tlosses.gamma_log_prob(*(torch.from_numpy(a) for a in (conc, rate, x))).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-5)


def test_total_loss_matches_jax():
    rng = np.random.default_rng(1)
    B, T, K = 4, 50, 16
    args = [rng.random((B, T, 1)), rng.random((B, T, 1)), rng.random((B, K)) * 4 + 0.5,
            rng.random((B, K)) + 0.5, rng.integers(0, 20, (B, K)), rng.random((B, K)),
            rng.random((B, K)), np.array([1, 1, 0, 1.0])]
    args = [a.astype(np.int32 if a.dtype.kind == "i" else np.float32) for a in args]
    ref_total, ref = jlosses.total_loss(*(jnp.asarray(a) for a in args))
    got_total, got = tlosses.total_loss(*(torch.from_numpy(a) for a in args))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-5)
    np.testing.assert_allclose(got_total.item(), float(ref_total), rtol=1e-5)


# ---------------------------------------------------------------------------
# schedules and optimizers vs optax
# ---------------------------------------------------------------------------

SCHEDULES = ["warmup_cosine", "warmup_constant", "constant", "warmup_cosine_restarts",
             "one_cycle"]


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_matches_optax(name):
    cfg = dict(load_config(None), lr_schedule=name, lr=3e-4, warmup_ratio=0.2)
    ref, got = jopt.build_schedule(cfg, 20), topt.build_schedule(cfg, 20)
    for step in range(22):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-5, atol=1e-10,
                                   err_msg=f"{name} step {step}")
    if name.startswith("warmup"):
        assert got(0) == 0.0  # optax counts from 0: the first step runs at lr 0


@pytest.mark.parametrize("name,wd", [("Adam", 0.0), ("Adam", 0.01), ("AdamW", 0.01),
                                     ("SGD", 0.01), ("RMSProp", 0.0), ("RAdam", 0.01)])
def test_optimizer_matches_optax(name, wd):
    cfg = dict(load_config(None), optimizer=name, weight_decay=wd, lr=1e-2,
               lr_schedule="warmup_cosine", warmup_ratio=0.2, gradient_clip_val=1.0)
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    # gradient norms on both sides of the clip value
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.05, 3.0, 0.5, 0.01, 1.0)]

    jo = jopt.build_optimizer(cfg, 10)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jo.init(jp)
    to = topt.build_optimizer(cfg, 10)
    tp = [torch.from_numpy(p0[k].copy()) for k in sorted(p0)]
    ts = to.init(tp)
    for g in grads:
        upd, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        to.update([torch.from_numpy(g[k]) for k in sorted(g)], ts, tp)
        for k, t in zip(sorted(p0), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
    # the state lists as optax flattens it, and restores
    ref_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    got_leaves = to.state_leaves(ts)
    assert len(got_leaves) == len(ref_leaves)
    for a, b in zip(got_leaves, ref_leaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
    back = to.restore_state(to.init(tp), ref_leaves)
    for a, b in zip(to.state_leaves(back), ref_leaves):
        np.testing.assert_array_equal(a, b.astype(a.dtype))
    with pytest.raises(ValueError, match="optimizer leaves"):
        to.restore_state(to.init(tp), ref_leaves[:-1] if len(ref_leaves) > 1 else [])


def test_unported_training_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="A11b"):
        topt.build_optimizer(dict(load_config(None), optimizer="AdaFactor"), 10)
    cfg = tiny_config()
    with pytest.raises(NotImplementedError, match="A12"):
        tloop.train_run(str(tmp_path), None, dict(cfg, tensor_parallel=2), None, device=CPU)
    with pytest.raises(NotImplementedError, match="A11b"):
        tloop.train_run(str(tmp_path), None, cfg, None, save_valid_plots=True, device=CPU)
    with pytest.raises(NotImplementedError, match="A11b"):
        tloop.load_train_state(str(tmp_path / "train_state.pkl"))


@pytest.mark.parametrize("mode,dtype,on_cuda,want", [
    ("core", torch.bfloat16, True, "core"), ("core", torch.float32, False, "core"),
    (False, torch.bfloat16, True, "plain"), ("auto", torch.float32, True, "plain"),
    ("auto", torch.bfloat16, False, "plain"), ("auto", torch.bfloat16, True, "block"),
    (True, torch.float32, False, "block"), ("block", torch.bfloat16, False, "block"),
])
def test_train_kernel_mode(mode, dtype, on_cuda, want):
    """`on_cuda=True` stands in for a tensor on a GPU (there is none here)."""
    x = torch.zeros(1, 50, 64, dtype=dtype)
    cfg = dict(load_config(None), pallas_train=mode)
    assert tmodel._train_kernel_mode(cfg, x[:, :16], on_cuda) == "plain"  # short: plain
    assert tmodel._train_kernel_mode(cfg, x, on_cuda) == want
    jwant = {"plain": "xla"}.get(want, want)
    if on_cuda is False and not (mode == "auto" and dtype == torch.bfloat16):
        # where the answer does not hang on the backend, the JAX package gives the same
        assert jmodel._train_kernel_mode(cfg, jnp.zeros((1, 50, 64)), None) == jwant
    with pytest.raises(ValueError, match="Unknown pallas_train"):
        tmodel._train_kernel_mode(dict(cfg, pallas_train="fastest"), x, on_cuda)


@pytest.mark.parametrize("mode,L,whole_block,want", [
    ("block", 40, False, "core"),  # an encoder with L > 32 in block mode: the core rung
    ("block", 40, True, "block"),  # the decoder: the whole-block rung
    ("block", 16, True, "plain"), ("core", 40, True, "core"), (False, 40, True, "plain"),
])
def test_train_blocks_rung_by_stack(monkeypatch, mode, L, whole_block, want):
    """_train_blocks is shared by the encoder and the decoder: only the
    decoder (whole_block=True) takes the block rung, as the JAX package's
    encoder_forward (`use_core = ... in ("core", "block")`)."""
    seen = []

    def plain(block, h, n_head, dropout_rate, dropout_key, packed_core):
        seen.append("core" if packed_core else "plain")
        return h

    def whole(h, block, s_a, s_f, n_head):
        seen.append("block")
        assert s_a is None and s_f is None  # no dropout key: no scales
        return h

    monkeypatch.setattr(tmodel, "fft_block", plain)
    monkeypatch.setattr(tmodel, "fused_block_train", whole)
    cfg = dict(load_config(None), pallas_train=mode)
    tmodel._train_blocks([{}, {}], torch.zeros(1, L, 64), 8, cfg, 0.0, None,
                         whole_block=whole_block)
    assert seen == [want, want]


# ---------------------------------------------------------------------------
# loss_fn and train steps vs JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [False, "core", "block", True])
def test_loss_fn_value_and_grads_match_jax(mode):
    cfg = tiny_config(pallas_train=mode)
    jparams = jmodel.init_params(cfg, jax.random.key(0))
    batch, mask = make_batch(cfg, 3, seed=5)

    def jloss(p):
        return jloop.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jnp.asarray(mask), cfg, jax.random.key(9))

    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    tparams = tmodel.to_train_params(params_from_jax(jparams), CPU)
    before = (attn_core.launches_fwd, attn_core.launches_bwd,
              block_train.launches_fwd, block_train.launches_bwd)
    loss, metrics = tloop.loss_fn(tparams, to_torch(batch), torch.from_numpy(mask), cfg,
                                  prng.key(9))
    paths, leaves = zip(*tmodel.tree_leaves(tparams))
    grads = torch.autograd.grad(loss, leaves)
    assert (attn_core.launches_fwd, attn_core.launches_bwd,
            block_train.launches_fwd, block_train.launches_bwd) == before  # CPU: no launch

    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    for k in ref_metrics:
        np.testing.assert_allclose(metrics[k].item(), float(ref_metrics[k]), rtol=1e-4)
    ref = jax_leaves(ref_grads)
    assert set(ref) == {"/".join(p) for p in paths}
    for p, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), ref["/".join(p)], rtol=2e-3, atol=2e-4,
                                   err_msg="/".join(p))


@pytest.mark.parametrize("mode", ["core", "block"])
def test_three_adam_steps_match_jax(mode):
    cfg = tiny_config(pallas_train=mode, lr=1e-3)
    jparams = jmodel.init_params(cfg, jax.random.key(2))
    tparams = tmodel.to_train_params(params_from_jax(jparams), CPU)

    jo = jopt.build_optimizer(cfg, 10)
    jstate = jo.init(jparams)
    jstep = jloop.make_train_step(cfg, jo)
    to = topt.build_optimizer(cfg, 10)
    tstate = to.init([v for _, v in tmodel.tree_leaves(tparams)])
    tstep = tloop.make_train_step(cfg, to)

    for i in range(3):
        batch, mask = make_batch(cfg, 4, seed=20 + i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in batch.items()},
                                    jnp.asarray(mask), jax.random.fold_in(jax.random.key(1), i))
        tm = tstep(tparams, tstate, to_torch(batch), torch.from_numpy(mask),
                   prng.fold_in(prng.key(1), i))
        assert set(tm) == set(jm)  # the same metric names, per-parameter norms included
        np.testing.assert_allclose(tm["total_loss"].item(), float(jm["total_loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-3)
    ref = jax_leaves(jparams)
    for path, v in torch_leaves(tparams).items():
        np.testing.assert_allclose(v.detach().numpy(), ref[path], rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_trains_pos_enc_as_the_jax_package_does():
    """The JAX package differentiates its whole tree, positional tables
    included, while count_params leaves them out; so does the port."""
    cfg = tiny_config()
    tparams = tmodel.to_train_params(tmodel.init_params(cfg, prng.key(0)), CPU)
    assert all(v.requires_grad and v.is_leaf for _, v in tmodel.tree_leaves(tparams))
    jparams = jmodel.init_params(cfg, jax.random.key(0))
    assert tmodel.count_params(tparams) == jmodel.count_params(jparams)
    assert len(tmodel.tree_leaves(tparams)) == len(jax.tree_util.tree_leaves(jparams))


# ---------------------------------------------------------------------------
# train_run end to end, checkpoints crossing between the packages
# ---------------------------------------------------------------------------


def _make_training_dir(tmp_path, cfg, n_files=3, chunks_per_file=24):
    from test_preprocess import make_events

    from seq2squiggle_tpu.train.preprocess import build_chunkset, save_chunkset

    outdir = tmp_path / "train_npy"
    for i in range(n_files):
        df = make_events(chunks_per_file * 16, seed=i, read_name=f"r{i}")
        save_chunkset(build_chunkset(df, cfg, rna=False, partition_by=False), str(outdir), i)
    return str(outdir)


def test_train_run_end_to_end_and_checkpoints_cross(tmp_path):
    cfg = tiny_config(max_signal_len=250, pallas_train="core")
    train_dir = _make_training_dir(tmp_path, cfg)
    model_path = tmp_path / "ckpt" / "model.npz"
    metrics = tloop.train_run(train_dir=train_dir, valid_dir=None, config=cfg,
                              model_path=str(model_path), seed=1, max_steps_per_epoch=3,
                              device=CPU)
    assert "valid_total_loss" in metrics and np.isfinite(metrics["valid_total_loss"])
    for name in ("model.npz", "model-epoch0.npz", "model-epoch1.npz", "metrics.jsonl",
                 "train_state.npz"):
        assert (tmp_path / "ckpt" / name).exists(), name
    rows = [json.loads(line) for line in open(tmp_path / "ckpt" / "metrics.jsonl")]
    assert any("train_total_loss" in r for r in rows)
    assert any("train_grad_norm/decoder/blocks/0/attn/w_qs/kernel" in r for r in rows)

    # the checkpoint loads in the JAX package and in the port, to the same tree
    jparams, jcfg = jax_load_native(str(model_path))
    assert jcfg["seq_kmer"] == cfg["seq_kmer"]
    tparams, _ = load_checkpoint(str(model_path))
    ref = jax_leaves(jparams)
    for path, v in torch_leaves(tparams).items():
        np.testing.assert_array_equal(v.numpy(), ref[path])

    # the Adam train state is accepted by the JAX package's restore_opt_state
    state = jloop.load_train_state(str(tmp_path / "ckpt" / "train_state.npz"))
    assert state["epoch"] == cfg["max_epochs"] - 1
    jo = jopt.build_optimizer(cfg, 6)
    restored = jloop.restore_opt_state(jo.init(jparams), state["opt_leaves"])
    counts = [int(x) for x in jax.tree_util.tree_leaves(restored) if np.ndim(x) == 0]
    assert counts == [6, 6]  # Adam's step count and the schedule's
    # ... and a JAX-written state by the port's
    jloop._save_train_state(str(tmp_path / "jax_state.npz"), jparams, restored, 1)
    back = tloop.load_train_state(str(tmp_path / "jax_state.npz"))
    to = topt.build_optimizer(cfg, 6)
    fresh = to.init([v for _, v in tmodel.tree_leaves(params_from_jax(back["params"]))])
    tstate = to.restore_state(fresh, back["opt_leaves"])
    assert tstate["count"] == 6 and tstate["sched_count"] == 6


def test_train_resume_continues_through_cli(tmp_path):
    cfg = tiny_config(max_signal_len=250, pallas_train=False)
    train_dir = _make_training_dir(tmp_path, cfg, n_files=2, chunks_per_file=12)
    valid_dir = _make_training_dir(tmp_path / "v", cfg, n_files=1, chunks_per_file=8)
    model_path = tmp_path / "ckpt" / "model.npz"

    def run(max_epochs, *extra):
        import yaml

        y = tmp_path / f"cfg{max_epochs}.yaml"
        y.write_text(yaml.safe_dump(dict(cfg, max_epochs=max_epochs)))
        res = CliRunner().invoke(cli.main, ["train", train_dir, valid_dir, "-y", str(y),
                                            "-m", str(model_path), "-s", "1",
                                            "--device", "cpu", *extra])
        assert res.exit_code == 0, (res.output, res.exception)

    run(1)
    assert tloop.load_train_state(str(tmp_path / "ckpt" / "train_state.npz"))["epoch"] == 0
    assert not (tmp_path / "ckpt" / "model-epoch1.npz").exists()
    run(3, "--resume")
    assert tloop.load_train_state(str(tmp_path / "ckpt" / "train_state.npz"))["epoch"] == 2
    assert (tmp_path / "ckpt" / "model-epoch1.npz").exists()
    assert (tmp_path / "ckpt" / "model-epoch2.npz").exists()
    steps = [json.loads(line).get("step") for line in open(tmp_path / "ckpt" / "metrics.jsonl")]
    assert steps == sorted(steps)


def test_train_cli_at_block_writes_a_checkpoint_the_jax_package_loads(tmp_path):
    """`train` at `pallas_train: block` on the CPU (the plain versions of the
    whole-block kernels, forward and hand-written backward)."""
    import yaml

    cfg = tiny_config(max_signal_len=250, pallas_train="block", max_epochs=1)
    train_dir = _make_training_dir(tmp_path, cfg, n_files=2, chunks_per_file=12)
    model_path = tmp_path / "ckpt" / "model.npz"
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    seen = []
    real = block_train.fused_block_train_backward_reference

    def counted(*args):
        seen.append(tuple(args[0].shape))
        return real(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(block_train, "fused_block_train_backward_reference", counted)
        res = CliRunner().invoke(cli.main, ["train", train_dir, "-y", str(tmp_path / "cfg.yaml"),
                                            "-m", str(model_path), "-s", "1", "--device", "cpu"])
    assert res.exit_code == 0, (res.output, res.exception)
    assert seen and all(shape[1:] == (250, 64) for shape in seen)  # the decoder's blocks
    assert len(seen) % 2 == 0  # two blocks per train step
    rows = [json.loads(line) for line in open(tmp_path / "ckpt" / "metrics.jsonl")]
    losses = [v for r in rows for k, v in r.items() if k.endswith("total_loss")]
    assert losses and all(np.isfinite(v) for v in losses)
    jparams, jcfg = jax_load_native(str(model_path))
    assert jcfg["pallas_train"] == "block"
    tparams, _ = load_checkpoint(str(model_path))
    ref = jax_leaves(jparams)
    for path, v in torch_leaves(tparams).items():
        np.testing.assert_array_equal(v.numpy(), ref[path])
    # and it differs from the initial parameters: the steps moved the decoder
    init = torch_leaves(tmodel.init_params(cfg, prng.key(1)))
    assert any(not torch.equal(v, init[path]) for path, v in torch_leaves(tparams).items()
               if path.startswith("decoder/blocks"))


def test_train_cli_defaults_to_cuda(tmp_path):
    """Without a GPU the default device raises; only --device cpu trains here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = CliRunner().invoke(cli.main, ["train", str(tmp_path), "-m",
                                        str(tmp_path / "m.npz")])
    assert res.exit_code != 0
    assert isinstance(res.exception, RuntimeError) and "cuda" in str(res.exception)


def test_params_to_jax_inverts_params_from_jax():
    cfg = tiny_config()
    jparams = jmodel.init_params(cfg, jax.random.key(4))
    back = params_to_jax(params_from_jax(jparams))
    ref = jax_leaves(jparams)
    got = jax_leaves(back)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k])
