"""The rest of training in the port against the JAX package on its CPU
backend: AdaFactor's train states crossing between the packages, the legacy
`train_state.pkl` resume (read without jax or optax), and the validation
plots.

Bars:
  - AdaFactor's state lists as optax flattens it: 254 leaves at the default
    config, every shape equal (the update rule itself is held against optax
    in tests/test_torch_port_train.py::test_optimizer_matches_optax);
  - train states and legacy pickles: exact (bit-equal leaves, same epoch);
  - plots: the sampled durations equal; every drawn array within rtol 2e-3 /
    atol 2e-4 x scaling_max_value (the f32 block bar, in pA); the same files.

The model here is tiny (one encoder and one decoder block, f32, batch 8):
each train_run of the JAX package compiles its steps anew, ~15 s on a CPU.
"""

from __future__ import annotations

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import collections
import json
import logging
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from click.testing import CliRunner

from seq2squiggle_tpu.config import load_config
from seq2squiggle_tpu.models import fft_model as jmodel
from seq2squiggle_tpu.sampling import per_chunk_keys as jper_chunk_keys
from seq2squiggle_tpu.sampling import sample_gamma_durations as jsample_gamma_durations
from seq2squiggle_tpu.train import loop as jloop
from seq2squiggle_tpu.train import optimizers as jopt
from seq2squiggle_tpu.train import plots as jplots
from seq2squiggle_tpu_torch import cli, prng
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.models.weights import params_from_jax
from seq2squiggle_tpu_torch.train import loop as tloop
from seq2squiggle_tpu_torch.train import optimizers as topt
from seq2squiggle_tpu_torch.train import plots as tplots
from seq2squiggle_tpu_torch.train.preprocess import build_chunkset, save_chunkset

CPU = torch.device("cpu")
SCALE = 165.0  # scaling_max_value


def tiny_config(**over):
    cfg = load_config(None)
    cfg.update(dict(compute_dtype="float32", train_batch_size=8, max_epochs=1,
                    max_chunks_valid=100, warmup_ratio=0.1, encoder_layers=1,
                    decoder_layers=1, optimizer="AdaFactor"))
    cfg.update(over)
    return cfg


def _chunk_dir(path, n_files, chunks_per_file, seed):
    from test_preprocess import make_events

    cfg = load_config(None)
    for i in range(n_files):
        df = make_events(chunks_per_file * 16, seed=seed + i, read_name=f"r{seed + i}")
        save_chunkset(build_chunkset(df, cfg, rna=False, partition_by=False), str(path), i)
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two train files of 12 chunks and a validation file of 2 chunks."""
    root = tmp_path_factory.mktemp("train_rest")
    return {"root": root, "train": _chunk_dir(root / "train", 2, 12, 0),
            "valid": _chunk_dir(root / "valid", 1, 2, 9)}


@pytest.fixture(scope="module")
def jax_run(data):
    """One epoch of 2 AdaFactor steps by the JAX package; its train_state.npz."""
    ckpt = data["root"] / "jax_ckpt"
    jloop.train_run(data["train"], data["valid"], tiny_config(), str(ckpt / "model.npz"),
                    False, seed=1, max_steps_per_epoch=2)
    return ckpt


def _leaf_shapes(leaves):
    return [tuple(np.shape(x)) for x in leaves]


# ---------------------------------------------------------------------------
# AdaFactor's state and train states across the packages
# ---------------------------------------------------------------------------


def test_adafactor_state_lists_as_optax_does_at_the_default_config():
    cfg = dict(load_config(None), optimizer="AdaFactor")
    jparams = jmodel.init_params(cfg, jax.random.key(0))
    ref = jax.tree_util.tree_leaves(jopt.build_optimizer(cfg, 10).init(jparams))
    leaves = [v for _, v in tmodel.tree_leaves(params_from_jax(jparams))]
    assert len(leaves) == 84
    assert not any(topt.factored_dims(v.shape) for v in leaves)  # none is factored here
    got = topt.build_optimizer(cfg, 10).state_leaves(topt.build_optimizer(cfg, 10).init(leaves))
    assert len(got) == len(ref) == 254
    assert _leaf_shapes(got) == _leaf_shapes(ref)


def test_jax_written_adafactor_state_resumes_in_the_port(data, jax_run, tmp_path):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(jax_run, ckpt)
    saved = jloop.load_train_state(str(ckpt / "train_state.npz"))
    cfg = tiny_config(max_epochs=2)
    # the port grafts the JAX package's leaves bit for bit
    opt = topt.build_optimizer(cfg, 4)
    leaves = [v for _, v in tmodel.tree_leaves(params_from_jax(saved["params"]))]
    state = opt.restore_state(opt.init(leaves), saved["opt_leaves"])
    for a, b in zip(opt.state_leaves(state), saved["opt_leaves"]):
        np.testing.assert_array_equal(a, b)
    assert state["count"] == 2 and state["sched_count"] == 2

    metrics = tloop.train_run(data["train"], data["valid"], cfg, str(ckpt / "model.npz"),
                              seed=1, max_steps_per_epoch=2, resume=True, device=CPU)
    assert np.isfinite(metrics["valid_total_loss"])
    after = tloop.load_train_state(str(ckpt / "train_state.npz"))
    assert after["epoch"] == 1
    assert [int(x) for x in after["opt_leaves"] if np.ndim(x) == 0] == [4, 4]


def test_port_written_adafactor_state_resumes_in_the_jax_package(data, jax_run, tmp_path):
    ckpt = tmp_path / "ckpt"
    metrics = tloop.train_run(data["train"], data["valid"], tiny_config(),
                              str(ckpt / "model.npz"), seed=1, max_steps_per_epoch=2,
                              device=CPU)
    # the same epoch as the JAX package's run: the same validation loss
    jmetrics = json.loads((jax_run / "metrics.jsonl").read_text().splitlines()[-1])
    np.testing.assert_allclose(metrics["valid_total_loss"], jmetrics["valid_total_loss"],
                               rtol=1e-3)
    ours = tloop.load_train_state(str(ckpt / "train_state.npz"))
    theirs = jloop.load_train_state(str(jax_run / "train_state.npz"))
    assert len(ours["opt_leaves"]) == len(theirs["opt_leaves"])
    assert _leaf_shapes(ours["opt_leaves"]) == _leaf_shapes(theirs["opt_leaves"])

    jmetrics = jloop.train_run(data["train"], data["valid"], tiny_config(max_epochs=2),
                               str(ckpt / "model.npz"), False, seed=1,
                               max_steps_per_epoch=2, resume=True)
    assert np.isfinite(jmetrics["valid_total_loss"])
    after = jloop.load_train_state(str(ckpt / "train_state.npz"))
    assert after["epoch"] == 1
    assert [int(x) for x in after["opt_leaves"] if np.ndim(x) == 0] == [4, 4]


# ---------------------------------------------------------------------------
# the legacy train_state.pkl
# ---------------------------------------------------------------------------


def test_legacy_pickle_resumes_in_the_port(data, jax_run, tmp_path):
    """The JAX package's recipe (tests/test_train.py:290-329), with the
    leaves as jax arrays, as a run before format 1 pickled them."""
    saved = jloop.load_train_state(str(jax_run / "train_state.npz"))
    cfg = tiny_config()
    jparams = jax.tree_util.tree_map(jnp.asarray, saved["params"])
    jstate = jloop.restore_opt_state(jopt.build_optimizer(cfg, 2).init(jparams),
                                     saved["opt_leaves"])
    legacy = {"params": jparams, "opt_state": jax.tree_util.tree_map(jnp.asarray, jstate),
              "epoch": saved["epoch"]}
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    with open(ckpt / "train_state.pkl", "wb") as fh:
        pickle.dump(legacy, fh)
    raw = (ckpt / "train_state.pkl").read_bytes()
    for name in (b"jax._src.array", b"_reconstruct_array", b"optax._src.factorized",
                 b"FactoredState", b"ScaleByScheduleState"):
        assert name in raw  # the globals the port's reader stands in for

    got = tloop.load_train_state(str(ckpt / "train_state.pkl"))
    assert got["epoch"] == saved["epoch"] == 0
    want = jax.tree_util.tree_leaves(saved["params"])
    params = jax.tree_util.tree_leaves(got["params"])
    assert len(params) == len(want)
    for a, b in zip(params, want):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got["opt_leaves"]) == len(saved["opt_leaves"])
    for a, b in zip(got["opt_leaves"], saved["opt_leaves"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    # train_run takes the .pkl where no .npz is, and goes on from epoch 1
    metrics = tloop.train_run(data["train"], data["valid"], tiny_config(max_epochs=2),
                              str(ckpt / "model.npz"), seed=1, max_steps_per_epoch=2,
                              resume=True, device=CPU)
    assert np.isfinite(metrics["valid_total_loss"])
    after = tloop.load_train_state(str(ckpt / "train_state.npz"))
    assert after["epoch"] == 1
    assert [int(x) for x in after["opt_leaves"] if np.ndim(x) == 0] == [4, 4]


@pytest.mark.parametrize("name", ["Adam", "AdamW", "RAdam", "AdaFactor", "SGD", "RMSProp"])
def test_legacy_pickle_flattens_as_jax_does(name, tmp_path):
    """Every optimizer's optax state (weight decay and clipping on, so every
    link of each chain is there) comes back as jax.tree_util lists it."""
    cfg = dict(load_config(None), optimizer=name, weight_decay=0.01, gradient_clip_val=1.0)
    rng = np.random.default_rng(4)
    shapes = {"a": (4, 3), "b": (5,), "f": (130, 136)}
    jparams = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
               for k, s in shapes.items()}
    jo = jopt.build_optimizer(cfg, 10)
    jstate = jo.init(jparams)
    for _ in range(2):  # moments that are not zeros
        grads = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
                 for k, s in shapes.items()}
        upd, jstate = jo.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    path = tmp_path / "train_state.pkl"
    with open(path, "wb") as fh:
        pickle.dump({"params": jparams, "opt_state": jstate, "epoch": 3}, fh)

    got = tloop.load_train_state(str(path))
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    assert len(got["opt_leaves"]) == len(ref)
    for a, b in zip(got["opt_leaves"], ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    opt = topt.build_optimizer(cfg, 10)
    leaves = [torch.from_numpy(np.asarray(jparams[k])) for k in sorted(jparams)]
    state = opt.restore_state(opt.init(leaves), got["opt_leaves"])
    assert state["sched_count"] == 2


class _Smuggled:
    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize("payload,named", [
    (collections.OrderedDict(a=1), "collections.OrderedDict"),
    (_Smuggled(), "getcwd"),
])
def test_legacy_pickle_refuses_other_globals(payload, named, tmp_path):
    path = tmp_path / "train_state.pkl"
    with open(path, "wb") as fh:
        pickle.dump({"params": {}, "opt_state": payload, "epoch": 0}, fh)
    with pytest.raises(pickle.UnpicklingError, match=named):
        tloop.load_train_state(str(path))


# ---------------------------------------------------------------------------
# validation plots
# ---------------------------------------------------------------------------


def _plot_batch(cfg, B=2, seed=6):
    """A validation batch whose rows fit max_signal_len (the plots cut the
    reference at the sum of the row's dwells)."""
    rng = np.random.default_rng(seed)
    K, k, T = cfg["max_dna_len"], cfg["seq_kmer"], cfg["max_signal_len"]
    lengths = rng.integers(1, 16, (B, K)).astype(np.int32)
    assert lengths.sum(1).max() <= T
    return {"chunks": np.eye(5, dtype=np.float32)[rng.integers(0, 5, (B, K, k))],
            "targets": (rng.random((B, T, 1)) * 0.6).astype(np.float32),
            "chunks_lengths": lengths,
            "stdevs": (rng.random((B, K)) * 0.05).astype(np.float32)}


def _record_plots(monkeypatch):
    import matplotlib.axes

    drawn = []
    real = matplotlib.axes.Axes.plot

    def plot(self, *args, **kwargs):
        drawn.append(np.asarray(args[1], np.float64))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(matplotlib.axes.Axes, "plot", plot)
    return drawn


def test_plots_draw_the_jax_packages_arrays(monkeypatch, tmp_path):
    cfg = tiny_config(encoder_layers=2, decoder_layers=2)
    jparams = jmodel.init_params(cfg, jax.random.key(3))
    batch = _plot_batch(cfg)
    drawn = _record_plots(monkeypatch)
    jkey = jax.random.fold_in(jax.random.key(5), 10_000)
    jplots.generate_validation_plots(jparams, cfg, batch, 0, str(tmp_path / "jax"), jkey)
    ref = list(drawn)
    drawn.clear()
    tparams = tmodel.to_train_params(params_from_jax(jparams), CPU)
    tkey = prng.fold_in(prng.key(5), 10_000)
    tplots.generate_validation_plots(tparams, cfg, batch, 0, str(tmp_path / "port"), tkey)

    assert os.listdir(tmp_path / "port") == ["epoch_0"]
    assert (sorted(os.listdir(tmp_path / "port" / "epoch_0"))
            == sorted(os.listdir(tmp_path / "jax" / "epoch_0"))
            == sorted(f"batch_{b}_{kind}.png" for b in range(2)
                      for kind in ("reference", "all_signals")))
    assert len(drawn) == len(ref) == 2 * (2 + 4)
    for i, (got, want) in enumerate(zip(drawn, ref)):
        assert got.shape == want.shape, i
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4 * SCALE, err_msg=str(i))

    # the durations both packages sample from the same key
    arrays = tplots.validation_arrays(tparams, cfg, batch, tkey)
    enc, emb = jmodel.encoder_forward(jparams, jnp.asarray(batch["chunks"].reshape(2, 16, -1)),
                                      cfg)
    conc, rate = jmodel.duration_gamma_params(jparams, emb, cfg)
    jdur = jnp.round(jnp.maximum(jsample_gamma_durations(
        jper_chunk_keys(jkey, jnp.arange(2, dtype=jnp.int32)), conc, rate), 1.0))
    np.testing.assert_array_equal(arrays["sampled_dur"], np.asarray(jdur, np.int32))
    assert arrays["sampled_dur"].min() >= 1


def _write_cfg(tmp_path, **over):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(tiny_config(**over)))
    return str(path)


def test_train_command_writes_the_plots_by_default(data, tmp_path, caplog):
    """C12: `train` with a validation set and no --save_valid_plots flag
    writes the plots, as the JAX package's command does (batch 2: the plots
    take the first validation batch, padding rows included)."""
    caplog.set_level(logging.WARNING, logger="seq2squiggle_tpu_torch")
    model = tmp_path / "ckpt" / "model.npz"
    cfg = _write_cfg(tmp_path, optimizer="Adam", train_batch_size=2)
    res = CliRunner().invoke(cli.main, ["train", data["train"], data["valid"], "-y", cfg, "-m",
                                        str(model), "-s", "1", "--device", "cpu"])
    assert res.exit_code == 0, (res.output, res.exception)
    assert not [r for r in caplog.records if "Validation plots failed" in r.getMessage()]
    assert sorted(os.listdir(model.parent / "epoch_0")) == sorted(
        f"batch_{b}_{kind}.png" for b in range(2) for kind in ("reference", "all_signals"))


def test_a_failed_plot_never_stops_training(data, tmp_path, monkeypatch, caplog):
    def broken(*args, **kwargs):
        raise RuntimeError("no canvas")

    monkeypatch.setattr(tplots, "generate_validation_plots", broken)
    caplog.set_level(logging.WARNING, logger="seq2squiggle_tpu_torch")
    metrics = tloop.train_run(data["train"], data["valid"], tiny_config(max_epochs=2),
                              str(tmp_path / "ckpt" / "model.npz"), save_valid_plots=True,
                              seed=1, max_steps_per_epoch=1, device=CPU)
    assert np.isfinite(metrics["valid_total_loss"])
    failed = [r for r in caplog.records if "Validation plots failed: no canvas" in r.getMessage()]
    assert len(failed) == 2  # one per epoch
    assert tloop.load_train_state(str(tmp_path / "ckpt" / "train_state.npz"))["epoch"] == 1
