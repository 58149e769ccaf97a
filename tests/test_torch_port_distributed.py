"""The port over several processes on the CPU: gloo process groups, two ranks
started as subprocesses from the JAX package's variables
(JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) or torchrun's
(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE), against the port in one process
and the JAX package on its 8-device CPU mesh.

Bars (the JAX package's own, tests/test_parallel.py:116-122 and
tests/test_sharding_invariance.py, with every parameter leaf checked where
it checks one):
  - `predict` over 2 processes: `<out>.shard0` and `<out>.shard1`, whose
    records together are the one-process run's, with global read ids, read
    numbers and samples;
  - one train step at dp = 2 and at tp = 2 (`pallas_train` false, core and
    block; the kernels' plain versions on the CPU), float32, dropout on:
    loss within rtol 1e-5 and every parameter leaf within rtol 1e-4 /
    atol 1e-6 of the port's one-process step, and (at false) of the JAX
    package's step on its (4, 2) mesh;
  - AdaFactor at d_model 128 (w_1 (128, 256) and the attention's 128 x 128
    matrices factored) over tp = 2: three updates from the same numpy-seeded
    gradients (clipped: their global norm is above 1), parameters at the
    step bars against the one-process port and optax, the gathered state
    leaves within rtol 1e-4 of the one-process state. (Through whole train
    steps AdaFactor is no test: the key bias's gradient is zero up to
    rounding, and with eps 1e-30 its first update is the sign of that
    rounding, in any two summation orders.)
  - `train` over 2 processes at --tp 2: rank 0 alone writes (rank 1's model
    path stays empty), the JAX package loads its checkpoint and train state,
    the state resumes at tp = 1 in one process; against the one-process run
    every logged loss within rtol 1e-5, and the model at the step bars on
    >= 99.9 % of its entries, the rest within lr (see the test);
    tensor_parallel = 3 over 2 ranks raises ValueError.
"""

from __future__ import annotations

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import functools
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

from seq2squiggle_tpu_torch import prng
from seq2squiggle_tpu_torch.config import load_config
from seq2squiggle_tpu_torch.io.slow5 import read_slow5
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.models.weights import load_checkpoint, params_to_jax
from seq2squiggle_tpu_torch.runtime import simulate as tsimulate
from seq2squiggle_tpu_torch.train import loop as tloop
from seq2squiggle_tpu_torch.train.optimizers import build_optimizer, leaf_axes

# The ranks import this module for its torch helpers; jax and the JAX package
# are imported by the tests that use them, so that no rank loads them.

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
CPU = torch.device("cpu")
MODES = (False, "core", "block")
ADAFACTOR_STEPS = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args_by_rank, env_by_rank, timeout=240):
    """Run one subprocess a rank; fail the test with their output if any fails."""
    procs = []
    for args, env in zip(args_by_rank, env_by_rank):
        full = dict(PATH=os.environ.get("PATH", "/usr/bin:/bin"), HOME=os.environ.get("HOME", "/"),
                    PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2", **env)
        if "TMPDIR" in os.environ:
            full["TMPDIR"] = os.environ["TMPDIR"]
        procs.append(subprocess.Popen([sys.executable, *args], env=full, cwd=str(ROOT),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("ranks timed out")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _torchrun_env(world):
    port = str(_free_port())
    return [dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world)) for r in range(world)]


def _jax_env(world):
    port = _free_port()
    return [dict(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES=str(world),
                 JAX_PROCESS_ID=str(r)) for r in range(world)]


def step_config(**over):
    cfg = load_config(None)
    cfg.update(dict(compute_dtype="float32", train_batch_size=8, max_epochs=2,
                    max_chunks_valid=100, warmup_ratio=0.1, max_signal_len=50,
                    lr_schedule="constant"))
    cfg.update(over)
    return cfg


def adafactor_config():
    return step_config(optimizer="AdaFactor", dmodel=128, dff=256, pallas_train=False)


def make_batch(cfg, B, seed):
    """A training batch as train/data.py serves it, from a numpy seed; the
    last row padding."""
    rng = np.random.default_rng(seed)
    K, k, T = cfg["max_dna_len"], cfg["seq_kmer"], cfg["max_signal_len"]
    chunks = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (B, K, k))]
    lengths = rng.integers(0, 6, (B, K)).astype(np.int32)
    batch = {"chunks": chunks, "targets": rng.random((B, T, 1)).astype(np.float32),
             "chunks_lengths": lengths, "targets_lengths": lengths.sum(1).astype(np.int32),
             "stdevs": (rng.random((B, K)) * 0.1).astype(np.float32)}
    mask = np.ones(B, np.float32)
    mask[-1] = 0.0
    return batch, mask


@functools.lru_cache(maxsize=None)
def _leaf_shapes(dmodel: int) -> tuple:
    cfg = dict(adafactor_config(), dmodel=dmodel)
    return tuple(("/".join(p), tuple(v.shape))
                 for p, v in tmodel.tree_leaves(tmodel.init_params(cfg, prng.key(0))))


def adafactor_grads(cfg, i):
    """Gradients for update i of every leaf of the AdaFactor config, from a
    numpy seed: {path: array}."""
    rng = np.random.default_rng(100 + i)
    return {path: (rng.standard_normal(shape) * 0.01).astype(np.float32)
            for path, shape in _leaf_shapes(cfg["dmodel"])}


def adafactor_updates(cfg, n_updates, mesh=None):
    """n_updates of the port's AdaFactor from init_params(seed 0) with
    `adafactor_grads`; under a mesh on this rank's shards. Returns (whole
    params, whole state leaves)."""
    from seq2squiggle_tpu_torch.parallel.mesh import gather_params, shard_tensor
    from seq2squiggle_tpu_torch.parallel.mesh import shard_params as tshard

    params = tmodel.to_train_params(tshard(tmodel.init_params(cfg, prng.key(0)), mesh), CPU)
    paths, leaves = zip(*tmodel.tree_leaves(params))
    axes = leaf_axes(params)
    opt = build_optimizer(cfg, 10, params, mesh)
    state = opt.init(leaves)
    for i in range(n_updates):
        full = adafactor_grads(cfg, i)
        grads = [shard_tensor(torch.from_numpy(full["/".join(p)]), a, mesh).contiguous()
                 for p, a in zip(paths, axes)]
        opt.update(grads, state, leaves)
    whole = {"/".join(p): v.numpy() for p, v in tmodel.tree_leaves(gather_params(params, mesh))}
    return whole, opt.state_leaves(state)


def port_steps(cfg, n_steps, mesh=None, rank_rows=slice(None)):
    """n_steps train steps of the port from init_params(seed 0) on batch
    seeds 1, 2, ...; dropout keys 2, 3, ... Returns (losses, whole params,
    whole state leaves). Under a mesh: this rank's slab and shards."""
    from seq2squiggle_tpu_torch.parallel.mesh import gather_params, shard_params as tshard

    params = tmodel.to_train_params(tshard(tmodel.init_params(cfg, prng.key(0)), mesh), CPU)
    opt = build_optimizer(cfg, 10, params, mesh)
    leaves = [v for _, v in tmodel.tree_leaves(params)]
    state = opt.init(leaves)
    step = tloop.make_train_step(cfg, opt, mesh)
    losses = []
    for i in range(n_steps):
        batch, mask = make_batch(cfg, cfg["train_batch_size"], seed=1 + i)
        metrics = step(params, state, {k: torch.from_numpy(v[rank_rows]) for k, v in batch.items()},
                       torch.from_numpy(mask[rank_rows]), prng.key(2 + i))
        losses.append(float(metrics["total_loss"]))
    whole = {"/".join(p): v.numpy() for p, v in tmodel.tree_leaves(gather_params(params, mesh))}
    return losses, whole, opt.state_leaves(state)


_STEP_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    from seq2squiggle_tpu_torch.parallel.distributed import maybe_init_distributed, world
    assert maybe_init_distributed("cpu")
    from test_torch_port_distributed import (ADAFACTOR_STEPS, MODES, adafactor_config,
                                             adafactor_updates, port_steps, step_config)
    from seq2squiggle_tpu_torch.parallel.mesh import make_mesh
    from seq2squiggle_tpu_torch.train.loop import train_run

    out = {}
    for mode in MODES:
        for name, (n_dp, n_tp) in (("dp", (2, 1)), ("tp", (1, 2))):
            mesh = make_mesh(n_dp, n_tp)
            cfg = step_config(pallas_train=mode, tensor_parallel=n_tp)
            losses, whole, _ = port_steps(cfg, 1, mesh, mesh.local_rows(8))
            out[f"{mode}/{name}/loss"] = np.asarray(losses)
            out.update({f"{mode}/{name}/p/{k}": v for k, v in whole.items()})
    mesh = make_mesh(1, 2)
    whole, leaves = adafactor_updates(adafactor_config(), ADAFACTOR_STEPS, mesh)
    out.update({f"adafactor/p/{k}": v for k, v in whole.items()})
    out.update({f"adafactor/opt/{i:04d}": v for i, v in enumerate(leaves)})
    try:
        train_run("unused", None, step_config(tensor_parallel=3), None, device="cpu")
    except ValueError as exc:
        out["tp3_error"] = np.asarray(str(exc))
    if world()[1] == 0:
        np.savez(os.environ["OUT"], **out)
""")


@pytest.fixture(scope="module")
def two_rank_steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("steps") / "ranks.npz"
    env = [dict(e, OUT=str(out)) for e in _torchrun_env(2)]
    _spawn([["-c", _STEP_WORKER]] * 2, env)
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def _assert_step_bars(loss, params, ref_loss, ref_params, what):
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5, err_msg=what)
    assert set(params) == set(ref_params), what
    for path, ref in ref_params.items():
        np.testing.assert_allclose(params[path], ref, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what}: {path}")


def _prefixed(data, prefix):
    return {k[len(prefix):]: v for k, v in data.items() if k.startswith(prefix)}


@functools.lru_cache(maxsize=None)
def one_process_step(mode):
    """The port's step in this process: (losses, whole params, state)."""
    return port_steps(step_config(pallas_train=mode), 1)


@pytest.fixture(scope="module")
def jax_mesh_step():
    """The JAX package's step on its (4, 2) mesh (tests/test_parallel.py:
    80-122), at the step config, from the port's init_params (the JAX
    package's bit for bit): (loss, {path: leaf})."""
    import jax

    from seq2squiggle_tpu.parallel.mesh import batch_sharding, make_mesh, shard_params
    from seq2squiggle_tpu.train import loop as jloop
    from seq2squiggle_tpu.train import optimizers as jopt

    cfg = step_config(pallas_train=False)
    params = params_to_jax(tmodel.init_params(cfg, prng.key(0)))
    opt = jopt.build_optimizer(cfg, 10)
    mesh = make_mesh(n_dp=4, n_tp=2)
    params_sh = shard_params(params, mesh)
    batch, mask = make_batch(cfg, 8, seed=1)
    bsh = batch_sharding(mesh)
    with mesh:
        p, _, m = jloop.make_train_step(cfg, opt)(
            params_sh, opt.init(params_sh), {k: jax.device_put(v, bsh) for k, v in batch.items()},
            jax.device_put(mask, bsh), jax.random.key(2))
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = np.asarray(tree)

    walk(p, "")
    return float(m["total_loss"]), flat


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", ["dp", "tp"])
def test_train_step_over_two_ranks(two_rank_steps, jax_mesh_step, layout, mode):
    data = two_rank_steps
    got_loss = data[f"{mode}/{layout}/loss"]
    got = _prefixed(data, f"{mode}/{layout}/p/")
    ref_loss, ref, _ = one_process_step(mode)
    _assert_step_bars(got_loss, got, ref_loss, ref, f"{layout} at {mode} vs one process")
    if mode is False:
        jloss, jparams = jax_mesh_step
        _assert_step_bars(got_loss, got, [jloss], jparams, f"{layout} vs the JAX (4, 2) mesh")


def test_adafactor_over_tp(two_rank_steps):
    import jax
    import optax

    from seq2squiggle_tpu.train import optimizers as jopt
    from seq2squiggle_tpu_torch.train.optimizers import factored_dims

    data = two_rank_steps
    cfg = adafactor_config()
    assert factored_dims((128, 256)) == (0, 1)  # w_1 is factored at this width
    ref, ref_leaves = adafactor_updates(cfg, ADAFACTOR_STEPS)
    got = _prefixed(data, "adafactor/p/")
    _assert_step_bars(0.0, got, 0.0, ref, "AdaFactor tp = 2 vs one process")
    leaves = [data[f"adafactor/opt/{i:04d}"] for i in range(len(ref_leaves))]
    assert f"adafactor/opt/{len(ref_leaves):04d}" not in data
    for i, (a, b) in enumerate(zip(leaves, ref_leaves)):
        assert np.shape(a) == np.shape(b), i
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=f"state leaf {i}")
    # optax's adafactor, the JAX package's chain, on the same gradients
    jparams = params_to_jax(tmodel.init_params(cfg, prng.key(0)))
    opt = jopt.build_optimizer(cfg, 10)
    jstate = opt.init(jparams)
    update, apply = jax.jit(opt.update), jax.jit(optax.apply_updates)
    for i in range(ADAFACTOR_STEPS):
        grads = adafactor_grads(cfg, i)
        jgrads = jax.tree_util.tree_map_with_path(
            lambda path, _: grads["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                           for k in path)], jparams)
        updates, jstate = update(jgrads, jstate, jparams)
        jparams = apply(jparams, updates)
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jparams)}
    _assert_step_bars(0.0, got, 0.0, flat, "AdaFactor tp = 2 vs optax")


def test_tp_that_does_not_divide_the_world_raises(two_rank_steps):
    assert "tensor_parallel=3 does not divide the device count 2" in str(
        two_rank_steps["tp3_error"])


# ---- predict over two processes, from the JAX package's variables ----

def _write_fasta(path, n_reads, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n_reads):
            n = int(rng.integers(120, 700))
            fh.write(f">read{i}\n{''.join(rng.choice(list('ACGT'), n))}\n")
    return str(path)


def test_two_process_predict_shards_are_the_single_run(tmp_path):
    """tests/test_sharding_invariance.py:8-27, 45-67 over two processes
    started from JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID:
    each rank writes <out>.shard<rank>.blow5; indexed read ids and read
    numbers are global, so the union is the one-process run's."""
    fasta = _write_fasta(tmp_path / "in.fasta", 7, seed=4)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump({"compute_dtype": "float32"}))
    args = ["-m", "seq2squiggle_tpu_torch", "predict", fasta, "--read-input",
            "-o", str(tmp_path / "out.blow5"), "-m", str(ROOT / "assets" / "bench-weights-R10.npz"),
            "-y", str(cfg_path), "-s", "11", "--predict-batch-size", "32", "--device", "cpu",
            "-v", "warning"]
    _spawn([args] * 2, _jax_env(2))
    tsimulate.simulate_run(
        config=dict(load_config(None), compute_dtype="float32"),
        saved_weights=str(ROOT / "assets" / "bench-weights-R10.npz"), fasta=fasta,
        read_input=True, n=-1, r=1000, c=-1, out=str(tmp_path / "all.blow5"),
        profile="dna-r10-prom", dwell_mean=None, dwell_std=0.0, noise_std=2.0,
        noise_sampling=True, duration_sampling=True, distr="expon", predict_batch_size=32,
        export_every_n_samples=1_000_000, seed=11, show_progress=False, device=[CPU])

    def by_id(path):
        return {r["read_id"]: (r["signal"], r["read_number"]) for r in read_slow5(str(path))[1]}

    full = by_id(tmp_path / "all.blow5")
    s0, s1 = by_id(tmp_path / "out.shard0.blow5"), by_id(tmp_path / "out.shard1.blow5")
    assert not (tmp_path / "out.blow5").exists()
    assert len(full) == 7 and len(s0) == 4 and len(s1) == 3 and not set(s0) & set(s1)
    assert set(full) == set(s0) | set(s1)
    for read_id, (signal, number) in {**s0, **s1}.items():
        np.testing.assert_array_equal(signal, full[read_id][0])
        assert number == full[read_id][1]


# ---- train over two processes at --tp 2 ----

def test_train_over_two_processes_at_tp_two(tmp_path):
    from test_torch_port_train import _make_training_dir

    from seq2squiggle_tpu.config import load_config as jload_config
    from seq2squiggle_tpu.models.torch_import import load_native_checkpoint as jax_load_native
    from seq2squiggle_tpu.train import loop as jloop
    from seq2squiggle_tpu.train import optimizers as jopt

    cfg = step_config(max_signal_len=250, lr_schedule="warmup_cosine", max_epochs=1)
    train_dir = _make_training_dir(tmp_path, jload_config(None) | {"max_signal_len": 250},
                                   n_files=2, chunks_per_file=8)
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    common = ["-m", "seq2squiggle_tpu_torch", "train", train_dir, "-y", str(tmp_path / "cfg.yaml"),
              "-s", "1", "--tp", "2", "--device", "cpu", "--save_valid_plots", "false",
              "-v", "warning"]
    _spawn([[*common, "-m", str(tmp_path / f"rank{r}" / "model.npz")] for r in range(2)],
           _torchrun_env(2))
    out = tmp_path / "rank0"
    assert list((tmp_path / "rank1").iterdir()) == []  # rank 1 wrote nothing
    for name in ("model.npz", "model-epoch0.npz", "train_state.npz", "metrics.jsonl"):
        assert (out / name).exists(), name
    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["step"] for r in rows] == sorted({r["step"] for r in rows})  # logged once

    # the one-process run of the same command
    single = tmp_path / "single" / "model.npz"
    tloop.train_run(train_dir, None, dict(cfg), str(single), seed=1, device=CPU)
    got_rows = [json.loads(line) for line in open(tmp_path / "single" / "metrics.jsonl")]
    assert len(got_rows) == len(rows)
    for a, b in zip(rows, got_rows):
        for k, v in a.items():
            if k.endswith("_loss"):
                np.testing.assert_allclose(v, b[k], rtol=1e-5, err_msg=k)
    # Over several Adam steps the step bars hold for all but a few entries:
    # an entry whose gradient is rounding noise (zero in exact arithmetic,
    # e.g. where a decoder input feature is constant over positions, as for
    # the key bias) gets an update of ~lr·sign(noise) in either run. Those
    # stay within one step's reach (lr); test_train_step_over_two_ranks
    # holds one step at the bars on every entry.
    got, ref = load_checkpoint(str(out / "model.npz"))[0], load_checkpoint(str(single))[0]
    outside, total = 0, 0
    for (path, a), (_, b) in zip(tmodel.tree_leaves(got), tmodel.tree_leaves(ref)):
        outside += int(((a - b).abs() > 1e-6 + 1e-4 * b.abs()).sum())
        total += a.numel()
        assert (a - b).abs().max() <= cfg["lr"], "/".join(path)
    assert outside <= 1e-3 * total, f"{outside} of {total} entries outside the step bars"
    # whole leaves in optax's order: the JAX package loads both files
    jparams, _ = jax_load_native(str(out / "model.npz"))
    state = jloop.load_train_state(str(out / "train_state.npz"))
    jloop.restore_opt_state(jopt.build_optimizer(cfg, 3).init(jparams), state["opt_leaves"])
    assert state["epoch"] == 0
    # and the tp = 2 state resumes at tp = 1 in one process
    tloop.train_run(train_dir, None, dict(cfg, max_epochs=2), str(out / "model.npz"), seed=1,
                    resume=True, device=CPU)
    assert tloop.load_train_state(str(out / "train_state.npz"))["epoch"] == 1
    assert (out / "model-epoch1.npz").exists()
