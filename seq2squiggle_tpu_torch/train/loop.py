"""Training loop on one GPU: the port of seq2squiggle_tpu/train/loop.py.

The same forward wiring as the JAX package (noise and duration heads on the
detached pre-PE embedding, ground-truth durations through the one-hot length
regulator), the same three-term loss, optimizer and schedule menu, dropout
keys (`fold_in(base_key, step)` per step, split four ways), per-epoch
weights-only checkpoints, a full train state (parameters + optimizer state)
for `--resume`, first-batch validation plots and metrics every 100 steps.
Checkpoints and train states are the JAX package's files: either package
loads the other's, and the port also resumes from the JAX package's legacy
`train_state.pkl` (read without jax or optax, see `_LegacyUnpickler`).

The step is eager PyTorch: loss, `.backward()`, the optimizer's update in
place. The decoder's two blocks take the rung `pallas_train` names
(models/fft_model.py::_train_kernel_mode): `block` (also `true`, and `auto`
in bfloat16 on a GPU, the default) runs each whole block through the
hand-written forward and backward kernels of ops/block_train.py; `core` runs
only the attention core through those of ops/attn_core.py; `false` (and
`auto` in float32 or on the CPU) is plain PyTorch.

Several processes (parallel/distributed.py starts them; one rank a process,
each on its own device) train as the JAX package trains on several devices:
the ranks lay out as a ('dp', 'tp') mesh (parallel/mesh.py), tp = the
config's `tensor_parallel` (`train --tp`), which must divide the world, and
dp = world / tp where the batch divides by it (else a warning, and each rank
runs unsharded). Every rank iterates the same permutation and reads its dp
slab of each batch (`epoch_batches(local_rows=...)`); the loss divides by
the global batch's valid rows, so the gradients summed over dp are the
global batch's; tp shards the weights (models/fft_model.py). Rank 0 alone
logs metrics, draws plots and writes checkpoints, from parameters and
optimizer state gathered on every rank first (a gather on rank 0 alone would
deadlock); `train_state.npz` holds the whole leaves in optax's order, so the
JAX package loads it and `--resume` at another tp re-shards it. There is no
probe ladder: a kernel that fails to build or launch raises, and no rung
steps down to another. A validation plot
that fails logs a warning and training goes on, as in the JAX package; the
plots run in float32 on the plain blocks, so no kernel runs inside them.
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import prng, tracing
from ..device import resolve_device
from ..models.fft_model import (
    compute_dtype,
    count_params,
    decoder_forward,
    duration_gamma_params,
    encoder_forward,
    init_params,
    noise_head,
    to_train_params,
    tree_leaves,
)
from ..models.weights import (
    _flatten,
    _unflatten,
    params_from_jax,
    params_to_jax,
    save_native_checkpoint,
)
from ..ops.regulator import length_regulate
from ..parallel.distributed import world as world_and_rank
from ..parallel.mesh import (
    dp_sum,
    dp_sum_all,
    gather_params,
    make_mesh,
    shard_params,
)
from .data import ChunkDataset, epoch_batches, load_file_groups
from .losses import total_loss
from .metrics import MetricsLogger
from .optimizers import Optimizer, build_optimizer, leaf_square_sums

logger = logging.getLogger("seq2squiggle_tpu_torch")


def model_forward_train(params: dict, batch: Dict[str, torch.Tensor], config: dict,
                        dropout_key: Optional[torch.Tensor], mesh=None):
    """Shared train/valid forward. Returns (prediction, conc, rate, noise_pred).
    Under a mesh the batch is the rank's slab and params its shards."""
    B, K = batch["chunks"].shape[:2]
    data = batch["chunks"].reshape(B, K, -1).to(compute_dtype(config))

    keys = prng.split(dropout_key, 4) if dropout_key is not None else [None] * 4
    enc_out, emb_out = encoder_forward(params, data, config, dropout_key=keys[0], train=True,
                                       mesh=mesh)

    emb_detached = emb_out.detach().float()
    noise_pred = noise_head(params, emb_detached, config, dropout_key=keys[1], mesh=mesh)
    conc, rate = duration_gamma_params(params, emb_detached, config, dropout_key=keys[2],
                                       mesh=mesh)

    expanded, _, _ = length_regulate(enc_out, batch["chunks_lengths"],
                                     config["max_signal_len"])
    prediction = decoder_forward(params, expanded, config, dropout_key=keys[3], train=True,
                                 mesh=mesh)
    return prediction.float(), conc, rate, noise_pred


def loss_fn(params, batch, mask, config, dropout_key, mesh=None):
    """The loss and its terms. Under dp each rank's terms are its slab's
    share of the global batch's means (they sum over dp to the global loss)."""
    n_valid = None
    if mesh is not None and mesh.dp_group is not None:
        n_valid = dp_sum(mask.sum().clone(), mesh)
    prediction, conc, rate, noise_pred = model_forward_train(params, batch, config,
                                                             dropout_key, mesh)
    return total_loss(prediction, batch["targets"], conc, rate, batch["chunks_lengths"],
                      noise_pred, batch["stdevs"], mask, n_valid)


def _dp_metrics(metrics: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The loss terms summed over dp: the global batch's."""
    names = list(metrics)
    summed = dp_sum_all([metrics[k].detach() for k in names], mesh)
    return dict(zip(names, summed))


def make_train_step(config: dict, optimizer: Optimizer, mesh=None):
    """(params, opt_state, batch, mask, key) -> metrics; parameters and the
    optimizer state are updated in place. Under a mesh: the rank's slab and
    shards, the gradients summed over dp, the metrics the global batch's.
    Each call is a `train.step` span (tracing.py, switched on or off here),
    its id the call's number, with a `train.masks` span in it for each
    dropout draw."""
    tracing.switch_from_env()
    calls = itertools.count()

    def step(params, opt_state, batch, mask, key):
        with tracing.span("train.step", next(calls)):
            paths, leaves = zip(*tree_leaves(params))
            _, metrics = loss_fn(params, batch, mask, config, key, mesh)
            grads = dp_sum_all(torch.autograd.grad(metrics["total_loss"], leaves), mesh)
            metrics = _dp_metrics(metrics, mesh)
            # the global norm and each leaf's (grad_norm/<a/b/0/c>, the JAX
            # package's names), whole leaves under tp
            squares = leaf_square_sums(grads, optimizer.axes, mesh)
            metrics["grad_norm"] = torch.sqrt(sum(squares.unbind()))
            metrics.update({f"grad_norm/{'/'.join(p)}": n
                            for p, n in zip(paths, squares.sqrt().unbind())})
            optimizer.update(grads, opt_state, leaves)
            return metrics

    return step


def make_valid_step(config: dict, mesh=None):
    def step(params, batch, mask):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch, mask, config, None, mesh)
        return _dp_metrics(metrics, mesh)

    return step


def _save_train_state(path: str, host_params, opt_leaves: List[np.ndarray], epoch: int):
    """Write train_state.npz in the JAX package's format 1: params (a tree of
    numpy leaves, models.weights.params_to_jax) under
    params/<path>, optimizer-state leaves as opt/<i> in tree-flatten order,
    plus a JSON meta record. allow_pickle=False end to end."""
    flat = {f"params/{k}": v for k, v in _flatten(host_params).items()}
    for i, leaf in enumerate(opt_leaves):
        flat[f"opt/{i:04d}"] = np.asarray(leaf)
    flat["__meta__"] = np.frombuffer(
        json.dumps({"epoch": int(epoch), "n_opt_leaves": len(opt_leaves),
                    "format": 1}).encode("utf-8"), np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)  # atomic: a crash mid-save keeps the old state


# The globals a train_state.pkl written by the JAX package names: optax's
# state classes (stand-ins with the same fields) and jax's array rebuild.
_OPTAX_STATES = {
    ("optax._src.base", "EmptyState"): (),
    ("optax._src.transform", "ScaleByAdamState"): ("count", "mu", "nu"),
    ("optax._src.transform", "ScaleByRmsState"): ("nu",),
    ("optax._src.transform", "ScaleByScheduleState"): ("count",),
    ("optax._src.factorized", "FactoredState"): ("count", "v_row", "v_col", "v"),
}
_STAND_INS = {key: collections.namedtuple(key[1], fields)
              for key, fields in _OPTAX_STATES.items()}
_NUMPY_GLOBALS = {
    (mod, name) for mod in ("numpy._core.multiarray", "numpy.core.multiarray")
    for name in ("_reconstruct", "scalar")
} | {("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode")}


def _rebuild_jax_array(fun, args, arr_state, aval_state):
    """jax._src.array._reconstruct_array without the device: the numpy array."""
    arr = fun(*args)
    arr.__setstate__(arr_state)
    return arr


class _LegacyUnpickler(pickle.Unpickler):
    """Reads the JAX package's legacy train_state.pkl without jax or optax:
    jax arrays come back as numpy arrays, optax states as namedtuples with
    the same fields; any other global is refused."""

    def find_class(self, module, name):
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _rebuild_jax_array
        if (module, name) in _STAND_INS:
            return _STAND_INS[(module, name)]
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"train_state.pkl names the global {module}.{name}, which a train "
            "state written by the JAX package does not hold; refusing to load it")


def _tree_leaves(tree) -> list:
    """jax.tree_util.tree_leaves: dict keys sorted, sequences and namedtuple
    fields in order, None (and an empty state) no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [tree]


def load_train_state(path: str):
    """Load a train state; returns {params, opt_leaves, epoch} with numpy
    leaves. Dispatches on extension: .npz is format 1; .pkl is the JAX
    package's legacy raw pickle, loadable once so that a run can resume."""
    if path.endswith(".pkl"):
        with open(path, "rb") as fh:
            legacy = _LegacyUnpickler(fh).load()
        return {"params": legacy["params"],
                "opt_leaves": [np.asarray(x) for x in _tree_leaves(legacy["opt_state"])],
                "epoch": int(legacy["epoch"])}
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    meta = json.loads(bytes(flat.pop("__meta__")).decode("utf-8"))
    params = _unflatten({k[len("params/"):]: v for k, v in flat.items()
                         if k.startswith("params/")})
    opt_leaves = [flat[f"opt/{i:04d}"] for i in range(meta["n_opt_leaves"])]
    return {"params": params, "opt_leaves": opt_leaves, "epoch": int(meta["epoch"])}


def choose_mesh(config: dict, batch_size: int):
    """The JAX package's choice of layout (its train_run): tp from the config,
    which must divide the world (else ValueError); dp = world / tp where the
    batch divides by it; otherwise a warning when tp was asked for and no
    mesh (each rank runs unsharded). Every rank calls this: it makes the
    mesh's process groups."""
    n_world, _ = world_and_rank()
    n_tp = max(1, int(config.get("tensor_parallel", 1)))
    if n_tp > 1 and n_world % n_tp != 0:
        raise ValueError(f"tensor_parallel={n_tp} does not divide the device count {n_world}")
    n_dp = n_world // n_tp
    if n_world > 1 and batch_size % n_dp == 0:
        logger.info(f"Training over {n_world} devices (dp={n_dp}, tp={n_tp})")
        return make_mesh(n_dp, n_tp)
    if n_tp > 1:
        logger.warning(f"tensor_parallel={n_tp} requested but only {n_world} device(s) "
                       "available or batch not divisible; running unsharded.")
    return None


def train_run(
    train_dir: str,
    valid_dir: Optional[str],
    config: dict,
    model_path: Optional[str],
    save_valid_plots: bool = False,
    seed: int = 42,
    max_steps_per_epoch: Optional[int] = None,
    resume: bool = False,
    init_params_override: Optional[dict] = None,
    device: torch.device = torch.device("cuda"),
) -> dict:
    """Train a model on `device` (a CUDA device that is not there raises);
    returns the final metrics. Checkpoints land next to model_path (or in
    ./logs-<log_name>/, as the reference does). In a multi-process run every
    rank calls this with the same arguments; `cuda` is the rank's card."""
    device = resolve_device(device)
    mesh = choose_mesh(config, int(config["train_batch_size"]))
    is_primary = world_and_rank()[1] == 0
    if model_path is not None:
        log_dir, filename = os.path.split(str(model_path))
        ckpt_name = os.path.splitext(filename)[0] or "last"
        log_dir = log_dir or "."
    else:
        log_dir = "./logs-" + config["log_name"]
        ckpt_name = "last"
        logger.info(f"Model path not specified. Saving to {log_dir}/{ckpt_name}.npz")
    os.makedirs(log_dir, exist_ok=True)

    params = (init_params_override if init_params_override is not None
              else init_params(config, prng.key(seed)))
    logger.info(f"Total Trainable Params: {count_params(params):,}")

    train_files, valid_files = load_file_groups(
        train_dir, valid_dir, config["train_valid_split"],
        config.get("random_seed", seed))
    train_ds = ChunkDataset(train_files, config["max_chunks_train"], config)
    valid_ds = ChunkDataset(valid_files, config["max_chunks_valid"], config)
    logger.info(f"True Training dataset size: {len(train_ds)}; "
                f"validation size: {len(valid_ds)}")

    batch_size = int(config["train_batch_size"])
    steps_per_epoch = max(1, (len(train_ds) + batch_size - 1) // batch_size)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    total_steps = steps_per_epoch * int(config["max_epochs"])


    start_epoch = 0
    state_path = os.path.join(log_dir, "train_state.npz")
    legacy_path = os.path.join(log_dir, "train_state.pkl")
    resume_path = (state_path if os.path.exists(state_path)
                   else legacy_path if os.path.exists(legacy_path) else None)
    saved = None
    if resume and resume_path:
        saved = load_train_state(resume_path)
        params = params_from_jax(saved["params"])
        start_epoch = int(saved["epoch"]) + 1
        logger.info(f"Resuming training from epoch {start_epoch}")
    elif resume:
        logger.warning(f"--resume requested but {state_path} not found; starting fresh.")

    params = to_train_params(shard_params(params, mesh), device)
    leaves = [v for _, v in tree_leaves(params)]
    optimizer = build_optimizer(config, total_steps, params, mesh)
    opt_state = optimizer.init(leaves)
    if saved is not None:
        opt_state = optimizer.restore_state(opt_state, saved["opt_leaves"])

    train_step = make_train_step(config, optimizer, mesh)
    valid_step = make_valid_step(config, mesh)
    local_rows = mesh.local_rows(batch_size) if mesh is not None and mesh.n_dp > 1 else None

    on_gpu = device.type == "cuda"

    def place_batch(batch, mask):
        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if on_gpu:
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        return {k: put(v) for k, v in batch.items()}, put(mask)

    metrics_log = MetricsLogger(log_dir, config) if is_primary else None
    rng = np.random.default_rng(seed)
    base_key = prng.key(seed, device)

    step = start_epoch * steps_per_epoch
    last_metrics: Dict[str, float] = {}
    for epoch in range(start_epoch, int(config["max_epochs"])):
        for i, (batch, mask) in enumerate(
                epoch_batches(train_ds, batch_size, rng, shuffle=True, local_rows=local_rows)):
            if max_steps_per_epoch and i >= max_steps_per_epoch:
                break
            dropout_key = prng.fold_in(base_key, step)
            batch, mask = place_batch(batch, mask)
            metrics = train_step(params, opt_state, batch, mask, dropout_key)
            if step % 100 == 0:
                host = {f"train_{k}": float(v) for k, v in metrics.items()}
                host["lr_epoch"] = epoch
                if is_primary:
                    metrics_log.log(host, step=step)
                last_metrics = host
            step += 1

        # ---- validation ----
        val_accum: Dict[str, torch.Tensor] = {}
        n_val = 0
        first_batch = None
        for batch, mask in epoch_batches(valid_ds, batch_size, rng, shuffle=False,
                                         local_rows=local_rows):
            batch, mask = place_batch(batch, mask)
            if first_batch is None:
                first_batch = batch
            for k, v in valid_step(params, batch, mask).items():
                val_accum[k] = val_accum.get(k, 0.0) + v.double()
            n_val += 1
        if n_val:
            val_metrics = {f"valid_{k}": float(v) / n_val for k, v in val_accum.items()}
            if is_primary:
                metrics_log.log(val_metrics, step=step)
            last_metrics.update(val_metrics)
            logger.info(f"epoch {epoch}: "
                        + ", ".join(f"{k}={v:.5f}" for k, v in val_metrics.items()))

        # whole parameters on every rank (a collective) for rank 0's plots and files
        plots = save_valid_plots and first_batch is not None
        whole = (gather_params(params, mesh) if plots or config.get("save_model", True)
                 else None)
        if plots and is_primary:
            try:
                from .plots import generate_validation_plots

                generate_validation_plots(whole, config, first_batch, epoch, log_dir,
                                          prng.fold_in(base_key, 10_000 + epoch))
            except Exception as exc:  # plots must never stop training
                logger.warning(f"Validation plots failed: {exc}")

        # ---- checkpoints: weights-only npz per epoch (save_top_k=-1) ----
        if config.get("save_model", True):
            opt_leaves = optimizer.state_leaves(opt_state)  # whole leaves, every rank
        if config.get("save_model", True) and is_primary:
            host_params = params_to_jax(whole)
            save_native_checkpoint(os.path.join(log_dir, f"{ckpt_name}-epoch{epoch}.npz"),
                                   host_params, config)
            save_native_checkpoint(os.path.join(log_dir, f"{ckpt_name}.npz"),
                                   host_params, config)
            _save_train_state(state_path, host_params, opt_leaves, epoch)

    if metrics_log is not None:
        metrics_log.close()
    logger.info("Training finished.")
    return last_metrics
