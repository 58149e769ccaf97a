"""Training loop on one GPU: the port of seq2squiggle_tpu/train/loop.py.

The same forward wiring as the JAX package (noise and duration heads on the
detached pre-PE embedding, ground-truth durations through the one-hot length
regulator), the same three-term loss, optimizer and schedule menu, dropout
keys (`fold_in(base_key, step)` per step, split four ways), per-epoch
weights-only checkpoints, a full train state (parameters + optimizer state)
for `--resume`, and metrics every 100 steps. Checkpoints and train states
are the JAX package's files: either package loads the other's.

The step is eager PyTorch: loss, `.backward()`, the optimizer's update in
place. The decoder's two blocks take the rung `pallas_train` names
(models/fft_model.py::_train_kernel_mode): `block` (also `true`, and `auto`
in bfloat16 on a GPU, the default) runs each whole block through the
hand-written forward and backward kernels of ops/block_train.py; `core` runs
only the attention core through those of ops/attn_core.py; `false` (and
`auto` in float32 or on the CPU) is plain PyTorch.

Not ported (each raises NotImplementedError): `tensor_parallel > 1` and more
than one device or process, `--save-valid-plots`, the legacy `.pkl` train
state. There is no probe ladder: a kernel that fails to build or launch
raises, and no rung steps down to another.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import prng
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
from .data import ChunkDataset, epoch_batches, load_file_groups
from .losses import total_loss
from .metrics import MetricsLogger
from .optimizers import Optimizer, build_optimizer, global_norm

logger = logging.getLogger("seq2squiggle_tpu_torch")


def model_forward_train(params: dict, batch: Dict[str, torch.Tensor], config: dict,
                        dropout_key: Optional[torch.Tensor]):
    """Shared train/valid forward. Returns (prediction, conc, rate, noise_pred)."""
    B, K = batch["chunks"].shape[:2]
    data = batch["chunks"].reshape(B, K, -1).to(compute_dtype(config))

    keys = prng.split(dropout_key, 4) if dropout_key is not None else [None] * 4
    enc_out, emb_out = encoder_forward(params, data, config, dropout_key=keys[0], train=True)

    emb_detached = emb_out.detach().float()
    noise_pred = noise_head(params, emb_detached, config, dropout_key=keys[1])
    conc, rate = duration_gamma_params(params, emb_detached, config, dropout_key=keys[2])

    expanded, _, _ = length_regulate(enc_out, batch["chunks_lengths"],
                                     config["max_signal_len"])
    prediction = decoder_forward(params, expanded, config, dropout_key=keys[3], train=True)
    return prediction.float(), conc, rate, noise_pred


def loss_fn(params, batch, mask, config, dropout_key):
    prediction, conc, rate, noise_pred = model_forward_train(params, batch, config,
                                                             dropout_key)
    return total_loss(prediction, batch["targets"], conc, rate, batch["chunks_lengths"],
                      noise_pred, batch["stdevs"], mask)


def per_param_grad_norms(paths, grads) -> Dict[str, torch.Tensor]:
    """grad_norm/<a/b/0/c> per leaf, the JAX package's names."""
    return {f"grad_norm/{'/'.join(p)}": torch.linalg.vector_norm(g.float())
            for p, g in zip(paths, grads)}


def make_train_step(config: dict, optimizer: Optimizer):
    """(params, opt_state, batch, mask, key) -> metrics; parameters and the
    optimizer state are updated in place."""

    def step(params, opt_state, batch, mask, key):
        paths, leaves = zip(*tree_leaves(params))
        _, metrics = loss_fn(params, batch, mask, config, key)
        grads = torch.autograd.grad(metrics["total_loss"], leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        metrics.update(per_param_grad_norms(paths, grads))
        optimizer.update(grads, opt_state, leaves)
        return metrics

    return step


def make_valid_step(config: dict):
    def step(params, batch, mask):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch, mask, config, None)
        return metrics

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


def load_train_state(path: str):
    """Load a format-1 train state; returns {params, opt_leaves, epoch} with
    numpy leaves."""
    if path.endswith(".pkl"):
        raise NotImplementedError(
            "the legacy train_state.pkl format is not ported (ROADMAP.md, module "
            "queue A11b); resume it once with the JAX package, which rewrites it "
            "as train_state.npz")
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    meta = json.loads(bytes(flat.pop("__meta__")).decode("utf-8"))
    params = _unflatten({k[len("params/"):]: v for k, v in flat.items()
                         if k.startswith("params/")})
    opt_leaves = [flat[f"opt/{i:04d}"] for i in range(meta["n_opt_leaves"])]
    return {"params": params, "opt_leaves": opt_leaves, "epoch": int(meta["epoch"])}


def _check_supported(config: dict, save_valid_plots: bool) -> None:
    if max(1, int(config.get("tensor_parallel", 1))) > 1:
        raise NotImplementedError(
            "tensor_parallel > 1 (and training over more than one device or "
            "process) is not ported to the GPU yet (ROADMAP.md, module queue A12)")
    if save_valid_plots:
        raise NotImplementedError(
            "--save_valid_plots is not ported to the GPU yet (ROADMAP.md, module "
            "queue A11b); pass --save_valid_plots false")


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
    ./logs-<log_name>/, as the reference does)."""
    _check_supported(config, save_valid_plots)
    device = resolve_device(device)
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

    optimizer = build_optimizer(config, total_steps)

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

    params = to_train_params(params, device)
    leaves = [v for _, v in tree_leaves(params)]
    opt_state = optimizer.init(leaves)
    if saved is not None:
        opt_state = optimizer.restore_state(opt_state, saved["opt_leaves"])

    train_step = make_train_step(config, optimizer)
    valid_step = make_valid_step(config)

    on_gpu = device.type == "cuda"

    def place_batch(batch, mask):
        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if on_gpu:
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        return {k: put(v) for k, v in batch.items()}, put(mask)

    metrics_log = MetricsLogger(log_dir, config)
    rng = np.random.default_rng(seed)
    base_key = prng.key(seed, device)

    step = start_epoch * steps_per_epoch
    last_metrics: Dict[str, float] = {}
    for epoch in range(start_epoch, int(config["max_epochs"])):
        for i, (batch, mask) in enumerate(
                epoch_batches(train_ds, batch_size, rng, shuffle=True)):
            if max_steps_per_epoch and i >= max_steps_per_epoch:
                break
            dropout_key = prng.fold_in(base_key, step)
            batch, mask = place_batch(batch, mask)
            metrics = train_step(params, opt_state, batch, mask, dropout_key)
            if step % 100 == 0:
                host = {f"train_{k}": float(v) for k, v in metrics.items()}
                host["lr_epoch"] = epoch
                metrics_log.log(host, step=step)
                last_metrics = host
            step += 1

        # ---- validation ----
        val_accum: Dict[str, torch.Tensor] = {}
        n_val = 0
        for batch, mask in epoch_batches(valid_ds, batch_size, rng, shuffle=False):
            batch, mask = place_batch(batch, mask)
            for k, v in valid_step(params, batch, mask).items():
                val_accum[k] = val_accum.get(k, 0.0) + v.double()
            n_val += 1
        if n_val:
            val_metrics = {f"valid_{k}": float(v) / n_val for k, v in val_accum.items()}
            metrics_log.log(val_metrics, step=step)
            last_metrics.update(val_metrics)
            logger.info(f"epoch {epoch}: "
                        + ", ".join(f"{k}={v:.5f}" for k, v in val_metrics.items()))

        # ---- checkpoints: weights-only npz per epoch (save_top_k=-1) ----
        if config.get("save_model", True):
            host_params = params_to_jax(params)
            save_native_checkpoint(os.path.join(log_dir, f"{ckpt_name}-epoch{epoch}.npz"),
                                   host_params, config)
            save_native_checkpoint(os.path.join(log_dir, f"{ckpt_name}.npz"),
                                   host_params, config)
            _save_train_state(state_path, host_params, optimizer.state_leaves(opt_state),
                              epoch)

    metrics_log.close()
    logger.info("Training finished.")
    return last_metrics
