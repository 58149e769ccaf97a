"""Checkpoints for the port: the JAX package's parameter tree as torch tensors.

The tree keeps the JAX package's layout (models/fft_model.py): nested dicts
keyed like the reference's state_dict, lists for `pre_net` and `blocks`,
Linear kernels stored (in, out). Two formats load:
  - `.npz`, the JAX package's native checkpoint: flat `a/b/0/c` keys plus a
    `__config__` JSON entry (models/torch_import.py:112-162);
  - `.ckpt`, a reference Lightning checkpoint, through the same state-dict
    mapping as models/torch_import.py:21-104.
Both are port-local because importing seq2squiggle_tpu.models imports jax.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch


def params_from_jax(tree):
    """Map a parameter tree of numpy (or numpy-convertible) leaves to float32
    CPU tensors with the same structure."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _unflatten(flat: dict):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def load_native_checkpoint(path: str) -> Tuple[dict, dict]:
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    config = json.loads(bytes(flat.pop("__config__")).decode("utf-8"))
    return params_from_jax(_unflatten(flat)), config


def _lin(sd: dict, name: str) -> dict:
    return {"kernel": sd[f"{name}.weight"].T.copy(), "bias": sd[f"{name}.bias"]}


def _ln(sd: dict, name: str) -> dict:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _block(sd: dict, prefix: str) -> dict:
    return {
        "attn": {
            "w_qs": _lin(sd, f"{prefix}.slf_attn.w_qs"),
            "w_ks": _lin(sd, f"{prefix}.slf_attn.w_ks"),
            "w_vs": _lin(sd, f"{prefix}.slf_attn.w_vs"),
            "fc": _lin(sd, f"{prefix}.slf_attn.fc"),
            "ln": _ln(sd, f"{prefix}.slf_attn.layer_norm"),
        },
        "ffn": {
            "w_1": _lin(sd, f"{prefix}.pos_ffn.w_1"),
            "w_2": _lin(sd, f"{prefix}.pos_ffn.w_2"),
            "ln": _ln(sd, f"{prefix}.pos_ffn.layer_norm"),
        },
    }


def _mlp_head(sd: dict, prefix: str) -> dict:
    # Sequential(Linear, ReLU, Dropout, Linear, Softplus): layers 0 and 3
    return {"fc1": _lin(sd, f"{prefix}.0"), "fc2": _lin(sd, f"{prefix}.3")}


def params_from_state_dict(sd: dict, config: dict) -> dict:
    """Map a reference state_dict to the port's parameter tree."""
    sd = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v, np.float32)
          for k, v in sd.items()}
    tree = {
        "encoder": {
            "src_emb": _lin(sd, "encoders.src_emb"),
            "pre_net": [_lin(sd, f"encoders.pre_net_stack.{i}")
                        for i in range(config["pre_layers"])],
            "pos_enc": sd["encoders.position_enc"][0],
            "blocks": [_block(sd, f"encoders.layer_stack.{i}")
                       for i in range(config["encoder_layers"])],
        },
        "decoder": {
            "pos_enc": sd["decoders.position_enc"][0],
            "blocks": [_block(sd, f"decoders.layer_stack_FFT.{i}")
                       for i in range(config["decoder_layers"])],
            "out_linear": _lin(sd, "decoders.out_linear"),
        },
        "noise_sampler": _mlp_head(sd, "noise_sampler.stdv_layer"),
        "duration_sampler": {
            "conc": _mlp_head(sd, "length_regulator.duration_sampler.conc_layer"),
            "rate": _mlp_head(sd, "length_regulator.duration_sampler.rate_layer"),
        },
    }
    return params_from_jax(tree)


def load_torch_checkpoint(path: str) -> Tuple[dict, dict]:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    config = dict(ckpt.get("hyper_parameters", {}).get("config", {}))
    if not config:
        raise ValueError(
            f"{path} has no embedded config (hyper_parameters.config); "
            "pass a matching --config explicitly."
        )
    return params_from_state_dict(sd, config), config


def load_checkpoint(path: str) -> Tuple[dict, dict]:
    """Dispatch on extension: .ckpt -> reference import, .npz -> native."""
    path = str(path)
    if path.endswith(".ckpt"):
        return load_torch_checkpoint(path)
    if path.endswith(".npz"):
        return load_native_checkpoint(path)
    raise ValueError(f"Unknown checkpoint format: {path} (expect .ckpt or .npz)")
