"""Configuration system.

Mirrors the reference's flat-dict YAML config (reference:
src/seq2squiggle/config.yaml:1-47 and set_config at
src/seq2squiggle/seq2squiggle.py:640-657): packaged defaults, optionally
overridden by a user YAML. We keep the same key names so user configs and
imported torch checkpoints (whose hparams embed this dict) line up.
"""

from __future__ import annotations

import copy
import logging
import pathlib
from typing import Optional

import yaml

logger = logging.getLogger("seq2squiggle_tpu_torch")

# Packaged defaults (same keys/values as the reference config.yaml so that
# check_model()-style hparam comparison against imported checkpoints works).
DEFAULT_CONFIG: dict = {
    # Logging
    "log_name": "Human-R1041-4khz",
    "wandb_logger_state": "disabled",  # disabled, online, offline
    # Preprocessing
    "max_chunks_train": 210000000,
    "max_chunks_valid": 100000,
    "scaling_max_value": 165.0,
    "train_valid_split": 0.9,
    "max_dna_len": 16,
    "max_signal_len": 250,
    "allowed_chars": "_ACGT",
    "seq_kmer": 9,
    # Model
    "pre_layers": 1,
    "dmodel": 64,
    "dff": 256,
    "encoder_layers": 2,
    "encoder_heads": 8,
    "decoder_layers": 2,
    "decoder_heads": 8,
    "encoder_dropout": 0.2,
    "decoder_dropout": 0.2,
    "duration_dropout": 0.2,
    # Training
    "train_batch_size": 512,
    "max_epochs": 25,
    "save_model": True,
    "optimizer": "Adam",
    "warmup_ratio": 0.01,
    "lr": 0.0005,
    "weight_decay": 0.0,
    "lr_schedule": "warmup_cosine",
    "gradient_clip_val": 1.0,
    # TPU-build extensions (not present in the reference; safe extra keys)
    "compute_dtype": "bfloat16",  # bfloat16 | float32 — inner-loop matmul dtype
    "use_pallas": "auto",  # auto | true | false — fused TPU attention blocks
    "pallas_packed": "auto",  # auto | true | false — head-packed attention
    # inside the fused blocks (auto = by sequence length; see
    # ops/pallas/fft_block._packed_default)
    "pallas_pair": "auto",  # auto | true | false — fuse both decoder FFT
    # blocks into one pallas_call (auto = off until timed on hardware)
    "pallas_train": "auto",  # auto | true | block | core | false — the
    # decoder's rung on the TRAINING path: whole-block kernels, attention-core
    # kernels or plain blocks (auto = block in bf16 on a GPU, else plain; see
    # models/fft_model._train_kernel_mode)
    "random_seed": 42,  # used for file-level train/valid splits
    "tensor_parallel": 1,  # 'tp' mesh degree for training (CLI: train --tp)
}


def load_config(config_path: Optional[str] = None) -> dict:
    """Load config: packaged defaults, overlaid with a user YAML if given.

    Unlike the reference (which *replaces* the whole dict with the user file),
    we merge user keys over defaults so partial configs are valid; a full
    reference-style config file therefore behaves identically.
    """
    config = copy.deepcopy(DEFAULT_CONFIG)
    if config_path is None:
        logger.info("Config file was not specified. Default config will be used.")
        return config

    path = pathlib.Path(config_path)
    try:
        with open(path, "r") as f_in:
            user_config = yaml.safe_load(f_in) or {}
    except FileNotFoundError:
        logger.error(f"Configuration file not found: {path}")
        raise
    except yaml.YAMLError as exc:
        logger.error(f"Error parsing YAML file: {path} - {exc}")
        raise

    for key, value in user_config.items():
        if key not in config:
            logger.warning(f"Unknown config key {key!r} (kept as-is)")
        config[key] = value
    return config


def check_model_config(model_config: dict, config: dict) -> None:
    """Validate checkpoint hparams against the active config.

    Equivalent behavior to the reference check_model
    (src/seq2squiggle/inference.py:224-267): hard error on seq_kmer
    mismatch, warning on any other architecture-relevant mismatch.
    """
    exclude_params = {
        "log_name",
        "wandb_logger_state",
        "max_chunks_train",
        "max_chunks_valid",
        "train_valid_split",
        "train_batch_size",
        "save_model",
        # TPU-build-only keys that never affect weight shapes:
        "compute_dtype",
        "use_pallas",
        "pallas_packed",
        "pallas_pair",
        "pallas_train",
        "random_seed",
        "tensor_parallel",
    }
    for param, value in config.items():
        if param in exclude_params:
            continue
        if model_config.get(param) != value:
            if param == "seq_kmer":
                raise ValueError(
                    f"Parameter 'seq_kmer' mismatch: model checkpoint value is "
                    f"{model_config.get(param)}, while config value is {value}. "
                    f"The model was trained on {model_config.get(param)}-mers, "
                    f"while the config expects {value}-mers. Choose a different "
                    f"model or change the config value or the --profile option."
                )
            logger.warning(
                f"Mismatching {param} parameter in model checkpoint "
                f"({model_config.get(param)}) and in config file ({value})"
            )
