"""The run's device, chosen once at the entry point and passed down.

Asking for CUDA where there is none is an error, never a quiet move to the
CPU. Float32 products run at full precision on the GPU (TF32 off for matmul
and cuDNN): the JAX package's float32 mode multiplies at Precision.HIGHEST
(seq2squiggle_tpu/ops/attention.py:25-34).
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} was asked for but torch.cuda.is_available() is "
                "false; pass --device cpu to run the plain version on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device
