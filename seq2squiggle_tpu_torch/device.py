"""The run's devices, chosen once at the entry point and passed down.

Asking for CUDA where there is none is an error, never a quiet move to the
CPU. Float32 products run at full precision on the GPU (TF32 off for matmul
and cuDNN): the JAX package's float32 mode multiplies at Precision.HIGHEST
(seq2squiggle_tpu/ops/attention.py:25-34).

`cuda` without an index means, in one process, the current card for a
command that runs on one device (`resolve_device`) and every visible card for
`predict` (`resolve_devices`, as jax.devices() lists them); in a
multi-process run (parallel/distributed.py) it is the rank's own card, local
rank modulo the cards, for both. `cuda:N` pins card N.
"""

from __future__ import annotations

import torch


def _check(name, device: torch.device) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} was asked for but torch.cuda.is_available() is "
            "false; pass --device cpu to run the plain version on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rank_card() -> "int | None":
    """The rank's card in a multi-process run, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        from .parallel.distributed import local_rank

        return local_rank() % torch.cuda.device_count()
    return None


def resolve_device(name) -> torch.device:
    device = torch.device(name)
    _check(name, device)
    if device.type == "cuda" and device.index is None:
        card = _rank_card()
        device = torch.device("cuda", torch.cuda.current_device() if card is None else card)
    return device


def resolve_devices(name) -> list:
    """The devices `predict` shards its batches over."""
    device = torch.device(name)
    _check(name, device)
    if device.type != "cuda" or device.index is not None:
        return [device]
    card = _rank_card()
    if card is not None:
        return [torch.device("cuda", card)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
