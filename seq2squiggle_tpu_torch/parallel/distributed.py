"""Multi-process start-up: the port of seq2squiggle_tpu/parallel/distributed.py.

One process per rank, joined by a `torch.distributed` process group. The run
is multi-process when the environment says so, in either of two ways:

  - the JAX package's own variables: JAX_COORDINATOR_ADDRESS (host:port),
    JAX_NUM_PROCESSES and JAX_PROCESS_ID (SEQ2SQUIGGLE_TPU_DISTRIBUTED=1
    alone, which lets jax find its TPU pod, here needs one of the two sets);
  - torchrun's: MASTER_ADDR and MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK
    (and LOCAL_WORLD_SIZE, the ranks on this host).

Otherwise nothing starts and the run is one process, as before.

The backend follows one rule, with no option to change it: `nccl` when each
rank of this host owns a card of its own, `gloo` when ranks share a card
(NCCL refuses two ranks on one GPU) and on the CPU. A group that the caller
started before is checked against the same rule: `nccl` with ranks sharing a
card raises. Asking for CUDA where there is none raises, as device.py does;
nothing moves to the CPU.

What the commands do with it (cli.py): a multi-process `predict` shards the
reads round-robin by global read index over the ranks (num_shards = world,
shard_index = rank) and each rank writes `<out>.shard<rank>.<ext>`; `train`
lays the ranks out as a ('dp', 'tp') mesh (parallel/mesh.py), every rank reads
its slab of each batch, and rank 0 alone logs, plots and writes checkpoints.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger("seq2squiggle_tpu_torch")

RULE = ("the backend rule: nccl when each rank owns a card of its own, gloo when "
        "ranks share a card (NCCL refuses two ranks on one GPU) and on the CPU")

_LOCAL = {"rank": 0, "world": 1}  # this host's ranks, set when the group starts


def backend_for(device_type: str, local_world: int, n_cards: int,
                requested: str | None = None) -> str:
    """The backend the rule gives `local_world` ranks of one host that run on
    `device_type` with `n_cards` cards; `requested` (a group's backend that is
    already chosen) is checked against it and returned."""
    shared = device_type != "cuda" or local_world > n_cards
    rule = "gloo" if shared else "nccl"
    if requested is None:
        return rule
    if requested == "nccl" and shared:
        where = ("on the CPU" if device_type != "cuda"
                 else f"{local_world} ranks share {n_cards} card(s) on this host")
        raise ValueError(f"a nccl process group cannot run here ({where}); {RULE}")
    return requested


def local_rank() -> int:
    """This process's rank among the ranks of its host (0 in one process)."""
    return _LOCAL["rank"]


def _environment():
    """(init_method, world, rank, local rank, local world) from the JAX
    package's variables or torchrun's; None when neither set is there."""
    env = os.environ
    if env.get("JAX_COORDINATOR_ADDRESS"):
        world, rank = int(env["JAX_NUM_PROCESSES"]), int(env["JAX_PROCESS_ID"])
        init = f"tcp://{env['JAX_COORDINATOR_ADDRESS']}"
    elif env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        init = "env://"
    elif env.get("SEQ2SQUIGGLE_TPU_DISTRIBUTED", "").lower() in ("1", "true", "yes"):
        raise RuntimeError(
            "SEQ2SQUIGGLE_TPU_DISTRIBUTED is set but neither JAX_COORDINATOR_ADDRESS "
            "(with JAX_NUM_PROCESSES and JAX_PROCESS_ID) nor torchrun's MASTER_ADDR, "
            "MASTER_PORT, RANK and WORLD_SIZE are: a process group needs its address, "
            "world size and rank")
    else:
        return None
    # without LOCAL_* the ranks are taken to be on one host
    return (init, world, rank, int(env.get("LOCAL_RANK", rank)),
            int(env.get("LOCAL_WORLD_SIZE", world)))


def maybe_init_distributed(device="cpu") -> bool:
    """Start the process group if the environment asks for one; returns True
    when the run is multi-process. Safe to call again. `device` is what the
    run computes on (`cpu`, `cuda` or `cuda:N`); it picks the backend."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() is "
            "false; pass --device cpu to run the plain version on the CPU")
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if dist.is_available() and dist.is_initialized():
        if _LOCAL["world"] == 1:  # a group the caller started
            env = os.environ
            _LOCAL.update(rank=int(env.get("LOCAL_RANK", dist.get_rank())),
                          world=int(env.get("LOCAL_WORLD_SIZE", dist.get_world_size())))
        backend_for(device_type, _LOCAL["world"], n_cards, dist.get_backend())
        return dist.get_world_size() > 1
    found = _environment()
    if found is None:
        return False
    init, world, rank, lrank, lworld = found
    _LOCAL.update(rank=lrank, world=lworld)
    backend = backend_for(device_type, lworld, n_cards)
    if device_type == "cuda":
        torch.cuda.set_device(lrank % n_cards)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    logger.info(f"torch.distributed: rank {rank}/{world} (local {lrank}/{lworld}), "
                f"backend {backend}")
    return world > 1


def world() -> tuple:
    """(world size, rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0
