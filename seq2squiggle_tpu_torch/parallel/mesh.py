"""The ('dp', 'tp') layout of the ranks and its collectives: the port of
seq2squiggle_tpu/parallel/mesh.py.

The JAX package lays its devices out as a ('dp', 'tp') mesh and lets XLA
insert the collectives its shardings imply. Here each device is a process (a
rank of torch.distributed), and the collectives are written out:

  - 'dp': each rank of a dp row reads its slab of every batch; the gradients
    are summed over the ranks that share a tp index (`dp_group`), with the
    loss divided by the global count of valid rows, so the sum is the
    gradient of the global batch's loss;
  - 'tp': Megatron's tensor parallelism over the FFN's hidden axis and the
    attention heads, as `param_shardings` lays the weights out: w_1, w_qs,
    w_ks and w_vs column-parallel (each rank owns whole heads, n_head / tp of
    them), w_2 and fc row-parallel, everything else replicated. The pair of
    autograd Functions is Megatron's: `copy_to_tp` (identity forward, sum of
    the gradient over tp backward) before a column-parallel product,
    `reduce_from_tp` (sum over tp forward, identity backward) after a
    row-parallel one.

Rank r sits at dp row r // n_tp, tp column r % n_tp (the JAX package reshapes
its device list the same way). A gather is an all-reduce of zero-padded
shards: gloo takes all-reduce on CUDA tensors, and for nccl it is the same
collective. With one rank (or a layout made without a process group, as the
tests make them) every collective is the identity.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """n_dp x n_tp ranks; `rank` is this process's. dp_group holds the ranks
    of this rank's tp column (the gradient sum), tp_group those of its dp row
    (the tensor-parallel sums); each is None where it has one rank or no
    process group exists."""

    def __init__(self, n_dp: int, n_tp: int, rank: int = 0, dp_group=None, tp_group=None):
        self.n_dp, self.n_tp, self.rank = n_dp, n_tp, rank
        self.dp_group, self.tp_group = dp_group, tp_group

    @property
    def shape(self) -> dict:
        return {"dp": self.n_dp, "tp": self.n_tp}

    @property
    def ranks(self) -> np.ndarray:
        return np.arange(self.n_dp * self.n_tp).reshape(self.n_dp, self.n_tp)

    @property
    def dp_rank(self) -> int:
        return self.rank // self.n_tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.n_tp

    def local_rows(self, batch_size: int) -> slice:
        """This rank's slab of a global batch (its dp row's rows)."""
        per = batch_size // self.n_dp
        return slice(self.dp_rank * per, (self.dp_rank + 1) * per)

    def __repr__(self) -> str:
        return f"Mesh(dp={self.n_dp}, tp={self.n_tp}, rank={self.rank})"


def make_mesh(n_dp: Optional[int] = None, n_tp: int = 1, world: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """A ('dp', 'tp') layout over the world's ranks (all of them on dp by
    default). With a process group running, `world` and `rank` are its own and
    every rank must call this, in the same order: it makes a group for each dp
    row and each tp column. Without one, `world` and `rank` lay out a world
    that is not there (the layout alone, no collective)."""
    running = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if running else 1
    if rank is None:
        rank = dist.get_rank() if running else 0
    if n_dp is None:
        n_dp = world // n_tp
    if n_dp < 1 or n_dp * n_tp > world:
        raise ValueError(f"a ({n_dp}, {n_tp}) mesh needs {n_dp * n_tp} ranks; the world has {world}")
    mesh = Mesh(n_dp, n_tp, rank)
    if running and n_dp * n_tp > 1:
        ranks = mesh.ranks
        for i in range(n_dp):  # every rank makes every group, in one order
            group = dist.new_group(ranks[i].tolist()) if n_tp > 1 else None
            if i == mesh.dp_rank:
                mesh.tp_group = group
        for j in range(n_tp):
            group = dist.new_group(ranks[:, j].tolist()) if n_dp > 1 else None
            if j == mesh.tp_rank:
                mesh.dp_group = group
    return mesh


# ---------------------------------------------------------------------------
# The parameter layout (the JAX package's path rule; a spec is a tuple of
# axis names or None, as a PartitionSpec lists them)
# ---------------------------------------------------------------------------


def spec_for(path: str, ndim: int) -> tuple:
    """The spec of the leaf at `path` (a/b/0/c) with `ndim` axes."""
    if ndim == 2:
        if "ffn/w_1/kernel" in path or any(f"attn/{w}/kernel" in path
                                           for w in ("w_qs", "w_ks", "w_vs")):
            return (None, "tp")
        if "ffn/w_2/kernel" in path or "attn/fc/kernel" in path:
            return ("tp", None)
    elif ndim == 1:
        if "ffn/w_1/bias" in path or any(f"attn/{w}/bias" in path
                                         for w in ("w_qs", "w_ks", "w_vs")):
            return ("tp",)
    return ()


def _map(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def param_shardings(params: dict) -> dict:
    """The spec of every leaf: (None, 'tp') column-parallel, ('tp', None)
    row-parallel, ('tp',) a column-parallel bias, () replicated (the JAX
    package's function takes the mesh to build NamedShardings; a spec here
    needs none)."""
    return _map(lambda path, leaf: spec_for(path, len(leaf.shape)), params)


def shard_axis(spec: tuple) -> Optional[int]:
    """The axis a spec shards over tp, or None."""
    return spec.index("tp") if "tp" in spec else None


def shard_tensor(t, axis: Optional[int], mesh: Optional[Mesh]):
    """This rank's slice of a full leaf (a tensor or an array)."""
    if axis is None or mesh is None or mesh.n_tp == 1:
        return t
    size = t.shape[axis]
    if size % mesh.n_tp:
        raise ValueError(f"axis {axis} of size {size} does not divide over tp={mesh.n_tp}")
    per = size // mesh.n_tp
    index = [slice(None)] * len(t.shape)
    index[axis] = slice(mesh.tp_rank * per, (mesh.tp_rank + 1) * per)
    return t[tuple(index)]


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def gather_tensor(t: torch.Tensor, axis: Optional[int], mesh: Optional[Mesh]) -> torch.Tensor:
    """The full leaf from every tp rank's slice (a collective: every rank of
    the dp row calls it)."""
    if axis is None or mesh is None or mesh.tp_group is None:
        return t
    shape = list(t.shape)
    per = shape[axis]
    shape[axis] = per * mesh.n_tp
    full = t.new_zeros(shape)
    full.narrow(axis, mesh.tp_rank * per, per).copy_(t)
    return _all_reduce(full, mesh.tp_group)


def shard_params(params: dict, mesh: Optional[Mesh]) -> dict:
    """Each leaf as this rank holds it under `param_shardings`."""
    return _map(lambda path, leaf: shard_tensor(leaf, shard_axis(spec_for(path, len(leaf.shape))),
                                                mesh), params)


def gather_params(params: dict, mesh: Optional[Mesh]) -> dict:
    """The full leaves from the ranks' shards (a collective), detached."""
    def full(path, leaf):
        return gather_tensor(leaf.detach(), shard_axis(spec_for(path, len(leaf.shape))), mesh)

    return _map(full, params)


# ---------------------------------------------------------------------------
# Collectives inside the training step
# ---------------------------------------------------------------------------


def tp_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum over the tp ranks, in place (no graph)."""
    return _all_reduce(t, mesh.tp_group if mesh is not None else None)


def dp_sum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum over the dp ranks, in place (no graph)."""
    return _all_reduce(t, mesh.dp_group if mesh is not None else None)


def dp_sum_all(tensors, mesh: Optional[Mesh]) -> list:
    """Each tensor summed over the dp ranks, in one collective."""
    tensors = list(tensors)
    if mesh is None or mesh.dp_group is None or not tensors:
        return tensors
    flat = dp_sum(torch.cat([t.reshape(-1).float() for t in tensors]), mesh)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


def global_rows(mesh: Optional[Mesh], rows: int) -> tuple:
    """(rows of the global batch, this rank's first row) for a slab of
    `rows`: a draw over the global batch taken at this slab is the JAX
    package's draw on its dp shard (threefry is partitionable there)."""
    if mesh is None or mesh.n_dp == 1:
        return rows, 0
    return rows * mesh.n_dp, rows * mesh.dp_rank


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over tp backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        # summed in f32 (gloo's sum of bf16 is not to be relied on): for two
        # ranks the one rounding of the bf16 sum
        return _all_reduce(g.float(), ctx.group).to(g.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over tp forward; identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)  # the f32 partial products

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOwnGrad(torch.autograd.Function):
    """The full weight from the tp ranks' slices forward; backward, this rank's
    slice of the weight's gradient, not summed: every tp rank computes the
    same full gradient (it runs the whole block on the same rows), so the
    rank keeps the part it owns. What pjit does to a kernel it cannot shard."""

    @staticmethod
    def forward(ctx, t, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return gather_tensor(t, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return shard_tensor(g, ctx.axis, ctx.mesh).contiguous(), None, None


def copy_to_tp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    if mesh is None or mesh.tp_group is None:
        return x
    return _CopyToTP.apply(x, mesh.tp_group)


def reduce_from_tp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    if mesh is None or mesh.tp_group is None:
        return x
    return _ReduceFromTP.apply(x, mesh.tp_group)


def gather_for_kernel(block: dict, mesh: Optional[Mesh], prefix: str = "") -> dict:
    """A block's weights whole on every tp rank, each gradient kept as the
    rank's own slice (`_GatherOwnGrad`)."""
    if mesh is None or mesh.tp_group is None:
        return block

    def full(path, leaf):
        axis = shard_axis(spec_for(prefix + path, len(leaf.shape)))
        return leaf if axis is None else _GatherOwnGrad.apply(leaf, axis, mesh)

    return _map(full, block)
