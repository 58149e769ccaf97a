"""Optimizers and LR schedules: the port of seq2squiggle_tpu/train/optimizers.py
(reference configure_optimizers, src/seq2squiggle/model.py:309-385).

The JAX package builds these from optax; the update rules here are plain
functions on tensors that mirror optax's formulas, not `torch.optim` classes,
because the two differ where it shows: optax's Adam adds `eps` (1e-7 here)
outside the square root of the bias-corrected second moment; optax clips with
`g * clip / norm` only when `norm >= clip` where torch divides by
`norm + 1e-6`; optax's rmsprop puts `eps` inside the square root. Schedules
are plain functions of the step and count from 0 as optax does, so step 0 of
a warm-up runs at lr 0.

AdaFactor is optax.adafactor at optax's defaults (factored second moments
for leaves whose two largest dimensions are both >= 128, decay 1 - t^-0.8,
eps 1e-30, updates clipped to block RMS 1, scaled by the learning rate and by
the parameter's RMS floored at 1e-3; no momentum, no weight decay: the JAX
package passes none).

An optimizer's state is a dict {"count", "mu", "nu", "sched_count"} (the keys
its chain has; AdaFactor's moments are "v_row", "v_col" and "v"), and
`state_leaves` lists it in optax's tree-flatten order (Adam: step count,
first moments, second moments, the schedule's count; moments in the
sorted-key order of the parameter tree), so a train state crosses between
the two packages.

Under tensor parallelism (`build_optimizer` given the rank's shards and the
mesh, parallel/mesh.py, which fix each leaf's tp axis and whole shape for the
run) a leaf is the rank's shard and every quantity optax
takes over a whole leaf is taken over the whole leaf: the clipping norm sums
the squares of a sharded leaf over tp and counts a replicated leaf once;
AdaFactor decides `factored_dims` on the whole shape, and a factored mean, the
update's block RMS or the parameter's RMS that runs over a sharded axis is
summed over tp. `state_leaves` gathers the sharded moments, so a train state
holds whole leaves in optax's order at any tp degree, and `restore_state`
cuts them to the rank's shards again.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.fft_model import tree_leaves
from ..parallel.mesh import gather_tensor, shard_axis, shard_tensor, spec_for, tp_sum

logger = logging.getLogger("seq2squiggle_tpu_torch")

Schedule = Callable[[int], float]
ADAM_B1, ADAM_B2 = 0.9, 0.999  # optax's defaults, which the JAX package keeps


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule (a constant `init` for steps <= 0)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine_decay(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, "
                         f"got {decay_steps=}.")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)

    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: each schedule counts from its own boundary."""

    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def _cosine_onecycle(steps: int, peak: float, pct_start: float = 0.3,
                     div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """optax.cosine_onecycle_schedule (piecewise cosine interpolation)."""
    bounds = [0, int(pct_start * steps), int(steps)]
    values = np.cumprod([peak / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])

    def schedule(count):
        if count >= bounds[-1]:
            return float(values[-1])
        for lo, hi, start, end in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
            if lo <= count < hi:
                pct = (count - lo) / (hi - lo)
                return float(end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1))
        return 0.0

    return schedule


def build_schedule(config: dict, total_steps: int) -> Schedule:
    lr = float(config["lr"])
    warmup = int(total_steps * float(config["warmup_ratio"]))
    name = config["lr_schedule"]
    total_steps = max(total_steps, warmup + 1)

    if name == "warmup_cosine":
        return _join([_linear(0.0, lr, warmup), _cosine_decay(lr, total_steps - warmup)],
                     [warmup])
    if name == "warmup_constant":
        return _join([_linear(0.0, lr, max(warmup, 1)), lambda count: lr],
                     [max(warmup, 1)])
    if name == "constant":
        return lambda count: lr
    if name == "warmup_cosine_restarts":
        # two hard-restart cosine cycles after warmup (num_cycles=2,
        # model.py:369-377)
        cycle = max((total_steps - warmup) // 2, 1)
        return _join(
            [_linear(0.0, lr, max(warmup, 1)), _cosine_decay(lr, cycle),
             _cosine_decay(lr, cycle)],
            [max(warmup, 1), max(warmup, 1) + cycle],
        )
    if name == "one_cycle":
        return _cosine_onecycle(total_steps, lr)
    raise ValueError(f"Unknown lr_schedule: {name}")


# ---------------------------------------------------------------------------
# Update rules (optax's formulas; every function works leaf by leaf, in place
# on its state, and returns the new update direction)
# ---------------------------------------------------------------------------


def _tp(axis, mesh):
    """The leaf's tp axis where a tp group runs, else None."""
    return axis if mesh is not None and mesh.tp_group is not None else None


def leaf_square_sums(tensors: Sequence[torch.Tensor], axes=None, mesh=None) -> torch.Tensor:
    """Σ x² of each whole leaf in float32: a leaf sharded over tp (its axis in
    `axes`) summed over the tp ranks, one collective for all of them."""
    sums = torch.stack([t.float().square().sum() for t in tensors])
    if axes is not None and mesh is not None and mesh.tp_group is not None:
        sharded = torch.tensor([a is not None for a in axes], device=sums.device)
        whole = tp_sum(torch.where(sharded, sums, torch.zeros_like(sums)), mesh)
        sums = torch.where(sharded, whole, sums)
    return sums


def global_norm(tensors: Sequence[torch.Tensor], axes=None, mesh=None) -> torch.Tensor:
    """sqrt(Σ x²) over all leaves in float32, summed leaf by leaf in order:
    optax.global_norm (whole leaves under tp)."""
    return torch.sqrt(sum(leaf_square_sums(tensors, axes, mesh).unbind()))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float, axes=None,
                        mesh=None) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g where norm < max_norm, else (g / norm) * max_norm."""
    norm = global_norm(grads, axes, mesh)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for g in grads]


def _update_moments(g, mu, nu, b1: float, b2: float) -> None:
    if mu is not None:
        mu.mul_(b1).add_(g, alpha=1 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1 - b2)


def adam_direction(g, mu, nu, bc1, bc2, b1=ADAM_B1, b2=ADAM_B2, eps=1e-8) -> torch.Tensor:
    """optax.scale_by_adam: moments updated in place; returns mu_hat /
    (sqrt(nu_hat) + eps), where mu_hat = mu / bc1 and nu_hat = nu / bc2 and
    bc1, bc2 are the step's bias corrections 1 - b1^count, 1 - b2^count
    (0-dim tensors, `Optimizer.advance`)."""
    _update_moments(g, mu, nu, b1, b2)
    mu_hat = mu / bc1
    nu_hat = nu / bc2
    return mu_hat / (nu_hat.sqrt() + eps)


def radam_rectifier(count: int, b2=ADAM_B2, threshold=5.0) -> Optional[float]:
    """optax.scale_by_radam's rectification r after `count` updates, or None
    while the variance of the adaptive rate is intractable (ro < threshold)."""
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    b2t = b2 ** count
    ro = ro_inf - 2 * count * b2t / (1 - b2t)
    if ro < threshold:
        return None
    return math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))


def radam_direction(g, mu, nu, bc1, bc2, r, b1=ADAM_B1, b2=ADAM_B2, eps=1e-8) -> torch.Tensor:
    """optax.scale_by_radam: the rectified Adam step r * mu_hat / (sqrt(nu_hat)
    + eps) where `radam_rectifier` gives an r, else (r None) bias-corrected
    momentum mu_hat; bc1, bc2 and r are 0-dim tensors as in adam_direction."""
    _update_moments(g, mu, nu, b1, b2)
    mu_hat = mu / bc1
    if r is None:
        return mu_hat
    nu_hat = nu / bc2
    return r * mu_hat / (nu_hat.sqrt() + eps)


def rms_direction(g, nu, decay=0.9, eps=1e-8) -> torch.Tensor:
    """optax.scale_by_rms: g * rsqrt(nu + eps), eps inside the root."""
    _update_moments(g, None, nu, 0.0, decay)
    return g * torch.rsqrt(nu + eps)


def factored_dims(shape: Sequence[int], min_dim_size: int = 128):
    """optax's _factored_dims: (d1, d0), the axes of the second-largest and
    the largest dimension, where both are >= min_dim_size; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size:
        return None
    return int(order[-2]), int(order[-1])


def _adafactor_moment_shape(moment: str, shape: Sequence[int]):
    """The shape optax.scale_by_factored_rms gives a leaf's v_row, v_col or
    v: the factored vectors for a factored leaf, the full second moment for
    any other, and (1,) placeholders for the moments a leaf does not use."""
    dims = factored_dims(shape)
    if dims is None:
        return tuple(shape) if moment == "v" else (1,)
    if moment == "v":
        return (1,)
    drop = dims[1] if moment == "v_row" else dims[0]
    return tuple(n for i, n in enumerate(shape) if i != drop)


def _drop_axis(axis, dropped: int):
    """Where axis `axis` lands once axis `dropped` is reduced away."""
    if axis is None or axis == dropped:
        return None
    return axis - (axis > dropped)


def _adafactor_moment_axis(moment: str, shape: Sequence[int], axis):
    """The tp axis of a leaf's v_row, v_col or v (shape: the whole leaf's)."""
    dims = factored_dims(shape)
    if dims is None:
        return axis if moment == "v" else None
    if moment == "v":
        return None
    return _drop_axis(axis, dims[1] if moment == "v_row" else dims[0])


def _whole_shape(shape: Sequence[int], axis, mesh) -> tuple:
    shape = list(shape)
    if axis is not None:
        shape[axis] *= mesh.n_tp
    return tuple(shape)


def _mean(t: torch.Tensor, dim, sharded: bool, mesh, keepdim: bool = False) -> torch.Tensor:
    """t.mean(dim), dim=None for all; over the whole leaf where `sharded`
    (the sum over tp, divided by the whole count)."""
    if not sharded:
        return t.mean() if dim is None else t.mean(dim=dim, keepdim=keepdim)
    if dim is None:
        return tp_sum(t.sum(), mesh) / (t.numel() * mesh.n_tp)
    return tp_sum(t.sum(dim=dim, keepdim=keepdim), mesh) / (t.shape[dim] * mesh.n_tp)


def adafactor_decay(count: int, decay_rate: float = 0.8) -> float:
    """optax's _decay_rate_pow at step `count` (0 for the first update),
    1 - (count + 1)^-0.8, evaluated in float32 as optax does."""
    t = torch.tensor(count + 1, dtype=torch.float32)
    return float(1.0 - t ** -decay_rate)


def adafactor_direction(g, v_row, v_col, v, decay, fresh, eps: float = 1e-30,
                        axis=None, mesh=None) -> torch.Tensor:
    """optax.scale_by_factored_rms then clip_by_block_rms(1.0), with the
    step's `decay` (adafactor_decay) and `fresh` = 1 - decay, taken in double
    before its rounding to float32 (0-dim tensors, `Optimizer.advance`); the
    moments are updated in place. g is the rank's shard of a leaf sharded
    over tp on `axis` (None: whole)."""
    axis = _tp(axis, mesh)
    g2 = g * g + eps
    dims = factored_dims(_whole_shape(g.shape, axis, mesh))
    if dims is not None:
        d1, d0 = dims
        v_row.copy_(decay * v_row + fresh * _mean(g2, d0, axis == d0, mesh))
        v_col.copy_(decay * v_col + fresh * _mean(g2, d1, axis == d1, mesh))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_mean = _mean(v_row, reduced_d1, _drop_axis(axis, d0) == reduced_d1, mesh,
                         keepdim=True)
        row_factor = (v_row / row_mean) ** -0.5
        u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
    else:
        v.copy_(decay * v + fresh * g2)
        u = g * v ** -0.5
    return u / torch.clamp(_mean(u.square(), None, axis is not None, mesh).sqrt(), min=1.0)


def param_block_rms(p: torch.Tensor, min_scale: float = 1e-3, axis=None,
                    mesh=None) -> torch.Tensor:
    """optax's safe_root_mean_squares(p, min_scale): the leaf's RMS, floored."""
    sharded = _tp(axis, mesh) is not None
    return torch.clamp(_mean(p.detach().square(), None, sharded, mesh).sqrt(), min=min_scale)


class Optimizer:
    """clip -> weight decay -> direction -> -lr(step), as the JAX package
    chains optax transformations. `update` changes parameters and state in
    place (the JAX package donates both to its jitted step).

    An update has two halves. `advance` is the host's: it moves the state's
    counts (Python ints) on and writes the step's scalars (the learning
    rate, Adam's bias corrections, RAdam's rectification, AdaFactor's
    decay), computed in double as optax's Python schedule is, into 0-dim
    float32 tensors on the leaves' device with `fill_`, a value handed to a
    kernel and no copy from host memory. The rest of `update` is the
    device's: every operation reads those tensors and no Python number that
    changes from step to step, so a CUDA graph captured around it
    (train/loop.py) replays the right step after each `advance`. It divides
    by the bias corrections as optax does. `update` runs `advance` first
    unless its caller has run it for this update, as the train step does
    before each call and each replay. `graph_key` is what a captured update
    depends on beyond the scalars' values."""

    _MOMENTS = {"Adam": ("mu", "nu"), "AdamW": ("mu", "nu"), "RAdam": ("mu", "nu"),
                "SGD": (), "RMSProp": ("nu",), "AdaFactor": ("v_row", "v_col", "v")}
    _COUNTED = ("Adam", "AdamW", "RAdam", "AdaFactor")  # a step count leads the state

    def __init__(self, name: str, schedule: Schedule, weight_decay: float, clip: float,
                 mesh=None, axes: Optional[Sequence] = None,
                 shapes: Optional[Sequence] = None):
        """Under a tp mesh, `axes` gives each leaf's tp axis (None: replicated)
        and `shapes` each whole leaf's shape, in tree_leaves order; without
        one the leaves are whole."""
        if name not in self._MOMENTS:
            raise ValueError(f"Unknown optimizer: {name}")
        self.name = name
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip = clip
        tp = mesh is not None and mesh.tp_group is not None
        self.mesh = mesh if tp else None
        self.axes = list(axes) if tp else None
        self._whole = [tuple(s) for s in shapes] if tp else None
        self._scalars: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self._rectified: Optional[bool] = None  # RAdam's branch at the last advance
        self._advanced = False  # an `advance` that no `update` has taken up yet

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        """The fresh state for `params` (the rank's shards under tp)."""
        whole = self._whole or [tuple(p.shape) for p in params]
        state: Dict = {m: [torch.zeros(self._local_shape(m, i, whole[i]), dtype=torch.float32,
                                       device=p.device) for i, p in enumerate(params)]
                       for m in self._MOMENTS[self.name]}
        if self.name in self._COUNTED:
            state["count"] = 0
        state["sched_count"] = 0
        return state

    def _axis(self, i: int):
        """Leaf i's tp axis (None: replicated or no tp)."""
        return None if self.axes is None else self.axes[i]

    def _moment_axis(self, m: str, i: int):
        """The tp axis of leaf i's moment m (None: replicated or no tp)."""
        if self.axes is None:
            return None
        if self.name == "AdaFactor":
            return _adafactor_moment_axis(m, self._whole[i], self.axes[i])
        return self.axes[i]

    def _local_shape(self, m: str, i: int, whole: tuple) -> tuple:
        if self.name == "AdaFactor":
            whole = _adafactor_moment_shape(m, whole)
        axis = self._moment_axis(m, i)
        return tuple(n // self.mesh.n_tp if d == axis else n for d, n in enumerate(whole))

    def advance(self, state: Dict, device: torch.device) -> None:
        """The host's half of an update: the counts move on, and the step's
        scalars are written to their tensors on `device`."""
        lr = self.schedule(state["sched_count"])
        state["sched_count"] += 1
        if "count" in state:
            state["count"] += 1
        if self.name == "AdaFactor":  # lr, then the parameter's scale, then the sign
            decay = adafactor_decay(state["count"] - 1)
            values = {"lr": lr, "decay": decay, "fresh": 1.0 - decay}
        else:
            values = {"neg_lr": -lr}
        if self.name in ("Adam", "AdamW", "RAdam"):
            values.update(bc1=1 - ADAM_B1 ** state["count"], bc2=1 - ADAM_B2 ** state["count"])
        if self.name == "RAdam":
            r = radam_rectifier(state["count"])
            self._rectified = r is not None
            if r is not None:
                values["r"] = r
        scalars = self._scalars.setdefault(device, {})
        for name, value in values.items():
            if name not in scalars:
                scalars[name] = torch.zeros((), dtype=torch.float32, device=device)
            scalars[name].fill_(value)
        self._advanced = True

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: Dict,
               params: Sequence[torch.Tensor]) -> None:
        """One update: `advance`, unless the caller has run it for this
        update, then the device's half with the scalars it wrote."""
        if not self._advanced:
            self.advance(state, params[0].device)
        self._advanced = False
        name, wd, mesh = self.name, self.weight_decay, self.mesh
        sc = self._scalars[params[0].device]
        if self.clip > 0:
            grads = clip_by_global_norm(grads, self.clip, self.axes, mesh)
        if wd and name not in ("AdamW", "AdaFactor"):  # L2 on the gradient, as torch's Adam
            grads = [g + wd * p for g, p in zip(grads, params)]
        for i, (g, p) in enumerate(zip(grads, params)):
            if name == "AdaFactor":
                u = adafactor_direction(g, state["v_row"][i], state["v_col"][i], state["v"][i],
                                        sc["decay"], sc["fresh"], axis=self._axis(i), mesh=mesh)
                p.sub_((sc["lr"] * u) * param_block_rms(p, axis=self._axis(i), mesh=mesh))
                continue
            if name in ("Adam", "AdamW"):
                u = adam_direction(g, state["mu"][i], state["nu"][i], sc["bc1"], sc["bc2"],
                                   eps=1e-7)
                if name == "AdamW":
                    u = u + wd * p
            elif name == "RAdam":
                u = radam_direction(g, state["mu"][i], state["nu"][i], sc["bc1"], sc["bc2"],
                                    sc["r"] if self._rectified else None)
            elif name == "RMSProp":
                u = rms_direction(g, state["nu"][i])
            else:  # SGD
                u = g
            p.add_(u * sc["neg_lr"])

    def graph_key(self, state: Dict) -> tuple:
        """What a captured update of `state` holds fixed besides the
        scalars' values: the rule, RAdam's branch at the last `advance` and
        the moments' storage."""
        return (self.name, self._rectified,
                tuple(t.data_ptr() for m in self._MOMENTS[self.name] for t in state[m]))

    def state_leaves(self, state: Dict) -> List[np.ndarray]:
        """The state as optax's tree_leaves would list it, whole leaves: a
        moment sharded over tp is gathered (a collective under tp, so every
        rank of a dp row calls this)."""
        leaves: List[np.ndarray] = []
        if "count" in state:
            leaves.append(np.asarray(state["count"], np.int32))
        for m in self._MOMENTS[self.name]:
            leaves.extend(gather_tensor(t.detach(), self._moment_axis(m, i), self.mesh)
                          .cpu().numpy() for i, t in enumerate(state[m]))
        leaves.append(np.asarray(state["sched_count"], np.int32))
        return leaves

    def restore_state(self, fresh: Dict, saved_leaves: Sequence[np.ndarray]) -> Dict:
        """The JAX package's train/loop.py::restore_opt_state: graft saved leaf
        values (whole leaves) onto a freshly initialised state, checking the
        leaf count and every shape so that a config or optimizer mismatch
        fails loudly instead of mis-assigning moments; a moment sharded over
        tp keeps the rank's slice."""
        want: list = [()] if "count" in fresh else []
        for m in self._MOMENTS[self.name]:
            want.extend(_whole_shape(t.shape, self._moment_axis(m, i), self.mesh)
                        for i, t in enumerate(fresh[m]))
        want.append(())
        if len(want) != len(saved_leaves):
            raise ValueError(
                f"train_state has {len(saved_leaves)} optimizer leaves but the "
                f"current optimizer expects {len(want)} — optimizer config "
                "changed since the state was saved; restart without --resume.")
        for i, (ref, new) in enumerate(zip(want, saved_leaves)):
            if tuple(ref) != tuple(np.shape(new)):
                raise ValueError(
                    f"train_state optimizer leaf {i} has shape {np.shape(new)} but "
                    f"the current optimizer expects {tuple(ref)} — "
                    "model/optimizer config changed; restart without --resume.")
        it = iter(saved_leaves)
        out: Dict = {}
        if "count" in fresh:
            out["count"] = int(next(it))
        for m in self._MOMENTS[self.name]:
            out[m] = [shard_tensor(torch.from_numpy(np.array(next(it), np.float32)),
                                   self._moment_axis(m, i), self.mesh)
                      .contiguous().to(t.device) for i, t in enumerate(fresh[m])]
        out["sched_count"] = int(next(it))
        return out


def leaf_axes(params: dict) -> list:
    """Each leaf's tp axis under `param_shardings` (None: replicated), in
    tree_leaves order."""
    return [shard_axis(spec_for("/".join(p), v.dim())) for p, v in tree_leaves(params)]


def build_optimizer(config: dict, total_steps: int, params: Optional[dict] = None,
                    mesh=None) -> Optimizer:
    """The run's optimizer. Under a tp mesh, `params` (the rank's shards)
    fixes each leaf's tp axis and whole shape."""
    axes = shapes = None
    if mesh is not None and mesh.tp_group is not None:
        axes = leaf_axes(params)
        shapes = [_whole_shape(v.shape, a, mesh) for (_, v), a in zip(tree_leaves(params), axes)]
    return Optimizer(config["optimizer"], build_schedule(config, total_steps),
                     float(config.get("weight_decay", 0.0)),
                     float(config.get("gradient_clip_val") or 0.0), mesh, axes, shapes)
