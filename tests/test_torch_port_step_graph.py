"""The train step as a CUDA graph (train/loop.py::TrainStep) and what makes
it capturable: the optimizer's per-step scalars as device tensors
(train/optimizers.py, `Optimizer.advance` and `update`) and the dropout's
divisor held on the device (ops/attention.py::_maybe_dropout).

Bars, on the CPU:
  - every optimizer under every schedule, over 30 steps that cross the
    warm-up's end: parameters and state bit-equal, step by step, to the
    update that took its scalars as Python numbers, kept here as it was,
    whether `update` runs its own `advance` or the caller ran it first;
  - `_maybe_dropout` bit-equal to its formula with the divisor built per
    call by `torch.tensor`, in float32 and bfloat16;
  - on CPU tensors the step never captures: every call an eager step, no
    `train.graph_*` count, and each call bit-equal to `TrainStep.eager` on a
    copy of the state.
On the card (`gpu`, `chip_smoke.py` phase 20's bars): for each of its
runs (rung, dtype, optimizer, schedule), 9 steps through the graph (eager,
capture, replays, then a batch of half the rows, which captures again, as
does RAdam where its branch flips) and the same 9 through `eager` on a
copy, parameters, the optimizer's state and every metric bit-equal, the
wrappers' counts on the steps the host issued and a replayed step's
kernels from a profile; and the default Adam on the card, dividing by its
device scalars, at least as close to the CPU's update as the update with
Python numbers was.
"""

import torch_port_threads  # noqa: F401  (torch's threads: one share of the cores a worker)

import copy

import numpy as np
import pytest
import torch

from seq2squiggle_tpu_torch import prng, tracing
from seq2squiggle_tpu_torch.config import load_config
from seq2squiggle_tpu_torch.models import fft_model as tmodel
from seq2squiggle_tpu_torch.ops import attention as tattention
from seq2squiggle_tpu_torch.ops import threefry as tthreefry
from seq2squiggle_tpu_torch.train import loop as tloop
from seq2squiggle_tpu_torch.train import optimizers as topt

OPTIMIZERS = ("Adam", "AdamW", "RAdam", "SGD", "RMSProp", "AdaFactor")
SCHEDULES = ("warmup_cosine", "warmup_constant", "constant", "warmup_cosine_restarts",
             "one_cycle")
STEPS = 30
# a factored AdaFactor leaf (both of its largest dimensions >= 128), a matrix,
# a vector and a scalar-like leaf
SHAPES = ((130, 136), (64, 256), (64,), (1,))


@pytest.fixture
def recorder(monkeypatch):
    """The span recorder on and empty; both restored afterwards."""
    monkeypatch.setenv(tracing.ENV, "1")
    tracing.switch_from_env()
    tracing.reset()
    yield tracing
    monkeypatch.delenv(tracing.ENV, raising=False)
    tracing.switch_from_env()
    tracing.reset()


# ---- the update as it was, its scalars Python numbers ----

def _python_adafactor_direction(g, v_row, v_col, v, decay, eps=1e-30):
    g2 = g * g + eps
    dims = topt.factored_dims(g.shape)
    if dims is not None:
        d1, d0 = dims
        v_row.copy_(decay * v_row + (1.0 - decay) * g2.mean(dim=d0))
        v_col.copy_(decay * v_col + (1.0 - decay) * g2.mean(dim=d1))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
        u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
    else:
        v.copy_(decay * v + (1.0 - decay) * g2)
        u = g * v ** -0.5
    return u / torch.clamp(u.square().mean().sqrt(), min=1.0)


def _python_adam_moments(g, mu, nu, b1=0.9, b2=0.999):
    mu.mul_(b1).add_(g, alpha=1 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1 - b2)


@torch.no_grad()
def _python_update(opt, grads, state, params):
    """Optimizer.update before its scalars were device tensors."""
    name, wd = opt.name, opt.weight_decay
    if opt.clip > 0:
        grads = topt.clip_by_global_norm(grads, opt.clip)
    if wd and name not in ("AdamW", "AdaFactor"):
        grads = [g + wd * p for g, p in zip(grads, params)]
    lr = opt.schedule(state["sched_count"])
    state["sched_count"] += 1
    if "count" in state:
        state["count"] += 1
    count = state.get("count")
    if name == "AdaFactor":
        decay = topt.adafactor_decay(count - 1)
    for i, (g, p) in enumerate(zip(grads, params)):
        if name == "AdaFactor":
            u = _python_adafactor_direction(g, state["v_row"][i], state["v_col"][i],
                                            state["v"][i], decay)
            p.sub_((lr * u) * topt.param_block_rms(p))
            continue
        if name in ("Adam", "AdamW", "RAdam"):
            mu, nu = state["mu"][i], state["nu"][i]
            _python_adam_moments(g, mu, nu)
            mu_hat = mu / (1 - 0.9 ** count)
        if name in ("Adam", "AdamW"):
            nu_hat = nu / (1 - 0.999 ** count)
            u = mu_hat / (nu_hat.sqrt() + 1e-7)
            if name == "AdamW":
                u = u + wd * p
        elif name == "RAdam":
            ro_inf = 2.0 / (1.0 - 0.999) - 1.0
            b2t = 0.999 ** count
            ro = ro_inf - 2 * count * b2t / (1 - b2t)
            if ro < 5.0:
                u = mu_hat
            else:
                r = np.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                            / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                u = float(r) * mu_hat / ((nu / (1 - b2t)).sqrt() + 1e-8)
        elif name == "RMSProp":
            state["nu"][i].mul_(0.9).addcmul_(g, g, value=1 - 0.9)
            u = g * torch.rsqrt(state["nu"][i] + 1e-8)
        else:
            u = g
        p.add_(u * -lr)


@pytest.mark.parametrize("advanced", [False, True], ids=["update", "advance-update"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_update_with_device_scalars_is_the_python_scalars_update(name, schedule, advanced):
    config = {"lr": 3e-3, "warmup_ratio": 0.1, "lr_schedule": schedule}
    warmup = int(STEPS * config["warmup_ratio"])
    assert 0 < warmup < STEPS  # the steps cross the warm-up's end
    opt = topt.Optimizer(name, topt.build_schedule(config, STEPS),
                         weight_decay=0.01, clip=1.0)
    rng = np.random.default_rng(11)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in SHAPES]
    ref_params = [p.clone() for p in params]
    state = opt.init(params)
    ref_state = copy.deepcopy(state)
    for step in range(STEPS):
        scale = (0.002, 0.5, 0.03)[step % 3]  # gradient norms on both sides of the clip
        grads = [torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
                 for s in SHAPES]
        if advanced:
            opt.advance(state, params[0].device)
        opt.update(grads, state, params)
        _python_update(opt, grads, ref_state, ref_params)
        assert state["count" if "count" in state else "sched_count"] == step + 1
        for i, (a, b) in enumerate(zip(params, ref_params)):
            assert torch.equal(a, b), f"step {step}: leaf {i} differs"
        for a, b in zip(opt.state_leaves(state), opt.state_leaves(ref_state)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.2])
def test_maybe_dropout_is_its_formula_with_a_per_call_divisor(dtype, rate):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 37, 64))
                         .astype(np.float32)).to(dtype)
    key, keep = prng.key(9), 1.0 - rate
    mask = tattention.dropout_mask(key, keep, x.shape)
    keep_cd = torch.tensor(keep, dtype=x.dtype, device=x.device).float()
    want = torch.where(mask, (x.float() / keep_cd).to(x.dtype), torch.zeros_like(x))
    got = tattention._maybe_dropout(x, rate, key)
    assert got.dtype == dtype and torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                                       else torch.int32),
                                              want.view(torch.int16 if dtype == torch.bfloat16
                                                        else torch.int32))


def _cpu_batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    K, T = cfg["max_dna_len"], cfg["max_signal_len"]
    batch = {
        "chunks": np.eye(5, dtype=np.float32)[rng.integers(0, 5, (B, K, cfg["seq_kmer"]))],
        "targets": rng.random((B, T, 1)).astype(np.float32),
        "chunks_lengths": rng.integers(1, 3, (B, K)).astype(np.int32),
        "stdevs": (rng.random((B, K)) * 0.1).astype(np.float32),
    }
    return {k: torch.from_numpy(v) for k, v in batch.items()}, torch.ones(B)


def test_cpu_step_never_captures_and_is_its_eager_body(recorder):
    cfg = dict(load_config(None), compute_dtype="float32", max_signal_len=40,
               encoder_layers=1, decoder_layers=1)
    host = tmodel.init_params(cfg, prng.key(2))
    runs = []
    for graphed in (True, False):
        params = tmodel.to_train_params(host, torch.device("cpu"))
        opt = topt.build_optimizer(cfg, 10)
        state = opt.init([v for _, v in tmodel.tree_leaves(params)])
        step = tloop.make_train_step(cfg, opt)
        tracing.reset()
        launches = tthreefry.launches
        metrics = [(step if graphed else step.eager)(params, state, *_cpu_batch(cfg, 3, i),
                                                     prng.fold_in(prng.key(5), i))
                   for i in range(3)]
        counts = tracing.totals().counts
        assert counts["train.eager_steps"] == 3 and tthreefry.launches == launches
        assert not [k for k in counts if k.startswith("train.graph_")]
        runs.append((params, state, metrics))
    (p1, s1, m1), (p2, s2, m2) = runs
    for (_, a), (_, b) in zip(tmodel.tree_leaves(p1), tmodel.tree_leaves(p2)):
        assert torch.equal(a, b)
    for a, b in zip(s1["mu"] + s1["nu"], s2["mu"] + s2["nu"]):
        assert torch.equal(a, b)
    for a, b in zip(m1, m2):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ---- on the card ----

@pytest.mark.gpu
@pytest.mark.parametrize("mode,dtype,optimizer,schedule", [
    ("block", "bfloat16", "Adam", "warmup_cosine"),
    ("core", "bfloat16", "Adam", "warmup_cosine"),
    (False, "bfloat16", "Adam", "warmup_cosine"),
    ("block", "float32", "Adam", "warmup_cosine"),
    (False, "float32", "Adam", "warmup_cosine"),
    ("block", "bfloat16", "AdamW", "one_cycle"),
    ("block", "bfloat16", "RAdam", "constant"),
    ("block", "bfloat16", "SGD", "warmup_constant"),
    ("block", "bfloat16", "RMSProp", "warmup_cosine_restarts"),
    ("block", "bfloat16", "AdaFactor", "warmup_cosine"),
])
def test_graphed_steps_are_the_eager_steps(mode, dtype, optimizer, schedule):
    """chip_smoke.py phase 20's bars for one of its runs: parameters, state
    and metrics bit-equal, one capture a graph key, the counters on the
    steps the host issued, a replayed step's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    got = chip_smoke.hold_graphed_step(torch.device("cuda"), mode, dtype, optimizer, schedule)
    # RAdam's branch flips at its 6th update, on the last step at the first shape
    want = (3, 2, 6) if optimizer == "RAdam" else (2, 2, 7)
    assert got["schedule"] == want


@pytest.mark.gpu
def test_adam_on_the_card_divides_at_least_as_closely():
    """chip_smoke.py phase 20's bar on the default Adam's division."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    got = chip_smoke.hold_adam_division(torch.device("cuda"))
    assert sum(got["card"]["differ"]) <= sum(got["card_old"]["differ"])
