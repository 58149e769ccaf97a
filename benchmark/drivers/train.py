"""Training traffic: the user's loop one layer below `train_run`.

Set-up writes the chunk files from the seed (the traffic file's model of a
pore, `events`), loads the initial parameters from the configuration's
weights file (a fitted model: from there each row's residual, not their
mean, makes the gradient, so a step that drops rows shows in its loss), and
builds one training step (parameters, optimizer state, `make_train_step`).
It then drives that object through its first `checked_steps` steps by the
window's own call and feed (the outputs check replays them), and hands the
same object to the window: batches from `train/data.py` (`ChunkDataset`,
`epoch_batches`, shuffled, one epoch after another), placed as `train_run`
places them (pinned, non-blocking), the step's key `fold_in(key, step)`
derived as `train_run` derives it (the program's threefry kernel, one
launch on a card), a host read of the metrics every `metrics_every` steps.
The window ends with a synchronize.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict

import numpy as np
import torch

from ..harness import synth
from ..reference.model import load_weights


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.traffic = ctx.traffic
        self.cfg = ctx.program_config
        self.work = ctx.workdir

    def _place(self, batch, mask):
        dev = self.ctx.device

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if dev.type == "cuda":
                t = t.pin_memory()
            return t.to(dev, non_blocking=True)

        return {k: put(v) for k, v in batch.items()}, put(mask)

    def _next(self):
        from seq2squiggle_tpu_torch.train.data import epoch_batches

        while True:
            try:
                return next(self.batches)
            except StopIteration:
                self.batches = epoch_batches(self.dataset, self.batch_size, self.rng,
                                             shuffle=bool(self.traffic["shuffle"]))

    def _step(self):
        from seq2squiggle_tpu_torch.ops import threefry

        t0 = time.perf_counter()
        host_batch, host_mask = self._next()
        batch, mask = self._place(host_batch, host_mask)
        self.data_s += time.perf_counter() - t0
        metrics = self.step_fn(self.params, self.opt_state, batch, mask,
                               threefry.fold_in(self.key, self.step))
        if self.step % int(self.traffic["metrics_every"]) == 0:
            host = {k: float(v) for k, v in metrics.items()}
            if not math.isfinite(host["total_loss"]):
                self.failed += 1
        self.step += 1
        self.chunks += int(host_mask.sum())
        return host_batch, host_mask, metrics

    def setup(self):
        from seq2squiggle_tpu_torch import prng
        from seq2squiggle_tpu_torch.models.fft_model import to_train_params, tree_leaves
        from seq2squiggle_tpu_torch.train.data import ChunkDataset, epoch_batches
        from seq2squiggle_tpu_torch.train.loop import make_train_step
        from seq2squiggle_tpu_torch.train.optimizers import build_optimizer

        t = self.traffic
        dev = self.ctx.device
        made = synth.write_chunk_files(os.path.join(self.work, "chunks"), self.ctx.seed,
                                       int(t["chunks"]), int(t["files"]), self.cfg, t["events"])
        self.bytes_written = made["bytes"]
        self.dataset = ChunkDataset(made["files"], int(self.cfg["max_chunks_train"]), self.cfg)
        self.batch_size = int(t["batch"])
        steps_per_epoch = max(1, -(-len(self.dataset) // self.batch_size))
        self.total_steps = steps_per_epoch * int(self.cfg["max_epochs"])
        init = load_weights(self.ctx.weights, dev)
        self.init_host = {k: v.cpu() for k, v in init.items()}
        self.params = to_train_params(synth.nest(init), dev)
        del init
        leaves = [v for _, v in tree_leaves(self.params)]
        self.optimizer = build_optimizer(self.cfg, self.total_steps, self.params)
        self.opt_state = self.optimizer.init(leaves)
        self.step_fn = make_train_step(self.cfg, self.optimizer)
        self.rng = np.random.default_rng(self.ctx.seed)
        self.batches = epoch_batches(self.dataset, self.batch_size, self.rng,
                                     shuffle=bool(t["shuffle"]))
        self.key = prng.key(self.ctx.seed, dev)
        self.step = self.chunks = self.failed = 0
        self.data_s = 0.0
        # the checked steps: the window's call and feed, recorded for the check
        self.checked, self.losses = [], []
        for i in range(int(t["checked_steps"])):
            hb, hm, metrics = self._step()
            self.checked.append((hb, hm))
            self.losses.append(float(metrics["total_loss"]))
            if i == 0:  # Adam's first moment after one update is 0.1 x the clipped gradient
                self.grad0 = {"/".join(p): m.detach().cpu() / 0.1 for (p, _), m in
                              zip(tree_leaves(self.params), self.opt_state["mu"])}
        self.after = {k: v.detach().cpu().clone() for k, v in synth.flatten(self.params).items()}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def window(self, seconds: float, trace: bool) -> Dict:
        from ..harness.trace import Traced

        dev = self.ctx.device
        first = self.step
        self.chunks = 0
        self.data_s = 0.0
        summary = None
        traced = int(self.traffic["traced_steps"]) if trace else 0
        traced_wall = 0.0  # the traced steps and the trace's reduction
        pending = bool(traced)
        t0 = time.perf_counter()
        while self.step == first or time.perf_counter() - t0 < seconds or pending:
            if pending and self.step - first >= int(self.traffic["traced_after_steps"]):
                pending = False
                tt, data_s = time.perf_counter(), self.data_s
                with Traced(dev) as tr:
                    for _ in range(traced):
                        self._step()
                summary = tr.summary
                summary["steps"] = traced
                traced_wall = time.perf_counter() - tt
                self.data_s = data_s  # the profiler slows the data layer too
                continue
            self._step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        steps = self.step - first
        return {"wall_s": wall, "steps": steps, "chunks": self.chunks, "trace": summary,
                "untraced_steps": steps - (traced if summary else 0),
                "traced_wall_s": traced_wall, "data_s": self.data_s,
                "attempted": steps, "failed": self.failed,
                "e2e": {"train_chunks_per_s": self.chunks / wall}}

    def release(self):
        for name in ("params", "opt_state", "step_fn", "optimizer", "batches", "dataset"):
            self.__dict__.pop(name, None)

    def check(self, control: str = "", fault: str = "", detail: bool = False) -> Dict[str, float]:
        """The checked steps against the reference's. `control` names a
        precision (model.PRECISIONS) and `fault` a fault (train_ref.FAULTS),
        at or with which the reference is put in the program's place."""
        from ..harness import judge_train
        from ..reference import model, threefry, train_ref

        dev = self.ctx.device
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        P0 = {k: v.to(dev) for k, v in self.init_host.items()}
        batches = [({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in b.items()},
                    torch.from_numpy(m).to(dev)) for b, m in self.checked]
        key = threefry.key(self.ctx.seed, dev)

        def replay(precision="float32", fault=""):
            losses, g0, after = train_ref.run_steps(P0, batches, self.cfg, self.total_steps, key,
                                                    q=model.PRECISIONS[precision], fault=fault)
            return (losses, {k: v.cpu() for k, v in g0.items()},
                    {k: v.cpu() for k, v in after.items()})

        ref, ref_cd = replay(), replay(str(self.cfg["compute_dtype"]))
        if control or fault:
            prog = replay(control or "float32", fault)
        else:
            prog = (self.losses, self.grad0, self.after)
        return judge_train.compare(prog, ref, ref_cd, self.init_host, detail)
