"""Hyperparameter sweeps: the port's copy of seq2squiggle_tpu/train/sweep.py,
whose trials run the port's train_run on an explicit torch device.

The reference runs a wandb sweep agent (src/seq2squiggle/train_sweep.py:
15-46, search space configs/sweep.yaml). When wandb is available and
sweep_id looks like 'user/project/id', we do the same. Otherwise sweep_id
is a local YAML search-space file (same wandb sweep format: parameters with
`values` or `min`/`max`) and we run an offline search, tracking the best
trial by valid_total_loss in <outdir>/sweep_results.jsonl.

Offline search methods (top-level `method:` key in the YAML):
  random   — uniform/log-uniform sampling from the space (default)
  grid     — cartesian product of every parameter's `values` (discrete
             specs only), capped at --count points
  halving  — successive halving: --count random configs start at
             `min_epochs` (default 1), the best 1/`eta` (default 3)
             advance to an eta× epoch budget each rung until one
             survives (budgets capped at the config's max_epochs)
  bayes    — wandb-`method: bayes` analogue: Gaussian-process surrogate
             (sklearn, Matern kernel) over unit-cube-encoded params,
             expected-improvement acquisition maximised over random
             candidates; the first few trials (and the sklearn-less
             fallback) are random
"""

from __future__ import annotations

import json
import logging
import os
import random
from typing import Optional

import torch
import yaml

logger = logging.getLogger("seq2squiggle_tpu_torch")


def _sample_param(spec, rng: random.Random):
    if isinstance(spec, dict):
        if "values" in spec:
            return rng.choice(spec["values"])
        if "min" in spec and "max" in spec:
            lo, hi = spec["min"], spec["max"]
            if spec.get("distribution", "").startswith("log"):
                import math

                return math.exp(rng.uniform(math.log(lo), math.log(hi)))
            if isinstance(lo, int) and isinstance(hi, int):
                return rng.randint(lo, hi)
            return rng.uniform(lo, hi)
        if "value" in spec:
            return spec["value"]
    return spec


def _bayes_encoding(parameters: dict):
    """Unit-cube encoding of the search space for the GP surrogate.

    Returns (dims, decode) where dims is a list of (key, kind, payload)
    for every FREE parameter — kind 'values' (ordinal over the list) or
    'range' (linear or log min/max) — and decode maps a [0,1]^d point
    back to a {key: value} trial dict (fixed `value:` params included).
    Ordinal treatment of `values` lists is an offline approximation of
    wandb's categorical handling; the lists here are ordered magnitudes
    (lr grids, layer widths), where ordinal distance is meaningful.
    """
    import math

    dims, fixed = [], {}
    for k, spec in parameters.items():
        if not isinstance(spec, dict):
            fixed[k] = spec
        elif "values" in spec:
            vals = list(spec["values"])
            if len(vals) == 1:
                fixed[k] = vals[0]
            else:
                dims.append((k, "values", vals))
        elif "min" in spec and "max" in spec:
            lo, hi = spec["min"], spec["max"]
            log = str(spec.get("distribution", "")).startswith("log")
            if log:
                lo_t, hi_t = math.log(lo), math.log(hi)
            else:
                lo_t, hi_t = float(lo), float(hi)
            is_int = (not log and isinstance(lo, int) and isinstance(hi, int))
            dims.append((k, "range", (lo_t, hi_t, log, is_int)))
        elif "value" in spec:
            fixed[k] = spec["value"]

    def decode(u):
        import math

        out = dict(fixed)
        for x, (k, kind, payload) in zip(u, dims):
            x = min(max(float(x), 0.0), 1.0)
            if kind == "values":
                vals = payload
                out[k] = vals[min(int(x * len(vals)), len(vals) - 1)]
            else:
                lo_t, hi_t, log, is_int = payload
                v = lo_t + x * (hi_t - lo_t)
                if log:
                    v = math.exp(v)
                out[k] = int(round(v)) if is_int else v
        return out

    return dims, decode


def _bayes_propose(X, y, n_dims, rng: random.Random, n_candidates=256):
    """Expected-improvement argmax over random unit-cube candidates,
    using a GP surrogate fit on the observed (X, y). Returns a point in
    [0,1]^d, or a random one when the GP cannot be fit."""
    import numpy as np

    cands = [[rng.random() for _ in range(n_dims)]
             for _ in range(n_candidates)]
    try:
        from sklearn.gaussian_process import GaussianProcessRegressor
        from sklearn.gaussian_process.kernels import Matern

        gp = GaussianProcessRegressor(
            kernel=Matern(nu=2.5), normalize_y=True, alpha=1e-6,
            random_state=rng.randrange(2**31))
        gp.fit(np.asarray(X, float), np.asarray(y, float))
        mu, sigma = gp.predict(np.asarray(cands, float), return_std=True)
    except Exception as exc:  # sklearn absent or degenerate fit
        logger.debug(f"bayes surrogate unavailable ({exc}); random point")
        return cands[0]
    best = min(y)
    sigma = np.maximum(sigma, 1e-12)
    z = (best - mu) / sigma
    # EI for minimisation: (best-mu)*Phi(z) + sigma*phi(z)
    from math import erf, exp, pi, sqrt

    phi = np.array([exp(-0.5 * v * v) / sqrt(2 * pi) for v in z])
    Phi = np.array([0.5 * (1 + erf(v / sqrt(2))) for v in z])
    ei = (best - mu) * Phi + sigma * phi
    return cands[int(np.argmax(ei))]


def _grid_points(parameters: dict) -> list:
    """Cartesian product over discrete parameter specs, in YAML key order
    (wandb grid semantics: every parameter needs `values`/`value`)."""
    import itertools

    keys, axes = [], []
    for k, spec in parameters.items():
        if isinstance(spec, dict) and "values" in spec:
            keys.append(k)
            axes.append(list(spec["values"]))
        elif isinstance(spec, dict) and "value" in spec:
            keys.append(k)
            axes.append([spec["value"]])
        else:
            raise ValueError(
                f"method: grid requires discrete 'values' for parameter "
                f"{k!r} (got {spec!r}); use method: random for "
                "min/max ranges."
            )
    return [dict(zip(keys, combo)) for combo in itertools.product(*axes)]


def sweep_run(sweep_id: str, count: int, config: dict, seed: int,
              train_dir: Optional[str] = None,
              valid_dir: Optional[str] = None,
              device: torch.device = torch.device("cuda")):
    if not os.path.exists(sweep_id):
        try:
            import wandb

            from .loop import train_run

            def agent_fn():
                wandb.init()
                cfg = dict(config)
                cfg.update(dict(wandb.config))
                train_run(
                    train_dir=cfg.get("train_dir", train_dir),
                    valid_dir=cfg.get("valid_dir", valid_dir),
                    config=cfg, model_path=None, save_valid_plots=False,
                    seed=seed, device=device,
                )

            wandb.agent(sweep_id, agent_fn, count=count)
            return
        except ImportError:
            raise FileNotFoundError(
                f"sweep_id {sweep_id!r} is not a local YAML file and wandb "
                "is not installed. Provide a search-space YAML for offline "
                "random search."
            )

    with open(sweep_id) as fh:
        space = yaml.safe_load(fh)
    parameters = space.get("parameters", {})
    td = train_dir or space.get("train_dir")
    vd = valid_dir or space.get("valid_dir")
    if not td:
        raise ValueError(
            "Offline sweep needs a train_dir (top-level key in the YAML)."
        )

    from .loop import train_run

    rng = random.Random(seed)
    results_path = os.path.join(
        os.path.dirname(os.path.abspath(sweep_id)), "sweep_results.jsonl"
    )
    method = str(space.get("method", "random")).lower()
    best = None
    trial_no = 0

    def run_trial(trial_params, extra_cfg=None, record=None):
        nonlocal best, trial_no
        cfg = dict(config)
        cfg.update(trial_params)
        if extra_cfg:
            cfg.update(extra_cfg)
        logger.info(f"Sweep trial {trial_no}: {trial_params}"
                    + (f" {extra_cfg}" if extra_cfg else ""))
        metrics = train_run(
            train_dir=td, valid_dir=vd, config=cfg, model_path=None,
            save_valid_plots=False, seed=seed + trial_no, device=device,
        )
        score = metrics.get("valid_total_loss", float("inf"))
        row = {"trial": trial_no, "params": trial_params, "metrics": metrics}
        if record:
            row.update(record)
        with open(results_path, "a") as fh:
            fh.write(json.dumps(row) + "\n")
        if best is None or score < best[0]:
            best = (score, trial_no, trial_params)
        trial_no += 1
        return score

    if method == "grid":
        points = _grid_points(parameters)
        if len(points) > count:
            logger.info(
                f"Grid has {len(points)} points; --count caps it at {count}."
            )
            points = points[:count]
        for trial_params in points:
            run_trial(trial_params)
    elif method == "halving":
        eta = max(2, int(space.get("eta", 3)))
        budget = max(1, int(space.get("min_epochs", 1)))
        max_budget = int(config.get("max_epochs", budget))
        survivors = [
            {k: _sample_param(v, rng) for k, v in parameters.items()}
            for _ in range(count)
        ]
        rung = 0
        while True:
            scored = []
            for trial_params in survivors:
                score = run_trial(
                    trial_params,
                    extra_cfg={"max_epochs": min(budget, max_budget)},
                    record={"rung": rung,
                            "epochs": min(budget, max_budget)},
                )
                scored.append((score, trial_params))
            if len(survivors) <= 1:
                break
            scored.sort(key=lambda t: t[0])
            survivors = [tp for _, tp in scored[:max(1, len(scored) // eta)]]
            budget *= eta
            rung += 1
    elif method == "bayes":
        dims, decode = _bayes_encoding(parameters)
        n_init = int(space.get("n_init", max(2, min(5, count // 2))))
        X, y = [], []
        for i in range(count):
            if not dims:
                u = []
            elif i < n_init or len(y) < 2:
                u = [rng.random() for _ in range(len(dims))]
            else:
                u = _bayes_propose(X, y, len(dims), rng)
            score = run_trial(decode(u), record={"point": list(u)})
            if dims:
                X.append(list(u))
                y.append(score if score == score else 1e30)  # NaN guard
    else:
        for _ in range(count):
            trial_params = {
                k: _sample_param(v, rng) for k, v in parameters.items()
            }
            run_trial(trial_params)

    if best:
        logger.info(
            f"Best trial {best[1]} (valid_total_loss={best[0]:.5f}): {best[2]}"
        )
