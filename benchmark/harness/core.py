"""One run of one cell: set-up, the measured window, the outputs check and
the result line. `run.py` is the command; tests call `run` with a CPU
device and small traffic."""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import logging
import math
import os
import pathlib
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, Optional

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
BANNED_MODULES = ("jax", "jaxlib", "flax", "seq2squiggle_tpu")


def banned_modules_loaded() -> list:
    """Top-level names (before the first dot, compared whole) of loaded
    modules that a run must not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED_MODULES))


def load_cell(workload: str):
    """BENCHMARK.json, the cell's entry, its configuration file, traffic and limits."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {', '.join(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg_file = json.loads((ROOT / config["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    return bench, cell, cfg_file, traffic, limits


def _applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def _reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_context(cell, cfg_file, traffic, seed: int, device: torch.device, workdir: str):
    from seq2squiggle_tpu_torch.config import load_config

    program_config = dict(load_config(None), **cfg_file["model"])
    profile = cfg_file["profile"]
    signal = {"scaling_max_value": cfg_file["model"]["scaling_max_value"],
              "digitisation": profile["digitisation"], "range": profile["range"],
              "offset_mean": profile["offset_mean"]}
    weights = str(ROOT / cfg_file["weights"]) if cfg_file.get("weights") else None
    return SimpleNamespace(cell=cell, traffic=traffic, model_config=cfg_file["model"],
                           program_config=program_config, profile=profile,
                           signal_settings=signal, weights=weights, seed=int(seed),
                           device=device, workdir=workdir)


def load_driver(name: str):
    """The class `Cell` of benchmark/drivers/<name>.py, the module that a
    traffic file names under `driver`."""
    if not name.isidentifier():
        raise SystemExit(f"a driver's name is a module name: {name!r}")
    return importlib.import_module(f"benchmark.drivers.{name}").Cell


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: Optional[torch.device] = None, traffic_override: Optional[Dict] = None,
        out=sys.stdout, err=sys.stderr) -> int:
    """One run; prints the result line and returns the exit code. With
    `device` given the look for cards is skipped (tests on the CPU)."""
    bench, cell, cfg_file, traffic, limits = load_cell(workload)
    traffic = dict(traffic, **(traffic_override or {}))
    chips = int(cell["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"this cell needs {chips} CUDA device(s); {n} found", file=err)
            return 2
        device = torch.device("cuda", 0)
    workdir = tempfile.mkdtemp(prefix=f"bench-{workload}-")
    try:
        return _run(bench, cell, cfg_file, traffic, limits, seed, seconds, trace, t_start,
                    device, workdir, out, err)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(bench, cell, cfg_file, traffic, limits, seed, seconds, trace, t_start, device,
         workdir, out, err) -> int:
    on_gpu = device.type == "cuda"
    logging.getLogger("seq2squiggle_tpu_torch").setLevel(logging.ERROR)
    if trace:
        os.environ["SEQ2SQUIGGLE_TPU_TIMERS"] = "1"
    ctx = make_context(cell, cfg_file, traffic, seed, device, workdir)
    driver = load_driver(traffic["driver"])(ctx)
    driver.setup()
    if on_gpu:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    res = driver.window(float(seconds), bool(trace))
    peak = torch.cuda.max_memory_allocated(device) if on_gpu else 0
    if hasattr(driver, "release"):
        driver.release()
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    numbers = driver.check()
    checks = {k: {"value": float(numbers.get(k, math.inf)), "limit": float(v)}
              for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    name = cell["name"]
    e2e_values = dict(res["e2e"], setup_s=setup_s)
    reported = {m["name"] for m in bench["end_to_end"] if _applies(m, name, set())
                and m["name"] in e2e_values}
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if m["name"] in reported:
                metrics[m["name"]] = {"value": float(e2e_values[m["name"]]), "unit": m["unit"]}
    else:
        view = dict(res, config=ctx.program_config, traffic=traffic)
        for m in bench["per_layer"]:
            if not _applies(m, name, reported):
                continue
            value = _reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_gpu else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_gpu else "cpu",
                "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics, "device": dev_info}
    if trace and res.get("trace"):
        tr = res["trace"]
        dev_info["busy_s"] = float(tr["busy_s"])
        dev_info["window_s"] = float(tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["written_bytes"] = int(getattr(driver, "bytes_written", 0))
    result.update(getattr(driver, "result_fields", {}))
    result["checks"] = checks
    found = banned_modules_loaded()
    if found:
        print(f"modules that a run must not load are loaded: {', '.join(found)}", file=err)
        return 3
    for line in getattr(driver, "log", []):
        print("job %d: %d chunks, %d samples, %.3f s" % line, file=err)
    if trace and res.get("trace"):
        print(f"trace: {res['trace']['window_s']:.3f} s traced, reduced in "
              f"{res['trace']['reduce_s']:.3f} s", file=err)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=err)
    print(json.dumps(result), file=out)
    out.flush()
    return 0
