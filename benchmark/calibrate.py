"""Readings that the limits of a cell's outputs check are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3

For every seed, one pass of the cell's timed path at its own size (one
predict job; the checked training steps) judged as a run judges it: the
program's readings, whose largest is a limit's lower reading. For each
control seed, besides: the reference at the next lower precision put in the
program's place (float8 e4m3 for a configuration in bfloat16), and for
training the faults planted in the reference (train_ref.FAULTS). Each
seed's readings are one JSON line on standard output and in --out.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONTROL = "float8_e4m3"  # the precision below the configurations' bfloat16


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--detail", action="store_true", help="per-leaf readings (training)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_run", ROOT / "benchmark" / "run.py")
    run_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_mod)
    run_mod._fixed_caches()
    import gc
    import logging
    import shutil
    import tempfile

    import torch

    from benchmark.harness import core

    logging.getLogger("seq2squiggle_tpu_torch").setLevel(logging.ERROR)
    _, cell, cfg_file, traffic, _ = core.load_cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.perf_counter()
        work = tempfile.mkdtemp(prefix="calibrate-")
        try:
            ctx = core.make_context(cell, cfg_file, traffic, seed, device, work)
            driver = core.load_driver(traffic["driver"])(ctx)
            driver.setup()
            driver.window(0.0, False)
            if hasattr(driver, "release"):
                driver.release()
            gc.collect()
            torch.cuda.empty_cache()
            more = {"detail": True} if args.detail and traffic["driver"] == "train" else {}
            rec = {"workload": args.workload, "seed": seed, "program": driver.check(**more)}
            if seed in controls:
                rec["control"] = driver.check(control=CONTROL, **more)
                if traffic["driver"] == "train":
                    from benchmark.reference.train_ref import FAULTS

                    for fault in FAULTS:
                        rec[fault] = driver.check(fault=fault, **more)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        rec["seconds"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
