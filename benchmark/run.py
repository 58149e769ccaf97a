"""The benchmark of seq2squiggle_tpu_torch, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA cards. The
cells, configurations and metrics are in BENCHMARK.json; each cell's traffic
is benchmark/traffic/<traffic>.json, its configuration
benchmark/configs/<config>.json, its limits benchmark/limits/<cell>.json,
and each per-layer metric's reader benchmark/metrics/<metric>.py. The last
line of standard output is the result (JSON); the numbers the outputs check
compared, each beside its limit, are the last lines of standard error.
Build and kernel caches stay under build/ in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fixed_caches() -> None:
    """Every cache the program or its libraries write goes under
    build/bench-cache in the checkout, at fixed paths: the native codec's
    (under ~/.cache), Triton's, torch extensions' and the CUDA JIT's."""
    cache = ROOT / "build" / "bench-cache"
    for var, sub in (("HOME", "home"), ("XDG_CACHE_HOME", "xdg"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
        (cache / sub).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    _fixed_caches()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.core import run

    return run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
