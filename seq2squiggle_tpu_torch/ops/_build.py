"""Build and load the port's CUDA kernels.

At first use, every `csrc/*.cu` source of this package is compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a` into one shared library with a
plain C interface, then loaded with ctypes. In a checkout of the repository
the library goes to `build/torch_kernels/` at its root; an installed copy
builds into `$XDG_CACHE_HOME/seq2squiggle_tpu_torch/torch_kernels/` (by
default under `~/.cache`), outside site-packages. Each C entry point returns `cudaGetLastError()` after its
launch; the Python wrapper raises if that is not 0. A failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> pathlib.Path:
    root = pathlib.Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():  # a checkout
        return root / "build" / "torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return pathlib.Path(cache) / "seq2squiggle_tpu_torch" / "torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB = None
build_seconds = None  # wall time of this process's build, for chip_smoke.py
build_log = ""  # nvcc's output (registers, shared memory, spills)


def sources():
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ with the CUDA toolkit at first use")


def _lib_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources() + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libs2s_kernels-{h.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.s2s_fft_block.restype = ctypes.c_int
    lib.s2s_fft_block.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.s2s_error_string.restype = ctypes.c_char_p
    lib.s2s_error_string.argtypes = [ctypes.c_int]
    return lib


def load() -> ctypes.CDLL:
    """Build (once per source digest) and load the kernel library."""
    global _LIB, build_seconds, build_log
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = _lib_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(s) for s in sources())]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{build_log}")
            os.replace(tmp, out)
        _LIB = _bind(ctypes.CDLL(str(out)))
        return _LIB


def error_string(code: int) -> str:
    return f"{code} ({load().s2s_error_string(code).decode()})"
