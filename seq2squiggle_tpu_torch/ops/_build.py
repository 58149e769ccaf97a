"""Build and load the port's CUDA kernels.

At first use, every `csrc/*.cu` source of this package is compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a` (one nvcc per source, all
started together) and the objects are linked into one shared library with a
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Dynamic shared memory one thread block can opt into on an H100 (227 KB).
SHARED_MEMORY_MAX = 232_448

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
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    # the fused block, its pair and its profiling variants share one argument
    # list: x, out, weight pointers, B, L, dtype, 1/sqrt(d_k), one knob, stream
    for entry in ("s2s_fft_block", "s2s_fft_block_pair", "s2s_fft_block_abc",
                  "s2s_fft_block_d", "s2s_fft_block_parts"):
        fn = getattr(lib, entry)
        fn.restype = c_int
        fn.argtypes = [ptr, ptr, ctypes.POINTER(ptr), c_int, c_int, c_int, ctypes.c_float,
                       c_int, ptr]
    lib.s2s_attn_core_fwd.restype = c_int
    lib.s2s_attn_core_fwd.argtypes = [ptr, ptr, ptr, ptr, c_int, c_int, c_int,
                                      ctypes.c_float, ptr]
    lib.s2s_attn_core_bwd.restype = c_int
    lib.s2s_attn_core_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, c_int, c_int,
                                      c_int, ctypes.c_float, ptr]
    bind_block_train(lib)
    lib.s2s_error_string.restype = ctypes.c_char_p
    lib.s2s_error_string.argtypes = [ctypes.c_int]
    return lib


def bind_block_train(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The entry points of csrc/block_train.cu (also for a library that
    scripts/profile_torch_block_train.py built from that file alone)."""
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    ptrs = ctypes.POINTER(ptr)
    lib.s2s_block_train_workspace.restype = None
    lib.s2s_block_train_workspace.argtypes = [c_int, c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.s2s_block_train_fwd.restype = c_int
    lib.s2s_block_train_fwd.argtypes = [ptr, ptr, ptr, ptr, ptrs, ptr, c_int, c_int, c_int,
                                        ctypes.c_float, ptr]
    lib.s2s_block_train_bwd.restype = c_int
    lib.s2s_block_train_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptrs, ptr, ptr, ptr,
                                        c_int, c_int, c_int, ctypes.c_float, c_int, ptr]
    return lib


def _compile(out: pathlib.Path) -> None:
    """One `nvcc -c` per source, all running at once, then one link."""
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], None
    for cmd, _, proc in jobs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd)
    tmp = BUILD_DIR / f"{tag}.tmp"
    if failed is None:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed = (link.returncode, cmd)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed is not None:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{' '.join(failed[1])}\n{build_log}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """Build (once per source digest) and load the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out = _lib_path()
        if not out.exists():
            _compile(out)
        _LIB = _bind(ctypes.CDLL(str(out)))
        return _LIB


def check_shared_memory(kernel: str, L: int, dtype, need, hint: str = "") -> None:
    """Refuse, before any launch, a sequence whose per-block working set does
    not fit in shared memory. `need(L)` is the kernel's dynamic shared memory
    in bytes for length L (the Python twin of the formula in its .cu file; it
    grows with L). Raises a ValueError naming L, the dtype, the bytes and the
    largest L that fits, then `hint` (the way out, where there is one). It
    touches no device: on the CPU it checks as well."""
    n_bytes = need(L)
    if n_bytes <= SHARED_MEMORY_MAX:
        return
    fits, too_long = 0, L
    while too_long - fits > 1:
        mid = (fits + too_long) // 2
        if need(mid) <= SHARED_MEMORY_MAX:
            fits = mid
        else:
            too_long = mid
    raise ValueError(
        f"{kernel}: a sequence of L = {L} in {str(dtype).replace('torch.', '')} needs "
        f"{n_bytes} bytes of shared memory per thread block, more than the "
        f"{SHARED_MEMORY_MAX} an H100 gives one; the largest L that fits is {fits}"
        + (f" ({hint})" if hint else ""))


def error_string(code: int) -> str:
    return f"{code} ({load().s2s_error_string(code).decode()})"
