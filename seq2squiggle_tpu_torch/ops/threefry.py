"""The Gamma dwell draw and its per-chunk key chain in one kernel launch.

`chunk_keys_and_durations` is the predict step's key chain
fold_in(fold_in(base, read_idx), chunk_off), its dwell keys fold_in(·, 1),
the Gamma(conc, rate) draw of sampling.sample_gamma_durations and
_compute_durations' clamp to `min_duration` and round half to even. A CUDA
tensor runs all of it as one launch of `csrc/threefry.cu` (or raises); a
CPU tensor runs the plain versions below, which are the torch ops of
prng.py and sampling.py, the spec.

It replaces no TPU kernel: XLA fuses the JAX package's threefry and
Marsaglia–Tsang loop on its own, while those torch ops are ~10,250 launches a
predict batch (B = 1024, K = 16) at ~10 us of host time each. What bounds the
kernel is that launch: its work is ~16k draws of ~800 integer operations,
about a microsecond of the card's integer rate, on ~0.25 MB of inputs and
outputs. One thread draws one (row, k-mer) element, derives its
row's keys itself and stops at its first accepted round.

Numerics are the plain path's op for op (csrc/threefry.cuh): keys and bits
bit-equal; __fmaf_rn where prng.fma emulates a fused multiply-add in f64,
which rounds twice where the kernel rounds once; the card's expf, which is
torch.exp's there. The draws meet sampling's bars against the plain path
(rtol 1e-5 and equal after rounding on >= 99.9 %).

The counters `sampling.gamma_kernel` and `sampling.gamma_plain` (tracing.py)
count the rows each path draws; `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import prng, tracing
from ..sampling import per_chunk_keys, sample_gamma_durations as _plain_gamma_durations
from . import _build

launches = 0  # kernel launches; chip_smoke.py reads and resets it


def chunk_keys_reference(base_key: torch.Tensor, read_idx: torch.Tensor,
                         chunk_off: torch.Tensor) -> torch.Tensor:
    """The plain key chain: (B, 2) chunk keys from the run key (2,)."""
    return prng.fold_in(per_chunk_keys(base_key, read_idx), chunk_off)


def durations_reference(keys: torch.Tensor, conc: torch.Tensor, rate: torch.Tensor,
                        min_duration: float) -> torch.Tensor:
    """The plain dwell counts (B, K) int32 from the dwell keys (B, 2)."""
    dur = _plain_gamma_durations(keys, conc, rate)
    dur = dur.clamp_min(1.0).clamp_min(float(min_duration))
    return torch.round(dur).to(torch.int32)  # round half to even


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _launch(device: torch.device, B: int, K: int, *, base_key=None, read_idx=None,
            chunk_off=None, keys=None, conc=None, rate=None, keys_out=False,
            draws=False, durations=False, min_duration: float = 1.0):
    """One launch of s2s_gamma_draw; returns (keys_out, draws, durations),
    each None where not asked for."""
    global launches
    if conc is not None:
        if conc.shape != (B, K) or rate.shape != (B, K):
            raise ValueError(f"conc and rate must be ({B}, {K}); got {tuple(conc.shape)} "
                             f"and {tuple(rate.shape)}")
        conc = conc.to(device=device, dtype=torch.float32).contiguous()
        rate = rate.to(device=device, dtype=torch.float32).contiguous()
    if keys is not None:
        if keys.shape != (B, 2):
            raise ValueError(f"keys must be ({B}, 2); got {tuple(keys.shape)}")
        keys = keys.to(device=device, dtype=torch.int64).contiguous()
    else:
        if base_key.shape != (2,) or read_idx.shape != (B,) or chunk_off.shape != (B,):
            raise ValueError(f"the key chain takes a (2,) key and ({B},) indices; got "
                             f"{tuple(base_key.shape)}, {tuple(read_idx.shape)}, "
                             f"{tuple(chunk_off.shape)}")
        base_key = base_key.to(device=device, dtype=torch.int64).contiguous()
        # int32 keeps the low 32 bits of any index, which is what prng._u32 folds in
        read_idx = read_idx.to(device=device, dtype=torch.int32).contiguous()
        chunk_off = chunk_off.to(device=device, dtype=torch.int32).contiguous()
    out_keys = torch.empty((B, 2), dtype=torch.int64, device=device) if keys_out else None
    out_draws = torch.empty((B, K), dtype=torch.float32, device=device) if draws else None
    out_dur = torch.empty((B, K), dtype=torch.int32, device=device) if durations else None
    if B * K == 0:
        return out_keys, out_draws, out_dur
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.s2s_gamma_draw(
            _ptr(base_key), _ptr(read_idx), _ptr(chunk_off), _ptr(keys), _ptr(conc),
            _ptr(rate), _ptr(out_keys), _ptr(out_draws), _ptr(out_dur), ctypes.c_int(B),
            ctypes.c_int(K), ctypes.c_float(min_duration),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"s2s_gamma_draw launch failed: {_build.error_string(err, lib)}")
    with _build.COUNT_LOCK:
        launches += 1
    return out_keys, out_draws, out_dur


def chunk_keys(base_key: torch.Tensor, read_idx: torch.Tensor,
               chunk_off: torch.Tensor) -> torch.Tensor:
    """The per-chunk keys (B, 2) int64 from the run key (2,), the (B,) read
    indices (-1 for padding rows) and chunk offsets, on base_key's device."""
    if not base_key.is_cuda:
        return chunk_keys_reference(base_key, read_idx, chunk_off)
    return _launch(base_key.device, read_idx.shape[0], 1, base_key=base_key,
                   read_idx=read_idx, chunk_off=chunk_off, keys_out=True)[0]


def chunk_keys_and_durations(base_key: torch.Tensor, read_idx: torch.Tensor,
                             chunk_off: torch.Tensor, conc: torch.Tensor, rate: torch.Tensor,
                             min_duration: float):
    """(chunk keys (B, 2) int64, dwell counts (B, K) int32): the counts are
    round(max(Gamma(conc, rate), 1, min_duration)) drawn with the keys
    fold_in(chunk key, 1), as runtime/predict.py's step draws them."""
    B = conc.shape[0]
    if not conc.is_cuda:
        tracing.count("sampling.gamma_plain", B)
        keys = chunk_keys_reference(base_key, read_idx, chunk_off)
        return keys, durations_reference(prng.fold_in(keys, 1), conc, rate, min_duration)
    tracing.count("sampling.gamma_kernel", B)
    keys, _, dur = _launch(conc.device, B, conc.shape[1], base_key=base_key, read_idx=read_idx,
                           chunk_off=chunk_off, conc=conc, rate=rate, keys_out=True,
                           durations=True, min_duration=float(min_duration))
    return keys, dur


def sample_gamma_durations(keys: torch.Tensor, conc: torch.Tensor,
                           rate: torch.Tensor) -> torch.Tensor:
    """Gamma(conc, rate) draws (B, K) float32 with one key (B, 2) a row:
    sampling.sample_gamma_durations, one launch on the card."""
    B = conc.shape[0]
    if not conc.is_cuda:
        tracing.count("sampling.gamma_plain", B)
        return _plain_gamma_durations(keys, conc, rate)
    tracing.count("sampling.gamma_kernel", B)
    return _launch(conc.device, B, conc.shape[1], keys=keys, conc=conc, rate=rate,
                   draws=True)[1]
