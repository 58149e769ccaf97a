"""The port's threefry draws on the card, one kernel launch each: predict's
Gamma dwell draw with its per-chunk key chain, and the train step's key
derivations and dropout draws (the end of this docstring).

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

The train step's threefry takes the same dispatch (`fold_in`, `split`,
`fold_in_split`, `bernoulli`, `dropout_scales`): on a CUDA key each is one
launch of `csrc/threefry.cu` (`s2s_threefry_keys`, `s2s_dropout_draw`)
where the torch ops of prng.py take ~175 launches a key derivation and ~190
a dropout draw; on a CPU key each is those torch ops. Keys and masks are
bit-equal: the key chain is integer work, and the mask compares uniform's
f in [0, 1) with keep, where prng.fma's `f * 1 + 0` is f exactly. A dp
rank's draw on the card is its own slab of the global draw, element for
element. The counters `train.masks_kernel` and `train.masks_plain` count
the elements each path draws.
"""

from __future__ import annotations

import ctypes
import functools
import math

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


# ---- the train step: key derivation and dropout draws ----


def _derive(keys: torch.Tensor, fold_data: int, n_fold: int, n_split: int) -> torch.Tensor:
    """One launch of s2s_threefry_keys over keys (..., 2): each key folded
    with fold_data + f for f < n_fold (none where n_fold is 0), then split
    into n_split keys (none where 0). Returns (N, max(n_fold, 1),
    max(n_split, 1), 2) int64 for the N leading keys."""
    global launches
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,):
        raise ValueError(f"a key is (..., 2) int64; got {tuple(keys.shape)} {keys.dtype}")
    flat = keys.reshape(-1, 2).contiguous()
    out = torch.empty((flat.shape[0], max(n_fold, 1), max(n_split, 1), 2), dtype=torch.int64,
                      device=keys.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(keys.device):  # the argument types convert the ints
        err = lib.s2s_threefry_keys(
            flat.data_ptr(), out.data_ptr(), flat.shape[0], n_fold, int(fold_data) & prng.MASK,
            n_split, torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"s2s_threefry_keys launch failed: {_build.error_string(err, lib)}")
    with _build.COUNT_LOCK:
        launches += 1
    return out


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """prng.fold_in(key, data) for keys (..., 2) and an int: one launch on
    the card."""
    if not key.is_cuda:
        return prng.fold_in(key, data)
    return _derive(key, data, 1, 0).reshape(key.shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """prng.split(key, num): (..., 2) -> (..., num, 2), one launch on the card."""
    if not key.is_cuda:
        return prng.split(key, num)
    return _derive(key, 0, 0, num).reshape(*key.shape[:-1], num, 2)


def fold_in_split_reference(key: torch.Tensor, n: int, num: int = 2) -> torch.Tensor:
    """The plain split(fold_in(key, i), num) for i < n: (..., n, num, 2)."""
    return torch.stack([prng.split(prng.fold_in(key, i), num) for i in range(n)], dim=-3)


def fold_in_split(key: torch.Tensor, n: int, num: int = 2) -> torch.Tensor:
    """split(fold_in(key, i), num) for i < n, (..., n, num, 2): a block
    stack's per-block dropout keys, one launch on the card."""
    if not key.is_cuda:
        return fold_in_split_reference(key, n, num)
    return _derive(key, 0, n, num).reshape(*key.shape[:-1], n, num, 2)


def _rows(shape, rows) -> tuple:
    shape = tuple(int(s) for s in shape)
    return shape, shape[0] if rows is None else int(rows)


def bernoulli_reference(key: torch.Tensor, p: float, shape, rows=None,
                        start: int = 0) -> torch.Tensor:
    """The plain draw: prng.bernoulli(key, p, (rows, *shape[1:])) cut to its
    rows [start, start + shape[0]) (rows defaults to shape[0])."""
    shape, rows = _rows(shape, rows)
    mask = prng.bernoulli(key, p, (rows, *shape[1:]))
    return mask[start:start + shape[0]] if rows != shape[0] else mask


def dropout_scales_reference(key: torch.Tensor, keep: float, shape, dtype: torch.dtype,
                             rows=None, start: int = 0) -> torch.Tensor:
    """The plain scales: bernoulli_reference's mask -> {1/keep, 0}, built in
    float32 and then cast to dtype."""
    mask = bernoulli_reference(key, keep, shape, rows, start)
    return (mask.to(torch.float32) * (1.0 / keep)).to(dtype)


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}  # element size -> its raw view


@functools.lru_cache(maxsize=64)
def _scale_bits(keep: float, dtype: torch.dtype) -> int:
    """The raw bits of a kept element's scale 1/keep in dtype, by the plain
    path's arithmetic (float32, then a cast); cached, as the train step asks
    for the same few scales every step."""
    on = (torch.ones(1) * (1.0 / keep)).to(dtype)
    return int(on.view(_BITS[dtype.itemsize]).item()) % (1 << 8 * dtype.itemsize)


def _draw(key: torch.Tensor, keep: float, shape: tuple, rows: int, start: int,
          dtype: torch.dtype, on_bits: int) -> torch.Tensor:
    """One launch of s2s_dropout_draw: rows [start, start + shape[0]) of the
    (rows, *shape[1:]) draw as `dtype`, the raw bits `on_bits` where kept and
    0 elsewhere."""
    global launches
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"a dropout key is (2,) int64; got {tuple(key.shape)} {key.dtype}")
    if dtype.itemsize not in _BITS or dtype.is_complex:
        raise ValueError(f"the dropout kernel writes 1, 2 or 4-byte elements; got {dtype}")
    if not 0 <= start <= rows - shape[0]:
        raise ValueError(f"rows [{start}, {start + shape[0]}) lie outside a draw of {rows}")
    out = torch.empty(shape, dtype=dtype, device=key.device)
    tracing.count("train.masks_kernel", out.numel())
    if out.numel() == 0:
        return out
    key = key.contiguous()
    lib = _build.load()
    with torch.cuda.device(key.device):  # the argument types convert the ints
        err = lib.s2s_dropout_draw(
            key.data_ptr(), out.data_ptr(), out.numel(), start * math.prod(shape[1:]),
            prng.f32(keep), on_bits, dtype.itemsize,
            torch.cuda.current_stream(key.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"s2s_dropout_draw launch failed: {_build.error_string(err, lib)}")
    with _build.COUNT_LOCK:
        launches += 1
    return out


def bernoulli(key: torch.Tensor, p: float, shape, rows=None, start: int = 0) -> torch.Tensor:
    """jax.random.bernoulli(key, p, (rows, *shape[1:])), rows [start,
    start + shape[0]) of it (a dp rank's slab; rows defaults to shape[0]):
    a bool mask of `shape`, one launch on the card, which draws the slab
    alone."""
    shape, rows = _rows(shape, rows)
    if not key.is_cuda:
        tracing.count("train.masks_plain", rows * math.prod(shape[1:]))
        return bernoulli_reference(key, p, shape, rows, start)
    return _draw(key, p, shape, rows, start, torch.bool, 1)


def dropout_scales(key: torch.Tensor, keep: float, shape, dtype: torch.dtype, rows=None,
                   start: int = 0) -> torch.Tensor:
    """bernoulli(key, keep, shape, rows, start) as scales of `dtype`: 1/keep
    (rounded to float32, then to dtype) where kept, 0 where dropped."""
    shape, rows = _rows(shape, rows)
    if not key.is_cuda:
        tracing.count("train.masks_plain", rows * math.prod(shape[1:]))
        return dropout_scales_reference(key, keep, shape, dtype, rows, start)
    return _draw(key, keep, shape, rows, start, dtype, _scale_bits(keep, dtype))
