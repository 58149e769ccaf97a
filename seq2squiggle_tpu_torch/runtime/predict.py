"""The per-batch device step: the port of seq2squiggle_tpu/runtime/predict.py
with its device-to-host wire formats.

  windowed base codes -> k-mers -> one-hot -> encoder -> noise head
    -> duration draw (Gamma head sample | static normal | constant)
    -> segment map + gather regulation -> decoder -> x scaling_max_value
    -> amplitude noise on non-zero frames -> clamp >= 0
    -> int16 digitisation + stable front-compaction of the kept samples

Shapes are static: (B, K + k - 1) base windows in, (B, T) int16 samples and
(B,) counts out at the raw tier (wire_bits 16). The packed tiers are the JAX
package's, byte for byte: 8- and 12-bit first differences of the raw rows
with exact exceptions (`_pack_wire`), and the two event tiers, which ship the
CLEAN decoder output's per-event statistics and draw no per-sample noise on
the device (`_pack_event_wire`, 4 bits; `_pack_event_wire_ulp`, 2 bits under
bf16 compute). runtime/wire.py decodes them on the host and regenerates the
noise from the same threefry keys. `framed=True` returns one (B, ROW_BYTES)
uint8 tensor per batch in `wire_layout` order (little-endian fields), so a
batch comes back in one copy.
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .. import prng, tracing
from ..models.fft_model import (
    compute_dtype,
    decoder_forward,
    duration_gamma_params,
    encoder_forward,
    noise_head,
)
from ..ops import threefry
from ..ops.regulator import regulate_from_seg, segment_map
from ..sampling import sample_normal


@dataclasses.dataclass(frozen=True)
class PredictKnobs:
    """Inference-time controls (reference CLI: --dwell-mean/std, --noise-std,
    --noise-sampler/--duration-sampler, --min_noise, --min_duration), as
    seq2squiggle_tpu.runtime.predict.PredictKnobs."""

    dwell_mean: float = 12.5
    dwell_std: float = 0.0
    noise_std: float = 2.0
    noise_sampling: bool = True
    duration_sampling: bool = True
    min_noise: float = 0.0
    min_duration: int = 3
    scaling_max_value: float = 165.0
    # digitisation (from the chemistry profile)
    digitisation: float = 2048.0
    signal_range: float = 281.345551
    offset_mean: float = -127.5655735
    # Device->host wire width: 16 = raw int16 rows, 8 / 12 = first
    # differences with exact exceptions, 4 = the event tier, 2 = the ULP
    # event tier (bf16 compute only); see the JAX package's PredictKnobs.
    wire_bits: int = 16


# Exception slots per row of the 4-, 8- and 12-bit tiers, and the ULP tier's
# batch-flat escape budget in 4-bit nibbles per row: the JAX package's
# values (seq2squiggle_tpu/runtime/predict.py:91, :104), which fix the wire.
WIRE_EXC_SLOTS = {4: 12, 8: 24, 12: 4}
WIRE_ESC_NIB_PER_ROW = 20


def _keys_and_durations(params: dict, emb_out: torch.Tensor, base_key: torch.Tensor,
                        read_idx: torch.Tensor, chunk_off: torch.Tensor,
                        knobs: PredictKnobs, config: dict):
    """The per-chunk keys (B, 2) and the integer dwell counts per k-mer
    (B, K) int32, drawn with the keys fold_in(chunk key, 1). The Gamma draw
    and its key chain are one launch on the card (ops/threefry.py). The
    draws are the `sampling` span (tracing.py), on the thread that launches
    them."""
    B, K = emb_out.shape[:2]
    if knobs.duration_sampling:
        conc, rate = duration_gamma_params(params, emb_out, config)
        with tracing.span("sampling"):
            return threefry.chunk_keys_and_durations(base_key, read_idx, chunk_off, conc, rate,
                                                     knobs.min_duration)
    chunk_keys = threefry.chunk_keys(base_key, read_idx, chunk_off)
    if knobs.dwell_std > 0:
        with tracing.span("sampling"):
            noise = sample_normal(prng.fold_in(chunk_keys, 1), (K,))
        dur = prng.fma(noise, prng.f32(knobs.dwell_std), prng.f32(knobs.dwell_mean))
        dur = dur.clamp_min(float(knobs.min_duration))
    else:
        dur = torch.full((B, K), knobs.dwell_mean, dtype=torch.float32,
                         device=emb_out.device)
    return chunk_keys, torch.round(dur).to(torch.int32)  # round half to even


def _stable_front_compact(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Move each row's kept values to its front, order preserved; dropped
    values follow, also in order (a stable partition)."""
    kept_rank = torch.cumsum(keep, dim=1) - 1
    n_keep = kept_rank[:, -1:] + 1
    drop_rank = torch.cumsum(~keep, dim=1) - 1 + n_keep
    dest = torch.where(keep, kept_rank, drop_rank)
    return torch.empty_like(values).scatter_(1, dest, values)


def decoder_output(
    params: dict,
    codes: torch.Tensor,
    read_idx: torch.Tensor,
    chunk_off: torch.Tensor,
    base_key: torch.Tensor,
    n_kmers: Optional[torch.Tensor] = None,
    *,
    config: dict,
    knobs: PredictKnobs,
):
    """The step up to the decoder (arguments as `predict_step`).

    Returns (dec (B, T) in the compute dtype, before the x scaling_max_value;
    the regulated noise stdev (B, T) float32; the per-chunk keys (B, 2); the
    per-k-mer noise stdev (B, K) float32; segment_map's (ends, starts_ext,
    seg, is_start), which the event tiers pack).
    """
    cd = compute_dtype(config)
    dev = codes.device
    if codes.ndim == 2:
        k = int(config["seq_kmer"])
        K = codes.shape[1] - k + 1
        kmers = torch.stack([codes[:, j: j + K] for j in range(k)], dim=-1)
        if n_kmers is not None:
            valid = (torch.arange(K, device=dev)[None, :]
                     < n_kmers.to(torch.int64)[:, None])
            kmers = torch.where(valid[..., None], kmers, torch.zeros_like(kmers))
        codes = kmers
    B, K, k = codes.shape
    T = int(config["max_signal_len"])
    n_chars = len(config["allowed_chars"])

    # code n_chars (unknown base) gives the all-zero row
    one_hot = (codes.long()[..., None]
               == torch.arange(n_chars, device=dev)).to(cd).reshape(B, K, k * n_chars)

    enc_out, emb_out = encoder_forward(params, one_hot, config)
    emb32 = emb_out.float()
    noise_stdev = noise_head(params, emb32, config)  # (B, K)

    chunk_keys, durations = _keys_and_durations(params, emb32, base_key, read_idx, chunk_off,
                                                knobs, config)

    seg_parts = segment_map(durations, T)
    expanded, noise_ext = regulate_from_seg(enc_out, seg_parts[2],
                                            x_noise=noise_stdev[..., None])

    dec = decoder_forward(params, expanded, config)[..., 0]  # (B, T)
    return dec, noise_ext[..., 0], chunk_keys, noise_stdev, seg_parts


def predict_step(
    params: dict,
    codes: torch.Tensor,  # (B, K+k-1) base windows, or (B, K, k) k-mer codes
    read_idx: torch.Tensor,  # (B,) global read index (-1 = padding row)
    chunk_off: torch.Tensor,  # (B,) chunk offset within the read
    base_key: torch.Tensor,  # (2,) run key, prng.key(seed)
    n_kmers: Optional[torch.Tensor] = None,  # (B,) valid k-mers per window row
    *,
    config: dict,
    knobs: PredictKnobs,
    framed: bool = False,
):
    """The tier's outputs, as the JAX package's predict_step returns them.

    At wire_bits 16: (signal_compact (B, T) int16, counts (B,) int32). The
    kept samples (non-zero after noise and clamp, on non-padding rows) are
    stably compacted to the front of each row; the host slices
    row[:count]. At 8 and 12: `_pack_wire`'s four arrays and the counts. At
    4 and 2: the clean signal packed by `_pack_event_wire(_ulp)`; no noise
    is drawn here. With framed=True: one (B, ROW_BYTES) uint8 tensor
    (`_frame_outputs`), which runtime/wire.unframe_wire splits again.
    """
    bits = knobs.wire_bits
    if bits not in (2, 4, 8, 12, 16):
        raise ValueError(f"unsupported wire_bits {bits}")
    dec, noise_ext, chunk_keys, noise_stdev, seg_parts = decoder_output(
        params, codes, read_idx, chunk_off, base_key, n_kmers, config=config, knobs=knobs)

    if bits == 2:
        outs = _pack_event_wire_ulp(dec, seg_parts, noise_stdev, read_idx, knobs)
    elif bits == 4:
        outs = _pack_event_wire(dec.float() * knobs.scaling_max_value, seg_parts,
                                noise_stdev, read_idx, knobs)
    else:
        signal_compact, counts = _raw_rows(dec, noise_ext, chunk_keys, read_idx, knobs)
        outs = (signal_compact, counts)
        if bits != 16:
            outs = _pack_wire(signal_compact, counts, bits) + (counts,)
    return _frame_outputs(outs) if framed else outs


def _raw_rows(dec, noise_ext, chunk_keys, read_idx, knobs: PredictKnobs):
    """The raw tier: amplitude noise on the non-zero frames, clamp, int16
    digitisation; returns (signal_compact (B, T) int16, counts (B,) int32)."""
    pred = dec.float() * knobs.scaling_max_value
    if knobs.noise_std > 0:
        non_zero = pred != 0.0
        with tracing.span("sampling"):
            gauss = sample_normal(prng.fold_in(chunk_keys, 2), (pred.shape[1],))
        if knobs.noise_sampling:
            std = noise_ext.clamp_min(knobs.min_noise)
            std = std * knobs.noise_std * knobs.scaling_max_value
        else:
            std = prng.f32(knobs.noise_std)
        pred = torch.where(non_zero, prng.fma(gauss, std, pred), pred)
    pred = pred.clamp_min(0.0)

    # round(sig * dig / range - offset), half to even, saturated to int16
    signal_raw = torch.round(
        pred * knobs.digitisation / knobs.signal_range - knobs.offset_mean
    ).clamp(-32768.0, 32767.0).to(torch.int16)

    keep = (pred != 0.0) & (read_idx[:, None] >= 0)
    counts = keep.sum(dim=1, dtype=torch.int32)
    return _stable_front_compact(signal_raw, keep), counts


def _i16_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 -> int16 keeping the low 16 bits (what XLA's narrowing convert
    does), without relying on how a torch backend narrows out-of-range
    values: uint16 fields travel as int16 with the same bytes."""
    return (((x & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)


def _stable_sort_front(flagged: torch.Tensor, *vals: torch.Tensor):
    """Each row's flagged entries first, then the rest, both in their order
    (the JAX package's stable `lax.sort` on an int8 key): returns `vals`
    gathered in that order, and the order itself."""
    order = torch.sort((~flagged).to(torch.int8), dim=-1, stable=True).indices
    return tuple(torch.gather(v, -1, order) for v in vals), order


def _sigma_wire(noise_stdev: torch.Tensor, knobs: PredictKnobs):
    """The per-event noise stdev in quarter ADC counts, the uint8 field of
    both event tiers, and the unclipped value the overflow flags read."""
    cpr = prng.f32(knobs.digitisation / knobs.signal_range)  # ADC counts per pA
    sigma_counts = (noise_stdev.clamp_min(knobs.min_noise) * prng.f32(knobs.noise_std)
                    * prng.f32(knobs.scaling_max_value) * cpr)
    sigma_raw = torch.round(sigma_counts * 4.0)
    return sigma_raw.clamp(0, 255).to(torch.uint8), sigma_raw


def _pack_event_wire(pred, seg_parts, noise_stdev, read_idx, knobs: PredictKnobs):
    """The 4-bit event tier (JAX predict.py:259): the clean signal as
    integer-count levels at each event's first frame, 4-bit within-event
    deltas two to a byte, exact (position, residual) exceptions, the
    per-event stdev in quarter counts and the event boundaries. n_exc carries
    1 << 20 on a row whose residual, stdev or level does not fit, so the host
    refuses the batch instead of decoding it lossily.

    Returns (stream (B, T/2) u8, levels (B, K+1) i16, sigma_q (B, K) u8,
    ends (B, K) u8, exc_pos (B, E) u8, exc_val (B, E) i16, n_exc (B,) i32).
    """
    B, T = pred.shape
    ends, starts_ext, _, is_start = seg_parts
    if T % 2 or T > 255:
        raise ValueError(f"the event tier needs an even frame budget < 256, not {T}")
    cpr = prng.f32(knobs.digitisation / knobs.signal_range)
    E = WIRE_EXC_SLOTS[4]

    # integer counts, non-zero predictions floored at 1 count so that the
    # zero / non-zero distinction of the raw tier stays exact
    clean_q = torch.where(pred > 0.0, torch.round(pred * cpr).clamp_min(1.0),
                          torch.zeros_like(pred)).to(torch.int32)
    clean_q = torch.where(read_idx[:, None] >= 0, clean_q, torch.zeros_like(clean_q))
    levels = torch.gather(clean_q, 1, starts_ext.clamp(max=T - 1).long())  # (B, K+1)
    sigma_q, sigma_raw = _sigma_wire(noise_stdev, knobs)

    d = torch.diff(clean_q, dim=1, prepend=torch.zeros_like(clean_q[:, :1]))
    d = torch.where(is_start, torch.zeros_like(d), d)  # starts come from `levels`
    lo = d.clamp(-8, 7)
    u = lo + 8
    stream = (u[:, 0::2] | (u[:, 1::2] << 4)).to(torch.uint8)  # (B, T/2)

    resid = d - lo
    over = resid != 0
    resid_fits = (resid >= -32768) & (resid <= 32767)
    (resid_sorted,), pos_sorted = _stable_sort_front(over, resid)
    exc_pos = pos_sorted[:, :E].to(torch.uint8)
    exc_val = _i16_bits(resid_sorted[:, :E])
    n_exc = over.sum(dim=1, dtype=torch.int32)
    row_bad = (~resid_fits).any(dim=1) | (levels.abs() > 32767).any(dim=1)
    if knobs.noise_std > 0 and knobs.noise_sampling:
        row_bad = row_bad | (sigma_raw > 255).any(dim=1)
    n_exc = n_exc + row_bad.to(torch.int32) * (1 << 20)
    return (stream, _i16_bits(levels), sigma_q, ends.to(torch.uint8),
            exc_pos, exc_val, n_exc)


def _flat_compact(flagged: torch.Tensor, vals: torch.Tensor, cap: int):
    """vals[flagged] in row-major order, front-compacted into a (cap,) int32
    buffer with zeros past the total, and the total (JAX predict.py:349).

    A stable per-row sort front-packs each row; each row's first flat slot
    gets its row and its start offset by a scatter-max, and running maxes
    fill the slots between (rows and their prefixes never decrease). An
    empty row, or a row whose prefix lies past `cap` (an overflowing batch),
    writes to the extra slot `cap`, which is cut off: the JAX package's
    `.at[].max(mode="drop")`.
    """
    B, T = flagged.shape
    dev = flagged.device
    (vals_sorted,), _ = _stable_sort_front(flagged, vals)
    n_row = flagged.sum(dim=1, dtype=torch.int32)
    prefix = torch.cumsum(n_row, dim=0, dtype=torch.int32) - n_row  # exclusive
    total = prefix[-1] + n_row[-1]
    tgt = torch.where(n_row > 0, prefix, torch.full_like(prefix, cap)).clamp(max=cap).long()
    rows = torch.arange(B, dtype=torch.int32, device=dev)

    def fill(src):
        slots = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        slots.scatter_reduce_(0, tgt, src, reduce="amax")
        return torch.cummax(slots[:cap], dim=0).values

    row_of, start_of = fill(rows), fill(prefix)
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    src = (row_of * T + (slot - start_of)).clamp(0, B * T - 1).long()
    flat = vals_sorted.reshape(-1)[src].to(torch.int32)
    return torch.where(slot < total, flat, torch.zeros_like(flat)), total


def _pack_event_wire_ulp(dec, seg_parts, noise_stdev, read_idx, knobs: PredictKnobs):
    """The 2-bit ULP event tier (JAX predict.py:384). The bf16 decoder
    output is >= +0, so its raw bits are a monotonic ordinal (1 ULP = 1):
    each event's first frame ships as bits (a u16 anchor and i8 deltas
    against the previous non-zero level; -128 = a zero level, -127 = the
    exact u16 in the batch-flat `lvl_esc`), the frames between as 2-bit
    symbols (+0, +1, -1 ULP, escape), escapes as biased nibbles in a
    batch-flat buffer (nibble 8 = a wide jump, whose exact i32 sits in the
    batch-flat `wide`). The decoder derives each row's offsets into the flat
    buffers by walking the rows in order. flags is 1 on every row when a
    flat buffer overflows, and on a row whose stdev field overflows.

    Returns (stream (B, ceil(T/4)) u8, lvl0 (B,) u16 as i16 bits, lvl_d
    (B, K) i8, sigma_q (B, K) u8, ends (B, K) u8, esc (B, NIB/2) u8, lvl_esc
    (B,) u16 as i16 bits, wide (B,) u8, flags (B,) u8).
    """
    B, T = dec.shape
    ends, starts_ext, _, is_start = seg_parts
    K = ends.shape[1]
    if T > 255 or B < 4 or dec.dtype != torch.bfloat16:
        raise ValueError("the ULP event tier needs bfloat16 compute, T < 256 and "
                         f"B >= 4 (got {dec.dtype}, T = {T}, B = {B})")
    dev = dec.device
    cap_esc = B * WIRE_ESC_NIB_PER_ROW
    cap_wide = max(B // 4, 1)
    cap_lvl = B

    # bf16 bits as an unsigned ordinal in int32 (torch has few uint16 ops)
    ord_ = dec.view(torch.int16).to(torch.int32) & 0xFFFF
    ord_ = torch.where(read_idx[:, None] >= 0, ord_, torch.zeros_like(ord_))
    levels32 = torch.gather(ord_, 1, starts_ext.clamp(max=T - 1).long())  # (B, K+1)

    lvl_nz = levels32 != 0
    e_idx = torch.arange(K + 1, dtype=torch.int32, device=dev).expand(B, -1)
    last_nz = torch.cummax(torch.where(lvl_nz, e_idx, torch.full_like(e_idx, -1)),
                           dim=1).values
    prev_idx = torch.cat([torch.full_like(last_nz[:, :1], -1), last_nz[:, :-1]], dim=1)
    prev_nz = torch.where(prev_idx >= 0,
                          torch.gather(levels32, 1, prev_idx.clamp_min(0).long()),
                          torch.zeros_like(levels32))
    lvl_delta = levels32 - prev_nz
    lvl_is_esc = lvl_nz & ((lvl_delta < -126) | (lvl_delta > 126))
    lvl_d = torch.where(~lvl_nz, torch.full_like(lvl_delta, -128),
                        torch.where(lvl_is_esc, torch.full_like(lvl_delta, -127), lvl_delta))
    lvl_d = lvl_d[:, 1:].to(torch.int8)  # event 0 ships as the u16 anchor
    lvl0 = _i16_bits(levels32[:, 0])
    lvl_flat, n_lvl_total = _flat_compact(lvl_is_esc[:, 1:], levels32[:, 1:], cap_lvl)
    lvl_esc = _i16_bits(lvl_flat)  # one u16 slot per row

    sigma_q, sigma_raw = _sigma_wire(noise_stdev, knobs)

    d = torch.diff(ord_, dim=1, prepend=torch.zeros_like(ord_[:, :1]))
    d = torch.where(is_start, torch.zeros_like(d), d)  # starts come from the levels
    sym = torch.full_like(d, 3)
    sym = torch.where(d == -1, torch.full_like(d, 2), sym)
    sym = torch.where(d == 1, torch.ones_like(d), sym)
    sym = torch.where(d == 0, torch.zeros_like(d), sym)
    q = torch.nn.functional.pad(sym, (0, (-T) % 4)).reshape(B, -1, 4)
    stream = (q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)).to(torch.uint8)

    is_esc = sym == 3
    is_wide = (d < -8) | (d > 7)
    nib_val = torch.where(is_wide, torch.full_like(d, 8), d.clamp(-8, 7) + 8)
    nib_flat, n_esc_total = _flat_compact(is_esc, nib_val, cap_esc)
    esc = (nib_flat[0::2] | (nib_flat[1::2] << 4)).to(torch.uint8).reshape(B, -1)

    # the wide jumps' exact i32 values, as bytes, zero-padded to one a row
    wide, n_wide_total = _flat_compact(is_wide, d, cap_wide)
    wide_b = torch.cat([wide.view(torch.uint8),
                        torch.zeros(B - 4 * cap_wide, dtype=torch.uint8, device=dev)])

    batch_bad = (n_esc_total > cap_esc) | (n_wide_total > cap_wide) | (n_lvl_total > cap_lvl)
    flags = batch_bad.expand(B)
    if knobs.noise_std > 0 and knobs.noise_sampling:
        flags = flags | (sigma_raw > 255).any(dim=1)
    return (stream, lvl0, lvl_d, sigma_q, ends.to(torch.uint8), esc, lvl_esc, wide_b,
            flags.to(torch.uint8))


def _pack_wire(signal_compact: torch.Tensor, counts: torch.Tensor, bits: int):
    """The 8- and 12-bit delta tiers (JAX predict.py:558): first differences
    of the front-compacted rows, clipped to int8 or to biased 12-bit fields
    packed two to three bytes, plus up to WIRE_EXC_SLOTS[bits] exact
    (position, residual) exceptions per row. n_exc is the row's true
    exception count, + 1 << 20 where a residual does not fit int16.

    Returns (stream, exc_pos (B, E) u8, exc_val (B, E) i16, n_exc (B,) i32).
    """
    B, T = signal_compact.shape
    pos = torch.arange(T, dtype=torch.int32, device=signal_compact.device)[None, :]
    live = pos < counts[:, None]
    s = torch.where(live, signal_compact.to(torch.int32), torch.zeros_like(pos))
    d = torch.diff(s, dim=1, prepend=torch.zeros_like(s[:, :1]))
    d = torch.where(live, d, torch.zeros_like(d))

    if bits == 8:
        lo = d.clamp(-127, 127)
        stream = lo.to(torch.int8)
    elif bits == 12:
        if T % 2:
            raise ValueError("12-bit packing needs an even frame budget")
        lo = d.clamp(-2048, 2047)
        u = lo + 2048  # 12-bit biased fields
        u0, u1 = u[:, 0::2], u[:, 1::2]
        stream = torch.stack([u0 & 0xFF, (u0 >> 8) | ((u1 & 0xF) << 4), u1 >> 4], dim=-1)
        stream = stream.reshape(B, (T // 2) * 3).to(torch.uint8)
    else:
        raise ValueError(f"unsupported wire_bits {bits}")
    resid = d - lo  # exact correction, 0 for in-range deltas
    over = resid != 0
    resid_fits = (resid >= -32768) & (resid <= 32767)
    (resid_sorted,), pos_sorted = _stable_sort_front(over, resid)
    E = WIRE_EXC_SLOTS[bits]
    exc_pos = pos_sorted[:, :E].to(torch.uint8)
    exc_val = _i16_bits(resid_sorted[:, :E])
    n_exc = over.sum(dim=1, dtype=torch.int32)
    n_exc = n_exc + (~resid_fits).any(dim=1).to(torch.int32) * (1 << 20)
    return stream, exc_pos, exc_val, n_exc


def wire_layout(bits: int, T: int, K: int):
    """Per-row field layout of the framed wire (JAX predict.py:616): shared by
    `_frame_outputs` and runtime/wire.unframe_wire. Each entry is (name,
    numpy dtype, count)."""
    if bits == 2:
        return [("stream", np.uint8, (T + 3) // 4),
                ("lvl0", np.uint16, 1), ("lvl_d", np.int8, K),
                ("sigma_q", np.uint8, K), ("ends", np.uint8, K),
                ("esc", np.uint8, WIRE_ESC_NIB_PER_ROW // 2),
                ("lvl_esc", np.uint16, 1), ("wide", np.uint8, 1),
                ("flags", np.uint8, 1)]
    if bits == 4:
        E = WIRE_EXC_SLOTS[4]
        return [("stream", np.uint8, T // 2), ("levels", np.int16, K + 1),
                ("sigma_q", np.uint8, K), ("ends", np.uint8, K),
                ("exc_pos", np.uint8, E), ("exc_val", np.int16, E),
                ("n_exc", np.int32, 1)]
    if bits in (8, 12):
        E = WIRE_EXC_SLOTS[bits]
        W = T if bits == 8 else (T // 2) * 3
        return [("stream", np.int8 if bits == 8 else np.uint8, W),
                ("exc_pos", np.uint8, E), ("exc_val", np.int16, E),
                ("n_exc", np.int32, 1), ("counts", np.int32, 1)]
    return [("signal", np.int16, T), ("counts", np.int32, 1)]


def row_bytes(bits: int, T: int, K: int) -> int:
    """Bytes per row of the framed wire at this tier."""
    return sum(np.dtype(dt).itemsize * n for _, dt, n in wire_layout(bits, T, K))


def _frame_outputs(outs) -> torch.Tensor:
    """A tier's outputs as one (B, ROW_BYTES) uint8 tensor: each field's
    bytes, little-endian (as the GPU and x86 store them), in layout order."""
    B = outs[0].shape[0]
    return torch.cat([o.reshape(B, -1).contiguous().view(torch.uint8) for o in outs], dim=1)


def launching(device: torch.device, stream=None):
    """The calling thread's torch state for launching on `device`: inference
    mode, and on a card the device guard and `stream` (the thread's current
    stream when None)."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.inference_mode())
    if device.type == "cuda":
        stack.enter_context(torch.cuda.device(device))
        if stream is not None:
            stack.enter_context(torch.cuda.stream(stream))
    return stack


class ShardLaunchers:
    """One launching thread per device shard, alive for a whole run.

    Shard i's work runs on thread `seq2squiggle-shard{i}` under
    `torch.inference_mode()`, with devices[i] current and, on a card, its own
    stream: torch keeps grad mode, the current device and the current stream
    per thread, and two shards of one card must not share a stream. Only the
    part of a launch that releases the interpreter lock overlaps another
    thread's; with a step of ~10k small launches the threads mostly take
    turns at the lock (PERF.md, "The parallel layer on one card"). `close`
    (or leaving the `with` block) joins the threads."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]
        # the shards share the cores: each thread's CPU ops get its share of
        # the intra-op threads (a per-thread setting), not all of them each
        share = max(1, torch.get_num_threads() // len(self.devices))
        self._pools = [ThreadPoolExecutor(1, thread_name_prefix=f"seq2squiggle-shard{i}",
                                          initializer=torch.set_num_threads, initargs=(share,))
                       for i in range(len(self.devices))]

    def submit(self, i: int, fn, *args):
        """Run fn(*args) on shard i's thread; a future of its result."""
        def run():
            with launching(self.devices[i], self.streams[i]):
                return fn(*args)

        return self._pools[i].submit(run)

    def close(self):
        for pool in self._pools:
            pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def predict_step_sharded(replicas: dict, codes, read_idx, chunk_off, base_keys: dict,
                         n_kmers=None, *, config: dict, knobs: PredictKnobs,
                         devices, launchers: Optional[ShardLaunchers] = None,
                         ready=None) -> torch.Tensor:
    """Data-parallel predict over `devices`: the counterpart of the JAX
    package's make_predict_fn_sharded (shard_map over a 1-D 'dp' mesh).

    The batch's rows split shard-major into len(devices) equal slabs; slab i
    runs `predict_step(..., framed=True)` on devices[i] with that device's
    replica of the parameters (`replicas[device]`) and key
    (`base_keys[device]`), so each shard packs its own flat buffers with its
    own caps; the framed rows come back concatenated in shard order on
    devices[0], on the calling thread's current stream. The per-chunk keys
    derive from global read indices, so the rows are bit-identical to one
    device's. No collective: a device may appear more than once (several
    shards on one card). Inputs are host tensors or on any device; each slab
    moves to its own. `ready`, a CUDA event, is waited on before the inputs
    are read (the producer's copy into them).

    With n > 1 each slab is launched from its shard's thread in `launchers`
    (the run's ShardLaunchers; without one, a pool lives for this call).
    With n = 1 the calling thread launches the step itself and its rows come
    back as they are, with no copy."""
    n = len(devices)
    B = codes.shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over {n} devices")
    per = B // n

    def shard(i, dev):
        rows = slice(i * per, (i + 1) * per)

        def put(t):
            if t is None:
                return None
            if t.is_cuda:  # read on this thread's stream, made on the producer's
                stream = torch.cuda.current_stream(t.device)
                if ready is not None:
                    stream.wait_event(ready)
                t.record_stream(stream)
            return t[rows].to(dev, non_blocking=True)

        out = predict_step(replicas[dev], put(codes), put(read_idx), put(chunk_off),
                           base_keys[dev], put(n_kmers), config=config, knobs=knobs,
                           framed=True)
        done = None
        if out.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out.device))
        return out, done

    if n == 1:
        return shard(0, devices[0])[0]
    pool = launchers or ShardLaunchers(devices)
    try:
        futures = [pool.submit(i, shard, i, dev) for i, dev in enumerate(devices)]
        outs = [f.result() for f in futures]
    finally:
        if launchers is None:
            pool.close()
    parts = []
    for out, done in outs:
        if done is not None:  # made on the shard's stream, read on this thread's
            stream = torch.cuda.current_stream(out.device)
            stream.wait_event(done)
            out.record_stream(stream)
        parts.append(out.to(devices[0], non_blocking=True))
    return torch.cat(parts)
