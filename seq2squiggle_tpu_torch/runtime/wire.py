"""Host-side decoders for the packed device->host wire formats: the port's
own copy of seq2squiggle_tpu/runtime/wire.py, with the jax parts in torch.

Delta tiers (8/12 bit): the device ships narrow first-differences of the
front-compacted int16 signal plus up to WIRE_EXC_SLOTS[bits] exact
(position, residual) exceptions per row (see runtime/predict._pack_wire).
Reconstruction is two vectorised passes: scatter the residuals, then a
row-wise cumulative sum.

Event tiers (2/4): the device ships the CLEAN signal's sufficient
statistics and EventWireDecoder regenerates the Gaussian amplitude noise
on the host CPU from the same per-chunk threefry keys the device path
uses. Output is deterministic and invariant to batch size and sharding.

Tier 4 ships per-event digitised levels + 4-bit within-event count
deltas (runtime/predict._pack_event_wire); the clean signal is quantised
to integer counts BEFORE noise, so samples sit within 1 ADC count of the
raw tier. Tier 2 ("ulp", the default under bfloat16 compute) ships the
bf16 BITS at event starts (as a u16 anchor + i8 ordinal deltas) + 2-bit
ULP deltas with batch-flat escape buffers whose per-row offsets the
decoder derives itself (runtime/predict._pack_event_wire_ulp, 127 B/row);
the decoder's exact bf16 output is rebuilt and the device's own f32
digitisation chain replayed, so noise-free and static-noise runs are
BIT-IDENTICAL to the raw tier and sampled-noise runs stay within the
1-count sigma quantisation. (A batch that overflows a tier's budget is
recomputed through the raw tier — runtime/simulate — so its samples are
raw-exact.)

The C++ decoders are the port's copy of io/native/slow5_codec.cc. The numpy
paths are the parity oracle; their noise comes from the port's threefry
(prng.py, sampling.py), which draws what jax.random draws bit for bit, so
they give what the JAX package's numpy paths give.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import prng, tracing
from ..sampling import per_chunk_keys, sample_normal
from .predict import PredictKnobs, WIRE_EXC_SLOTS, wire_layout


def unframe_wire(buf: np.ndarray, bits: int, T: int, K: int):
    """Split one (B, ROW_BYTES) uint8 wire buffer back into the tier's
    arrays (see predict.wire_layout / predict._frame_outputs).

    Returns a tuple in layout order; 1-wide int32 fields are squeezed to
    (B,). Fields are copied out of the row (cheap: one row's worth of
    bytes) because numpy cannot reinterpret a non-contiguous slice.
    """
    out = []
    off = 0
    for name, dtype, n in wire_layout(bits, T, K):
        width = n * np.dtype(dtype).itemsize
        field = np.ascontiguousarray(buf[:, off:off + width]).view(dtype)
        out.append(field[:, 0] if n == 1 else field)
        off += width
    if off != buf.shape[1]:
        raise ValueError(
            f"wire buffer is {buf.shape[1]} B/row, layout expects {off}"
        )
    return tuple(out)


def _native_lib():
    """The C++ codec library, or None (then the numpy fallbacks run)."""
    from ..io.native.build import load_native

    return load_native()


def delta_native(stream: np.ndarray, bits: int, use_native: bool = True):
    """The C++ codec when unpack_wire decodes this delta stream with it, else
    None (no codec, or rows past its 256 frames: then numpy runs)."""
    T = stream.shape[1] if bits == 8 else (stream.shape[1] // 3) * 2
    return _native_lib() if use_native and bits in (8, 12) and T <= 256 else None


def saturate_i16(x: np.ndarray) -> np.ndarray:
    """Rounded f32 digitised samples -> int16 with a DEFINED boundary:
    NaN -> 0, +/-inf and out-of-range values clamp to the int16 edges.

    All three decode paths (the jitted device digitisation in
    runtime/predict.predict_step, the C++ decoders' saturate_i16 in
    io/native/slow5_codec.cc, and this numpy fallback) share this exact
    contract, pinned by tests/test_wire.py::test_int16_saturation_* — a
    corrupted wire buffer or an extreme noise draw produces clamped
    values, never a RuntimeWarning, wrapped int, or C++ UB cast.
    """
    x = np.nan_to_num(x, copy=True, nan=0.0, posinf=32767.0, neginf=-32768.0)
    np.clip(x, -32768.0, 32767.0, out=x)
    return x.astype(np.int16)


def unpack_wire(stream: np.ndarray, exc_pos: np.ndarray, exc_val: np.ndarray,
                n_exc: np.ndarray, bits: int = 8,
                use_native: bool = True) -> np.ndarray:
    """Narrow deltas + int16 exceptions -> (B,T) int16 signal.

    n_exc rows flagged by the device (slot overflow, or a residual outside
    int16) exceed WIRE_EXC_SLOTS[bits] and raise, so the caller downgrades
    the wire tier and recomputes that batch.

    Decodes through the single-pass C++ kernel (io/native/slow5_codec.cc,
    delta_wire_unpack) when delta_native says so; the numpy path below is
    the portable fallback and the parity oracle.
    """
    slots = WIRE_EXC_SLOTS[bits]
    max_exc = int(np.max(n_exc))
    if max_exc > slots:
        raise RuntimeError(
            f"wire-format exception overflow: a row produced {max_exc} "
            f"out-of-range deltas (> {slots} slots at {bits}-bit width)"
        )
    B = stream.shape[0]
    T = stream.shape[1] if bits == 8 else (stream.shape[1] // 3) * 2
    lib = delta_native(stream, bits, use_native)
    if lib is not None:
        import ctypes

        out = np.empty((B, T), np.int16)
        stream_c = np.ascontiguousarray(stream)
        exc_pos_c = np.ascontiguousarray(exc_pos)
        exc_val_c = np.ascontiguousarray(exc_val)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.delta_wire_unpack(
            stream_c.ctypes.data_as(u8p),
            exc_pos_c.ctypes.data_as(u8p),
            exc_val_c.ctypes.data_as(i16p),
            B, T, exc_pos.shape[1], bits,
            out.ctypes.data_as(i16p),
        )
        return out
    if bits == 8:
        B, T = stream.shape
        d = stream.astype(np.int64)
    elif bits == 12:
        B, W = stream.shape
        T = (W // 3) * 2
        s = stream.reshape(B, T // 2, 3).astype(np.uint32)
        u0 = s[..., 0] | ((s[..., 1] & 0xF) << 8)
        u1 = (s[..., 1] >> 4) | (s[..., 2] << 4)
        u = np.empty((B, T), np.int64)
        u[:, 0::2] = u0
        u[:, 1::2] = u1
        d = u - 2048
    else:
        raise ValueError(f"unsupported wire bits {bits}")
    if exc_val.any():
        flat_idx = (
            np.repeat(np.arange(B, dtype=np.int64), exc_pos.shape[1]) * T
            + exc_pos.reshape(-1).astype(np.int64)
        )
        corr = np.bincount(
            flat_idx, weights=exc_val.reshape(-1).astype(np.float64),
            minlength=B * T,
        ).astype(np.int64).reshape(B, T)
        d = d + corr
    return np.cumsum(d, axis=1).astype(np.int16)


class EventWireDecoder:
    """Decode event-tier batches: clean reconstruction + host-side noise.

    With the native codec available, both the clean-signal rebuild and the
    threefry Gaussian regeneration run as single-pass SIMD C++
    (io/native/slow5_codec.cc) — the C++ threefry replicates jax.random's
    exact key chain and partitionable counter layout, bit-exact on the
    uniform bits and within float-rounding (~1e-5) of jax.random.normal's
    erfinv transform. The fallback path is vectorised numpy for the
    rebuild plus the port's threefry on CPU tensors for the noise, and is
    the parity oracle for tests. One instance per simulation run. Raises
    RuntimeError on exception-slot/sigma/level overflow so the caller can
    recompute that batch through the raw tier. Returns
    (flat_kept_samples, counts) for StreamingExporter.add_flat.
    """

    def __init__(self, knobs: PredictKnobs, base_key, use_native: bool = True,
                 frames: int = None, dp_shards: int = 1):
        self._knobs = knobs
        # prng.key(seed): two uint32 words in an int64 tensor, the words
        # jax.random.key_data gives
        self._base_key = base_key.detach().to("cpu")
        self._use_native = use_native
        self._frames = frames  # required for the ULP tier (stream pads to 4)
        self._dp_shards = dp_shards  # ULP flat buffers are per device shard
        kd = [int(w) & 0xFFFFFFFF for w in self._base_key.tolist()]
        self._key_words = (kd[0], kd[1])
        self._T = None  # set on first call (static shape)
        # the names of its stages' spans (runtime/simulate.stage_timers)
        self.spans = {stage: f"event{knobs.wire_bits}.{stage}"
                      for stage in ("noise_dispatch", "noise_wait", "rebuild")}
        # the last decode ran the C++ decoder (True) or numpy (False)
        self.native_used = None

    def _noise(self, read_idx: np.ndarray, chunk_off: np.ndarray) -> np.ndarray:
        """(B, T) standard normals on the CPU: the device's key chain of
        runtime/predict.predict_step, fold_in(chunk key, 2)."""
        chunk_keys = prng.fold_in(
            per_chunk_keys(self._base_key, torch.from_numpy(np.asarray(read_idx))),
            torch.from_numpy(np.asarray(chunk_off)))
        return sample_normal(prng.fold_in(chunk_keys, 2), (self._T,)).numpy()

    def __call__(self, outs, read_idx: np.ndarray, chunk_off: np.ndarray):
        """outs: the tier's device arrays; returns (flat_samples, counts)."""
        if self._knobs.wire_bits == 2:
            return self._decode_ulp(outs, read_idx, chunk_off)
        knobs = self._knobs
        stream, levels, sigma_q, ends, exc_pos, exc_val, n_exc = (
            np.asarray(o) for o in outs
        )
        max_exc = int(np.max(n_exc)) if n_exc.size else 0
        if max_exc > WIRE_EXC_SLOTS[4]:
            raise RuntimeError(
                f"wire-format exception overflow: a row produced {max_exc} "
                f"out-of-range values (> {WIRE_EXC_SLOTS[4]} slots at the "
                f"event tier)"
            )
        B, W = stream.shape
        T = W * 2
        self._T = T
        cpr = knobs.digitisation / knobs.signal_range
        rows = np.arange(B, dtype=np.intp)[:, None]

        lib = _native_lib() if self._use_native else None
        native = lib is not None and T <= 256

        # The native path draws its own noise in C++ (same key chain); the
        # numpy path draws it here with the port's threefry.
        gauss = None
        if knobs.noise_std > 0 and not native:
            with tracing.span(self.spans["noise_dispatch"]):
                gauss = self._noise(read_idx, chunk_off)
        self.native_used = native

        # Single-pass C++ decode when available (bit-identical to the numpy
        # fallback below given the same noise, asserted by tests/test_wire.py).
        if native:
            import ctypes

            K = ends.shape[1]
            sigma_tail = np.float32(
                knobs.min_noise * knobs.noise_std
                * knobs.scaling_max_value * cpr
            )
            noise_mode = (
                0 if knobs.noise_std <= 0
                else (2 if knobs.noise_sampling else 1)
            )
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i16p = ctypes.POINTER(ctypes.c_int16)
            i32p = ctypes.POINTER(ctypes.c_int32)
            f32p = ctypes.POINTER(ctypes.c_float)
            ridx = np.ascontiguousarray(read_idx, np.int32)
            gauss = None
            with tracing.span(self.spans["noise_wait"]):
                if noise_mode:
                    coff = np.ascontiguousarray(chunk_off, np.int32)
                    gauss = np.empty((B, T), np.float32)
                    lib.threefry_normal_fill(
                        self._key_words[0], self._key_words[1],
                        ridx.ctypes.data_as(i32p), coff.ctypes.data_as(i32p),
                        B, T, gauss.ctypes.data_as(f32p),
                    )
            flat = np.empty(B * T, np.int16)
            counts = np.empty(B, np.int32)
            with tracing.span(self.spans["rebuild"], cpu=True):
                total = lib.event_wire_decode(
                    np.ascontiguousarray(stream).ctypes.data_as(u8p),
                    np.ascontiguousarray(levels).ctypes.data_as(i16p),
                    np.ascontiguousarray(sigma_q).ctypes.data_as(u8p),
                    np.ascontiguousarray(ends).ctypes.data_as(u8p),
                    np.ascontiguousarray(exc_pos).ctypes.data_as(u8p),
                    np.ascontiguousarray(exc_val).ctypes.data_as(i16p),
                    gauss.ctypes.data_as(f32p) if gauss is not None else None,
                    ridx.ctypes.data_as(i32p),
                    B, T, K, exc_pos.shape[1],
                    noise_mode, np.float32(0.25), sigma_tail,
                    np.float32(knobs.noise_std * cpr),
                    np.float32(knobs.offset_mean),
                    flat.ctypes.data_as(i16p),
                    counts.ctypes.data_as(i32p),
                )
            return flat[:total], counts

        # 4-bit biased deltas -> int32, then exact exception residuals.
        # Unused exception slots carry value 0 (stable-sorted tail); real
        # exception positions are unique per row, so unbuffered add.at is
        # exact even when a zero slot aliases a real position.
        d = np.empty((B, T), np.int32)
        d[:, 0::2] = stream & 0xF
        d[:, 1::2] = stream >> 4
        d -= 8
        np.add.at(d, (rows, exc_pos.astype(np.intp)),
                  exc_val.astype(np.int32))

        # segment id per frame via boundary marks + cumsum (O(B*T))
        ends_i = ends.astype(np.intp)
        seg = np.zeros((B, T), np.intp)
        in_range = ends_i < T
        np.add.at(seg, (np.broadcast_to(rows, ends_i.shape)[in_range],
                        ends_i[in_range]), 1)
        np.cumsum(seg, axis=1, out=seg)  # (B, T) in [0, K]

        starts_ext = np.concatenate(
            [np.zeros((B, 1), np.intp), ends_i], axis=1
        )  # (B, K+1)
        start_frame = np.take_along_axis(starts_ext, seg, 1)
        t_grid = np.arange(T, dtype=np.intp)[None, :]
        d[t_grid == start_frame] = 0  # starts come from `levels`

        # clean_q[t] = level[seg(t)] + within-segment cumulative delta
        np.cumsum(d, axis=1, out=d)
        np.minimum(start_frame, T - 1, out=start_frame)
        C_start = np.take_along_axis(d, start_frame, 1)
        level_f = np.take_along_axis(levels.astype(np.int32), seg, 1)
        clean_q = level_f
        clean_q += d
        clean_q -= C_start  # (B, T) int32, >= 0
        nz = clean_q > 0

        if knobs.noise_std > 0:
            if knobs.noise_sampling:
                # tail segment (seg == K): length regulation extends the
                # stdev with zeros, so the device-side clamp floor is
                # min_noise
                sigma_tail = (knobs.min_noise * knobs.noise_std
                              * knobs.scaling_max_value * cpr)
                sigma_ev = np.concatenate(
                    [sigma_q.astype(np.float32) * 0.25,
                     np.full((B, 1), sigma_tail, np.float32)], axis=1,
                )  # (B, K+1) ADC counts
                sigma_f = np.take_along_axis(sigma_ev, seg, 1)
                noisy = gauss * sigma_f
            else:
                noisy = gauss * np.float32(
                    knobs.noise_std * cpr
                )
            noisy += clean_q
            out_f = np.where(nz, noisy, np.float32(0.0))
        else:
            out_f = np.where(nz, clean_q, 0).astype(np.float32)

        np.maximum(out_f, 0.0, out=out_f)
        keep = out_f != 0.0
        keep &= read_idx[:, None] >= 0
        # np.rint = round-half-to-even, same as the device digitisation
        out_f -= knobs.offset_mean
        np.rint(out_f, out=out_f)
        counts = keep.sum(axis=1).astype(np.int32)
        return saturate_i16(out_f[keep]), counts

    def _decode_ulp(self, outs, read_idx: np.ndarray, chunk_off: np.ndarray):
        """Decode the ULP event tier (predict._pack_event_wire_ulp).

        Reconstructs the decoder's EXACT bfloat16 output from per-event
        bf16 bit levels + 2-bit ULP deltas (escapes in the 4-bit side
        channel, residuals in the exception slots), then replays the
        device's own digitisation chain in f32. Noise-free and
        static-noise batches are BIT-IDENTICAL to the raw tier through
        the numpy path; sampled-noise batches are within 1 ADC count
        (quarter-count sigma quantisation; the native threefry fill adds
        float-rounding-level noise deviations, still inside 1 count).
        """
        knobs = self._knobs
        stream, lvl0, lvl_d, sigma_q, ends, esc, lvl_esc, wide_b, flags = (
            np.asarray(o) for o in outs
        )
        if flags.any():
            raise RuntimeError(
                "wire-format exception overflow: the device flagged "
                f"{int((flags != 0).sum())} rows (sigma field or batch "
                "escape-buffer overflow at the ULP event tier)"
            )
        B = stream.shape[0]
        T = self._frames if self._frames is not None else stream.shape[1] * 4
        self._T = T
        rows = np.arange(B, dtype=np.intp)[:, None]
        # A batch from dp_shards devices concatenates per-shard flat buffers,
        # each with its own caps; no offsets ship on the wire: rows consume
        # their shard's buffers in row-major order, so per-row starts are
        # shard-local exclusive cumulative counts.
        dp = self._dp_shards
        B_s = B // dp
        cap_esc_s = esc.size * 2 // dp  # nibbles per shard
        cap_wide_s = B_s // 4  # i32 slots per shard (byte-packed)
        cap_lvl_s = B_s  # u16 escaped-level slots per shard

        lib = _native_lib() if self._use_native else None
        native = lib is not None and T <= 255

        gauss = None
        if knobs.noise_std > 0 and not native:
            with tracing.span(self.spans["noise_dispatch"]):
                gauss = self._noise(read_idx, chunk_off)
        self.native_used = native

        scale_s = np.float32(knobs.scaling_max_value)
        dig = np.float32(knobs.digitisation)
        rng_f = np.float32(knobs.signal_range)
        offset = np.float32(knobs.offset_mean)
        # sigma wire (quarter ADC counts) back to pA: one f32 multiply, so
        # both decode paths quantise identically.
        sigma_scale_pa = np.float32(
            0.25 * knobs.signal_range / knobs.digitisation
        )
        sigma_tail_pa = np.float32(knobs.min_noise * knobs.noise_std
                                   * knobs.scaling_max_value)
        noise_mode = (
            0 if knobs.noise_std <= 0 else (2 if knobs.noise_sampling else 1)
        )

        if native:
            import ctypes

            K = ends.shape[1]
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            i16p = ctypes.POINTER(ctypes.c_int16)
            i32p = ctypes.POINTER(ctypes.c_int32)
            f32p = ctypes.POINTER(ctypes.c_float)
            i8p = ctypes.POINTER(ctypes.c_int8)
            ridx = np.ascontiguousarray(read_idx, np.int32)
            coff = np.ascontiguousarray(chunk_off, np.int32)
            flat = np.empty(B * T, np.int16)
            counts = np.empty(B, np.int32)
            # The C++ decoder regenerates each row's threefry normals inside
            # its vector pass: no (B, T) gauss buffer exists at all.
            with tracing.span(self.spans["rebuild"], cpu=True):
                total = lib.ulp_event_wire_decode_fused(
                    np.ascontiguousarray(stream).ctypes.data_as(u8p),
                    np.ascontiguousarray(lvl0).ctypes.data_as(u16p),
                    np.ascontiguousarray(lvl_d).ctypes.data_as(i8p),
                    np.ascontiguousarray(sigma_q).ctypes.data_as(u8p),
                    np.ascontiguousarray(ends).ctypes.data_as(u8p),
                    np.ascontiguousarray(esc).ctypes.data_as(u8p),
                    np.ascontiguousarray(lvl_esc).ctypes.data_as(u16p),
                    np.ascontiguousarray(wide_b).ctypes.data_as(u8p),
                    self._key_words[0], self._key_words[1],
                    coff.ctypes.data_as(i32p), ridx.ctypes.data_as(i32p),
                    B, T, K, B_s, cap_esc_s, cap_wide_s, cap_lvl_s,
                    noise_mode, sigma_scale_pa, sigma_tail_pa,
                    np.float32(knobs.noise_std), scale_s, dig, rng_f, offset,
                    flat.ctypes.data_as(i16p),
                    counts.ctypes.data_as(i32p),
                )
            if total == ctypes.c_size_t(-1).value:
                raise RuntimeError(
                    "wire-format exception overflow: escape buffer bounds "
                    "exceeded at the ULP event tier"
                )
            return flat[:total], counts

        # ---- numpy fallback (parity oracle) ----
        with tracing.span(self.spans["rebuild"], cpu=True):
            def shard_excl_offsets(row_counts):
                """Per-row exclusive start offsets into the row's shard-local flat
                buffer (rows are shard-major)."""
                cum = np.cumsum(row_counts) - row_counts  # global exclusive
                base = np.repeat(cum[0::B_s], B_s)[:B]
                return (cum - base).astype(np.intp)

            shard = rows // B_s  # (B, 1)

            # Event levels: u16 anchor + i8 deltas vs the previous non-zero
            # level; -128 = zero level, -127 = escape (exact u16 in lvl_esc).
            lvl_d_i = lvl_d.astype(np.int32)
            is_zero_l = lvl_d_i == -128
            is_esc_l = lvl_d_i == -127
            lrank = np.cumsum(is_esc_l, axis=1) - is_esc_l
            lvl_off = shard_excl_offsets(is_esc_l.sum(axis=1))
            glidx = shard * cap_lvl_s + lvl_off[:, None] + lrank
            if is_esc_l.any():
                cap_end = np.broadcast_to((shard + 1) * cap_lvl_s, glidx.shape)
                if (glidx[is_esc_l] >= cap_end[is_esc_l]).any():
                    raise RuntimeError(
                        "wire-format exception overflow: level-escape buffer "
                        "bounds exceeded at the ULP event tier"
                    )
            lvl_esc_flat = lvl_esc.reshape(-1)
            lvl_vals = lvl_esc_flat[
                np.minimum(glidx, lvl_esc_flat.size - 1)
            ].astype(np.int32)
            K = lvl_d.shape[1]
            levels = np.zeros((B, K + 1), np.int32)
            levels[:, 0] = lvl0
            prev = np.where(lvl0 != 0, lvl0, 0).astype(np.int32)
            for e in range(1, K + 1):
                col = np.where(
                    is_zero_l[:, e - 1], 0,
                    np.where(is_esc_l[:, e - 1], lvl_vals[:, e - 1],
                             prev + lvl_d_i[:, e - 1]),
                )
                levels[:, e] = col
                prev = np.where(col != 0, col, prev)

            W = stream.shape[1]
            sym = np.empty((B, W * 4), np.uint8)
            for j in range(4):
                sym[:, j::4] = (stream >> (2 * j)) & 3
            sym = sym[:, :T]
            d = (sym == 1).astype(np.int32) - (sym == 2).astype(np.int32)
            is_esc = sym == 3
            esc_i = is_esc.astype(np.int32)
            # Flat nibble index per escape: shard base + derived row offset +
            # row-local exclusive rank (row-major stream order, as packed).
            rank = np.cumsum(esc_i, axis=1) - esc_i
            esc_off = shard_excl_offsets(esc_i.sum(axis=1))
            gidx = shard * cap_esc_s + esc_off[:, None] + rank
            if is_esc.any():
                cap_end = np.broadcast_to((shard + 1) * cap_esc_s, gidx.shape)
                if (gidx[is_esc] >= cap_end[is_esc]).any():
                    raise RuntimeError(
                        "wire-format exception overflow: escape buffer bounds "
                        "exceeded at the ULP event tier"
                    )
            nib_flat = np.empty(esc.size * 2, np.uint8)
            esc_flat = esc.reshape(-1)
            nib_flat[0::2] = esc_flat & 0xF
            nib_flat[1::2] = esc_flat >> 4
            esc_vals = nib_flat[np.minimum(gidx, nib_flat.size - 1)].astype(
                np.int32
            ) - 8
            is_wide = is_esc & (esc_vals == 0)  # nibble 8 marks a wide jump
            wide_i = is_wide.astype(np.int32)
            wrank = np.cumsum(wide_i, axis=1) - wide_i
            wide_off = shard_excl_offsets(wide_i.sum(axis=1))
            gwidx = shard * cap_wide_s + wide_off[:, None] + wrank
            if is_wide.any():
                cap_end = np.broadcast_to((shard + 1) * cap_wide_s, gwidx.shape)
                if (gwidx[is_wide] >= cap_end[is_wide]).any():
                    raise RuntimeError(
                        "wire-format exception overflow: wide-jump buffer "
                        "bounds exceeded at the ULP event tier"
                    )
            # The wide buffer ships as bytes (one per row, zero-padded); each
            # shard's i32 slots occupy the first cap_wide_s*4 bytes of its span.
            wb = wide_b.reshape(dp, B_s)
            wide_flat = np.zeros(max(dp * cap_wide_s, 1), np.int32)
            if cap_wide_s:
                for sh in range(dp):
                    wide_flat[sh * cap_wide_s:(sh + 1) * cap_wide_s] = np.ascontiguousarray(
                        wb[sh, :cap_wide_s * 4]).view(np.int32)
            wide_vals = wide_flat[np.minimum(gwidx, wide_flat.size - 1)]
            d = np.where(is_esc, np.where(is_wide, wide_vals, esc_vals), d)

            # segment machinery identical to the 4-bit tier
            ends_i = ends.astype(np.intp)
            seg = np.zeros((B, T), np.intp)
            in_range = ends_i < T
            np.add.at(seg, (np.broadcast_to(rows, ends_i.shape)[in_range],
                            ends_i[in_range]), 1)
            np.cumsum(seg, axis=1, out=seg)
            starts_ext = np.concatenate(
                [np.zeros((B, 1), np.intp), ends_i], axis=1
            )
            start_frame = np.take_along_axis(starts_ext, seg, 1)
            t_grid = np.arange(T, dtype=np.intp)[None, :]
            d[t_grid == start_frame] = 0
            np.cumsum(d, axis=1, out=d)
            np.minimum(start_frame, T - 1, out=start_frame)
            C_start = np.take_along_axis(d, start_frame, 1)
            level_i = np.take_along_axis(levels.astype(np.int32), seg, 1)
            ord_ = level_i + d - C_start  # (B, T) bf16 bit ordinals

            bits16 = ord_.astype(np.uint16)
            p = (bits16.astype(np.uint32) << 16).view(np.float32)
            # Corrupt wire bits may hold NaN/inf/near-max bf16 patterns; the f32
            # chain then overflows by design and saturate_i16 defines the result
            # (C++ float arithmetic does the same silently), so suppress numpy's
            # intermediate-overflow warnings rather than leak them per batch.
            with np.errstate(over="ignore", invalid="ignore"):
                p = p * scale_s  # exact bf16 -> f32 pred, then the device's chain

                if noise_mode == 0:
                    pn = p
                else:
                    if noise_mode == 2:
                        sigma_ev = np.concatenate(
                            [sigma_q.astype(np.float32) * sigma_scale_pa,
                             np.full((B, 1), sigma_tail_pa, np.float32)], axis=1,
                        )  # (B, K+1) pA
                        sigma_f = np.take_along_axis(sigma_ev, seg, 1)
                    else:
                        sigma_f = np.float32(knobs.noise_std)
                    pn = np.where(p != 0.0, p + gauss * sigma_f, p)
                    np.maximum(pn, np.float32(0.0), out=pn)
                keep = pn != 0.0
                keep &= read_idx[:, None] >= 0
                out_f = (pn * dig) / rng_f - offset
                np.rint(out_f, out=out_f)
                counts = keep.sum(axis=1).astype(np.int32)
                res = saturate_i16(out_f[keep]), counts
        return res
