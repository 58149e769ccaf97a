"""SLOW5 (ASCII) and BLOW5 (binary) writers + readers, dependency-free.

The reference delegates BLOW5/SLOW5 output to pyslow5's C bindings
(src/seq2squiggle/signal_io.py:62-172). That wheel is not part of this
build, so the codec is implemented here from the SLOW5 format specification
(v1.0, slow5 version 0.2.0):

ASCII (.slow5):
    #slow5_version\t0.2.0
    #num_read_groups\t1
    @<attr>\t<value>            (one line per read-group header attribute)
    #<type list>                (primary + aux column types)
    #<column name list>
    one TSV line per read; raw_signal is comma-separated int16 values.

Binary (.blow5), little-endian throughout (see docs/SLOW5_SPEC_NOTES.md for
the spec-derivation notes and tests/test_slow5_goldens.py for the byte-level
golden assertions):
    [0..5]   magic "BLOW5\\x01"
    [6..8]   version 0.2.0 (three uint8)
    [9]      record compression method (shared enum: 0=none, 1=zlib,
             2=svb-zd, 3=zstd)
    [10]     signal compression method (same enum; svb-zd = 2)
    [11..14] num_read_groups uint32
    [15..63] zero padding (reserved)
    [64..67] header_size uint32 = byte length of the ASCII header block
    [68.. ]  ASCII header block (same text as .slow5 header, uncompressed)
    records: [record_size uint32 = COMPRESSED byte length][record bytes,
              compressed with the record method]
    EOF marker: "5WOLB"

    record bytes (uncompressed layout):
      uint16 read_id_len; char read_id[] (no NUL);
      uint32 read_group; double digitisation; double offset; double range;
      double sampling_rate;
      uint64 len_raw_signal: the NUMBER OF int16 SAMPLES when signal
        compression is none, but the BYTE LENGTH of the compressed signal
        blob when signal compression is enabled (slow5lib updates the field
        to the sample count after decompression);
      raw signal: int16[n] (no signal compression) or the compressed blob;
        the svb-zd blob itself starts with a uint64 sample count followed
        by the StreamVByte stream;
      aux fields in header order: primitive types stored raw little-endian;
        array types including char* stored as uint64 element count + data.

svb-zd is StreamVByte over zig-zag-encoded first differences of the int16
signal (the scheme slow5lib uses): a control stream of 2-bit
bytes-per-value codes packed 4 values/byte (first value in the low bits),
then the variable-length little-endian data stream.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import tracing

logger = logging.getLogger("seq2squiggle_tpu_torch")

SLOW5_VERSION = "0.2.0"
_MAGIC = b"BLOW5\x01"
_EOF = b"5WOLB"
_HEADER_SIZE_OFFSET = 64

# Compression method codes — ONE shared enum for both the record and the
# signal method bytes (slow5lib slow5_press_method): 0=none, 1=zlib,
# 2=svb-zd, 3=zstd. Round-1 wrote svb-zd as 1, which slow5lib would parse
# as zlib signal compression; fixed to the spec value.
PRESS_NONE = 0
PRESS_ZLIB = 1
PRESS_SVB_ZD = 2
PRESS_ZSTD = 3
# Aliases for the signal-method byte (same enum).
SIGPRESS_NONE = PRESS_NONE
SIGPRESS_SVB_ZD = PRESS_SVB_ZD

# Primary columns (type, name) in spec order.
_PRIMARY = [
    ("char*", "read_id"),
    ("uint32_t", "read_group"),
    ("double", "digitisation"),
    ("double", "offset"),
    ("double", "range"),
    ("double", "sampling_rate"),
    ("uint64_t", "len_raw_signal"),
    ("int16_t*", "raw_signal"),
]
# Aux columns written by this framework (matches the fields the reference
# populates at signal_io.py:156-161).
_AUX = [
    ("char*", "channel_number"),
    ("double", "median_before"),
    ("int32_t", "read_number"),
    ("uint8_t", "start_mux"),
    ("uint64_t", "start_time"),
]


# ---------------------------------------------------------------------------
# svb-zd signal codec (StreamVByte over zig-zag deltas), vectorised numpy
# ---------------------------------------------------------------------------


def zigzag_delta_encode(signal: np.ndarray) -> np.ndarray:
    """int16 signal -> uint32 zig-zag-encoded first differences."""
    s = signal.astype(np.int32)
    deltas = np.diff(s, prepend=np.int32(0))
    return ((deltas << 1) ^ (deltas >> 31)).astype(np.uint32)


def zigzag_delta_decode(zz: np.ndarray) -> np.ndarray:
    deltas = (zz >> np.uint32(1)).astype(np.int32) ^ -(zz & np.uint32(1)).astype(
        np.int32
    )
    return np.cumsum(deltas, dtype=np.int64).astype(np.int16)


def _native():
    from .native.build import load_native

    return load_native()


def svb_zd_encode_signal(signal: np.ndarray) -> bytes:
    """int16 signal -> svb-zd bytes, via the native C++ codec when available
    (single pass), else the vectorised numpy path."""
    sig = np.ascontiguousarray(signal, "<i2")
    lib = _native()
    if lib is not None and len(sig):
        import ctypes

        cap = lib.svb_zd_max_size(len(sig))
        out = np.empty(cap, np.uint8)
        n = lib.svb_zd_encode(
            sig.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            len(sig),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out[:n].tobytes()
    return svb_encode(zigzag_delta_encode(sig))


def svb_zd_decode_signal(data: bytes, count: int) -> np.ndarray:
    lib = _native()
    if lib is not None and count:
        import ctypes

        out = np.empty(count, np.int16)
        buf = np.frombuffer(data, np.uint8)
        n = lib.svb_zd_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf),
            count,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        )
        if n == count:
            return out
    return zigzag_delta_decode(svb_decode(data, count))


def svb_encode(values: np.ndarray) -> bytes:
    """StreamVByte-encode uint32 values: control stream + data stream."""
    n = len(values)
    if n == 0:
        return b""
    v = values.astype(np.uint32)
    nbytes = np.ones(n, np.uint8)
    nbytes[v > 0xFF] = 2
    nbytes[v > 0xFFFF] = 3
    nbytes[v > 0xFFFFFF] = 4
    codes = nbytes - 1  # 2-bit codes

    # Control stream: 4 codes per byte, little positions first.
    n_ctrl = (n + 3) // 4
    codes_padded = np.zeros(n_ctrl * 4, np.uint8)
    codes_padded[:n] = codes
    ctrl = (
        codes_padded[0::4]
        | (codes_padded[1::4] << 2)
        | (codes_padded[2::4] << 4)
        | (codes_padded[3::4] << 6)
    ).astype(np.uint8)

    # Data stream: for each value, its nbytes low-order bytes.
    as_bytes = v.view(np.uint8).reshape(n, 4)  # little-endian lanes
    total = int(nbytes.sum())
    out = np.empty(total, np.uint8)
    ends = np.cumsum(nbytes.astype(np.int64))
    starts = ends - nbytes
    # Scatter via a mask: position j of value i is kept iff j < nbytes[i].
    lane = np.arange(4, dtype=np.uint8)
    keep = lane[None, :] < nbytes[:, None]
    out[:] = as_bytes[keep]
    del starts
    return ctrl.tobytes() + out.tobytes()


def svb_decode(data: bytes, count: int) -> np.ndarray:
    """Decode StreamVByte stream back to uint32 values."""
    if count == 0:
        return np.zeros(0, np.uint32)
    n_ctrl = (count + 3) // 4
    ctrl = np.frombuffer(data[:n_ctrl], np.uint8)
    codes = np.empty(n_ctrl * 4, np.uint8)
    codes[0::4] = ctrl & 3
    codes[1::4] = (ctrl >> 2) & 3
    codes[2::4] = (ctrl >> 4) & 3
    codes[3::4] = (ctrl >> 6) & 3
    nbytes = codes[:count].astype(np.int64) + 1
    payload = np.frombuffer(data[n_ctrl:], np.uint8)
    lanes = np.zeros((count, 4), np.uint8)
    keep = np.arange(4)[None, :] < nbytes[:, None]
    lanes[keep] = payload[: int(nbytes.sum())]
    return lanes.view(np.uint32)[:, 0].copy()


# ---------------------------------------------------------------------------
# Record encoding
# ---------------------------------------------------------------------------


def _encode_record(
    read_id: str,
    signal: np.ndarray,
    digitisation: float,
    offset: float,
    range_val: float,
    sampling_rate: float,
    aux: dict,
    signal_press: int,
) -> bytes:
    rid = read_id.encode("ascii")
    parts = [struct.pack("<H", len(rid)), rid]
    parts.append(
        struct.pack(
            "<Idddd",
            0,  # read_group
            digitisation,
            offset,
            range_val,
            sampling_rate,
        )
    )
    sig = np.ascontiguousarray(signal, dtype="<i2")
    if signal_press == SIGPRESS_SVB_ZD:
        # Compressed blob = uint64 sample count + StreamVByte stream;
        # len_raw_signal holds the BYTE length of that blob (slow5lib
        # semantics — it rewrites the field to the sample count only after
        # decompression).
        blob = struct.pack("<Q", len(sig)) + svb_zd_encode_signal(sig)
        parts.append(struct.pack("<Q", len(blob)))
        parts.append(blob)
    else:
        parts.append(struct.pack("<Q", len(sig)))
        parts.append(sig.tobytes())
    # Aux array types (char* included) carry a uint64 element count.
    chan = str(aux["channel_number"]).encode("ascii")
    parts.append(struct.pack("<Q", len(chan)))
    parts.append(chan)
    parts.append(
        struct.pack(
            "<diBQ",
            float(aux["median_before"]),
            int(aux["read_number"]),
            int(aux["start_mux"]),
            int(aux["start_time"]),
        )
    )
    return b"".join(parts)


def _decode_record(buf: bytes, signal_press: int) -> dict:
    off = 0
    (rid_len,) = struct.unpack_from("<H", buf, off)
    off += 2
    read_id = buf[off : off + rid_len].decode("ascii")
    off += rid_len
    read_group, dig, offs, rng, rate = struct.unpack_from("<Idddd", buf, off)
    off += 4 + 8 * 4
    (len_raw,) = struct.unpack_from("<Q", buf, off)
    off += 8
    if signal_press == SIGPRESS_SVB_ZD:
        # len_raw is the blob byte length; the blob leads with the count.
        (n_sig,) = struct.unpack_from("<Q", buf, off)
        signal = svb_zd_decode_signal(buf[off + 8 : off + len_raw], n_sig)
        off += len_raw
    else:
        n_sig = len_raw
        signal = np.frombuffer(buf, "<i2", count=n_sig, offset=off).copy()
        off += 2 * n_sig
    (chan_len,) = struct.unpack_from("<Q", buf, off)
    off += 8
    channel_number = buf[off : off + chan_len].decode("ascii")
    off += chan_len
    median_before, read_number, start_mux, start_time = struct.unpack_from(
        "<diBQ", buf, off
    )
    return {
        "read_id": read_id,
        "read_group": read_group,
        "digitisation": dig,
        "offset": offs,
        "range": rng,
        "sampling_rate": rate,
        "len_raw_signal": n_sig,
        "signal": signal,
        "channel_number": channel_number,
        "median_before": median_before,
        "read_number": read_number,
        "start_mux": start_mux,
        "start_time": start_time,
    }


def _press_record(rec: bytes, method: int) -> bytes:
    if method == PRESS_ZLIB:
        lib = _native()
        if lib is not None and rec:
            import ctypes

            cap = lib.zlib_compress_bound(len(rec))
            out = np.empty(cap, np.uint8)
            src = np.frombuffer(rec, np.uint8)
            n = lib.zlib_compress_buf(
                src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(rec),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap, 1,
            )
            if n:
                return out[:n].tobytes()
        return zlib.compress(rec, 1)
    if method == PRESS_ZSTD:
        return _zstd_compressor().compress(rec)
    if method == PRESS_NONE:
        return rec
    raise ValueError(f"unsupported record compression method {method}")


_ZSTD_LOCAL = threading.local()


def _zstd_compressor():
    # One ZstdCompressor per thread: the CCtx is reused across records
    # (per-record construction measured ~2x the compress cost at record
    # sizes ~25 KB) but a single context must not be shared across
    # threads (zstandard's documented contract).
    c = getattr(_ZSTD_LOCAL, "compressor", None)
    if c is None:
        import zstandard

        c = zstandard.ZstdCompressor(level=1)
        _ZSTD_LOCAL.compressor = c
    return c


def _depress_record(rec: bytes, method: int) -> bytes:
    if method == PRESS_ZLIB:
        return zlib.decompress(rec)
    if method == PRESS_ZSTD:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(rec)
    if method == PRESS_NONE:
        return rec
    raise ValueError(f"unsupported record compression method {method}")


def _header_text(header_attrs: Dict[str, object]) -> str:
    lines = [f"#slow5_version\t{SLOW5_VERSION}", "#num_read_groups\t1"]
    for key, value in header_attrs.items():
        lines.append(f"@{key}\t{value}")
    types = "\t".join(t for t, _ in _PRIMARY + _AUX)
    names = "\t".join(n for _, n in _PRIMARY + _AUX)
    lines.append(f"#{types}")
    lines.append(f"#{names}")
    return "\n".join(lines) + "\n"


def _fmt_double(x: float) -> str:
    return f"{float(x):.17g}"


class Slow5FileWriter:
    """Low-level appendable SLOW5/BLOW5 file writer.

    Format is chosen by extension: .slow5 -> ASCII, .blow5 -> binary. Binary
    files default to zlib record compression + svb-zd signal compression
    (the pyslow5 defaults the reference relies on).
    """

    def __init__(
        self,
        filename: str,
        record_press: int = PRESS_ZLIB,
        signal_press: int = SIGPRESS_SVB_ZD,
    ):
        self.filename = str(filename)
        self.binary = self.filename.endswith(".blow5")
        self.record_press = record_press if self.binary else PRESS_NONE
        self.signal_press = signal_press if self.binary else SIGPRESS_NONE
        self._fh = None
        self._header_written = False
        # Grow-only output scratch reused across write_records_batch
        # flushes: a fresh np.empty per flush costs ~0.1 s/flush in
        # first-touch page faults alone (measured), dwarfing the actual
        # encode.
        self._batch_buf: Optional[np.ndarray] = None

    # O_DIRECT bulk-write machinery: buffered fh.write() of a whole
    # compressed flush (~27 MB) costs up to several CPU-seconds on hosts
    # where page-cache folio allocation hits memory compaction (measured;
    # O_DIRECT writes the same bytes at ~0.01 s CPU). The record stream's
    # aligned middle goes through a second O_DIRECT fd; the unaligned head
    # and tail of each flush go through the ordinary buffered fh, so the
    # on-disk bytes are identical and every non-Linux/unsupported-FS case
    # falls back cleanly to the buffered path.
    _DIRECT_ALIGN = 4096

    def _open_direct(self):
        self._fd_direct = -1
        if not self.binary or not hasattr(os, "O_DIRECT"):
            return  # ASCII output never takes the bulk path
        try:
            self._fd_direct = os.open(self.filename, os.O_WRONLY | os.O_DIRECT)
        except OSError:
            self._fd_direct = -1

    def direct_source_offset(self) -> int:
        """Where the batch encoder should place the record stream inside a
        page-aligned scratch buffer so that the aligned middle of the flush
        is also address-aligned: (-((-F) % A)) % A for file offset F."""
        if getattr(self, "_fd_direct", -1) < 0 or self._fh is None:
            return 0
        a = self._DIRECT_ALIGN
        head = (-self._fh.tell()) % a
        return (a - head) % a if head else 0

    def write_bulk(self, out: np.ndarray, s0: int, pos: int):
        """Write out[s0:s0+pos] at the current file position, using
        O_DIRECT for the aligned middle when available. `out` must be
        page-aligned (the batch scratch is mmap-backed) and s0 must come
        from direct_source_offset()."""
        mv = memoryview(out)
        if getattr(self, "_fd_direct", -1) < 0:
            self._fh.write(mv[s0:s0 + pos])
            return
        a = self._DIRECT_ALIGN
        f = self._fh.tell()
        head = min((-f) % a, pos)
        if head:
            self._fh.write(mv[s0:s0 + head])
        aligned = ((pos - head) // a) * a
        if aligned:
            self._fh.flush()
            # pwrite may write fewer bytes than asked (per-call size limits,
            # ENOSPC partway): loop until the whole aligned middle lands, and
            # finish any O_DIRECT-refused remainder through the buffered fh
            # so a short write can never leave a gap of garbage mid-file.
            off = f + head
            src = s0 + head
            remaining = aligned
            while remaining:
                try:
                    n = os.pwrite(self._fd_direct, mv[src:src + remaining],
                                  off)
                except OSError:
                    n = 0
                if n <= 0:
                    break
                off += n
                src += n
                remaining -= n
            if remaining:
                self._fh.seek(off)
                self._fh.write(mv[src:src + remaining])
            self._fh.seek(f + head + aligned)
        tail = pos - head - aligned
        if tail:
            self._fh.write(mv[s0 + head + aligned:s0 + pos])

    def open(self, header_attrs: Dict[str, object]):
        exists = os.path.exists(self.filename)
        if exists:
            # Append: strip the EOF marker of the previous session (binary).
            self._fh = open(self.filename, "r+b")
            self._fh.seek(0, os.SEEK_END)
            if self.binary and self._fh.tell() >= len(_EOF):
                self._fh.seek(-len(_EOF), os.SEEK_END)
                if self._fh.read(len(_EOF)) == _EOF:
                    self._fh.seek(-len(_EOF), os.SEEK_END)
                    self._fh.truncate()
            self._header_written = True
            self._open_direct()
            return
        self._fh = open(self.filename, "wb")
        text = _header_text(header_attrs).encode("ascii")
        if self.binary:
            head = bytearray(_HEADER_SIZE_OFFSET + 4)
            head[0:6] = _MAGIC
            head[6:9] = bytes([0, 2, 0])
            head[9] = self.record_press
            head[10] = self.signal_press
            struct.pack_into("<I", head, 11, 1)  # num_read_groups
            struct.pack_into("<I", head, _HEADER_SIZE_OFFSET, len(text))
            self._fh.write(bytes(head))
            self._fh.write(text)
        else:
            self._fh.write(text)
        self._header_written = True
        self._open_direct()

    def write_record(
        self,
        read_id: str,
        signal: np.ndarray,
        digitisation: float,
        offset: float,
        range_val: float,
        sampling_rate: float,
        aux: dict,
    ):
        if self.binary:
            rec = _encode_record(
                read_id, signal, digitisation, offset, range_val,
                sampling_rate, aux, self.signal_press,
            )
            rec = _press_record(rec, self.record_press)
            self._fh.write(struct.pack("<I", len(rec)))
            self._fh.write(rec)
        else:
            sig = np.asarray(signal, np.int16)
            fields = [
                read_id,
                "0",
                _fmt_double(digitisation),
                _fmt_double(offset),
                _fmt_double(range_val),
                _fmt_double(sampling_rate),
                str(len(sig)),
                ",".join(map(str, sig.tolist())),
                str(aux["channel_number"]),
                _fmt_double(aux["median_before"]),
                str(int(aux["read_number"])),
                str(int(aux["start_mux"])),
                str(int(aux["start_time"])),
            ]
            self._fh.write(("\t".join(fields) + "\n").encode("ascii"))

    def write_records_batch(
        self,
        read_ids: List[str],
        signals: List[np.ndarray],
        digitisation: float,
        offsets: List[float],
        range_val: float,
        sampling_rate: float,
        median_befores: List[float],
        read_numbers: List[int],
        start_times: List[int],
        channel_number: str = "0",
        flat: Optional[np.ndarray] = None,
        sample_off: Optional[np.ndarray] = None,
    ) -> bool:
        """Encode + frame + compress a whole flush of records in ONE native
        call (blow5_encode_batch in native/slow5_codec.cc) — the per-record
        Python loop costs ~1.2 s of host CPU per 10k-read bench run in
        struct.pack/ctypes/zstd-call churn alone. Byte layout is identical
        to write_record's (the C++ assembles the same record bytes; zlib
        output is bit-identical, zstd frames may differ in header params
        but decode to the same records). Returns False when the native
        path is unavailable (ASCII output, no toolchain, zstd requested
        but not compiled in) — the caller then writes per record."""
        if not self.binary or not read_ids:
            return not read_ids and self.binary
        lib = _native()
        if lib is None or not hasattr(lib, "blow5_encode_batch"):
            return False
        if self.record_press == PRESS_ZSTD and not lib.blow5_have_zstd():
            return False
        if self.signal_press not in (SIGPRESS_NONE, SIGPRESS_SVB_ZD):
            return False
        import ctypes

        with tracing.span("slow5.prep", cpu=True):
            n = len(read_ids)
            if flat is None:
                flat = np.ascontiguousarray(
                    np.concatenate([np.asarray(s, "<i2").ravel() for s in signals])
                )
                sample_off = np.zeros(n + 1, np.int64)
                np.cumsum([len(s) for s in signals], out=sample_off[1:])
            else:
                flat = np.ascontiguousarray(flat, "<i2")
                sample_off = np.ascontiguousarray(sample_off, np.int64)
            rid_bytes = np.frombuffer(
                "".join(read_ids).encode("ascii"), np.uint8
            ).copy()
            rid_off = np.zeros(n + 1, np.int64)
            np.cumsum([len(r) for r in read_ids], out=rid_off[1:])
            chan = np.frombuffer(channel_number.encode("ascii"), np.uint8).copy()

            # Output capacity: per-record worst case (svb-zd expansion bound)
            # plus a margin covering both zlib's and zstd's compressBound
            # overhead (~src/256 + constants; rec//64 + 512 dominates both).
            nsig = np.diff(sample_off)
            if self.signal_press == SIGPRESS_SVB_ZD:
                sig_bytes = 16 + (nsig + 3) // 4 + 4 * nsig
            else:
                sig_bytes = 8 + 2 * nsig
            rec = 2 + np.diff(rid_off) + 36 + sig_bytes + 8 + len(chan) + 21
            cap = int(np.sum(4 + rec + rec // 64 + 512))
            s0 = self.direct_source_offset()
            need = cap + self._DIRECT_ALIGN
            if self._batch_buf is None or self._batch_buf.size < need:
                # mmap-backed => page-aligned base, as the O_DIRECT path needs
                import mmap as _mmap

                self._batch_buf = np.frombuffer(
                    _mmap.mmap(-1, need), np.uint8
                )
            out = self._batch_buf[s0:]

            offs = np.ascontiguousarray(offsets, np.float64)
            mbs = np.ascontiguousarray(median_befores, np.float64)
            rns = np.ascontiguousarray(read_numbers, np.int32)
            sts = np.ascontiguousarray(start_times, np.uint64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
        with tracing.span("slow5.encode", cpu=True):
            pos = lib.blow5_encode_batch(
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                sample_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                rid_bytes.ctypes.data_as(u8p),
                rid_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                mbs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                rns.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                sts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                chan.ctypes.data_as(u8p), len(chan), n,
                float(digitisation), float(range_val), float(sampling_rate),
                int(self.record_press), int(self.signal_press), 1,
                out.ctypes.data_as(u8p), cap,
            )
        if pos in (0, 2**64 - 1) or pos > cap:
            logger.warning(
                "native blow5_encode_batch failed; falling back to the "
                "per-record writer for this flush"
            )
            return False
        with tracing.span("slow5.fwrite", cpu=True):
            self.write_bulk(self._batch_buf, s0, pos)
        return True

    def close(self):
        if self._fh is None:
            return
        if self.binary:
            self._fh.write(_EOF)
        self._fh.flush()
        self._fh.close()
        self._fh = None
        if getattr(self, "_fd_direct", -1) >= 0:
            os.close(self._fd_direct)
            self._fd_direct = -1


def read_slow5(path: str) -> Tuple[Dict[str, str], List[dict]]:
    """Read a .slow5/.blow5 file written by this module.

    Returns (header_attrs, records). Used for tests and downstream analysis.
    """
    path = str(path)
    if path.endswith(".blow5"):
        return _read_blow5(path)
    return _read_ascii(path)


def _read_ascii(path: str):
    attrs: Dict[str, str] = {}
    records = []
    names: Optional[List[str]] = None
    with open(path, "r", encoding="ascii") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("@"):
                key, _, value = line[1:].partition("\t")
                attrs[key] = value
            elif line.startswith("#"):
                parts = line[1:].split("\t")
                if parts and parts[0] == "read_id":
                    names = parts
            else:
                assert names is not None, "record before column header"
                parts = line.split("\t")
                rec = dict(zip(names, parts))
                rec["signal"] = np.array(
                    [int(x) for x in rec.pop("raw_signal").split(",") if x != ""],
                    np.int16,
                )
                rec["read_group"] = int(rec["read_group"])
                for f in ("digitisation", "offset", "range", "sampling_rate",
                          "median_before"):
                    rec[f] = float(rec[f])
                for f in ("len_raw_signal", "read_number", "start_mux",
                          "start_time"):
                    rec[f] = int(rec[f])
                records.append(rec)
    return attrs, records


def _read_blow5(path: str):
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:6] == _MAGIC, "bad BLOW5 magic"
    record_press = data[9]
    signal_press = data[10]
    (header_size,) = struct.unpack_from("<I", data, _HEADER_SIZE_OFFSET)
    text_start = _HEADER_SIZE_OFFSET + 4
    header_text = data[text_start : text_start + header_size].decode("ascii")
    attrs = {}
    for line in header_text.splitlines():
        if line.startswith("@"):
            key, _, value = line[1:].partition("\t")
            attrs[key] = value
    off = text_start + header_size
    records = []
    while off < len(data) - len(_EOF) + 1:
        if data[off : off + len(_EOF)] == _EOF:
            break
        (size,) = struct.unpack_from("<I", data, off)
        off += 4
        rec = data[off : off + size]
        off += size
        records.append(_decode_record(_depress_record(rec, record_press),
                                      signal_press))
    return attrs, records


def iter_slow5_signals(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    _, records = read_slow5(path)
    for rec in records:
        yield rec["read_id"], rec["signal"]
