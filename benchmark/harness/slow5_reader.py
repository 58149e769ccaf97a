"""A BLOW5 reader of the benchmark's own (SLOW5 format v0.2.0).

Reads what a BLOW5 writer writes: the 64-byte lead-in (magic, version,
record and signal compression, read groups), the ASCII header, then
records of [uint32 size][record bytes, compressed by the record method],
ending in "5WOLB". A record is read_id (uint16 length + bytes), read
group, digitisation, offset, range, sampling rate, then the raw signal:
int16[n] uncompressed, or with svb-zd (signal method 2) a blob of the
byte length given, holding a uint64 sample count and a StreamVByte stream
of zig-zag first differences. Records compressed with zstd (method 3) are
inflated through libzstd, or the `zstandard` module where that is present.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import zlib
from typing import Dict, Iterator, Tuple

import numpy as np

_MAGIC = b"BLOW5\x01"
_EOF = b"5WOLB"
RECORD_PRESS = {0: "none", 1: "zlib", 3: "zstd"}  # the lead-in's record compression byte


class _Zstd:
    def __init__(self):
        self._lib = None
        self._mod = None
        name = ctypes.util.find_library("zstd")
        for cand in ([name] if name else []) + ["libzstd.so.1", "libzstd.so"]:
            try:
                lib = ctypes.CDLL(cand)
            except OSError:
                continue
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                            ctypes.c_void_p, ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
            self._lib = lib
            return
        import zstandard  # no libzstd: the module is the only other way

        self._mod = zstandard.ZstdDecompressor()

    def decompress(self, data: bytes) -> bytes:
        if self._mod is not None:
            return self._mod.decompress(data)
        n = self._lib.ZSTD_getFrameContentSize(data, len(data))
        if n >= (1 << 63):
            raise ValueError("zstd frame without a content size")
        out = ctypes.create_string_buffer(int(n))
        got = self._lib.ZSTD_decompress(out, int(n), data, len(data))
        if self._lib.ZSTD_isError(got) or got != n:
            raise ValueError("corrupt zstd record")
        return out.raw


def _svb_zd(blob: bytes, count: int) -> np.ndarray:
    if count == 0:
        return np.zeros(0, np.int16)
    n_ctrl = (count + 3) // 4
    ctrl = np.frombuffer(blob[:n_ctrl], np.uint8)
    codes = np.stack([(ctrl >> s) & 3 for s in (0, 2, 4, 6)], 1).reshape(-1)[:count]
    nbytes = codes.astype(np.int64) + 1
    payload = np.frombuffer(blob[n_ctrl:], np.uint8)
    lanes = np.zeros((count, 4), np.uint8)
    lanes[np.arange(4)[None, :] < nbytes[:, None]] = payload[: int(nbytes.sum())]
    zz = lanes.view("<u4")[:, 0]
    deltas = (zz >> np.uint32(1)).astype(np.int32) ^ -(zz & np.uint32(1)).astype(np.int32)
    return np.cumsum(deltas, dtype=np.int64).astype(np.int16)


def read_blow5(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """(read id, int16 signal) of every record, in file order."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:6] != _MAGIC:
        raise ValueError(f"{path}: not a BLOW5 file")
    record_press, signal_press = data[9], data[10]
    (header_size,) = struct.unpack_from("<I", data, 64)
    off = 68 + header_size
    inflate = {0: lambda b: b, 1: zlib.decompress}
    if record_press == 3:
        inflate[3] = _Zstd().decompress
    while off < len(data) and data[off:off + 5] != _EOF:
        (size,) = struct.unpack_from("<I", data, off)
        rec = inflate[record_press](data[off + 4:off + 4 + size])
        off += 4 + size
        (n_id,) = struct.unpack_from("<H", rec, 0)
        read_id = rec[2:2 + n_id].decode("ascii")
        p = 2 + n_id + 4 + 32
        (n_raw,) = struct.unpack_from("<Q", rec, p)
        p += 8
        if signal_press == 2:
            (count,) = struct.unpack_from("<Q", rec, p)
            signal = _svb_zd(rec[p + 8:p + n_raw], count)
        elif signal_press == 0:
            signal = np.frombuffer(rec, "<i2", count=n_raw, offset=p).copy()
        else:
            raise ValueError(f"signal compression {signal_press} is not read here")
        yield read_id, signal


def record_press(path: str) -> str:
    """The record compression a BLOW5 file was written with, from its lead-in."""
    with open(path, "rb") as fh:
        lead = fh.read(10)
    if lead[:6] != _MAGIC:
        raise ValueError(f"{path}: not a BLOW5 file")
    return RECORD_PRESS.get(lead[9], f"method {lead[9]}")


def read_index(read_id: str) -> int:
    """The read's index in its run from an indexed read id
    (00000000-0000-0000-0000-<index + 1, 12 digits>)."""
    return int(read_id.rsplit("-", 1)[1]) - 1


def signals_by_index(path: str) -> Dict[int, np.ndarray]:
    return {read_index(rid): sig for rid, sig in read_blow5(path)}
