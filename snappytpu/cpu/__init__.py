"""ctypes bindings for the native host runtime (snappy_cpu.cc).

Auto-builds the shared library with g++ on first import (cached next to the
source); falls back to `available = False` if no toolchain is present, in
which case callers use the pure-Python model codec.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "snappy_cpu.cc")
_LIB = os.path.join(_DIR, "csrc", "libsnappy_cpu.so")

available = False
_lib = None


class NativeError(ValueError):
    """Malformed input or capacity error reported by the native runtime."""


_ERRORS = {
    -1: "varint/preamble malformed or buffer too small",
    -2: "output larger than destination capacity",
    -3: "truncated stream",
    -4: "op overruns declared output length",
    -5: "copy offset out of range",
    -6: "trailing garbage after output complete",
    -7: "op straddles block boundary",
    -8: "too many blocks",
}


def _build() -> bool:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return True
    try:
        r = subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-o", _LIB, _SRC],
            capture_output=True,
            timeout=300,
        )
        return r.returncode == 0
    except Exception:
        return False


def _load():
    global _lib, available
    if not _build():
        return
    lib = ctypes.CDLL(_LIB)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.stpu_max_compressed.restype = i64
    lib.stpu_max_compressed.argtypes = [i64]
    lib.stpu_compress.restype = i64
    lib.stpu_compress.argtypes = [u8p, i64, u8p, i64]
    lib.stpu_decompress.restype = i64
    lib.stpu_decompress.argtypes = [u8p, i64, u8p, i64, i64p]
    lib.stpu_scan_ops.restype = i64
    lib.stpu_scan_ops.argtypes = [u8p, i64, i64, i64, i64p, i64p, i64]
    lib.stpu_compact.restype = i64
    lib.stpu_compact.argtypes = [u8p, i64, i32p, i64, u8p, i64]
    lib.stpu_split.restype = i64
    lib.stpu_split.argtypes = [u8p, i64, i64p, i64, u8p, i64, i32p]
    _lib = lib
    available = True


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def compress(data: bytes | np.ndarray) -> bytes:
    """Native greedy-hash compress (raw Snappy stream with preamble)."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.ascontiguousarray(data, dtype=np.uint8)
    cap = int(_lib.stpu_max_compressed(arr.size))
    out = np.empty(cap, dtype=np.uint8)
    size = _lib.stpu_compress(_u8(arr), arr.size, _u8(out), cap)
    if size < 0:
        raise NativeError(_ERRORS.get(size, f"error {size}"))
    return out[:size].tobytes()


def decompress(data: bytes | np.ndarray) -> bytes:
    """Native validated decompress of a raw Snappy stream."""
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.ascontiguousarray(data, dtype=np.uint8)
    from ..format.varint import decode_varint

    total, _ = decode_varint(arr)
    out = np.empty(total + 8, dtype=np.uint8)  # +8: overlap fast-path slack
    out_len = ctypes.c_int64(0)
    rc = _lib.stpu_decompress(
        _u8(arr), arr.size, _u8(out), total + 8, ctypes.byref(out_len)
    )
    if rc != 0:
        raise NativeError(_ERRORS.get(rc, f"error {rc}"))
    return out[: out_len.value].tobytes()


def scan_ops(ops: np.ndarray, total_out: int, block_size: int = 65536):
    """Native op-boundary scan: -> (comp_offsets int64[], out_lens int64[]).
    Raises NativeError on malformed or unsplittable streams."""
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    max_blocks = max(total_out // block_size + 2, 2)
    offs = np.empty(max_blocks, dtype=np.int64)
    lens = np.empty(max_blocks, dtype=np.int64)
    nb = _lib.stpu_scan_ops(
        _u8(ops), ops.size, total_out, block_size,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_blocks,
    )
    if nb < 0:
        raise NativeError(_ERRORS.get(nb, f"error {nb}"))
    return offs[:nb], lens[:nb]


def compact(rows: np.ndarray, lens: np.ndarray) -> bytes:
    """Native gather of variable-length rows into one contiguous stream."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    lens32 = np.ascontiguousarray(lens, dtype=np.int32)
    cap = int(lens32.sum())
    out = np.empty(max(cap, 1), dtype=np.uint8)
    w = _lib.stpu_compact(
        _u8(rows), rows.shape[1], lens32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rows.shape[0], _u8(out), cap,
    )
    if w < 0:
        raise NativeError("compact overflow")
    return out[:w].tobytes()


def split_rows(stream: np.ndarray, cuts: np.ndarray, stride: int):
    """Native scatter of a contiguous stream into zero-padded fixed-stride
    rows given per-row start offsets."""
    stream = np.ascontiguousarray(stream, dtype=np.uint8)
    cuts64 = np.ascontiguousarray(cuts, dtype=np.int64)
    nrows = cuts64.size
    rows = np.empty((nrows, stride), dtype=np.uint8)
    lens = np.empty(nrows, dtype=np.int32)
    rc = _lib.stpu_split(
        _u8(stream), stream.size,
        cuts64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nrows,
        _u8(rows), stride, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise NativeError("row exceeds stride")
    return rows, lens


_load()
