"""High-level codec API: device (JAX) compress/decompress with host framing.

This is the user-facing equivalent of the reference's `snappy_compress` /
`snappy_decompress` entry points (snappy_compression.h:8,
snappy_decompression.h:15), producing/consuming the same raw wire format.
Batches are padded to power-of-two block counts so jit recompiles stay
bounded.
"""

from __future__ import annotations

import numpy as np

from .format import constants as C
from .format.varint import encode_varint
from .kernels.decode import decode_blocks, decode_stream
from .kernels.encode_v2 import encode_blocks_v2
from .model.decode import CorruptError
from .stream import framing


def encode_blocks(blocks, lens, profile="dense"):
    return encode_blocks_v2(blocks, lens, dense=(profile != "fast"))

_MAX_DEVICE_BATCH = 128  # blocks per device call (8 MiB input per call)


def _bucket(b: int) -> int:
    """Round block count up to a power of two (bounded recompile count)."""
    n = 1
    while n < b:
        n *= 2
    return min(n, _MAX_DEVICE_BATCH)


def _batched(nblocks: int):
    start = 0
    while start < nblocks:
        size = min(_MAX_DEVICE_BATCH, nblocks - start)
        yield start, size, _bucket(size)
        start += size


def encode_array_pieces(arr: np.ndarray, profile: str = "dense"):
    """Device-encode a byte array, yielding compacted wire pieces (no
    preamble) one device batch at a time — the shared inner loop of
    compress() and the bounded-memory file codec (stream/filecodec.py)."""
    from . import cpu

    blocks, lens = framing.pack_blocks(arr)
    for start, size, bucket in _batched(blocks.shape[0]):
        bb = np.zeros((bucket, C.MAX_BLOCK_SIZE), dtype=np.uint8)
        bl = np.zeros(bucket, dtype=np.int32)
        bb[:size] = blocks[start : start + size]
        bl[:size] = lens[start : start + size]
        comp, totals = encode_blocks(bb, bl, profile)
        comp, totals = np.asarray(comp), np.asarray(totals)
        if (totals[:size] < 0).any():
            # the encoder's emission-capacity guard poisoned a block
            # (encode_v2._section_capacity) — unreachable for legal
            # geometry, but never silently emit a truncated stream
            raise RuntimeError(
                f"encoder capacity overflow in block(s) "
                f"{np.nonzero(totals[:size] < 0)[0].tolist()}"
            )
        if cpu.available:
            # native variable-length row gather (memcpy speed) instead of a
            # per-block Python loop — at device GB/s this loop is the wall
            yield cpu.compact(comp[:size], totals[:size])
        else:
            for i in range(size):
                yield comp[i, : totals[i]].tobytes()


def compress(data: bytes | np.ndarray, profile: str = "dense") -> bytes:
    """Device-encode a byte string into a raw Snappy stream.

    profile: "dense" (default, reference-BST-analog quality) or "fast"
    (fewer candidate tiers, reference-hash-table analog)."""
    arr = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray))
        else np.ascontiguousarray(data, dtype=np.uint8)
    )
    if arr.size == 0:
        return encode_varint(0)
    return b"".join(
        [encode_varint(arr.size)] + list(encode_array_pieces(arr, profile))
    )


_WINDOWED_BATCH = 64  # chunks staged per decode_stream call (~4.6 MB comp)


def _decompress_windowed(split) -> bytes:
    """Device decode of a NON-block-splittable stream: chunks cut at op
    boundaries run through the sequential sliding-window decoder
    (kernels/decode.decode_stream), the device analog of the reference's
    128 KiB source-window refill (snappy_decompression.c:154-161).

    Chunks are staged in bounded batches with the 64 KiB context tail
    carried between kernel calls (the kernel's ctx0 input), so a multi-GB
    unsplittable stream decodes incrementally instead of staging all its
    padded chunks at once."""
    chunks, out_lens, ctx_lens = split
    N = len(chunks)
    pieces = []
    ctx0 = np.zeros(C.MAX_BLOCK_SIZE, np.uint8)
    tail = b""  # last <= 64 KiB of decoded output so far
    for k0 in range(0, N, _WINDOWED_BATCH):
        k1 = min(k0 + _WINDOWED_BATCH, N)
        padded, comp_lens = framing.pad_chunks(chunks[k0:k1])
        ctx0[:] = 0
        if tail:
            ctx0[C.MAX_BLOCK_SIZE - len(tail):] = np.frombuffer(tail, np.uint8)
        out, ok = decode_stream(
            padded,
            comp_lens,
            np.asarray(out_lens[k0:k1], np.int32),
            np.asarray(ctx_lens[k0:k1], np.int32),
            ctx0,
        )
        out, ok = np.asarray(out), np.asarray(ok)
        if not ok.all():
            raise CorruptError(
                f"malformed chunk(s) {(k0 + np.nonzero(~ok)[0]).tolist()} (windowed)"
            )
        batch = b"".join(out[i, : out_lens[k0 + i]].tobytes() for i in range(k1 - k0))
        pieces.append(batch)
        tail = (tail + batch)[-C.MAX_BLOCK_SIZE:]
    return b"".join(pieces)


def decompress(data: bytes | np.ndarray) -> bytes:
    """Device-decode a raw Snappy stream.  Block-splittable streams (ops
    never straddle 64 KiB output boundaries — true for the reference's and
    our streams) decode as independent parallel blocks; other valid Snappy
    streams decode on device through the sequential sliding-window kernel;
    only single ops wider than 64 KiB fall back to the host decoder."""
    arr = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray))
        else np.ascontiguousarray(data, dtype=np.uint8)
    )
    out_len, ops_start = framing.read_preamble(arr)
    if out_len == 0:
        if arr.size != ops_start:
            raise CorruptError("trailing garbage after empty stream")
        return b""
    ops = arr[ops_start:]
    from . import cpu

    if cpu.available:
        try:
            offs, out_lens_np = cpu.scan_ops(ops, out_len)
            padded, comp_lens = cpu.split_rows(ops, offs, C.MAX_COMPRESSED_BLOCK_SIZE)
        except cpu.NativeError:
            try:
                split = framing.split_ops_windowed(ops, out_len)
                return _decompress_windowed(split)
            except CorruptError:
                # giant-op stream, or a chunk the window kernel cannot
                # prove valid (e.g. copy offsets beyond 128 KiB of context,
                # which the format allows but no block encoder emits):
                # the native sequential decoder is the authority — it
                # decodes the valid ones and raises on the corrupt ones
                return cpu.decompress(arr)
        out_lens = out_lens_np.astype(np.int64).tolist()
    else:
        try:
            chunks, out_lens = framing.split_ops_stream(ops, out_len)
        except CorruptError:
            try:
                split = framing.split_ops_windowed(ops, out_len)
                return _decompress_windowed(split)
            except CorruptError:
                from .model.decode import decode_ops  # sequential fallback

                return decode_ops(ops, out_len).tobytes()
        padded, comp_lens = framing.pad_chunks(chunks)
    out_pieces = []
    for start, size, bucket in _batched(padded.shape[0]):
        pc = np.zeros((bucket, C.MAX_COMPRESSED_BLOCK_SIZE), dtype=np.uint8)
        pl = np.zeros(bucket, dtype=np.int32)
        ol = np.zeros(bucket, dtype=np.int32)
        pc[:size] = padded[start : start + size]
        pl[:size] = comp_lens[start : start + size]
        ol[:size] = out_lens[start : start + size]
        out, ok = decode_blocks(pc, pl, ol)
        out, ok = np.asarray(out), np.asarray(ok)
        if not ok[:size].all():
            raise CorruptError(f"malformed block(s) {np.nonzero(~ok[:size])[0].tolist()}")
        if cpu.available:
            out_pieces.append(cpu.compact(out[:size], ol[:size]))
        else:
            for i in range(size):
                out_pieces.append(out[i, : ol[i]].tobytes())
    return b"".join(out_pieces)
