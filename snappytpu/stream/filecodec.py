"""Bounded-memory file-to-file codec.

The reference compresses file-to-file one 64 KiB block at a time
(snappy_compression.c:210, :384-403) and decodes through a 128 KiB source
window (snappy_decompression.c:154-161) — O(block) resident memory.  The
in-memory api.compress/decompress materialize the whole input plus padded
device arrays, which cannot hold BASELINE config 5 (10 GB/host).  This
module is the device-rate equivalent of the reference's streaming
discipline: a sliding window of blocks is staged, encoded/decoded on
device, written out, and dropped, so resident memory is
O(window + batch padding), independent of file size.

Layout notes:
  * compress: the varint preamble needs the total size up front — known
    from the file — then windows are independent (blocks share no state,
    snappy_compression.c:419-425), so output bytes are IDENTICAL to
    api.compress of the whole file (tested byte-equal).
  * decompress: the op-boundary scan (native cpu.scan_ops) walks the
    compressed stream through a read-only memmap — file-backed clean
    pages, no heap copy of the stream — and each window of blocks is then
    copied, device-decoded, verified, and appended to the output file.
"""

from __future__ import annotations

import os

import numpy as np

from ..format import constants as C
from ..format.varint import encode_varint
from ..model.decode import CorruptError
from . import framing

# 32 MiB of input blocks per staged window: 4 device batches of 128 blocks
_DEF_WINDOW_BLOCKS = 512


def compress_file(src: str | os.PathLike, dst: str | os.PathLike,
                  profile: str = "dense",
                  window_blocks: int = _DEF_WINDOW_BLOCKS) -> int:
    """Stream-compress a file; returns compressed size in bytes.  Output is
    byte-identical to api.compress of the whole file."""
    from .. import api

    size = os.path.getsize(src)
    window = window_blocks * C.MAX_BLOCK_SIZE
    written = 0
    with open(src, "rb") as r, open(dst, "wb") as w:
        pre = encode_varint(size)
        w.write(pre)
        written += len(pre)
        while True:
            chunk = r.read(window)
            if not chunk:
                break
            arr = np.frombuffer(chunk, dtype=np.uint8)
            for piece in api.encode_array_pieces(arr, profile):
                w.write(piece)
                written += len(piece)
    return written


def decompress_file(src: str | os.PathLike, dst: str | os.PathLike,
                    window_blocks: int = _DEF_WINDOW_BLOCKS) -> int:
    """Stream-decompress a block-splittable raw Snappy file; returns the
    output size.  Streams whose ops straddle 64 KiB output boundaries (not
    produced by block encoders) fall back to the in-memory path."""
    from .. import api, cpu
    from ..kernels.decode import decode_blocks

    m = np.memmap(src, dtype=np.uint8, mode="r")
    out_len, start = framing.read_preamble(np.asarray(m[:32].copy()))
    if out_len == 0:
        if m.size != start:
            raise CorruptError("trailing garbage after empty stream")
        open(dst, "wb").close()
        return 0
    ops = m[start:]

    if not cpu.available:
        # no native scanner: fall back to the in-memory path (documented
        # limitation of the pure-Python install)
        data = api.decompress(np.asarray(m))
        with open(dst, "wb") as w:
            w.write(data)
        return len(data)

    try:
        offs, lens = cpu.scan_ops(ops, out_len)
    except cpu.NativeError:
        data = api.decompress(np.asarray(m))  # windowed/sequential fallback
        with open(dst, "wb") as w:
            w.write(data)
        return len(data)

    ends = np.concatenate([offs[1:], [ops.size]])
    if (ends - offs > C.MAX_COMPRESSED_BLOCK_SIZE).any():
        # A valid stream (e.g. all-1-byte-literal encodings) can carry more
        # than MAX_COMPRESSED_BLOCK_SIZE compressed bytes per 64 KiB block;
        # split_rows would reject it, but api.decompress's windowed path
        # handles it — route there instead of erroring.
        data = api.decompress(np.asarray(m))
        with open(dst, "wb") as w:
            w.write(data)
        return len(data)
    nb = offs.size
    written = 0
    with open(dst, "wb") as w:
        for g0 in range(0, nb, window_blocks):
            g1 = min(g0 + window_blocks, nb)
            base = int(offs[g0])
            comp_win = np.array(ops[base : int(ends[g1 - 1])])  # window copy
            rows, comp_lens = cpu.split_rows(
                comp_win, offs[g0:g1] - base, C.MAX_COMPRESSED_BLOCK_SIZE
            )
            win_lens = lens[g0:g1].astype(np.int32)
            for b0 in range(0, rows.shape[0], 128):
                b1 = min(b0 + 128, rows.shape[0])
                size = b1 - b0
                pc = np.zeros((128, C.MAX_COMPRESSED_BLOCK_SIZE), np.uint8)
                pl = np.zeros(128, np.int32)
                ol = np.zeros(128, np.int32)
                pc[:size] = rows[b0:b1]
                pl[:size] = comp_lens[b0:b1]
                ol[:size] = win_lens[b0:b1]
                out, ok = decode_blocks(pc, pl, ol)
                out, ok = np.asarray(out), np.asarray(ok)
                if not ok[:size].all():
                    raise CorruptError(
                        f"malformed block(s) "
                        f"{(g0 + b0 + np.nonzero(~ok[:size])[0]).tolist()}"
                    )
                piece = cpu.compact(out[:size], ol[:size])
                w.write(piece)
                written += len(piece)
    if written != out_len:
        raise CorruptError(f"decoded {written} bytes, preamble said {out_len}")
    return written
