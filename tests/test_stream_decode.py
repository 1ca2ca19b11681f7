"""Windowed (sliding-context) device decode of non-block-splittable streams.

The reference decoder handles ANY valid Snappy stream with its sliding
128 KiB source window (snappy_decompression.c:154-161); block-disciplined
encoders (ours, the reference's, google/snappy's) never emit ops straddling
64 KiB output boundaries, but the format allows them.  These tests build
such streams by hand and drive them through api.decompress, which must take
the windowed decoder (kernels/decode.decode_stream, NOT the host fallback)
and still reject corrupt input deterministically.
"""

import numpy as np
import pytest

from snappytpu import api
from snappytpu.format import constants as C
from snappytpu.format.varint import encode_varint
from snappytpu.model.decode import CorruptError, decode_ops
from snappytpu.stream import framing


def _lit(payload: bytes) -> bytes:
    n = len(payload)
    assert n >= 1
    if n <= 60:
        return bytes([(n - 1) << 2]) + payload
    if n <= 1 << 8:
        return bytes([C.LITERAL_CODE_1BYTE << 2, n - 1]) + payload
    if n <= 1 << 16:
        return bytes([C.LITERAL_CODE_2BYTE << 2, (n - 1) & 0xFF, (n - 1) >> 8]) + payload
    return bytes(
        [C.LITERAL_CODE_3BYTE << 2, (n - 1) & 0xFF, ((n - 1) >> 8) & 0xFF, (n - 1) >> 16]
    ) + payload


def _copy2(length: int, dist: int) -> bytes:
    assert 1 <= length <= 64 and 1 <= dist < (1 << 16)
    return bytes([((length - 1) << 2) | C.TAG_COPY2, dist & 0xFF, dist >> 8])


def _copy4(length: int, dist: int) -> bytes:
    assert 1 <= length <= 64 and 1 <= dist < (1 << 32)
    return bytes([((length - 1) << 2) | C.TAG_COPY4]) + int(dist).to_bytes(4, "little")


def _build_straddling_stream(seed=0):
    """Ops that cross 64 KiB output boundaries: big literals plus copy
    chains whose sources live in previous windows."""
    rng = np.random.default_rng(seed)
    ops = bytearray()
    out = bytearray()
    # 60000-byte literal, then copies reaching back across what will be
    # the first 64 KiB boundary, then more literals/copies
    first = rng.integers(0, 256, 60000, dtype=np.uint8).tobytes()
    ops += _lit(first)
    out += first
    for _ in range(300):                      # crosses 65536 mid-chain
        dist = int(rng.integers(1000, 59000))
        ln = int(rng.integers(4, 65))
        ops += _copy2(ln, dist)
        out += bytes(out[len(out) - dist : len(out) - dist + ln])
    second = rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
    ops += _lit(second)
    out += second
    for _ in range(600):                      # deep chains over old windows
        dist = int(rng.integers(1, 65000))
        dist = min(dist, len(out))
        ln = int(rng.integers(4, 65))
        ops += _copy2(ln, dist)
        src = len(out) - dist
        for j in range(ln):                   # overlap-correct byte-forward
            out.append(out[src + j])
    ops = bytes(ops)
    stream = encode_varint(len(out)) + ops
    return stream, bytes(out)


def test_straddling_stream_is_not_block_splittable():
    stream, data = _build_straddling_stream()
    arr = np.frombuffer(stream, np.uint8)
    out_len, start = framing.read_preamble(arr)
    with pytest.raises(CorruptError):
        framing.split_ops_stream(arr[start:], out_len)
    # sanity: the model decoder agrees with the hand-built oracle
    assert decode_ops(arr[start:], out_len).tobytes() == data


def test_windowed_device_decode_roundtrip():
    stream, data = _build_straddling_stream()
    assert api.decompress(stream) == data


def test_windowed_split_geometry():
    stream, data = _build_straddling_stream()
    arr = np.frombuffer(stream, np.uint8)
    out_len, start = framing.read_preamble(arr)
    chunks, out_lens, ctx_lens = framing.split_ops_windowed(arr[start:], out_len)
    assert sum(out_lens) == len(data)
    assert all(o <= C.MAX_BLOCK_SIZE for o in out_lens)
    assert ctx_lens[0] == 0 and all(
        c == min(sum(out_lens[:i]), C.MAX_BLOCK_SIZE) for i, c in enumerate(ctx_lens)
    )
    assert len(chunks) > 1            # it actually was windowed


def test_windowed_rejects_forward_reference():
    # a copy whose dist exceeds ALL prior output (incl. context) must be
    # flagged by the windowed decoder, not silently decoded
    payload = bytes(range(256)) * 300          # 76800 bytes -> 2 chunks
    ops = _lit(payload[:50000]) + _lit(payload[50000:]) + _copy4(8, 60000 + 16801)
    stream = encode_varint(len(payload) + 8) + ops
    # the windowed decoder flags it; the authoritative host fallback re-checks
    # and rejects too (CorruptError from the model path, NativeError —
    # a ValueError — from the native path)
    with pytest.raises(ValueError):
        api.decompress(stream)


def test_giant_literal_falls_back_to_host():
    # a single >64 KiB literal op cannot fit any window: host path, still exact
    payload = np.random.default_rng(3).integers(0, 256, 70000, dtype=np.uint8).tobytes()
    stream = encode_varint(len(payload)) + _lit(payload)
    arr = np.frombuffer(stream, np.uint8)
    out_len, start = framing.read_preamble(arr)
    with pytest.raises(CorruptError):
        framing.split_ops_windowed(arr[start:], out_len)
    assert api.decompress(stream) == payload


def test_windowed_api_batched_context_carry(monkeypatch):
    """api._decompress_windowed stages chunks in bounded batches, carrying
    the 64 KiB context tail between decode_stream calls:
    force 2-chunk batches and decode an unaligned stream whose copies
    reach across the batch seams."""
    import numpy as np

    from snappytpu import api
    from snappytpu.bench import corpus
    from snappytpu.model import compress as model_compress
    from snappytpu.stream import framing

    monkeypatch.setattr(api, "_WINDOWED_BATCH", 2)

    # phase-shifted stream (op boundaries straddle the 64 KiB grid) with
    # long-range repetition so copies cross chunk/batch boundaries
    base = bytearray(corpus.mixed(150_000, seed=91))
    base[70_000:130_000] = base[5_000:65_000]  # far repeats
    data = bytes(base)
    shift = 23
    head, tail = data[:shift], data[shift:]
    tail_comp = np.frombuffer(model_compress(tail), np.uint8)
    _, tstart = framing.read_preamble(tail_comp)
    lit = bytes([(shift - 1) << 2]) + head
    ops = np.concatenate([np.frombuffer(lit, np.uint8), tail_comp[tstart:]])

    split = framing.split_ops_windowed(ops, len(data))
    assert len(split[0]) >= 3, "need multiple batches for the carry test"
    assert api._decompress_windowed(split) == data


def test_far_reach_copy_falls_back_to_sequential(monkeypatch):
    """A valid stream whose copy reaches back MORE than 64 KiB past its
    chunk start exceeds the windowed decoder's context window; api.decompress
    must route it to the sequential authority (native or model decoder) and
    still produce exact bytes (the reference accepts any in-range offset
    because its whole output is resident, snappy_decompression.c:323-327)."""
    import numpy as np

    from snappytpu import api
    from snappytpu.format.varint import encode_varint
    from snappytpu.model import decode as mdec

    rng = np.random.default_rng(61)
    lit = rng.integers(0, 256, 131_073, dtype=np.uint8)

    ops = bytearray()
    # literal ops of 60000/60000/11073 bytes
    for seg in (lit[:60000], lit[60000:120000], lit[120000:]):
        m = len(seg) - 1  # extra length bytes encode len-1
        ops += bytes([(62 << 2), m & 0xFF, (m >> 8) & 0xFF, (m >> 16) & 0xFF])
        ops += seg.tobytes()
    # COPY2 len 64 dist 61000: lands at output 131073 (chunk 3 start
    # 131072 + 1), reaching back to 70073 — 61000 > 1 + 65536 of window
    # context, so the windowed decoder cannot prove it and must fall back
    dist = 61_000
    ops += bytes([((64 - 1) << 2) | 2, dist & 0xFF, dist >> 8])
    out_len = 131_073 + 64

    expected = np.concatenate([lit, lit[131_073 - dist : 131_073 - dist + 64]])
    # sanity: the model decoder (whole output resident) accepts it
    assert mdec.decode_ops(np.frombuffer(bytes(ops), np.uint8), out_len).tobytes() \
        == expected.tobytes()

    stream = encode_varint(out_len) + bytes(ops)
    assert api.decompress(stream) == expected.tobytes()
