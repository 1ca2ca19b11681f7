"""Bounded-memory file codec (stream/filecodec.py): windowed file-to-file
compress/decompress must be byte-identical to the in-memory path and round
trip across window boundaries (the device-rate analog of the reference's
block streaming, snappy_compression.c:210/:384-403)."""

import numpy as np
import pytest

from snappytpu import api
from snappytpu.bench import corpus
from snappytpu.stream import filecodec


@pytest.mark.parametrize("nbytes", [0, 1, 65536, 3 * 65536 + 17, 9 * 65536 + 1])
def test_windowed_compress_byte_equal(tmp_path, nbytes):
    """compress_file through 2-block windows == api.compress of the whole
    buffer, for sizes straddling window and block boundaries."""
    data = corpus.mixed(nbytes, seed=31) if nbytes else b""
    src = tmp_path / "in.raw"
    dst = tmp_path / "out.snappy"
    src.write_bytes(data)
    n = filecodec.compress_file(src, dst, window_blocks=2)
    whole = api.compress(data)
    assert dst.read_bytes() == whole
    assert n == len(whole)


def test_windowed_roundtrip_multiwindow(tmp_path):
    """Multi-window compress -> multi-window decompress round trip, with
    window sizes that force several staging/drain cycles each way."""
    data = corpus.mixed(7 * 65536 + 123, seed=32)
    src = tmp_path / "in.raw"
    comp = tmp_path / "c.snappy"
    out = tmp_path / "out.raw"
    src.write_bytes(data)
    filecodec.compress_file(src, comp, profile="fast", window_blocks=3)
    n = filecodec.decompress_file(comp, out, window_blocks=2)
    assert n == len(data)
    assert out.read_bytes() == data


def test_windowed_decompress_empty_and_corrupt(tmp_path):
    comp = tmp_path / "c.snappy"
    out = tmp_path / "out.raw"
    comp.write_bytes(api.compress(b""))
    assert filecodec.decompress_file(comp, out) == 0
    assert out.read_bytes() == b""

    # raw Snappy has no checksum: a flipped byte may still be a VALID
    # stream (different literal content) — the contract is "reject or
    # decode deterministically", never crash or silently truncate
    data = corpus.mixed(130_000, seed=33)
    stream = bytearray(api.compress(data))
    stream[len(stream) // 2] ^= 0x55
    comp.write_bytes(bytes(stream))
    from snappytpu.model.decode import CorruptError

    try:
        n = filecodec.decompress_file(comp, out, window_blocks=1)
    except (CorruptError, ValueError):
        pass  # structural corruption detected
    else:
        assert n == len(data)
        assert out.read_bytes() != data  # valid-but-different stream


def test_cli_window_flag(tmp_path):
    """CLI --window-mb routes through the streaming codec and round-trips."""
    from snappytpu import cli

    data = corpus.mixed(200_000, seed=34)
    src = tmp_path / "in.raw"
    comp = tmp_path / "c.snappy"
    out = tmp_path / "out.raw"
    src.write_bytes(data)
    assert cli.main(["-b", str(src), str(comp), "--window-mb", "1"]) == 0
    assert cli.main(["-d", str(comp), str(out), "--window-mb", "1"]) == 0
    assert out.read_bytes() == data
    assert comp.read_bytes() == api.compress(data)


def test_oversized_compressed_block_falls_back(tmp_path):
    """A VALID stream whose per-block compressed span exceeds
    MAX_COMPRESSED_BLOCK_SIZE (e.g. all 1-byte literals: 2 comp bytes per
    output byte = 131072 B per 64 KiB block) must decode through
    decompress_file, not raise: it routes to the in-memory
    windowed path."""
    from snappytpu.format.varint import encode_varint

    data = corpus.mixed(2 * 65536 + 100, seed=33)
    stream = bytearray(encode_varint(len(data)))
    for b in data:
        stream += bytes([0x00, b])  # literal, length 1
    comp = tmp_path / "c.snappy"
    out = tmp_path / "out.raw"
    comp.write_bytes(bytes(stream))
    assert api.decompress(bytes(stream)) == data  # sanity: in-memory path
    n = filecodec.decompress_file(comp, out, window_blocks=1)
    assert n == len(data)
    assert out.read_bytes() == data
