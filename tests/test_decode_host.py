"""The host-resident decode route, api.decompress: the native runtime cuts the
stream into padded 64 KiB rows, the block decoder (kernels/decode.py) runs
them in power-of-two batches, and the native runtime compacts the output.
Checked against the native decoder: same bytes on valid streams (ours and
the native compressor's), same verdict on malformed ones.
"""

import numpy as np
import pytest

from snappytpu import api, cpu
from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.format.varint import encode_varint
from snappytpu.kernels.decode import decode_blocks

pytestmark = pytest.mark.skipif(not cpu.available, reason="native runtime required")

CASES = dict(corpus.edge_case_corpus())
CASES["mixed100k"] = corpus.mixed(100_000, seed=7)


def _verdict(fn, stream):
    try:
        return ("ok", fn(stream))
    except ValueError:
        return ("reject", None)


@pytest.mark.parametrize("name", ["alice_like_text", "low_entropy_runs",
                                  "32k_random", "mixed100k", "block_boundary_64k_plus_1"])
def test_api_roundtrip_own_streams(name):
    data = CASES[name]
    comp = api.compress(data, profile="fast")
    assert api.decompress(comp) == data
    assert cpu.decompress(comp) == data


def test_api_decodes_native_compressor_streams():
    data = corpus.mixed(3 * C.MAX_BLOCK_SIZE + 99, seed=21)
    assert api.decompress(cpu.compress(data)) == data


def test_api_accept_set_matches_native_on_flips():
    data = corpus.mixed(2 * C.MAX_BLOCK_SIZE, seed=5)
    comp = np.frombuffer(api.compress(data, profile="fast"), np.uint8)
    rng = np.random.default_rng(0)
    rejected = 0
    for _ in range(12):
        cc = comp.copy()
        cc[int(rng.integers(4, cc.size))] ^= int(rng.integers(1, 256))
        stream = cc.tobytes()
        got = _verdict(api.decompress, stream)
        assert got == _verdict(cpu.decompress, stream)
        rejected += got[0] == "reject"
    assert rejected > 0  # the flip set must actually exercise rejection


def test_api_decodes_all_one_byte_literal_stream():
    # 2 compressed bytes per output byte: the densest valid op stream
    n = 24_000
    raw = corpus.mixed(n, seed=33)
    ops = b"".join(bytes([0x00, b]) for b in raw)
    assert api.decompress(encode_varint(n) + ops) == raw


def test_api_batches_and_pads_blocks(monkeypatch):
    """A stream of 7 blocks in batches of 4: the last batch of 3 pads to its
    power-of-two bucket with a zero-length row, which must decode as ok and
    be dropped from the output."""
    monkeypatch.setattr(api, "_MAX_DEVICE_BATCH", 4)
    data = corpus.mixed(6 * C.MAX_BLOCK_SIZE + 777, seed=9)
    assert list(api._batched(7)) == [(0, 4, 4), (4, 3, 4)]
    assert api.decompress(cpu.compress(data)) == data


def test_zero_length_pad_blocks_ok():
    comp = np.zeros((2, C.MAX_COMPRESSED_BLOCK_SIZE), np.uint8)
    out, ok = decode_blocks(comp, np.zeros(2, np.int32), np.zeros(2, np.int32))
    assert np.asarray(ok).all()
    assert not np.asarray(out).any()
