"""Device (JAX) encoder vs the numpy model: the compressed bytes must be
IDENTICAL — the model is the executable spec, not an approximation.  Runs on
CPU here; the same jitted function runs unchanged on a GPU."""

import numpy as np
import pytest

from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.model import decompress, encode_block
from snappytpu.kernels import encode_blocks


def _pad_block(data: bytes):
    arr = np.frombuffer(data, dtype=np.uint8)
    assert arr.size <= C.MAX_BLOCK_SIZE
    padded = np.zeros(C.MAX_BLOCK_SIZE, dtype=np.uint8)
    padded[: arr.size] = arr
    return padded, arr.size


def _device_encode(data: bytes) -> bytes:
    padded, n = _pad_block(data)
    comp, total = encode_blocks(padded[None], np.array([n], dtype=np.int32))
    return bytes(np.asarray(comp[0])[: int(total[0])].tobytes())


CASES = {
    name: data[: C.MAX_BLOCK_SIZE]
    for name, data in corpus.edge_case_corpus().items()
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_matches_model_bitexact(name):
    data = CASES[name]
    assert _device_encode(data) == encode_block(np.frombuffer(data, dtype=np.uint8))


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_roundtrip(name):
    data = CASES[name]
    comp = _device_encode(data)
    if len(data) == 0:
        assert comp == b""
        return
    from snappytpu.model.decode import decode_ops

    out = decode_ops(np.frombuffer(comp, dtype=np.uint8), len(data))
    assert out.tobytes() == data


def test_batched_blocks_independent():
    datas = [corpus.text(1000), corpus.constant(500), corpus.random_bytes(65536)]
    padded = np.stack([_pad_block(d)[0] for d in datas])
    lens = np.array([len(d) for d in datas], dtype=np.int32)
    comp, totals = encode_blocks(padded, lens)
    comp, totals = np.asarray(comp), np.asarray(totals)
    for i, d in enumerate(datas):
        expect = encode_block(np.frombuffer(d, dtype=np.uint8))
        assert comp[i, : totals[i]].tobytes() == expect


def test_full_stream_via_device_blocks():
    data = corpus.mixed(200_000, seed=9)
    arr = np.frombuffer(data, dtype=np.uint8)
    starts = range(0, len(arr), C.MAX_BLOCK_SIZE)
    blocks = []
    lens = []
    for s in starts:
        chunk = arr[s : s + C.MAX_BLOCK_SIZE]
        p = np.zeros(C.MAX_BLOCK_SIZE, dtype=np.uint8)
        p[: chunk.size] = chunk
        blocks.append(p)
        lens.append(chunk.size)
    comp, totals = encode_blocks(np.stack(blocks), np.array(lens, dtype=np.int32))
    comp, totals = np.asarray(comp), np.asarray(totals)
    from snappytpu.format.varint import encode_varint

    stream = bytearray(encode_varint(len(arr)))
    for i in range(len(lens)):
        stream += comp[i, : totals[i]].tobytes()
    assert decompress(bytes(stream)) == data
