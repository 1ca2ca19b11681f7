"""Block decoder (kernels/decode.decode_blocks): correctness on our
streams, reference streams, and malformed input.  On the CPU this runs the
plain-JAX decoder; on a GPU the same tests run the CUDA kernel.
"""

import subprocess

import numpy as np
import pytest

from snappytpu.bench import corpus
from snappytpu.format.varint import decode_varint
from snappytpu.kernels.decode import decode_blocks
from snappytpu.kernels.encode_v2 import encode_blocks_v2
from snappytpu.stream import framing

CASES = dict(corpus.edge_case_corpus())
CASES["mixed100k"] = corpus.mixed(100_000, seed=7)


def _vm_decode_stream(ops: np.ndarray, out_len: int) -> bytes:
    chunks, out_lens = framing.split_ops_stream(ops, out_len)
    padded, comp_lens = framing.pad_chunks(chunks)
    out, ok = decode_blocks(padded, comp_lens, np.array(out_lens, np.int32))
    out, ok = np.asarray(out), np.asarray(ok)
    assert ok.all(), f"VM flagged corrupt blocks: {np.nonzero(~ok)[0]}"
    return b"".join(out[i, :out_lens[i]].tobytes() for i in range(len(out_lens)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_vm_roundtrip_own_streams(name):
    data = CASES[name]
    if not data:
        return
    arr = np.frombuffer(data, np.uint8)
    blocks, lens = framing.pack_blocks(arr)
    comp, totals = encode_blocks_v2(blocks, lens)
    comp, totals = np.asarray(comp), np.asarray(totals)
    out, ok = decode_blocks(comp, totals, lens)
    out, ok = np.asarray(out), np.asarray(ok)
    assert ok.all()
    rec = b"".join(out[i, : lens[i]].tobytes() for i in range(len(lens)))
    assert rec == data


@pytest.mark.parametrize("name", ["alice_like_text", "32k_ff", "mixed100k"])
def test_vm_decodes_reference_streams(name, reference_cli, tmp_path):
    data = CASES[name]
    raw = tmp_path / "in.raw"
    raw.write_bytes(data)
    refc = tmp_path / "ref.snappy"
    subprocess.run(
        [reference_cli, "-c", str(raw), str(refc)],
        cwd=tmp_path, check=True, capture_output=True,
    )
    stream = np.frombuffer(refc.read_bytes(), np.uint8)
    out_len, start = decode_varint(stream)
    assert _vm_decode_stream(stream[start:], out_len) == data


def test_vm_flags_corrupt_streams():
    data = CASES["alice_like_text"][:65536]
    arr = np.frombuffer(data, np.uint8)
    blocks, lens = framing.pack_blocks(arr)
    comp, totals = encode_blocks_v2(blocks, lens)
    comp, totals = np.asarray(comp).copy(), np.asarray(totals)

    # forward reference: copy offset beyond the write cursor
    bad = comp.copy()
    bad[0, 0] = (60 << 2) | 2  # COPY2 len 61 at output position 0
    out, ok = decode_blocks(bad, totals, lens)
    assert not np.asarray(ok)[0]

    # truncated stream
    out, ok = decode_blocks(comp, np.maximum(totals - 5, 1), lens)
    assert not np.asarray(ok)[0]

    # declared output too long
    out, ok = decode_blocks(comp, totals, lens + 7)
    assert not np.asarray(ok)[0]


def test_vm_overlap_replication():
    # period-p self-overlapping copies, all periods 1..9
    for period in range(1, 10):
        seed = bytes(range(1, period + 1))
        data = (seed * (3000 // period + 1))[:3000]
        arr = np.frombuffer(data, np.uint8)
        blocks, lens = framing.pack_blocks(arr)
        comp, totals = encode_blocks_v2(blocks, lens)
        out, ok = decode_blocks(np.asarray(comp), np.asarray(totals), lens)
        assert np.asarray(ok).all()
        assert np.asarray(out)[0, : len(data)].tobytes() == data


@pytest.mark.parametrize("field", ["comp_len", "out_len"])
def test_decoder_rejects_lengths_outside_the_row(field):
    """A comp_len past the padded row or an out_len past 64 KiB is malformed
    input: the block is not ok, whatever the row holds (both backends)."""
    data = CASES["alice_like_text"][:65536]
    blocks, lens = framing.pack_blocks(np.frombuffer(data, np.uint8))
    comp, totals = map(np.asarray, encode_blocks_v2(blocks, lens))
    ok = np.asarray(decode_blocks(comp, totals, lens)[1])
    assert ok.all()
    comp_lens, out_lens = totals.copy(), np.asarray(lens).copy()
    if field == "comp_len":
        comp_lens[0] = comp.shape[1] + 5
    else:
        out_lens[0] = 65536 + 5
    ok = np.asarray(decode_blocks(comp, comp_lens, out_lens)[1])
    assert not ok[0]
