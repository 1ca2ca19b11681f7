"""Differential fuzzing of the three decoders (model / native / device).

The reference decoder silently corrupts or loops on malformed input (its one
plausibility check is dead code, snappy_decompression.c:262).  Ours must
never crash, hang, or disagree: for every input — random garbage, mutated
valid streams, truncations — model and native either both reject or both
produce identical bytes; the device pipeline's ok flag must match on
single-block streams."""

import numpy as np
import pytest

from snappytpu import cpu
from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.kernels.pipeline import decode_pipeline
from snappytpu.model import compress as model_compress
from snappytpu.model.decode import CorruptError, decode_ops
from snappytpu.stream import framing


def _model_result(stream: bytes):
    try:
        arr = np.frombuffer(stream, dtype=np.uint8)
        out_len, start = framing.read_preamble(arr)
        if out_len > 1 << 22:
            return ("reject", None)
        return ("ok", decode_ops(arr[start:], out_len).tobytes())
    except (CorruptError, ValueError):
        return ("reject", None)


def _native_result(stream: bytes):
    if not cpu.available:
        return None
    try:
        return ("ok", cpu.decompress(stream))
    except ValueError:  # NativeError or preamble parse failure
        return ("reject", None)


@pytest.mark.parametrize("seed", range(20))
def test_random_garbage_differential(seed):
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, 256, int(rng.integers(1, 3000)), dtype=np.uint8).tobytes()
    m = _model_result(stream)
    n = _native_result(stream)
    if n is not None:
        if m[0] == "ok" and n[0] == "ok":
            assert m[1] == n[1]
        # a >4MiB declared size is a resource guard in the test harness only:
        # model rejects there while native may decode; only compare verdicts
        # when the model actually parsed
        elif m[0] == "ok" or (n is not None and n[0] == "ok"):
            arr = np.frombuffer(stream, dtype=np.uint8)
            try:
                out_len, _ = framing.read_preamble(arr)
            except ValueError:
                out_len = 0
            assert out_len > 1 << 22 or m[0] == n[0]


@pytest.mark.parametrize("seed", range(20))
def test_mutated_valid_streams_differential(seed):
    rng = np.random.default_rng(100 + seed)
    data = corpus.mixed(int(rng.integers(100, 40000)), seed=seed)
    stream = bytearray(model_compress(data))
    for _ in range(int(rng.integers(1, 6))):
        stream[int(rng.integers(0, len(stream)))] = int(rng.integers(0, 256))
    m = _model_result(bytes(stream))
    n = _native_result(bytes(stream))
    if n is not None:
        assert m[0] == n[0], (m[0], n[0])
        if m[0] == "ok":
            assert m[1] == n[1]


@pytest.mark.parametrize("seed", range(8))
def test_device_ok_flag_matches_model(seed):
    rng = np.random.default_rng(200 + seed)
    data = corpus.mixed(int(rng.integers(100, 60000)), seed=seed)
    stream = bytearray(model_compress(data))
    # mutate op region only (skip preamble) to keep out_len stable
    for _ in range(3):
        stream[int(rng.integers(4, len(stream)))] = int(rng.integers(0, 256))
    arr = np.frombuffer(bytes(stream), dtype=np.uint8)
    out_len, start = framing.read_preamble(arr)
    ops = arr[start:]
    if ops.size > C.MAX_COMPRESSED_BLOCK_SIZE or out_len > C.MAX_BLOCK_SIZE:
        pytest.skip("mutation changed sizes beyond single block")
    padded, comp_lens = framing.pad_chunks([ops])
    out, ok = decode_pipeline(padded, comp_lens, np.array([out_len], np.int32))
    ok = bool(np.asarray(ok)[0])
    m = _model_result(bytes(stream))
    if m[0] == "ok":
        assert ok, "device rejected a stream the model decodes"
        assert np.asarray(out)[0, :out_len].tobytes() == m[1]
    else:
        assert not ok, "device accepted a stream the model rejects"


def test_truncations_never_crash():
    data = corpus.text(20000)
    stream = model_compress(data)
    for cut in range(0, len(stream), max(len(stream) // 37, 1)):
        m = _model_result(stream[:cut])
        n = _native_result(stream[:cut])
        if n is not None and cut > 0:
            assert m[0] == n[0] or m[0] == "reject"


# ---- block decoder differential (kernels/decode.decode_blocks: the CUDA
# kernel on a GPU, the plain-JAX decoder on the CPU) ----


def _vm_result(ops: np.ndarray, out_len: int):
    from snappytpu.kernels.decode import decode_blocks

    if out_len > C.MAX_BLOCK_SIZE or ops.size > C.MAX_COMPRESSED_BLOCK_SIZE:
        return None
    padded = np.zeros((1, C.MAX_COMPRESSED_BLOCK_SIZE), np.uint8)
    padded[0, : ops.size] = ops
    out, ok = decode_blocks(
        padded, np.array([ops.size], np.int32), np.array([out_len], np.int32)
    )
    if not bool(np.asarray(ok)[0]):
        return ("reject", None)
    return ("ok", np.asarray(out)[0, :out_len].tobytes())


@pytest.mark.parametrize("seed", range(12))
def test_vm_mutation_differential(seed):
    """Single-block valid stream, one random byte mutated: the block decoder
    and the model decoder must both reject or agree byte-for-byte."""
    rng = np.random.default_rng(1000 + seed)
    data = corpus.mixed(int(rng.integers(500, 60000)), seed=seed)
    comp = model_compress(data)
    arr = np.frombuffer(comp, np.uint8).copy()
    out_len, start = framing.read_preamble(arr)
    idx = int(rng.integers(start, arr.size))
    arr[idx] ^= int(rng.integers(1, 256))
    ops = arr[start:]

    try:
        m = ("ok", decode_ops(ops, out_len).tobytes())
    except (CorruptError, ValueError):
        m = ("reject", None)
    v = _vm_result(ops, out_len)
    if v is None:
        return
    assert v[0] == m[0], f"VM {v[0]} vs model {m[0]}"
    if v[0] == "ok":
        assert v[1] == m[1]


@pytest.mark.parametrize("seed", range(8))
def test_vm_garbage_ops(seed):
    """Random op bytes must never produce ok=True unless the model decoder
    also accepts them (and then with identical bytes)."""
    rng = np.random.default_rng(2000 + seed)
    ops = rng.integers(0, 256, int(rng.integers(2, 2000)), dtype=np.uint8)
    out_len = int(rng.integers(1, 65536))
    try:
        m = ("ok", decode_ops(ops, out_len).tobytes())
    except (CorruptError, ValueError):
        m = ("reject", None)
    v = _vm_result(ops, out_len)
    assert v[0] == m[0]
    if v[0] == "ok":
        assert v[1] == m[1]


@pytest.mark.parametrize("seed", range(8))
def test_vm_mutation_differential_device_streams(seed):
    """Same mutation differential, but on streams produced by the PRODUCTION
    device encoder (encode_v2) rather than the model encoder — the fuzzer
    must exercise the wire shapes the production path actually emits
    (byte-stretched runs, 60/64 chunking, COPY1/COPY2 mix)."""
    from snappytpu.kernels.encode_v2 import encode_blocks_v2

    rng = np.random.default_rng(3000 + seed)
    data = corpus.mixed(int(rng.integers(500, 60000)), seed=seed + 50)
    arr_in = np.frombuffer(data, dtype=np.uint8)
    blocks, lens = framing.pack_blocks(arr_in)
    comp, totals = encode_blocks_v2(blocks, lens)
    total = int(np.asarray(totals)[0])
    ops = np.asarray(comp)[0, :total].copy()
    out_len = int(lens[0])

    idx = int(rng.integers(0, ops.size))
    ops[idx] ^= int(rng.integers(1, 256))

    try:
        m = ("ok", decode_ops(ops, out_len).tobytes())
    except (CorruptError, ValueError):
        m = ("reject", None)
    v = _vm_result(ops, out_len)
    if v is None:
        return
    assert v[0] == m[0], f"VM {v[0]} vs model {m[0]}"
    if v[0] == "ok":
        assert v[1] == m[1]


# ---- windowed stream decoder differential (kernels/decode.decode_stream +
# framing.split_ops_windowed — the sliding-context path for streams whose
# ops straddle 64 KiB output boundaries, snappy_decompression.c:154-161) ----


def _windowed_result(ops: np.ndarray, out_len: int):
    """Full windowed device pipeline verdict: host op-walk split + the
    sliding-window decoder; reject = split refuses OR any chunk not-ok."""
    from snappytpu.kernels.decode import decode_stream

    if out_len > 1 << 21 or ops.size > 1 << 21:
        return None  # resource guard for the test harness
    try:
        chunks, out_lens, ctx_lens = framing.split_ops_windowed(ops, out_len)
    except (CorruptError, ValueError):
        return ("reject", None)
    padded, comp_lens = framing.pad_chunks(chunks)
    out, ok = decode_stream(
        padded, comp_lens, np.asarray(out_lens, np.int32), ctx_lens,
        np.zeros(C.MAX_BLOCK_SIZE, np.uint8),
    )
    out, ok = np.asarray(out), np.asarray(ok)
    if not ok.all():
        return ("reject", None)
    return ("ok", b"".join(out[i, : out_lens[i]].tobytes()
                           for i in range(len(out_lens))))


def _unaligned_stream(rng, seed):
    """A VALID stream whose op boundaries straddle the 64 KiB output grid:
    a short literal prefix phase-shifts a model-encoded tail, so no
    block-aligned split exists (split_ops_stream would refuse it)."""
    shift = int(rng.integers(1, 60))
    data = corpus.mixed(int(rng.integers(70_000, 150_000)), seed=seed)
    head, tail = data[:shift], data[shift:]
    tail_comp = np.frombuffer(model_compress(tail), np.uint8)
    _, tail_start = framing.read_preamble(tail_comp)
    lit = bytes([(shift - 1) << 2]) + head  # one inline-length literal op
    ops = np.frombuffer(lit, np.uint8)
    ops = np.concatenate([ops, tail_comp[tail_start:]])
    return ops, len(data), data


@pytest.mark.parametrize("seed", range(12))
def test_windowed_mutation_differential(seed):
    """Mutated non-block-splittable stream: the windowed device pipeline and
    the model decoder must both reject or agree byte-for-byte."""
    rng = np.random.default_rng(4000 + seed)
    ops, out_len, data = _unaligned_stream(rng, seed)

    w = _windowed_result(ops, out_len)
    assert w == ("ok", data), "pristine unaligned stream must decode"

    for _ in range(3):
        mut = ops.copy()
        for _m in range(int(rng.integers(1, 5))):
            mut[int(rng.integers(0, mut.size))] ^= int(rng.integers(1, 256))
        try:
            m = ("ok", decode_ops(mut, out_len).tobytes())
        except (CorruptError, ValueError):
            m = ("reject", None)
        w = _windowed_result(mut, out_len)
        if w is None:
            continue
        assert w[0] == m[0], f"windowed {w[0]} vs model {m[0]}"
        if w[0] == "ok":
            assert w[1] == m[1]


@pytest.mark.parametrize("seed", range(8))
def test_windowed_truncation_differential(seed):
    """Truncated non-block-splittable streams must be rejected by the
    windowed pipeline exactly when the model rejects them."""
    rng = np.random.default_rng(5000 + seed)
    ops, out_len, _ = _unaligned_stream(rng, seed + 20)
    for frac in (0.25, 0.6, 0.95):
        cut = ops[: int(ops.size * frac)]
        try:
            m = ("ok", decode_ops(cut, out_len).tobytes())
        except (CorruptError, ValueError):
            m = ("reject", None)
        w = _windowed_result(cut, out_len)
        if w is None:
            continue
        assert w[0] == m[0]
        if w[0] == "ok":
            assert w[1] == m[1]


def _api_result(stream: bytes):
    """The host-resident route: api.decompress (native split into rows, the
    block decoder, native compaction) as a verdict."""
    from snappytpu import api

    try:
        return ("ok", api.decompress(stream))
    except ValueError:  # CorruptError, NativeError or a bad preamble
        return ("reject", None)


@pytest.mark.parametrize("seed", range(8))
def test_api_mutation_differential(seed):
    """Mutated multi-block streams through api.decompress must get the same
    verdict and bytes as the native decoder."""
    if not cpu.available:
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(7000 + seed)
    data = corpus.mixed(int(rng.integers(500, 150_000)), seed=seed)
    arr = np.frombuffer(cpu.compress(data), np.uint8).copy()
    _, start = framing.read_preamble(arr)
    for _ in range(int(rng.integers(1, 4))):
        arr[int(rng.integers(start, arr.size))] ^= int(rng.integers(1, 256))
    stream = arr.tobytes()
    assert _api_result(stream) == _native_result(stream)


@pytest.mark.parametrize("seed", range(8))
def test_api_garbage_differential(seed):
    """Random op bytes behind a valid preamble: api.decompress and the native
    decoder reject together, or agree byte-for-byte."""
    if not cpu.available:
        pytest.skip("native runtime unavailable")
    from snappytpu.format.varint import encode_varint

    rng = np.random.default_rng(8000 + seed)
    ops = rng.integers(0, 256, int(rng.integers(2, 2000)), dtype=np.uint8)
    stream = encode_varint(int(rng.integers(1, 65536))) + ops.tobytes()
    assert _api_result(stream) == _native_result(stream)
