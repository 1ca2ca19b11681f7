"""The CUDA decode kernels (kernels/csrc/decode.cu) and their JAX wrappers.

CPU tests cover what surrounds the kernels: the result shapes the wrappers
declare, that the dispatcher lowers to the FFI targets for CUDA and to the
plain-JAX decoder for the CPU, and that a missing compiler raises instead of
falling back.  Tests marked `gpu` run the kernels themselves against the
plain-JAX reference on the card and skip without one:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import export

from snappytpu import cpu
from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.kernels import decode as D
from snappytpu.kernels import decode_jax
from snappytpu.stream import framing

BS, PAD = C.MAX_BLOCK_SIZE, C.MAX_COMPRESSED_BLOCK_SIZE


def _block_args(n):
    return (jax.ShapeDtypeStruct((n, PAD), jnp.uint8), jax.ShapeDtypeStruct((n,), jnp.int32),
            jax.ShapeDtypeStruct((n,), jnp.int32))


def _stream_args(n):
    return _block_args(n) + (jax.ShapeDtypeStruct((n,), jnp.int32),
                             jax.ShapeDtypeStruct((BS,), jnp.uint8))


CASES = {
    "blocks": (D._cuda_blocks, D.decode_blocks, _block_args, "snappy_decode_blocks"),
    "stream": (D._cuda_stream, D.decode_stream, _stream_args, "snappy_decode_stream"),
}


@pytest.mark.parametrize("n", [1, 128])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_cuda_wrapper_result_shapes(kind, n):
    cuda_fn, _, make_args, _ = CASES[kind]
    out, ok = jax.eval_shape(cuda_fn, *make_args(n))
    assert (out.shape, out.dtype) == ((n, BS), jnp.uint8)
    assert (ok.shape, ok.dtype) == ((n,), jnp.bool_)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_dispatch_lowers_to_ffi_on_cuda_only(kind):
    _, entry, make_args, target = CASES[kind]
    on_cuda = export.export(
        entry, platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(target)],
    )(*make_args(4)).mlir_module()
    on_cpu = export.export(entry, platforms=["cpu"])(*make_args(4)).mlir_module()
    assert f"@{target}" in on_cuda
    assert target not in on_cpu


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(D, "_BUILD", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        D.build()


def test_library_is_named_by_its_source(monkeypatch, tmp_path):
    lib = D.library_path()
    assert os.path.dirname(lib) == D._BUILD and lib == D.library_path()
    edited = tmp_path / "decode.cu"
    edited.write_bytes(open(D._SRC, "rb").read() + b"\n")
    monkeypatch.setattr(D, "_SRC", str(edited))
    assert D.library_path() != lib


# ---- on the card ----

@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU")


def _mutated_batch(data: bytes, seed: int):
    stream = np.frombuffer(cpu.compress(data), np.uint8)
    out_len, start = framing.read_preamble(stream)
    offs, olens = cpu.scan_ops(stream[start:], out_len)
    rows, clens = cpu.split_rows(stream[start:], offs, PAD)
    rng = np.random.default_rng(seed)
    for i in range(1, rows.shape[0], 2):
        rows[i, int(rng.integers(0, clens[i]))] ^= int(rng.integers(1, 256))
    return rows, clens, olens.astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["text", "runs", "random", "mixed"])
def test_cuda_blocks_match_plain_reference(gpu, kind):
    gen = {"text": corpus.text, "runs": corpus.low_entropy,
           "random": corpus.random_bytes, "mixed": corpus.mixed}[kind]
    rows, clens, olens = _mutated_batch(gen(128 * BS), seed=len(kind))
    k_out, k_ok = map(np.asarray, D.decode_blocks(rows, clens, olens))
    r_out, r_ok = map(np.asarray, decode_jax.decode_blocks(rows, clens, olens))
    np.testing.assert_array_equal(k_ok, r_ok)
    assert k_ok[::2].all()  # the unmutated rows
    np.testing.assert_array_equal(k_out[k_ok], r_out[k_ok])


@pytest.mark.gpu
def test_cuda_stream_matches_plain_reference(gpu):
    data = corpus.mixed(2 << 20, seed=3)
    tail = np.frombuffer(cpu.compress(data[23:]), np.uint8)
    _, ts = framing.read_preamble(tail)
    ops = np.concatenate([np.frombuffer(bytes([22 << 2]) + data[:23], np.uint8), tail[ts:]])
    chunks, out_lens, ctx_lens = framing.split_ops_windowed(ops, len(data))
    padded, comp_lens = framing.pad_chunks(chunks)
    args = (padded, comp_lens, np.asarray(out_lens, np.int32), ctx_lens, np.zeros(BS, np.uint8))
    k_out, k_ok = map(np.asarray, D.decode_stream(*args))
    r_out, r_ok = map(np.asarray, decode_jax.decode_stream(*args))
    assert k_ok.all() and r_ok.all()
    np.testing.assert_array_equal(k_out, r_out)
    assert b"".join(k_out[i, :n].tobytes() for i, n in enumerate(out_lens)) == data
