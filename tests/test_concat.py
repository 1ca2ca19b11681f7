"""The encoder's emit concat (kernels/encode_v2.concat_rows) against a numpy
model: row b is its pieces' first lens[b, s] bytes in order, zero-padded."""

import jax.numpy as jnp
import numpy as np
import pytest

from snappytpu.kernels.encode_v2 import concat_rows


def _model(words: np.ndarray, lens: np.ndarray, out_cap: int) -> np.ndarray:
    B, S, W = words.shape
    raw = words.astype(np.int32).view(np.uint8).reshape(B, S, 4 * W)
    out = np.zeros((B, out_cap), np.uint8)
    for b in range(B):
        row = b"".join(raw[b, s, : lens[b, s]].tobytes() for s in range(S))
        out[b, : len(row)] = np.frombuffer(row, np.uint8)
    return out


def _words(rng, shape):
    return rng.integers(-(2 ** 31), 2 ** 31, shape, dtype=np.int64).astype(np.int32)


def _run(words, lens, out_cap):
    return np.asarray(concat_rows(jnp.asarray(words), jnp.asarray(lens, jnp.int32), out_cap))


@pytest.mark.parametrize("seed", range(4))
def test_concat_matches_numpy_model(seed):
    rng = np.random.default_rng(seed)
    B, S, W = 3, 16, 32
    words = _words(rng, (B, S, W))
    lens = rng.integers(0, 4 * W + 1, (B, S)).astype(np.int32)
    out_cap = S * 4 * W
    np.testing.assert_array_equal(_run(words, lens, out_cap), _model(words, lens, out_cap))


def test_concat_piece_offsets_are_cumulative_lengths():
    # piece s holds bytes of value s + 1, so each output byte names its source
    B, S, W = 1, 5, 4
    words = np.zeros((B, S, W), np.int32)
    for s in range(S):
        words[0, s] = np.frombuffer(bytes([s + 1]) * 4 * W, np.int32)
    lens = np.array([[3, 0, 16, 1, 5]], np.int32)
    out = _run(words, lens, 32)[0]
    want = [1] * 3 + [3] * 16 + [4] * 1 + [5] * 5
    assert out[: len(want)].tolist() == want
    assert not out[len(want):].any()


def test_concat_zero_length_pieces():
    rng = np.random.default_rng(7)
    B, S, W = 2, 8, 8
    words = _words(rng, (B, S, W))
    lens = np.zeros((B, S), np.int32)
    lens[1, ::3] = 9  # only some pieces of row 1 carry bytes
    out = _run(words, lens, 512)
    assert not out[0].any()
    np.testing.assert_array_equal(out, _model(words, lens, 512))


def test_concat_full_rows():
    # every piece full and the row exactly full: no padding at all
    rng = np.random.default_rng(8)
    B, S, W = 2, 4, 16
    words = _words(rng, (B, S, W))
    lens = np.full((B, S), 4 * W, np.int32)
    out = _run(words, lens, S * 4 * W)
    np.testing.assert_array_equal(out, words.view(np.uint8).reshape(B, -1))


def test_concat_pads_with_zeros_past_the_pieces():
    # bytes of a piece past its length never reach the output
    B, S, W = 1, 2, 8
    words = np.full((B, S, W), -1, np.int32)
    lens = np.array([[5, 2]], np.int32)
    out = _run(words, lens, 64)[0]
    assert out[:7].tolist() == [255] * 7
    assert not out[7:].any()
