"""Executable-spec contract for the production encoder: the numpy spec
(model/encode_v2_spec.py) and the device kernel (kernels/encode_v2.py) must
agree on intermediate arrays stage by stage AND on the final byte stream.

This restores the 'every device kernel diffs against a numpy spec' contract
for the v2 pipeline (round-1 verdict item 4): matches -> inherit -> elect ->
reglue intermediates are compared elementwise, then the emitted bytes."""

import numpy as np
import pytest

from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.kernels import encode_v2 as E
from snappytpu.model import encode_v2_spec as S
from snappytpu.model.decode import decode_ops

def _csv_rows(size: int, seed: int = 5) -> bytes:
    """Seeded results-table text: a header and rows of numbers that repeat
    in structure but not in value, like a benchmark CSV."""
    rng = np.random.default_rng(seed)
    rows = ["input_size,output_size,time_taken,speed,ratio"]
    while sum(len(r) + 1 for r in rows) < size:
        n = int(rng.choice([500, 1000, 5000, 10000, 50000]))
        out = int(n / rng.uniform(1.5, 3.5))
        t = rng.uniform(1e-5, 1e-2)
        rows.append(f"{n},{out},{t:.6f},{n / t / 1e6:.3f},{n / out:.4f}")
    return "\n".join(rows).encode()[:size]


CASES = {
    "text_12k": corpus.text(12_000),
    "lowent_8k": corpus.low_entropy(8_000),
    "records_10k": corpus.structured_binary(10_000),
    "random_4k": corpus.random_bytes(4_000),
    "abc_periodic": (b"abcabcabc" * 400)[:3_500],
    "csv_rows": _csv_rows(9_000),
}


def _device_stages(block: np.ndarray, n: int):
    import jax.numpy as jnp

    blocks = jnp.asarray(block[None, :])
    lens = jnp.asarray([n], jnp.int32)
    tiers = E._find_matches(blocks, lens, dense=True)
    mlen, dist = E._best_tier(tiers)
    inh = E._inherit(tiers, lens)
    el = E._elect(tiers, inh, lens)
    rg = E._reglue(blocks, *el, lens)
    comp, totals = E._emit(blocks, *rg, lens)
    return (
        np.asarray(mlen)[0],
        np.asarray(dist)[0],
        tuple(np.asarray(x)[0] for x in inh),
        tuple(np.asarray(x)[0] for x in rg),
        np.asarray(comp)[0, : int(np.asarray(totals)[0])],
    )


@pytest.mark.parametrize("name", sorted(CASES))
def test_spec_matches_device(name):
    data = np.frombuffer(CASES[name], np.uint8)
    n = data.size
    block = np.zeros(S.BS, np.uint8)
    block[:n] = data

    d_mlen, d_dist, d_inh, d_rg, d_bytes = _device_stages(block, n)
    s_bytes, s = S.spec_encode_block(block, n, dense=True)

    # stage 1: per-position best match
    np.testing.assert_array_equal(d_mlen[:n], s["mlen"][:n], err_msg="mlen")
    live = s["mlen"][:n] > 0
    np.testing.assert_array_equal(
        d_dist[:n][live], s["dist"][:n][live], err_msg="dist"
    )

    # stage 2: inherited per-anchor winner
    r2, d2, s2 = s["inherit"]
    na_n = (n + S.G - 1) // S.G
    np.testing.assert_array_equal(d_inh[0][:na_n], r2[:na_n], err_msg="inherit reach")
    inh_live = r2[:na_n] >= 0
    np.testing.assert_array_equal(
        d_inh[1][:na_n][inh_live], d2[:na_n][inh_live], err_msg="inherit dist"
    )

    # stages 3+4: post-reglue election state
    np.testing.assert_array_equal(d_rg[0][:na_n], s["is_copy"][:na_n], err_msg="is_copy")
    cp = s["is_copy"][:na_n]
    np.testing.assert_array_equal(d_rg[1][:na_n][cp], s["ad"][:na_n][cp], err_msg="ad")
    np.testing.assert_array_equal(d_rg[2][:na_n][cp], s["lead"][:na_n][cp], err_msg="lead")
    np.testing.assert_array_equal(d_rg[3][:na_n][cp], s["tail"][:na_n][cp], err_msg="tail")

    # stage 5: byte-identical stream, and it must decode
    assert d_bytes.tobytes() == s_bytes, "emitted bytes differ"
    assert decode_ops(np.frombuffer(s_bytes, np.uint8), n).tobytes() == data.tobytes()
