"""encode_v2 (sort/scan-native device encoder): correctness + density.

Three oracles, per SURVEY.md §4's test strategy:
  1. round trip through the numpy model decoder (bit-exact),
  2. cross-decode by the rebuilt reference C binary (wire compat),
  3. compression ratio at least as good as the reference C compressor's
     output on the same inputs (BASELINE.json: ">= reference ratio").
"""

import os
import subprocess

import numpy as np
import pytest

from snappytpu.bench import corpus
from snappytpu.format.varint import encode_varint
from snappytpu.kernels.encode_v2 import encode_blocks_v2
from snappytpu.model import decode as mdec
from snappytpu.stream import framing


def _encode_stream(data: bytes, dense=True) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    blocks, lens = framing.pack_blocks(arr)
    comp, totals = encode_blocks_v2(blocks, lens, dense)
    comp, totals = np.asarray(comp), np.asarray(totals)
    stream = bytearray(encode_varint(len(data)))
    for i in range(blocks.shape[0]):
        stream += comp[i, : totals[i]].tobytes()
    return bytes(stream)


CASES = dict(corpus.edge_case_corpus())
CASES["mixed200k"] = corpus.mixed(200_000, seed=8)
CASES["rep"] = (b"snappy on gpu! " * 7000)[:100_000]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dense", [True, False])
def test_roundtrip_model_decoder(name, dense):
    data = CASES[name]
    if not data:
        return
    stream = _encode_stream(data, dense)
    assert mdec.decompress(stream) == data


@pytest.mark.parametrize("name", ["alice_like_text", "mixed200k", "32k_ff"])
def test_reference_binary_decodes_v2(name, reference_cli, tmp_path):
    data = CASES[name]
    stream = _encode_stream(data)
    comp_f = tmp_path / "in.snappy"
    out_f = tmp_path / "out.raw"
    comp_f.write_bytes(stream)
    subprocess.run(
        [reference_cli, "-d", str(comp_f), str(out_f)],
        cwd=tmp_path, check=True, capture_output=True,
    )
    assert out_f.read_bytes() == data


def test_ratio_beats_reference(reference_cli, tmp_path):
    """Corpus-aggregate density >= the reference compressor's, per
    BASELINE.json ("bit-exact round trip at >= reference ratio")."""
    names = ["alice_like_text", "mixed200k", "32k_ff", "low_entropy_runs",
             "binary_image_like", "32k_random"]
    ours_total = ref_total = raw_total = 0
    per_case = {}
    for name in names:
        data = CASES[name]
        raw = tmp_path / f"{name}.raw"
        raw.write_bytes(data)
        refc = tmp_path / f"{name}.snappy"
        subprocess.run(
            [reference_cli, "-c", str(raw), str(refc)],
            cwd=tmp_path, check=True, capture_output=True,
        )
        ours = len(_encode_stream(data))
        ours_total += ours
        ref_total += refc.stat().st_size
        raw_total += len(data)
        per_case[name] = (ours, refc.stat().st_size)
    assert ours_total <= ref_total, f"aggregate {ours_total} > ref {ref_total}: {per_case}"
    # per-fixture strictness is covered by test_reference_compat.py's
    # no-slack contract (ours <= min(ref -c, ref -b) on every fixture AND
    # real files); no slack multiplier here that could mask a regression


def test_fast_profile_ratio_contract(reference_cli, tmp_path):
    """The fast profile's explicit contract (README/PARITY): corpus-AGGREGATE
    density >= the reference hash compressor's — per-fixture strictness is
    dense's contract only (fast trades per-fixture guarantees for speed,
    the reference's own hash-vs-BST tradeoff, snappy_compression_tree.c)."""
    names = ["alice_like_text", "mixed200k", "32k_ff", "low_entropy_runs",
             "binary_image_like", "32k_random"]
    ours_total = ref_total = 0
    per_case = {}
    for name in names:
        data = CASES[name]
        raw = tmp_path / f"{name}.raw"
        raw.write_bytes(data)
        refc = tmp_path / f"{name}.snappy"
        subprocess.run(
            [reference_cli, "-c", str(raw), str(refc)],
            cwd=tmp_path, check=True, capture_output=True,
        )
        ours = len(_encode_stream(data, dense=False))
        ours_total += ours
        ref_total += refc.stat().st_size
        per_case[name] = (ours, refc.stat().st_size)
    assert ours_total <= ref_total, (
        f"fast aggregate {ours_total} > ref {ref_total}: {per_case}"
    )


def test_emit_straggler_at_section_boundary():
    """The emission packs the third op byte into the NEXT position's slot;
    a section-final op start instead uses the dedicated straggler lane.
    Force a COPY2 op start at exactly position sp-1 (the last position of
    emission section 0) via crafted election state and verify the stream
    byte-decodes."""
    import jax.numpy as jnp
    from snappytpu.kernels.encode_v2 import _emit, _NSEC, BS, G, NA

    sp = BS // _NSEC
    rng = np.random.default_rng(11)
    dist = 50
    E = 8200
    data = rng.integers(0, 256, BS, dtype=np.uint8)
    for q in range(63, E):
        data[q] = data[q - dist]
    # copy run covering bytes 63..E: anchors 16..E//4, lead 1 at the head
    # (64 - 1 = byte 63), so op starts land at 63 + 64k — including sp-1,
    # the section-0-final position (sp is a multiple of 64, so
    # sp-1 === 63 mod 64 for any section count)
    assert (sp - 1 - 63) % 64 == 0 and E > sp + 4
    is_copy = np.zeros((1, NA), bool)
    is_copy[0, 16 : E // G] = True
    ad = np.where(is_copy, dist, 0).astype(np.int32)
    lead = np.zeros((1, NA), np.int32)
    lead[0, 16] = 1
    tail = np.zeros((1, NA), np.int32)
    n = np.array([BS], np.int32)
    comp, total = _emit(
        jnp.asarray(data[None, :]), jnp.asarray(is_copy), jnp.asarray(ad),
        jnp.asarray(lead), jnp.asarray(tail), jnp.asarray(n),
    )
    stream = np.asarray(comp)[0, : int(np.asarray(total)[0])]
    out = mdec.decode_ops(np.asarray(stream), BS)
    assert out.tobytes() == data.tobytes()


def test_empty_and_tiny():
    assert mdec.decompress(_encode_stream(b"")) == b""
    for payload in (b"a", b"ab", b"abc", b"abcd", b"\x00" * 7):
        assert mdec.decompress(_encode_stream(payload)) == payload


def test_block_tail_alignment():
    # lengths straddling the 4-byte anchor grid and the block boundary
    base = corpus.text(70_000, seed=3)
    for ln in (65533, 65536, 65537, 65541, 69999):
        data = base[:ln]
        assert mdec.decompress(_encode_stream(data)) == data


def test_emission_max_density_and_capacity_guard():
    """Emission-capacity contract.

    (a) The densest legal emission geometry the anchor-tile grid admits —
        a [4-byte COPY2 op][64-byte literal] alternation, ~1.015 emitted
        bytes/position sustained (the 2-byte literal header at rlen 64 is
        the peak header density a 4-aligned gap allows) — emits MORE
        bytes than it covers, stays within _section_capacity's 1.31*sp
        bound with margin, and byte-decodes.
    (b) The in-jit guard: with seccap overridden below the achieved
        density, _emit reports total = -1 (the encode-side ok bit)
        instead of silently truncating section slots, which is what
        shipped before the guard existed.
    """
    import jax.numpy as jnp
    from snappytpu.kernels.encode_v2 import (
        _emit, _section_capacity, _NSEC, BS, G, NA,
    )

    sp = BS // _NSEC
    rng = np.random.default_rng(23)
    dist = 4000          # >= 2048 forces COPY2 (3 op bytes per 4-byte op)
    data = rng.integers(0, 256, dist, dtype=np.uint8)
    data = np.resize(data, BS)            # period-4000 => all copies verify
    start_a = dist // G                   # first anchor where dist <= a_pos
    # copy anchors every 17th tile: 4 covered bytes + 64-byte literal gap
    # per 68-byte period => (3 + 64 + 2) / 68 = 1.0147 bytes/position
    is_copy = np.zeros((1, NA), bool)
    is_copy[0, start_a::17] = True
    ad = np.where(is_copy, dist, 0).astype(np.int32)
    lead = np.zeros((1, NA), np.int32)
    tail = np.zeros((1, NA), np.int32)
    n = np.array([BS], np.int32)
    args = (
        jnp.asarray(data[None, :]), jnp.asarray(is_copy), jnp.asarray(ad),
        jnp.asarray(lead), jnp.asarray(tail), jnp.asarray(n),
    )

    comp, total = _emit(*args)
    t = int(np.asarray(total)[0])
    assert t > 0, "max-density emission must not overflow the derived bound"
    assert t > BS, "the adversarial shape must expand (density > 1)"
    stream = np.asarray(comp)[0, :t]
    out = mdec.decode_ops(np.asarray(stream), BS)
    assert out.tobytes() == data.tobytes()
    assert _section_capacity(sp) >= sp + sp // 4  # the margin the bound claims

    # (b) guard fires when capacity is (artificially) insufficient: the
    # steady-state sections need ~1.015 * sp slots, so capacity sp drops
    # slots today without the guard — with it, the total is poisoned
    comp2, total2 = _emit(*args, seccap=sp)
    assert int(np.asarray(total2)[0]) == -1, (
        "sections over capacity must poison the total, not drop slots"
    )
