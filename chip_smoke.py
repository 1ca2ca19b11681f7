"""Smoke test of the whole codec on one NVIDIA GPU, in one process.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the block mesh only

Drives the public entry points at the size of a bulk-file deployment: a
128 MiB input (bench/corpus.py `mixed`, seed 2026: text, record-like
binary, byte runs and random bytes in 4-64 KiB segments) cut into 64 KiB
Snappy blocks, 128 blocks per device call.  Phases:

  compress    api.compress with both profiles, api.decompress back;
              byte-exact, and the native C++ codec reads our streams and
              we read its; compressed sizes beside the native codec's
  resident    one device-resident batch: encode_blocks_v2 then the CUDA
              block decoder, compared on the device with the input, and
              the emit concat compared with a numpy model
  kernels     the CUDA block decoder against the plain-JAX decoder compiled
              for the same card, on 128 mutated 64 KiB blocks, and both
              against the native decoder (ok flags and bytes)
  windowed    a stream whose ops straddle 64 KiB blocks through the CUDA
              windowed decoder, against the plain-JAX one and the input
  golden      the google/snappy wire vectors of tests/golden
  cli         `-c` then `-d` through the CLI, and the same through
              --window-mb (stream/filecodec.py)

With --four: encode_mesh/decode_mesh on a 1-D mesh of four cards over the
same 128 MiB, byte-identical to the one-card api result.

Exits non-zero, printing no result, without a GPU or if any phase fails.
The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
The only child process is nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from snappytpu import api, cpu  # noqa: E402
from snappytpu.bench import corpus  # noqa: E402
from snappytpu.config import enable_compile_cache  # noqa: E402
from snappytpu.format import constants as C  # noqa: E402
from snappytpu.format.varint import encode_varint  # noqa: E402
from snappytpu.stream import framing  # noqa: E402

MB = 128
SEED = 2026
BATCH = 128  # blocks per device call, as api uses
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip()


def make_input(mb: int = MB) -> bytes:
    return corpus.mixed(mb << 20, seed=SEED)


def native_result(stream: bytes):
    try:
        return True, cpu.decompress(stream)
    except ValueError:
        return False, None


def phase_compress(data: bytes) -> dict[str, bytes]:
    streams = {}
    native = cpu.compress(data)
    for profile in ("fast", "dense"):
        t = time.perf_counter()
        comp = api.compress(data, profile=profile)
        t_c = time.perf_counter() - t
        t = time.perf_counter()
        back = api.decompress(comp)
        t_d = time.perf_counter() - t
        check(back == data, f"api round trip, {profile}")
        check(cpu.decompress(comp) == data, f"native decoder reads our {profile} stream")
        log(f"compress {profile}: {len(data)} -> {len(comp)} B (native {len(native)} B), "
            f"ratio {len(data) / len(comp):.4f} vs native {len(data) / len(native):.4f}; "
            f"api.compress {t_c:.2f} s, api.decompress {t_d:.2f} s (first call compiles)")
        streams[profile] = comp
    check(api.decompress(native) == data, "card decoder reads the native stream")
    log("native stream decoded on the card: ok")
    return streams


def phase_resident(data: bytes) -> None:
    import jax
    import jax.numpy as jnp

    from snappytpu.kernels.decode import decode_blocks
    from snappytpu.kernels.encode_v2 import concat_rows, encode_blocks_v2

    blocks, lens = framing.pack_blocks(np.frombuffer(data[: BATCH * C.MAX_BLOCK_SIZE], np.uint8))
    b = jax.device_put(blocks)
    n = jax.device_put(lens)
    comp, totals = encode_blocks_v2(b, n, dense=False)
    out, ok = decode_blocks(comp, totals, n)
    same = jnp.all(out == b, axis=1)
    check(bool(jnp.all(ok)) and bool(jnp.all(same)), "device-resident encode -> decode")
    log(f"resident batch: {blocks.shape[0]} blocks decoded on the card, all exact")

    # the emit concat at the encoder's real shape, against a numpy model
    rng = np.random.default_rng(SEED)
    S, W = 64, 384
    words = rng.integers(-(2 ** 31), 2 ** 31, (BATCH, S, W), dtype=np.int64).astype(np.int32)
    plens = rng.integers(0, 4 * W + 1, (BATCH, S)).astype(np.int32)
    plens[:, ::7] = 0
    got = np.asarray(concat_rows(jnp.asarray(words), jnp.asarray(plens), C.MAX_COMPRESSED_BLOCK_SIZE))
    raw = words.view(np.uint8).reshape(BATCH, S, 4 * W)
    want = np.zeros_like(got)
    for i in range(BATCH):
        row = b"".join(raw[i, s, : plens[i, s]].tobytes() for s in range(S))
        want[i, : len(row)] = np.frombuffer(row, np.uint8)
    check(np.array_equal(got, want), "concat_rows against the numpy model")
    log("emit concat: 128 x 64 pieces match the numpy model")


def phase_kernels(stream: bytes) -> None:
    import jax.numpy as jnp

    from snappytpu.kernels import decode_jax
    from snappytpu.kernels.decode import decode_blocks

    arr = np.frombuffer(stream, np.uint8)
    out_len, start = framing.read_preamble(arr)
    offs, olens = cpu.scan_ops(arr[start:], out_len)
    rows, clens = cpu.split_rows(arr[start:], offs, C.MAX_COMPRESSED_BLOCK_SIZE)
    rows, clens, olens = rows[:BATCH].copy(), clens[:BATCH], olens[:BATCH].astype(np.int32)
    rng = np.random.default_rng(SEED + 1)
    for i in range(1, BATCH):  # row 0 stays pristine
        for _ in range(int(rng.integers(1, 4))):
            rows[i, int(rng.integers(0, clens[i]))] ^= int(rng.integers(1, 256))
    args = (jnp.asarray(rows), jnp.asarray(clens), jnp.asarray(olens))
    k_out, k_ok = (np.asarray(x) for x in decode_blocks(*args))
    r_out, r_ok = (np.asarray(x) for x in decode_jax.decode_blocks(*args))
    check(np.array_equal(k_ok, r_ok), "CUDA and plain-JAX ok flags")
    check(k_ok[0], "pristine row decodes")
    accepted = 0
    for i in range(BATCH):
        n_ok, n_bytes = native_result(encode_varint(int(olens[i])) + rows[i, : clens[i]].tobytes())
        check(bool(k_ok[i]) == n_ok, f"row {i}: card and native verdicts")
        if n_ok:
            accepted += 1
            check(k_out[i, : olens[i]].tobytes() == n_bytes, f"row {i}: card and native bytes")
            check(np.array_equal(k_out[i], r_out[i]), f"row {i}: CUDA and plain-JAX bytes")
    log(f"mutation differential: {BATCH} rows, {accepted} accepted, {BATCH - accepted} rejected; "
        "CUDA, plain JAX and native agree")


def straddling_stream(data: bytes, shift: int = 23):
    """A valid stream whose op boundaries straddle the 64 KiB output grid: a
    short literal phase-shifts a block-disciplined tail."""
    head, tail = data[:shift], data[shift:]
    tail_comp = np.frombuffer(cpu.compress(tail), np.uint8)
    _, tstart = framing.read_preamble(tail_comp)
    ops = np.concatenate([np.frombuffer(bytes([(shift - 1) << 2]) + head, np.uint8),
                          tail_comp[tstart:]])
    return ops


def phase_windowed(data: bytes) -> None:
    import jax.numpy as jnp

    from snappytpu.kernels import decode_jax
    from snappytpu.kernels.decode import decode_stream

    piece = data[: 4 << 20]
    ops = straddling_stream(piece)
    try:
        framing.split_ops_stream(ops, len(piece))
        check(False, "the straddling stream must not be block-splittable")
    except ValueError:
        pass
    split = framing.split_ops_windowed(ops, len(piece))
    check(api._decompress_windowed(split) == piece, "windowed api path")
    chunks, out_lens, ctx_lens = split
    padded, comp_lens = framing.pad_chunks(chunks[:BATCH])
    args = (jnp.asarray(padded), jnp.asarray(comp_lens),
            jnp.asarray(np.asarray(out_lens[:BATCH], np.int32)), jnp.asarray(ctx_lens[:BATCH]),
            jnp.zeros(C.MAX_BLOCK_SIZE, jnp.uint8))
    k_out, k_ok = (np.asarray(x) for x in decode_stream(*args))
    r_out, r_ok = (np.asarray(x) for x in decode_jax.decode_stream(*args))
    check(k_ok.all() and r_ok.all(), "windowed chunks ok")
    check(np.array_equal(k_out, r_out), "CUDA and plain-JAX windowed bytes")
    log(f"windowed: {len(chunks)} chunks, {len(piece)} B exact; CUDA matches plain JAX")


def phase_golden() -> None:
    names = sorted(f[: -len(".snappy")] for f in os.listdir(GOLDEN) if f.endswith(".snappy"))
    check(len(names) >= 8, "golden vectors present")
    for name in names:
        with open(os.path.join(GOLDEN, name + ".raw"), "rb") as f:
            raw = f.read()
        with open(os.path.join(GOLDEN, name + ".snappy"), "rb") as f:
            comp = f.read()
        check(api.decompress(comp) == raw, f"golden {name}")
        for profile in ("fast", "dense"):
            check(cpu.decompress(api.compress(raw, profile=profile)) == raw,
                  f"golden {name} re-encoded ({profile})")
    log(f"golden: {len(names)} google/snappy vectors decoded, re-encoded streams read back")


def phase_cli(data: bytes) -> None:
    from snappytpu import cli

    with tempfile.TemporaryDirectory() as d:
        src, comp, back = (os.path.join(d, n) for n in ("in.bin", "in.snappy", "back.bin"))
        with open(src, "wb") as f:
            f.write(data)
        for extra in ([], ["--window-mb", "16"]):
            check(cli.main(["-c", *extra, src, comp]) == 0, f"cli -c {extra}")
            check(cli.main(["-d", *extra, comp, back]) == 0, f"cli -d {extra}")
            with open(back, "rb") as f:
                check(f.read() == data, f"cli round trip {extra}")
            log(f"cli -c/-d {' '.join(extra) or '(whole buffer)'}: {os.path.getsize(comp)} B, exact")


def phase_four(data: bytes) -> None:
    import jax

    from snappytpu.mesh import decode_mesh, encode_mesh, make_mesh

    check(len(jax.devices()) >= 4, "four cards")
    mesh = make_mesh(4)
    one_card = api.compress(data, profile="fast")
    blocks, lens = framing.pack_blocks(np.frombuffer(data, np.uint8))
    step = 4 * BATCH  # one 128-block batch per card per call
    pieces, rows_all, totals_all = [encode_varint(len(data))], [], []
    t = time.perf_counter()
    for s in range(0, blocks.shape[0], step):
        comp, totals = encode_mesh(mesh, blocks[s:s + step], lens[s:s + step], profile="fast")
        pieces.append(cpu.compact(comp, totals))
        rows_all.append(comp)
        totals_all.append(totals)
    log(f"encode_mesh over 4 cards: {time.perf_counter() - t:.2f} s (first call compiles)")
    mesh_stream = b"".join(pieces)
    check(mesh_stream == one_card, "4-card stream byte-identical to the one-card api stream")
    rows, totals = np.concatenate(rows_all), np.concatenate(totals_all)
    out_parts = []
    t = time.perf_counter()
    for s in range(0, rows.shape[0], step):
        out, ok = decode_mesh(mesh, rows[s:s + step], totals[s:s + step], lens[s:s + step])
        check(ok.all(), "decode_mesh ok flags")
        out_parts.append(cpu.compact(out, lens[s:s + step]))
    log(f"decode_mesh over 4 cards: {time.perf_counter() - t:.2f} s")
    check(b"".join(out_parts) == data, "4-card decode round trip")
    log(f"mesh: {len(data)} B -> {len(mesh_stream)} B on 4 cards, identical to one card")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true", help="run the 4-card block mesh only")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform}", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    log(f"cache {enable_compile_cache()}; {len(devices)} x {devices[0].device_kind}")
    check(cpu.available, "native runtime built")

    data = make_input()
    log(f"input: corpus.mixed({MB} MiB, seed={SEED})")
    if args.four:
        phase_four(data)
    else:
        streams = phase_compress(data)
        phase_resident(data)
        phase_kernels(streams["fast"])
        phase_windowed(data)
        phase_golden()
        phase_cli(data)
    print(json.dumps({"ok": True, "device": {"platform": devices[0].platform,
                                             "kind": devices[0].device_kind,
                                             "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
