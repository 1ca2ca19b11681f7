"""Benchmark sweeps producing reference-style CSV series.

The reference's Test_results/ holds 4 repeated-run CSV series (hash, alt,
BST compressors and decompression) over a 500 B..1 MB size grid
(snappy_test.c:7, result.c:67-95).  This module reproduces that shape for
any backend/profile so new numbers are directly comparable, and adds:

  * a large REAL-file point (the Silesia stand-in from corpus.silesia_standin,
    BASELINE config 3),
  * a --mesh mode that measures the shard_map'ed mesh codec
    (snappytpu.mesh.sharding) over all visible devices — sharding overhead
    as a number (BASELINE configs 4/5 at whatever device count is visible).

Run: python -m snappytpu.bench.sweep --backend device --profile dense \
         --out results
"""

from __future__ import annotations

import argparse
import os
import time

from . import corpus
from .metrics import Result, write_result_csv

SIZES = [500, 1000, 5000, 10000, 50000, 100000, 500000, 1000000]


def _codec(backend: str, profile: str):
    if backend == "device":
        import functools

        from .. import api

        return functools.partial(api.compress, profile=profile), api.decompress
    if backend == "cpu":
        from .. import cpu

        assert cpu.available, "native backend unavailable"
        return cpu.compress, cpu.decompress
    from .. import model

    return model.compress, model.decompress


def _mesh_codec(profile: str):
    """End-to-end mesh compress/decompress over all visible devices."""
    import numpy as np

    from .. import cpu
    from ..format import constants as C
    from ..format.varint import encode_varint
    from ..mesh import sharding
    from ..stream import framing

    mesh = sharding.make_mesh()

    def _compact(rows: np.ndarray, lens: np.ndarray) -> bytes:
        if cpu.available:
            return cpu.compact(rows, lens)
        return b"".join(rows[i, : int(lens[i])].tobytes() for i in range(rows.shape[0]))

    def compress(data: bytes) -> bytes:
        arr = np.frombuffer(data, np.uint8)
        blocks, lens = framing.pack_blocks(arr)
        comp, totals = sharding.encode_mesh(mesh, blocks, lens)
        return encode_varint(arr.size) + _compact(np.asarray(comp), np.asarray(totals))

    def decompress(stream: bytes) -> bytes:
        arr = np.frombuffer(stream, np.uint8)
        out_len, start = framing.read_preamble(arr)
        if cpu.available:
            offs, out_lens = cpu.scan_ops(arr[start:], out_len)
            padded, comp_lens = cpu.split_rows(
                arr[start:], offs, C.MAX_COMPRESSED_BLOCK_SIZE
            )
            out_lens = out_lens.astype(np.int32)
        else:
            chunks, out_lens_list = framing.split_ops_stream(arr[start:], out_len)
            padded, comp_lens = framing.pad_chunks(chunks)
            out_lens = np.asarray(out_lens_list, np.int32)
        out, ok = sharding.decode_mesh(mesh, padded, comp_lens, out_lens)
        assert ok.all()
        return _compact(np.asarray(out), out_lens)

    return compress, decompress, mesh.devices.size


def _best_of(fn, reps):
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return out, best


def run_sweep(backend: str = "cpu", profile: str = "dense", reps: int = 5,
              out_dir: str = "results", sizes=SIZES,
              real_file_mb: int = 0, mesh: bool = False,
              n_hosts: int = 1) -> list[Result]:
    os.makedirs(out_dir, exist_ok=True)
    n_chips = 1
    if mesh:
        compress, decompress, n_chips = _mesh_codec(profile)
        tag = f"mesh{n_chips}_{profile}"
    else:
        compress, decompress = _codec(backend, profile)
        tag = f"{backend}_{profile}"
    comp_csv = os.path.join(out_dir, f"compression_results_{tag}.csv")
    dec_csv = os.path.join(out_dir, f"decompression_results_{tag}.csv")

    inputs = [(size, corpus.mixed(size, seed=size)) for size in sizes]
    if real_file_mb:
        inputs.append((real_file_mb << 20, corpus.silesia_standin(real_file_mb << 20)))

    results = []
    for size, data in inputs:
        compress(data)  # warm (compiles on device backend)
        comp, best_c = _best_of(lambda: compress(data), reps)
        r = Result("compress", size, len(comp), best_c, backend, n_chips, n_hosts)
        write_result_csv(comp_csv, r)
        results.append(r)

        out = decompress(comp)
        assert out == data, f"round trip mismatch at size {size}"
        out, best_d = _best_of(lambda: decompress(comp), reps)
        r = Result("decompress", len(comp), size, best_d, backend, n_chips, n_hosts)
        write_result_csv(dec_csv, r)
        results.append(r)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--backend", default="cpu", choices=["device", "cpu", "model"])
    p.add_argument("--profile", default="dense", choices=["dense", "fast"])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default="results")
    p.add_argument("--real-file-mb", type=int, default=0,
                   help="append a Silesia-stand-in point of this many MB")
    p.add_argument("--mesh", action="store_true",
                   help="measure the shard_map mesh codec over all devices")
    args = p.parse_args(argv)
    for r in run_sweep(args.backend, args.profile, args.reps, args.out,
                       real_file_mb=args.real_file_mb, mesh=args.mesh):
        print(r.report())
        print()


if __name__ == "__main__":
    main()
