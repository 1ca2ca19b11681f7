"""Command-line interface.

Flag-compatible with the reference CLI (`snappy [-c|-b|-d] [-r] in out`,
cmd.c:19-28): `-c` compresses (device backend), `-b` compresses with the
dense profile (same collision-free matcher — the BST variant's raison d'être,
denser matching, is our default), `-d` decompresses, `-r` prints a results
report.  Extras: `--backend device|cpu|model`, `--csv FILE` to append the
reference-schema results row, `roundtrip` verb for compress+decompress+verify.

Usage:
  python -m snappytpu.cli -c in out
  python -m snappytpu.cli -d in.snappy out
  python -m snappytpu.cli roundtrip in --backend cpu
"""

from __future__ import annotations

import argparse
import os
import sys

from .bench.metrics import Result, Timer, write_result_csv
from .format import constants as C


def _codec(backend: str, profile: str = "dense"):
    if backend == "device":
        import functools

        from . import api

        return functools.partial(api.compress, profile=profile), api.decompress
    if backend == "cpu":
        from . import cpu

        if not cpu.available:
            print("native backend unavailable, falling back to model", file=sys.stderr)
            from . import model

            return model.compress, model.decompress
        return cpu.compress, cpu.decompress
    if backend == "model":
        from . import model

        return model.compress, model.decompress
    raise SystemExit(f"unknown backend {backend!r}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="snappytpu", description=__doc__)
    p.add_argument("-c", action="store_true", help="compress infile to outfile")
    p.add_argument("-b", action="store_true", help="compress (dense profile)")
    p.add_argument("-d", action="store_true", help="decompress infile to outfile")
    p.add_argument("-r", action="store_true", help="print results report")
    p.add_argument("paths", nargs="*", help="[verb] infile [outfile]")
    p.add_argument("--backend", default="device", choices=["device", "cpu", "model"])
    p.add_argument("--csv", help="append a reference-schema results row to FILE")
    p.add_argument(
        "--window-mb", type=int, default=0, metavar="MB",
        help="stream file-to-file through a bounded window of this many MB "
             "(device backend; 0 = auto: whole-buffer below 512 MB, 512 MB "
             "windows above — the reference's block-streaming discipline, "
             "snappy_compression.c:210, at device batch granularity)",
    )
    args = p.parse_args(argv)
    if args.backend == "device":
        from .config import enable_compile_cache

        enable_compile_cache()

    # getopt-style flags take priority; otherwise the first positional may be
    # a verb (compress/decompress/roundtrip)
    paths = list(args.paths)
    verb = None
    if paths and paths[0] in ("compress", "decompress", "roundtrip"):
        verb = paths.pop(0)
    if verb is None and (args.c or args.b or args.d):
        verb = "decompress" if args.d else "compress"
    if verb is None:
        p.error("one of -c/-b/-d or a verb is required")
    infile = paths[0] if paths else None
    outfile = paths[1] if len(paths) > 1 else None
    if verb == "roundtrip":
        if not infile:
            p.error("infile required")
    elif not infile or not outfile:
        p.error("infile and outfile required")

    # -c maps to the fast profile, -b to dense — mirroring the reference's
    # hash-table vs BST compressor pair (cmd.c:64-84)
    profile = "fast" if (args.c and not args.b) else "dense"

    # bounded-memory streaming path: file-to-file through a block window
    # (stream/filecodec.py) — explicit via --window-mb, automatic for
    # files too large to comfortably double-buffer in host RAM
    in_size = os.path.getsize(infile)
    auto_stream = args.window_mb == 0 and in_size >= (512 << 20)
    if (args.window_mb > 0 or auto_stream) and args.backend == "device" and \
            verb in ("compress", "decompress"):
        from .stream import filecodec

        wb = max((args.window_mb or 512) << 20, C.MAX_BLOCK_SIZE)
        window_blocks = max(wb // C.MAX_BLOCK_SIZE, 1)
        t = Timer().start()
        if verb == "compress":
            out_size = filecodec.compress_file(
                infile, outfile, profile, window_blocks=window_blocks)
        else:
            out_size = filecodec.decompress_file(
                infile, outfile, window_blocks=window_blocks)
        took = t.stop()
        result = Result(phase=verb, input_size=in_size, output_size=out_size,
                        time_taken=took, backend=args.backend)
        if args.r:
            print(result.report())
        if args.csv:
            write_result_csv(args.csv, result)
        return 0

    compress, decompress = _codec(args.backend, profile)

    with open(infile, "rb") as f:
        data = f.read()

    if verb == "compress":
        t = Timer().start()
        out = compress(data)
        took = t.stop()
        phase = "compress"
    elif verb == "decompress":
        t = Timer().start()
        out = decompress(data)
        took = t.stop()
        phase = "decompress"
    else:  # roundtrip
        t = Timer().start()
        comp = compress(data)
        out = decompress(comp)
        took = t.stop()
        if out != data:
            print("ROUNDTRIP MISMATCH", file=sys.stderr)
            return 1
        print(
            f"roundtrip ok: {len(data)} bytes, ratio {len(data)/max(len(comp),1):.4f}, "
            f"{took*1000:.1f} ms ({args.backend})"
        )
        return 0

    with open(outfile, "wb") as f:
        f.write(out)

    result = Result(
        phase=phase,
        input_size=len(data),
        output_size=len(out),
        time_taken=took,
        backend=args.backend,
    )
    if args.r:
        print(result.report())
    if args.csv:
        write_result_csv(args.csv, result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
