"""Hand-written kernels against what XLA makes of the plain version, on one
NVIDIA GPU.

    python tools/kernel_vs_xla.py [--reps N]

Block decode: the CUDA kernel (kernels/decode.decode_blocks) against the
plain-JAX parallel-scan decoder (kernels/decode_jax.decode_blocks) compiled
for the same card, on the same device-resident batch of 128 blocks of
64 KiB encoded by encode_blocks_v2 (fast profile), for text, byte runs,
random bytes and the mixed corpus separately.  The two must agree on every
byte and ok flag.

Emit concat: the plain gather (kernels/encode_v2.concat_rows) at the
encoder's shape (128 rows of 64 sections of 1536 bytes into 73,728-byte
rows), beside a full encode of the same batch for its share.

Times are host-clock medians over --reps calls, each ended by
block_until_ready (launch overhead included).  Rates are input-side GB/s of
uncompressed bytes.  Memory-roofline shares use 3.35 TB/s (H100 SXM data
sheet) and count the bytes each call must read and write.  Prints one JSON
line per measurement; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from snappytpu.bench import corpus  # noqa: E402
from snappytpu.config import enable_compile_cache  # noqa: E402
from snappytpu.format import constants as C  # noqa: E402
from snappytpu.stream import framing  # noqa: E402

B = 128
HBM_BYTES_PER_S = 3.35e12
CLASSES = {
    "text": lambda n: corpus.text(n, seed=11),
    "runs": lambda n: corpus.low_entropy(n, seed=12),
    "random": lambda n: corpus.random_bytes(n, seed=13),
    "mixed": lambda n: corpus.mixed(n, seed=14),
}


def median_ms(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)) * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from snappytpu.kernels import decode_jax
    from snappytpu.kernels.decode import decode_blocks
    from snappytpu.kernels.encode_v2 import concat_rows, encode_blocks_v2

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "device_kind": dev.device_kind}), flush=True)
    enable_compile_cache()

    def emit(rec):
        print(json.dumps(rec), flush=True)

    for name, gen in CLASSES.items():
        data = np.frombuffer(gen(B * C.MAX_BLOCK_SIZE), np.uint8)
        blocks, lens = framing.pack_blocks(data)
        b, n = jax.device_put(blocks), jax.device_put(lens)
        comp, totals = encode_blocks_v2(b, n, dense=False)
        jax.block_until_ready(comp)
        comp_bytes = int(jnp.sum(totals))
        k_out, k_ok = decode_blocks(comp, totals, n)
        r_out, r_ok = decode_jax.decode_blocks(comp, totals, n)
        agree = bool(jnp.all(k_ok == r_ok)) and bool(jnp.all(k_out == r_out))
        exact = bool(jnp.all(k_ok)) and bool(jnp.all(k_out == b))
        moved = comp_bytes + B * C.MAX_BLOCK_SIZE
        for impl, fn in (("cuda", decode_blocks), ("xla", decode_jax.decode_blocks)):
            ms = median_ms(fn, (comp, totals, n), args.reps)
            emit({"op": "decode", "class": name, "impl": impl, "ms": ms,
                  "gbps": data.size / ms / 1e6, "ratio": data.size / comp_bytes,
                  "hbm_share": moved / HBM_BYTES_PER_S / (ms / 1e3),
                  "agree": agree, "exact": exact})
        for dense in (False, True):
            ms = median_ms(lambda x, y: encode_blocks_v2(x, y, dense=dense), (b, n), args.reps)
            emit({"op": "encode", "class": name, "profile": "dense" if dense else "fast",
                  "ms": ms, "gbps": data.size / ms / 1e6})

    rng = np.random.default_rng(5)
    S, W = 64, 384
    words = jnp.asarray(rng.integers(-(2 ** 31), 2 ** 31, (B, S, W), dtype=np.int64).astype(np.int32))
    plens = rng.integers(0, 4 * W + 1, (B, S)).astype(np.int32)
    out_bytes = B * C.MAX_COMPRESSED_BLOCK_SIZE
    moved = out_bytes + int(plens.sum()) + plens.nbytes
    concat = jax.jit(concat_rows, static_argnums=2)
    ms = median_ms(lambda w, l: concat(w, l, C.MAX_COMPRESSED_BLOCK_SIZE),
                   (words, jnp.asarray(plens)), args.reps)
    emit({"op": "concat", "impl": "xla", "ms": ms, "hbm_share": moved / HBM_BYTES_PER_S / (ms / 1e3),
          "bytes_moved": moved})
    return 0


if __name__ == "__main__":
    sys.exit(main())
