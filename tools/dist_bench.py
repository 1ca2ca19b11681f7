"""Repeated-run distribution series at the reference's size grid: the
reference ships 5000/500/1000 runs per size (Test_results/, schema
result.c:67-95); best-of rows make avg-vs-max spread incomparable.  This appends ONE ROW PER RUN:

  CPU backend (native C++):  1000 reps/size — directly comparable to the
      reference's single-core series.
  device backend:            100 reps/size; each rep includes one
      dispatch and one scalar fetch, so small-size device rows measure
      per-call LATENCY, exactly as the reference's small-size rows measure
      its per-call overhead.

Series: results/*_dist.csv per (phase, backend, profile).  One process;
the device series needs a GPU and refuses to run without one.
SNAPPYTPU_DIST_BACKENDS=cpu,device  SNAPPYTPU_DIST_SIZES=500,10000,...
SNAPPYTPU_DIST_PROFILES=fast,dense   (device profiles; resume a partial series)
"""
import os, sys, time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from snappytpu import cpu
from snappytpu.bench import corpus, metrics
from snappytpu.format import constants as C
from snappytpu.stream import framing

t0 = time.time()
def log(m): print(f"[{time.time()-t0:6.1f}s] {m}", flush=True)

SIZES = [int(s) for s in os.environ.get(
    "SNAPPYTPU_DIST_SIZES", "500,10000,50000,100000,500000,1000000").split(",")]
BACKENDS = os.environ.get("SNAPPYTPU_DIST_BACKENDS", "cpu,device").split(",")
CPU_REPS = int(os.environ.get("SNAPPYTPU_DIST_CPU_REPS", "1000"))
DEV_REPS = int(os.environ.get("SNAPPYTPU_DIST_DEV_REPS", "100"))
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "results")


def rows_path(phase, backend, profile):
    return os.path.join(OUT, f"{'compression' if phase == 'compress' else 'decompression'}"
                             f"_results_{backend}_{profile}_dist.csv")


def cpu_series():
    os.makedirs(OUT, exist_ok=True)
    if not cpu.available:
        log("native backend unavailable; skipping cpu series")
        return
    for size in SIZES:
        data = corpus.mixed(size, seed=size % 97)
        comp = cpu.compress(data)
        for _ in range(CPU_REPS):
            t1 = time.perf_counter()
            c = cpu.compress(data)
            dt = time.perf_counter() - t1
            metrics.write_result_csv(
                rows_path("compress", "cpu", "hash"),
                metrics.Result("compress", size, len(c), dt, "cpu"))
        for _ in range(CPU_REPS):
            t1 = time.perf_counter()
            d = cpu.decompress(comp)
            dt = time.perf_counter() - t1
            metrics.write_result_csv(
                rows_path("decompress", "cpu", "hash"),
                metrics.Result("decompress", len(comp), len(d), dt, "cpu"))
        log(f"cpu {size}: {2 * CPU_REPS} rows")


def device_series():
    import jax
    import jax.numpy as jnp
    from snappytpu.config import enable_compile_cache
    from snappytpu.kernels.decode import decode_blocks
    from snappytpu.kernels.encode_v2 import encode_block_core

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"device series needs a GPU, found {jax.devices()[0].platform}")
    enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    log(f"device: {jax.devices()[0].device_kind}")
    profiles = os.environ.get("SNAPPYTPU_DIST_PROFILES", "fast,dense").split(",")
    for profile in profiles:
        dense = profile == "dense"
        enc_timed = jax.jit(lambda b, l, dense=dense: (lambda ct: jnp.sum(ct[1]) + jnp.sum(
            ct[0][:, ::997].astype(jnp.int32)))(encode_block_core(b, l, dense)))
        enc_keep = jax.jit(lambda b, l, dense=dense: encode_block_core(b, l, dense))
        dec_timed = jax.jit(lambda c, t, l: (lambda o: jnp.sum(o[1].astype(jnp.int32)) + jnp.sum(
            o[0][:, ::997].astype(jnp.int32)))(decode_blocks(c, t, l)))
        for size in SIZES:
            data = np.frombuffer(corpus.mixed(size, seed=size % 97), np.uint8)
            blocks, lens = framing.pack_blocks(data)
            bb = jax.device_put(jnp.asarray(blocks))
            ll = jax.device_put(jnp.asarray(lens, jnp.int32))
            comp, totals = enc_keep(bb, ll)
            out_size = int(np.asarray(jnp.sum(totals)))
            _ = int(np.asarray(enc_timed(bb, ll)))          # warm
            for _ in range(DEV_REPS):
                t1 = time.perf_counter()
                _ = int(np.asarray(enc_timed(bb, ll)))
                dt = time.perf_counter() - t1
                metrics.write_result_csv(
                    rows_path("compress", "device", profile),
                    metrics.Result("compress", size, out_size, dt, "device"))
            _ = int(np.asarray(dec_timed(comp, totals, ll)))  # warm
            for _ in range(DEV_REPS):
                t1 = time.perf_counter()
                _ = int(np.asarray(dec_timed(comp, totals, ll)))
                dt = time.perf_counter() - t1
                metrics.write_result_csv(
                    rows_path("decompress", "device", profile),
                    metrics.Result("decompress", out_size, size, dt, "device"))
            log(f"device {profile} {size}: {2 * DEV_REPS} rows")


if __name__ == "__main__":
    if "cpu" in BACKENDS:
        cpu_series()
    if "device" in BACKENDS:
        device_series()
    log("DONE")
