"""Focused full-encoder timing A/B on the device: stages the bench corpus
once, then times encode_block_core for each (profile, nsec) configuration
in one process (honest queued-dispatch protocol, scalar fetches)."""
import os, sys, time
import numpy as np
import jax, jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.stream import framing
from snappytpu.kernels import encode_v2 as E

t0 = time.time()
def log(m): print(f"[{time.time()-t0:6.1f}s] {m}", flush=True)

B = 128
NQ = int(os.environ.get("SNAPPYTPU_ENC_NQ", "4"))
CFGS = os.environ.get("SNAPPYTPU_ENC_CFGS", "fast:16,fast:32,dense:16,dense:32")

log(f"backend {jax.default_backend()}")
batches = []
for q in range(NQ):
    data = np.frombuffer(corpus.mixed(B * C.MAX_BLOCK_SIZE, seed=100 + q), np.uint8)
    blocks_np, lens_np = framing.pack_blocks(data)
    batches.append((jax.device_put(jnp.asarray(blocks_np[:B])),
                    jax.device_put(jnp.asarray(lens_np[:B], jnp.int32))))
_ = int(np.asarray(jnp.sum(batches[-1][0][..., ::997].astype(jnp.int32))))
log("inputs staged")

# optional third token selects a matcher-kwarg preset (tools/enc_variants.py)
PRESETS = {
    "": {},
    "k12samp": dict(dense_keys=(0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 15)),
    "k12samp+a5": dict(dense_keys=(0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 15),
                       a_ranks=(1, 2, 3, 4, 5)),
    "k10samp+a6": dict(dense_keys=(0, 1, 2, 3, 4, 6, 8, 10, 12, 14),
                       a_ranks=(1, 2, 3, 4, 5, 6)),
    "k14samp": dict(dense_keys=(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 13, 15)),
    "k13samp": dict(dense_keys=(0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 15)),
}

for cfg in CFGS.split(","):
    parts = cfg.split(":")
    prof, nsec = parts[0], parts[1]
    kw = PRESETS[parts[2]] if len(parts) > 2 else {}
    dense = prof == "dense"
    nsec = int(nsec)

    def run(b, n, dense=dense, nsec=nsec, kw=kw):
        tiers = E._find_matches(b, n, dense=dense, **kw)
        inh = E._inherit(tiers, n)
        ic, ad, ld, tl = E._elect(tiers, inh, n)
        ic, ad, ld, tl = E._reglue(b, ic, ad, ld, tl, n)
        comp, totals = E._emit(b, ic, ad, ld, tl, n, nsec=nsec)
        return jnp.sum(totals) + jnp.sum(comp[:, ::997].astype(jnp.int32)), jnp.sum(totals)

    g = jax.jit(run)
    outs = [g(*a) for a in batches]
    tot = sum(int(np.asarray(o[1])) for o in outs)
    best = 1e9
    for _ in range(3):
        t1 = time.perf_counter()
        outs = [g(*a) for a in batches]
        _ = [int(np.asarray(o[0])) for o in outs]
        best = min(best, (time.perf_counter() - t1) / len(batches))
    mbs = B * 64 * 1024 / 1e6 / best
    log(f"encode {prof}:{nsec:3d}  {best*1000:8.2f} ms/batch  {mbs:7.1f} MB/s  "
        f"ratio {NQ * B * 64 * 1024 / max(tot, 1):.3f}")
log("DONE")
