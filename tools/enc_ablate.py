"""Fast-encoder ablation timing: each variant is ONE jit over identical
resident inputs, so the per-call dispatch overhead cancels in the
deltas.  Variants produce wire-INVALID streams (measurement only)."""
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

B, NQ = 128, 4
log(f"backend {jax.default_backend()}")
batches = []
for q in range(NQ):
    data = np.frombuffer(corpus.mixed(B * C.MAX_BLOCK_SIZE, seed=100 + q), np.uint8)
    blocks_np, lens_np = framing.pack_blocks(data)
    batches.append((jax.device_put(jnp.asarray(blocks_np[:B])),
                    jax.device_put(jnp.asarray(lens_np[:B], jnp.int32))))
_ = int(np.asarray(jnp.sum(batches[-1][0][..., ::997].astype(jnp.int32))))
log("staged")


def run_variant(name, fn, reps=3):
    g = jax.jit(lambda b, n: (lambda o: jnp.sum(o[1]) + jnp.sum(o[0][:, ::997].astype(jnp.int32)))(fn(b, n)))
    outs = [g(*a) for a in batches]
    _ = [int(np.asarray(r)) for r in outs]
    best = 1e9
    for _r in range(reps):
        t1 = time.perf_counter()
        outs = [g(*a) for a in batches]
        _ = [int(np.asarray(r)) for r in outs]
        best = min(best, (time.perf_counter() - t1) / len(batches))
    log(f"{name:28s} {best*1000:8.2f} ms/batch")
    return best


def pipe(b, n, *, tiers_sel=None, use_reglue=True, use_inherit=True,
         a_ranks=None, nsec=None):
    tiers = E._find_matches(b, n, dense=False, a_ranks=a_ranks)
    if tiers_sel is not None:
        tiers = tiers_sel(tiers)
    inh = E._inherit(tiers, n) if use_inherit else (
        jnp.full((b.shape[0], E.NA), -1, jnp.int32),
        jnp.zeros((b.shape[0], E.NA), jnp.int32),
        jnp.full((b.shape[0], E.NA), -1, jnp.int32))
    ic, ad, ld, tl = E._elect(tiers, inh, n)
    if use_reglue:
        ic, ad, ld, tl = E._reglue(b, ic, ad, ld, tl, n)
    return E._emit(b, ic, ad, ld, tl, n, nsec=nsec)


full = run_variant("full fast", lambda b, n: pipe(b, n))
run_variant("no reglue", lambda b, n: pipe(b, n, use_reglue=False))
run_variant("no inherit", lambda b, n: pipe(b, n, use_inherit=False))
run_variant("no run tiers", lambda b, n: pipe(b, n, tiers_sel=lambda t: t[:2]))
run_variant("no tier B", lambda b, n: pipe(b, n, tiers_sel=lambda t: [t[0]] + t[2:]))
run_variant("a_ranks (1,2)", lambda b, n: pipe(b, n, a_ranks=(1, 2)))
run_variant("a_ranks (1,2,3,4)", lambda b, n: pipe(b, n, a_ranks=(1, 2, 3, 4)))
run_variant("nsec 32", lambda b, n: pipe(b, n, nsec=32))
run_variant("nsec 128", lambda b, n: pipe(b, n, nsec=128))
log("DONE")
