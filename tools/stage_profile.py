"""Encoder stage and decoder profile on the device: queued dispatches over
FRESH inputs per rep (no runtime result reuse), one aggregated scalar
fetch, overhead amortized over NQ queued calls."""
import os, sys, time
import numpy as np
import jax, jax.numpy as jnp
from jax import lax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from snappytpu.bench import corpus
from snappytpu.format import constants as C
from snappytpu.stream import framing
from snappytpu.kernels import encode_v2 as E
from snappytpu.kernels.decode import decode_blocks

t0 = time.time()
def log(m): print(f"[{time.time()-t0:6.1f}s] {m}", flush=True)

B = 128
NQ = 4
log(f"backend {jax.default_backend()}")
batches = []
for q in range(NQ):
    data = np.frombuffer(corpus.mixed(B * C.MAX_BLOCK_SIZE, seed=100 + q), np.uint8)
    blocks_np, lens_np = framing.pack_blocks(data)
    batches.append((jax.device_put(jnp.asarray(blocks_np[:B])),
                    jax.device_put(jnp.asarray(lens_np[:B], jnp.int32))))
_ = int(np.asarray(jnp.sum(batches[-1][0][..., ::997].astype(jnp.int32))))
log("inputs staged")

def prof(name, fn, argsets, reps=2):
    g = jax.jit(lambda *a: [jnp.sum(x[..., ::997].astype(jnp.int32)) for x in jax.tree.leaves(fn(*a))])
    outs = [g(*a) for a in argsets]
    _ = [int(np.asarray(r[0])) for r in outs]
    best = 1e9
    for _ in range(reps):
        t1 = time.perf_counter()
        outs = [g(*a) for a in argsets]
        _ = [int(np.asarray(r[0])) for r in outs]
        best = min(best, (time.perf_counter() - t1) / len(argsets))
    mbs = B * 64 * 1024 / 1e6 / best
    log(f"{name:30s} {best*1000:8.2f} ms/batch  {mbs:7.1f} MB/s")
    return best

# ---- encoder stages (fresh inputs per queued call) ----
prof("find_matches fast", lambda b, n: E._find_matches(b, n, False), batches)
prof("find_matches dense", lambda b, n: E._find_matches(b, n, True), batches)

def mk_tiers(b, n):
    return E._find_matches(b, n, True)

tier_sets = [jax.jit(mk_tiers)(*a) for a in batches]
tier_sets = [jax.tree.map(lambda x: jax.device_put(x), t) for t in tier_sets]
_ = int(np.asarray(tier_sets[-1][0][0][0, 0]))
prof("inherit", E._inherit, [(t, a[1]) for t, a in zip(tier_sets, batches)])
inh_sets = [jax.jit(E._inherit)(t, a[1]) for t, a in zip(tier_sets, batches)]
prof("elect", E._elect, [(t, i, a[1]) for t, i, a in zip(tier_sets, inh_sets, batches)])
el_sets = [jax.jit(E._elect)(t, i, a[1]) for t, i, a in zip(tier_sets, inh_sets, batches)]
prof("reglue", lambda b, ic, ad, ld, tl, n: E._reglue(b, ic, ad, ld, tl, n),
     [(a[0], *e, a[1]) for e, a in zip(el_sets, batches)])
rg_sets = [jax.jit(E._reglue)(a[0], *e, a[1]) for e, a in zip(el_sets, batches)]
prof("emit", lambda b, ic, ad, ld, tl, n: E._emit(b, ic, ad, ld, tl, n),
     [(a[0], *r, a[1]) for r, a in zip(rg_sets, batches)])
prof("encode full dense", lambda b, n: E.encode_block_core(b, n, True), batches)
prof("encode full fast", lambda b, n: E.encode_block_core(b, n, False), batches)

# ---- decode ----
enc = jax.jit(lambda b, n: E.encode_block_core(b, n, True))
dec_sets = []
for (b, l) in batches:
    comp, totals = enc(b, l)
    comp_np, totals_np = np.asarray(comp), np.asarray(totals)
    dec_sets.append((jax.device_put(jnp.asarray(comp_np)),
                     jax.device_put(jnp.asarray(totals_np)), l))
prof("decode", decode_blocks, dec_sets)
log("DONE")
