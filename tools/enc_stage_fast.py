"""Fast-profile encoder stage breakdown on the device, plus _emit sub-stage
cuts (slots-only / sort-only) to locate the emission cost.  Honest queued
protocol (tools/stage_profile.py)."""
import os, sys, time
import numpy as np
import jax, jax.numpy as jnp
from jax import lax

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
log("inputs staged")

def prof(name, fn, argsets, reps=3):
    g = jax.jit(lambda *a: [jnp.sum(x[..., ::997].astype(jnp.int32))
                            for x in jax.tree.leaves(fn(*a))])
    outs = [g(*a) for a in argsets]
    _ = [int(np.asarray(r[0])) for r in outs]
    best = 1e9
    for _ in range(reps):
        t1 = time.perf_counter()
        outs = [g(*a) for a in argsets]
        _ = [int(np.asarray(r[0])) for r in outs]
        best = min(best, (time.perf_counter() - t1) / len(argsets))
    log(f"{name:34s} {best*1000:8.2f} ms/batch  {B*64*1024/1e6/best:7.1f} MB/s")
    return best

FAST = dict(dense=False)
prof("find fast", lambda b, n: E._find_matches(b, n, **FAST), batches)
tier_sets = [jax.jit(lambda b, n: E._find_matches(b, n, **FAST))(*a) for a in batches]
_ = int(np.asarray(tier_sets[-1][0][0][0, 0]))
prof("inherit", E._inherit, [(t, a[1]) for t, a in zip(tier_sets, batches)])
inh_sets = [jax.jit(E._inherit)(t, a[1]) for t, a in zip(tier_sets, batches)]
prof("elect", E._elect, [(t, i, a[1]) for t, i, a in zip(tier_sets, inh_sets, batches)])
el_sets = [jax.jit(E._elect)(t, i, a[1]) for t, i, a in zip(tier_sets, inh_sets, batches)]
prof("reglue", E._reglue, [(a[0], *e, a[1]) for e, a in zip(el_sets, batches)])
rg_sets = [jax.jit(E._reglue)(a[0], *e, a[1]) for e, a in zip(el_sets, batches)]
prof("emit full", E._emit, [(a[0], *r, a[1]) for r, a in zip(rg_sets, batches)])


# total-only variant: XLA DCEs the slot/sort/concat graph (total depends
# only on the geometry sums), isolating geometry cost from compaction
prof("emit total-only (geometry DCE)",
     lambda b, ic, ad, ld, tl, n: E._emit(b, ic, ad, ld, tl, n)[1],
     [(a[0], *r, a[1]) for r, a in zip(rg_sets, batches)])
prof("encode full fast", lambda b, n: E.encode_block_core(b, n, False), batches)

# ---- find sub-stages: synthetic sorts at the exact tier shapes ----
key = jax.random.PRNGKey(0)
W = E.BS
rnd = lambda w, k: jax.random.randint(jax.random.fold_in(key, k), (B, w),
                                      0, 1 << 30, jnp.int32)
tA = [tuple(rnd(W, 10 * q + j) for j in range(5)) for q in range(NQ)]
tB = [tuple(rnd(W // 4, 100 * q + j) for j in range(17)) for q in range(NQ)]
tBkeys = [tuple(rnd(W // 4, 200 * q + j) for j in range(7)) for q in range(NQ)]
sb = [tuple(rnd(W, 300 * q + j) for j in range(2)) for q in range(NQ)]
_ = int(np.asarray(jnp.sum(tB[-1][0][..., ::97])))
prof("sort tierA shape (1key+4ops, 64k)",
     lambda *a: lax.sort(a, dimension=1, num_keys=1), tA)
prof("sort tierB fast (6key+11ops, 16k)",
     lambda *a: lax.sort(a, dimension=1, num_keys=6), tB)
prof("sort tierB-trim (6key+1op, 16k)",
     lambda *a: lax.sort(a, dimension=1, num_keys=6), tBkeys)
prof("sort sortback (1key+1op, 64k)",
     lambda *a: lax.sort(a, dimension=1, num_keys=1), sb)
log("DONE")
