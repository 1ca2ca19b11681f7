"""Dense-profile tier-B/tier-A configuration matrix vs the strict-size
contract (ours <= min(reference -c, -b) per fixture) — the offline search
for a cheaper sort that keeps every margin.  CPU-only; speed of surviving
configs is measured separately on the GPU (tools/enc_profile.py).

Each config is threaded through encode_block_core's keyword knobs (real
function args, so every variant traces separately)."""
import os, subprocess, sys, tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import numpy as np
from conftest import _build_reference_cli  # noqa: E402
from snappytpu.bench import corpus  # noqa: E402
from snappytpu.format.varint import encode_varint  # noqa: E402
from snappytpu.kernels.encode_v2 import encode_block_core  # noqa: E402
from snappytpu.stream import framing  # noqa: E402

import jax

exe = _build_reference_cli()
FIX = {k: v for k, v in corpus.edge_case_corpus().items() if k != "empty"}
FIX.update(
    {
        f"real:{name}": data[:262144]
        for name, data in sorted(corpus.reference_files().items())[:6]
        if len(data) > 1024
    }
)


def ref_best(data: bytes) -> int:
    with tempfile.TemporaryDirectory() as d:
        src, comp = os.path.join(d, "in"), os.path.join(d, "out")
        open(src, "wb").write(data)
        best = None
        for flag in ("-c", "-b"):
            subprocess.run([exe, flag, src, comp], capture_output=True, timeout=300,
                           cwd=os.path.dirname(exe), check=True)
            s = os.path.getsize(comp)
            best = s if best is None else min(best, s)
    return best


REF = {name: ref_best(data) for name, data in sorted(FIX.items())}

CONFIGS = {
    "base16":      dict(),
    "k12":         dict(dense_keys=tuple(range(12))),
    "k10":         dict(dense_keys=tuple(range(10))),
    "k8":          dict(dense_keys=tuple(range(8))),
    "k8+a5":       dict(dense_keys=tuple(range(8)), a_ranks=(1, 2, 3, 4, 5)),
    "k8+a6":       dict(dense_keys=tuple(range(8)), a_ranks=(1, 2, 3, 4, 5, 6)),
    "k8+b3":       dict(dense_keys=tuple(range(8)), b_ranks=(1, 2, 3)),
    "k10samp":     dict(dense_keys=(0, 1, 2, 3, 4, 6, 8, 10, 12, 14)),
    "k10samp+b3":  dict(dense_keys=(0, 1, 2, 3, 4, 6, 8, 10, 12, 14),
                        b_ranks=(1, 2, 3)),
    "k12samp":     dict(dense_keys=(0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 15)),
    "k12samp+a5":  dict(dense_keys=(0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 15),
                        a_ranks=(1, 2, 3, 4, 5)),
    "k12samp+a6":  dict(dense_keys=(0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 15),
                        a_ranks=(1, 2, 3, 4, 5, 6)),
    "k10samp+a6":  dict(dense_keys=(0, 1, 2, 3, 4, 6, 8, 10, 12, 14),
                        a_ranks=(1, 2, 3, 4, 5, 6)),
    "k13samp":     dict(dense_keys=(0, 1, 2, 3, 4, 5, 6, 7, 9, 11, 13, 15)),
    "k14":         dict(dense_keys=tuple(range(14))),
    "k14samp":     dict(dense_keys=(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 13, 15)),
}
if os.environ.get("ENCVAR"):
    CONFIGS = {k: v for k, v in CONFIGS.items()
               if k in os.environ["ENCVAR"].split(",")}


def dense_size(data: bytes, **kw) -> int:
    arr = np.frombuffer(data, np.uint8)
    if arr.size == 0:
        return 1
    blocks, lens = framing.pack_blocks(arr)
    fn = jax.jit(lambda b, l: encode_block_core(b, l, True, **kw))
    comp, totals = fn(blocks, lens)
    t = np.asarray(totals)
    assert (t >= 0).all(), "capacity overflow"
    return len(encode_varint(arr.size)) + int(t.sum())


for cname, kw in CONFIGS.items():
    worst = None
    lines = []
    ok_all = True
    for name, data in sorted(FIX.items()):
        dn = dense_size(data, **kw)
        margin = REF[name] - dn
        ok_all &= margin >= 0
        lines.append((name, margin))
        if worst is None or margin < worst[1]:
            worst = (name, margin)
    tag = "PASS" if ok_all else "FAIL"
    detail = " ".join(f"{n}:{m:+d}" for n, m in lines if m < 200)
    print(f"{tag} {cname:12s} worst {worst[0]}:{worst[1]:+d} | {detail}", flush=True)
