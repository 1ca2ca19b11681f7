"""Per-fixture compressed-size report for both encoder profiles vs the
reference binary's best — the fast inner loop for iterating on encoder
changes without breaking the strict <=-reference contract
(tests/test_reference_compat.py:100-115).  Runs on the CPU mesh."""
import os, subprocess, sys, tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

from conftest import _build_reference_cli  # noqa: E402
from snappytpu import api  # noqa: E402
from snappytpu.bench import corpus  # noqa: E402

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


bad = 0
rows = []
for name, data in sorted(FIX.items()):
    rb = ref_best(data) if exe else -1
    dn = len(api.compress(data, profile="dense"))
    fa = len(api.compress(data, profile="fast"))
    ok = "OK " if (rb < 0 or dn <= rb) else "FAIL"
    bad += ok == "FAIL"
    rows.append((name, len(data), rb, dn, fa, rb - dn, rb - fa))
    print(f"{ok} {name:28s} ref {rb:8d}  dense {dn:8d} ({rb-dn:+6d})  fast {fa:8d} ({rb-fa:+6d})", flush=True)
print("STRICT-CONTRACT:", "PASS" if bad == 0 else f"{bad} FAIL")

# margin table, regenerated on each run so a thinning contract margin
# shows up before the suite fails
out_csv = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "results", "size_margins.csv")
os.makedirs(os.path.dirname(out_csv), exist_ok=True)
with open(out_csv, "w") as f:
    f.write("fixture,input_size,ref_best,dense,fast,dense_margin,fast_margin\n")
    for r in rows:
        f.write(",".join(str(x) for x in r) + "\n")
print(f"wrote {out_csv}")
