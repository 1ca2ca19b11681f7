"""Contract-margin visibility.

The dense profile's strict <=-reference size contract
(test_reference_compat.py:93-107) is pass/fail per fixture; this test
computes the per-fixture margin over the SAME fixture set in one pass and
fails with the two thinnest margins in the message, so a change that spends
the ~13-byte two_blocks_mixed margin is diagnosed — not just detected.
tools/enc_sizes.py writes the same table to results/size_margins.csv.
"""

from snappytpu import api

from test_reference_compat import FIXTURES, REAL_FILES, _ref_compress_size


def test_dense_margins_nonnegative_and_visible(reference_cli):
    margins = []
    for name, data in sorted({**FIXTURES, **REAL_FILES}.items()):
        ref = _ref_compress_size(reference_cli, data)
        dense = len(api.compress(data, profile="dense"))
        margins.append((ref - dense, name, ref, dense))
    margins.sort()
    thinnest = ", ".join(f"{n}: {m:+d} B (ref {r}, dense {d})"
                         for m, n, r, d in margins[:2])
    assert margins[0][0] >= 0, f"dense margin went negative — thinnest: {thinnest}"
    # always-visible record of where the contract is closest to breaking
    print(f"\n[margins] thinnest two: {thinnest}")
