"""Device block encoder v2 — sort/scan-native.

The v1 encoder (encode_jax.py) is algorithmically parallel but leans on
unbounded random gathers/scatters.  v2 is built from sorts
(`lax.sort`), cumulative scans and elementwise ops, plus two bounded
gather rounds for run re-gluing and one collision-free scatter that
assembles the output row.  Its stage costs on the GPU are not measured yet.

Pipeline (all per-block, batched over rows, fully inside one jit):

  1. match tiers      two content sorts, both collision-free because the
                      carried key words give EXACT LCP (<= LCP_CAP bytes) by
                      shift-and-compare (the property the reference's BST
                      variant exists for, snappy_compression_tree.c:11-24):
                      tier A (flag, 4-gram; stable pos order) — in-group
                      predecessors are the nearest previous occurrences (the
                      reference hash chain, snappy_compression.c:303-307,
                      resolved perfectly); tier B (flag, sampled 64-byte
                      prefix words) — suffix-array adjacency for long
                      matches; plus exact-reach run tiers at short periodic
                      distances (no sort at all).
  2. sort-back        (spos, len, dist) sorted by position: a permutation
                      inverse done as a sort, not a scatter.
  3. inheritance      a match of length L at s implies a match at every
                      p in (s, s+L) with the same distance; one associative
                      scan over (s + len, dist, s) triples.
  4. election         anchored parse over 4-byte tiles: quantized max-reach
                      with hysteresis, so the winning distance is
                      piecewise-constant (emission density) instead of
                      flipping at every new record reach.  Replaces the v1
                      pointer-doubling greedy walk (17 gather rounds) with
                      two scans.
  5. re-glue          two bounded 2M-element gather rounds adopt a
                      neighbor's distance where this anchor's bytes
                      verifiably match at it — stitches run fragmentation.
  6. emission         same-d anchor runs stretch into adjacent literal slack
                      by the winners' verified lead/tail bytes, split into
                      ops with the reference's 60/64 remainder rule
                      (snappy_compression.c:153-165); every emitted byte
                      becomes a (dest, value) slot, compacted by short-row
                      per-section sorts + one collision-free scatter that
                      concatenates the sections (concat_rows).

Self-overlapping copies (dist < len) are emitted as-is; the decoders
(decode.py) replicate them natively, so no ACEAPEX-style offset
flattening is needed.

Wire format: byte-identical Snappy element stream (SURVEY.md §2 format
contract).  Op starts land at arbitrary byte offsets (lead stretching and
literal-run boundaries are byte-granular) — decoders must not assume any
alignment of op boundaries.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..format import constants as C

BS = C.MAX_BLOCK_SIZE
PAD_OUT = C.MAX_COMPRESSED_BLOCK_SIZE
LCP_CAP = 64          # exact-match cap from the carried sort-key words
KW = LCP_CAP // 4     # carried 4-byte words per position
NEIGHBORS = (1, 2)    # sorted-order predecessor/successor ranks examined
G = 4                 # anchor tile width (== MIN_MATCH_LEN)
NA = BS // G          # anchors per block


def _pos(B, n):
    return jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (B, n))


def _words(blocks_u8: jnp.ndarray) -> jnp.ndarray:
    """Big-endian u32 word starting at every byte (zero-padded tail)."""
    B = blocks_u8.shape[0]
    b = jnp.concatenate(
        [blocks_u8.astype(jnp.uint32), jnp.zeros((B, 3), jnp.uint32)], axis=1
    )
    return (
        (b[:, :BS] << 24)
        | (b[:, 1 : BS + 1] << 16)
        | (b[:, 2 : BS + 2] << 8)
        | b[:, 3 : BS + 3]
    )


def _shift_words(w: jnp.ndarray, k: int) -> jnp.ndarray:
    """w advanced k bytes: word starting at p+k (zero-padded)."""
    B = w.shape[0]
    return jnp.concatenate([w[:, k:], jnp.zeros((B, k), jnp.uint32)], axis=1)


def _word_lcp(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Common-prefix bytes (0..4) of two big-endian u32 words."""
    d = x ^ y
    return jnp.where(
        d == 0,
        4,
        jnp.where(d < (1 << 8), 3, jnp.where(d < (1 << 16), 2, jnp.where(d < (1 << 24), 1, 0))),
    ).astype(jnp.int32)


def _shifted(a, sh, fill):
    B, W = a.shape
    return jnp.concatenate([jnp.full((B, sh), fill, a.dtype), a[:, : W - sh]], axis=1)


def _neighbor_lcp(ks, sh: int):
    """LCP (<= 4*len(ks) bytes) between each sorted slot and the slot `sh`
    earlier, from the carried 4-byte words; pure shift-and-compare."""
    B, W = ks[0].shape
    lcp = jnp.zeros((B, W), jnp.int32)
    alive = jnp.ones((B, W), jnp.bool_)
    for kw in ks:
        wl = _word_lcp(kw, _shifted(kw, sh, 0))
        lcp = lcp + jnp.where(alive, wl, 0)
        alive = alive & (wl == 4)
    return lcp


def _tier_best(spos, ks, pred_ranks, succ_ranks=()):
    """Best (lcp, cand_pos) per sorted slot against the given neighbor ranks.

    Works for any sort order; LCP is exact from the carried words, so
    there are no hash collisions to verify (the property the reference's BST
    variant exists for, snappy_compression_tree.c:11-24).

    Tail positions (pos > n - G, zero-padded carried words) need no flag
    key: they are numerically the LARGEST positions, so `cpos < spos`
    already excludes them as candidates, and as slots their garbage best
    match is clamped below G by `finish` (mlen <= n - pos <= 3)."""
    B, W = spos.shape
    best_len = jnp.zeros((B, W), jnp.int32)
    best_cand = jnp.full((B, W), -1, jnp.int32)

    def consider(cpos, clcp):
        nonlocal best_len, best_cand
        ok = (cpos >= 0) & (cpos < spos) & (clcp >= G)
        better = ok & ((clcp > best_len) | ((clcp == best_len) & (cpos > best_cand)))
        best_len = jnp.where(better, clcp, best_len)
        best_cand = jnp.where(better, cpos, best_cand)

    # one adjacency LCP per shift, shared by the predecessor view and the
    # (shifted) successor view — halves the shift-and-compare volume when a
    # rank appears on both sides
    lcp_by_sh = {sh: _neighbor_lcp(ks, sh) for sh in dict.fromkeys(pred_ranks + tuple(succ_ranks))}
    for sh in pred_ranks:
        consider(_shifted(spos, sh, -1), lcp_by_sh[sh])
    for sh in succ_ranks:
        B_ = spos.shape[0]
        npos = jnp.concatenate([spos[:, sh:], jnp.full((B_, sh), -1, jnp.int32)], axis=1)
        nlcp = jnp.concatenate(
            [lcp_by_sh[sh][:, sh:], jnp.zeros((B_, sh), jnp.int32)], axis=1
        )
        consider(npos, nlcp)
    return best_len, best_cand


_RUN_DISTS = (1, 2, 3, 4, 8)  # short periods probed with exact reach


def _run_tier(blocks_u8: jnp.ndarray, n: jnp.ndarray):
    """Exact-reach matches at short periodic distances.

    The sort tiers cap match length at LCP_CAP, so inside a long run every
    position keeps setting a new capped reach record and the election
    winner churns (fragmenting the run into extra ops).  For dist d, byte q
    continues a period-d copy iff data[q] == data[q-d] — one shift-compare
    — and the EXACT end of the periodic stretch falls out of a reverse
    cummin, so run matches carry their true (uncapped) reach and win the
    whole run in one chain.  Decode-side, dist in {1,2,4} hits the VM's
    single-merge pattern fill."""
    B = blocks_u8.shape[0]
    pos = _pos(B, BS)
    x = blocks_u8.astype(jnp.int32)
    nn = n[:, None]
    tiers = []
    for d in _RUN_DISTS:
        eq = jnp.concatenate(
            [jnp.zeros((B, d), jnp.bool_), x[:, d:] == x[:, : BS - d]], axis=1
        )
        stop = jnp.where(eq, BS + 1, pos)
        run_end = lax.cummin(stop[:, ::-1], axis=1)[:, ::-1]
        mlen = jnp.where(eq, jnp.minimum(run_end, nn) - pos, 0)
        mlen = jnp.where(mlen >= G, mlen, 0)
        tiers.append((mlen, jnp.where(mlen >= G, jnp.int32(d), 0)))
    return tiers


def _find_matches(blocks_u8: jnp.ndarray, n: jnp.ndarray, dense: bool = True,
                  *, a_ranks=None, b_ranks=None, dense_keys=None,
                  a_words: int = 4, pos16: bool = True):
    """Per-position (match_len <= 16, dist >= 1); len 0 where no match.

    Two sort tiers, both collision-free:
      tier A  (flag, w0, pos): inside an exact-4-gram group, sorted
              predecessors ARE the nearest previous occurrences — the
              reference hash chain (snappy_compression.c:303-307) with
              perfect resolution; ranks 1..4 examined.
      tier B  (flag, w0..w3, pos): suffix-array adjacency on the 16-byte
              prefix — long matches whose nearest occurrence is many
              4-gram-group slots away.  (dense profile only)

    The keyword knobs are A/B levers for the profiling tools ONLY; the
    defaults are the tested configuration and the size contracts
    (tests/test_reference_compat.py, test_encode_v2.py) hold for the
    defaults alone.  They are real function arguments (not env reads) so
    every variant traces separately and the production jit cache cannot
    serve a non-default trace.
    """
    B = blocks_u8.shape[0]
    pos = _pos(B, BS)
    w = _words(blocks_u8)
    kws = tuple(_shift_words(w, 4 * j) if j else w for j in range(KW))
    # Tail positions replace a flag KEY (formerly one extra sort key in both
    # tiers): forcing their first key word to the maximum pushes them to the
    # end of the sort exactly as the flag did (within a genuine 0xFFFFFFFF
    # group they append last by stability; matches there come from the run
    # tiers), and candidate exclusion is positional (see _tier_best).
    tail = pos > (n - G)[:, None]
    w0p = jnp.where(tail, jnp.uint32(0xFFFFFFFF), kws[0])

    def finish(blen, bcand, pos_sub):
        mlen = jnp.minimum(blen, jnp.maximum(n[:, None] - pos_sub, 0))
        dist = jnp.where(mlen >= G, pos_sub - bcand, 0)
        return jnp.where(mlen >= G, mlen, 0), dist

    def sort_back(spos, blen, bcand, pos_sub):
        # pack (cand, len) into one payload: len <= LCP_CAP (7 bits)
        packed = (jnp.maximum(bcand, 0) << 7) | jnp.minimum(blen, 127)
        packed = jnp.where(bcand >= 0, packed, -1)
        # positions are 0..65535: a u16 key halves the sort's key traffic
        key = spos.astype(jnp.uint16) if pos16 else spos
        _, mp = lax.sort((key, packed), dimension=1, num_keys=1)
        mlen = jnp.where(mp >= 0, mp & 127, 0)
        mcand = jnp.where(mp >= 0, mp >> 7, -1)
        return finish(mlen, mcand, pos_sub)

    # tier A: 4-gram groups in position order; 16-byte LCP from 4 carried
    # words (nearest occurrences are short-match candidates — the deep-LCP
    # work is tier B's job).  lax.sort is stable, so within a (flag, w0)
    # group slots are already position-ordered — pos rides as an operand,
    # not a key (sort cost scales with the key count).
    # positions ride sorts at half width (u16) by default
    pos_op = pos.astype(jnp.uint16) if pos16 else pos
    sortedA = lax.sort((w0p, pos_op) + kws[1:a_words], dimension=1, num_keys=1)
    apos = sortedA[1].astype(jnp.int32)
    aks = (sortedA[0],) + sortedA[2:]
    # fast has no byte-resolution deep tier, so it examines two extra
    # in-group predecessor ranks — that is what keeps its corpus-aggregate
    # ratio >= the reference hash compressor's (the fast-profile contract,
    # tests/test_encode_v2.py::test_fast_profile_ratio_contract)
    if a_ranks is None:
        a_ranks = (1, 2, 3, 4) if dense else (1, 2, 3, 4, 5, 6)
    lenA, candA = _tier_best(apos, aks, pred_ranks=tuple(a_ranks))
    tiers = [sort_back(apos, lenA, candA, pos)]

    # tier B: deep suffix adjacency from SAMPLED key words — the sort
    # orders by bytes [0:8), [16:20), [32:36), [48:52), [60:64) of each
    # suffix (ties position-ordered by stability), approximating the
    # 64-byte suffix order at 7-key cost instead of 17.  Key DEPTH
    # matters on repetitive data: an 8-byte-key variant loses the
    # cross-run far matches that cover run transitions (~6% worse on
    # low-entropy runs); sampling keeps that reach because long-run
    # prefixes already differ in the sampled words.  Candidate LCP
    # stays exact to LCP_CAP bytes via all carried words.
    #
    # dense: byte resolution and FULL key depth (the strict <=-reference
    # size contract needs both — sampled keys or stride 2 each measured a
    # few dozen bytes worse on one fixture).  fast: sampled keys at
    # STRIDE 4 — long matches starting off-stride are found <=3 bytes
    # later with their lead restored by the same-distance chain, at ~1/5
    # the sort volume.
    stride = 1 if dense else 4
    sub = (lambda x: x) if stride == 1 else (lambda x: x[:, ::stride])
    dense_ids = tuple(dense_keys) if dense_keys is not None else tuple(range(KW))
    key_ids = dense_ids if dense else (0, 1, 4, 8, 12, 15)
    rest_ids = tuple(j for j in range(KW) if j not in key_ids)
    kw_eff = (w0p,) + kws[1:]
    sortedB = lax.sort(
        tuple(sub(kw_eff[j]) for j in key_ids)
        + (sub(pos_op),)
        + tuple(sub(kws[j]) for j in rest_ids),
        dimension=1,
        num_keys=len(key_ids),
    )
    bpos = sortedB[len(key_ids)].astype(jnp.int32)
    # reassemble carried words in kws order for the exact-LCP compare
    by_id = dict(zip(key_ids, sortedB[: len(key_ids)]))
    rest_it = iter(sortedB[1 + len(key_ids) :])
    bks = tuple(
        by_id[j] if j in key_ids else next(rest_it) for j in range(KW)
    )
    if b_ranks is None:
        b_ranks = NEIGHBORS
    b_ranks = tuple(b_ranks)
    lenB, candB = _tier_best(
        bpos, bks, pred_ranks=b_ranks, succ_ranks=b_ranks
    )
    mlenB, distB = sort_back(bpos, lenB, candB, sub(pos))
    if stride > 1:
        # interleave back to byte resolution (off-stride: no tier-B match)
        z = jnp.zeros((B, BS // stride, stride - 1), jnp.int32)
        expand = lambda x: jnp.concatenate(
            [x[:, :, None], z], axis=2
        ).reshape(B, BS)
        mlenB, distB = expand(mlenB), expand(distB)
    tiers.append((mlenB, distB))

    tiers.extend(_run_tier(blocks_u8, n))
    return tiers


def _prefix_winner(key, payloads):
    """Prefix-argmax over each row with payload recovery, built ONLY from
    native cummax scans (associative tuple scans are far slower).

    key must encode the full preference order numerically (pack tie-breaks
    into low bits); invalid positions use key -1.  The prefix winner at p is
    the latest RECORD position <= p (a record strictly improves on every
    earlier key), so each payload is recovered by monotone packed fills from
    the record positions: (pos << bits) | value rides a cummax.  Positions
    use 17 bits, so payloads wider than 14 bits are split into a low-14 and
    a high fill to stay inside int32.

    payloads: list of (values, bits) with 0 <= values < 2**bits, bits <= 17.
    Returns (prefix_max_key, winner_pos (-1 where no winner), [values], rec).
    """
    B, N = key.shape
    m = lax.cummax(key, axis=1)
    prev_m = jnp.concatenate(
        [jnp.full((B, 1), jnp.iinfo(jnp.int32).min, jnp.int32), m[:, : N - 1]], axis=1
    )
    rec = key > prev_m
    pos = _pos(B, N)
    wpos = lax.cummax(jnp.where(rec, pos, -1), axis=1)

    def fill(val, bits):
        f = lax.cummax(jnp.where(rec, (pos << bits) | val, -1), axis=1)
        return jnp.where(f >= 0, f & ((1 << bits) - 1), 0)

    vals = []
    for pval, bits in payloads:
        if bits <= 14:
            vals.append(fill(pval, bits))
        else:
            lo = fill(pval & 0x3FFF, 14)
            hi = fill(pval >> 14, bits - 14)
            vals.append((hi << 14) | lo)
    return m, wpos, vals, rec


def _chain_start(rec, dist, f_dist, f_reach):
    """Start position of the winner's same-distance RECORD CHAIN.

    Long matches are LCP-capped, so inside a repeat region every position
    sets a new reach record and the prefix winner is always the latest one —
    its own start, losing the lead slack at run heads.  Records with the
    same distance whose start lies within the previous record's reach cover
    one contiguous region at that distance; the chain's first record is the
    verified start of that region, restoring lead stretching."""
    B, N = rec.shape
    pos = _pos(B, N)
    pd = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), f_dist[:, : N - 1]], axis=1)
    pr = jnp.concatenate([jnp.full((B, 1), -1, jnp.int32), f_reach[:, : N - 1]], axis=1)
    brk = rec & ((dist != pd) | (pos > pr))
    return lax.cummax(jnp.where(brk, pos, -1), axis=1)


def _best_tier(tiers):
    """Merge per-position tier results: longest match, then smallest dist."""
    mlen, dist = tiers[0]
    for ml, dd in tiers[1:]:
        better = (ml > mlen) | ((ml == mlen) & (dd < dist))
        mlen = jnp.where(better, ml, mlen)
        dist = jnp.where(better, dd, dist)
    return mlen, dist


def _inherit(tiers, n: jnp.ndarray):
    """Per-ANCHOR inherited match (reach, dist, start): a match of length L
    at s implies a match at every p in (s, s+L) with the same distance.

    The winner at anchor a=4k is the max-reach match over starts s <= 4k
    (first achiever on ties), computed with native cummax scans and sampled
    at the anchors."""
    mlen, dist = _best_tier(tiers)
    B = mlen.shape[0]
    pos = _pos(B, BS)
    reach = jnp.where(mlen >= G, pos + mlen, -1)
    m, wpos, (d,), rec = _prefix_winner(reach, [(dist, 17)])
    sc = _chain_start(rec, dist, d, m)
    return m[:, ::G], d[:, ::G], sc[:, ::G]


def _prop_pack(val, start, bits, idx=None):
    """Segmented forward fill via ONE native cummax: start positions are
    strictly ascending, so (index << bits) | val is monotone per segment
    order and a plain cumulative max propagates the latest start's value.
    Requires val in [0, 2^bits) and index < 2^(31-bits)."""
    B = val.shape[0]
    if idx is None:
        idx = _pos(B, val.shape[1])
    packed = jnp.where(start, (idx << bits) | val, -1)
    return lax.cummax(packed, axis=1)


def _prop_val(packed, bits):
    return jnp.where(packed >= 0, packed & ((1 << bits) - 1), 0)


def _seg_propagate(val, start):
    """Segmented forward fill: value at the latest start, per row."""
    return lax.associative_scan(
        lambda x, y: (jnp.where(y[1], y[0], x[0]), y[1] | x[1]),
        (val, start),
        axis=1,
    )[0]


_HYST_Q = 16  # reach quantum: winners switch only across 16-byte bands


def _elect(tiers, inh, n):
    """Anchor parse: quantized max-reach election with hysteresis.

    A pure max-reach parse fragments: in plain text a new record reach
    appears at almost every position, so the winning match — and its
    distance — flips anchor to anchor and copies degenerate to 4-byte tiles.
    Emission density needs PIECEWISE-CONSTANT distance, so the election key
    is (reach // 16, earliest start): a winner keeps its run until another
    match crosses a 16-byte reach band, giving ~16-byte same-distance runs.
    The exact max-reach scan (inh) backstops coverage where the quantized
    winner's true reach has already run out.

    Returns per-anchor (is_copy, d, lead_avail, tail_avail): how many bytes
    before/after the anchor tile the winning match is KNOWN to also cover —
    emission stretches runs into those slacks at byte granularity."""
    B = tiers[0][0].shape[0]
    pos = _pos(B, BS)

    mlen, dist = _best_tier(tiers)
    has = mlen >= G
    reach = jnp.where(has, pos + mlen, -1)
    # preference: highest 16-byte reach band, then earliest start — packed
    # into one key so the native-cummax record scan reproduces the order
    rq = reach // _HYST_Q
    key = jnp.where(has, (rq << 17) | (BS - pos), -1)
    # the lead start comes from the same-distance record chain, not the
    # (latest) winner itself
    _, s1, (d1, r1v), rec = _prefix_winner(key, [(dist, 17), (jnp.maximum(reach, 0), 17)])
    r1 = jnp.where(s1 >= 0, r1v, -1)
    sc1 = _chain_start(rec, dist, d1, r1)
    s1a, d1a, r1a = sc1[:, ::G], d1[:, ::G], r1[:, ::G]
    r2a, d2a, s2a = inh

    a_pos = _pos(B, NA) * G
    n_ok = (a_pos + G) <= n[:, None]
    use1 = (r1a >= a_pos + G) & (d1a >= 1) & (d1a <= a_pos)
    use2 = (r2a >= a_pos + G) & (d2a >= 1) & (d2a <= a_pos)
    is_copy = n_ok & (use1 | use2)
    ad = jnp.where(use1, d1a, jnp.where(use2, d2a, 0))
    sel_r = jnp.where(use1, r1a, r2a)
    sel_s = jnp.where(use1, s1a, s2a)
    lead = jnp.where(is_copy, jnp.maximum(a_pos - sel_s, 0), 0)
    tail = jnp.where(is_copy, jnp.maximum(sel_r - (a_pos + G), 0), 0)
    return is_copy, jnp.where(is_copy, ad, 0), lead, tail


def _reglue(blocks_u8, is_copy, ad, lead, tail, n):
    """Two bounded gather rounds: adopt a neighbor's distance where this
    anchor's 4 bytes verifiably also match at it (left-neighbor round
    extends runs rightward, right-neighbor round leftward).  Stitches the
    vote-boundary disagreements that fragment runs.  Glued anchors carry
    no lead/tail slack (only their own 4 bytes are verified at the
    adopted distance).  Dropping the second round costs +3.6% compressed
    size (text +7%), far beyond the contract margins.
    """
    B = is_copy.shape[0]
    a_pos = _pos(B, NA) * G
    w = _words(blocks_u8)
    w_a = w[:, ::G]
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]

    for direction in ("left", "right"):
        left_d = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), ad[:, : NA - 1]], axis=1)
        right_d = jnp.concatenate([ad[:, 1:], jnp.zeros((B, 1), jnp.int32)], axis=1)
        if direction == "left":
            nb_d, other = left_d, right_d
        else:
            nb_d, other = right_d, left_d
        # only anchors that do not already continue a run on the other side
        # may switch (adopting would otherwise split an existing run)
        loose = ~is_copy | (ad != other)
        cand_ok = (
            loose & (nb_d >= 1) & (nb_d <= a_pos) & ((a_pos + G) <= n[:, None]) & (nb_d != ad)
        )
        src = jnp.where(cand_ok, a_pos - nb_d, 0)
        glue = cand_ok & (w[rows, src] == w_a)
        is_copy = is_copy | glue
        ad = jnp.where(glue, nb_d, ad)
        lead = jnp.where(glue, 0, lead)
        tail = jnp.where(glue, 0, tail)
    return is_copy, ad, lead, tail


# Emission sections per block (shorter compaction-sort rows are cheaper
# until the concat of many sections costs more; not tuned on the GPU).
# Wire bytes are nsec-INVARIANT (section dests are disjoint contiguous
# ranges, so per-section sorts + concat equal one global sort; verified
# byte-identical across 32/64 on mixed/runs/text, both profiles).
_NSEC = 64


def _section_capacity(sp: int) -> int:
    """Per-section slot capacity: worst-case emitted bytes attributable to
    one section's sp positions, padded to a multiple of 512 bytes.

    The sustained emission density is bounded by ~1.015 bytes/position:
    covered intervals always contain a full 4-aligned anchor tile, so
    ops cover >= 4 positions for <= 3 op bytes (0.75); literal runs of L
    bytes cost L + hdr, maximized per position at the 2-byte header's
    lower edge — and the 4-aligned gap geometry makes L = 64 the densest
    reachable run (66/64).  The tightest alternation, [4-byte COPY2]
    [64-byte literal], costs (3 + 66) bytes per 68 positions = 1.0147
    (exercised by tests/test_encode_v2.py::
    test_emission_max_density_and_capacity_guard).  The sp // 4 + 128
    headroom over 1.0 * sp covers that excess plus section-boundary
    partial ops/headers with >5x margin.  _emit enforces the bound at
    runtime: a section exceeding it poisons the block's reported total
    (negative), the device-side analog of decode's ok bit — silent slot
    dropping is impossible (worst-case expansion discipline of
    snappy_compression.c:190)."""
    return ((sp + sp // 4 + 128 + 511) // 512) * 512


def _emit(blocks_u8, is_copy, ad, lead, tail, n, nsec=None, seccap=None):
    """Byte-granular interval emission + sectioned compaction.

    Anchor runs (same-d consecutive copy tiles) are stretched into the
    adjacent literal slack by the election winners' verified lead/tail
    bytes, then split into Snappy ops with the reference's 60/64 rule for
    awkward remainders (snappy_compression.c:153-165).  Every emitted byte
    becomes a (dest, value) slot; short-row per-section sorts compact the
    slots and one collision-free scatter (concat_rows)
    assembles the final row."""
    nsec = _NSEC if nsec is None else nsec
    sp = BS // nsec
    # seccap is overridable ONLY so tests can prove the overflow guard
    # fires (tests/test_encode_v2.py); production always uses the bound
    seccap = _section_capacity(sp) if seccap is None else seccap
    B = blocks_u8.shape[0]
    pos = _pos(B, BS)
    a_pos = _pos(B, NA) * G

    # ---- run geometry over anchors ----
    prev_is = jnp.concatenate([jnp.zeros((B, 1), jnp.bool_), is_copy[:, : NA - 1]], axis=1)
    prev_d = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), ad[:, : NA - 1]], axis=1)
    run_start = is_copy & ~(prev_is & (prev_d == ad))
    nxt_is = jnp.concatenate([is_copy[:, 1:], jnp.zeros((B, 1), jnp.bool_)], axis=1)
    nxt_d = jnp.concatenate([ad[:, 1:], jnp.zeros((B, 1), jnp.int32)], axis=1)
    run_end = is_copy & ~(nxt_is & (nxt_d == ad))

    # All forward fills below ride native cummax: scatter targets are
    # position-ordered, so (index << bits) | value is monotone and one
    # cumulative max propagates each latest mark (_prop_pack) — no
    # associative tuple scans on the hot 64k arrays.
    rev = lambda x: x[:, ::-1]

    # ---- stretch: tails first (into the following literal gap) ----
    next_start_p = rev(_prop_pack(rev(jnp.where(run_start, a_pos, 0)), rev(run_start), 17))
    nxt_exists = jnp.concatenate(
        [next_start_p[:, 1:] >= 0, jnp.zeros((B, 1), jnp.bool_)], axis=1
    )
    next_start_at_end = jnp.where(
        nxt_exists,
        jnp.concatenate([_prop_val(next_start_p, 17)[:, 1:], jnp.zeros((B, 1), jnp.int32)], axis=1),
        n[:, None],
    )
    gap_next = jnp.maximum(jnp.minimum(next_start_at_end, n[:, None]) - (a_pos + G), 0)
    tail_fin = jnp.where(run_end, jnp.minimum(tail, gap_next), 0)

    # ---- leads second (into what the previous tail left over) ----
    pc_p = _prop_pack(jnp.where(run_end, a_pos + G + tail_fin, 0), run_end, 17)
    pc_p = jnp.concatenate([jnp.full((B, 1), -1, jnp.int32), pc_p[:, : NA - 1]], axis=1)
    prev_cover = _prop_val(pc_p, 17)
    lead_fin = jnp.where(run_start, jnp.minimum(lead, a_pos - prev_cover), 0)

    # ---- byte-level run intervals from ANCHOR-level fills (no scatters) ----
    # A byte p in anchor tile k is covered either by the latest run starting
    # at an anchor <= k (its tail may extend past its anchors) or by the
    # first run starting at an anchor > k (its lead may reach back into this
    # tile).  The two never overlap: lead stretching is capped at the
    # previous run's covered end.  Both "latest <=" and "first >" fields
    # ride anchor-resolution packed cummax fills and a free x4 broadcast —
    # instead of byte-level scatter fills.
    ivs = jnp.where(run_start, a_pos - lead_fin, 0)               # interval start byte
    # interval end: tail of THIS run — propagate run_end info back to start
    ive_p = rev(_prop_pack(rev(jnp.where(run_end, a_pos + G + tail_fin, 0)), rev(run_end), 17))
    ive = _prop_val(ive_p, 17)                                    # per anchor: end of its run

    def afwd(val):
        return _prop_pack(val, run_start, 17)

    def arev(val):
        p = rev(_prop_pack(rev(val), rev(run_start), 17))
        return jnp.concatenate([p[:, 1:], jnp.full((B, 1), -1, jnp.int32)], axis=1)

    def expand(x):
        return jnp.broadcast_to(x[:, :, None], (B, NA, G)).reshape(B, BS)

    p_s, p_e, p_d = afwd(ivs), afwd(ive), afwd(ad)
    n_s, n_e, n_d = arev(ivs), arev(ive), arev(ad)
    sP, hasP = expand(_prop_val(p_s, 17)), expand(p_s >= 0)
    eP, dP = expand(_prop_val(p_e, 17)), expand(_prop_val(p_d, 17))
    sN, hasN = expand(_prop_val(n_s, 17)), expand(n_s >= 0)
    eN, dN = expand(_prop_val(n_e, 17)), expand(_prop_val(n_d, 17))

    cov_next = hasN & (pos >= sN)
    cov_prev = hasP & (pos >= sP) & (pos < eP)
    covered = cov_next | cov_prev
    s_b = jnp.where(cov_next, sN, jnp.where(cov_prev, sP, -1))
    e_b = jnp.where(cov_next, eN, eP)
    d_b = jnp.where(covered, jnp.where(cov_next, dN, dP), 0)

    # ---- op chunking (64s, with the 60-split for remainders 65..67) ----
    q = pos - s_b
    remq = e_b - pos
    on64 = (q % C.MAX_COPY_LEN) == 0
    on60 = (q % C.MAX_COPY_LEN) == 60
    # on64 boundaries with remq<4 are interior to a 60-split chunk; on60
    # boundaries exist only when the preceding on64 chunk was a 60-split
    # (its remainder was 65..67, leaving 5..7 here)
    op_start = covered & (
        (on64 & (remq >= 4)) | (on60 & (remq >= 5) & (remq <= 7))
    )
    op_len = jnp.where(
        remq <= C.MAX_COPY_LEN, remq, jnp.where(remq <= 67, 60, C.MAX_COPY_LEN)
    )
    op_len = jnp.where(op_start, op_len, 0)
    two = op_start & (op_len <= C.COPY1_MAX_LEN) & (d_b < C.COPY1_MAX_OFFSET)
    opb = jnp.where(op_start, jnp.where(two, 2, 3), 0)

    # ---- literal geometry ----
    lit = (~covered) & (pos < n[:, None])
    lit_prev = jnp.concatenate([jnp.zeros((B, 1), jnp.bool_), lit[:, : BS - 1]], axis=1)
    lstart = lit & ~lit_prev
    lit_next = jnp.concatenate([lit[:, 1:], jnp.zeros((B, 1), jnp.bool_)], axis=1)
    lend = lit & ~lit_next
    ls = lax.cummax(jnp.where(lstart, pos, -1), axis=1)
    le = lax.cummin(jnp.where(lend, pos, BS + 1)[:, ::-1], axis=1)[:, ::-1]
    rlen = jnp.where(lit, le - ls + 1, 0)
    hdr = jnp.where(
        rlen > 0,
        1 + (rlen > C.LITERAL_MAX_INLINE_LEN).astype(jnp.int32) + (rlen > 256),
        0,
    )

    # ---- per-byte emitted size -> offsets ----
    size = opb + jnp.where(lit, 1, 0) + jnp.where(lstart, hdr, 0)
    off = lax.cumsum(size, axis=1) - size
    total = jnp.sum(size, axis=1).astype(jnp.int32)

    # ---- slots: TWO wire bytes per int32 (r5 slot packing) ----
    d_lo, d_hi = d_b & 0xFF, d_b >> 8
    b0 = jnp.where(
        two,
        (d_hi << 5) | ((op_len - 4) << 2) | C.TAG_COPY1,
        ((op_len - 1) << 2) | C.TAG_COPY2,
    )
    m = rlen - 1
    h0 = jnp.where(
        hdr == 1,
        m << 2,
        jnp.where(hdr == 2, C.LITERAL_CODE_1BYTE << 2, C.LITERAL_CODE_2BYTE << 2),
    )

    # Each emitting position owns `size` consecutive dest bytes; its byte
    # values in order are e0..e3 (op: tag/d_lo/d_hi; literal start: header
    # then the data byte; plain literal: the data byte):
    bu = blocks_u8.astype(jnp.int32)
    e0 = jnp.where(op_start, b0, jnp.where(lstart, h0, bu))
    e1 = jnp.where(op_start, d_lo, jnp.where(hdr >= 2, m & 0xFF, bu))
    e2 = jnp.where(op_start, d_hi, jnp.where(hdr == 3, m >> 8, bu))
    e3 = bu  # reached only for hdr-3 literal starts (size 4)

    # Slots carry a PAIR of dest bytes: key = (pair_index << 16) | hi | lo,
    # where pair_index is relative to the SECTION's first dest (cumulative
    # sizes are contiguous, so the byte after this position's last is
    # exactly the NEXT emitter's first byte — a reverse fill, no gather).
    # Halving the slot count cuts the compaction-sort volume from the old
    # 3*sp+128 lanes to 2*sp per section (~36% less sorted data) and the
    # wire bytes are IDENTICAL: same dests, same values, different packing.
    sec_base = jnp.broadcast_to(
        off.reshape(B, nsec, sp)[:, :, :1], (B, nsec, sp)
    ).reshape(B, BS)
    rel = off - sec_base
    emit = size > 0
    nxt_p = rev(_prop_pack(rev(e0 & 0xFF), rev(emit), 8))
    nf = jnp.concatenate(
        [_prop_val(nxt_p, 8)[:, 1:], jnp.zeros((B, 1), jnp.int32)], axis=1
    )
    q = rel & 1  # dest parity of this position's first byte within the pair
    INFK = jnp.int32(1) << 30

    def lane(j_even, ev, od):
        """Slot for the pair whose even byte is this position's byte j_even."""
        active = emit & (size > j_even)
        P = (rel + j_even) >> 1
        return jnp.where(active, (P << 16) | ((ev & 0xFF) << 8) | (od & 0xFF), INFK)

    # lane 0: first even-dest byte (j = q); its odd partner is the next own
    # byte or, past the end, the next emitter's first byte (nf)
    v0 = lane(
        q,
        jnp.where(q == 0, e0, e1),
        jnp.where(q == 0, jnp.where(size > 1, e1, nf), jnp.where(size > 2, e2, nf)),
    )
    # lane 1: second even-dest byte (j = q + 2); only size-3/4 emitters
    v1 = lane(
        q + 2,
        jnp.where(q == 0, e2, e3),
        jnp.where((q == 0) & (size > 3), e3, nf),
    )

    # Section compaction: slot dests are globally monotone in source
    # position, so the nsec sections own disjoint, ordered dest ranges.
    # Each section's 2*sp slots compact with an independent short-row sort
    # (cheaper per element than a full-width sort) and the variable-length
    # section heads are assembled by one collision-free scatter
    # (concat_rows) — no second sort.
    slots = jnp.stack(
        [v0.reshape(B, nsec, sp), v1.reshape(B, nsec, sp)], axis=3
    ).reshape(B * nsec, 2 * sp)
    (ss,) = lax.sort((slots,), dimension=1, num_keys=1)
    # valid pair indices are 0..ceil(sec_cnt/2)-1 contiguous (one slot per
    # pair), so sorted rank == pair index.  Two consecutive pair slots make
    # one little-endian output word, built with shifts on the 2D sorted
    # array, which concat_rows takes as it is.
    paircap = (seccap + 1) // 2 + ((seccap + 1) // 2 & 1)  # even # of pairs
    sp2 = ss[:, :paircap]
    e, o = sp2[:, 0::2], sp2[:, 1::2]
    sec_words = (
        ((e >> 8) & 0xFF) | ((e & 0xFF) << 8)
        | ((o & 0xFF00) << 8) | ((o & 0xFF) << 24)
    )
    sec_cnt = jnp.sum(size.reshape(B, nsec, sp), axis=2, dtype=jnp.int32)
    # capacity guard: a section needing more than seccap bytes would have
    # its tail slots truncated by the ss[:, :seccap] take above — flag the
    # block by poisoning its total (callers treat total < 0 as an encode
    # error, the encode-side ok bit).  The bound is derived in
    # _section_capacity and cannot be hit by legal emission geometry.
    overflow = jnp.any(sec_cnt > seccap, axis=1)
    total = jnp.where(overflow, jnp.int32(-1), total)
    out = concat_rows(
        sec_words.reshape(B, nsec, sec_words.shape[1]),
        jnp.minimum(sec_cnt, seccap), PAD_OUT,
    )
    return out, total


def concat_rows(words: jnp.ndarray, lens: jnp.ndarray, out_cap: int) -> jnp.ndarray:
    """(B, S, W) int32 little-endian words + (B, S) int32 byte lens ->
    (B, out_cap) uint8, where row b is the first lens[b, s] bytes of each of
    its S pieces in order, zero-padded.  Requires lens[b, s] <= 4 W and
    sum(lens[b]) <= out_cap.

    One scatter: byte j of piece s goes to the piece's start (a cumsum of
    the lengths) plus j.  Bytes past a piece's length get distinct targets
    past the row and are dropped, so every target is unique and the
    scatter needs no atomics."""
    B, S, W = words.shape
    cap = 4 * W
    src = lax.bitcast_convert_type(words, jnp.uint8).reshape(B, S * cap)
    lens = jnp.asarray(lens, jnp.int32)
    starts = jnp.cumsum(lens, axis=1) - lens
    j = jnp.arange(cap, dtype=jnp.int32)
    past = out_cap + jnp.arange(S * cap, dtype=jnp.int32).reshape(S, cap)
    dest = jnp.where(j < lens[:, :, None], starts[:, :, None] + j, past)
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    return jnp.zeros((B, out_cap), jnp.uint8).at[rows, dest.reshape(B, S * cap)].set(
        src, mode="drop", unique_indices=True)


def encode_block_core(blocks_u8: jnp.ndarray, n: jnp.ndarray, dense: bool = True,
                      *, nsec=None, **match_kw):
    tiers = _find_matches(blocks_u8, n, dense=dense, **match_kw)
    inh = _inherit(tiers, n)
    is_copy, ad, lead, tail = _elect(tiers, inh, n)
    is_copy, ad, lead, tail = _reglue(blocks_u8, is_copy, ad, lead, tail, n)
    return _emit(blocks_u8, is_copy, ad, lead, tail, n, nsec=nsec)


@functools.partial(jax.jit, static_argnames=("dense",))
def encode_blocks_v2(blocks_u8: jnp.ndarray, lens: jnp.ndarray, dense: bool = True):
    """Batched block encode: (B, BS) uint8 + (B,) int32 ->
    ((B, PAD_OUT) uint8, (B,) int32).  Drop-in contract match for
    encode_jax.encode_blocks; dense=False skips the 16-byte tier (the
    fast-profile analog of the reference's plain hash compressor)."""
    return encode_block_core(jnp.asarray(blocks_u8), jnp.asarray(lens, jnp.int32), dense)
