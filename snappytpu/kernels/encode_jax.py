"""Device block encoder — vectorized JAX, the data-parallel LZ77 pipeline.

Bit-for-bit the same algorithm as the numpy model (snappytpu/model/encode.py);
every phase is data-parallel over positions so the whole block compiles to
vector ops on the VPU plus `lax.sort` and gathers/scatters — no sequential
per-byte loop anywhere (the reference's hot loop, snappy_compression.c:384-403,
is replaced wholesale):

  candidates   5 gram tiers, each a (hash, position) `lax.sort` whose sorted
               predecessors are the nearest previous occurrences
  best match   exact LCP against every candidate via stride-4 word compares
               (17 gathers), tie-broken toward the smallest offset
  greedy parse pointer doubling: jump table J[p] = p + step(p), 17 rounds of
               J = J[J] with a scatter-or reachability mask — the greedy walk
               of a 64 KiB block in O(log n) vector steps
  refinement   4 rounds of cost-aware copy dropping with realized literal-gap
               contexts from cummax/cummin sweeps
  emission     per-op byte sizes -> exclusive prefix sum -> scattered tag,
               header, and payload bytes

Static shapes throughout: blocks are zero-padded to MAX_BLOCK_SIZE with a
per-block valid length `n`; outputs are MAX_COMPRESSED_BLOCK_SIZE buffers plus
a true-length scalar.  Batch with vmap; shard batches with shard_map (see
snappytpu/mesh/).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..format import constants as C

BS = C.MAX_BLOCK_SIZE
PAD_OUT = C.MAX_COMPRESSED_BLOCK_SIZE
_DOUBLING_ROUNDS = 17  # 2^17 > BS: covers the longest possible path
_LCP_WORDS = C.MAX_COPY_LEN // 4 + 1  # 17 stride-4 compares cover 64+3 bytes

_MIX1 = jnp.uint32(0x9E3779B1)
_MIX2 = jnp.uint32(0x85EBCA77)

GRAM_TIERS = ((4, 2), (8, 1), (16, 1), (32, 1), (64, 1))


def _word32(block_u32: jnp.ndarray) -> jnp.ndarray:
    """Big-endian 4-byte word at every position (zero-padded tail)."""
    z = jnp.zeros(3, dtype=jnp.uint32)
    b = jnp.concatenate([block_u32, z])
    return (b[:BS] << 24) | (b[1 : BS + 1] << 16) | (b[2 : BS + 2] << 8) | b[3 : BS + 3]


def _gram_hashes(words: jnp.ndarray, gram_len: int) -> jnp.ndarray:
    """Hierarchical uint32 gram hash; identical to model.encode.gram_hashes."""
    h = words
    g = 4
    while g < gram_len:
        shifted = jnp.concatenate([h[g:], jnp.zeros(g, dtype=jnp.uint32)])
        h = (h * _MIX1) ^ ((shifted * _MIX2) >> jnp.uint32(3)) ^ (shifted << jnp.uint32(13))
        g *= 2
    return h


def _tier_candidates(words: jnp.ndarray, n: jnp.ndarray, hashes=None):
    """All candidate position arrays (list of (BS,) int32, -1 = none)."""
    pos = lax.broadcasted_iota(jnp.int32, (BS, 1), 0).reshape(BS)
    cands = []
    for gram_len, n_pred in GRAM_TIERS:
        h = hashes[gram_len] if hashes else _gram_hashes(words, gram_len)
        valid = pos <= n - gram_len
        flag = jnp.where(valid, jnp.uint32(0), jnp.uint32(1))
        sflag, sh, spos = lax.sort((flag, h, pos), num_keys=3)
        same1 = jnp.concatenate(
            [jnp.array([False]), (sh[1:] == sh[:-1]) & (sflag[1:] == 0) & (sflag[:-1] == 0)]
        )
        run_same = same1
        for k in range(n_pred):
            prev_pos = jnp.concatenate(
                [jnp.full(k + 1, -1, dtype=jnp.int32), spos[: BS - k - 1]]
            )
            pred = jnp.where(run_same, prev_pos, -1)
            cand = jnp.zeros(BS, dtype=jnp.int32).at[spos].set(pred)
            cands.append(cand)
            if k + 1 < n_pred:
                shifted = jnp.concatenate([jnp.array([False]), same1[: BS - 1]])
                run_same = run_same & shifted
    return cands


def _lcp(words: jnp.ndarray, cand: jnp.ndarray, pos: jnp.ndarray, n: jnp.ndarray):
    """Exact common-prefix length vs candidate, capped at MAX_COPY_LEN and the
    block end.  Stride-4 big-endian word compares + byte refinement.

    The word loop is a fori_loop on purpose: loop-carried rounds compile to
    separate gather kernels instead of one fusion of unrolled chains of
    data-dependent gathers."""
    valid = cand >= 0
    c = jnp.maximum(cand, 0)

    def body(j, st):
        nfull, alive, extra = st
        a = words[jnp.clip(pos + 4 * j, 0, BS - 1)]
        b = words[jnp.clip(c + 4 * j, 0, BS - 1)]
        x = a ^ b
        eq = x == 0
        # byte-level tail at the first mismatching word (big-endian layout)
        e = jnp.where(
            x < (1 << 8), 3, jnp.where(x < (1 << 16), 2, jnp.where(x < (1 << 24), 1, 0))
        ).astype(jnp.int32)
        first_mismatch = alive & ~eq
        extra = jnp.where(first_mismatch, e, extra)
        alive = alive & eq
        nfull = nfull + alive
        return nfull, alive, extra

    # carries seeded from `c` (not fresh constants) so they share its varying
    # manifest under shard_map's check_vma — see shard_map.html#scan-vma
    nfull, alive, extra = lax.fori_loop(0, _LCP_WORDS, body, (c * 0, valid, c * 0))
    lcp = 4 * nfull + jnp.where(alive, 0, extra)
    cap = jnp.minimum(C.MAX_COPY_LEN, n - pos)
    return jnp.where(valid, jnp.minimum(lcp, jnp.maximum(cap, 0)), 0)


def _best_match(block_u32: jnp.ndarray, n: jnp.ndarray):
    """Per-position (best_len, best_dist).

    Two-stage selection, identical to model.encode.best_match: every candidate
    scored by hash-quantized LCP estimate (largest matching gram tier, ties to
    the smallest distance), then one exact LCP on the winner."""
    words = _word32(block_u32)
    hashes = {g: _gram_hashes(words, g) for g, _ in GRAM_TIERS}
    pos = lax.broadcasted_iota(jnp.int32, (BS, 1), 0).reshape(BS)
    best_est = jnp.full(BS, -1, dtype=jnp.int32)
    best_cand = jnp.full(BS, -1, dtype=jnp.int32)
    best_dist = jnp.zeros(BS, dtype=jnp.int32)
    for cand in _tier_candidates(words, n, hashes):
        valid = cand >= 0
        c = jnp.maximum(cand, 0)
        est = jnp.zeros(BS, dtype=jnp.int32)
        for g, _ in GRAM_TIERS:
            h = hashes[g]
            lim = n - g
            ok = (h[c] == h) & (pos <= lim) & (c <= lim)
            est = jnp.where(ok, g, est)
        est = jnp.where(valid, est, -1)
        dist = pos - cand
        better = valid & ((est > best_est) | ((est == best_est) & (dist < best_dist)))
        best_est = jnp.where(better, est, best_est)
        best_cand = jnp.where(better, cand, best_cand)
        best_dist = jnp.where(better, dist, best_dist)
    mlen = _lcp(words, best_cand, pos, n)
    return mlen, jnp.where(mlen > 0, best_dist, 0)


def _greedy_path(best_len: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Reachability mask of the greedy parse via pointer doubling.

    J[p] = p + best_len[p] (if a match) else p + 1, clamped to the sentinel
    BS; after round k the mask holds every position reachable from 0 in
    < 2^(k+1) greedy steps."""
    # sentinel region is lane-aligned: positions >= BS self-trap at BS..BS+127
    BSP = BS + 128
    pos = lax.broadcasted_iota(jnp.int32, (BSP, 1), 0).reshape(BSP)
    step = jnp.where(best_len >= C.MIN_MATCH_LEN, best_len, 1)
    step = jnp.concatenate([step, jnp.ones(128, dtype=jnp.int32)])
    J = jnp.minimum(pos + step, BS)

    def body(_, st):
        J, R = st
        R = R | jnp.zeros(BSP, dtype=jnp.int32).at[J].max(R)
        return J[J], R

    # R seeded from J*0 (varying) rather than a replicated constant: keeps the
    # carry's varying manifest stable under shard_map's check_vma
    J, R = lax.fori_loop(0, _DOUBLING_ROUNDS, body, (J, (J * 0).at[0].set(1)))
    return (R[:BS] == 1) & (pos[:BS] < n)


def _hdr_or0(gap: jnp.ndarray) -> jnp.ndarray:
    """Literal header bytes for a run of `gap` bytes; 0 for an empty run."""
    return jnp.where(
        gap > 0, 1 + (gap > C.LITERAL_MAX_INLINE_LEN).astype(jnp.int32) + (gap > 256), 0
    )


def _copy_op_bytes(length: jnp.ndarray, dist: jnp.ndarray) -> jnp.ndarray:
    two = (length <= C.COPY1_MAX_LEN) & (dist < C.COPY1_MAX_OFFSET)
    return jnp.where(two, 2, 3).astype(jnp.int32)


def _refine(is_copy: jnp.ndarray, L: jnp.ndarray, D: jnp.ndarray, n: jnp.ndarray):
    """Drop net-negative copies given realized literal-gap contexts; 4
    simultaneous-drop rounds, mirroring model.encode.refine_parse."""
    pos = lax.broadcasted_iota(jnp.int32, (BS, 1), 0).reshape(BS)

    def body(_, is_copy):
        cend = jnp.where(is_copy, pos + L, 0)
        pce = jnp.concatenate([jnp.zeros(1, jnp.int32), lax.cummax(cend)[: BS - 1]])
        ncs = jnp.where(is_copy, pos, jnp.int32(BS + 1))
        ncs = jnp.concatenate(
            [lax.cummin(ncs[::-1])[::-1][1:], jnp.full(1, BS + 1, jnp.int32)]
        )
        left = pos - pce
        right = jnp.minimum(ncs, n) - (pos + L)
        benefit = (
            L
            + _hdr_or0(left + L + right)
            - _copy_op_bytes(L, D)
            - _hdr_or0(left)
            - _hdr_or0(right)
        )
        return is_copy & (benefit >= 0)

    return lax.fori_loop(0, 4, body, is_copy)


def _emit(block_u32, is_copy, L, D, n):
    """Serialize the parse: sizes -> prefix sum -> scattered bytes."""
    pos = lax.broadcasted_iota(jnp.int32, (BS, 1), 0).reshape(BS)

    # literal coverage = bytes < n not covered by a kept copy
    delta = (
        jnp.zeros(BS + 1, dtype=jnp.int32)
        .at[jnp.where(is_copy, pos, BS)].add(1, mode="drop")
        .at[jnp.where(is_copy, pos + L, BS)].add(-1, mode="drop")
    )
    covered = lax.cumsum(delta[:BS]) > 0
    lit = (~covered) & (pos < n)

    lit_prev = jnp.concatenate([jnp.array([False]), lit[: BS - 1]])
    run_start = lit & ~lit_prev
    # run start position propagated to every literal byte
    rs = lax.cummax(jnp.where(run_start, pos, -1))
    # run length at each literal byte: next non-literal boundary - run start
    lit_next = jnp.concatenate([lit[1:], jnp.array([False])])
    run_end = lit & ~lit_next
    re_rev = lax.cummin(jnp.where(run_end, pos, BS + 1)[::-1])[::-1]
    rlen = jnp.where(lit, re_rev - rs + 1, 0)

    hdr = _hdr_or0(rlen)
    opb = _copy_op_bytes(L, D)
    size = jnp.where(is_copy, opb, 0) + jnp.where(run_start, hdr + rlen, 0)
    out_off = lax.cumsum(size) - size
    total = jnp.sum(size)

    out = jnp.zeros(PAD_OUT, dtype=jnp.int32)

    # --- copy ops ---
    two = opb == 2
    b0 = jnp.where(
        two,
        ((D >> 8) << 5) | ((L - 4) << 2) | C.TAG_COPY1,
        ((L - 1) << 2) | C.TAG_COPY2,
    )
    b1 = D & 0xFF
    b2 = D >> 8
    idx = jnp.where(is_copy, out_off, PAD_OUT)
    out = out.at[idx].set(b0, mode="drop")
    out = out.at[jnp.where(is_copy, idx + 1, PAD_OUT)].set(b1, mode="drop")
    out = out.at[jnp.where(is_copy & ~two, idx + 2, PAD_OUT)].set(b2, mode="drop")

    # --- literal run headers ---
    m = rlen - 1
    h0 = jnp.where(
        hdr == 1,
        m << 2,
        jnp.where(hdr == 2, C.LITERAL_CODE_1BYTE << 2, C.LITERAL_CODE_2BYTE << 2),
    )
    hidx = jnp.where(run_start, out_off, PAD_OUT)
    out = out.at[hidx].set(h0, mode="drop")
    out = out.at[jnp.where(run_start & (hdr >= 2), hidx + 1, PAD_OUT)].set(
        m & 0xFF, mode="drop"
    )
    out = out.at[jnp.where(run_start & (hdr >= 3), hidx + 2, PAD_OUT)].set(
        m >> 8, mode="drop"
    )

    # --- literal payload ---
    run_off = lax.cummax(jnp.where(run_start, out_off + hdr, -1))
    dest = jnp.where(lit, run_off + (pos - jnp.maximum(rs, 0)), PAD_OUT)
    out = out.at[dest].set(block_u32.astype(jnp.int32), mode="drop")

    return out.astype(jnp.uint8), total.astype(jnp.int32)


def encode_block_device(block_u8: jnp.ndarray, n: jnp.ndarray):
    """Encode one zero-padded (BS,) uint8 block with valid length n.

    Returns (comp_bytes (PAD_OUT,) uint8, comp_len int32)."""
    block_u32 = block_u8.astype(jnp.uint32)
    best_len, best_dist = _best_match(block_u32, n)
    mark = _greedy_path(best_len, n)
    is_copy = mark & (best_len >= C.MIN_MATCH_LEN)
    is_copy = _refine(is_copy, best_len, best_dist, n)
    return _emit(block_u32, is_copy, best_len, best_dist, n)


@functools.partial(jax.jit, static_argnames=())
def encode_blocks(blocks_u8: jnp.ndarray, lens: jnp.ndarray):
    """Batched block encode: (B, BS) uint8 + (B,) int32 -> ((B, PAD_OUT) uint8,
    (B,) int32).  The unit shipped to the mesh layer."""
    return jax.vmap(encode_block_device)(blocks_u8, lens)
