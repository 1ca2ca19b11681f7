"""Staged device pipeline of the v1 research codec.

Why stages instead of one fused jit: a pipeline of small jitted stages (each
a few dozen HLO ops) keeps every compile short; intermediates stay
device-resident between stages.  `lax.optimization_barrier` fences each
data-dependent gather/scatter round so XLA cannot fuse gather chains into
one large fusion.

The algorithm is bit-identical to the numpy model (snappytpu/model/encode.py)
and to the fused kernels (encode_jax.py/decode_jax.py): tiered sorted
candidates, hash-quantized candidate selection + one exact LCP, pointer-
doubling greedy parse, cost-aware refine, prefix-sum + scatter emission;
decode is speculative op-table + doubling boundary walk + chain resolution.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..format import constants as C
from .encode_jax import GRAM_TIERS, _MIX1, _MIX2

BS = C.MAX_BLOCK_SIZE
PAD_OUT = C.MAX_COMPRESSED_BLOCK_SIZE
BSP = BS + 128      # greedy jump table with lane-aligned sentinel region
POP = PAD_OUT + 128  # decode boundary walk sentinel region

_barrier = lax.optimization_barrier


def _rows(B):
    return jnp.arange(B, dtype=jnp.int32)[:, None]


def _pos_row(n_cols):
    return jnp.arange(n_cols, dtype=jnp.int32)[None, :]


def _take(arr, idx):
    """Batched within-block gather: arr[b, idx[b, i]] with barrier'd indices."""
    B = arr.shape[0]
    return arr[_rows(B), _barrier(idx)]


# ----------------------------------------------------------------- encode ---


@jax.jit
def s_words(blocks_u8):
    """(B, BS) uint8 -> big-endian u32 word at every position."""
    b = blocks_u8.astype(jnp.uint32)
    z = jnp.zeros((b.shape[0], 3), dtype=jnp.uint32)
    p = jnp.concatenate([b, z], axis=1)
    return (
        (p[:, :BS] << 24) | (p[:, 1 : BS + 1] << 16) | (p[:, 2 : BS + 2] << 8) | p[:, 3 : BS + 3]
    )


@functools.partial(jax.jit, static_argnames=("g",))
def s_hash(words, g):
    """Hierarchical gram hash for tier g (identical to model.gram_hashes)."""
    h = words
    k = 4
    while k < g:
        shifted = jnp.concatenate(
            [h[:, k:], jnp.zeros((h.shape[0], k), dtype=jnp.uint32)], axis=1
        )
        h = (h * _MIX1) ^ ((shifted * _MIX2) >> jnp.uint32(3)) ^ (shifted << jnp.uint32(13))
        k *= 2
    return h


@jax.jit
def s_sort_tier(h, limit):
    """Sort (validity, hash, position) per block; limit = n - gram_len."""
    B = h.shape[0]
    pos = jnp.broadcast_to(_pos_row(BS), (B, BS)).astype(jnp.int32)
    flag = (pos > limit[:, None]).astype(jnp.uint32)
    return lax.sort((flag, h, pos), dimension=1, num_keys=3)


@functools.partial(jax.jit, static_argnames=("k",))
def s_pred(sflag, sh, spos, k):
    """k-th sorted predecessor as a candidate array in position order."""
    B = sh.shape[0]
    same = jnp.ones((B, BS), dtype=jnp.bool_)
    for j in range(1, k + 1):
        shifted_h = jnp.concatenate([jnp.zeros((B, j), jnp.uint32), sh[:, : BS - j]], axis=1)
        shifted_f = jnp.concatenate([jnp.ones((B, j), jnp.uint32), sflag[:, : BS - j]], axis=1)
        same = same & (sh == shifted_h) & (sflag == 0) & (shifted_f == 0)
    prev = jnp.concatenate([jnp.full((B, k), -1, jnp.int32), spos[:, : BS - k]], axis=1)
    pred = jnp.where(same, prev, -1)
    # scatter back to position order; spos is a permutation so slots are unique
    out = jnp.full((B, BS), -2, dtype=jnp.int32)
    out = out.at[_rows(B), _barrier(spos)].max(pred)
    return out


@jax.jit
def s_score(cand, h4, h8, h16, h32, h64, n):
    """Hash-quantized LCP estimate for one candidate array (5 gathers)."""
    valid = cand >= 0
    c = _barrier(jnp.maximum(cand, 0))
    B = cand.shape[0]
    pos = jnp.broadcast_to(_pos_row(BS), (B, BS)).astype(jnp.int32)
    est = jnp.zeros((B, BS), dtype=jnp.int32)
    r = _rows(B)
    for g, h in ((4, h4), (8, h8), (16, h16), (32, h32), (64, h64)):
        lim = (n - g)[:, None]
        ok = (h[r, c] == h) & (pos <= lim) & (c <= lim)
        est = jnp.where(ok, g, est)
    return jnp.where(valid, est, -1)


@jax.jit
def s_pick(ests, cands, n):
    """Select best candidate per position: max est, ties to smallest dist."""
    B = ests[0].shape[0]
    pos = jnp.broadcast_to(_pos_row(BS), (B, BS)).astype(jnp.int32)
    best_est = jnp.full((B, BS), -1, jnp.int32)
    best_cand = jnp.full((B, BS), -1, jnp.int32)
    best_dist = jnp.zeros((B, BS), jnp.int32)
    for est, cand in zip(ests, cands):
        dist = pos - cand
        valid = cand >= 0
        better = valid & ((est > best_est) | ((est == best_est) & (dist < best_dist)))
        best_est = jnp.where(better, est, best_est)
        best_cand = jnp.where(better, cand, best_cand)
        best_dist = jnp.where(better, dist, best_dist)
    return best_cand, best_dist


@functools.partial(jax.jit, static_argnames=("j0", "nrounds"))
def s_lcp_rounds(words, cand, n, nfull, alive, extra, j0, nrounds):
    """nrounds stride-4 word-compare rounds of the exact LCP."""
    B = words.shape[0]
    r = _rows(B)
    pos = jnp.broadcast_to(_pos_row(BS), (B, BS)).astype(jnp.int32)
    c = jnp.maximum(cand, 0)
    for j in range(j0, j0 + nrounds):
        a = words[r, _barrier(jnp.clip(pos + 4 * j, 0, BS - 1))]
        b = words[r, _barrier(jnp.clip(c + 4 * j, 0, BS - 1))]
        x = a ^ b
        eq = x == 0
        e = jnp.where(x < (1 << 8), 3, jnp.where(x < (1 << 16), 2, jnp.where(x < (1 << 24), 1, 0))).astype(jnp.int32)
        first_mismatch = alive & ~eq
        extra = jnp.where(first_mismatch, e, extra)
        alive = alive & eq
        nfull = nfull + alive
        nfull, alive, extra = _barrier((nfull, alive, extra))
    return nfull, alive, extra


@jax.jit
def s_lcp_final(cand, pos_n, nfull, alive, extra):
    """Assemble the capped LCP from the word-compare state."""
    n = pos_n
    B = cand.shape[0]
    pos = jnp.broadcast_to(_pos_row(BS), (B, BS)).astype(jnp.int32)
    valid = cand >= 0
    lcp = 4 * nfull + jnp.where(alive, 0, extra)
    cap = jnp.minimum(C.MAX_COPY_LEN, n[:, None] - pos)
    return jnp.where(valid, jnp.minimum(lcp, jnp.maximum(cap, 0)), 0)


def exact_lcp(words, cand, n):
    B = words.shape[0]
    nfull = jnp.zeros((B, BS), jnp.int32)
    alive = cand >= 0
    extra = jnp.zeros((B, BS), jnp.int32)
    for j0 in (0, 6, 12):
        nfull, alive, extra = s_lcp_rounds(words, cand, n, nfull, alive, extra, j0, 6)
    return s_lcp_final(cand, n, nfull, alive, extra)


@jax.jit
def s_greedy_init(best_len):
    B = best_len.shape[0]
    pos = jnp.broadcast_to(_pos_row(BSP), (B, BSP)).astype(jnp.int32)
    step = jnp.where(best_len >= C.MIN_MATCH_LEN, best_len, 1)
    step = jnp.concatenate([step, jnp.ones((B, 128), jnp.int32)], axis=1)
    J = jnp.minimum(pos + step, BS)
    R = jnp.zeros((B, BSP), jnp.int32).at[:, 0].set(1)
    return J, R


@functools.partial(jax.jit, static_argnames=("nrounds",))
def s_doubling(J, R, nrounds):
    """nrounds of reachability doubling (shared by greedy and decode walk)."""
    B = J.shape[0]
    r = _rows(B)
    N = J.shape[1]
    for _ in range(nrounds):
        R = R | jnp.zeros((B, N), jnp.int32).at[r, _barrier(J)].max(R)
        J = J[r, _barrier(J)]
        J, R = _barrier((J, R))
    return J, R


@jax.jit
def s_greedy_final(R, best_len, n):
    B = R.shape[0]
    pos = jnp.broadcast_to(_pos_row(BS), (B, BS)).astype(jnp.int32)
    mark = (R[:, :BS] == 1) & (pos < n[:, None])
    return mark & (best_len >= C.MIN_MATCH_LEN)


def _hdr_or0(gap):
    return jnp.where(gap > 0, 1 + (gap > C.LITERAL_MAX_INLINE_LEN).astype(jnp.int32) + (gap > 256), 0)


def _copy_op_bytes(length, dist):
    two = (length <= C.COPY1_MAX_LEN) & (dist < C.COPY1_MAX_OFFSET)
    return jnp.where(two, 2, 3).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("nrounds",))
def s_refine(is_copy, L, D, n, nrounds=4):
    B = is_copy.shape[0]
    pos = jnp.broadcast_to(_pos_row(BS), (B, BS)).astype(jnp.int32)
    for _ in range(nrounds):
        cend = jnp.where(is_copy, pos + L, 0)
        pce = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), lax.cummax(cend, axis=1)[:, : BS - 1]], axis=1
        )
        ncs = jnp.where(is_copy, pos, jnp.int32(BS + 1))
        ncs = jnp.concatenate(
            [lax.cummin(ncs[:, ::-1], axis=1)[:, ::-1][:, 1:], jnp.full((B, 1), BS + 1, jnp.int32)],
            axis=1,
        )
        left = pos - pce
        right = jnp.minimum(ncs, n[:, None]) - (pos + L)
        benefit = (
            L + _hdr_or0(left + L + right) - _copy_op_bytes(L, D) - _hdr_or0(left) - _hdr_or0(right)
        )
        is_copy = _barrier(is_copy & (benefit >= 0))
    return is_copy


@jax.jit
def s_emit_layout(is_copy, L, D, n):
    """Literal coverage, run geometry, op sizes, output offsets, total."""
    B = is_copy.shape[0]
    r = _rows(B)
    pos = jnp.broadcast_to(_pos_row(BS), (B, BS)).astype(jnp.int32)
    delta = (
        jnp.zeros((B, BS + 128), jnp.int32)
        .at[r, _barrier(jnp.where(is_copy, pos, BS))].add(1, mode="drop")
        .at[r, _barrier(jnp.where(is_copy, pos + L, BS))].add(-1, mode="drop")
    )
    covered = lax.cumsum(delta[:, :BS], axis=1) > 0
    lit = (~covered) & (pos < n[:, None])
    lit_prev = jnp.concatenate([jnp.zeros((B, 1), jnp.bool_), lit[:, : BS - 1]], axis=1)
    run_start = lit & ~lit_prev
    rs = lax.cummax(jnp.where(run_start, pos, -1), axis=1)
    lit_next = jnp.concatenate([lit[:, 1:], jnp.zeros((B, 1), jnp.bool_)], axis=1)
    run_end = lit & ~lit_next
    re_rev = lax.cummin(jnp.where(run_end, pos, BS + 1)[:, ::-1], axis=1)[:, ::-1]
    rlen = jnp.where(lit, re_rev - rs + 1, 0)
    hdr = _hdr_or0(rlen)
    opb = _copy_op_bytes(L, D)
    size = jnp.where(is_copy, opb, 0) + jnp.where(run_start, hdr + rlen, 0)
    out_off = lax.cumsum(size, axis=1) - size
    total = jnp.sum(size, axis=1).astype(jnp.int32)
    return lit, run_start, rs, rlen, hdr, opb, out_off, total


@jax.jit
def s_emit_bytes(blocks_u8, is_copy, L, D, lit, run_start, rs, rlen, hdr, opb, out_off):
    """Scatter tag/header/payload bytes into the padded output buffer."""
    B = is_copy.shape[0]
    r = _rows(B)
    pos = jnp.broadcast_to(_pos_row(BS), (B, BS)).astype(jnp.int32)
    out = jnp.zeros((B, PAD_OUT + 8), jnp.int32)
    two = opb == 2
    b0 = jnp.where(two, ((D >> 8) << 5) | ((L - 4) << 2) | C.TAG_COPY1, ((L - 1) << 2) | C.TAG_COPY2)
    idx = jnp.where(is_copy, out_off, PAD_OUT + 1)
    out = out.at[r, _barrier(idx)].add(b0 * is_copy, mode="drop")
    out = out.at[r, _barrier(jnp.where(is_copy, idx + 1, PAD_OUT + 1))].add((D & 0xFF) * is_copy, mode="drop")
    m3 = is_copy & ~two
    out = out.at[r, _barrier(jnp.where(m3, idx + 2, PAD_OUT + 1))].add((D >> 8) * m3, mode="drop")
    m = rlen - 1
    h0 = jnp.where(hdr == 1, m << 2, jnp.where(hdr == 2, C.LITERAL_CODE_1BYTE << 2, C.LITERAL_CODE_2BYTE << 2))
    hidx = jnp.where(run_start, out_off, PAD_OUT + 1)
    out = out.at[r, _barrier(hidx)].add(h0 * run_start, mode="drop")
    h2 = run_start & (hdr >= 2)
    out = out.at[r, _barrier(jnp.where(h2, hidx + 1, PAD_OUT + 1))].add((m & 0xFF) * h2, mode="drop")
    h3 = run_start & (hdr >= 3)
    out = out.at[r, _barrier(jnp.where(h3, hidx + 2, PAD_OUT + 1))].add((m >> 8) * h3, mode="drop")
    run_off = lax.cummax(jnp.where(run_start, out_off + hdr, -1), axis=1)
    dest = jnp.where(lit, run_off + (pos - jnp.maximum(rs, 0)), PAD_OUT + 1)
    out = out.at[r, _barrier(dest)].add(blocks_u8.astype(jnp.int32) * lit, mode="drop")
    return out[:, :PAD_OUT].astype(jnp.uint8)


def encode_pipeline(blocks_u8, lens, profile: str = "dense"):
    """Staged batch encode: (B, BS) uint8 + (B,) int32 -> ((B, PAD_OUT) uint8,
    (B,) int32).  Same contract (and bytes) as encode_jax.encode_blocks.

    profile selects the candidate tier set (config.PROFILES): "dense" is the
    default quality tier (the reference's BST variant analog), "fast" searches
    fewer gram tiers (its hash-table analog) — both collision-free."""
    from ..config import PROFILES

    blocks_u8 = jnp.asarray(blocks_u8)
    n = jnp.asarray(lens, dtype=jnp.int32)
    words = s_words(blocks_u8)
    hashes = {4: words}
    for g in (8, 16, 32, 64):
        hashes[g] = s_hash(words, g)
    cands = []
    for g, n_pred in PROFILES[profile]:
        sflag, sh, spos = s_sort_tier(hashes[g], n - g)
        for k in range(1, n_pred + 1):
            cands.append(s_pred(sflag, sh, spos, k))
    ests = [s_score(c, hashes[4], hashes[8], hashes[16], hashes[32], hashes[64], n) for c in cands]
    best_cand, best_dist = s_pick(tuple(ests), tuple(cands), n)
    best_len = exact_lcp(words, best_cand, n)
    J, R = s_greedy_init(best_len)
    for _ in range(3):
        J, R = s_doubling(J, R, 6)
    is_copy = s_greedy_final(R, best_len, n)
    is_copy = s_refine(is_copy, best_len, best_dist, n)
    lit, run_start, rs, rlen, hdr, opb, out_off, total = s_emit_layout(is_copy, best_len, best_dist, n)
    comp = s_emit_bytes(blocks_u8, is_copy, best_len, best_dist, lit, run_start, rs, rlen, hdr, opb, out_off)
    return comp, total


# ----------------------------------------------------------------- decode ---


@jax.jit
def d_op_table(comp_u8):
    """Speculative op parse at every offset (see decode_jax._op_table)."""
    comp_i32 = comp_u8.astype(jnp.int32)
    B = comp_i32.shape[0]
    r = _rows(B)
    pos = jnp.broadcast_to(_pos_row(PAD_OUT), (B, PAD_OUT)).astype(jnp.int32)

    def at(off):
        return comp_i32[r, jnp.clip(pos + off, 0, PAD_OUT - 1)]

    t = comp_i32
    b1, b2, b3, b4 = at(1), at(2), at(3), at(4)
    kind = t & 3
    code = t >> 2
    extra = jnp.clip(code - (C.LITERAL_CODE_1BYTE - 1), 0, 4)
    lit_len = jnp.where(
        extra == 0,
        code + 1,
        jnp.where(
            extra == 1,
            b1 + 1,
            jnp.where(
                extra == 2,
                (b1 | (b2 << 8)) + 1,
                jnp.where(extra == 3, (b1 | (b2 << 8) | (b3 << 16)) + 1, (b1 | (b2 << 8) | (b3 << 16) | ((b4 & 0x3F) << 24)) + 1),
            ),
        ),
    )
    lit_len = jnp.clip(lit_len, 1, BS + 1)
    is_lit = kind == C.TAG_LITERAL
    hdr = jnp.where(is_lit, 1 + extra, jnp.where(kind == C.TAG_COPY1, 2, jnp.where(kind == C.TAG_COPY2, 3, 5)))
    out_len = jnp.where(
        is_lit,
        lit_len,
        jnp.where(kind == C.TAG_COPY1, ((code & 0x7) + 4), code + 1),
    )
    dist = jnp.where(
        kind == C.TAG_COPY1,
        ((code >> 3) << 8) | b1,
        jnp.where(kind == C.TAG_COPY2, b1 | (b2 << 8), jnp.clip(b1 | (b2 << 8) | (b3 << 16) | ((b4 & 0x3F) << 24), 0, 1 << 28)),
    )
    jump = pos + hdr + jnp.where(is_lit, lit_len, 0)
    return jump, out_len, hdr, kind, dist


@jax.jit
def d_walk_init(jump, comp_len):
    B = jump.shape[0]
    pos = jnp.broadcast_to(_pos_row(POP), (B, POP)).astype(jnp.int32)
    J = jnp.minimum(jnp.concatenate([jump, jnp.full((B, 128), PAD_OUT, jnp.int32)], axis=1), PAD_OUT)
    cl = comp_len[:, None]
    J = jnp.where(pos >= cl, pos, J)
    J = jnp.maximum(J, pos + (pos < cl))
    R = jnp.zeros((B, POP), jnp.int32).at[:, 0].set(1)
    return J, R


@jax.jit
def d_walk_final(R, comp_len):
    B = R.shape[0]
    pos = jnp.broadcast_to(_pos_row(PAD_OUT), (B, PAD_OUT)).astype(jnp.int32)
    starts = (R[:, :PAD_OUT] == 1) & (pos < comp_len[:, None])
    landed = R[_rows(B).reshape(B), jnp.clip(comp_len, 0, POP - 1)] == 1
    return starts, landed


@jax.jit
def d_layout(starts, op_out, out_len):
    osize = jnp.where(starts, op_out, 0)
    out_off = lax.cumsum(osize, axis=1) - osize
    total_out = jnp.sum(osize, axis=1)
    ok_len = total_out == out_len
    return out_off, ok_len


@jax.jit
def d_op_at(starts, out_off):
    B = starts.shape[0]
    r = _rows(B)
    pos = jnp.broadcast_to(_pos_row(PAD_OUT), (B, PAD_OUT)).astype(jnp.int32)
    scatter_idx = jnp.where(starts & (out_off < BS), out_off, BS)
    op_at = jnp.zeros((B, BS + 128), jnp.int32).at[r, _barrier(scatter_idx)].max(
        jnp.where(starts, pos, 0), mode="drop"
    )
    return lax.cummax(op_at[:, :BS], axis=1)


@jax.jit
def d_chain_init(op_at, kind, dist, hdr, out_off, out_len):
    B = op_at.shape[0]
    r = _rows(B)
    q = jnp.broadcast_to(_pos_row(BS), (B, BS)).astype(jnp.int32)
    oa = _barrier(op_at)
    opk = kind[r, oa]
    opd = dist[r, oa]
    opo = out_off[r, oa]
    oph = hdr[r, oa]
    is_lit_byte = opk == C.TAG_LITERAL
    lit_src = op_at + oph + (q - opo)
    ptr = jnp.where(is_lit_byte, q, q - opd)
    in_out = q < out_len[:, None]
    bad_ref = jnp.any((~is_lit_byte) & ((ptr < 0) | (opd == 0)) & in_out, axis=1)
    return jnp.clip(ptr, 0, BS - 1), lit_src, bad_ref


@functools.partial(jax.jit, static_argnames=("nrounds",))
def d_chain(ptr, nrounds):
    B = ptr.shape[0]
    r = _rows(B)
    for _ in range(nrounds):
        ptr = _barrier(ptr[r, _barrier(ptr)])
    return ptr


@jax.jit
def d_final(comp_u8, lit_src, ptr, out_len, landed, ok_len, bad_ref):
    B = comp_u8.shape[0]
    r = _rows(B)
    q = jnp.broadcast_to(_pos_row(BS), (B, BS)).astype(jnp.int32)
    src = jnp.clip(lit_src[r, _barrier(ptr)], 0, PAD_OUT - 1)
    out = comp_u8[r, _barrier(src)]
    out = jnp.where(q < out_len[:, None], out, 0).astype(jnp.uint8)
    ok = landed & ok_len & ~bad_ref & (out_len >= 0)
    return out, ok


def decode_pipeline(comp_u8, comp_lens, out_lens):
    """Staged batch decode: same contract as decode_jax.decode_blocks."""
    comp_u8 = jnp.asarray(comp_u8)
    comp_lens = jnp.asarray(comp_lens, dtype=jnp.int32)
    out_lens = jnp.asarray(out_lens, dtype=jnp.int32)
    jump, op_out, hdr, kind, dist = d_op_table(comp_u8)
    J, R = d_walk_init(jump, comp_lens)
    for _ in range(3):
        J, R = s_doubling(J, R, 6)
    starts, landed = d_walk_final(R, comp_lens)
    out_off, ok_len = d_layout(starts, op_out, out_lens)
    op_at = d_op_at(starts, out_off)
    ptr, lit_src, bad_ref = d_chain_init(op_at, kind, dist, hdr, out_off, out_lens)
    for _ in range(3):
        ptr = d_chain(ptr, 6)
    return d_final(comp_u8, lit_src, ptr, out_lens, landed, ok_len, bad_ref)
