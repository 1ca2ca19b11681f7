"""Device block decoder — vectorized JAX parallel-scan decode.

The reference decoder is strictly sequential: op N's output is op N+1's copy
window (snappy_decompression.c:345-363).  Both serial dependencies are broken
here with pointer doubling (cf. PAPERS.md: "Massively-Parallel Lossless Data
Decompression"):

  op boundaries   every byte offset p gets jump[p] = p + op_length_if_an_op_
                  started_at(p) (computable from <=5 bytes, vectorized); 17
                  rounds of J = J[J] with a scatter-or mask walk the true op
                  chain from offset 0 in O(log n).  The walk lands exactly on
                  comp_len iff the stream parses cleanly — one landing bit
                  subsumes truncation/overrun checks (the reference's only
                  plausibility check is dead code, snappy_decompression.c:262).
  back-references every output byte q gets ptr[q] = q - offset (copy) or q
                  (literal root); 17 rounds of ptr = ptr[ptr] resolve every
                  byte to its literal origin, handling overlapping copies
                  (offset < length) exactly — the chain *is* the reference's
                  byte-forward replication semantics
                  (snappy_decompression.c:273-280) in closed form.

Per-block static shapes: compressed input padded to PAD_OUT, output to BS.
Blocks are independent (copies never cross block boundaries in streams from
the reference or from our encoder), so decode is vmap/shard_map parallel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..format import constants as C

BS = C.MAX_BLOCK_SIZE
PAD_OUT = C.MAX_COMPRESSED_BLOCK_SIZE
_ROUNDS = 17  # 2^17 > PAD_OUT and > BS


def _op_table(comp_i32: jnp.ndarray):
    """Vectorized speculative op parse at every byte offset.

    Returns (jump, out_len, hdr_len, kind, dist, bad): what the op starting
    at p would be.  Lengths are clamped so malformed bytes stay
    deterministic; a bad stream simply fails the landing check.  `bad` marks
    ops malformed wherever they sit: a 4-byte literal length >= 2^30 or a
    COPY4 distance >= 2^24, both beyond any block (the model and native
    decoders reject them too)."""
    pos = lax.broadcasted_iota(jnp.int32, (PAD_OUT, 1), 0).reshape(PAD_OUT)

    def at(off):
        return comp_i32[jnp.clip(pos + off, 0, PAD_OUT - 1)]

    t = comp_i32
    b1, b2, b3, b4 = at(1), at(2), at(3), at(4)
    kind = t & 3
    code = t >> 2

    extra = jnp.clip(code - (C.LITERAL_CODE_1BYTE - 1), 0, 4)
    lit_inline = code + 1
    lit_1 = b1 + 1
    lit_2 = (b1 | (b2 << 8)) + 1
    lit_3 = (b1 | (b2 << 8) | (b3 << 16)) + 1
    lit_4 = (b1 | (b2 << 8) | (b3 << 16) | ((b4 & 0x3F) << 24)) + 1  # clamped
    lit_len = jnp.where(
        extra == 0,
        lit_inline,
        jnp.where(extra == 1, lit_1, jnp.where(extra == 2, lit_2, jnp.where(extra == 3, lit_3, lit_4))),
    )
    lit_len = jnp.clip(lit_len, 1, BS + 1)
    lit_hdr = 1 + extra

    c1_len = (code & 0x7) + 4
    c1_dist = ((code >> 3) << 8) | b1
    c2_len = code + 1
    c2_dist = b1 | (b2 << 8)
    c4_len = code + 1
    c4_dist = b1 | (b2 << 8) | (b3 << 16)

    is_lit = kind == C.TAG_LITERAL
    hdr = jnp.where(
        is_lit, lit_hdr, jnp.where(kind == C.TAG_COPY1, 2, jnp.where(kind == C.TAG_COPY2, 3, 5))
    )
    out_len = jnp.where(
        is_lit,
        lit_len,
        jnp.where(kind == C.TAG_COPY1, c1_len, jnp.where(kind == C.TAG_COPY2, c2_len, c4_len)),
    )
    dist = jnp.where(
        kind == C.TAG_COPY1, c1_dist, jnp.where(kind == C.TAG_COPY2, c2_dist, c4_dist)
    )
    bad = jnp.where(is_lit, (extra == 4) & ((b4 & 0xC0) != 0),
                    (kind == C.TAG_COPY4) & (b4 != 0))
    jump = pos + hdr + jnp.where(is_lit, lit_len, 0)
    return jump, out_len, hdr, kind, dist, bad


def _op_starts(jump: jnp.ndarray, comp_len: jnp.ndarray):
    """Mark true op starts by pointer doubling from offset 0; also return the
    landing bit (the walk reaches exactly comp_len)."""
    # sentinel region is lane-aligned (PAD_OUT..PAD_OUT+127 self-trap)
    POP = PAD_OUT + 128
    J = jnp.minimum(
        jnp.concatenate([jump, jnp.full(128, PAD_OUT, jnp.int32)]), PAD_OUT
    )
    # positions at/after comp_len must not extend the walk past the landing
    pos = lax.broadcasted_iota(jnp.int32, (POP, 1), 0).reshape(POP)
    J = jnp.where(pos >= comp_len, pos, J)  # self-loop once input is consumed
    J = jnp.maximum(J, pos + jnp.where(pos < comp_len, 1, 0))  # force progress

    def body(_, st):
        J, R = st
        R = R | jnp.zeros(POP, dtype=jnp.int32).at[J].max(R)
        return J[J], R

    # R seeded from J*0 (varying) rather than a replicated constant: keeps the
    # carry's varying manifest stable under shard_map's check_vma
    J, R = lax.fori_loop(0, _ROUNDS, body, (J, (J * 0).at[0].set(1)))
    starts = (R[:PAD_OUT] == 1) & (pos[:PAD_OUT] < comp_len)
    landed = R[jnp.clip(comp_len, 0, PAD_OUT)] == 1
    return starts, landed


def decode_block_device(comp_u8: jnp.ndarray, comp_len: jnp.ndarray, out_len: jnp.ndarray,
                        ctx_u8: jnp.ndarray | None = None, ctx_len=0):
    """Decode one zero-padded (PAD_OUT,) uint8 op stream to (BS,) uint8.

    With a context, copies may also reach ctx_len bytes back into ctx_u8
    (BS,), the output that precedes this chunk: the windowed decoder's
    sliding window.  Returns (out_bytes, ok): ok is False for malformed
    input (bad landing, output-length mismatch, malformed op, or
    out-of-range copy offset), in which case the bytes are unspecified."""
    comp_i32 = comp_u8.astype(jnp.int32)
    jump, op_out, hdr, kind, dist, bad_op = _op_table(comp_i32)
    starts, landed = _op_starts(jump, comp_len)

    osize = jnp.where(starts, op_out, 0)
    out_off = lax.cumsum(osize) - osize
    total_out = jnp.sum(osize)

    pos = lax.broadcasted_iota(jnp.int32, (PAD_OUT, 1), 0).reshape(PAD_OUT)
    # scatter each op's stream position at its output offset, then propagate
    scatter_idx = jnp.where(starts & (out_off < BS), out_off, BS)
    op_at = jnp.zeros(BS, dtype=jnp.int32).at[scatter_idx].max(
        jnp.where(starts, pos, 0), mode="drop"
    )
    op_at = lax.cummax(op_at)

    q = lax.broadcasted_iota(jnp.int32, (BS, 1), 0).reshape(BS)
    opk = kind[op_at]
    opd = dist[op_at]
    opo = out_off[op_at]
    oph = hdr[op_at]
    is_lit_byte = opk == C.TAG_LITERAL
    # literal source in the compressed stream
    lit_src = op_at + oph + (q - opo)
    in_out = q < out_len
    # offset 0 would make a copy byte its own chain root (self-loop) — corrupt
    bad_ref = jnp.any((~is_lit_byte) & ((q - opd < -ctx_len) | (opd == 0)) & in_out)
    bad_ref = bad_ref | jnp.any(starts & bad_op)
    if ctx_u8 is None:
        ptr = jnp.clip(jnp.where(is_lit_byte, q, q - opd), 0, BS - 1)
        ptr = lax.fori_loop(0, _ROUNDS, lambda _, p: p[p], ptr)
        out = comp_u8[jnp.clip(lit_src[ptr], 0, PAD_OUT - 1)]
    else:
        # index space [0, BS) is the context (every byte its own root),
        # [BS, 2 BS) this chunk's output
        ptr = jnp.concatenate([q, jnp.clip(jnp.where(is_lit_byte, q, q - opd) + BS, 0, 2 * BS - 1)])
        ptr = lax.fori_loop(0, _ROUNDS + 1, lambda _, p: p[p], ptr)[BS:]
        from_comp = comp_u8[jnp.clip(lit_src[jnp.maximum(ptr - BS, 0)], 0, PAD_OUT - 1)]
        out = jnp.where(ptr < BS, ctx_u8[jnp.minimum(ptr, BS - 1)], from_comp)
    out = jnp.where(in_out, out, 0).astype(jnp.uint8)

    # lengths outside the row are rejected, never clamped into it
    sane = (comp_len >= 0) & (comp_len <= PAD_OUT) & (out_len >= 0) & (out_len <= BS)
    sane = sane & (ctx_len >= 0) & (ctx_len <= BS)
    ok = landed & (total_out == out_len) & ~bad_ref & sane
    return out, ok


@jax.jit
def decode_blocks(comp_u8: jnp.ndarray, comp_lens: jnp.ndarray, out_lens: jnp.ndarray):
    """Batched block decode: (B, PAD_OUT) uint8 + (B,) int32 x2 ->
    ((B, BS) uint8, (B,) bool)."""
    return jax.vmap(decode_block_device)(comp_u8, comp_lens, out_lens)


@jax.jit
def decode_stream(comp_u8, comp_lens, out_lens, ctx_lens, ctx0_u8):
    """Windowed decode of N op chunks in order, each with the previous 64 KiB
    of output as copy context (same contract as decode.decode_stream)."""

    def step(ctx, chunk):
        c, cl, ol, xl = chunk
        out, ok = decode_block_device(c, cl, ol, ctx, xl)
        # slide the window: the last BS bytes of (context || this output)
        ctx = lax.dynamic_slice(jnp.concatenate([ctx, out]), (ol,), (BS,))
        return ctx, (out, ok)

    _, (out, ok) = lax.scan(step, ctx0_u8, (comp_u8, comp_lens, out_lens, ctx_lens))
    return out, ok
