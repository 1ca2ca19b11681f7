"""Mesh-parallel codec: data-parallel block sharding over a device mesh.

The reference has no parallelism at all (single thread, SURVEY.md §2); its
64 KiB blocks share no state, which is exactly the property exploited here:
blocks are the data-parallel axis, sharded over every chip with `shard_map`,
and compressed outputs come back as fixed-size padded buffers + length
vectors gathered in original block order (SURVEY.md §5.8).  No collective is
needed inside the codec itself — XLA inserts the (all-)gather implied by the
output sharding; NVLink carries it between the cards of a host, the network
across hosts when `jax.distributed` is initialized.  The mesh is 1-D: every
card reaches every other at the same rate, so only the algorithm shapes it.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..format import constants as C
from ..kernels.decode import decode_blocks
from ..kernels.encode_v2 import encode_blocks_v2 as encode_blocks

AXIS = "blocks"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D device mesh over the block axis (the codec's only parallel axis)."""
    devices = jax.devices()
    n = n_devices or len(devices)
    return jax.make_mesh((n,), (AXIS,), devices=devices[:n])


@functools.lru_cache(maxsize=8)
def sharded_encode(mesh: Mesh, dense: bool = True):
    """shard_map'ed batched encoder: blocks row-sharded over the mesh."""
    return jax.jit(
        jax.shard_map(
            functools.partial(encode_blocks, dense=dense),
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS)),
            out_specs=(P(AXIS, None), P(AXIS)),
        )
    )


@functools.lru_cache(maxsize=8)
def sharded_decode(mesh: Mesh):
    """shard_map'ed batched decoder: blocks row-sharded over the mesh."""
    return jax.jit(
        jax.shard_map(
            decode_blocks,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS, None), P(AXIS)),
            # the CUDA decoder is an FFI call, whose outputs carry no
            # varying-axes metadata, so the per-platform branches of
            # decode_blocks only type-check with the check off
            check_vma=False,
        )
    )


def _pad_batch(nblocks: int, n_shards: int) -> int:
    """Blocks per shard_map call must divide evenly over the mesh."""
    return ((nblocks + n_shards - 1) // n_shards) * n_shards


def _fetch(x) -> np.ndarray:
    """Device->host fetch that also works for multi-process global arrays
    (each host only addresses its own shards; gather the rest over DCN)."""
    if jax.process_count() > 1 and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def encode_mesh(mesh: Mesh, blocks: np.ndarray, lens: np.ndarray,
                profile: str = "dense"):
    """Encode (B, BS) blocks data-parallel over the mesh.

    Pads the batch to a multiple of the mesh size with zero-length blocks
    (which compress to zero bytes) and returns order-preserving
    ((B, PAD_OUT) uint8, (B,) int32)."""
    B = blocks.shape[0]
    Bp = _pad_batch(B, mesh.devices.size)
    bb = np.zeros((Bp, C.MAX_BLOCK_SIZE), dtype=np.uint8)
    bl = np.zeros(Bp, dtype=np.int32)
    bb[:B] = blocks
    bl[:B] = lens
    sharding = NamedSharding(mesh, P(AXIS, None))
    bb = jax.device_put(bb, sharding)
    bl = jax.device_put(bl, NamedSharding(mesh, P(AXIS)))
    comp, totals = sharded_encode(mesh, profile != "fast")(bb, bl)
    comp, totals = _fetch(comp)[:B], _fetch(totals)[:B]
    if (totals < 0).any():
        # Same no-silent-truncation contract as api.encode_array_pieces: a
        # negative total is the encoder's in-jit capacity poison.
        bad = np.nonzero(totals < 0)[0]
        raise ValueError(
            f"block(s) {bad.tolist()} exceeded the emission capacity bound; "
            f"incompressible data this adversarial must be stored raw"
        )
    return comp, totals


def decode_mesh(mesh: Mesh, comp: np.ndarray, comp_lens: np.ndarray, out_lens: np.ndarray):
    """Decode padded per-block op chunks data-parallel over the mesh."""
    B = comp.shape[0]
    Bp = _pad_batch(B, mesh.devices.size)
    pc = np.zeros((Bp, C.MAX_COMPRESSED_BLOCK_SIZE), dtype=np.uint8)
    pl = np.zeros(Bp, dtype=np.int32)
    ol = np.zeros(Bp, dtype=np.int32)
    pc[:B] = comp
    pl[:B] = comp_lens
    ol[:B] = out_lens
    pc = jax.device_put(pc, NamedSharding(mesh, P(AXIS, None)))
    pl = jax.device_put(pl, NamedSharding(mesh, P(AXIS)))
    ol = jax.device_put(ol, NamedSharding(mesh, P(AXIS)))
    out, ok = sharded_decode(mesh)(pc, pl, ol)
    return _fetch(out)[:B], _fetch(ok)[:B]


def init_distributed():
    """Multi-host entry: initialize JAX distributed (DCN) when the standard
    cluster env vars are present; no-op for single-process runs.  After this,
    make_mesh() spans all hosts' devices and encode_mesh/decode_mesh shard
    blocks globally (each host feeds its local rows)."""
    import os

    if os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS"
    ):
        jax.distributed.initialize()
    return jax.process_index(), jax.process_count()
