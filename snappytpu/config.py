"""Configuration (SURVEY.md §5.6).

The reference exposes getopt flags plus compile-time constants
(MAX_BLOCK_SIZE/MAX_HTABLE_SIZE/BUFFER_DIM, snappy_compression.c:9-10,
snappy_decompression.c:15).  Here the equivalent knobs are a dataclass used
across backends; the two encoder profiles correspond to the reference's two
match-finder quality tiers (hash table = fast, BST = dense,
snappy_compression.c vs snappy_compression_tree.c) — except both of ours are
collision-free, the fast profile just searches fewer gram tiers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from .format import constants as C

# v2 production encoder profiles (kernels/encode_v2.py):
#   dense — byte-resolution tier B with full-depth sort keys; compressed
#           size <= the reference C codec's best on every fixture
#   fast  — sampled-key tier B at stride 4; ~1.4x faster, ratio still above
#           the reference's hash compressor on the benchmark corpus
#
# gram tiers per profile (used by the v1 research encoder, encode_jax.py):
# (gram_len, n_predecessors)
PROFILES: dict[str, tuple[tuple[int, int], ...]] = {
    "dense": ((4, 2), (8, 1), (16, 1), (32, 1), (64, 1)),
    "fast": ((4, 1), (8, 1), (64, 1)),
}


@dataclass(frozen=True)
class CodecConfig:
    block_size: int = C.MAX_BLOCK_SIZE
    profile: str = "dense"          # "dense" | "fast"
    refine_rounds: int = 4           # cost-aware copy-drop rounds (0 = off)
    backend: str = "device"          # "device" | "cpu" | "model"
    device_batch: int = 128          # blocks per device dispatch
    mesh_axis: str = "blocks"

    @property
    def gram_tiers(self) -> tuple[tuple[int, int], ...]:
        return PROFILES[self.profile]

    def validate(self) -> "CodecConfig":
        if self.block_size < 16 or self.block_size > C.MAX_BLOCK_SIZE:
            raise ValueError("block_size must be in [16, 65536]")
        if self.profile not in PROFILES:
            raise ValueError(f"unknown profile {self.profile!r}")
        if self.backend not in ("device", "cpu", "model"):
            raise ValueError(f"unknown backend {self.backend!r}")
        return self


DEFAULT = CodecConfig()


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and nothing
    is set here.  Otherwise the cache lives at a fixed path inside the
    checkout (.jax_cache, listed in .gitignore): the path is part of the
    cache key, so it must not move between runs."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
