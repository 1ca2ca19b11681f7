"""snappytpu — a Snappy codec framework in JAX for GPUs.

Capabilities of the reference C codec (tturturiello/lightweight-snappy),
redesigned for a data-parallel accelerator: block-parallel LZ77 encode with a
collision-free sorted match finder, a per-block CUDA decoder (with a
plain-JAX parallel-scan decoder on the CPU), data-parallel sharding of
independent 64 KiB blocks over device meshes, plus a native C++ host runtime
and golden oracle.
"""

__version__ = "0.1.0"

from .format import constants  # noqa: F401
