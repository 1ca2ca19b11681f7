"""Device kernels.

Production paths:
  encode_blocks_v2   sort/scan-native block encoder (XLA)
  decode_blocks      per-block decoder: CUDA kernel on GPUs, the plain-JAX
                     parallel-scan decoder on the CPU (decode.py)
  decode_stream      windowed decoder for streams whose ops straddle
                     64 KiB blocks (same split)

Research/compat paths kept for parity tests:
  encode_blocks      v1 fused pointer-doubling encoder
  pipeline           staged v1 (per-stage jits, optimization barriers)
"""

from .decode import decode_blocks, decode_stream  # noqa: F401
from .encode_jax import encode_blocks  # noqa: F401
from .encode_v2 import encode_blocks_v2  # noqa: F401
