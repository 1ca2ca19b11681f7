"""Block and windowed-stream decode: one entry point per case, one kernel
per platform.

On CUDA devices both entry points call the hand-written kernels of
csrc/decode.cu through the XLA FFI: one thread block per 64 KiB block, the
ops walked in order by one warp (see the file's header).  On the CPU they
run the plain-JAX parallel-scan decoder (decode_jax.py), which is also the
reference the CUDA kernels are tested against.  The choice is made per
platform at lowering time (`lax.platform_dependent`); there is no fallback
from one to the other, and any other platform is an error.

The CUDA library is built from the source in the repository with nvcc the
first time a decode is traced on a GPU (`decode.build()` builds it ahead
of time).  It lands in csrc/build/, named by a hash of the
source and of the FFI headers, so an edited source is never served stale.
A failed build or load raises.

Contract of both entry points: malformed streams clear the block's ok flag
(same accept set as model/decode.py and the native decoder); zero-length
padded blocks are ok; bytes past out_len are zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import jax
import jax.numpy as jnp
from jax import lax

from ..format import constants as C
from . import decode_jax

BS = C.MAX_BLOCK_SIZE
PAD_OUT = C.MAX_COMPRESSED_BLOCK_SIZE

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "decode.cu")
_BUILD = os.path.join(_DIR, "csrc", "build")
_TARGETS = {"snappy_decode_blocks": "SnappyDecodeBlocks",
            "snappy_decode_stream": "SnappyDecodeStream"}
_registered = False


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    """Where the built library for the current source lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(jax.ffi.include_dir().encode())
    return os.path.join(_BUILD, f"libsnappy_decode-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile csrc/decode.cu for sm_90a unless the current build exists."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    nvcc = _nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
           "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


def _register_cuda() -> None:
    global _registered
    if _registered:
        return
    lib = ctypes.CDLL(build())
    for target, symbol in _TARGETS.items():
        jax.ffi.register_ffi_target(target, jax.ffi.pycapsule(getattr(lib, symbol)),
                                    platform="CUDA")
    _registered = True


def _cuda_blocks(comp, comp_lens, out_lens):
    B = comp.shape[0]
    out, ok = jax.ffi.ffi_call(
        "snappy_decode_blocks",
        (jax.ShapeDtypeStruct((B, BS), jnp.uint8), jax.ShapeDtypeStruct((B,), jnp.int32)),
    )(comp, comp_lens, out_lens)
    return out, ok != 0


def _cuda_stream(comp, comp_lens, out_lens, ctx_lens, ctx0):
    N = comp.shape[0]
    out, ok = jax.ffi.ffi_call(
        "snappy_decode_stream",
        (jax.ShapeDtypeStruct((N, BS), jnp.uint8), jax.ShapeDtypeStruct((N,), jnp.int32)),
    )(comp, comp_lens, out_lens, ctx_lens, ctx0)
    return out, ok != 0


def _prepare():
    # the FFI targets must exist before a CUDA lowering references them
    if jax.default_backend() == "gpu":
        _register_cuda()


@jax.jit
def decode_blocks(comp_u8, comp_lens, out_lens):
    """Batched block decode: (B, PAD_OUT) uint8 + (B,) int32 comp lens +
    (B,) int32 out lens -> ((B, BS) uint8, (B,) bool ok)."""
    _prepare()
    args = (jnp.asarray(comp_u8, jnp.uint8), jnp.asarray(comp_lens, jnp.int32),
            jnp.asarray(out_lens, jnp.int32))
    return lax.platform_dependent(*args, cpu=decode_jax.decode_blocks, cuda=_cuda_blocks)


@jax.jit
def decode_stream(comp_u8, comp_lens, out_lens, ctx_lens, ctx0_u8):
    """Sequential windowed decode of N op chunks cut at op boundaries:
    (N, PAD_OUT) uint8 + (N,) int32 comp lens + (N,) int32 out lens
    (<= 64 KiB each) + (N,) int32 available-context lens + (BS,) uint8
    initial context -> ((N, BS) uint8, (N,) bool ok).  Chunk i's copies may
    reach ctx_lens[i] bytes before its own output: the previous chunks'
    bytes, or ctx0 for the first."""
    _prepare()
    args = (jnp.asarray(comp_u8, jnp.uint8), jnp.asarray(comp_lens, jnp.int32),
            jnp.asarray(out_lens, jnp.int32), jnp.asarray(ctx_lens, jnp.int32),
            jnp.asarray(ctx0_u8, jnp.uint8))
    return lax.platform_dependent(*args, cpu=decode_jax.decode_stream, cuda=_cuda_stream)

