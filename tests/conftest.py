"""Test configuration.  The tests run on the CPU unless JAX_PLATFORMS says
otherwise: there JAX gets 8 virtual devices, so the mesh tests run without
hardware.  Tests marked `gpu` need a CUDA card and skip without one (see
tests/test_decode_cuda.py).  Must run before jax is imported anywhere."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if os.environ["JAX_PLATFORMS"] == "cpu" and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent compilation cache: the batch codec jits are expensive to build
# (hundreds of 64k-wide fused ops); cache them across test runs/processes.
from snappytpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

import subprocess

import pytest

REF_SRC = "/root/reference/src"
REF_BUILD = "/tmp/refsnappy"


def _build_reference_cli() -> str | None:
    """Compile the reference C codec (out of repo, in /tmp) as a test oracle.

    We never copy this code into our tree; we only build and run it to
    cross-validate wire compatibility, per SURVEY.md §4.
    """
    exe = os.path.join(REF_BUILD, "snappy")
    if os.path.exists(exe):
        return exe
    if not os.path.isdir(REF_SRC):
        return None
    os.makedirs(REF_BUILD, exist_ok=True)
    sources = [
        "cmd.c",
        "snappy_compression.c",
        "snappy_compression_tree.c",
        "snappy_decompression.c",
        "varint.c",
        "buffer_compression.c",
        "BST.c",
        "IO_utils.c",
        "result.c",
    ]
    cmd = ["gcc", "-O2", "-std=c99", "-o", exe] + [
        os.path.join(REF_SRC, s) for s in sources
    ]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        if r.returncode != 0:
            return None
    except Exception:
        return None
    return exe if os.path.exists(exe) else None


@pytest.fixture(scope="session")
def reference_cli():
    exe = _build_reference_cli()
    if exe is None:
        pytest.skip("reference C binary unavailable")
    return exe
