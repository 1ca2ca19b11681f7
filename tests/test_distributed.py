"""Multi-host (multi-process) smoke test — BASELINE config 5's mechanism.

Spawns two jax.distributed processes (gloo/CPU transport, 4 virtual devices
each) that build one global 8-device mesh, encode a shared corpus
data-parallel across both processes, mesh-decode it back, and digest the
compressed bytes.  The parent asserts (a) both processes agree, and (b) the
bytes are identical to a single-process encode of the same data —
host-count invariance of the output stream (SURVEY.md §4, §5.8).
"""

import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "distributed_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_mesh_encode_matches_single_process(tmp_path):
    port = _free_port()
    # the workers pin themselves to the CPU with 4 virtual devices each, so
    # none of them opens a GPU; the parent's platform settings must not leak
    drop = ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")
    env = {k: v for k, v in os.environ.items() if k not in drop}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, f"localhost:{port}", "2", str(i), str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"

    digests = []
    for i in range(2):
        with open(tmp_path / f"digest_{i}.txt") as f:
            digests.append(f.read().strip())
    assert digests[0] == digests[1], "processes disagree on compressed bytes"

    # single-process encode of the same corpus on the local 8-device mesh
    from snappytpu.bench import corpus
    from snappytpu.mesh import sharding
    from snappytpu.stream import framing

    data = np.frombuffer(corpus.mixed(300_000, seed=77), np.uint8)
    blocks, lens = framing.pack_blocks(data)
    comp, totals = sharding.encode_mesh(sharding.make_mesh(), blocks, lens)
    digest = hashlib.sha256()
    for i in range(comp.shape[0]):
        digest.update(comp[i, : totals[i]].tobytes())
    assert digest.hexdigest() == digests[0], (
        "2-process stream differs from single-process stream"
    )
