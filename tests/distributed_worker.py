"""Worker process for the 2-process jax.distributed smoke test.

Launched by tests/test_distributed.py with argv:
    distributed_worker.py <coordinator> <num_procs> <proc_id> <outdir>

Each process owns 4 virtual CPU devices; the global mesh spans 8.  The
worker encodes a shared deterministic corpus data-parallel over the global
mesh (encode_mesh), allgathers the padded outputs, round-trips them through
the mesh decoder, and writes a digest of the compressed bytes so the parent
can assert host-count invariance against a single-process encode.
"""

import hashlib
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from snappytpu.config import enable_compile_cache  # noqa: E402

enable_compile_cache()

coordinator, num_procs, proc_id, outdir = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
)
jax.distributed.initialize(
    coordinator_address=coordinator, num_processes=num_procs, process_id=proc_id
)

import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from snappytpu.bench import corpus  # noqa: E402
from snappytpu.mesh import sharding  # noqa: E402
from snappytpu.stream import framing  # noqa: E402

assert jax.process_count() == num_procs
assert len(jax.devices()) == 4 * num_procs, len(jax.devices())

data = np.frombuffer(corpus.mixed(300_000, seed=77), np.uint8)
blocks, lens = framing.pack_blocks(data)
mesh = sharding.make_mesh()
comp, totals = sharding.encode_mesh(mesh, blocks, lens)

# mesh decode round trip on the same global mesh
out, ok = sharding.decode_mesh(mesh, comp, totals, lens)
assert ok.all(), "mesh decode flagged corrupt blocks"
rec = b"".join(out[i, : lens[i]].tobytes() for i in range(len(lens)))
assert rec == data.tobytes(), "multi-process mesh round trip mismatch"

digest = hashlib.sha256()
for i in range(comp.shape[0]):
    digest.update(comp[i, : totals[i]].tobytes())

multihost_utils.sync_global_devices("done")
with open(os.path.join(outdir, f"digest_{proc_id}.txt"), "w") as f:
    f.write(digest.hexdigest())
print(f"proc {proc_id} OK", flush=True)
