"""Subprocess worker for the simulated multi-process test.

Each worker is one "host": it initializes jax.distributed against the
shared coordinator, contributes 4 virtual CPU devices to the global
mesh, materializes only its own chunk range of the genome, and runs the
full distributed pipeline.  Both workers must produce the identical
bit-exact region list (asserted by tests/test_multihost.py).
"""

import json
import os
import sys

port, pid, nproc, out_path = sys.argv[1:5]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    f"127.0.0.1:{port}", num_processes=int(nproc), process_id=int(pid))

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kmer_spans.parallel.multihost import (  # noqa: E402
    distributed_low_comp_regions,
)


def genome():
    rng = np.random.default_rng(5)
    n = 16384
    nb = rng.integers(0, 4, n, np.uint8)
    nb[3000:3400] = np.tile(np.array([1, 2], np.uint8), 200)
    nb[12000:12600] = np.tile(np.array([0, 3], np.uint8), 300)
    nb[8000:8040] = 4
    return nb


res = distributed_low_comp_regions(
    genome(), 5, 30, 5.0, thr=0.7, block=256, cand_blocks=8,
    bucket_cap=8192)
json.dump(
    {
        "process_id": int(pid),
        "n_processes": jax.process_count(),
        "n_devices": len(jax.devices()),
        "regions": [[int(a), int(b), int(c), float(d)]
                    for a, b, c, d in res.regions],
        "fallback": bool(res.fallback),
        "overflow": bool(res.overflow),
    },
    open(out_path, "w"),
)
