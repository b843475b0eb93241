"""Simulated multi-process run: 2 jax.distributed CPU processes.

The reference's only parallel harness is a 20-core mclapply fork
(test.R:550-565); the device analog is jax.distributed over hosts.
This test spawns two REAL processes (4 virtual CPU devices each, Gloo
collectives), runs the full distributed pipeline — per-process chunk
materialization, sharded spectrum + wide rank, all-to-all mass fetch,
cross-process summary/candidate all_gather — and checks both processes
emit the identical region list, bit-exact against the sequential oracle.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from kmer_spans.oracle import find_regions, weighted_ranks
from kmer_spans.oracle.reference import count_spectrum

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_genome():
    rng = np.random.default_rng(5)
    n = 16384
    nb = rng.integers(0, 4, n, np.uint8)
    nb[3000:3400] = np.tile(np.array([1, 2], np.uint8), 200)
    nb[12000:12600] = np.tile(np.array([0, 3], np.uint8), 300)
    nb[8000:8040] = 4
    return nb


def test_two_process_distributed_pipeline(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(port), str(i), "2", str(outs[i])],
            env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        logs.append(se.decode(errors="replace")[-2000:])
        if p.returncode != 0:
            pytest.fail(f"worker failed rc={p.returncode}\n{logs[-1]}")

    res = [json.loads(o.read_text()) for o in outs]
    assert res[0]["n_processes"] == 2 and res[0]["n_devices"] == 8
    assert not res[0]["fallback"] and not res[0]["overflow"]
    # both processes computed the identical list
    assert res[0]["regions"] == res[1]["regions"]

    # bit-exact vs the sequential oracle
    nb = _worker_genome()
    seq = np.frombuffer(b"ACTGN", dtype=np.uint8)[
        np.minimum(nb, 4)].tobytes()
    counts, nw = count_spectrum(seq, 5)
    ranks = weighted_ranks(counts, float(nw))
    expect = find_regions(seq, 0, 30, 5.0, ranks, 5, 0.7)
    got = [(b, e, s) for _, b, e, s in res[0]["regions"]]
    want = [(b, e, s) for _, b, e, s in expect]
    assert got == want
    assert len(got) >= 2
