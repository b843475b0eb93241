"""Multi-chip pipeline (8 virtual CPU devices) vs single-device/oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmer_spans.encoding import pack
from kmer_spans.oracle import count_spectrum, weighted_ranks
from kmer_spans.parallel.pipeline import data_mesh, make_pipeline_step
from kmer_spans.stats.ranks import cumulative_mass

from conftest import random_seq


@pytest.fixture(scope="module")
def mesh():
    return data_mesh(8)


def _run(mesh, seq, k, thr):
    p = pack(seq)
    n_dev = 8
    npad = -(-p.n // (n_dev * 64)) * (n_dev * 64)
    bases = np.zeros(npad, np.uint8)
    bases[: p.n] = p.bases
    valid = np.zeros(npad, bool)
    valid[: p.n] = p.valid
    step = make_pipeline_step(mesh, k)
    with mesh:
        counts, S, scored = step(
            jnp.asarray(bases), jnp.asarray(valid), jnp.float32(thr)
        )
    return (
        np.asarray(counts),
        np.asarray(S)[: p.n],
        np.asarray(scored)[: p.n],
        p,
    )


@pytest.mark.parametrize("seed,k,thr", [(0, 4, 0.5), (1, 6, 0.75), (2, 2, 0.3)])
def test_sharded_pipeline_matches_oracle(mesh, seed, k, thr):
    rng = np.random.default_rng(seed)
    seq = random_seq(rng, 20_000, n_prob=0.01)
    counts, S, scored, p = _run(mesh, seq, k, thr)

    oc, n = count_spectrum(seq, k)
    assert (counts == oc).all(), "psum'd sharded spectrum != oracle"

    # scored mask parity: segment ends/warm-ups/terminator all excluded
    from kmer_spans.encoding import kmer_codes_np

    codes_h, kv = kmer_codes_np(p, k)
    nv = np.zeros(p.n, bool)
    nv[:-1] = p.valid[1:]
    assert (scored == (kv & nv)).all()

    # S sign structure must match the exact host scan (positive mask drives
    # extraction; integer-mass scoring makes each s_i's sign exact)
    ranks = weighted_ranks(oc, float(n))
    s_exact = np.where(scored, ranks[codes_h] - thr, 0.0)
    S_ref = np.zeros(p.n)
    prev = 0.0
    for i in range(p.n):
        prev = max(prev + s_exact[i], 0.0) if scored[i] else 0.0
        S_ref[i] = prev
    np.testing.assert_allclose(S, S_ref, rtol=2e-4, atol=2e-4)
    assert ((S > 1e-4) == (S_ref > 1e-4)).mean() > 0.999


def test_sharded_mass_equals_host_mass(mesh):
    rng = np.random.default_rng(5)
    seq = random_seq(rng, 8_000)
    k = 3
    counts, S, scored, p = _run(mesh, seq, k, 0.5)
    oc, _ = count_spectrum(seq, k)
    # device _rank_mass must equal the exact host integer mass
    from kmer_spans.parallel.pipeline import _rank_mass

    dev_mass = np.asarray(_rank_mass(jnp.asarray(oc.astype(np.int32))))
    host_mass = cumulative_mass(oc)
    assert (dev_mass == host_mass).all()


def test_graft_entry_points():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out[0].shape == (1 << 16,)
    ge.dryrun_multichip(8)
