"""Hash-sharded spectrum counting + distributed ranks (8 CPU devices)."""

import jax.numpy as jnp
import numpy as np
import pytest

from kmer_spans.encoding import pack
from kmer_spans.oracle import count_spectrum
from kmer_spans.parallel.pipeline import data_mesh
from kmer_spans.parallel.sharded import (
    make_sharded_count_step,
    make_sharded_rank_step,
)
from kmer_spans.stats.ranks import cumulative_mass

from conftest import random_seq


@pytest.fixture(scope="module")
def mesh():
    return data_mesh(8)


def _staged(seq, n_dev=8, block=512):
    p = pack(seq)
    gran = n_dev * block
    npad = -(-p.n // gran) * gran
    b = np.zeros(npad, np.uint8)
    b[: p.n] = p.bases
    v = np.zeros(npad, bool)
    v[: p.n] = p.valid
    return jnp.asarray(b), jnp.asarray(v)


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 6)])
def test_sharded_count_matches_oracle(mesh, seed, k):
    rng = np.random.default_rng(seed)
    seq = random_seq(rng, 30_000, n_prob=0.01)
    bases, valid = _staged(seq)
    step = make_sharded_count_step(mesh, k)
    with mesh:
        counts, overflow = step(bases, valid)
    assert not bool(overflow)
    oc, n = count_spectrum(seq, k)
    got = np.asarray(counts)
    assert got.shape == (1 << (2 * k),)
    assert (got == oc).all()


def test_sharded_count_overflow_detected(mesh):
    # all-same-kmer genome: every code goes to one shard -> tiny cap overflows
    seq = "A" * 8192
    bases, valid = _staged(seq)
    step = make_sharded_count_step(mesh, 4, bucket_cap=16)
    with mesh:
        counts, overflow = step(bases, valid)
    assert bool(overflow)


@pytest.mark.parametrize("seed,k", [(2, 4), (3, 5)])
def test_sharded_rank_mass_matches_host(mesh, seed, k):
    rng = np.random.default_rng(seed)
    seq = random_seq(rng, 20_000)
    bases, valid = _staged(seq)
    count_step = make_sharded_count_step(mesh, k)
    rank_step = make_sharded_rank_step(mesh, k)
    with mesh:
        counts, overflow = count_step(bases, valid)
        mass, clip = rank_step(counts)
    assert not bool(overflow) and not bool(clip)
    oc, n = count_spectrum(seq, k)
    expect = cumulative_mass(oc)
    got = np.asarray(mass)
    assert (got == expect).all()


def test_sharded_rank_clip_flag(mesh):
    rng = np.random.default_rng(5)
    seq = random_seq(rng, 40_000)
    bases, valid = _staged(seq)
    count_step = make_sharded_count_step(mesh, 2)  # tiny k: huge counts
    rank_step = make_sharded_rank_step(mesh, 2, vmax=16)
    with mesh:
        counts, _ = count_step(bases, valid)
        mass, clip = rank_step(counts)
    assert bool(clip)  # counts exceed vmax -> flagged, not silent
