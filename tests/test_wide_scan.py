"""Sharded SPARSE-spectrum wide-k scan (parallel/wide_scan.py).

BASELINE config 5: k=17 on an 8-virtual-device mesh — the spectrum
exists only as exchanged sorted runs (O(n/device) memory, no 4^k
anywhere); spans must match the sequential oracle bit for bit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from kmer_spans.oracle import find_regions
from kmer_spans.oracle.reference import count_spectrum_sparse
from kmer_spans.parallel.wide_scan import wide_low_comp_regions
from kmer_spans.stats.ranks import SparseRanks

from conftest import random_seq
from test_span_pipeline import _nbases
from test_sortscreen import _plant


def mesh8():
    return Mesh(np.array(jax.devices()[:8]), ("data",))


def _wide_genome(k, n=80_000, seed=1700):
    rng = np.random.default_rng(seed + k)
    return _plant(
        random_seq(rng, n, n_prob=0.002),
        [(8_000, "AG", 700), (34_000, "CCTGA", 300),
         (60_000, "GATTACA", 180)],
    )


@pytest.mark.parametrize("k", [16, 17])
def test_wide_sharded_matches_oracle(k):
    seq = _wide_genome(k)
    nb = _nbases(seq)
    thr, min_w, min_s = 0.75, 30, 5.0
    res = wide_low_comp_regions(
        mesh8(), nb, k, min_w, min_s, thr=thr, block=512, cand_blocks=16)
    assert not res.overflow and not res.fallback
    assert res.devices == 8
    ucodes, ucounts, _ = count_spectrum_sparse(seq, k)
    sr = SparseRanks(ucodes, ucounts)
    expect = find_regions(seq, 0, min_w, min_s, sr, k, thr)
    assert len(expect) >= 3
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


def test_wide_sharded_matches_single_chip_pipeline():
    """Mesh result == single-chip wide pipeline result (same finisher
    discipline, different screen plumbing) at k=17."""
    from kmer_spans.spans.pipeline import (
        finish_wide_spans,
        make_wide_span_pipeline,
        unpack_wide_outputs,
    )

    k = 17
    seq = _wide_genome(k, seed=23)
    nb = _nbases(seq)
    thr, min_w, min_s = 0.72, 30, 5.0
    res = wide_low_comp_regions(
        mesh8(), nb, k, min_w, min_s, thr=thr, block=512, cand_blocks=16)
    assert not res.overflow and not res.fallback

    block, cand = 1024, 64
    n = -(-len(nb) // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    fn = make_wide_span_pipeline(k, block=block, cand_blocks=cand)
    v = np.asarray(fn(jnp.asarray(arr), jnp.float32(thr)))
    got = unpack_wide_outputs(v, n, block, cand)
    spectrum = count_spectrum_sparse(seq, k)
    single = finish_wide_spans(
        got, n, k, thr, min_w, min_s, spectrum, block=block)
    assert not single.fallback
    assert res.regions == single.regions
    assert len(res.regions) >= 2


def test_wide_sharded_overflow_flagged():
    """A run-exchange bucket cap far below the distinct-code count must
    FLAG overflow (never silently drop)."""
    k = 17
    seq = _wide_genome(k, n=40_000, seed=5)
    nb = _nbases(seq)
    res = wide_low_comp_regions(
        mesh8(), nb, k, 30, 5.0, thr=0.75, block=512, cand_blocks=16,
        bucket_cap=16)
    assert res.overflow
