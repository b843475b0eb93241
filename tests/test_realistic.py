"""Realistic-composition genome validation (test.R:104-106, :572-590).

The reference validates counts and spans on a real assembly; this
environment has no network, so utils.testgen.realistic_genome builds the
closest stand-in (Markov chain with human-like GC and CpG depletion +
Alu-like dispersed repeats, microsatellites, poly-A, N gaps) and the
pipelines are cross-validated on it: counts via three independent
implementations, spans device vs sequential oracle, bit-identical.
"""

import numpy as np
import pytest

from kmer_spans import api
from kmer_spans.encoding import PackedSeq, kmer_to_code
from kmer_spans.utils.testgen import realistic_genome


@pytest.fixture(scope="module")
def genome():
    return realistic_genome(1_500_000, seed=7)


def _packed(nb):
    return PackedSeq(bases=np.where(nb == 4, 0, nb).astype(np.uint8),
                     valid=nb != 4)


def test_composition_and_cpg_depletion(genome):
    p = _packed(genome)
    res = api.kmer_counts(p, 2, with_f=True, backend="host")
    counts = res.counts.astype(np.float64)
    total = counts.sum()
    # mononucleotide marginals: GC ~ 41%
    mono = np.zeros(4)
    for c in range(16):
        mono[c >> 2] += counts[c] / 2
        mono[c & 3] += counts[c] / 2
    mono /= mono.sum()
    gc = mono[1] + mono[3]
    assert 0.36 < gc < 0.46
    # CpG obs/exp ~ the configured depletion
    cg = counts[kmer_to_code("CG")] / total
    exp = mono[1] * mono[3]
    assert 0.1 < cg / exp < 0.4


def test_counts_cross_validated_three_ways(genome):
    """oracle (numpy segment decomposition) == native C walker == device
    histogram counter — exact equality on realistic input."""
    from kmer_spans.oracle import count_spectrum
    from kmer_spans.utils import native

    p = _packed(genome)
    k = 6
    res_o = api.kmer_counts(p, k, backend="host")
    res_d = api.kmer_counts(p, k, backend="jax")
    assert np.array_equal(res_o.counts, res_d.counts)
    if native.available():
        nb = genome.copy()
        counts_n, nw = native.host_spectrum(nb, k)
        assert np.array_equal(res_o.counts, counts_n)
        assert nw == int(res_o.counts.sum())


def test_spans_device_vs_oracle(genome):
    """Flagship rank spans, device fast path vs exact host — identical
    regions on realistic repeat structure (must find the planted
    microsatellites)."""
    p = _packed(genome)
    k = 8
    fast = api.kmer_low_comp_regions(p, k, 100, 20.0, thr=0.75,
                                     backend="jax", mode="fast")
    exact = api.kmer_low_comp_regions(p, k, 100, 20.0, thr=0.75,
                                      backend="host", mode="exact")
    got = [(r["beg"], r["end"], r["score"]) for r in fast.regions]
    want = [(r["beg"], r["end"], r["score"]) for r in exact.regions]
    assert got == want
    assert len(got) >= 2
    # the (AC)n microsatellite at 200k must be called
    assert any(b <= 200_101 and e >= 200_200 for b, e, _ in got)


def test_spans_pm_path_vs_oracle_k12(genome):
    """The device-complete pm pipeline on realistic composition (CpG
    depletion + repeat families) — identical to the exact host path."""
    p = _packed(genome)
    k = 12
    fast = api.kmer_low_comp_regions(p, k, 100, 20.0, thr=0.75,
                                     backend="jax", mode="fast")
    exact = api.kmer_low_comp_regions(p, k, 100, 20.0, thr=0.75,
                                      backend="host", mode="exact")
    got = [(r["beg"], r["end"], r["score"]) for r in fast.regions]
    want = [(r["beg"], r["end"], r["score"]) for r in exact.regions]
    assert got == want
    assert len(got) >= 1
