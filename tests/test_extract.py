"""Differential tests: vectorized span extraction vs the sequential oracle.

The extraction algorithm (excursion recursion, SURVEY A.4) must reproduce
the oracle's control-flow-faithful output bit-for-bit — regions, scores,
and the scan-count double-counting quirk — on adversarial random inputs.
"""

import numpy as np
import pytest

from kmer_spans.encoding import kmer_codes_np, pack
from kmer_spans.oracle import count_spectrum, find_regions, weighted_ranks
from kmer_spans.spans.extract import extract_spans

from conftest import random_seq


def _host_pipeline(seq, k, min_width, min_score, weights, threshold,
                   want_counts=False):
    """Exact host path mirroring the jax backend's extraction."""
    p = pack(seq)
    codes, kmer_valid = kmer_codes_np(p, k)
    nv = np.zeros(p.n, bool)
    nv[:-1] = p.valid[1:]
    scored = kmer_valid & nv
    s = np.where(scored, weights[codes] - threshold, 0.0)
    visits = np.zeros(p.n + 1, dtype=np.int64) if want_counts else None
    regions = extract_spans(s, scored, min_width, min_score, seq_id=0,
                            visits_full=visits)
    counts = None
    if want_counts:
        mult = np.cumsum(visits[:-1])
        sel = mult > 0
        counts = np.bincount(codes[sel], weights=mult[sel],
                             minlength=1 << (2 * k)).astype(np.int64)
    return regions, counts


@pytest.mark.parametrize("seed", range(8))
def test_extract_matches_oracle_random(seed):
    rng = np.random.default_rng(seed)
    # biased alphabet -> repeat-rich -> many excursions; sprinkle Ns
    seq = random_seq(rng, 5000, n_prob=0.01)
    k = 3
    counts, n = count_spectrum(seq, k)
    ranks = weighted_ranks(counts, float(n))
    for thr, mw, ms in [(0.5, 5, 2.0), (0.75, 3, 0.5), (0.25, 0, 0.0)]:
        oracle_regions = find_regions(seq, 0, mw, ms, ranks, k, thr)
        got, _ = _host_pipeline(seq, k, mw, ms, ranks, thr)
        assert len(got) == len(oracle_regions), (thr, mw, ms)
        for g, o in zip(got, oracle_regions):
            assert g[:3] == o[:3]
            assert g[3] == o[3]  # bit-identical f64 score


@pytest.mark.parametrize("seed", range(4))
def test_extract_scan_counts_match_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    seq = random_seq(rng, 3000, n_prob=0.02)
    k = 2
    size = 1 << (2 * k)
    # arbitrary weights with positives to force emissions and rescans
    weights = rng.normal(0.2, 1.0, size=size)
    oracle_counts = np.zeros(size, dtype=np.int64)
    oracle_regions = find_regions(seq, 0, 2, 0.5, weights, k, 0.0,
                                  scan_counts=oracle_counts)
    got, got_counts = _host_pipeline(seq, k, 2, 0.5, weights, 0.0,
                                     want_counts=True)
    assert len(got) == len(oracle_regions)
    for g, o in zip(got, oracle_regions):
        assert g[:3] == o[:3] and g[3] == o[3]
    assert (got_counts == oracle_counts).all()


def test_extract_repeat_heavy():
    # dense emissions: repeated islands in low-weight background
    seq = ("ACGTT" * 40 + "AGAGAGAGAGAGAGAGAGAG" * 3) * 5 + "N" * 10 + "AG" * 50
    k = 2
    counts, n = count_spectrum(seq, k)
    ranks = weighted_ranks(counts, float(n))
    for thr in (0.3, 0.5, 0.7):
        oracle_regions = find_regions(seq, 0, 4, 1.0, ranks, k, thr)
        got, _ = _host_pipeline(seq, k, 4, 1.0, ranks, thr)
        assert [g[:3] for g in got] == [o[:3] for o in oracle_regions]
        assert [g[3] for g in got] == [o[3] for o in oracle_regions]


def test_extract_golden(golden):
    counts, n = count_spectrum(golden, 8)
    ranks = weighted_ranks(counts, float(n))
    got, _ = _host_pipeline(golden, 8, 100, 20.0, ranks, 0.75)
    assert [g[:3] for g in got] == [
        (0, 20008, 20600), (0, 50008, 50900), (0, 80007, 80400)]
    assert [round(g[3], 6) for g in got] == [137.923657, 214.364008, 96.947531]


@pytest.mark.parametrize("seed", range(4))
def test_extract_integer_weights_exact_zero_semantics(seed):
    """Integer weights make exact-zero scores and ties common — the
    score==0 crossing and s>0 strictness semantics must hold exactly."""
    rng = np.random.default_rng(200 + seed)
    seq = random_seq(rng, 4000, n_prob=0.01)
    k = 2
    weights = rng.choice([-1.0, 0.0, 1.0, 2.0], size=16,
                         p=[0.4, 0.25, 0.25, 0.1])
    for mw, ms in [(3, 2.0), (0, 0.0), (5, -1.0)]:
        expect = find_regions(seq, 0, mw, ms, weights, k, 0.0)
        got, _ = _host_pipeline(seq, k, mw, ms, weights, 0.0)
        assert [g[:4] for g in got] == [e[:4] for e in expect], (mw, ms)


def test_extract_all_zero_weights():
    # s == 0 everywhere: no excursion ever starts (score>0 strict)
    seq = "ACGT" * 500
    got, _ = _host_pipeline(seq, 2, 0, 0.0, np.zeros(16), 0.0)
    expect = find_regions(seq, 0, 0, 0.0, np.zeros(16), 2, 0.0)
    assert got == [] and expect == []
