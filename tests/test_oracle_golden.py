"""Golden conformance vectors from SURVEY.md Appendix B and test.R hand traces.

These pin the sequential oracle to the probe-verified behavior of the
reference C core; the vectorized device path is then tested against the oracle.
"""

import numpy as np
import pytest

from kmer_spans.encoding import kmer_to_code
from kmer_spans.oracle import (
    count_spectrum,
    find_regions,
    find_tr_regions,
    weighted_ranks,
    windowed_distributions,
)
from kmer_spans.utils.testgen import spectrum_checksum


def test_golden_spectrum_k8(golden):
    counts, n = count_spectrum(golden, 8)
    assert n == 99_993
    assert spectrum_checksum(counts) == 6585132732039205817


def test_golden_spans_k8(golden):
    counts, n = count_spectrum(golden, 8)
    ranks = weighted_ranks(counts, float(n))
    regions = find_regions(golden, 0, 100, 20.0, ranks, 8, 0.75)
    expect = [
        (0, 20008, 20600, 137.923657),
        (0, 50008, 50900, 214.364008),
        (0, 80007, 80400, 96.947531),
    ]
    assert len(regions) == 3
    for got, exp in zip(regions, expect):
        assert got[:3] == exp[:3]
        assert round(got[3], 6) == exp[3]


def test_counting_basics():
    # SURVEY.md A.1 probe-verified vectors
    counts, n = count_spectrum("CGCCAATGCG", 2)
    assert n == 9
    exp = {"CG": 2, "GC": 2, "CC": 1, "CA": 1, "AA": 1, "AT": 1, "TG": 1}
    for kmer, c in exp.items():
        assert counts[kmer_to_code(kmer)] == c
    assert counts.sum() == 9


def test_counting_n_splits_words():
    counts, n = count_spectrum("ACGTACGTNNNNACGTACGT", 2)
    assert n == 14  # 7 + 7


def test_counting_n_doubling_property():
    # test.R:66-77 — counts(seq + N*36 + seq) == 2 * counts(seq)
    seq = "ACGGTTACGGATTTACCAGATT"
    c1, n1 = count_spectrum(seq, 3)
    c2, n2 = count_spectrum(seq + "N" * 36 + seq, 3)
    assert n2 == 2 * n1
    assert (c2 == 2 * c1).all()


def test_counting_non_acgtn():
    # "ACGWACGT" counts as ACG G ACGT (W encodes as G): AC:2 CG:2 GG:1 GA:1 GT:1
    counts, n = count_spectrum("ACGWACGT", 2)
    exp = {"AC": 2, "CG": 2, "GG": 1, "GA": 1, "GT": 1}
    for kmer, c in exp.items():
        assert counts[kmer_to_code(kmer)] == c
    assert counts.sum() == 7


def test_counting_lowercase():
    c1, _ = count_spectrum("ACGTACGT", 2)
    c2, _ = count_spectrum("acgtacgt", 2)
    assert (c1 == c2).all()


def test_counting_short_seq_contributes_nothing():
    counts, n = count_spectrum("AC", 3)
    assert n == 0 and counts.sum() == 0


def test_weighted_rank_tie_break():
    # SURVEY.md A.2 probe-verified: counts A=5,C=2,T=2,G=1, total 10
    # -> G:0, C:0.1, T:0.3, A:0.5   (k=1; index order A,C,T,G)
    counts = np.array([5, 2, 2, 1])
    ranks = weighted_ranks(counts, 10.0)
    assert ranks[3] == 0.0  # G (smallest nonzero also ranks 0)
    assert ranks[1] == pytest.approx(0.1)  # C
    assert ranks[2] == pytest.approx(0.3)  # T (tied count, higher index)
    assert ranks[0] == pytest.approx(0.5)  # A


def test_weighted_rank_zero_counts_rank_zero():
    counts = np.array([0, 3, 0, 7])
    ranks = weighted_ranks(counts, 10.0)
    assert ranks[0] == 0.0 and ranks[2] == 0.0
    assert ranks[1] == 0.0  # smallest nonzero ranks 0
    assert ranks[3] == pytest.approx(0.3)


def test_pure_repeat_self_referential_no_spans():
    # SURVEY.md A.2: AG*60, thr=0.5 -> 0 regions (self-mass keeps rank low)
    seq = "AG" * 60
    counts, n = count_spectrum(seq, 2)
    ranks = weighted_ranks(counts, float(n))
    regions = find_regions(seq, 0, 10, 5.0, ranks, 2, 0.5)
    assert regions == []


def test_tr_lr_cpg_vector():
    # SURVEY.md Appendix B CpG vector
    seq = "ATATATATCGCGCGCGCGCGATATATATATATATATCGCGCG"
    ks = np.full(16, -1.0)
    ks[kmer_to_code("CG")] = 2.0
    ts = np.full(16, -0.5)
    ts[kmer_to_code("CG")] = 2.0
    regions = find_tr_regions(seq, 1, 2, ks, ts, 4)
    assert len(regions) == 1
    seq_id, beg, end, score = regions[0]
    assert (seq_id, beg, end) == (1, 10, 20)
    assert score == pytest.approx(9.5)


def test_windowed_hand_trace_10bp():
    # test.R:373-401 hand trace, probe-verified (SURVEY §4.1)
    names = ["CG", "GC", "CC", "CA", "AA", "AT", "TG"]
    expect = {
        "CG": (3, 2), "GC": (1, 4), "CC": (2, 3), "CA": (1, 4),
        "AA": (0, 5), "AT": (1, 4), "TG": (2, 3),
    }
    tracked = np.array([kmer_to_code(x) for x in names])
    dist = windowed_distributions("CGCCAATGCG", tracked, 2, 6)
    for i, nm in enumerate(names):
        assert tuple(dist[:2, i]) == expect[nm], nm
        assert dist[2:, i].sum() == 0


def test_windowed_hand_trace_doubled_20bp():
    # test.R:406-439: the doubled 20-bp sequence, window=6, probe-verified
    # expected: CG: 6 6 3 / GC: 2 8 4 1 (dist rows = counts 0,1,2,...)
    seq = "CGCCAATGCG" * 2
    names = ["CG", "GC"]
    tracked = np.array([kmer_to_code(x) for x in names])
    dist = windowed_distributions(seq, tracked, 2, 6)
    assert tuple(dist[:4, 0]) == (6, 6, 3, 0)
    assert tuple(dist[:4, 1]) == (2, 8, 4, 1)
    assert dist[4:].sum() == 0


def test_windowed_per_position_counts():
    seq = "CGCCAATGCG"
    tracked = np.array([kmer_to_code("CG")])
    counts_pos = np.zeros((len(seq), 1), dtype=np.int64)
    windowed_distributions(seq, tracked, 2, 6, counts_pos=counts_pos)
    # windows start at 0..4; CG occurs in windows 0 (pos 0) and 4 (pos 8)
    assert list(counts_pos[:, 0]) == [1, 0, 0, 0, 1, 0, 0, 0, 0, 0]
