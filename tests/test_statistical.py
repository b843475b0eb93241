"""Statistical-model validation (SURVEY §4.4, mirroring test.R:167-348).

On an i.i.d. random sequence the occurrence count of a fixed k-mer in a
window of w bases is approximately Binomial(w - k + 1, p) with p = 4^-k
(slot dependencies are negligible for non-overlapping-prone k-mers).  The
windowed engine's empirical distribution must match in mean and variance.
"""

import numpy as np
import pytest

from kmer_spans import api

from conftest import random_seq


def test_window_distribution_binomial_moments():
    rng = np.random.default_rng(123)
    seq = random_seq(rng, 300_000)
    window, k = 128, 2
    # "AC" cannot overlap itself -> clean binomial approximation
    res = api.window_kmer_dist(seq, ["AC"], window, freq=False,
                               backend="host")
    dist = res.dist[:, 0].astype(np.float64)
    n_windows = dist.sum()
    counts = np.arange(dist.shape[0])
    mean = (counts * dist).sum() / n_windows
    var = ((counts - mean) ** 2 * dist).sum() / n_windows
    slots = window - k + 1
    p = 1 / 16
    exp_mean = slots * p
    exp_var = slots * p * (1 - p)
    assert mean == pytest.approx(exp_mean, rel=0.05)
    assert var == pytest.approx(exp_var, rel=0.15)


def test_count_frequencies_uniform():
    # i.i.d. uniform bases: every k-mer frequency ~ 4^-k
    rng = np.random.default_rng(42)
    seq = random_seq(rng, 400_000)
    res = api.kmer_counts(seq, 3, backend="host")
    f = res.f
    assert f.mean() == pytest.approx(1 / 64, rel=1e-6)
    assert f.max() < 2.0 / 64 and f.min() > 0.5 / 64


def test_self_referential_repeat_suppression():
    # SURVEY A.2: a pure repeat's own mass keeps its rank low — spans only
    # appear when the repeat is embedded in diverse background
    pure = "AG" * 2000
    res_pure = api.kmer_low_comp_regions(pure, 2, 10, 5.0, thr=0.5,
                                         backend="host")
    assert len(res_pure.regions) == 0
    rng = np.random.default_rng(9)
    embedded = random_seq(rng, 20_000) + "AG" * 200 + random_seq(rng, 20_000)
    res_emb = api.kmer_low_comp_regions(embedded, 2, 10, 5.0, thr=0.5,
                                        backend="host")
    assert len(res_emb.regions) >= 1
    # the island's region dominates every background excursion's score
    island = [r for r in res_emb.regions
              if r["beg"] < 20_400 and r["end"] > 20_000]
    assert island and max(r["score"] for r in island) > 3 * max(
        r["score"] for r in res_emb.regions if r["end"] <= 20_000)


def _rc_code(codes, k):
    """Reverse-complement in 2-bit space (A=0,C=1,T=2,G=3: comp = c^2)."""
    codes = np.asarray(codes)
    out = np.zeros_like(codes)
    for t in range(k):
        out = (out << 2) | (((codes >> (2 * t)) & 3) ^ 2)
    return out


def _markov_dimer_window(p1, p2, w):
    """Port of test.R:311-329 hetero.dn.markov.p: 3-state chain giving
    the probability of sitting at the second base of dimer n1n2 after w
    steps (states S / n1 / n2)."""
    m = np.zeros((w + 1, 3))
    m[0] = (1.0, 0.0, 0.0)
    p12 = p1 + p2
    for i in range(1, w + 1):
        s, n1, n2 = m[i - 1]
        m[i, 0] = s * (1 - p1) + n1 * (1 - p12) + n2 * (1 - p1)
        m[i, 1] = p1 * (s + n1 + n2)
        m[i, 2] = n1 * p2
    return m


def _skewed_seq(rng, n, probs):
    return "".join(rng.choice(list("ACTG"), size=n, p=probs))


def test_window_dist_markov_expectation():
    """test.R:167-348 Markov-conditional expectation: on a skewed i.i.d.
    sequence the windowed count of dimer 'AC' has mean
    (w-1) * P(n2 at a slot), with P(n2) from the 3-state Markov chain
    (which must itself converge to fA*fC)."""
    rng = np.random.default_rng(2024)
    probs = np.array([0.4, 0.1, 0.3, 0.2])  # A, C, T, G
    seq = _skewed_seq(rng, 2_000_000, probs)
    w = 200
    m = _markov_dimer_window(probs[0], probs[1], w)
    # the chain's stationary n2 probability is exactly fA*fC
    assert m[-1, 2] == pytest.approx(probs[0] * probs[1], rel=1e-6)
    res = api.window_kmer_dist(seq, ["AC"], w, freq=False, backend="host")
    dist = res.dist[:, 0].astype(np.float64)
    n_windows = dist.sum()
    counts = np.arange(dist.shape[0])
    mean = (counts * dist).sum() / n_windows
    exp_mean = (w - 1) * m[-1, 2]
    assert mean == pytest.approx(exp_mean, rel=0.02)


def test_inter_dimer_distance_geometric():
    """test.R:247-312: distances between same-parity occurrences of a
    non-self-overlapping dimer on an i.i.d. sequence follow the
    geometric distribution pmf p*(1-p)^(d-1) (d in dimer steps)."""
    from kmer_spans.encoding import kmer_codes_np, kmer_to_code, pack

    rng = np.random.default_rng(7)
    probs = np.array([0.3, 0.25, 0.25, 0.2])
    seq = _skewed_seq(rng, 4_000_000, probs)
    p = pack(seq)
    codes, valid = kmer_codes_np(p, 2)
    gc = kmer_to_code("GC")
    pos = np.nonzero(valid & (codes == gc))[0]
    pgc = probs[3] * probs[1]  # fG * fC
    for parity in (0, 1):
        d = np.diff(pos[pos % 2 == parity]) // 2
        assert d.size > 20_000
        dmax = 40
        emp = np.bincount(d, minlength=dmax + 1)[1:dmax + 1] / d.size
        # same-parity slots are 2 bases apart and a dimer never spans
        # two of them, so slot occupancy is iid Bernoulli(pgc) and gaps
        # are Geometric(pgc); compare truncated renormalized pmfs
        geo = pgc * (1 - pgc) ** (np.arange(1, dmax + 1) - 1.0)
        tv = 0.5 * np.abs(emp / emp.sum() - geo / geo.sum()).sum()
        assert tv < 0.03, (parity, tv)


def test_reverse_complement_count_symmetry():
    """test.R:584-590 RC symmetry, sharpened to an exact invariant: the
    spectrum of s + N + revcomp(s) is EXACTLY RC-symmetric; and on a
    plain random sequence counts agree with their RC within Poisson
    noise."""
    rng = np.random.default_rng(5)
    seq = random_seq(rng, 400_000)
    comp = {"A": "T", "T": "A", "C": "G", "G": "C"}
    rc = "".join(comp[c] for c in reversed(seq))
    k = 5
    res = api.kmer_counts(seq + "N" + rc, k, backend="host")
    counts = res.counts
    rc_codes = _rc_code(np.arange(1 << (2 * k)), k)
    assert np.array_equal(counts, counts[rc_codes])  # exact symmetry
    # statistical symmetry on the single strand (Poisson fluctuation)
    res1 = api.kmer_counts(seq, k, backend="host")
    c1 = res1.counts.astype(np.float64)
    diff = c1 - c1[rc_codes]
    denom = np.sqrt(np.maximum(c1 + c1[rc_codes], 1.0))
    z = diff / denom
    assert np.abs(z).mean() < 1.0  # ~half-normal mean 0.8
    assert np.abs(z).max() < 6.0
