"""Streaming scoring variants (round-4 weak #7) + permissive-gate weight
screen (round-4 weak #8).

BASELINE config 4 requires streaming under all three README scoring
functions (README.md:25-54), not just rank; and the arbitrary-weight
device screen must survive min_score <= 0 without falling back to the
host (the reference kmer_regions contract, src/kmer_spans.c:490-546).
"""

import numpy as np
import pytest

from kmer_spans.models.scoring import (
    Log2MedianScoring,
    ThresholdScoring,
    WeightScoring,
)
from kmer_spans.oracle import count_spectrum, find_regions
from kmer_spans.parallel.stream import StreamingSpanPipeline

from conftest import random_seq
from test_stream import _chunks, _nbases


def _stream_with_model(seq, k, scoring, min_w, min_s, chunk=8192,
                       block=512):
    nb = _nbases(seq)
    pipe = StreamingSpanPipeline(
        k, chunk_bases=chunk, block=block, cand_blocks=32,
        margin_blocks=4)
    return pipe.run(_chunks(nb, chunk), 0.5, min_w, min_s,
                    scoring=scoring)


def _planted(seed, n=50_000):
    rng = np.random.default_rng(seed)
    seq = random_seq(rng, n, n_prob=0.003)
    s = list(seq)
    for pos in (7800, 16000, 30500, 40900):  # straddle 8192 chunk edges
        s[pos: pos + 700] = "AG" * 350
    return "".join(s)


def _check(seq, k, model, res, min_w, min_s):
    expect = find_regions(seq, 0, min_w, min_s, model.weights, k,
                          model.threshold)
    assert res.unresolved == []
    got = sorted((r[1], r[2]) for r in res.regions)
    exp = sorted((e[1], e[2]) for e in expect)
    assert got == exp
    gs = {(r[1], r[2]): r[3] for r in res.regions}
    for e in expect:
        assert gs[(e[1], e[2])] == e[3]  # bit-identical f64
    return expect


def test_stream_weight_scoring():
    """Arbitrary weights: reward AG/GA dimers, punish the rest."""
    k = 2
    seq = _planted(1)
    w = np.full(16, -0.6)
    from kmer_spans.encoding import kmer_to_code

    w[kmer_to_code("AG")] = 1.0
    w[kmer_to_code("GA")] = 1.0

    def scoring(counts, total):
        return WeightScoring(w)

    res = _stream_with_model(seq, k, scoring, 30, 5.0)
    expect = _check(seq, k, WeightScoring(w), res, 30, 5.0)
    assert len(expect) >= 3


def test_stream_threshold_scoring():
    # f_t above the uniform 4-mer frequency (1/256): background scores
    # -1, only the planted repeats' k-mers +1
    k = 4
    seq = _planted(2)

    def scoring(counts, total):
        return ThresholdScoring(counts, 6e-3)

    res = _stream_with_model(seq, k, scoring, 30, 5.0)
    counts, _ = count_spectrum(seq, k)
    expect = _check(seq, k, ThresholdScoring(counts, 6e-3), res, 30, 5.0)
    assert len(expect) >= 3


def test_stream_log2_median_scoring():
    # log2(f/f_med) with a positive threshold: raw log2-median scoring
    # sits at s ~ 0 for half of all positions by construction (the
    # weighted median), which no bounded-margin streaming can stitch —
    # the practical streaming parameterization subtracts a margin
    from kmer_spans.models.scoring import ScoringModel

    k = 4
    seq = _planted(3)

    def scoring(counts, total):
        m = Log2MedianScoring(counts)
        return ScoringModel(weights=m.weights, threshold=0.25)

    res = _stream_with_model(seq, k, scoring, 30, 10.0)
    counts, _ = count_spectrum(seq, k)
    m = Log2MedianScoring(counts)
    expect = _check(
        seq, k, ScoringModel(weights=m.weights, threshold=0.25), res,
        30, 10.0)
    assert len(expect) >= 3


def test_weight_screen_min_score_zero_no_fallback(monkeypatch):
    """kmer_regions with min_score=0 through the jax backend: candidate
    blocks beyond the speculative top-C are fetched by the exact
    post-candidacy pull — no host fallback, oracle-identical output."""
    import kmer_spans.api as api

    k = 3
    rng = np.random.default_rng(11)
    seq = random_seq(rng, 1_000_000, n_prob=0.001)
    s = list(seq)
    for pos in range(30_000, 960_000, 60_000):
        s[pos: pos + 400] = "CA" * 200
    seq = "".join(s)
    w = np.full(64, -0.4)
    from kmer_spans.encoding import kmer_to_code

    w[kmer_to_code("CAC")] = 1.0
    w[kmer_to_code("ACA")] = 1.0
    from kmer_spans.oracle import find_regions as oracle_find

    from kmer_spans.encoding import pack

    expect = oracle_find(pack(seq), 0, 50, 0.0, w, k, 0.0)
    assert len(expect) >= 16

    def boom(*a, **kw):
        raise AssertionError("host fallback used — pull path failed")

    monkeypatch.setattr(api.oracle, "find_regions", boom)
    res = api.kmer_regions([seq], k, w, min_width=50, min_score=0.0,
                           backend="jax")
    got = [(r["beg"], r["end"], r["score"]) for r in res.regions]
    assert got == [(e[1], e[2], e[3]) for e in expect]
