"""Large-scale differential: every pipeline flavor on a 2M-base genome.

Exercises block/chunk boundaries, candidate compaction, and stitching at a
scale where off-by-one-block bugs actually fire; the native C++ oracle is
the independent referee.
"""

import numpy as np
import pytest

from kmer_spans import api
from kmer_spans.encoding import pack
from kmer_spans.oracle import weighted_ranks
from kmer_spans.parallel.stream import StreamingSpanPipeline
from kmer_spans.stats.ranks import cumulative_mass
from kmer_spans.utils import native

N = 2_000_000
K = 8
MW, MS, THR = 100, 20.0, 0.75


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(77)
    raw = rng.integers(0, 4, N, dtype=np.uint8)
    # repeat islands of several kinds, some straddling 8192-block edges
    for start, unit in [(100_000, [0, 3]), (524_200, [1, 0, 3]),
                        (1_048_500, [2]), (1_572_860, [0, 1, 2, 3, 3, 1])]:
        rep = np.tile(np.array(unit, np.uint8), 3000 // len(unit) + 1)
        raw[start : start + 3000] = rep[:3000]
    # N gaps, one at a block boundary
    raw[700_000:700_200] = 4
    raw[1_310_720 - 50 : 1_310_720 + 50] = 4
    return raw


@pytest.fixture(scope="module")
def expected(genome):
    counts, nw = native.count_spectrum(genome, K)
    ranks = weighted_ranks(counts, float(nw))
    beg, end, score, _ = native.find_spans(genome, K, ranks, THR, MW, MS)
    return counts, nw, list(zip(beg, end, score))


def test_native_agrees_with_api_host(genome, expected):
    counts, nw, regions = expected
    seq_bytes = np.frombuffer(b"ACTGN", dtype=np.uint8)[
        np.minimum(genome, 4)].tobytes()
    res = api.kmer_low_comp_regions(seq_bytes, K, MW, MS, thr=THR,
                                    backend="host")
    assert res.n[0] == nw
    assert (res.counts == counts).all()
    assert len(res.regions) == len(regions)
    for got, (b, e, s) in zip(res.regions, regions):
        assert (got["beg"], got["end"]) == (b, e)
        assert got["score"] == s  # bit-identical f64


def test_fast_mode_matches_native(genome, expected):
    counts, nw, regions = expected
    seq_bytes = np.frombuffer(b"ACTGN", dtype=np.uint8)[
        np.minimum(genome, 4)].tobytes()
    res = api.kmer_low_comp_regions(seq_bytes, K, MW, MS, thr=THR,
                                    backend="jax", mode="fast")
    assert len(res.regions) == len(regions)
    for got, (b, e, s) in zip(res.regions, regions):
        assert (got["beg"], got["end"]) == (b, e)
        assert got["score"] == s  # bit-identical f64 (rank-chain replay)


def test_stream_matches_native(genome, expected):
    counts, nw, regions = expected

    def chunks():
        for i in range(0, N, 1 << 18):
            yield genome[i : i + (1 << 18)]

    pipe = StreamingSpanPipeline(K, chunk_bases=1 << 18, block=4096,
                                 cand_blocks=64, margin_blocks=8)
    res = pipe.run(chunks, THR, MW, MS)
    assert res.unresolved == []
    assert res.n_kmers == nw
    assert [(r[1], r[2]) for r in res.regions] == [
        (b, e) for b, e, _ in regions]
    for r, (_, _, s) in zip(res.regions, regions):
        assert r[3] == s  # bit-identical f64 (rank-chain replay)
