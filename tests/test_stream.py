"""Streaming chunked pipeline vs oracle (stitching across chunk edges)."""

import numpy as np
import pytest

from kmer_spans.encoding import pack
from kmer_spans.oracle import count_spectrum, find_regions
from kmer_spans.parallel.stream import StreamingSpanPipeline
from kmer_spans.stats.ranks import cumulative_mass

from conftest import random_seq


def _nbases(seq):
    p = pack(seq)
    nb = p.bases.copy()
    nb[~p.valid] = 4
    return nb


def _chunks(nb_arr, chunk):
    def factory():
        for i in range(0, len(nb_arr), chunk):
            yield nb_arr[i : i + chunk]
    return factory


def _mass_rank_regions(seq, k, thr, min_w, min_s):
    counts, n = count_spectrum(seq, k)
    ranks = cumulative_mass(counts).astype(np.float64) / float(n)
    return find_regions(seq, 0, min_w, min_s, ranks, k, thr)


def _run_stream(seq, k, thr, min_w, min_s, chunk_bases, block, cand=32,
                margin=4):
    nb = _nbases(seq)
    pipe = StreamingSpanPipeline(
        k, chunk_bases=chunk_bases, block=block,
        cand_blocks=cand, margin_blocks=margin,
    )
    return pipe.run(_chunks(nb, chunk_bases), thr, min_w, min_s)


@pytest.mark.parametrize("seed", range(3))
def test_stream_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    seq = random_seq(rng, 50_000, n_prob=0.005)
    s = list(seq)
    # islands deliberately placed across the 8192-base chunk boundaries
    for pos in (7800, 16000, 24200, 40900):
        s[pos : pos + 700] = "AG" * 350
    seq = "".join(s)
    k, thr, mw, ms = 4, 0.75, 30, 5.0
    res = _run_stream(seq, k, thr, mw, ms, chunk_bases=8192, block=512)
    assert res.unresolved == []
    expect = _mass_rank_regions(seq, k, thr, mw, ms)
    got = sorted((r[1], r[2]) for r in res.regions)
    exp = sorted((e[1], e[2]) for e in expect)
    assert got == exp
    gs = {(r[1], r[2]): r[3] for r in res.regions}
    for e in expect:
        assert gs[(e[1], e[2])] == pytest.approx(e[3], rel=1e-9)
    assert res.n_kmers == count_spectrum(seq, k)[1]


def test_stream_island_straddling_boundary_exactly():
    rng = np.random.default_rng(7)
    seq = random_seq(rng, 20_000)
    s = list(seq)
    s[8000:8500] = "TC" * 250  # covers the 8192 chunk edge
    seq = "".join(s)
    res = _run_stream(seq, 3, 0.7, 20, 3.0, chunk_bases=8192, block=512)
    assert res.unresolved == []
    expect = _mass_rank_regions(seq, 3, 0.7, 20, 3.0)
    assert sorted((r[1], r[2]) for r in res.regions) == sorted(
        (e[1], e[2]) for e in expect)
    assert any(r[1] < 8192 < r[2] for r in res.regions)


def test_stream_n_gap_at_boundary():
    rng = np.random.default_rng(8)
    seq = random_seq(rng, 20_000)
    s = list(seq)
    s[8100:8300] = "N" * 200
    s[9000:9400] = "GA" * 200
    seq = "".join(s)
    res = _run_stream(seq, 3, 0.7, 20, 3.0, chunk_bases=8192, block=512)
    expect = _mass_rank_regions(seq, 3, 0.7, 20, 3.0)
    assert sorted((r[1], r[2]) for r in res.regions) == sorted(
        (e[1], e[2]) for e in expect)


def test_stream_single_chunk_genome(golden):
    # whole genome fits in one chunk: must equal the non-streamed pipeline
    res = _run_stream(golden, 8, 0.75, 100, 20.0,
                      chunk_bases=1 << 17, block=1024, cand=64, margin=8)
    assert res.unresolved == []
    assert [(r[1], r[2]) for r in res.regions] == [
        (20008, 20600), (50008, 50900), (80007, 80400)]


def test_stream_64mb_matches_native():
    """Scale differential at 64 Mb (round-2 directive: the biggest prior
    test was 2 Mb): stresses int32 block-count boundaries, chunk
    stitching across 16 chunks, and an N gap straddling a chunk edge.
    Spans AND scores must equal the native oracle exactly (~60 s)."""
    from kmer_spans.oracle import weighted_ranks
    from kmer_spans.utils import native

    N = 64 * 1024 * 1024
    rng = np.random.default_rng(42)
    g = rng.integers(0, 4, N, dtype=np.uint8)
    for s in range(3_000_000, N - 4000, 9_000_000):
        g[s:s + 3000] = np.tile(np.array([0, 3], np.uint8), 1500)
    g[33_554_431:33_554_631] = 4  # N gap straddling the chunk boundary

    def chunks():
        for i in range(0, N, 1 << 22):
            yield g[i:i + (1 << 22)]

    pipe = StreamingSpanPipeline(8, chunk_bases=1 << 22, block=8192,
                                 cand_blocks=96, margin_blocks=8)
    res = pipe.run(chunks, 0.75, 100, 20.0)
    assert res.unresolved == []
    counts, nw = native.count_spectrum(g, 8)
    assert res.n_kmers == nw
    ranks = weighted_ranks(counts, float(nw))
    beg, end, score, _ = native.find_spans(g, 8, ranks, 0.75, 100, 20.0)
    got = [(r[1], r[2], r[3]) for r in res.regions]
    want = [(int(b), int(e), float(s)) for b, e, s in
            zip(beg, end, score)]
    assert got == want
    assert len(got) >= 5


def test_stream_k11_rowgather_screen():
    """k >= 10 streaming goes through the uint8 row-gather screen
    (ops/rowgather.py); spans must match the oracle across chunk
    boundaries exactly like the k <= 9 class screen."""
    rng = np.random.default_rng(77)
    seq = random_seq(rng, 60_000, n_prob=0.004)
    s = list(seq)
    for pos in (7900, 24300, 47800):  # straddle the 8192-chunk boundaries
        s[pos : pos + 700] = "AG" * 350
    s[33000:33600] = "CCTGA" * 120
    seq = "".join(s)
    k, thr, mw, ms = 11, 0.75, 30, 5.0
    res = _run_stream(seq, k, thr, mw, ms, chunk_bases=8192, block=512,
                      cand=32, margin=8)
    assert res.unresolved == []
    expect = _mass_rank_regions(seq, k, thr, mw, ms)
    assert len(expect) >= 3
    got = sorted((r[1], r[2]) for r in res.regions)
    exp = sorted((e[1], e[2]) for e in expect)
    assert got == exp
