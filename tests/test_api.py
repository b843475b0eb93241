"""API-level tests: R-layer parity, backend bit-identity, file round-trips."""

import numpy as np
import pytest

from kmer_spans import api
from kmer_spans.encoding import kmer_to_code
from kmer_spans.models.scoring import Log2MedianScoring
from kmer_spans.utils.testgen import spectrum_checksum

from conftest import random_seq


def test_kmer_counts_backends_identical(golden):
    h = api.kmer_counts(golden, 8, backend="host")
    j = api.kmer_counts(golden, 8, backend="jax")
    assert h.n == j.n == 99_993
    assert (h.counts == j.counts).all()
    assert spectrum_checksum(j.counts) == 6585132732039205817
    np.testing.assert_allclose(h.f, j.f)


def test_kmer_counts_skips_short_seqs():
    r = api.kmer_counts(["ACGTACGT", "AC"], 3, backend="host")
    r2 = api.kmer_counts(["ACGTACGT"], 3, backend="host")
    assert r.n == r2.n and (r.counts == r2.counts).all()


def test_low_comp_regions_golden_both_backends(golden):
    for backend in ("host", "jax"):
        res = api.kmer_low_comp_regions(
            golden, 8, 100, 20.0, thr=0.75, backend=backend
        )
        regs = res.regions
        assert len(regs) == 3
        assert list(regs["beg"]) == [20008, 50008, 80007]
        assert list(regs["end"]) == [20600, 50900, 80400]
        assert [round(s, 6) for s in regs["score"]] == [
            137.923657, 214.364008, 96.947531]
        assert (regs["entropy"] == 0).all()
        assert res.n[0] == 99_993 and res.n[1] == 0


def test_low_comp_backends_bit_identical(rng):
    seqs = [random_seq(rng, 4000, n_prob=0.01) for _ in range(3)]
    h = api.kmer_low_comp_regions(seqs, 4, 10, 1.0, thr=0.5, backend="host")
    j = api.kmer_low_comp_regions(seqs, 4, 10, 1.0, thr=0.5, backend="jax")
    assert (h.regions == j.regions).all()
    assert (h.counts == j.counts).all()
    np.testing.assert_array_equal(h.w_rank, j.w_rank)


def test_kmer_regions_cpg_weights():
    # CpG calling via arbitrary weights (kmer_spans.R:29-34 use case)
    seq = "ATATATAT" + "CG" * 10 + "ATATATATATAT"
    scores = {km: (3.0 if km == "CG" else -1.0) for km in api.kmer_seq(2)}
    for backend in ("host", "jax"):
        res = api.kmer_regions(seq, 2, scores, 4, 5.0, backend=backend)
        assert len(res.regions) == 1
        assert res.n[0] == len(seq)
        # scan counts cover every scanned position (incl. rescans)
        assert res.counts.sum() >= len(seq) - 2


def test_kmer_regions_backends_scan_counts_identical(rng):
    seqs = [random_seq(rng, 2000, n_prob=0.02) for _ in range(2)]
    size = 16
    w = dict(zip(api.kmer_seq(2), rng.normal(0.3, 1.0, size=size)))
    h = api.kmer_regions(seqs, 2, w, 2, 0.5, backend="host")
    j = api.kmer_regions(seqs, 2, w, 2, 0.5, backend="jax")
    assert (h.regions == j.regions).all()
    assert (h.counts == j.counts).all()


def test_kmer_regions_validates_scores():
    with pytest.raises(ValueError):
        api.kmer_regions("ACGT", 2, {"AA": 1.0}, 1, 1.0, backend="host")


def test_lr_regions_api():
    seq = "ATATATATCGCGCGCGCGCGATATATATATATATATCGCGCG"
    kmers = api.kmer_seq(2)
    ks = [2.0 if km == "CG" else -1.0 for km in kmers]
    ts = [2.0 if km == "CG" else -0.5 for km in kmers]
    res = api.lr_regions(seq, (2, 4), kmers, ks, ts)
    assert len(res.regions) == 1
    r = res.regions[0]
    assert (r["seq_id"], r["beg"], r["end"]) == (1, 10, 20)
    assert r["score"] == pytest.approx(9.5)
    # reordered table sanity: CG row holds (2.0, 2.0)
    cg = kmer_to_code("CG")
    assert tuple(res.kmer_scores[cg]) == (2.0, 2.0)


def test_lr_regions_alphabetical_order_reorder():
    # score tables given in alphabetical (Biostrings-like) order must be
    # reordered into 2-bit order (reference :686-694)
    seq = "ATATATATCGCGCGCGCGCGATATATATATATATATCGCGCG"
    kmers = sorted(api.kmer_seq(2))
    ks = [2.0 if km == "CG" else -1.0 for km in kmers]
    ts = [2.0 if km == "CG" else -0.5 for km in kmers]
    res = api.lr_regions(seq, (2, 4), kmers, ks, ts)
    assert len(res.regions) == 1
    assert res.regions[0]["beg"] == 10


def test_window_kmer_dist_api():
    res = api.window_kmer_dist(
        ["CGCCAATGCG", "AC"], ["CG", "GC"], 6, freq=False, ret_flag=1
    )
    assert tuple(res.dist[:2, 0]) == (3, 2)
    assert tuple(res.dist[:2, 1]) == (1, 4)
    assert list(res.seq_i) == [1, 0]  # second seq shorter than window
    assert res.scores[0] is not None and res.scores[1] is None
    assert list(res.scores[0][:, 0][:5]) == [1, 0, 0, 0, 1]


def test_window_kmer_dist_freq_normalization():
    res = api.window_kmer_dist("CGCCAATGCG", ["CG"], 6, freq=True)
    assert res.dist[:, 0].sum() == pytest.approx(1.0)


def test_window_kmer_dist_validation():
    with pytest.raises(ValueError):
        api.window_kmer_dist("ACGTACGT", ["CG", "CGG"], 6)
    with pytest.raises(ValueError):
        api.window_kmer_dist("ACGTACGT", ["CG"], 3)  # window < 2k


def test_spectrum_file_roundtrip(tmp_path, golden):
    from kmer_spans.io.fasta import write_fasta

    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", golden)])
    out = api.kmers_to_file(str(fa), str(tmp_path) + "/", [2, 8], min_l=1000)
    assert out[1] is not None
    back = api.read_kmers(out[1])
    assert back["k"] == [2, 8]
    h = api.kmer_counts(golden, 8, backend="host")
    assert (back["counts"][1] == h.counts).all()
    assert spectrum_checksum(back["counts"][1]) == 6585132732039205817


def test_read_kmers_bad_magic(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"\x00" * 16)
    assert api.read_kmers(str(p)) is None


def test_fasta_reader(tmp_path):
    p = tmp_path / "t.fa"
    p.write_bytes(b">s1 descr\nACGT\nACGT\n>s2\nNNAC\n")
    from kmer_spans.io.fasta import read_fasta

    recs = read_fasta(str(p))
    assert recs == [("s1", b"ACGTACGT"), ("s2", b"NNAC")]


def test_kmer_spans_scoring_variants(golden):
    # rank == kmer_low_comp_regions
    r = api.kmer_spans(golden, 8, scoring="rank", min_width=100,
                       min_score=20.0, thr=0.75, backend="host")
    assert list(r.regions["beg"]) == [20008, 50008, 80007]
    # threshold scoring with a discriminating f_t (only repeat k-mers are
    # more frequent than 10/total) isolates the planted islands
    t = api.kmer_spans(golden, 8, scoring="threshold", min_width=100,
                       min_score=50.0, f_t=10 / 99_993, backend="host")
    assert list(t.regions["beg"]) == [20008, 50008, 80007]
    assert list(t.regions["end"]) == [20600, 50900, 80400]


def test_log2_median_model():
    # README.md:27-32: s = log2(f_i / f_med); f_med is the weighted
    # (per-instance) median frequency.  Note this scoring has no negative
    # drift when the median count is the minimum (log2(1)=0), so region
    # separation requires a mid-distribution median — verified at the
    # model level here.
    from kmer_spans.models.scoring import Log2MedianScoring

    counts = np.array([1, 4, 2, 1])  # total 8; weighted median count = 2
    m = Log2MedianScoring(counts)
    f_med = 2 / 8
    np.testing.assert_allclose(
        m.weights, np.log2((counts / 8) / f_med))
    assert m.threshold == 0.0
    # zero-count k-mers get -inf (infinite penalty resets the scan)
    m2 = Log2MedianScoring(np.array([0, 8, 0, 0]))
    assert np.isneginf(m2.weights[0])


def test_kmer_spans_log2_median_absent_kmers_device_matches_host():
    """log2 scoring gives absent k-mers -inf weights: the device weight
    screen must quantize them soundly and match the host path exactly."""
    seq = "ACGT" * 400 + "AG" * 300 + "TTGACA" * 300 + "ACGGT" * 200
    kw = dict(scoring="log2_median", min_width=10, min_score=5.0)
    d = api.kmer_spans(seq, 5, backend="jax", **kw)
    h = api.kmer_spans(seq, 5, backend="host", **kw)
    assert np.isneginf(Log2MedianScoring(h.counts).weights).any()
    assert len(h.regions) > 0
    assert d.regions.tolist() == h.regions.tolist()


def test_kmer_spans_threshold_matches_oracle_pm1():
    # threshold scoring is a +/-1 weight table; cross-check via oracle
    seq = "ACGT" * 500 + "AG" * 300 + "TTGACA" * 300
    r = api.kmer_spans(seq, 2, scoring="threshold", min_width=10,
                       min_score=5.0, f_t=0.05, backend="host")
    from kmer_spans.models.scoring import ThresholdScoring
    from kmer_spans.oracle import count_spectrum, find_regions

    counts, n = count_spectrum(seq, 2)
    model = ThresholdScoring(counts, 0.05)
    expect = find_regions(seq, 0, 10, 5.0, model.weights, 2, 0.0)
    assert len(r.regions) == len(expect)
    for got, e in zip(r.regions, expect):
        assert (got["beg"], got["end"]) == (e[1], e[2])
        assert got["score"] == e[3]


def test_low_comp_fast_mode_matches_exact(golden, rng):
    # fast mode: one device program over concatenated scaffolds
    seqs = [golden[:30_000], golden[30_000:70_000], "AC",
            golden[70_000:]]
    exact = api.kmer_low_comp_regions(seqs, 8, 100, 20.0, thr=0.75,
                                      backend="host")
    fast = api.kmer_low_comp_regions(seqs, 8, 100, 20.0, thr=0.75,
                                     backend="jax", mode="fast")
    # concatenation-with-N keeps per-sequence semantics; positions match
    # exactly and scores to mass-rank precision
    assert [(r["seq_id"], r["beg"], r["end"]) for r in fast.regions] == \
        [(r["seq_id"], r["beg"], r["end"]) for r in exact.regions]
    np.testing.assert_allclose(fast.regions["score"],
                               exact.regions["score"], rtol=1e-9)
    assert fast.n[0] == exact.n[0]
    assert (fast.counts == exact.counts).all()


def test_native_backend_bit_identical(golden):
    from kmer_spans.utils import native as _native

    if not _native.available():
        pytest.skip("native toolchain unavailable")
    h = api.kmer_low_comp_regions(golden, 8, 100, 20.0, thr=0.75,
                                  backend="host")
    n = api.kmer_low_comp_regions(golden, 8, 100, 20.0, thr=0.75,
                                  backend="native")
    assert (h.regions == n.regions).all()
    assert (h.counts == n.counts).all()
    c = api.kmer_counts(golden, 8, backend="native")
    assert c.n == 99_993


def test_native_backend_scan_counts(rng):
    from kmer_spans.utils import native as _native

    if not _native.available():
        pytest.skip("native toolchain unavailable")
    seqs = [random_seq(rng, 2000, n_prob=0.02) for _ in range(2)]
    w = dict(zip(api.kmer_seq(2), rng.normal(0.3, 1.0, size=16)))
    h = api.kmer_regions(seqs, 2, w, 2, 0.5, backend="host")
    n = api.kmer_regions(seqs, 2, w, 2, 0.5, backend="native")
    assert (h.regions == n.regions).all()
    assert (h.counts == n.counts).all()


def test_kmer_regions_min_score_nonpositive_jax_matches_host():
    """min_score <= 0 makes the score screen vacuous: candidacy falls to
    the width gate (sparse pipeline, no O(n) pull).  jax must equal host
    bit for bit, including scan counts."""
    rng = np.random.default_rng(123)
    seq = "".join(rng.choice(list("ACGT"), 30_000))
    s = list(seq)
    s[9000:9400] = "CG" * 200
    seq = "".join(s)
    scores = {a + b: (1.5 if a + b == "CG" else -0.4)
              for a in "ACGT" for b in "ACGT"}
    r_host = api.kmer_regions([seq], 2, scores, 40, -5.0, backend="host")
    r_jax = api.kmer_regions([seq], 2, scores, 40, -5.0, backend="jax")
    assert r_jax.regions.tolist() == r_host.regions.tolist()
    assert (r_jax.counts == r_host.counts).all()
