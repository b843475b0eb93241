"""Native C++ kernels vs the Python oracle (differential + golden)."""

import numpy as np
import pytest

from kmer_spans.encoding import pack
from kmer_spans.oracle import count_spectrum, find_regions, weighted_ranks
from kmer_spans.utils import native
from kmer_spans.utils.testgen import spectrum_checksum

from conftest import random_seq

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _nbases(seq):
    p = pack(seq)
    nb = p.bases.copy()
    nb[~p.valid] = 4
    return nb


def test_native_pack():
    raw = np.frombuffer(b"ACGTnNWacgt", dtype=np.uint8)
    nb = native.pack_nbases(raw)
    assert list(nb) == [0, 1, 3, 2, 4, 4, 3, 0, 1, 3, 2]


def test_native_count_golden(golden):
    nb = _nbases(golden)
    counts, n = native.count_spectrum(nb, 8)
    assert n == 99_993
    assert spectrum_checksum(counts) == 6585132732039205817


@pytest.mark.parametrize("seed", range(3))
def test_native_count_random(seed):
    rng = np.random.default_rng(seed)
    seq = random_seq(rng, 10_000, n_prob=0.02)
    oc, on = count_spectrum(seq, 5)
    counts, n = native.count_spectrum(_nbases(seq), 5)
    assert n == on and (counts == oc).all()


def test_native_spans_golden(golden):
    nb = _nbases(golden)
    counts, n = native.count_spectrum(nb, 8)
    ranks = weighted_ranks(counts, float(n))
    beg, end, score, _ = native.find_spans(nb, 8, ranks, 0.75, 100, 20.0)
    assert list(beg) == [20008, 50008, 80007]
    assert list(end) == [20600, 50900, 80400]
    assert [round(s, 6) for s in score] == [137.923657, 214.364008, 96.947531]


@pytest.mark.parametrize("seed", range(5))
def test_native_spans_random_bit_identical(seed):
    rng = np.random.default_rng(50 + seed)
    seq = random_seq(rng, 6_000, n_prob=0.01)
    k = 3
    oc, on = count_spectrum(seq, k)
    ranks = weighted_ranks(oc, float(on))
    for thr, mw, ms in [(0.5, 5, 2.0), (0.75, 3, 0.5)]:
        expect = find_regions(seq, 0, mw, ms, ranks, k, thr)
        beg, end, score, _ = native.find_spans(_nbases(seq), k, ranks, thr, mw, ms)
        assert list(beg) == [e[1] for e in expect]
        assert list(end) == [e[2] for e in expect]
        assert list(score) == [e[3] for e in expect]  # bit-identical f64


def test_native_scan_counts_match_oracle():
    rng = np.random.default_rng(77)
    seq = random_seq(rng, 3_000, n_prob=0.02)
    k = 2
    w = rng.normal(0.2, 1.0, size=16)
    oracle_counts = np.zeros(16, dtype=np.int64)
    expect = find_regions(seq, 0, 2, 0.5, w, k, 0.0, scan_counts=oracle_counts)
    beg, end, score, sc = native.find_spans(
        _nbases(seq), k, w, 0.0, 2, 0.5, want_scan_counts=True
    )
    assert list(beg) == [e[1] for e in expect]
    assert (sc == oracle_counts).all()


def test_native_capacity_growth():
    # many planted islands in random background to force capacity regrowth
    rng = np.random.default_rng(3)
    chunks = []
    for _ in range(1500):
        chunks.append(random_seq(rng, 120))
        chunks.append("AG" * 25)
    seq = "".join(chunks)
    k = 2
    oc, on = count_spectrum(seq, k)
    ranks = weighted_ranks(oc, float(on))
    expect = find_regions(seq, 0, 5, 1.0, ranks, k, 0.5)
    beg, end, score, _ = native.find_spans(_nbases(seq), k, ranks, 0.5, 5, 1.0)
    assert len(beg) == len(expect)
    assert len(beg) > 1024  # exercised the regrow path
    assert list(score) == [e[3] for e in expect]


def test_sanitizer_selftest():
    """ASan/UBSan harness: native kernels must be UB-free up to k=15
    (the reference C has signed-shift UB at its MAX_K; SURVEY §5.2)."""
    import subprocess
    import os

    native_dir = os.path.join(os.path.dirname(__file__), "..", "native")
    try:
        r = subprocess.run(
            ["make", "-C", native_dir, "-s", "sanitize"],
            capture_output=True, timeout=300, text=True,
        )
    except (subprocess.TimeoutExpired, FileNotFoundError):
        pytest.skip("sanitizer toolchain unavailable")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "selftest ok" in r.stdout


def test_count_mt_matches_single_thread():
    """Code-space-partitioned multithreaded count == sequential count."""
    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(5)
    nb = rng.integers(0, 4, size=300_000, dtype=np.uint8)
    nb[40_000:40_100] = 4  # N gap
    for k in [2, 8, 13]:
        c1, n1 = native.count_spectrum(nb, k)
        c2, n2 = native.host_spectrum(nb, k, threads=3)
        assert n1 == n2
        assert np.array_equal(np.asarray(c1), np.asarray(c2))


def test_mass_of_codes_matches_oracle_chain():
    """Native per-code mass + sparse value hist reproduce the reference's
    f64 rank chain BIT-IDENTICALLY through chain_ranks_from_mass — the
    k >= 14 replay path that never builds a 4^k rank table."""
    if not native.available():
        pytest.skip("native library unavailable")
    from kmer_spans.stats.ranks import chain_ranks_from_mass

    rng = np.random.default_rng(6)
    size = 4096  # k=6
    counts = rng.integers(0, 30, size=size).astype(np.int32)
    counts[rng.integers(0, size, 100)] = 0          # zero-count ties
    counts[7] = 2_000_000                            # heavy value (> VCAP
    counts[11] = 2_000_000                           # dense range) twice
    total = int(counts.sum())
    ranks = weighted_ranks(counts.astype(np.int64), float(total))
    q = np.unique(rng.integers(0, size, 500))
    pm, vv, vn = native.mass_of_codes(counts, q)
    got = chain_ranks_from_mass(pm, (vv, vn), total)
    assert np.array_equal(got, ranks[q])
    # value hist is consistent: code multiplicities sum to 4^k
    assert int(vn.sum()) == size


def test_native_rank_chain_bit_identical():
    """ks_rank_chain (sort-free: value histogram + per-value cursors) ==
    the numpy argsort chain, bit for bit — zeros, ties, a > 2^16 value."""
    from kmer_spans.oracle import weighted_ranks
    from kmer_spans.utils import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(9)
    counts = rng.poisson(3, 1 << 12).astype(np.int64)
    counts[5] = 0
    counts[77] = 1 << 18
    total = int(counts.sum())
    got = native.rank_chain(counts, total)
    np.testing.assert_array_equal(got, weighted_ranks(counts, float(total)))


def test_native_chain_from_hist_boundaries():
    """ks_chain_from_hist: p=0 queries, mid-group, group-boundary, and
    the pm == total-mass query all match the numpy fold; invalid pm
    raises."""
    from kmer_spans.stats.ranks import chain_ranks_from_mass
    from kmer_spans.utils import native

    if not native.available():
        pytest.skip("native library unavailable")
    v_vals = np.array([1, 3, 7], np.int64)
    n_codes = np.array([4, 2, 1], np.int64)
    total = int((v_vals * n_codes).sum())  # 17
    # all valid masses: 0,1,2,3,4 (v=1), 4+3=7, 4+6=10 (v=3), 17 (v=7 end)
    pm = np.array([0, 1, 2, 3, 4, 7, 10, 17], np.int64)
    got = native.chain_from_hist(v_vals, n_codes, float(total), pm)
    want = chain_ranks_from_mass(pm, (v_vals, n_codes), total)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        native.chain_from_hist(v_vals, n_codes, float(total),
                               np.array([5], np.int64))  # mid-value
    # empty histogram: all ranks 0
    z = native.chain_from_hist(np.zeros(0, np.int64), np.zeros(0, np.int64),
                               0.0, np.array([0, 0], np.int64))
    np.testing.assert_array_equal(z, [0.0, 0.0])
