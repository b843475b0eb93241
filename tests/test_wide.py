"""Wide-code (k >= 16) engine: BASELINE config 5 territory.

The reference's own MAX_K=16 is UB (SURVEY §2.1 #4); these tests pin
this build's extension past it: (hi, lo) int32 pair codes, the 2-key
sort screen, sparse host spectra, and the exact f64 chain replay — all
without any 4^k table anywhere (68 GB at k=17).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from kmer_spans.encoding import kmer_codes_np, pack
from kmer_spans.oracle import count_spectrum, find_regions
from kmer_spans.oracle.reference import count_spectrum_sparse
from kmer_spans.stats.ranks import SparseRanks, sparse_mass
from kmer_spans.spans.pipeline import (
    finish_wide_spans,
    make_wide_span_pipeline,
    unpack_wide_outputs,
)

from conftest import random_seq
from test_span_pipeline import _nbases
from test_sortscreen import _plant


def test_sparse_mass_matches_dense_oracle():
    """sparse_mass + chain ranks over present codes == the dense oracle's
    weighted_ranks, bit for bit (k=6 where both forms exist)."""
    from kmer_spans.oracle import weighted_ranks

    rng = np.random.default_rng(5)
    seq = _plant(random_seq(rng, 30_000, n_prob=0.005),
                 [(4000, "AG", 200), (15000, "CCTGA", 80)])
    k = 6
    counts, nk = count_spectrum(seq, k)
    dense_ranks = weighted_ranks(counts, float(nk))
    ucodes, ucounts, nk2 = count_spectrum_sparse(seq, k)
    assert nk2 == nk
    assert np.array_equal(counts[ucodes], ucounts)
    sr = SparseRanks(ucodes, ucounts)
    assert sr.total == nk
    got = sr.lookup(ucodes)
    np.testing.assert_array_equal(got, dense_ranks[ucodes])
    # scalar path too
    assert sr[int(ucodes[3])] == dense_ranks[ucodes[3]]


def test_native_sparse_counter_matches_numpy():
    """ks_count_sparse (threads partition code space, sort, merge) ==
    the numpy sparse oracle, codes and counts, at k=17 and k=8."""
    from kmer_spans.utils import native

    rng = np.random.default_rng(77)
    seq = _plant(random_seq(rng, 50_000, n_prob=0.01),
                 [(7000, "GATTACA", 150)])
    p = pack(seq)
    nb = np.where(p.valid, p.bases, 4).astype(np.uint8)
    for k in (8, 17):
        uc_np, un_np, nw_np = count_spectrum_sparse(seq, k)
        uc, un, nw = native.host_spectrum_sparse(nb, k)
        assert nw == nw_np
        np.testing.assert_array_equal(uc, uc_np)
        np.testing.assert_array_equal(un, un_np)


def test_blocked_codes_wide_matches_numpy():
    """Device (hi, lo) pair codes == int64 numpy rolling codes, k=17."""
    from kmer_spans.ops.blocked import blocked_codes_wide

    k = 17
    rng = np.random.default_rng(9)
    seq = random_seq(rng, 4096, n_prob=0.01)
    p = pack(seq)
    ref_codes, ref_valid = kmer_codes_np(p, k)
    b2 = jnp.asarray(p.bases.astype(np.int32)).reshape(-1, 512)
    v2 = jnp.asarray(p.valid).reshape(-1, 512)
    hi, lo, kv = blocked_codes_wide(b2, v2, k)
    kv = np.asarray(kv).reshape(-1)
    np.testing.assert_array_equal(kv, ref_valid)
    got = (np.asarray(hi, np.int64).reshape(-1) << 16) | np.asarray(
        lo, np.int64).reshape(-1)
    np.testing.assert_array_equal(got[kv], ref_codes[kv])


def test_wide_sort_screen_is_sound_k16():
    """s_int/SCALE >= rank - thr at every scored position (k=16)."""
    from kmer_spans.ops.blocked import blocked_codes_wide, blocked_scored
    from kmer_spans.ops.gather import SCREEN_SCALE, screen_thr_q
    from kmer_spans.ops.sortscreen import sort_screen_scores_wide

    k = 16
    rng = np.random.default_rng(31)
    seq = _plant(random_seq(rng, 24_000, n_prob=0.01),
                 [(3000, "A", 1500), (9000, "CCTGA", 300)])
    nb = _nbases(seq)
    n = -(-len(nb) // 512) * 512
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    b2 = jnp.asarray(arr & 3).reshape(-1, 512).astype(jnp.int32)
    v2 = jnp.asarray(arr < 4).reshape(-1, 512)
    hi, lo, kv = blocked_codes_wide(b2, v2, k)
    scored = blocked_scored(v2, kv)
    thr = 0.6
    thr_q = screen_thr_q(jnp.float32(thr))
    s_int, total = sort_screen_scores_wide(
        hi.reshape(-1), lo.reshape(-1), kv.reshape(-1), k, thr_q, vmax=64)
    s_int = np.asarray(s_int)
    ucodes, ucounts, nk = count_spectrum_sparse(seq, k)
    assert int(np.asarray(total)) == nk
    sr = SparseRanks(ucodes, ucounts)
    codes64 = (np.asarray(hi, np.int64).reshape(-1) << 16) | np.asarray(
        lo, np.int64).reshape(-1)
    sc_np = np.asarray(scored).reshape(-1)
    true_s = sr.lookup(codes64[sc_np]) - thr
    assert np.all(s_int[sc_np] >= SCREEN_SCALE * true_s - 1e-6)


def test_api_kmer_wide_regions_backends_agree():
    """Public surface: multi-sequence k=17, jax pipeline == host oracle,
    coordinates mapped back per sequence."""
    from kmer_spans.api import kmer_wide_regions

    k = 17
    rng = np.random.default_rng(71)
    seqs = [
        _plant(random_seq(rng, 40_000), [(6_000, "GATTACA", 200)]),
        "ACGT" * 3,  # shorter than k: skipped
        _plant(random_seq(rng, 30_000), [(12_000, "CCTGA", 260)]),
    ]
    got_j = kmer_wide_regions(seqs, k, 30, 5.0, thr=0.75, backend="jax",
                              block=1024)
    got_h = kmer_wide_regions(seqs, k, 30, 5.0, thr=0.75, backend="host")
    assert got_j.n_words == got_h.n_words
    np.testing.assert_array_equal(got_j.spectrum_codes,
                                  got_h.spectrum_codes)
    assert got_j.regions.tolist() == got_h.regions.tolist()
    sids = {int(r["seq_id"]) for r in got_j.regions}
    assert sids == {0, 2}
    with pytest.raises(ValueError):
        kmer_wide_regions(seqs, 15, 30, 5.0)


@pytest.mark.parametrize("k", [16, 17])
def test_wide_pipeline_matches_oracle(k):
    """End to end at k=16/17: wide device pipeline + sparse host recount
    + exact chain replay == the sequential oracle with a SparseRanks
    lookup — positions AND f64 scores, no 4^k table on either side."""
    rng = np.random.default_rng(900 + k)
    seq = _plant(
        random_seq(rng, 120_000, n_prob=0.002),
        [(12_000, "AG", 900), (50_000, "CCTGA", 400),
         (90_000, "GATTACA", 250)],
    )
    nb = _nbases(seq)
    block, cand = 1024, 64
    n = -(-len(nb) // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    thr, min_w, min_s = 0.75, 30, 5.0
    fn = make_wide_span_pipeline(k, block=block, cand_blocks=cand)
    v = np.asarray(fn(jnp.asarray(arr), jnp.float32(thr)))
    got = unpack_wide_outputs(v, n, block, cand)
    spectrum = count_spectrum_sparse(seq, k)
    assert got["total"] == spectrum[2]
    res = finish_wide_spans(
        got, n, k, thr, min_w, min_s, spectrum, block=block)
    assert not res.fallback
    sr = SparseRanks(spectrum[0], spectrum[1])
    expect = find_regions(seq, 0, min_w, min_s, sr, k, thr)
    assert len(expect) >= 3
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]
