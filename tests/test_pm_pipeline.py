"""Device-complete pm pipeline (ops/pmscreen.py, spans/pm_pipeline.py).

The k >= 10 replay must need NO host spectrum: the device emits exact
per-position cumulative mass (pm), a run-value histogram, and an
explicit high-count run list; the finisher's spans must be bit-identical
to the sequential oracle chain (positions AND f64 scores).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from kmer_spans.oracle import count_spectrum
from kmer_spans.spans.pm_pipeline import (
    finish_pm_spans,
    make_pm_span_pipeline,
    make_wide_pm_pipeline,
    unpack_pm_outputs,
)
from conftest import random_seq
from test_span_pipeline import _chain_rank_regions, _nbases


def _plant(seq, spans):
    s = list(seq)
    for beg, unit, reps in spans:
        s[beg:beg + len(unit) * reps] = unit * reps
    return "".join(s)


def _arr(seq, block):
    nb = _nbases(seq)
    n = -(-len(nb) // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    return arr, n


def _screen_dict(seq, k, block=512, **kw):
    from kmer_spans.ops.blocked import blocked_codes
    from kmer_spans.ops.pmscreen import pm_sort_screen

    arr, n = _arr(seq, block)
    b2 = jnp.asarray(arr & 3).reshape(-1, block).astype(jnp.int32)
    v2 = jnp.asarray(arr < 4).reshape(-1, block)
    codes, kv = blocked_codes(b2, v2, k)
    scr = pm_sort_screen(codes.reshape(-1), kv.reshape(-1), k, **kw)
    return {kk: np.asarray(vv) if kk != "t_list" else vv
            for kk, vv in scr.items()}, np.asarray(codes).reshape(-1), \
        np.asarray(kv).reshape(-1)


def _sparse_cm(seq, k):
    """(code -> exact cumulative mass) lookup via the SPARSE oracle —
    O(distinct) host cost so k = 14/15 stay test-sized (a dense 4^15
    table is 8 GB and minutes of argsort on this box)."""
    from kmer_spans.oracle import count_spectrum_sparse
    from kmer_spans.stats.ranks import sparse_mass

    ucodes, ucounts, nk = count_spectrum_sparse(seq, k)
    pm_u, vhist, total = sparse_mass(ucodes, ucounts)
    assert total == nk

    def cm(codes):
        idx = np.searchsorted(ucodes, codes)
        assert np.array_equal(ucodes[idx], codes)
        return pm_u[idx]

    return cm, ucounts, nk


@pytest.mark.parametrize("k,strategy", [
    (10, "packed"), (12, "packed"), (13, "packed"),
    (14, "packed"), (15, "smallv"), (12, "smallv"),
])
def test_pm_exact_mass(k, strategy):
    """Every valid position's pm (device value, or host list value for
    the -1 sentinel) equals the reference integer cumulative mass of its
    code — exactly."""
    rng = np.random.default_rng(300 + k)
    seq = _plant(
        random_seq(rng, 30_000, n_prob=0.004),
        [(4000, "AG", 250), (15000, "CCTGA", 120), (24000, "T", 400)],
    )
    scr, codes, kv = _screen_dict(seq, k, strategy=strategy)
    cm_lookup, ucounts, nk = _sparse_cm(seq, k)
    assert int(scr["total"]) == nk
    pm = scr["pm"].astype(np.int64)
    # device-exact positions
    dev = kv & (pm >= 0)
    assert np.array_equal(pm[dev], cm_lookup(codes[dev]))
    # sentinel positions resolve in the list, to the exact mass
    from kmer_spans.spans.pm_pipeline import _pm_host_tables

    t_list = scr["t_list"]
    out = {"total": nk, "vh": scr["vh"],
           "list_codes": scr["list_codes"].astype(np.int64),
           "list_v": scr["list_v"].astype(np.int64)}
    v_vals, n_codes, lcodes, lpm = _pm_host_tables(out, t_list)
    # value histogram == the true count-value multiset
    tv, tn = np.unique(ucounts, return_counts=True)
    assert np.array_equal(v_vals, tv)
    assert np.array_equal(n_codes, tn)
    need = kv & (pm < 0)
    if need.any():
        qi = np.searchsorted(lcodes, codes[need])
        assert np.array_equal(lcodes[qi], codes[need])
        assert np.array_equal(lpm[qi], cm_lookup(codes[need]))
    # every listed code's count must be >= t_list and vice versa
    assert int(scr["list_count"]) == int((ucounts >= t_list).sum())


@pytest.mark.parametrize("k", [10, 12, 13])
def test_pm_pipeline_matches_oracle(k):
    rng = np.random.default_rng(400 + k)
    seq = _plant(
        random_seq(rng, 50_000, n_prob=0.003),
        [(6000, "AG", 300), (20000, "CCTGA", 130), (41000, "T", 500)],
    )
    block, cand = 1024, 32
    arr, n = _arr(seq, block)
    fn, meta = make_pm_span_pipeline(k, block=block, cand_blocks=cand)
    v = np.asarray(fn(jnp.asarray(arr), jnp.float32(0.75)))
    out = unpack_pm_outputs(v, n, meta)
    res = finish_pm_spans(out, n, meta, 0.75, 30, 5.0)
    assert not res.fallback
    expect = _chain_rank_regions(seq, k, 0.75, 30, 5.0)
    assert len(expect) >= 2
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


def test_pm_pipeline_k15_smallv():
    from kmer_spans.oracle import count_spectrum_sparse, find_regions
    from kmer_spans.stats.ranks import SparseRanks

    k = 15
    rng = np.random.default_rng(77)
    seq = _plant(
        random_seq(rng, 60_000, n_prob=0.002),
        [(8000, "AG", 400), (30000, "GATTACA", 150)],
    )
    block, cand = 1024, 32
    arr, n = _arr(seq, block)
    fn, meta = make_pm_span_pipeline(k, block=block, cand_blocks=cand)
    v = np.asarray(fn(jnp.asarray(arr), jnp.float32(0.75)))
    out = unpack_pm_outputs(v, n, meta)
    assert out["t_list"] >= 4  # smallv, n-adaptive threshold
    res = finish_pm_spans(out, n, meta, 0.75, 30, 5.0)
    assert not res.fallback
    # sparse oracle: same exact f64 chain restricted to present codes
    # (a dense 4^15 chain table is 8 GB — not test-sized on this box)
    ucodes, ucounts, _ = count_spectrum_sparse(seq, k)
    expect = find_regions(seq, 0, 30, 5.0, SparseRanks(ucodes, ucounts),
                          k, 0.75)
    assert len(expect) >= 2
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


def test_pm_scores_sound():
    """s_int/SCALE >= rank - thr at every scored position (upper bound)."""
    from kmer_spans.ops.blocked import blocked_codes, blocked_scored
    from kmer_spans.ops.gather import SCREEN_SCALE, screen_thr_q
    from kmer_spans.ops.pmscreen import pm_scores_int, pm_sort_screen
    from kmer_spans.oracle import weighted_ranks

    k = 12
    rng = np.random.default_rng(55)
    seq = _plant(random_seq(rng, 25_000, n_prob=0.01),
                 [(3000, "A", 2000), (9000, "AG", 500)])
    arr, n = _arr(seq, 512)
    b2 = jnp.asarray(arr & 3).reshape(-1, 512).astype(jnp.int32)
    v2 = jnp.asarray(arr < 4).reshape(-1, 512)
    codes, kv = blocked_codes(b2, v2, k)
    scored = blocked_scored(v2, kv)
    thr = 0.6
    scr = pm_sort_screen(codes.reshape(-1), kv.reshape(-1), k)
    s_int = np.asarray(pm_scores_int(
        scr["pm"], scr["total"], screen_thr_q(jnp.float32(thr))))
    counts, nk = count_spectrum(seq, k)
    ranks = weighted_ranks(counts, float(nk))
    c_np = np.asarray(codes).reshape(-1)
    sc_np = np.asarray(scored).reshape(-1)
    true_s = ranks[c_np[sc_np]] - thr
    assert np.all(s_int[sc_np] >= SCREEN_SCALE * true_s - 1e-6)


def test_pm_list_overflow_flags_fallback():
    """A too-small list capacity must flag fallback, never emit."""
    k = 12
    rng = np.random.default_rng(3)
    seq = _plant(random_seq(rng, 30_000),
                 [(2000, "A", 3000), (9000, "AG", 800),
                  (15000, "CCTGA", 300), (21000, "T", 2000)])
    block, cand = 1024, 32
    arr, n = _arr(seq, block)
    fn, meta = make_pm_span_pipeline(k, block=block, cand_blocks=cand,
                                     list_cap=2)
    v = np.asarray(fn(jnp.asarray(arr), jnp.float32(0.75)))
    out = unpack_pm_outputs(v, n, meta)
    assert out["list_count"] > 2
    res = finish_pm_spans(out, n, meta, 0.75, 30, 5.0)
    assert res.fallback


def test_wide_pm_pipeline_matches_oracle():
    """k=17 device-complete: no sparse host recount anywhere."""
    from kmer_spans.oracle import count_spectrum_sparse, find_regions
    from kmer_spans.stats.ranks import SparseRanks

    k = 17
    rng = np.random.default_rng(19)
    seq = _plant(
        random_seq(rng, 60_000, n_prob=0.002),
        [(9000, "AG", 400), (33000, "GATTACA", 160)],
    )
    block, cand = 1024, 32
    arr, n = _arr(seq, block)
    fn, meta = make_wide_pm_pipeline(k, block=block, cand_blocks=cand)
    v = np.asarray(fn(jnp.asarray(arr), jnp.float32(0.75)))
    out = unpack_pm_outputs(v, n, meta)
    res = finish_pm_spans(out, n, meta, 0.75, 30, 5.0)
    assert not res.fallback
    ucodes, ucounts, nw = count_spectrum_sparse(seq, k)
    ranks = SparseRanks(ucodes, ucounts)
    expect = find_regions(seq, 0, 30, 5.0, ranks, k, 0.75)
    assert len(expect) >= 2
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


@pytest.mark.parametrize("case", ["poly", "allN", "tiny", "alternating"])
def test_pm_screen_adversarial_inputs(case):
    """Degenerate inputs: one giant run (every position in the clip
    list's range), all-N (zero counted k-mers), a sequence barely
    longer than k, and a two-code alternation."""
    from kmer_spans.ops.blocked import blocked_codes
    from kmer_spans.ops.pmscreen import pm_sort_screen
    from kmer_spans.oracle import count_spectrum_sparse
    from kmer_spans.stats.ranks import sparse_mass

    k = 12
    if case == "poly":
        seq = "A" * 4096
    elif case == "allN":
        seq = "N" * 4096
    elif case == "tiny":
        seq = "ACGTACGTACGTA"  # n = k + 1
    else:
        seq = "AG" * 2048
    arr, n = _arr(seq, 512 if len(seq) >= 512 else 16)
    import jax.numpy as jnp

    W = arr.shape[0]
    b2 = jnp.asarray(arr & 3).reshape(1, W).astype(jnp.int32)
    v2 = jnp.asarray(arr < 4).reshape(1, W)
    codes, kv = blocked_codes(b2, v2, k)
    scr = pm_sort_screen(codes.reshape(-1), kv.reshape(-1), k)
    ucodes, ucounts, nk = count_spectrum_sparse(seq, k)
    assert int(scr["total"]) == nk
    if nk == 0:
        assert int(scr["list_count"]) == 0
        return
    pm_u, _, _ = sparse_mass(ucodes, ucounts)
    pm = np.asarray(scr["pm"]).astype(np.int64)
    kvn = np.asarray(kv).reshape(-1)
    cn = np.asarray(codes).reshape(-1)
    from kmer_spans.spans.pm_pipeline import _pm_host_tables

    out = {"total": nk, "vh": np.asarray(scr["vh"]),
           "list_codes": np.asarray(scr["list_codes"]).astype(np.int64),
           "list_v": np.asarray(scr["list_v"]).astype(np.int64)}
    v_vals, n_codes, lcodes, lpm = _pm_host_tables(out, scr["t_list"])
    assert int((v_vals * n_codes).sum()) == nk
    for p in np.nonzero(kvn)[0]:
        i = int(np.searchsorted(ucodes, cn[p]))
        want = pm_u[i]
        if pm[p] >= 0:
            assert pm[p] == want, (case, p)
        else:
            j = int(np.searchsorted(lcodes, cn[p]))
            assert lcodes[j] == cn[p]
            assert lpm[j] == want, (case, p)


def test_pm_choose_params_strategy_flip():
    """The n-adaptive strategy must flip packed->smallv as counts get
    sparse, with the expected-list bound respected."""
    from kmer_spans.ops.pmscreen import choose_params, PM_CAP_SMALLV

    # k=13 at chunk scale: smallv with a raised T
    s, t = choose_params(13, 100_663_296)
    assert s == "smallv" and 4 <= t <= 13
    # k=13 at 2 Gb: lam ~ 32 — no safe T, fall back to packed
    s2, t2 = choose_params(13, 2_000_000_000)
    assert s2 == "packed"
    # k=15 always finds a smallv T below 2^31 bases
    s3, t3 = choose_params(15, 2_000_000_000)
    assert s3 == "smallv" and t3 <= 13
    # wide k: smallv with tiny T at chunk scale
    s4, t4 = choose_params(17, 100_663_296, wide=True)
    assert s4 == "smallv" and t4 == 4


def test_api_packed_retry_on_smallv_overflow(monkeypatch):
    """api fast path: a smallv run-list overflow retries with the
    packed-key strategy (which clips high counts into the key) before
    surrendering to the exact host path."""
    from kmer_spans import api as apimod
    from kmer_spans.spans.pm_pipeline import make_pm_span_pipeline

    calls = []

    def tiny(k, block, cand_blocks):
        calls.append("smallv")
        return make_pm_span_pipeline(k, block=block,
                                     cand_blocks=cand_blocks, list_cap=2)

    monkeypatch.setattr(apimod, "_cached_pm_pipeline", tiny)
    rng = np.random.default_rng(21)
    seq = _plant(random_seq(rng, 40_000),
                 [(4000, "AG", 300), (15000, "CCTGA", 150),
                  (30000, "T", 600)])
    k = 13
    fast = apimod.kmer_low_comp_regions(seq, k, 30, 5.0, thr=0.75,
                                        backend="jax", mode="fast")
    exact = apimod.kmer_low_comp_regions(seq, k, 30, 5.0, thr=0.75,
                                         backend="host", mode="exact")
    assert calls == ["smallv"]
    got = [(r["beg"], r["end"], r["score"]) for r in fast.regions]
    want = [(r["beg"], r["end"], r["score"]) for r in exact.regions]
    assert got == want and len(got) >= 2
