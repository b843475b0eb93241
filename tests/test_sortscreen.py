"""Sort-based k >= 10 screen (ops/sortscreen.py) conformance.

The sort screen replaces the fine-table screen for k >= 10: spans must
be bit-identical to the sequential oracle chain (positions AND f64
scores), with the spectrum coming from a host recount
(packed_counts=False semantics — the device never holds a 4^k table).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from kmer_spans.oracle import count_spectrum
from kmer_spans.spans.pipeline import (
    finish_spans,
    make_span_pipeline,
    unpack_outputs,
)

from conftest import random_seq
from test_span_pipeline import _chain_rank_regions, _nbases


def _plant(seq, spans):
    s = list(seq)
    for beg, unit, reps in spans:
        s[beg:beg + len(unit) * reps] = unit * reps
    return "".join(s)


@pytest.mark.parametrize("k", [10, 11, 12])
def test_sort_screen_matches_oracle(k):
    rng = np.random.default_rng(100 + k)
    seq = _plant(
        random_seq(rng, 50_000, n_prob=0.003),
        [(6000, "AG", 300), (20000, "CCTGA", 130), (41000, "T", 500)],
    )
    nb = _nbases(seq)
    block, cand = 1024, 32
    n = -(-len(nb) // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    fn = make_span_pipeline(k, block=block, cand_blocks=cand, screen="sort")
    out = fn(jnp.asarray(arr), jnp.float32(0.75))
    assert out["counts"] is None
    counts, nk = count_spectrum(seq, k)
    assert int(np.asarray(out["total"])) == nk
    res = finish_spans(out, n, 0.75, 30, 5.0, block=block, counts=counts)
    assert not res.fallback
    expect = _chain_rank_regions(seq, k, 0.75, 30, 5.0)
    assert len(expect) >= 2
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


def test_sort_screen_packed_payload():
    """packed=True + sort screen: the device vector carries no spectrum
    (packed_counts forced off); finisher replays from the host recount."""
    k = 10
    rng = np.random.default_rng(7)
    seq = _plant(random_seq(rng, 40_000, n_prob=0.002),
                 [(9000, "AG", 350), (25000, "GATTA", 140)])
    nb = _nbases(seq)
    block, cand = 1024, 24
    n = -(-len(nb) // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    fn = make_span_pipeline(k, block=block, cand_blocks=cand, packed=True,
                            screen="sort")
    v = np.asarray(fn(jnp.asarray(arr), jnp.float32(0.72)))
    got = unpack_outputs(v, k, n, block, cand,
                         packed_bases=fn.packed_bases, packed_counts=False,
                         lazy_codes=True)
    assert got["counts"] is None
    counts, _ = count_spectrum(seq, k)
    res = finish_spans(got, n, 0.72, 30, 5.0, block=block, counts=counts)
    assert not res.fallback
    expect = _chain_rank_regions(seq, k, 0.72, 30, 5.0)
    assert len(expect) >= 2
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


def test_sort_screen_auto_selected():
    """auto resolves to the sort screen at k >= 10 (counts is None) and
    still matches the oracle through the host-recount finisher."""
    k = 10
    rng = np.random.default_rng(17)
    seq = _plant(random_seq(rng, 30_000), [(5000, "A", 4000)])
    nb = _nbases(seq)
    block, cand = 1024, 24
    n = -(-len(nb) // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    fn = make_span_pipeline(k, block=block, cand_blocks=cand)  # auto
    out = fn(jnp.asarray(arr), jnp.float32(0.75))
    assert out["counts"] is None  # sort screen selected
    counts, _ = count_spectrum(seq, k)
    res = finish_spans(out, n, 0.75, 30, 5.0, block=block, counts=counts)
    assert not res.fallback
    expect = _chain_rank_regions(seq, k, 0.75, 30, 5.0)
    assert len(expect) >= 1
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


def test_sort_screen_soundness_under_value_clip():
    """Count values >= vmax fall into the clipped class bucket; the screen
    must stay a sound upper bound: s_int/SCALE >= rank - thr at every
    scored position, for a tiny vmax that everything overflows."""
    from kmer_spans.encoding import pack
    from kmer_spans.ops.gather import SCREEN_SCALE, screen_thr_q
    from kmer_spans.ops.sortscreen import sort_screen_scores
    from kmer_spans.oracle import weighted_ranks
    from kmer_spans.ops.blocked import (
        blocked_codes,
        blocked_scored,
    )

    k = 10
    rng = np.random.default_rng(23)
    seq = _plant(random_seq(rng, 20_000, n_prob=0.01),
                 [(3000, "A", 2000), (9000, "AG", 500)])
    nb = _nbases(seq)
    n = -(-len(nb) // 512) * 512
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    b2 = jnp.asarray(arr & 3).reshape(-1, 512).astype(jnp.int32)
    v2 = jnp.asarray(arr < 4).reshape(-1, 512)
    codes, kv = blocked_codes(b2, v2, k)
    scored = blocked_scored(v2, kv)
    thr = 0.6
    thr_q = screen_thr_q(jnp.float32(thr))
    s_int, total = sort_screen_scores(
        codes.reshape(-1), kv.reshape(-1), scored.reshape(-1), k, thr_q,
        vmax=64)
    s_int = np.asarray(s_int)
    counts, nk = count_spectrum(seq, k)
    assert int(np.asarray(total)) == nk
    ranks = weighted_ranks(counts, float(nk))
    c_np = np.asarray(codes).reshape(-1)
    sc_np = np.asarray(scored).reshape(-1)
    true_s = ranks[c_np[sc_np]] - thr
    assert np.all(s_int[sc_np] >= SCREEN_SCALE * true_s - 1e-6)


def test_sort_screen_k14_big_rank_path():
    """k=14 end to end: sort screen + host recount + the candidate-only
    native rank path (finish_spans never builds a 4^14 f64 chain table).
    Oracle-identical spans and bit-identical f64 scores."""
    from kmer_spans.utils import native

    if not native.available():
        pytest.skip("native library unavailable")
    k = 14
    rng = np.random.default_rng(41)
    seq = _plant(
        random_seq(rng, 60_000, n_prob=0.002),
        [(8000, "AG", 400), (30000, "CCTGA", 180)],
    )
    nb = _nbases(seq)
    block, cand = 1024, 24
    n = -(-len(nb) // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    fn = make_span_pipeline(k, block=block, cand_blocks=cand, packed=True)
    v = np.asarray(fn(jnp.asarray(arr), jnp.float32(0.75)))
    got = unpack_outputs(v, k, n, block, cand,
                         packed_bases=fn.packed_bases,
                         packed_counts=fn.packed_counts, lazy_codes=True)
    counts, nk = native.host_spectrum(arr, k)
    assert counts.dtype == np.int32  # k >= 14 keeps the table int32
    res = finish_spans(got, n, 0.75, 30, 5.0, block=block, counts=counts)
    assert not res.fallback
    # expected side: the fast exact chain (bit-identical to the oracle's
    # weighted_ranks — test_host_rank_chain_bit_identical_to_oracle; the
    # pure-python oracle takes minutes at 4^14) + the sequential caller
    from kmer_spans.oracle import find_regions
    from kmer_spans.spans.pipeline import host_rank_chain

    ranks = host_rank_chain(counts, int(nk))
    expect = find_regions(seq, 0, 30, 5.0, ranks, k, 0.75)
    assert len(expect) >= 2
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]
