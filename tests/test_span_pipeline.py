"""Sparse device span pipeline (make_span_pipeline + finish_spans) vs oracle.

Note: the fast pipeline uses mass/total ranks (can differ from the
reference's sequential rank chain in the last ulp), so region positions
must match the oracle exactly while scores match to ~1e-9 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from kmer_spans.encoding import pack
from kmer_spans.oracle import count_spectrum, find_regions, weighted_ranks
from kmer_spans.spans.pipeline import finish_spans, make_span_pipeline
from kmer_spans.stats.ranks import cumulative_mass

from conftest import random_seq


def _nbases(seq):
    p = pack(seq)
    nb = p.bases.copy()
    nb[~p.valid] = 4
    return nb


def _run_pipeline(seq, k, thr, min_w, min_s, block=1024, cand=32):
    nb = _nbases(seq)
    n = len(nb)
    npad = -(-n // block) * block
    arr = np.full(npad, 4, np.uint8)
    arr[:n] = nb
    fn = make_span_pipeline(k, block=block, cand_blocks=cand)
    out = fn(jnp.asarray(arr), jnp.float32(thr))
    return finish_spans(out, npad, thr, min_w, min_s, block=block)


def _chain_rank_regions(seq, k, thr, min_w, min_s):
    """True oracle: the reference's sequential f64 rank chain (SURVEY A.2).

    The device pipeline's finisher replays candidates through this exact
    chain (spans.pipeline.host_rank_chain), so scores must be == here,
    not approx (round-2 weak #4: a mass/total oracle hid 1e-9 drift)."""
    from kmer_spans.oracle import weighted_ranks

    counts, n = count_spectrum(seq, k)
    ranks = weighted_ranks(counts, float(n))
    return find_regions(seq, 0, min_w, min_s, ranks, k, thr)


@pytest.mark.parametrize("seed", range(5))
def test_sparse_pipeline_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    seq = random_seq(rng, 40_000, n_prob=0.005)
    # plant islands to force emissions
    s = list(seq)
    s[5000:5400] = "AG" * 200
    s[22000:22600] = "CCT" * 200
    seq = "".join(s)
    k, thr, min_w, min_s = 4, 0.75, 30, 5.0
    res = _run_pipeline(seq, k, thr, min_w, min_s)
    assert not res.fallback
    expect = _chain_rank_regions(seq, k, thr, min_w, min_s)
    assert [(r[1], r[2]) for r in res.regions] == [(e[1], e[2]) for e in expect]
    for r, e in zip(res.regions, expect):
        assert r[3] == e[3]  # bit-identical f64


def test_sparse_pipeline_no_candidates():
    rng = np.random.default_rng(9)
    seq = random_seq(rng, 8_000)
    res = _run_pipeline(seq, 4, 0.75, 100, 1000.0)
    assert res.regions == [] and not res.fallback


def test_sparse_pipeline_fallback_on_overflow():
    # every block a candidate but capacity tiny -> fallback flagged
    seq = ("AG" * 600 + "ACGTTACG" * 100) * 30
    res = _run_pipeline(seq, 2, 0.3, 5, 0.5, block=256, cand=4)
    assert res.fallback


def test_sparse_pipeline_island_across_blocks():
    rng = np.random.default_rng(11)
    seq = random_seq(rng, 16_000)
    s = list(seq)
    s[3000:5100] = "TTAGGC" * 350  # island spanning multiple 1024-blocks
    seq = "".join(s)
    res = _run_pipeline(seq, 4, 0.75, 50, 5.0)
    assert not res.fallback
    expect = _chain_rank_regions(seq, 4, 0.75, 50, 5.0)
    assert [(r[1], r[2]) for r in res.regions] == [(e[1], e[2]) for e in expect]
    assert len(res.regions) >= 1


@pytest.mark.parametrize("k", [4, 8, 10])
def test_packed_outputs_match_dict(k):
    """packed=True fuses all finisher inputs into one int32 vector; the
    decoded dict must reproduce the dict-mode outputs exactly (including
    integer mass rebuilt from counts for k<=8)."""
    from kmer_spans.spans.pipeline import unpack_outputs

    rng = np.random.default_rng(99 + k)
    seq = random_seq(rng, 40_000, n_prob=0.002)
    s = list(seq)
    s[9000:9500] = "AG" * 250
    seq = "".join(s)
    nb = _nbases(seq)
    block, cand = 1024, 16
    n = -(-len(nb) // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    fn_d = make_span_pipeline(k, block=block, cand_blocks=cand)
    fn_p = make_span_pipeline(k, block=block, cand_blocks=cand, packed=True)
    thr = jnp.float32(0.75)
    ref = {kk: None if v is None else np.asarray(v)
           for kk, v in fn_d(jnp.asarray(arr), thr).items()}
    got = unpack_outputs(fn_p(jnp.asarray(arr), thr), k, n, block, cand,
                         packed_bases=fn_p.packed_bases,
                         packed_counts=fn_p.packed_counts)
    assert fn_p.packed_bases
    for kk in ref:
        if ref[kk] is None:
            assert got[kk] is None, kk  # k >= 10 sort screen: no spectrum
            continue
        assert np.array_equal(np.asarray(got[kk]), ref[kk]), kk
    # and the finisher agrees end to end (host recount above k=9)
    counts_host = None
    if ref["counts"] is None:
        from kmer_spans.oracle.reference import count_spectrum

        counts_host, _ = count_spectrum(seq, k)
    r1 = finish_spans(ref, n, 0.75, 30, 5.0, block=block, counts=counts_host)
    r2 = finish_spans(got, n, 0.75, 30, 5.0, block=block, counts=counts_host)
    assert r1.regions == r2.regions and r1.fallback == r2.fallback


def test_host_rank_chain_bit_identical_to_oracle():
    """host_rank_chain's radix/bincount fast path must reproduce the
    oracle's sequential f64 chain bit for bit (argsort dtype narrowing
    and bincount+repeat both preserve order and per-element terms)."""
    from kmer_spans.spans.pipeline import host_rank_chain

    rng = np.random.default_rng(3)
    for size, hi in [(4096, 40), (4096, 70000), (1 << 16, 5)]:
        counts = rng.integers(0, hi, size).astype(np.int64)
        counts[rng.integers(0, size, 17)] = 0  # zero-count ties
        total = int(counts.sum())
        got = host_rank_chain(counts, total)
        want = weighted_ranks(counts, float(total))
        assert np.array_equal(got, want), (size, hi)
    assert np.array_equal(host_rank_chain(np.zeros(16, np.int64), 0),
                          np.zeros(16))


@pytest.mark.parametrize("k", [4, 8, 11])
@pytest.mark.parametrize("use_native", [True, False])
def test_lazy_codes_native_replay_matches_numpy(k, use_native, monkeypatch):
    """finish_spans over the lazy packed payload (native C replay when
    use_native, per-stretch numpy rebuild otherwise) must equal the eager
    numpy path exactly — spans AND f64 scores.  use_native=False forces
    the pure-numpy lazy fallback branch by monkeypatching
    native.available; use_native=True skips (not fails) where the .so
    genuinely cannot be built."""
    from kmer_spans.spans.pipeline import unpack_outputs
    from kmer_spans.utils import native

    if use_native and not native.available():
        pytest.skip("native library unavailable (no C++ toolchain)")
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)

    rng = np.random.default_rng(31 + k)
    seq = random_seq(rng, 60_000, n_prob=0.004)
    s = list(seq)
    s[9000:9700] = "AG" * 350
    s[30000:30090] = "N" * 90  # N gap inside a block
    s[30100:30800] = "CCT" * 233 + "C"
    seq = "".join(s)
    nb = _nbases(seq)
    block, cand = 1024, 24
    n = -(-len(nb) // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    fn = make_span_pipeline(k, block=block, cand_blocks=cand, packed=True)
    thr = jnp.float32(0.72)
    v = np.asarray(fn(jnp.asarray(arr), thr))
    # k >= 10 resolves to the sort screen (no device spectrum): the
    # finisher replays from a host recount, as production does
    counts_host = None
    if not fn.packed_counts:
        from kmer_spans.oracle.reference import count_spectrum

        counts_host, _ = count_spectrum(seq, k)
    eager = unpack_outputs(v, k, n, block, cand,
                           packed_bases=fn.packed_bases,
                           packed_counts=fn.packed_counts)
    lazy = unpack_outputs(v, k, n, block, cand,
                          packed_bases=fn.packed_bases,
                          packed_counts=fn.packed_counts, lazy_codes=True)
    assert lazy["codes"] is None and lazy["cand_words"] is not None
    r_eager = finish_spans(eager, n, 0.72, 30, 5.0, block=block,
                           counts=counts_host)
    r_lazy = finish_spans(lazy, n, 0.72, 30, 5.0, block=block,
                          counts=counts_host)
    assert r_eager.regions == r_lazy.regions
    assert len(r_lazy.regions) >= 2
    # and both must match the sequential oracle
    expect = _chain_rank_regions(seq, k, 0.72, 30, 5.0)
    assert [(r[1], r[2], r[3]) for r in r_lazy.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


def test_packed_counts_false_with_host_recount():
    """packed_counts=False drops the 4^k spectrum from the device vector;
    the finisher replays from a host recount instead (the k >= 10 pull
    killer: 67 MB of device counts at k=12)."""
    from kmer_spans.oracle.reference import count_spectrum
    from kmer_spans.spans.pipeline import unpack_outputs

    rng = np.random.default_rng(123)
    seq = random_seq(rng, 30_000, n_prob=0.002)
    s = list(seq)
    s[7000:7500] = "AG" * 250
    seq = "".join(s)
    nb = _nbases(seq)
    block, cand, k = 1024, 16, 8
    n = -(-len(nb) // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[: len(nb)] = nb
    fn_full = make_span_pipeline(k, block=block, cand_blocks=cand,
                                 packed=True)
    fn_nc = make_span_pipeline(k, block=block, cand_blocks=cand,
                               packed=True, packed_counts=False)
    thr = jnp.float32(0.75)
    v_full = np.asarray(fn_full(jnp.asarray(arr), thr))
    v_nc = np.asarray(fn_nc(jnp.asarray(arr), thr))
    assert v_nc.shape[0] == v_full.shape[0] - (1 << (2 * k))
    got = unpack_outputs(v_nc, k, n, block, cand,
                         packed_bases=fn_nc.packed_bases,
                         packed_counts=False)
    assert got["counts"] is None
    counts_host, _ = count_spectrum(seq, k)
    ref = unpack_outputs(v_full, k, n, block, cand,
                         packed_bases=fn_full.packed_bases)
    assert np.array_equal(ref["counts"], counts_host)
    r_full = finish_spans(ref, n, 0.75, 30, 5.0, block=block)
    r_nc = finish_spans(got, n, 0.75, 30, 5.0, block=block,
                        counts=counts_host)
    assert r_full.regions == r_nc.regions and len(r_nc.regions) >= 1
