"""Device ops vs oracle: codes, counting, scan — differential tests on CPU
(8 virtual devices; the same code path compiles for the GPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmer_spans.encoding import kmer_codes_np, pack
from kmer_spans.ops.codes import kmer_codes
from kmer_spans.ops.count import count_spectrum_scatter, count_spectrum_sort
from kmer_spans.ops.scan import span_scan, span_scan_blocked
from kmer_spans.oracle import count_spectrum

from conftest import random_seq


def _rand(rng, n, n_prob=0.02):
    return random_seq(rng, n, n_prob)


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_device_codes_match_host(rng, k):
    seq = _rand(rng, 3000)
    p = pack(seq)
    h_codes, h_valid = kmer_codes_np(p, k)
    d_codes, d_valid, d_scored = kmer_codes(
        jnp.asarray(p.bases), jnp.asarray(p.valid), k
    )
    d_codes, d_valid, d_scored = map(np.asarray, (d_codes, d_valid, d_scored))
    assert (d_valid == h_valid).all()
    assert (d_codes[h_valid] == h_codes[h_valid]).all()
    # scored = valid kmers whose next byte exists and is valid
    nv = np.zeros(p.n, bool)
    nv[:-1] = p.valid[1:]
    assert (d_scored == (h_valid & nv)).all()


@pytest.mark.parametrize("strategy", ["scatter", "sort"])
@pytest.mark.parametrize("k", [2, 6])
def test_device_count_matches_oracle(rng, strategy, k):
    seq = _rand(rng, 20_000, n_prob=0.01)
    p = pack(seq)
    oracle_counts, n = count_spectrum(p, k)
    codes, kv, _ = kmer_codes(jnp.asarray(p.bases), jnp.asarray(p.valid), k)
    fn = count_spectrum_sort if strategy == "sort" else count_spectrum_scatter
    dev = np.asarray(fn(codes, kv, k))
    assert (dev == oracle_counts).all()
    assert int(np.asarray(kv.sum())) == n


def _seq_scan_ref(s, scored):
    """Direct sequential reference for S_i = max(S_{i-1}+s_i, 0) w/ resets."""
    S = np.zeros_like(s)
    prev = 0.0
    for i in range(len(s)):
        if scored[i]:
            prev = max(prev + s[i], 0.0)
        else:
            prev = 0.0
        S[i] = prev
    return S


def test_span_scan_matches_sequential(rng):
    n = 4096
    s = rng.normal(size=n)
    scored = rng.random(n) > 0.2
    S, (A, B) = span_scan(jnp.asarray(s), jnp.asarray(scored))
    ref = _seq_scan_ref(s, scored)
    np.testing.assert_allclose(np.asarray(S), ref, rtol=1e-12, atol=1e-12)


def test_span_scan_blocked_matches_unblocked(rng):
    n = 10_000  # deliberately not a multiple of the block
    s = rng.normal(size=n)
    scored = rng.random(n) > 0.3
    S, _ = span_scan(jnp.asarray(s), jnp.asarray(scored))
    Sb = span_scan_blocked(jnp.asarray(s), jnp.asarray(scored), block=1024)
    np.testing.assert_allclose(np.asarray(Sb), np.asarray(S), rtol=1e-12)


def test_span_scan_carry_composes():
    # splitting a stream in two and carrying (A,B) equals one scan
    rng = np.random.default_rng(7)
    s = rng.normal(size=2048)
    scored = np.ones(2048, bool)
    S_full, _ = span_scan(jnp.asarray(s), jnp.asarray(scored))
    S1, (A1, B1) = span_scan(jnp.asarray(s[:1000]), jnp.asarray(scored[:1000]))
    S2, _ = span_scan(jnp.asarray(s[1000:]), jnp.asarray(scored[1000:]))
    # apply carry to second block's prefixes
    from kmer_spans.ops.scan import score_elements, _combine
    import jax.lax as lax

    a, b = score_elements(jnp.asarray(s[1000:]), jnp.asarray(scored[1000:]))
    A, B = lax.associative_scan(_combine, (a, b))
    S_in = jnp.maximum(A1[..., None] * 0 + np.asarray(S_full)[999], 0)  # scalar S at split
    S2_fixed = jnp.maximum(np.asarray(S_full)[999] + A, B)
    np.testing.assert_allclose(
        np.asarray(S2_fixed), np.asarray(S_full)[1000:], rtol=1e-12
    )


@pytest.mark.parametrize("size,shape,hot", [
    (64, (5000,), False),
    (4 ** 4, (5000,), True),
    (4 ** 8, (64, 512), True),
    (1000, (3, 4000), False),
    (256 * 256, (40000,), False),
])
def test_histogram_matches_bincount(size, shape, hot):
    """ops.count.histogram == np.bincount over the valid values, at
    power-of-four, non-power-of-two and (value, high-byte) table sizes;
    ``hot`` piles a fifth of the values into one bin (a repeat island)."""
    from kmer_spans.ops.count import histogram

    r = np.random.default_rng(size)
    vals = r.integers(0, size, size=shape).astype(np.int32)
    if hot:
        vals.reshape(-1)[: vals.size // 5] = size // 3
    valid = r.random(shape) > 0.25
    got = np.asarray(histogram(jnp.asarray(vals), jnp.asarray(valid), size))
    ref = np.bincount(vals[valid], minlength=size)
    assert got.dtype == np.int32 and got.shape == (size,)
    assert np.array_equal(got, ref)
