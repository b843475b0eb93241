"""Device windowed-distribution engine vs the sequential oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from kmer_spans.encoding import kmer_to_code, pack
from kmer_spans.ops.blocked import blocked_codes
from kmer_spans.ops.window import blocked_prefix_sum, windowed_counts_device
from kmer_spans.oracle import windowed_distributions

from conftest import random_seq


def _device_window(seq, kmers, k, window, block=512):
    p = pack(seq)
    npad = -(-p.n // block) * block
    b = np.zeros(npad, np.uint8)
    b[: p.n] = p.bases
    v = np.zeros(npad, bool)
    v[: p.n] = p.valid
    b2 = jnp.asarray(b).reshape(-1, block).astype(jnp.int32)
    v2 = jnp.asarray(v).reshape(-1, block)
    codes, kv = blocked_codes(b2, v2, k)
    codes = jnp.where(kv, codes, 0)
    tracked = jnp.asarray(
        np.array([kmer_to_code(x) for x in kmers], dtype=np.int32))
    dist, cpos, wv = windowed_counts_device(
        codes, kv, v2, tracked, k, window, with_positions=True)
    return np.asarray(dist), np.asarray(cpos)[:, : p.n], np.asarray(wv)


def test_blocked_prefix_sum():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 5, size=(70, 128)).astype(np.int32)
    got = np.asarray(blocked_prefix_sum(jnp.asarray(x), rows_per_step=16))
    np.testing.assert_array_equal(got.reshape(-1), np.cumsum(x.reshape(-1)))


def test_device_window_hand_trace():
    names = ["CG", "GC", "CC", "CA", "AA", "AT", "TG"]
    expect = {"CG": (3, 2), "GC": (1, 4), "CC": (2, 3), "CA": (1, 4),
              "AA": (0, 5), "AT": (1, 4), "TG": (2, 3)}
    dist, cpos, wv = _device_window("CGCCAATGCG", names, 2, 6)
    for i, nm in enumerate(names):
        assert tuple(dist[:2, i]) == expect[nm], nm
    assert list(cpos[0][:5]) == [1, 0, 0, 0, 1]  # CG per-window counts


@pytest.mark.parametrize("seed", range(3))
def test_device_window_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    seq = random_seq(rng, 6000, n_prob=0.01)
    kmers = ["ACG", "TTT", "GAG"]
    k, window = 3, 24
    tracked = np.array([kmer_to_code(x) for x in kmers])
    oracle_dist = windowed_distributions(seq, tracked, k, window)
    oracle_pos = np.zeros((len(seq), len(kmers)), dtype=np.int64)
    windowed_distributions(seq, tracked, k, window, counts_pos=oracle_pos)
    dist, cpos, wv = _device_window(seq, kmers, k, window)
    np.testing.assert_array_equal(dist[: window + 1], oracle_dist)
    np.testing.assert_array_equal(cpos.T, oracle_pos)


def test_streaming_window_engine_matches_oracle():
    """Chunked streaming engine (one program, window lookahead, packed
    positions): dist AND per-position counts must equal the oracle across
    chunk boundaries and N gaps, for sequences shorter and longer than
    the chunk."""
    from kmer_spans.parallel.window_stream import StreamingWindowEngine

    rng = np.random.default_rng(3)
    k, window = 2, 20
    kmers = ["CG", "GC", "AT"]
    tracked = np.array([kmer_to_code(x) for x in kmers], dtype=np.int32)
    eng = StreamingWindowEngine(k, window, len(tracked),
                                chunk=8192, block=512)
    for n in (5_000, 8192, 30_000):  # below, exactly, and above the chunk
        seq = random_seq(rng, n, n_prob=0.01)
        p = pack(seq)
        nb = p.bases.copy()
        nb[~p.valid] = 4
        dist, cpos = eng.run(nb, tracked, with_positions=True)
        want_d = np.zeros((window + 1, len(kmers)), dtype=np.int64)
        want_c = np.zeros((p.n, len(kmers)), dtype=np.int64)
        windowed_distributions(p, tracked.astype(np.int64), k, window,
                               want_d, want_c)
        assert np.array_equal(dist, want_d), n
        assert np.array_equal(cpos, want_c), n


def test_streaming_window_engine_int16_positions():
    """window + 2 > 255 switches the packed positions to int16."""
    from kmer_spans.parallel.window_stream import StreamingWindowEngine

    rng = np.random.default_rng(5)
    k, window = 1, 300
    tracked = np.array([kmer_to_code("A")], dtype=np.int32)
    eng = StreamingWindowEngine(k, window, 1, chunk=8192, block=512)
    assert eng._pos_dtype == np.int16
    seq = "A" * 700 + random_seq(rng, 10_000)
    p = pack(seq)
    nb = p.bases.copy()
    nb[~p.valid] = 4
    dist, cpos = eng.run(nb, tracked, with_positions=True)
    want_d = np.zeros((window + 1, 1), dtype=np.int64)
    want_c = np.zeros((p.n, 1), dtype=np.int64)
    windowed_distributions(p, tracked.astype(np.int64), k, window,
                           want_d, want_c)
    assert np.array_equal(dist, want_d)
    assert np.array_equal(cpos, want_c)
    assert int(cpos.max()) > 255  # counts genuinely exceed uint8


def test_windowed_multi_sequence_matches_per_sequence():
    """Per-sequence mode (one program for a scaffold cohort) must equal
    running the engine per scaffold — the device mclapply shape
    (test.R:553-567)."""
    import jax.numpy as jnp
    import numpy as np

    from kmer_spans.ops.blocked import blocked_codes
    from kmer_spans.ops.window import windowed_counts_device

    rng = np.random.default_rng(99)
    k, window, B = 2, 40, 256
    tracked = jnp.arange(16, dtype=jnp.int32)
    lens = [1000, 3000, 513, 2048]
    seqs = [rng.integers(0, 4, size=L, dtype=np.uint8) for L in lens]
    seqs[1][100:130] = 4  # interior N run
    # concatenate with single-N separators + segment ids
    total = sum(lens) + len(lens) - 1
    npad = -(-total // B) * B
    cat = np.full(npad, 4, np.uint8)
    seg = np.zeros(npad, np.int32)
    pos = 0
    offs = []
    for i, s in enumerate(seqs):
        if i:
            pos += 1
        offs.append(pos)
        cat[pos:pos + len(s)] = s
        seg[pos:] = i
        pos += len(s)
    b2 = jnp.asarray(cat & 3).reshape(-1, B).astype(jnp.int32)
    v2 = jnp.asarray(cat < 4).reshape(-1, B)
    codes, kv = blocked_codes(b2, v2, k)
    dist_multi, _, _ = windowed_counts_device(
        codes, kv, v2, tracked, k, window,
        seg2d=jnp.asarray(seg).reshape(-1, B), n_seqs=len(seqs))
    dist_multi = np.asarray(dist_multi)
    assert dist_multi.shape == (len(seqs), window + 1, 16)
    for i, s in enumerate(seqs):
        n1 = -(-len(s) // B) * B
        one = np.full(n1, 4, np.uint8)
        one[:len(s)] = s
        b1 = jnp.asarray(one & 3).reshape(-1, B).astype(jnp.int32)
        v1 = jnp.asarray(one < 4).reshape(-1, B)
        c1, kv1 = blocked_codes(b1, v1, k)
        d1, _, _ = windowed_counts_device(c1, kv1, v1, tracked, k, window)
        assert np.array_equal(dist_multi[i], np.asarray(d1)), i
