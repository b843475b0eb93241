"""ops/gather.py: packed rank-class tables and the class screen.

Checks (8 virtual CPU devices via conftest):
  * packing layout of class_table_from_mass
  * the class screen's per-block summaries (tA, tB, maxA, maxB) against
    a numpy reference of the gather + max-plus scan
  * screening scores are a SOUND upper bound on true rank scores
    (the invariant the span pipeline's candidate discovery relies on)
"""

import numpy as np
import jax.numpy as jnp
import pytest

from kmer_spans.ops.blocked import blocked_scan_summaries_int
from kmer_spans.ops.gather import (
    CLASS_LEVELS,
    SCREEN_SCALE,
    class_nibbles,
    class_screen_scores,
    class_scores_int,
    class_table_from_mass,
    screen_thr_q,
)


def _mass_from_counts(counts):
    order = np.argsort(counts, kind="stable")
    mass = np.zeros(counts.shape[0], np.int64)
    mass[order] = np.concatenate([[0], np.cumsum(counts[order])[:-1]])
    return mass


def _np_block_summaries(s, scored):
    """Sequential numpy (tA, tB, maxA, maxB) per row: A = running sum of
    scored scores, B = A minus the running min of A over scored
    positions (2^30 before the first one)."""
    out = []
    for srow, mrow in zip(s, scored):
        a = np.where(mrow, srow, 0).astype(np.int64)
        A = np.cumsum(a)
        M = np.minimum.accumulate(np.where(mrow, A, 1 << 30))
        B = A - M
        out.append((A[-1], B[-1], A.max(), B.max()))
    return [np.array(col) for col in zip(*out)]


@pytest.mark.parametrize("k", [4, 6, 8])
def test_class_screen_summaries_match_numpy(k):
    """The plain class screen (packed-word gather -> nibble -> integer
    score -> per-block scan) gives exactly the numpy reference's int32
    summaries, on a skewed spectrum with unscored gaps."""
    rng = np.random.default_rng(31 + k)
    size = 1 << (2 * k)
    nb, block = 6, 1024
    codes = rng.integers(0, size, size=(nb, block)).astype(np.int32)
    codes[2, 100:400] = 5  # one hot bin, as a poly-dinucleotide island
    scored = rng.random((nb, block)) > 0.1
    scored[4, :300] = False
    counts = np.bincount(codes[scored], minlength=size)
    mass = _mass_from_counts(counts)
    total = np.float32(counts.sum())
    thr_q = screen_thr_q(jnp.float32(0.7))
    words = class_table_from_mass(jnp.asarray(mass.astype(np.int32)),
                                  jnp.float32(total))
    s_int = class_scores_int(
        class_nibbles(words, jnp.asarray(codes)), thr_q)
    got = blocked_scan_summaries_int(s_int, jnp.asarray(scored))

    rank = mass.astype(np.float32) / total
    cls = np.clip((rank * CLASS_LEVELS).astype(np.int32), 0,
                  CLASS_LEVELS - 1)
    s_ref = (cls[codes] + 1) * (SCREEN_SCALE // CLASS_LEVELS) + 3 \
        - int(thr_q)
    ref = _np_block_summaries(s_ref, scored)
    for g, r in zip(got, ref):
        assert np.array_equal(np.asarray(g).astype(np.int64), r)


@pytest.mark.parametrize("k", [4, 8])
def test_class_table_packing(k):
    rng = np.random.default_rng(k)
    size = 1 << (2 * k)
    counts = rng.integers(0, 50, size=size)
    mass = _mass_from_counts(counts)
    total = float(counts.sum())
    packed = np.asarray(class_table_from_mass(
        jnp.asarray(mass.astype(np.int32)), jnp.float32(total)))
    rank = mass.astype(np.float32) / np.float32(total)
    cls = np.clip((rank * CLASS_LEVELS).astype(np.int32), 0,
                  CLASS_LEVELS - 1)
    ref = (cls.reshape(-1, 8) << (np.arange(8) * 4)).sum(axis=1)
    assert np.array_equal(packed, ref.astype(np.int32))


@pytest.mark.parametrize("k,thr", [(4, 0.5), (6, 0.75), (8, 0.9)])
def test_screen_scores_sound_upper_bound(k, thr):
    rng = np.random.default_rng(17 + k)
    size = 1 << (2 * k)
    counts = rng.integers(0, 100, size=size)
    mass = _mass_from_counts(counts)
    total = float(counts.sum())
    words = class_table_from_mass(
        jnp.asarray(mass.astype(np.int32)), jnp.float32(total))
    codes = rng.integers(0, size, size=20000).astype(np.int32)
    s = np.asarray(class_screen_scores(
        words, jnp.asarray(codes), jnp.float32(thr)))
    true_s = mass[codes].astype(np.float64) / total - thr
    assert (s >= true_s - 1e-7).all()
    # and not uselessly loose: within one quantization level + slack
    assert (s - true_s <= 1.0 / CLASS_LEVELS + 1e-4).all()
