"""Sort-based integer screen for k >= 10: no 4^k table on device, ever.

A table-based screen at k >= 10 needs a 4^k spectrum scatter, a 4^k
argsort for the mass and a per-position gather from a 4^k table.
Sorting the genome BY CODE instead reads each position's exact count
off its run length:

  1. sort (code, position); equal codes become contiguous runs, and a
     position's run length IS its k-mer's exact count in the chunk;
  2. two histograms over the runs give sound per-position rank upper
     bounds (derivation below);
  3. classes come from the same class_table_from_mass slack family as
     the k <= 9 screen (one-f32-rounding covered by class_scores_int),
     gathered from a small packed table (128 KB words);
  4. one more (position, s_int) sort restores genome order.

RANK UPPER BOUND (SURVEY A.2 sort order: count asc, code asc).  For a
code c with count v and high byte h = c >> (2k-8):

    mass(c) = below(v) + v * eqbelow(c)          [exact identity]
    below(v) = total mass at count values < v
    eqbelow(c) = # codes with count v and code < c

Since all count-v codes with a smaller high byte precede c, and c itself
is one of the count-v codes at high byte h:

    eqbelow(c) <= runs(v, high <= h) - 1
    mass(c)    <= below(v) + v * (runs(v, high <= h) - 1)   =: mass_ub2

The by-(value, high-byte) refinement is what makes the bound tight when
a single count value holds most of the mass (e.g. nearly-all-unique
k-mers at k >= 13, where a by-value-only bound degenerates to rank_ub
~= 1 for every position): the within-value inflation drops from
massfrac(v) to ~massfrac(v)/256.  Values v >= V2 fall back to the
by-value bound mass_ub1(v) = cummass(<= v) - v (>= mass(c) because
eqbelow <= n_v - 1), and values >= vmax screen as rank_ub = 1 — each
step coarser but still sound.

Exactness: the screen is a sound integer upper bound exactly like the
class/fine screens; emitted spans still come from the host finisher's
rank-chain replay (bit-identical to src/kmer_spans.c:198-202, 243-307).

This screen sees the spectrum of ITS OWN input — correct for the
one-shot pipeline where the chunk is the whole sequence set.  The
streaming pipeline (global spectrum across chunks) uses the row-gather
screen instead (ops/rowgather.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: count values >= VMAX screen as rank_ub = 1 (sound); the replay's
#: exactness never depends on this clip (host rank chain from counts).
VMAX = 1 << 16
#: count values < V2 get the (value, high-byte)-refined bound
V2 = 1 << 8


def rank_ub_histograms(v, hb, head_mask, vmax, v2):
    """The two run histograms the rank-upper-bound tables are built from.

    v/hb: per-element run length / top-8-bits; head_mask: True exactly
    once per REAL run (head & real).  Returns (vh_runs [vmax] — runs per
    count value — and h2 [v2*256] — runs per (value, high byte)).  In
    the sharded screen these are per-owner partials that psum to the
    global histograms (each global run is counted once, by its owner).
    """
    from .count import histogram

    vcl = jnp.minimum(v, vmax - 1)
    vh_runs = histogram(vcl, head_mask, vmax)
    idx2 = jnp.minimum(v, v2 - 1) * 256 + hb
    h2 = histogram(idx2, head_mask & (v < v2), v2 * 256)
    return vh_runs, h2


def rank_ub_tables(vh_runs, h2, total, vmax, v2):
    """Packed class words from the run histograms: the by-value table
    (vmax/8 words) followed by the (value, high-byte) table.

    mass_ub1(v) = cummass(<= v) - v (by-value bound); mass_ub2(v, h) =
    below(v) + v * (runs(v, high <= h) - 1) (the refinement for v < v2);
    the clipped bucket screens as rank_ub = 1.  See module docstring for
    the soundness derivation.
    """
    from .gather import class_table_from_mass

    i32 = jnp.int32
    w = jax.lax.iota(i32, vmax)
    cmass = jnp.cumsum(w * vh_runs)      # cummass(<= v); int32 (<= total)
    mass_ub1 = cmass - w
    # clipped bucket: force rank_ub = 1 (class top) — sound for any tail
    # (explicit int32: under jax_enable_x64 ``total`` may arrive int64
    # and implicit-downcast scatter is a FutureError)
    mass_ub1 = mass_ub1.at[vmax - 1].set(
        jnp.asarray(total, dtype=jnp.int32))
    cumh = jnp.cumsum(h2.reshape(v2, 256), axis=1)  # runs(v, high <= h)
    below = jnp.concatenate([jnp.zeros((1,), i32), cmass[: v2 - 1]])
    wv = jax.lax.iota(i32, v2)[:, None]
    mass_ub2 = below[:, None] + wv * (cumh - 1)
    total_f32 = total.astype(jnp.float32)
    words1 = class_table_from_mass(jnp.maximum(mass_ub1, 0), total_f32)
    words2 = class_table_from_mass(
        jnp.maximum(mass_ub2.reshape(-1), 0), total_f32)
    return jnp.concatenate([words1, words2])


def rank_ub_gather(words, v, hb, thr_q, vmax, v2):
    """Per-element integer screen scores from the rank_ub_tables words."""
    from .gather import class_nibbles, class_scores_int

    vcl = jnp.minimum(v, vmax - 1)
    vsm = v < v2
    idx2 = jnp.minimum(v, v2 - 1) * 256 + hb
    # entry index into the concatenated table: the (value, high-byte)
    # part starts after the vmax by-value entries
    entry = jnp.where(vsm, idx2 + vmax, vcl)
    return class_scores_int(class_nibbles(words, entry), thr_q)


def _rank_ub_scores(v, hb, head, real, total, thr_q, vmax, v2):
    """Shared rank-upper-bound screen from sorted runs (see module doc).

    v: int32 run length (exact count of the element's k-mer in the
    chunk); hb: its code's top 8 bits; head/real: run-head flag / not
    the invalid-sentinel run; total: counted k-mers (int32 scalar).
    Returns s_int for the SORTED order (callers unsort by position).
    """
    vh_runs, h2 = rank_ub_histograms(v, hb, head & real, vmax, v2)
    words = rank_ub_tables(vh_runs, h2, total, vmax, v2)
    return rank_ub_gather(words, v, hb, thr_q, vmax, v2)


def _run_lengths(head, n):
    """Exact run lengths from head flags over a sorted axis."""
    i32 = jnp.int32
    last = jnp.concatenate([head[1:], jnp.ones((1,), bool)])
    idx = jax.lax.iota(i32, n)
    start = jax.lax.cummax(jnp.where(head, idx, 0))
    end = jax.lax.cummin(
        jnp.where(last, idx + 1, jnp.int32(1 << 30)), reverse=True)
    return end - start


def sort_screen_scores(
    codes: jax.Array,
    kmer_valid: jax.Array,
    scored: jax.Array,
    k: int,
    thr_q: jax.Array,
    vmax: int = VMAX,
    v2: int = V2,
):
    """Integer upper-bound screen scores for every position, by sorting.

    codes: int32 [n] raw rolling codes (junk where invalid);
    kmer_valid/scored: bool [n].  Returns (s_int int32 [n] in genome
    order — junk where unscored, callers mask —, total int32 scalar =
    counted k-mers).  n must be < 2^31; 10 <= k <= 15 (codes < 2^30,
    high byte needs 2k >= 8).

    Reference parity: the scoring gather feeding kmer_regions
    (src/kmer_spans.c:268) with rank_kmers_w ranks (:189-202), as a
    sound screen; candidates replay exactly on the host.
    """
    v2 = min(v2, vmax)
    n = codes.shape[0]
    size = 1 << (2 * k)
    i32 = jnp.int32
    key = jnp.where(kmer_valid, codes, size)  # sentinel run at the end
    pos = jax.lax.iota(i32, n)
    skey, spos = jax.lax.sort((key, pos), num_keys=1)

    head = jnp.concatenate(
        [jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    v = _run_lengths(head, n)            # exact global count of my k-mer
    real = skey < size
    total = jnp.sum(kmer_valid.astype(i32))
    hb = (skey >> (2 * k - 8)) & 255
    s_sorted = _rank_ub_scores(v, hb, head, real, total, thr_q, vmax, v2)

    _, s_int = jax.lax.sort((spos, s_sorted), num_keys=1)
    return s_int, total


def sort_screen_scores_wide(
    hi: jax.Array,
    lo: jax.Array,
    kmer_valid: jax.Array,
    k: int,
    thr_q: jax.Array,
    vmax: int = VMAX,
    v2: int = V2,
):
    """The sort screen for WIDE codes (k >= 16): (hi, lo) int32 pairs.

    hi: bits 16..2k-1 of the code (< 2^(2k-16), int32 up to k = 23);
    lo: the low 16 bits.  Identical math to sort_screen_scores, with a
    2-key lax.sort and the high byte read from hi.  No 4^k anything —
    device memory is O(n), which is the whole point at k = 17 (a dense spectrum would be 68 GB;
    BASELINE config 5).

    Reference parity: the reference cannot reach k >= 16 at all (its
    MAX_K=16 is UB, SURVEY §2.1 #4); this extends the same
    rank_kmers_w/kmer_regions semantics (src/kmer_spans.c:189-202, :268)
    soundly past it.  Candidates still replay exactly on the host from a
    sparse recount.
    """
    v2 = min(v2, vmax)
    n = hi.shape[0]
    i32 = jnp.int32
    sent = jnp.int32(1 << 30)  # > any valid hi (k <= 23 -> hi < 2^30)
    key1 = jnp.where(kmer_valid, hi, sent)
    key2 = jnp.where(kmer_valid, lo, 0)
    pos = jax.lax.iota(i32, n)
    k1, k2, spos = jax.lax.sort((key1, key2, pos), num_keys=2)

    head = jnp.concatenate(
        [jnp.ones((1,), bool),
         (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])])
    v = _run_lengths(head, n)
    real = k1 < sent
    total = jnp.sum(kmer_valid.astype(i32))
    hb = (k1 >> (2 * k - 24)) & 255      # top 8 bits of the 2k-bit code
    s_sorted = _rank_ub_scores(v, hb, head, real, total, thr_q, vmax, v2)

    _, s_int = jax.lax.sort((spos, s_sorted), num_keys=1)
    return s_int, total
