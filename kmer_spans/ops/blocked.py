"""2D-blocked device ops: genome as (nb, block) tiles.

The genome lives as (nb, 8192) 2D tiles rather than one flat axis of
tens of millions of elements: every scan then compiles to one small loop
body over row groups, whatever n is.  Every op here is a static 2D
slice/concat/elementwise:

  * halo_blocks      — prepend each block with the previous block's tail
                       (the k-1 rolling-code halo; row 0 gets zeros)
  * blocked_codes    — k shifted fused ors along axis 1 (no cumsum)
  * blocked_kmer_valid — windowed AND of k shifted validity slices
  * blocked_scan     — max-plus scan along axis 1 + tiny cross-block
                       composition scan along axis 0

The same shapes serve the single-chip pipeline (spans/pipeline.py) and the
per-shard body of the multi-chip pipeline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .scan import _combine


def halo_blocks(x: jax.Array, h: int, fill=0, first=None):
    """[nb, B] -> [nb, h+B]: row i gets row i-1's last h columns as prefix.

    Row 0's prefix is ``first`` ([h]) if given (e.g. the previous device's
    tail in the multi-chip pipeline), else ``fill``.
    """
    nb, B = x.shape
    tail = x[:-1, B - h :]
    if first is None:
        first_row = jnp.full((1, h), fill, dtype=x.dtype)
    else:
        first_row = first.reshape(1, h).astype(x.dtype)
    return jnp.concatenate([jnp.concatenate([first_row, tail], 0), x], axis=1)


def blocked_codes(
    bases2d: jax.Array,
    valid2d: jax.Array,
    k: int,
    first_bases=None,
    first_valid=None,
):
    """Codes + kmer validity per block (end-position convention).

    bases2d/valid2d: [nb, B] (2-bit values / non-N flags).
    first_bases/first_valid ([k-1]) seed row 0's halo (multi-chip: the
    previous device's trailing bases; default: invalid, i.e. genome start).
    Returns codes [nb, B] i32 (zeroed where invalid), kmer_valid [nb, B].
    """
    h = k - 1
    eb = halo_blocks(bases2d.astype(jnp.int32), h, first=first_bases)
    ev = halo_blocks(valid2d, h, fill=False, first=first_valid)
    B = bases2d.shape[1]
    code = eb[:, h : h + B]
    kv = ev[:, h : h + B]
    for j in range(1, k):
        code = code | (eb[:, h - j : h - j + B] << (2 * j))
        kv = kv & ev[:, h - j : h - j + B]
    # positions before the very first k-1 bases of the genome are handled by
    # the zero/False fill of row 0's halo.
    return code, kv


#: widest k for (hi, lo) pair codes: hi holds bits 16..2k-1 < 2^30
WIDE_MAX_K = 23


def blocked_codes_wide(
    bases2d: jax.Array,
    valid2d: jax.Array,
    k: int,
    first_bases=None,
    first_valid=None,
):
    """Wide-code variant of blocked_codes for 16 <= k <= WIDE_MAX_K.

    A k-mer code needs 2k > 31 bits, so it travels as an int32 pair:
    ``lo`` = the low 16 bits (the rolling 8-mer ending at the position),
    ``hi`` = bits 16..2k-1 (the (k-8)-mer ending 8 positions earlier).
    Returns (hi, lo, kmer_valid), each [nb, B]; hi/lo are zeroed-garbage
    where invalid (consumers mask by kmer_valid), and ``lo & 3`` is still
    the 2-bit base at the position (the packed-bases candidate pull
    relies on this, as in the narrow path).
    """
    if not 16 <= k <= WIDE_MAX_K:
        raise ValueError(f"wide codes need 16 <= k <= {WIDE_MAX_K}")
    h = k - 1
    eb = halo_blocks(bases2d.astype(jnp.int32), h, first=first_bases)
    ev = halo_blocks(valid2d, h, fill=False, first=first_valid)
    B = bases2d.shape[1]
    lo = eb[:, h : h + B]
    kv = ev[:, h : h + B]
    for j in range(1, 8):
        lo = lo | (eb[:, h - j : h - j + B] << (2 * j))
        kv = kv & ev[:, h - j : h - j + B]
    hi = eb[:, h - 8 : h - 8 + B]
    kv = kv & ev[:, h - 8 : h - 8 + B]
    for j in range(9, k):
        hi = hi | (eb[:, h - j : h - j + B] << (2 * (j - 8)))
        kv = kv & ev[:, h - j : h - j + B]
    return hi, lo, kv


def blocked_scored(valid2d: jax.Array, kmer_valid: jax.Array, next_valid=None):
    """Scored mask: kmer valid AND the NEXT byte exists and is non-N.

    The next byte of a block's last column is the next block's first column;
    the final position's next byte is ``next_valid`` (scalar; multi-chip:
    the next device's first byte validity; default False = genome end) —
    matching the reference's never-score-the-segment's-last-kmer rule.
    """
    nb, B = valid2d.shape
    last = (
        jnp.zeros((1, 1), bool)
        if next_valid is None
        else jnp.asarray(next_valid).reshape(1, 1)
    )
    nxt = jnp.concatenate(
        [valid2d[:, 1:],
         jnp.concatenate([valid2d[1:, :1], last], 0)],
        axis=1,
    )
    return kmer_valid & nxt


def blocked_scan_prefixes(
    s2d: jax.Array, scored2d: jax.Array, rows_per_step: int = 64
):
    """Inclusive max-plus prefix transforms over row-major [nb, B] tiles.

    Returns (FA, FB, (tA, tB)): the composed prefix transform at every
    position — S at (i, j) for incoming state x is max(x + FA[i,j],
    FB[i,j]) — plus the whole-array transform scalars for cross-chunk /
    cross-device carries.

    Scan-of-scans structure: a lax.scan over groups of ``rows_per_step``
    rows, each group handled by a parallel associative_scan along lanes —
    the XLA program contains ONE small loop body instead of log2(n) levels
    of full-array slicing, which keeps compile time flat in n.
    """
    neg = jnp.array(-jnp.inf, dtype=s2d.dtype)
    nb, B = s2d.shape
    a = jnp.where(scored2d, s2d, neg)
    b = jnp.zeros_like(s2d)
    R = min(rows_per_step, nb)
    pad_rows = (-nb) % R
    if pad_rows:
        # identity elements f(x) = x: (a, b) = (0, -inf)
        a = jnp.concatenate([a, jnp.zeros((pad_rows, B), a.dtype)])
        b = jnp.concatenate([b, jnp.full((pad_rows, B), neg, b.dtype)])
    G = a.shape[0] // R
    a3 = a.reshape(G, R, B)
    b3 = b.reshape(G, R, B)

    def body(carry, xs):
        inA, inB = carry
        ar, br = xs  # [R, B]
        A, Bv = jax.lax.associative_scan(_combine, (ar, br), axis=1)
        tA, tB = A[:, -1], Bv[:, -1]
        cA, cB = jax.lax.associative_scan(_combine, (tA, tB))
        zero = jnp.zeros((1,), ar.dtype)
        RA = jnp.concatenate([zero, cA[:-1]])
        RB = jnp.concatenate([jnp.full((1,), -jnp.inf, ar.dtype), cB[:-1]])
        # incoming carry ∘ row-exclusive-within-group
        fullRA = inA + RA
        fullRB = jnp.maximum(inB + RA, RB)
        FA = fullRA[:, None] + A
        FB = jnp.maximum(fullRB[:, None] + A, Bv)
        newA = inA + cA[-1]
        newB = jnp.maximum(inB + cA[-1], cB[-1])
        return (newA, newB), (FA, FB)

    init = (jnp.zeros((), s2d.dtype), jnp.full((), neg, s2d.dtype))
    (tA, tB), (FA3, FB3) = jax.lax.scan(body, init, (a3, b3))
    FA = FA3.reshape(-1, B)[:nb]
    FB = FB3.reshape(-1, B)[:nb]
    return FA, FB, (tA, tB)


def blocked_scan_summaries(
    s2d: jax.Array, scored2d: jax.Array, rows_per_step: int | None = None
):
    """Per-row max-plus scan summaries WITHOUT materializing prefixes.

    Returns (block_max, block_last), both [nb]: the row's running-score
    max and its value at the row end, for initial state 0 at row 0.

    Cheaper algebra than the (a, b)-pair associative scan: with
    per-position transforms f(x) = max(x + s, 0) (scored) / identity
    (unscored), the inclusive prefix transform at j is
        A_j = cumsum of s over scored positions <= j          (plain add)
        B_j = A_j - min over scored i <= j of A_i             (cummin)
    so one cumsum + one cummin replace the 2-tuple combine, and the row
    summaries are plain maxes:
        S_j(x) = max(x + A_j, B_j)
        row max  = max(x + max_j A_j, max_j B_j)
        row last = max(x + A_end, B_end).
    Cross-row state is the usual tiny (tA, tB) composition scan.

    SCREENING SEMANTICS (deliberate, sound over-approximation): unscored
    positions pass the state through (identity) instead of the exact
    scan's reset-to-0 (ops/scan.py score_elements).  Since every max-plus
    transform is monotone and states are nonnegative, the returned
    summaries are pointwise >= the exact scan's — candidate screening can
    only ADD blocks around N-gaps, never lose a region; emitted spans are
    unaffected (the host finisher replays candidates exactly, with true
    resets).  The identity element is what makes A a PLAIN cumsum — the
    reset transform is not expressible that way — and buys the ~2.3x over
    the (a, b)-pair scan.
    """
    neg = jnp.array(-jnp.inf, dtype=s2d.dtype)
    nb, B = s2d.shape
    a = jnp.where(scored2d, s2d, jnp.zeros_like(s2d))
    if rows_per_step is None:
        # constant work per sequential scan step (~512K elements)
        rows_per_step = max(8, (64 * 8192) // B)
    R = min(rows_per_step, nb)
    pad_rows = (-nb) % R
    if pad_rows:
        a = jnp.concatenate([a, jnp.zeros((pad_rows, B), a.dtype)])
        scored2d = jnp.concatenate(
            [scored2d, jnp.zeros((pad_rows, B), bool)]
        )
    G = a.shape[0] // R
    a3 = a.reshape(G, R, B)
    m3 = scored2d.reshape(G, R, B)

    def body(_, xs):
        ar, mr = xs  # [R, B]
        A = jnp.cumsum(ar, axis=1)
        P = jnp.where(mr, A, -neg)  # +inf where unscored
        M = jax.lax.associative_scan(jnp.minimum, P, axis=1)
        Bv = A - M  # -inf while no scored position seen yet
        return None, (A[:, -1], Bv[:, -1], A.max(axis=1), Bv.max(axis=1))

    _, (tA, tB, maxA, maxB) = jax.lax.scan(body, None, (a3, m3))
    tA = tA.reshape(-1)[:nb]
    tB = tB.reshape(-1)[:nb]
    maxA = maxA.reshape(-1)[:nb]
    maxB = maxB.reshape(-1)[:nb]
    # cross-row composition: x entering row j (exclusive, from 0)
    cA, cB = jax.lax.associative_scan(_combine, (tA, tB))
    block_last = jnp.maximum(cA, cB)
    x_in = jnp.concatenate([jnp.zeros((1,), s2d.dtype), block_last[:-1]])
    block_max = jnp.maximum(x_in + maxA, maxB)
    return block_max, block_last


#: int32 "-inf" sentinel for B-parts of integer screen summaries: a row
#: with no scored position yet has B = 0 - 2^30; anything <= SCREEN_NEG/2
#: decodes as true -inf on the host.
SCREEN_NEG = -(1 << 30)


def blocked_scan_summaries_int(
    s2d: jax.Array, scored2d: jax.Array, rows_per_step: int | None = None
):
    """Integer per-row max-plus summaries, NO cross-row composition.

    s2d: int32 screen scores (units of 2^-12 rank; ops/gather.py
    class_scores_int / fine_scores_int).  Returns per-row int32 vectors
    (tA, tB, maxA, maxB): the row transform is x -> max(x + tA, tB) and
    the row's running max from incoming x is max(x + maxA, maxB).
    B-parts use the SCREEN_NEG sentinel for "no scored position yet".

    Within a row everything is EXACT int32 (|sums| <= 8192 * 2^13 < 2^27);
    callers compose rows exactly in int64 on the host (soundness) and
    approximately in f32 on device (top-k ordering only) — see
    compose_summaries_f32 / spans.pipeline.compose_summaries_exact.

    Same identity-at-unscored over-approximation as
    blocked_scan_summaries (sound; finisher replays candidates exactly).
    """
    nb, B = s2d.shape
    inf = jnp.int32(1 << 30)
    a = jnp.where(scored2d, s2d, 0).astype(jnp.int32)
    if rows_per_step is None:
        rows_per_step = max(8, (64 * 8192) // B)
    R = min(rows_per_step, nb)
    pad_rows = (-nb) % R
    if pad_rows:
        a = jnp.concatenate([a, jnp.zeros((pad_rows, B), a.dtype)])
        scored2d = jnp.concatenate(
            [scored2d, jnp.zeros((pad_rows, B), bool)]
        )
    G = a.shape[0] // R
    a3 = a.reshape(G, R, B)
    m3 = scored2d.reshape(G, R, B)

    def body(_, xs):
        ar, mr = xs  # [R, B]
        A = jnp.cumsum(ar, axis=1)
        P = jnp.where(mr, A, inf)
        M = jax.lax.associative_scan(jnp.minimum, P, axis=1)
        Bv = A - M  # >= -2^30 - 2^27: no int32 overflow
        return None, (A[:, -1], Bv[:, -1], A.max(axis=1), Bv.max(axis=1))

    _, (tA, tB, maxA, maxB) = jax.lax.scan(body, None, (a3, m3))
    return (
        tA.reshape(-1)[:nb],
        tB.reshape(-1)[:nb],
        maxA.reshape(-1)[:nb],
        maxB.reshape(-1)[:nb],
    )


def compose_summaries_f32(tA, tB, maxA, maxB):
    """Approximate f32 cross-row composition (device; top-k ordering only).

    Returns (block_max, block_last) f32 — the soundness-critical
    composition happens again on the host in exact int64.
    """
    neg = jnp.float32(-jnp.inf)
    sent = SCREEN_NEG // 2
    tAf = tA.astype(jnp.float32)
    tBf = jnp.where(tB <= sent, neg, tB.astype(jnp.float32))
    maxBf = jnp.where(maxB <= sent, neg, maxB.astype(jnp.float32))
    cA, cB = jax.lax.associative_scan(_combine, (tAf, tBf))
    block_last = jnp.maximum(cA, cB)
    x_in = jnp.concatenate(
        [jnp.zeros((1,), jnp.float32), block_last[:-1]]
    )
    block_max = jnp.maximum(x_in + maxA.astype(jnp.float32), maxBf)
    return block_max, block_last


def blocked_scan(s2d: jax.Array, scored2d: jax.Array):
    """Max-plus scan over row-major [nb, B] tiles, initial state 0.

    Returns S [nb, B] plus the whole-array transform (A, B) scalars.
    """
    FA, FB, total = blocked_scan_prefixes(s2d, scored2d)
    return jnp.maximum(FA, FB), total
