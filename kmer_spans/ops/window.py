"""Windowed k-mer occurrence distributions on device (SURVEY §7.6).

The reference slides a two-pointer window with a full 4^k scratch array
(src/kmer_spans.c:413-449) — strictly sequential, one pass per sequence.
Data-parallel form: the occurrence count of k-mer w in the window starting
at t is a LOCAL windowed sum of w's indicator vector,

    occ[p]   = [code ending at p+k-1 == w]  (start-position convention)
    count[t] = sum of occ[t .. t+window-k]  (slots = window-k+1 starts)

so every window is independent and no global prefix sum is needed: one
lax.scan over row groups computes counts for ALL tracked k-mers at once
from a group + ``window``-element halo (ONE program regardless of how
many k-mers are tracked — the round-2 engine built one prefix-sum
program per k-mer, round-1 directive 8).

The count histogram runs as ONE histogram over combined (kmer, count)
indices (ops.count.histogram) — never a per-kmer pass.

Windows never span N gaps: a window is valid iff all its bases are non-N
(windowed sum of invalidity == 0), which also kills windows that cross
the padded tail.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def blocked_prefix_sum(x2d: jax.Array, rows_per_step: int = 64):
    """Inclusive prefix sum over row-major [nb, B] tiles (scan-of-scans)."""
    nb, B = x2d.shape
    R = min(rows_per_step, nb)
    pad = (-nb) % R
    if pad:
        x2d = jnp.concatenate(
            [x2d, jnp.zeros((pad, B), x2d.dtype)])
    G = x2d.shape[0] // R

    def body(carry, xr):
        inc = jnp.cumsum(xr, axis=1, dtype=x2d.dtype)  # [R, B] inclusive
        row_tot = inc[:, -1]
        row_off = carry + jnp.concatenate(
            [jnp.zeros((1,), x2d.dtype),
             jnp.cumsum(row_tot, dtype=x2d.dtype)[:-1]])
        out = inc + row_off[:, None]
        return carry + jnp.sum(row_tot, dtype=x2d.dtype), out

    _, out = jax.lax.scan(body, jnp.zeros((), x2d.dtype),
                          x2d.reshape(G, R, B))
    return out.reshape(-1, B)[:nb]


@functools.partial(
    jax.jit,
    static_argnames=("k", "window", "with_positions", "start_limit",
                     "n_seqs"),
)
def windowed_counts_device(
    codes2d: jax.Array,
    kmer_valid2d: jax.Array,
    valid2d: jax.Array,
    tracked: jax.Array,
    k: int,
    window: int,
    with_positions: bool = False,
    start_limit: int | None = None,
    seg2d: jax.Array | None = None,
    n_seqs: int | None = None,
):
    """Per-window occurrence counts + distributions for tracked k-mers.

    codes2d/kmer_valid2d: end-position blocked codes ([nb, B]).
    valid2d: non-N mask. tracked: [n_tracked] int32 codes.
    Returns (dist [window+1, n_tracked] int32,
             counts_pos [n_tracked, n] int16 or None,
             window_valid [n] bool) — counts_pos[w, t] is the count for the
    window starting at t (0 where invalid), matching the reference's
    kmer_counts_pos matrices.

    start_limit: treat window starts >= this position as invalid — the
    chunked streaming engine (parallel/window_stream.py) feeds each chunk
    with a ``window``-base lookahead and masks starts beyond the chunk so
    every window is counted exactly once across chunks.

    seg2d/n_seqs: PER-SEQUENCE mode for many-scaffold batches (the
    reference's mclapply workload, test.R:553-567): scaffolds
    concatenate with single-N separators (no window survives a
    separator), seg2d carries each position's scaffold id, and the
    count histogram runs over combined (scaffold, kmer, count) indices
    — ONE program and ONE dispatch for the whole cohort instead of one
    per scaffold.  dist is then [n_seqs, window+1, n_tracked].
    """
    from .count import histogram

    nb, B = codes2d.shape
    n = nb * B
    T = int(tracked.shape[0])
    flat_c = codes2d.reshape(-1)
    flat_kv = kmer_valid2d.reshape(-1)
    flat_v = valid2d.reshape(-1)

    RB = min(1 << 16, n)
    if window > RB:
        raise ValueError("window larger than the group width")
    if with_positions and window + 2 > 32767:
        raise ValueError("positions matrix is int16; window too large")
    pad = (-n) % RB
    if pad:
        flat_c = jnp.concatenate([flat_c, jnp.zeros((pad,), flat_c.dtype)])
        flat_kv = jnp.concatenate([flat_kv, jnp.zeros((pad,), bool)])
        flat_v = jnp.concatenate([flat_v, jnp.zeros((pad,), bool)])
    G = flat_c.shape[0] // RB

    def ext(x, fill):
        """[G*RB] -> [G, RB+window]: each group plus the next group's head."""
        x2 = x.reshape(G, RB)
        xp = jnp.concatenate(
            [x, jnp.full((RB,), fill, x.dtype)]).reshape(G + 1, RB)
        return jnp.concatenate([x2, xp[1:, :window]], axis=1)

    ec = ext(flat_c, 0)
    ekv = ext(flat_kv, False)
    ev = ext(flat_v, False)
    tr = tracked.astype(flat_c.dtype).reshape(T, 1)

    def body(_, xs):
        c, kvx, vx, g = xs                        # [RB+window], group idx
        occ = ((c[None, :] == tr) & kvx[None, :]).astype(jnp.int32)
        S = jnp.cumsum(occ, axis=1)
        Sx = jnp.concatenate(
            [jnp.zeros((T, 1), jnp.int32), S], axis=1)  # exclusive
        # count[t] = occ summed over start slots t..t+window-k
        # (end positions t+k-1 .. t+window-1)
        cnt = Sx[:, window:window + RB] - Sx[:, k - 1:k - 1 + RB]
        inv = (~vx).astype(jnp.int32)
        Pi = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(inv)])
        wv = (Pi[window:window + RB] - Pi[0:RB]) == 0
        if start_limit is not None:
            pos = g * RB + jnp.arange(RB, dtype=jnp.int32)
            wv = wv & (pos < start_limit)
        cnt = jnp.where(wv[None, :], cnt, 0)
        return None, (cnt.astype(jnp.int16), wv)

    _, (cnts, wvs) = jax.lax.scan(
        body, None, (ec, ekv, ev, jnp.arange(G, dtype=jnp.int32)))
    cnt_all = cnts.transpose(1, 0, 2).reshape(T, -1)[:, :n]
    window_valid = wvs.reshape(-1)[:n]

    # one histogram over combined (kmer, count) indices — plus the
    # scaffold id in per-sequence mode
    W2 = window + 2
    comb = cnt_all.astype(jnp.int32) + (
        jnp.arange(T, dtype=jnp.int32) * W2)[:, None]
    wv_all = jnp.broadcast_to(window_valid[None, :], comb.shape)
    if seg2d is not None:
        S = int(n_seqs)
        seg = seg2d.reshape(-1)[:n]
        comb = comb + (seg * (T * W2))[None, :]
        dist = histogram(comb, wv_all, S * T * W2).reshape(S, T, W2)[
            :, :, :window + 1].transpose(0, 2, 1)
    else:
        dist = histogram(comb, wv_all, T * W2).reshape(T, W2)[
            :, :window + 1].T

    # int16 positions matrix: counts <= window-k+2 (guarded by the RB
    # check above, window <= 65536 => fits) — half the D2H bytes of int32
    counts_pos = cnt_all if with_positions else None
    return dist, counts_pos, window_valid
