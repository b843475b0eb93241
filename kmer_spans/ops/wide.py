"""Exact wide-integer accumulation on device via (hi, lo) int32 pairs.

Device programs run with x64 disabled (jnp silently truncates int64),
but the rank chain must stay exact past 2^31 total k-mers (the reference
accumulates in f64, src/kmer_spans.c:198-200; exact to 2^53 there).  A
value V is carried as V = hi * 2^16 + lo with the CANONICAL form
0 <= lo < 2^16, hi < 2^31 — exact to 2^47 (a 140-Tbase genome).

The trick everywhere: linear reductions (cumsums, histograms, psums)
distribute over the channels, so each channel is reduced with plain int32
ops in SEGMENTS small enough that no channel can overflow (segment sums
< 2^14 * 2^16 = 2^30), renormalizing the running pair between segments.
All functions return canonical pairs and assume true values < 2^47.

Genome totals themselves are host scalars (counts are pulled once per
genome for the exact replay) — no device-side grand total is needed.

Used by the streaming count accumulator (parallel/stream.py), the wide
sharded rank step, and the sharded scan's mass payloads
(parallel/sharded_scan.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: segment length keeping a lo-channel segment sum below 2^30
SEG = 1 << 14

_MASK = 0xFFFF


def renorm(hi, lo):
    """Canonicalize a pair: fold lo's overflow into hi (lo >= 0)."""
    return hi + (lo >> 16), lo & _MASK


def split(v32):
    """Non-negative int32 -> canonical pair."""
    return v32 >> 16, v32 & _MASK


def to_f32(hi, lo):
    """f32 approximation of the pair value (one rounding on the add)."""
    return hi.astype(jnp.float32) * 65536.0 + lo.astype(jnp.float32)


def pair_cumsum(x_hi, x_lo):
    """Exact inclusive cumsum of a 1D canonical pair array.

    True running totals must stay < 2^47 (then every int32 intermediate
    below is provably in range: the hi>>16 channel's scaled contribution
    2^32 * c_hh < 2^47 keeps c_hh < 2^15, so (c_hh << 16) < 2^31).
    Segment channel cumsums + a renormalized carry scan across segments.
    """
    n = x_hi.shape[0]
    pad = (-n) % SEG
    fh, fl = x_hi, x_lo
    if pad:
        fh = jnp.concatenate([fh, jnp.zeros(pad, jnp.int32)])
        fl = jnp.concatenate([fl, jnp.zeros(pad, jnp.int32)])
    G = fh.shape[0] // SEG
    h2 = fh.reshape(G, SEG)
    l2 = fl.reshape(G, SEG)
    c_lo = jnp.cumsum(l2, axis=1)              # < 2^14 * 2^16 = 2^30
    c_hl = jnp.cumsum(h2 & _MASK, axis=1)      # < 2^30
    c_hh = jnp.cumsum(h2 >> 16, axis=1)        # < 2^15 (value < 2^47)

    def body(carry, xs):
        chi, clo = carry  # canonical pair entering this segment
        slo, shl, shh = xs
        lo_full = clo + slo
        hi = chi + (shh << 16) + shl + (lo_full >> 16)
        lo = lo_full & _MASK
        return (hi[-1], lo[-1]), (hi, lo)

    (_, _), (hi, lo) = jax.lax.scan(
        body, (jnp.int32(0), jnp.int32(0)), (c_lo, c_hl, c_hh))
    return hi.reshape(-1)[:n], lo.reshape(-1)[:n]


def pair_scatter_add(size: int, idx, v32):
    """Exact histogram of int32 values (>= 0) per bin -> canonical pairs.

    idx: int32 bins in [0, size) (out-of-range contributions dropped).
    Segments of SEG elements keep each channel's per-segment gain < 2^30;
    the running histogram is renormalized between segments.
    """
    flat_i = idx.reshape(-1)
    flat_v = v32.reshape(-1)
    n = flat_i.shape[0]
    pad = (-n) % SEG
    if pad:
        flat_i = jnp.concatenate(
            [flat_i, jnp.full(pad, size, jnp.int32)])  # dropped
        flat_v = jnp.concatenate([flat_v, jnp.zeros(pad, jnp.int32)])
    G = flat_i.shape[0] // SEG
    i2 = flat_i.reshape(G, SEG)
    v2 = flat_v.reshape(G, SEG)

    def body(carry, xs):
        hi, lo = carry
        ii, vv = xs
        lo = lo.at[ii].add(vv & _MASK, mode="drop")
        hi = hi.at[ii].add(vv >> 16, mode="drop")
        hi, lo = renorm(hi, lo)
        return (hi, lo), None

    init = (jnp.zeros(size, jnp.int32), jnp.zeros(size, jnp.int32))
    (hi, lo), _ = jax.lax.scan(body, init, (i2, v2))
    return hi, lo


def pair_psum(hi, lo, axis_name: str):
    """Exact psum of canonical pairs over a mesh axis (n_dev <= 2^15)."""
    hi = jax.lax.psum(hi, axis_name)
    lo = jax.lax.psum(lo, axis_name)
    return renorm(hi, lo)
