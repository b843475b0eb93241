"""The span-score recurrence S_i = max(S_{i-1} + s_i, 0) as a parallel scan.

The reference computes this with a strictly sequential per-base loop
(src/kmer_spans.c:268-270).  The data-parallel formulation (SURVEY §5.7):
``f(x) = max(x + a, b)`` functions are closed under composition,

    (f2 ∘ f1)(x) = max(x + a1 + a2, max(b1 + a2, b2)),

so the recurrence is an associative max-plus scan over per-position
elements:

    scored position:   (a, b) = (s_i, 0)      — f(x) = max(x + s_i, 0)
    unscored position: (a, b) = (-inf, 0)     — f(x) = 0 (reset at N gaps,
                                                 warm-up, segment tails)

S_i = F_i(0) = max(A_i, B_i) where (A_i, B_i) is the inclusive composed
prefix.  -inf is safe: no +inf ever enters, so no inf - inf NaNs; long reset
runs saturate harmlessly.

The same pair algebra gives cross-chunk / cross-device carries: a block's
total transform is its last scan element, and blocks compose in order
(span_scan_blocked, and parallel/pipeline.py across devices).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _combine(left, right):
    """Compose two (a, b) transform pairs: apply left, then right."""
    al, bl = left
    ar, br = right
    return al + ar, jnp.maximum(bl + ar, br)


def score_elements(s: jax.Array, scored: jax.Array):
    """Per-position (a, b) max-plus elements from scores + scored mask."""
    neg = jnp.array(-jnp.inf, dtype=s.dtype)
    a = jnp.where(scored, s, neg)
    b = jnp.zeros_like(s)
    return a, b


@jax.jit
def span_scan(s: jax.Array, scored: jax.Array):
    """Inclusive scan: returns (S, (A_end, B_end)).

    S[p] is the reference's running score at position p (0 at unscored
    positions); the final (A, B) pair is the whole block's composed
    transform, for carrying into a following block:
    S_next_block = max(S_in + A, B).
    """
    a, b = score_elements(s, scored)
    A, B = jax.lax.associative_scan(_combine, (a, b))
    S = jnp.maximum(A, B)
    return S, (A[-1], B[-1])


@jax.jit
def apply_carry(S_in, A: jax.Array, B: jax.Array):
    """Apply an incoming scalar scan state to a block's composed prefixes."""
    return jnp.maximum(S_in + A, B)


def span_scan_blocked(s: jax.Array, scored: jax.Array, block: int):
    """Blocked scan (single device): identical result to span_scan.

    Exercises the carry algebra used by the multi-chip pipeline; also the
    building block for streaming genomes larger than device memory.
    """
    n = s.shape[0]
    pad = (-n) % block
    if pad:
        s = jnp.pad(s, (0, pad))
        scored = jnp.pad(scored, (0, pad))
    nb = s.shape[0] // block
    s2 = s.reshape(nb, block)
    m2 = scored.reshape(nb, block)
    a, b = score_elements(s2, m2)
    # intra-block inclusive scan along axis 1
    A, B = jax.lax.associative_scan(_combine, (a, b), axis=1)
    # block transforms: last column; exclusive scan across blocks
    tA, tB = A[:, -1], B[:, -1]
    cA, cB = jax.lax.associative_scan(_combine, (tA, tB))
    # incoming state per block: S after all previous blocks, from x=0
    S_in = jnp.maximum(cA, cB)  # inclusive; shift to exclusive with leading 0
    S_in = jnp.concatenate([jnp.zeros((1,), s.dtype), S_in[:-1]])
    S = jnp.maximum(S_in[:, None] + A, B)
    return S.reshape(-1)[:n]
