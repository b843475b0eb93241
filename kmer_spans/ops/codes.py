"""Device-side rolling k-mer codes (JAX, fully parallel).

The reference computes codes with a sequential rolling update
(src/kmer_spans.c:34, :119-132).  On the device there is no sequential
dependency: code[p] = sum_j bases[p-j] << 2j is k shifted fused adds over
the whole array, which XLA fuses into a handful of elementwise kernels.

Conventions:
  * END-position: codes[p] is the k-mer covering bases [p-k+1, p].
  * kmer_valid[p]: all k window bases are non-N and p >= k-1.
  * scored[p]: position is *scored* by the span caller — kmer_valid AND the
    next byte exists and is not N.  (The reference's scan loop never scores
    the final k-mer of a segment; SURVEY A.3 / oracle find_regions.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("k",))
def kmer_codes(bases: jax.Array, valid: jax.Array, k: int):
    """bases uint8/int32 [n], valid bool [n] -> (codes i32, kmer_valid, scored).

    codes at positions where kmer_valid is False are zeroed.
    """
    n = bases.shape[0]
    b = bases.astype(jnp.int32)
    code = b
    for j in range(1, k):
        # base at p-j contributes bits 2j; roll wraps but wrapped positions
        # are masked off by kmer_valid (p < k-1).
        code = code | (jnp.roll(b, j) << (2 * j))
    idx = jnp.arange(n, dtype=jnp.int32)
    v = valid.astype(jnp.int32)
    cs = jnp.cumsum(v)
    prev = jnp.where(idx >= k, jnp.roll(cs, k), 0)
    kmer_valid = ((cs - prev) == k) & (idx >= k - 1)
    next_valid = jnp.where(idx < n - 1, jnp.roll(valid, -1), False)
    scored = kmer_valid & next_valid
    code = jnp.where(kmer_valid, code, 0)
    return code, kmer_valid, scored
