"""Spectrum counting and dense histograms (device).

``histogram`` is the one dense-histogram primitive every device path
uses: the spectrum count of the k <= 9 span pipeline and the streaming
count pass, the run histograms of the sort and pm screens, and the
windowed engine's (kmer, count) distributions.  It is a plain XLA
scatter-add; on a GPU XLA lowers it to atomic adds that mostly land in
L2.

Two interchangeable spectrum strategies sit on top:

  * scatter: one scatter-add into the dense 4^k table.
  * sort: sort the codes, derive run lengths from run boundaries, then
    scatter-add only the unique run heads (conflict-free).

Both replace the reference's sequential counts[offset]++ hot loop
(src/kmer_spans.c:135-155) with O(n) parallel work.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def histogram(values: jax.Array, valid: jax.Array, size: int) -> jax.Array:
    """Dense int32 histogram of ``values`` (any shape) where ``valid``.

    Values must lie in [0, size) wherever valid; invalid positions count
    nowhere (they scatter to the dropped out-of-bounds slot ``size``).
    """
    idx = jnp.where(valid, values, size).reshape(-1)
    return jnp.zeros(size, jnp.int32).at[idx].add(1, mode="drop")


@functools.partial(jax.jit, static_argnames=("k",))
def count_spectrum_scatter(codes: jax.Array, kmer_valid: jax.Array, k: int):
    """Dense 4^k int32 spectrum via scatter-add; invalid positions add 0."""
    return histogram(codes, kmer_valid, 1 << (2 * k))


@functools.partial(jax.jit, static_argnames=("k",))
def count_spectrum_sort(codes: jax.Array, kmer_valid: jax.Array, k: int):
    """Dense 4^k int32 spectrum via sort + run-length + unique scatter."""
    size = 1 << (2 * k)
    n = codes.shape[0]
    # invalid codes -> sentinel `size`, sorted to the tail and dropped
    keys = jnp.where(kmer_valid, codes, size)
    skeys = jax.lax.sort(keys)
    idx = jnp.arange(n, dtype=jnp.int32)
    is_head = jnp.concatenate(
        [jnp.ones((1,), bool), skeys[1:] != skeys[:-1]]
    )
    # position of each run head; run length = next head position - this one
    head_pos = jnp.where(is_head, idx, n)
    # next head position via reverse cummin
    next_head = jnp.concatenate([head_pos[1:], jnp.full((1,), n, jnp.int32)])
    next_head = jnp.flip(jax.lax.cummin(jnp.flip(next_head)))
    run_len = jnp.where(is_head, next_head - idx, 0)
    # non-heads and the invalid-sentinel run scatter out of bounds and drop
    scatter_idx = jnp.where(is_head & (skeys < size), skeys, size)
    counts = jnp.zeros(size, jnp.int32).at[scatter_idx].add(
        run_len, mode="drop", unique_indices=True
    )
    return counts
