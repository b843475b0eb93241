"""Chunked streaming windowed-distribution engine (SURVEY §7.6, rows 15/21).

A one-shot windowed backend would compile one XLA program per padded
sequence length (dozens for the reference's 154-scaffold workload,
test.R:550-565) and, with ``ret_flag&1``, pull an O(n*T) int32 matrix
device-to-host in one go (~3 GB at the reference's 48 Mb x 16-dimer
config).  This engine avoids both:

  * ONE compiled program per (k, window, T, chunk) — every sequence, of
    any length, streams through fixed-size chunks with a ``window``-base
    lookahead; window starts beyond the chunk are masked
    (ops/window.py start_limit), so each window is counted exactly once
    and chunk boundaries are invisible (windows never span N anyway);
  * the positions matrix leaves the device per chunk as uint8 (int16
    when window+2 > 255) — 4x (2x) fewer bytes than int32 — and chunk
    i+1's dispatch overlaps chunk i's pull (double buffering).

Bit-exactness: identical window validity and counts as the one-shot
kernel — a window starting in chunk c lies entirely inside
[c*chunk, c*chunk + chunk + window), which the lookahead covers; halo
codes at a chunk's first k-1 END positions belong to windows starting
before the chunk and are masked there.  Conformance is pinned against
the oracle in tests/test_window_device.py.

Reference parity: windowed_kmer_count_distributions
(src/kmer_spans.c:413-449) and its ret_flag&1 positions matrices
(:763-783).
"""

from __future__ import annotations

import functools

import numpy as np


class StreamingWindowEngine:
    """One fixed-shape jitted program; sequences stream through it."""

    def __init__(self, k: int, window: int, n_tracked: int,
                 chunk: int = 1 << 22, block: int = 8192):
        import jax
        import jax.numpy as jnp

        from ..ops.blocked import blocked_codes
        from ..ops.window import windowed_counts_device

        if chunk % block:
            raise ValueError("chunk must be a multiple of block")
        self.k = k
        self.window = window
        self.T = n_tracked
        self.chunk = chunk
        # lookahead rounded up to whole blocks for the 2D reshape
        self._ext = -(-window // block) * block
        ext_rows = (chunk + self._ext) // block
        small = window + 2 <= 255
        self._pos_dtype = np.uint8 if small else np.int16

        @jax.jit
        def chunk_fn(nbases_ext, tracked):
            b2 = (nbases_ext & 3).reshape(ext_rows, block).astype(jnp.int32)
            v2 = (nbases_ext < 4).reshape(ext_rows, block)
            codes, kv = blocked_codes(b2, v2, k)
            codes = jnp.where(kv, codes, 0)
            dist, cpos, _ = windowed_counts_device(
                codes, kv, v2, tracked, k, window,
                with_positions=True, start_limit=chunk)
            cpos = cpos[:, :chunk]
            if small:
                cpos = cpos.astype(jnp.uint8)
            return dist, cpos

        self._fn = chunk_fn

    def run(self, nbases: np.ndarray, tracked: np.ndarray,
            with_positions: bool):
        """Stream one sequence; returns (dist int64 [window+1, T],
        counts_pos int64 [n, T] or None).

        Chunk i+1 is dispatched before chunk i's positions matrix is
        pulled, so the (chunked, packed) D2H rides under device compute.
        """
        import jax
        import jax.numpy as jnp

        n = nbases.shape[0]
        tr = jnp.asarray(np.asarray(tracked, dtype=np.int32))
        dist = np.zeros((self.window + 1, self.T), dtype=np.int64)
        counts_pos = (
            np.zeros((n, self.T), dtype=np.int64) if with_positions
            else None)
        nchunks = -(-n // self.chunk)
        pending = None  # (chunk_idx, dist_dev, cpos_dev)

        def drain(item):
            ci, d_dev, c_dev = item
            dist[:, :] += np.asarray(d_dev).astype(np.int64)
            if counts_pos is not None:
                lo = ci * self.chunk
                m = min(self.chunk, n - lo)
                counts_pos[lo:lo + m] = np.asarray(
                    c_dev)[:, :m].T.astype(np.int64)

        for ci in range(nchunks):
            lo = ci * self.chunk
            ext = np.full(self.chunk + self._ext, 4, np.uint8)
            m = min(n - lo, self.chunk + self._ext)
            ext[:m] = nbases[lo:lo + m]
            d_dev, c_dev = self._fn(jnp.asarray(ext), tr)
            if pending is not None:
                drain(pending)
            pending = (ci, d_dev, c_dev)
        if pending is not None:
            drain(pending)
        return dist, counts_pos


@functools.lru_cache(maxsize=8)
def get_engine(k: int, window: int, n_tracked: int, chunk: int,
               block: int = 8192) -> StreamingWindowEngine:
    """Engine cache: one compiled program per (k, window, T, chunk) —
    the reference's 154-scaffold workload reuses a single program."""
    return StreamingWindowEngine(k, window, n_tracked, chunk, block)
