"""Streaming span pipeline: genomes of any size through fixed-shape chunks.

Two compiled programs (shapes fixed => exactly two XLA compiles per (k,
chunk) config, however large the genome):

  * count_chunk(nbases)                  -> partial int32 spectrum, added
                                            into an int64 device accumulator
                                            (no 2^31 ceiling anywhere)
  * scan_chunk(nbases, screen_tab, ...)  -> integer block summaries +
                                            candidate/margin code gathers

The scan gathers ONLY from a quantized rank-class table: 4-bit packed
words for k <= 9 (ops/gather.py), a uint8 256-level table above
(ops/rowgather.py).  The EXACT rank mass lives
on the host in int64 (stats.ranks.cumulative_mass — the analog of the
reference's f64 rank chain, src/kmer_spans.c:189-202, valid past 2^31
k-mers); candidates are replayed from host mass via their pulled codes,
so no O(n) array and no 64-bit value is ever pulled from the device.

SOUNDNESS: screen scores are integer upper bounds (SCREEN_SCALE units),
per-block summaries exact int32, and the cross-block/cross-chunk
composition runs in exact int64 on the host — a block whose composed
bound is below min_score provably emits nothing (no f32 margins).  The
device's f32 composition only orders the top-C gather; misses are
detected exactly and flagged in ``unresolved``.

The scan state crosses chunk boundaries as the host's exact int64
running bound; the first k-1 positions of each chunk see the previous
chunk's tail bases via an explicit halo argument, and the scored rule's
lookahead byte rides in the same way — a chunk boundary is neither an N
gap nor a genome end.

Host-side, spans are extracted per chunk from the candidate blocks
(spans/extract.py exact replay); excursions that straddle a boundary are
stitched from each chunk's pulled tail/head margins.  If a straddling
excursion extends beyond the pulled margin the pipeline reports it in
``unresolved`` rather than guessing (callers rerun those windows through
the exact api path).

Reference parity: this is the chunked device replacement for processing a
48 Mb scaffold in one sequential C call (test.R:128-140) — SURVEY §5.7.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..ops.gather import SCREEN_SCALE
from ..spans.pipeline import rebuild_codes
from ..utils import native

_NEG64 = -(1 << 62)


@dataclasses.dataclass
class StreamResult:
    regions: list  # (seq_id, beg, end, score) global 1-based coords
    n_kmers: int
    unresolved: list  # (chunk_idx, reason) windows needing exact rerun
    counts_host: object  # int64 np spectrum (None until finish_rank ran)


def host_class_words(mass: np.ndarray, total: int) -> np.ndarray:
    """Packed 4-bit class table from int64 mass, on the host.

    Bit-identical to ops.gather.class_table_from_mass (same f32 IEEE ops),
    so the device soundness slack derivation applies unchanged.
    """
    rank = mass.astype(np.float32) / np.float32(max(total, 1))
    cls = np.clip((rank * 16).astype(np.int32), 0, 15)
    w = cls.reshape(-1, 8)
    shifts = (np.arange(8, dtype=np.int32) * 4)
    return np.bitwise_or.reduce(w << shifts[None, :], axis=1).astype(
        np.int32)


def host_fine_table(mass: np.ndarray, total: int) -> np.ndarray:
    """int16 4096-level class table from int64 mass, on the host
    (== ops.gather.fine_class_table)."""
    rank = mass.astype(np.float32) / np.float32(max(total, 1))
    return (
        np.clip((rank * SCREEN_SCALE).astype(np.int32), 0, SCREEN_SCALE) + 1
    ).astype(np.int16)


class StreamingSpanPipeline:
    """count -> rank -> scan over fixed-size chunks with exact stitching."""

    def __init__(
        self,
        k: int,
        chunk_bases: int = 1 << 25,
        block: int = 8192,
        cand_blocks: int = 128,
        margin_blocks: int = 16,
    ):
        import jax
        import jax.numpy as jnp

        from ..ops.blocked import (
            blocked_codes,
            blocked_scan_summaries_int,
            blocked_scored,
            compose_summaries_f32,
        )
        from ..ops.count import histogram
        from ..ops.gather import (
            CLASS_SCREEN_MAX_K,
            class_nibbles,
            class_scores_int,
            screen_thr_q,
        )
        from ..spans.pipeline import _seg_max_combine

        if chunk_bases % block:
            raise ValueError("chunk_bases must be a multiple of block")
        self.k = k
        self.block = block
        self.chunk = chunk_bases
        self.cand = cand_blocks
        self.margin = margin_blocks
        #: N-run interval capacity of the packed-H2D path (overflowing
        #: chunks — pathological N sprinkling — use the u8 program)
        self._ncap = 2048
        nb = chunk_bases // block
        size = 1 << (2 * k)
        h = k - 1
        use_class = k <= CLASS_SCREEN_MAX_K
        self._use_class = use_class
        ncap = self._ncap

        def decode_packed(words, nst, nln):
            """2-bit words + N-run intervals -> (b2, v2).

            2-bit words are 4x smaller than the u8 chunk and N runs
            travel as <= ncap explicit
            intervals (scatter of 2*ncap deltas + one cumsum rebuilds the
            validity mask on device).  Inactive interval slots are
            (0, 0) pairs whose +1/-1 deltas cancel.
            """
            shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, :]
            b = ((words[:, None] >> shifts) & 3).astype(jnp.int32)
            b2 = b.reshape(nb, block)
            mark = jnp.zeros(chunk_bases + 1, jnp.int32)
            mark = mark.at[nst].add(1, mode="drop")
            mark = mark.at[nst + nln].add(-1, mode="drop")
            v2 = (jnp.cumsum(mark[:chunk_bases]) == 0).reshape(nb, block)
            return b2, v2

        def count_body(b2, v2, acc_hi, acc_lo, halo_b, halo_v):
            codes, kv = blocked_codes(
                b2, v2, k, first_bases=halo_b, first_valid=halo_v
            )
            part = histogram(codes, kv, size)
            # exact wide accumulation WITHOUT device int64 (jnp silently
            # truncates int64 when x64 is off — the production default):
            # an int32 (hi, lo) pair, lo < 2^16 between chunks, part <
            # chunk_bases <= 2^30, so lo+part never overflows; per-kmer
            # totals are exact to 2^47 (poly-A at Gb scale can't overflow)
            lo2 = acc_lo + part
            return acc_hi + (lo2 >> 16), lo2 & 0xFFFF

        @jax.jit
        def count_chunk(nbases, acc_hi, acc_lo, halo_b, halo_v):
            b2 = (nbases & 3).reshape(nb, block)
            v2 = (nbases < 4).reshape(nb, block)
            return count_body(b2, v2, acc_hi, acc_lo, halo_b, halo_v)

        @jax.jit
        def count_chunk_packed(words, nst, nln, acc_hi, acc_lo, halo_b,
                               halo_v):
            b2, v2 = decode_packed(words, nst, nln)
            return count_body(b2, v2, acc_hi, acc_lo, halo_b, halo_v)

        C = min(cand_blocks, nb)
        m = margin_blocks

        def pack_codes(c2d):
            # [R, block] raw rolling codes -> seed code + 2-bit bases,
            # 16/word (code & 3 IS the position's base; the host rebuilds
            # exact codes from the seed's k-1 halo bits + the bases) —
            # 8x (k<=8) to 16x (k>8) fewer D2H bytes than whole codes
            rows = c2d.shape[0]
            seed = c2d[:, 0].astype(jnp.uint32)
            b16 = (c2d & 3).astype(jnp.uint32).reshape(
                rows, block // 16, 16)
            shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
            words = jnp.concatenate([
                seed[:, None],
                jnp.sum(b16 << shifts, axis=-1, dtype=jnp.uint32),
            ], axis=1)
            return jax.lax.bitcast_convert_type(
                words, jnp.int32).reshape(-1)

        def pack_bits(b2d):
            bits32 = jnp.arange(32, dtype=jnp.uint32)
            w = jnp.sum(
                b2d.reshape(-1, block // 32, 32).astype(jnp.uint32)
                << bits32[None, None, :],
                axis=-1, dtype=jnp.uint32)
            return jax.lax.bitcast_convert_type(w, jnp.int32).reshape(-1)

        def finish_scan(tA, tB, maxA, maxB, x_in_f, codes, scored):
            # f32 composition orders the top-C gather only (host re-does
            # the composition exactly in int64, carry included)
            block_max, block_last = compose_summaries_f32(
                tA, tB, maxA, maxB)
            block_max = jnp.concatenate(
                [jnp.maximum(block_max[:1], x_in_f + maxA[:1].astype(
                    jnp.float32)), block_max[1:]])
            linked = jnp.concatenate(
                [(x_in_f > 0).reshape(1), block_last[:-1] > 0])
            fwd, _ = jax.lax.associative_scan(
                _seg_max_combine,
                (block_max, (~linked).astype(jnp.float32)))
            linked_next = jnp.concatenate(
                [linked[1:], jnp.zeros((1,), bool)])
            bwd, _ = jax.lax.associative_scan(
                _seg_max_combine,
                (jnp.flip(block_max),
                 jnp.flip((~linked_next).astype(jnp.float32))))
            need = jnp.maximum(fwd, jnp.flip(bwd))
            _, top_idx = jax.lax.top_k(need, C)
            top_idx = jnp.sort(top_idx)

            summary = jnp.concatenate([
                tA.astype(jnp.int32), tB.astype(jnp.int32),
                maxA.astype(jnp.int32), maxB.astype(jnp.int32),
                top_idx.astype(jnp.int32),
            ])
            payload = jnp.concatenate([
                pack_codes(codes[top_idx]),
                pack_bits(scored[top_idx]),
                pack_codes(codes[:m]),
                pack_bits(scored[:m]),
                pack_codes(codes[nb - m:]),
                pack_bits(scored[nb - m:]),
            ])
            return summary, payload

        def scan_body(b2, v2, tab, thr, x_in_f, halo_b, halo_v, next_v):
            codes, kv = blocked_codes(
                b2, v2, k, first_bases=halo_b, first_valid=halo_v
            )
            scored = blocked_scored(v2, kv, next_valid=next_v)
            # codes stay RAW (consumers mask by scored; the payload's
            # bases packing needs code & 3 == the position's base)
            thr_q = screen_thr_q(thr)
            if use_class:
                s_int = class_scores_int(class_nibbles(tab, codes), thr_q)
            else:
                from ..ops.rowgather import row_screen_scores

                s_int = row_screen_scores(
                    tab, codes.reshape(-1), thr_q).reshape(nb, block)
            tA, tB, maxA, maxB = blocked_scan_summaries_int(s_int, scored)
            return finish_scan(tA, tB, maxA, maxB, x_in_f, codes, scored)

        @jax.jit
        def scan_chunk(nbases, tab, thr, x_in_f, halo_b, halo_v, next_v):
            b2 = (nbases & 3).reshape(nb, block)
            v2 = (nbases < 4).reshape(nb, block)
            return scan_body(b2, v2, tab, thr, x_in_f, halo_b, halo_v,
                             next_v)

        @jax.jit
        def scan_chunk_packed(words, nst, nln, tab, thr, x_in_f, halo_b,
                              halo_v, next_v):
            b2, v2 = decode_packed(words, nst, nln)
            return scan_body(b2, v2, tab, thr, x_in_f, halo_b, halo_v,
                             next_v)

        # ---- generic-scoring variants (round-4 weak #7): the screen is
        # a 256-level uint8 row table of ANY weight model with an affine
        # integer decode (ops/rowgather.host_row_table_weights); only the
        # s_int computation differs from the rank path
        def scan_body_w(b2, v2, tab, step, off, x_in_f, halo_b, halo_v,
                        next_v):
            from ..ops.rowgather import row_screen_scores_affine

            codes, kv = blocked_codes(
                b2, v2, k, first_bases=halo_b, first_valid=halo_v)
            scored = blocked_scored(v2, kv, next_valid=next_v)
            s_int = row_screen_scores_affine(
                tab, codes.reshape(-1), step, off).reshape(nb, block)
            tA, tB, maxA, maxB = blocked_scan_summaries_int(s_int, scored)
            return finish_scan(tA, tB, maxA, maxB, x_in_f, codes, scored)

        @jax.jit
        def scan_chunk_w(nbases, tab, step, off, x_in_f, halo_b, halo_v,
                         next_v):
            b2 = (nbases & 3).reshape(nb, block)
            v2 = (nbases < 4).reshape(nb, block)
            return scan_body_w(b2, v2, tab, step, off, x_in_f, halo_b,
                               halo_v, next_v)

        @jax.jit
        def scan_chunk_w_packed(words, nst, nln, tab, step, off, x_in_f,
                                halo_b, halo_v, next_v):
            b2, v2 = decode_packed(words, nst, nln)
            return scan_body_w(b2, v2, tab, step, off, x_in_f, halo_b,
                               halo_v, next_v)

        self._count = count_chunk
        self._count_p = count_chunk_packed
        self._scan = scan_chunk
        self._scan_p = scan_chunk_packed
        self._scan_w = scan_chunk_w
        self._scan_wp = scan_chunk_w_packed
        self._size = size
        self._nb = nb
        self._C = C

    # -------------------------------------------------------------- count
    def run(self, chunk_iter_factory, thr, min_width, min_score,
            seq_id: int = 0, checkpoint_path: str | None = None,
            resume: bool = False, metrics=None,
            stop_after_chunk: int | None = None,
            scoring=None) -> StreamResult:
        """Run the two-pass pipeline.

        chunk_iter_factory: zero-arg callable returning an iterator of
        uint8 numpy arrays (nbases; N encoded as 4), each exactly
        chunk_bases long except the last (which is padded with N here).
        The factory is called twice (count pass, scan pass).

        scoring: optional callable (counts int64 [4^k], total) ->
        ScoringModel — stream under any of the README scoring variants
        (models/scoring.py) instead of rank scoring; ``thr`` is then
        unused (the model carries its own threshold).

        checkpoint_path: if set, the scan pass saves a StreamCheckpoint
        after every chunk; with resume=True and an existing checkpoint,
        the scan pass restarts after the last completed chunk (SURVEY
        §5.3: chunk-granularity elastic recovery).
        metrics: optional utils.metrics.Metrics recorder.
        """
        import contextlib

        def _phase(name, bases=0, **kw):
            if metrics is None:
                return contextlib.nullcontext()
            return metrics.phase(name, bases=bases, **kw)

        with _phase("count"):
            acc = self.accumulate_counts(chunk_iter_factory)
        with _phase("rank"):
            mass, total = self.finish_rank(acc)
            model = scoring(self._counts_host, total) if scoring else None
        return self.scan_stream(
            chunk_iter_factory, mass, total, thr, min_width, min_score,
            seq_id=seq_id, checkpoint_path=checkpoint_path, resume=resume,
            metrics=metrics, stop_after_chunk=stop_after_chunk,
            counts_host=self._counts_host, model=model,
        )

    def _chunk_args(self, arr):
        """Device input for one chunk: 2-bit words + N-run intervals
        (PACKED H2D — 4x fewer bytes) when the chunk's N runs fit the
        interval cap,
        else the u8 bytes.  Returns (args tuple, packed flag)."""
        import jax.numpy as jnp

        w, st, ln, runs = native.pack2(arr, cap=self._ncap)
        if runs <= self._ncap:
            return (jnp.asarray(w), jnp.asarray(st), jnp.asarray(ln)), True
        return (jnp.asarray(arr),), False

    def accumulate_counts(self, chunk_iter_factory, acc=None):
        """Count pass over one stream; pass ``acc`` to accumulate multiple
        streams into one spectrum (the reference counts across ALL
        sequences before scanning any — src/kmer_spans.c:592-601)."""
        import jax.numpy as jnp

        h = self.k - 1
        if acc is None:
            acc = (jnp.zeros(self._size, jnp.int32),
                   jnp.zeros(self._size, jnp.int32))
        prev_tail = np.full(h, 4, np.uint8)  # N: stream start has no halo
        for arr in chunk_iter_factory():
            arr = self._pad(arr)
            args, packed = self._chunk_args(arr)
            count = self._count_p if packed else self._count
            acc = count(
                *args, acc[0], acc[1],
                jnp.asarray(prev_tail & 3), jnp.asarray(prev_tail < 4),
            )
            if h:
                prev_tail = arr[-h:]
        # force the queued count chunks to complete INSIDE this phase:
        # without the sync, finish_rank's blocking spectrum pull absorbs
        # all outstanding count H2D/compute and the per-phase metrics
        # misattribute it to "rank" (round-4 weak #5)
        float(np.asarray(acc[0].ravel()[0]))
        return acc

    def finish_rank(self, acc):
        """Exact int64 rank mass from the accumulated device spectrum.

        Pulls the (hi, lo) int32 pair spectrum ONCE per genome and
        computes the exact integer cumulative mass on the host — the
        analog of the reference's f64 rank chain (src/kmer_spans.c:
        198-200), exact at any genome size (no 2^31 ceiling).
        Returns (mass int64 np [4^k], total int).
        """
        from ..stats.ranks import cumulative_mass

        hi, lo = acc
        counts = (np.asarray(hi).astype(np.int64) << 16) + np.asarray(
            lo).astype(np.int64)
        self._counts_host = counts
        mass = cumulative_mass(counts)
        return mass, int(counts.sum())

    # --------------------------------------------------------------- scan
    def _screen_table(self, mass: np.ndarray, total: int):
        import jax.numpy as jnp

        from ..ops.rowgather import host_row_table

        if self._use_class:
            return jnp.asarray(host_class_words(mass, total))
        # k >= 10: uint8 row table for the row-gather screen (~3x the
        # int16 fine table's XLA scalar gather; ops/rowgather.py)
        return jnp.asarray(host_row_table(mass, total))

    def _unpack_summary(self, vec):
        v = np.asarray(vec)
        nb, C = self._nb, self._C
        tA, tB, maxA, maxB = (v[i * nb:(i + 1) * nb] for i in range(4))
        top_idx = v[4 * nb:4 * nb + C]
        return tA, tB, maxA, maxB, top_idx

    def _unpack_payload(self, vec, ranks, thr):
        """Decode packed codes/bits; candidates stay as packed words
        (decoded lazily per stretch — natively when the C library is
        available); margins (small) decode to s/scored eagerly.

        ranks: the reference's f64 sequential rank chain
        (spans.pipeline.host_rank_chain) — replayed scores are bit-identical
        to the C reference (src/kmer_spans.c:198-200, :268)."""
        from ..spans.pipeline import rebuild_codes

        v = np.asarray(vec)
        block, C, m = self.block, self._C, self.margin
        k = self.k
        cw = 1 + block // 16
        off = 0

        def words_of(rows):
            nonlocal off
            w = v[off:off + rows * cw].copy().view(np.uint32).reshape(
                rows, cw)
            off += rows * cw
            return w

        def bits_of(rows):
            nonlocal off
            w = v[off:off + rows * (block // 32)].copy().view(np.uint32)
            off += rows * (block // 32)
            return ((w[:, None] >> np.arange(32, dtype=np.uint32)) & 1
                    ).astype(bool).reshape(rows, block)

        def s_of(words, sc):
            codes = rebuild_codes(words, k, block)
            return np.where(sc, ranks[codes] - thr, 0.0)

        w_cand = words_of(C)
        sc_cand = bits_of(C)
        w_head = words_of(m)
        sc_head = bits_of(m)
        w_tail = words_of(m)
        sc_tail = bits_of(m)
        assert off == v.shape[0], (off, v.shape)
        return {
            "w_cand": w_cand, "sc_cand": sc_cand,
            "s_head": s_of(w_head, sc_head).reshape(-1),
            "sc_head": sc_head.reshape(-1),
            "s_tail": s_of(w_tail, sc_tail).reshape(-1),
            "sc_tail": sc_tail.reshape(-1),
        }

    def scan_stream(self, chunk_iter_factory, mass, total, thr,
                    min_width, min_score, seq_id=0, checkpoint_path=None,
                    resume=False, metrics=None, stop_after_chunk=None,
                    counts_host=None, model=None) -> StreamResult:
        """Scan pass over one stream with a (possibly shared) rank table.

        mass: int64 np array (finish_rank); total: int k-mer count.

        model: optional ScoringModel (models/scoring.py) — streams spans
        under ARBITRARY weights / frequency-threshold / log2-median
        scoring instead of rank scoring (BASELINE config 4 "all three
        scoring functions"; round-4 weak #7).  The screen quantizes the
        model to a 256-level row table with affine integer decode
        (ops/rowgather.host_row_table_weights); the exact f64 replay
        reads the model's weights directly, so emitted scores keep the
        sequential-f64 invariant for every scoring.
        """
        import time as _time

        import jax.numpy as jnp

        k, block, nb = self.k, self.block, self._nb
        h = k - 1
        if counts_host is None:
            counts_host = getattr(self, "_counts_host", None)
        if counts_host is None:
            raise ValueError(
                "scan_stream needs the host spectrum for bit-identical "
                "replay: run finish_rank first or pass counts_host"
            )
        thr32 = jnp.float32(thr)
        if model is None:
            from ..spans.pipeline import host_rank_chain

            mass = np.asarray(mass, dtype=np.int64)
            tab_dev = self._screen_table(mass, total)
            ranks = host_rank_chain(counts_host, total)
            score_thr = thr
            scale = float(SCREEN_SCALE)

            def dispatch_scan(args, packed, x_in):
                scan = self._scan_p if packed else self._scan
                return scan(*args, tab_dev, thr32, jnp.float32(x_in),
                            halo_b, halo_v, next_v)
        else:
            from ..ops.rowgather import host_row_table_weights

            tab_np, step, off, scale = host_row_table_weights(
                model.weights, model.threshold, block)
            tab_dev = jnp.asarray(tab_np)
            step32 = jnp.int32(step)
            off32 = jnp.int32(off)
            ranks = np.asarray(model.weights, dtype=np.float64)
            score_thr = float(model.threshold)

            def dispatch_scan(args, packed, x_in):
                scan = self._scan_wp if packed else self._scan_w
                return scan(*args, tab_dev, step32, off32,
                            jnp.float32(x_in), halo_b, halo_v, next_v)

        regions: list = []
        unresolved: list = []
        x_in = np.int64(0)  # exact composed screen bound entering the chunk
        halo_b = jnp.zeros((h,), jnp.uint8)
        halo_v = jnp.zeros((h,), bool)

        # host-side stitching state: open excursion s-values at boundary
        open_s: np.ndarray | None = None
        open_scored: np.ndarray | None = None
        open_start: int = 0  # global 0-based position of open_s[0]
        start_chunk = 0

        if checkpoint_path and resume and os.path.exists(checkpoint_path):
            from ..io.checkpoint import StreamCheckpoint

            ck = StreamCheckpoint.load(checkpoint_path)
            start_chunk = ck.chunk_idx + 1
            x_in = np.int64(ck.x_in)
            tail = np.frombuffer(ck.halo_bytes, dtype=np.uint8)
            if h:
                halo_b = jnp.asarray(tail & 3)
                halo_v = jnp.asarray(tail < 4)
            open_s, open_scored = ck.open_s, ck.open_scored
            open_start = ck.open_start
            regions = list(ck.regions)

        chunks = list(chunk_iter_factory())
        base = 0
        staged = {}  # ci -> (args, packed): H2D prefetched under compute
        for ci, raw in enumerate(chunks):
            arr = self._pad(raw)
            if ci < start_chunk:
                base += arr.shape[0]
                continue
            if stop_after_chunk is not None and ci > stop_after_chunk:
                break  # simulated interruption (scan resumes via checkpoint)
            args, packed = staged.pop(ci, None) or self._chunk_args(arr)
            is_last = ci == len(chunks) - 1
            next_v = jnp.asarray(
                False if is_last else chunks[ci + 1][0] != 4)
            t0 = _time.perf_counter()
            summary, payload = dispatch_scan(args, packed, x_in)
            # prefetch the next TWO chunks' pack + H2D while this chunk
            # computes (the summary pull below blocks): the per-chunk
            # H2D otherwise serializes with compute, and one chunk of
            # lookahead is not enough when the host link is slower than
            # ~chunk/compute_time
            for cj in (ci + 1, ci + 2):
                if cj < len(chunks) and cj not in staged:
                    staged[cj] = self._chunk_args(self._pad(chunks[cj]))
            tA, tB, maxA, maxB, top_idx = self._unpack_summary(summary)
            res, open_next, x_in = self._finish_chunk(
                tA, tB, maxA, maxB, top_idx, payload, x_in,
                base, score_thr, ranks, min_width, min_score, seq_id,
                open_s, open_scored, open_start, unresolved, ci,
                is_last=is_last, scale=scale,
            )
            regions.extend(res)
            open_s, open_scored, open_start = open_next
            if h:
                halo_b = jnp.asarray(arr[-h:] & 3)
                halo_v = jnp.asarray(arr[-h:] < 4)
            base += arr.shape[0]
            if metrics is not None:
                metrics.record(
                    "scan_chunk", _time.perf_counter() - t0,
                    bases=arr.shape[0], chunk=ci, regions=len(regions),
                )
            if checkpoint_path:
                from ..io.checkpoint import StreamCheckpoint

                StreamCheckpoint(
                    chunk_idx=ci,
                    x_in=int(x_in),
                    halo_bytes=(arr[-h:].tobytes() if h else b""),
                    open_start=open_start,
                    open_s=open_s,
                    open_scored=open_scored,
                    regions=regions,
                ).save(checkpoint_path)

        # genome end: terminal semantics were already applied inside the
        # final chunk (next_v=False)
        return StreamResult(
            regions=regions, n_kmers=total, unresolved=unresolved,
            counts_host=counts_host if counts_host is not None
            else getattr(self, "_counts_host", None),
        )

    def _pad(self, arr: np.ndarray) -> np.ndarray:
        n = arr.shape[0]
        if n == self.chunk:
            return arr
        if n > self.chunk:
            raise ValueError("chunk longer than configured chunk_bases")
        out = np.full(self.chunk, 4, np.uint8)
        out[:n] = arr
        return out

    def _finish_chunk(self, tA, tB, maxA, maxB, top_idx, payload, x_in,
                      base, thr, ranks, min_width, min_score,
                      seq_id, open_s, open_scored, open_start,
                      unresolved, ci, is_last=False,
                      scale=float(SCREEN_SCALE)):
        """Extract this chunk's spans + stitch the boundary excursion.

        All screening is EXACT: int64 composition of the integer block
        summaries, carry included.  Ownership protocol (prevents double
        emission):
          * the BOUNDARY replay owns the whole excursion that straddles the
            incoming chunk edge — all its regions on both sides — up to its
            exact end E;
          * the IN-CHUNK pass owns (E, next_open_start): candidate stretch
            positions outside that window are masked unscored;
          * the excursion open at the OUTGOING edge (start found from the
            exact block_last chain) is handed to the next chunk.
        """
        from ..spans.extract import extract_spans
        from ..spans.pipeline import compose_summaries_exact

        block, nb, m = self.block, self._nb, self.margin
        pl = self._unpack_payload(payload, ranks, thr)

        block_max, block_last = compose_summaries_exact(
            tA, tB, maxA, maxB, x0=int(x_in))
        # exact run-aware candidacy (see spans/pipeline.finish_spans)
        linked = np.zeros(nb, bool)
        linked[0] = x_in > 0
        linked[1:] = block_last[:-1] > 0
        seg_start = ~linked
        seg_start[0] = True
        starts = np.nonzero(seg_start)[0]
        run_of = np.cumsum(seg_start) - 1
        run_max = np.maximum.reduceat(block_max, starts)[run_of]
        cand = run_max >= float(min_score) * scale
        have = np.zeros(nb, bool)
        have[top_idx] = True
        pos_in_pull = {int(b): i for i, b in enumerate(top_idx)}
        w_cand = pl["w_cand"]
        sc_cand = pl["sc_cand"]

        regions = []

        # --- A. outgoing open excursion (start located via block_last) ---
        # The screen's identity-at-unscored semantics make block_last an
        # over-approximation (it can stay positive across N gaps); the
        # host resolves that here with the TRUE reset rule — an unscored
        # position provably has true S = 0, as does any position whose
        # no-reset upper-bound S is <= 0.  Never runs on the final chunk:
        # there is no next chunk, and the in-chunk pass owns terminal
        # emissions (reference sequence-end semantics, src/kmer_spans.c:
        # 298-305, live in extract_spans).
        open_next = (None, None, 0)
        clip_from_global = None  # in-chunk pass must not extract past this
        x_out = np.int64(block_last[-1]) if block_last[-1] > 0 else np.int64(0)
        if block_last[-1] > 0 and not is_last:
            # Locate the last position in the tail margin where TRUE
            # S = 0 provably.  Round-4's locator only trusted block-END
            # zeros of the integer bound (block_last <= 0), which random
            # background wobble defeats — composed bounds stay positive
            # at block ends while true S dips to 0 mid-block constantly
            # (surfaced by the permissive weight scorings).  Sound f64
            # refinement instead: replay the margin's true s-values with
            # the initial state bounded by the composed INTEGER bound
            # entering the margin (block_last >= scale * S_true always),
            #     S_ub(p) = max(x0_ub + P(p), P(p) - min(0, min P(<=p)))
            # — monotone in the init, so S_ub >= S_true and any
            # S_ub <= 0 (or unscored reset) is a provable close.
            tail_s = pl["s_tail"]
            tail_sc = pl["sc_tail"]
            x0_ub = (float(max(int(block_last[nb - m - 1]), 0)) / scale
                     if nb > m else float(max(int(x_in), 0)) / scale)
            P = np.cumsum(tail_s)
            Mn = np.minimum.accumulate(np.minimum(P, 0.0))
            S = np.maximum(P + x0_ub, P - Mn)
            closed = (S <= 0) | ~tail_sc
            zero = np.nonzero(closed)[0]
            if not zero.size:
                unresolved.append(
                    (ci, "open excursion exceeds tail margin"))
            else:
                start_rel = int(zero[-1]) + 1
                if start_rel >= tail_s.shape[0]:
                    # the edge position itself is provably closed: the
                    # chunk ends with true S = 0 — nothing to hand off
                    pass
                else:
                    open_next = (
                        tail_s[start_rel:],
                        tail_sc[start_rel:],
                        base + (nb - m) * block + start_rel,
                    )
                    clip_from_global = open_next[2]

        # --- B. incoming boundary excursion: owned here entirely ----------
        # The boundary pass owns the WHOLE handed window [open_start,
        # base) plus its continuation into the head margin, up to the
        # first TRUE close (S = 0 or unscored reset) at or after the
        # edge: closing at the first S <= 0 anywhere orphaned any
        # excursion that reopened between that close and the chunk edge
        # (surfaced by the permissive weight scorings).  The replay here
        # IS the true scan — true S = 0 at open_start - 1 by the handoff
        # invariant — so interior closes/reopens replay exactly and
        # extract_spans emits every region inside the owned window.
        boundary_done_global = base - 1  # in-chunk pass starts after this
        if open_s is not None:
            joined_s = np.concatenate([open_s, pl["s_head"]])
            joined_sc = np.concatenate([open_scored, pl["sc_head"]])
            hd0 = int(base - open_start)  # joined index of chunk start
            # EXACT close search (true S = 0 at open_start - 1 by the
            # handoff invariant, so this IS the reference scan): walk
            # excursion by excursion with _first_nonpositive's strictly
            # sequential f64 sums — the ownership split must be
            # provable under the reference's own rounding order, not a
            # vectorized near-equivalent that can differ by ulps at the
            # sign boundary.  An unscored position is a forced close.
            from ..spans.extract import _first_nonpositive

            nj = joined_s.shape[0]
            unsc = np.nonzero(~joined_sc)[0]
            z_close = None
            u = 0
            while u < nj:
                if not joined_sc[u]:
                    if u >= hd0 - 1:
                        z_close = u
                        break
                    u += 1
                    continue
                ui = int(np.searchsorted(unsc, u))
                nxt = int(unsc[ui]) if ui < unsc.size else nj
                _, z = _first_nonpositive(joined_s[:nxt], u)
                if z is None:
                    u = nxt  # excursion runs into the unscored reset
                    continue
                if z >= hd0 - 1:
                    z_close = z
                    break
                u = z + 1
            zero = (np.array([z_close - (hd0 - 1)])
                    if z_close is not None else np.array([], np.int64))
            if not zero.size:
                unresolved.append(
                    (ci, "boundary excursion exceeds head margin"))
                boundary_done_global = base + m * block  # best effort
            else:
                z = hd0 - 1 + int(zero[0])
                clip = z + 1
                regs = extract_spans(joined_s[:clip], joined_sc[:clip],
                                     min_width, min_score, seq_id=seq_id)
                regions.extend(
                    (sid, open_start + beg, open_start + end, sc)
                    for sid, beg, end, sc in regs
                )
                boundary_done_global = open_start + z

        # --- C. in-chunk candidate extraction with ownership masking ------
        if cand.any():
            if (cand & ~have).any():
                unresolved.append((ci, "candidate capacity overflow"))
            else:
                use_native = native.available()
                i = 0
                while i < nb:
                    if not cand[i]:
                        i += 1
                        continue
                    j = i
                    while j + 1 < nb and cand[j + 1]:
                        j += 1
                    rows = [pos_in_pull[b] for b in range(i, j + 1)]
                    bp = base + i * block  # global pos of first element
                    ne = len(rows) * block
                    gpos = bp + np.arange(ne).reshape(len(rows), block)
                    msk = gpos <= boundary_done_global
                    if clip_from_global is not None:
                        msk |= gpos >= clip_from_global
                    sc_rows = sc_cand[rows] & ~msk
                    if use_native:
                        beg, end, sc = native.replay_packed(
                            w_cand[rows], sc_rows, block, self.k, ranks,
                            thr, min_width, min_score, bp)
                        regions.extend(
                            (seq_id, int(b), int(e), float(s))
                            for b, e, s in zip(beg, end, sc)
                        )
                    else:
                        codes = rebuild_codes(w_cand[rows], self.k, block)
                        sc_flat = sc_rows.reshape(-1)
                        s_flat = np.where(
                            sc_flat, ranks[codes.reshape(-1)] - thr, 0.0)
                        regs = extract_spans(s_flat, sc_flat, min_width,
                                             min_score, seq_id=seq_id)
                        regions.extend(
                            (sid, beg + bp, end + bp, sc)
                            for sid, beg, end, sc in regs
                        )
                    i = j + 1
        return regions, open_next, x_out
