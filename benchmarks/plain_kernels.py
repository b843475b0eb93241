#!/usr/bin/env python
"""Device time of the plain-XLA forms of the span pipelines' kernels.

Each row times one operation alone at bench shapes (inputs staged on
the device first; ``block_until_ready`` around the timed calls; median
of REPS after a warm-up) and prints one JSON line with ns per element:

  count_k8        spectrum histogram (scatter-add) over 400 Mb of the
                  bench genome, poly-AT islands included
  class_screen_k8 packed-class gather + integer scores + per-block
                  max-plus summaries over 400 Mb
  sort_key_payload  lax.sort of (key, position) at 100,663,296 (3 * 2^25;
                  the k >= 10 screens)
  sortscreen_hist_k12 / pm_hist_k15  run histograms over 100 Mb
  window_hist     the windowed engine's (kmer, count) histogram at 48 Mb,
                  16 dimers, w=200 (and the whole engine call)
  row_gather_k12  the streaming k >= 10 screen's class lookup: flat
                  uint8 gather vs the whole-row gather + lane select
  pipeline_k8     the whole k=8 span pipeline step at 400 Mb, with
                  compiled.memory_analysis()

    python benchmarks/plain_kernels.py [--out FILE.jsonl]

Runs on a GPU only (no CPU fallback); every line names the card.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 7
BASES = 400_000_000   # the k=8 rows (bench genome)
BASES_K10 = 100_663_296   # the k >= 10 rows: 3 * 2^25, whole 8192-blocks
WINDOW_BASES = 48 * 1024 * 1024


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also append rows here")
    args = ap.parse_args()

    from kmer_spans.utils import runtime

    runtime.enable_compile_cache()
    devs = runtime.require_gpu()
    import jax
    import jax.numpy as jnp

    from bench import make_genome
    from kmer_spans.ops.blocked import (
        blocked_codes,
        blocked_scan_summaries_int,
        blocked_scored,
    )
    from kmer_spans.ops.count import histogram
    from kmer_spans.ops.gather import (
        class_nibbles,
        class_scores_int,
        class_table_from_mass,
        screen_thr_q,
    )
    from kmer_spans.ops.sortscreen import V2, VMAX, _run_lengths
    from kmer_spans.parallel.pipeline import _rank_mass

    card = runtime.card_info()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row = {**row, "card": card, "device": device}
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def bench(name, fn, argv, n, **extra):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*argv))
        first = time.perf_counter() - t0
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*argv))
            ts.append(time.perf_counter() - t0)
        med = statistics.median(ts)
        emit({"name": name, "elements": n, "median_s": med,
              "min_s": min(ts), "ns_per_el": med / n * 1e9,
              "first_call_s": first, **extra})

    block = 8192
    n = -(-BASES // (4 * block)) * (4 * block)
    nbases = jax.device_put(make_genome(n, np.random.default_rng(0)))

    @jax.jit
    def prep(nb):
        b2 = (nb & 3).reshape(-1, block)
        v2 = (nb < 4).reshape(-1, block)
        codes, kv = blocked_codes(b2, v2, 8)
        return codes, kv, blocked_scored(v2, kv)

    codes, kv, scored = jax.block_until_ready(prep(nbases))

    count = jax.jit(lambda c, v: histogram(c, v, 1 << 16))
    bench("count_k8", count, (codes, kv), n)

    counts = count(codes, kv)
    words = class_table_from_mass(
        _rank_mass(counts), jnp.sum(counts).astype(jnp.float32))
    thr_q = screen_thr_q(jnp.float32(0.75))

    @jax.jit
    def class_screen(words, codes, scored, thr_q):
        s = class_scores_int(class_nibbles(words, codes), thr_q)
        return blocked_scan_summaries_int(s, scored)

    bench("class_screen_k8", class_screen, (words, codes, scored, thr_q), n)

    from kmer_spans.spans.pipeline import make_span_pipeline

    fn = make_span_pipeline(8, block=block, packed=True,
                            cand_blocks=min(n // block, 1024))
    thr = jnp.float32(0.75)
    mem = jax.jit(fn).lower(nbases, thr).compile().memory_analysis()
    bench("pipeline_k8", fn, (nbases, thr), n,
          temp_bytes=getattr(mem, "temp_size_in_bytes", None),
          argument_bytes=getattr(mem, "argument_size_in_bytes", None),
          output_bytes=getattr(mem, "output_size_in_bytes", None))
    del codes, kv, scored, nbases

    # ---- k >= 10: sorted runs over 100 Mb
    m = BASES_K10
    nb100 = jax.device_put(make_genome(m, np.random.default_rng(1)))
    for k in (12, 15):
        @jax.jit
        def runs(nb):
            b2 = (nb & 3).reshape(-1, block)
            v2 = (nb < 4).reshape(-1, block)
            c, v = blocked_codes(b2, v2, k)
            key = jnp.where(v, c, 1 << (2 * k)).reshape(-1)
            pos = jax.lax.iota(jnp.int32, key.shape[0])
            return key, pos

        key, pos = jax.block_until_ready(runs(nb100))
        if k == 12:
            srt = jax.jit(lambda a, b: jax.lax.sort((a, b), num_keys=1))
            bench("sort_key_payload", srt, (key, pos), m)
        skey, _ = jax.lax.sort((key, pos), num_keys=1)
        head = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])
        v = _run_lengths(head, m)
        real = skey < (1 << (2 * k))
        hb = (skey >> (2 * k - 8)) & 255
        if k == 12:
            from kmer_spans.ops.sortscreen import rank_ub_histograms

            h = jax.jit(lambda v, hb, hm: rank_ub_histograms(
                v, hb, hm, VMAX, V2))
            bench("sortscreen_hist_k12", h, (v, hb, head & real), m)
        else:
            h = jax.jit(lambda v, hm: histogram(jnp.minimum(v, 255), hm,
                                                 256))
            bench("pm_hist_k15", h, (v, head & real), m)
    del key, pos, skey, v, real, hb, head

    # ---- row gather (streaming k >= 10 screen)
    r = jax.random.split(jax.random.key(0), 3)
    tab = jax.random.randint(
        r[0], ((1 << 24) // 128, 128), 0, 256).astype(jnp.uint8)
    rc = jax.random.randint(r[1], (m,), 0, 1 << 24, dtype=jnp.int32)
    flat = jax.jit(lambda t, c: t.reshape(-1)[c])

    def row_form(t, c):
        iota = jnp.arange(128, dtype=jnp.int32)[None, :]

        def body(cc):
            rows = t[cc >> 7]
            lane = (cc & 127)[:, None]
            return jnp.max(jnp.where(lane == iota, rows, jnp.uint8(0)),
                           axis=1)

        slab = min(1 << 22, c.shape[0])
        return jax.lax.map(body, c.reshape(-1, slab)).reshape(-1)

    assert bool(jnp.all(flat(tab, rc) == jax.jit(row_form)(tab, rc)))
    bench("row_gather_k12_flat", flat, (tab, rc), m)
    bench("row_gather_k12_rows", jax.jit(row_form), (tab, rc), m)
    del tab, rc, nb100

    # ---- windowed engine, 48 Mb, 16 dimers, w=200
    w = WINDOW_BASES
    T, window = 16, 200
    W2 = window + 2
    cnt = jax.random.binomial(r[2], window - 1, 1 / 16, shape=(T, w)
                              ).astype(jnp.int32)
    comb = cnt + (jnp.arange(T, dtype=jnp.int32) * W2)[:, None]
    valid = jnp.ones((T, w), bool)
    hw = jax.jit(lambda c, v: histogram(c, v, T * W2))
    bench("window_hist", hw, (comb, valid), T * w)
    del cnt, comb, valid

    from kmer_spans.ops.window import windowed_counts_device

    nbw = jax.device_put(np.random.default_rng(7).integers(
        0, 4, size=w, dtype=np.uint8))

    @jax.jit
    def engine(nb):
        b2 = (nb & 3).reshape(-1, block)
        v2 = (nb < 4).reshape(-1, block)
        c, v = blocked_codes(b2, v2, 2)
        c = jnp.where(v, c, 0)
        dist, _, _ = windowed_counts_device(
            c, v, v2, jnp.arange(T, dtype=jnp.int32), 2, window)
        return dist

    bench("window_engine", engine, (nbw,), w)
    if out:
        out.close()


if __name__ == "__main__":
    main()
