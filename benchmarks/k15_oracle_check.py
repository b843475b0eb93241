#!/usr/bin/env python
"""k=15 genome-scale differential: device pipeline vs the full native oracle.

Small-genome tests check k <= 13 against the native sequential caller
with the complete 4^k f64 rank chain; at k=15 that table is 8 GB, so
the genome-scale check runs HERE: k=15 spans on a 100 Mb planted genome, on the device,
bit-identical to the C-conformant oracle — positions AND f64 scores
(BASELINE configs 3-4).

Run: python benchmarks/k15_oracle_check.py
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from bench import make_genome
    from kmer_spans.spans.pipeline import (
        finish_spans,
        host_rank_chain,
        make_span_pipeline,
        unpack_outputs,
    )
    from kmer_spans.utils import native

    k = 15
    block = 8192
    thr, min_w, min_s = 0.75, 100, 20.0
    n = int(os.environ.get("K15_BASES", 100_663_296))
    n = -(-n // block) * block
    log(f"devices={jax.devices()} k={k} n={n:,}")
    rng = np.random.default_rng(0)
    nbases = make_genome(n, rng)
    cand = min(n // block, 512)

    fn = make_span_pipeline(k, block=block, cand_blocks=cand, packed=True)
    t0 = time.time()
    counts, nw = native.host_spectrum(nbases, k)
    log(f"host count: {time.time()-t0:.1f}s ({nw:,} kmers)")
    dev = jax.device_put(nbases)
    t0 = time.time()
    out = fn(dev, jnp.float32(thr))
    float(jax.device_get(out[:1])[0])
    log(f"compile+run: {time.time()-t0:.1f}s")
    t0 = time.time()
    host = unpack_outputs(np.asarray(out), k, n, block, cand,
                          packed_bases=fn.packed_bases,
                          packed_counts=fn.packed_counts, lazy_codes=True)
    res = finish_spans(host, n, thr, min_w, min_s, block=block,
                       counts=counts)
    log(f"finish: {time.time()-t0:.1f}s regions={len(res.regions)} "
        f"fallback={res.fallback}")

    # full oracle: 4^15 f64 chain (8 GB) + native sequential caller
    t0 = time.time()
    ranks = host_rank_chain(counts, nw)
    log(f"oracle chain (4^15): {time.time()-t0:.1f}s")
    t0 = time.time()
    beg, end, score, _ = native.find_spans(nbases, k, ranks, thr,
                                           min_w, min_s)
    log(f"oracle scan: {time.time()-t0:.1f}s regions={len(beg)}")
    got = [(r[1], r[2], r[3]) for r in res.regions]
    want = [(int(b), int(e), float(s)) for b, e, s in
            zip(beg, end, score)]
    ok = got == want
    log(f"k=15 bit-identity: match={ok} ({len(want)} regions)")
    if not ok:
        log(f"  got[:3]={got[:3]}")
        log(f"  want[:3]={want[:3]}")
        sys.exit(1)


if __name__ == "__main__":
    main()
