#!/usr/bin/env python
"""Smoke run of every span-calling path on an NVIDIA GPU, checked exactly.

    python chip_smoke.py            # every one-card phase (one GPU)
    python chip_smoke.py --four     # only the 4-card mesh phase (4 GPUs)

Each phase drives a public entry point (api / cli) at a realistic size,
calls the pipeline under it to assert that the device path itself
answered (its ``fallback``/``unresolved`` flags are False — the api
silently reruns the exact host path otherwise), and compares the regions
with the repo's exact host path: (seq_id, beg, end) equal and the f64
score equal bit for bit.  The oracle is the native C++ sequential caller
over the reference's f64 rank chain where it covers the call, else
``kmer_spans.oracle`` (on a cut, printed, where that is too slow).

Genomes are synthesized from a seed: uniform bases with planted repeat
islands (poly-AT, CAG, poly-A, a 7-mer tandem) and N runs.  Every phase
prints one JSON line; the last line is the device contract line.  Any
failure raises: the exit code is non-zero and no contract line prints.
Without a GPU the run stops before any phase (no CPU fallback).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import tempfile
import time

import numpy as np

THR, MIN_W, MIN_S = 0.75, 100, 20.0
#: planted repeat islands (repeat unit, copies), one per ISLAND_EVERY
#: bases, cycling through the kinds
_ISLANDS = (
    ((0, 3), 1000),                  # (AT)n: one hot bin at k=8
    ((1, 0, 3), 600),                # (CAG)n
    ((0,), 1500),                    # poly-A
    ((3, 1, 1, 0, 2, 3, 1), 250),    # 7-mer tandem
)
ISLAND_EVERY = 8_000_000


def island_period(n: int) -> int:
    return min(ISLAND_EVERY, max(n // 8, 1))


def genome(n: int, seed: int) -> np.ndarray:
    """nbases uint8 (N == 4): uniform bases, planted islands, N runs."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, 4, size=n, dtype=np.uint8)
    period = island_period(n)
    for j, base in enumerate(range(period // 2, n, period)):
        unit, reps = _ISLANDS[j % len(_ISLANDS)]
        e = base + len(unit) * reps
        if e < n:
            nb[base:e] = np.tile(np.array(unit, np.uint8), reps)
        g = base + period // 3
        if g + 400 < n:
            nb[g:g + int(rng.integers(1, 400))] = 4
    return nb


def split(nb: np.ndarray, parts: int):
    """Cut a genome into ``parts`` scaffolds of unequal length."""
    cuts = np.linspace(0, nb.shape[0], parts + 1).astype(np.int64)
    cuts[1:-1] += (np.arange(1, parts) * 7919) % 100_003
    return [nb[a:b].copy() for a, b in zip(cuts[:-1], cuts[1:])]


def packed(scaffolds):
    from kmer_spans.encoding import PackedSeq

    return [PackedSeq(bases=s & 3, valid=s < 4) for s in scaffolds]


def as_tuples(regions):
    """Structured api regions or (seq_id, beg, end, score) tuples ->
    sorted list of (seq_id, beg, end, score-bits)."""
    out = []
    for r in regions:
        sid, beg, end, sc = (r[0], r[1], r[2], r[3])
        out.append((int(sid), int(beg), int(end),
                    int(np.float64(sc).view(np.int64))))
    return sorted(out)


def same_regions(what, got, want):
    g, w = as_tuples(got), as_tuples(want)
    if g != w:
        gs, ws = set(g), set(w)
        raise AssertionError(
            f"{what}: {len(g)} regions vs {len(w)} expected; "
            f"only in result {sorted(gs - ws)[:5]}, "
            f"only in oracle {sorted(ws - gs)[:5]}")
    return len(g)


def oracle_rank_regions(scaffolds, k, thr=THR, min_w=MIN_W, min_s=MIN_S):
    """Exact rank-scored regions: native count over all scaffolds, the
    reference's f64 rank chain, the native sequential caller."""
    from kmer_spans.spans.pipeline import host_rank_chain
    from kmer_spans.utils import native

    counts = None
    total = 0
    for s in scaffolds:
        c, nw = native.host_spectrum(s, k)
        counts = c if counts is None else counts + c
        total += nw
    ranks = host_rank_chain(counts, total)
    del counts
    regions = []
    for i, s in enumerate(scaffolds):
        if s.shape[0] < k:
            continue
        beg, end, sc, _ = native.find_spans(s, k, ranks, thr, min_w, min_s)
        regions.extend(zip([i] * len(beg), beg, end, sc))
    return regions


def rank_pipeline_under(scaffolds, k, thr=THR, min_w=MIN_W, min_s=MIN_S):
    """The device pipeline kmer_low_comp_regions(mode="fast") runs, called
    directly: returns (regions in sequence coordinates, fallback)."""
    import jax.numpy as jnp

    from kmer_spans import api

    kept = [(i, p) for i, p in enumerate(packed(scaffolds)) if p.n >= k]
    arr, offsets = api.concat_padded(kept, 8192)
    n = arr.shape[0]
    if k >= 10:
        from kmer_spans.spans.pm_pipeline import (
            finish_pm_spans,
            unpack_pm_outputs,
        )

        fn, meta = api._cached_pm_pipeline(k, 8192, 128)
        out = unpack_pm_outputs(
            np.asarray(fn(jnp.asarray(arr), jnp.float32(thr))), n, meta)
        res = finish_pm_spans(out, n, meta, thr, min_w, min_s)
    else:
        from kmer_spans.spans.pipeline import finish_spans

        fn = api._cached_span_pipeline(k, 8192, 128)
        res = finish_spans(fn(jnp.asarray(arr), jnp.float32(thr)), n, thr,
                           min_w, min_s, block=8192)
    return api.to_sequence_coords(res.regions, kept, offsets), res.fallback


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0


class Smoke:
    def __init__(self, card: str):
        self.card = card

    def report(self, phase, **kw):
        print(json.dumps({"phase": phase, **kw, "card": self.card}),
              flush=True)

    # ---------------------------------------------------------- phases
    def golden(self):
        from kmer_spans import api
        from kmer_spans.utils.testgen import golden_genome

        g = golden_genome()
        res, t1 = timed(api.kmer_low_comp_regions, g, 8, MIN_W, MIN_S,
                        thr=THR, backend="jax", mode="fast")
        _, t2 = timed(api.kmer_low_comp_regions, g, 8, MIN_W, MIN_S,
                      thr=THR, backend="jax", mode="fast")
        from kmer_spans.encoding import pack

        p = pack(g)
        nb = np.where(p.valid, p.bases, 4).astype(np.uint8)
        under, fb = rank_pipeline_under([nb], 8)
        assert not fb, "golden: device pipeline fell back"
        want = api.kmer_low_comp_regions(g, 8, MIN_W, MIN_S, thr=THR,
                                         backend="host").regions
        nreg = same_regions("golden api", res.regions, want)
        same_regions("golden pipeline", under, want)
        assert nreg == 3, f"golden genome gave {nreg} regions, not 3"
        self.report("golden", bases=len(g), k=8, regions=nreg,
                    compile_s=max(t1 - t2, 0.0), wall_s=t2)

    def low_comp(self, k, n, parts, seed):
        from kmer_spans import api

        scaffolds = split(genome(n, seed), parts)
        seqs = packed(scaffolds)
        res, t1 = timed(api.kmer_low_comp_regions, seqs, k, MIN_W, MIN_S,
                        thr=THR, backend="jax", mode="fast")
        _, t2 = timed(api.kmer_low_comp_regions, seqs, k, MIN_W, MIN_S,
                      thr=THR, backend="jax", mode="fast")
        under, fb = rank_pipeline_under(scaffolds, k)
        assert not fb, f"low_comp k={k}: device pipeline fell back"
        want, t_o = timed(oracle_rank_regions, scaffolds, k)
        nreg = same_regions(f"low_comp k={k} api", res.regions, want)
        same_regions(f"low_comp k={k} pipeline", under, want)
        assert nreg > 0, f"low_comp k={k}: no regions on a planted genome"
        self.report(f"low_comp_k{k}", bases=sum(map(len, scaffolds)),
                    scaffolds=parts, k=k, regions=nreg,
                    compile_s=max(t1 - t2, 0.0), wall_s=t2,
                    oracle="native", oracle_s=t_o)

    def weight_scoring(self):
        """kmer_spans threshold / log2_median and the arbitrary-weight
        kmer_regions (its scan-count histogram is compared too)."""
        from kmer_spans import api

        k = 8
        scaffolds = split(genome(7_600_000, 11), 2)
        seqs = packed(scaffolds)
        rng = np.random.default_rng(5)
        table = rng.normal(-0.5, 1.0, 1 << (2 * k))
        cases = (
            ("threshold", dict(scoring="threshold", min_width=MIN_W,
                               min_score=50.0)),
            ("log2_median", dict(scoring="log2_median", min_width=MIN_W,
                                 min_score=MIN_S)),
            ("weights", dict(scoring="weights", kmer_scores=table,
                             min_width=50, min_score=15.0)),
        )
        for name, kw in cases:
            res, t1 = timed(api.kmer_spans, seqs, k, backend="jax", **kw)
            _, t2 = timed(api.kmer_spans, seqs, k, backend="jax", **kw)
            want = api.kmer_spans(seqs, k, backend="native", **kw)
            nreg = same_regions(f"kmer_spans {name} api", res.regions,
                                want.regions)
            if name == "weights":
                assert np.array_equal(res.counts, want.counts), \
                    "weights: device scan counts differ from native"
            # the pipeline under the api, per sequence: no fallback
            model = _weight_model(name, api, seqs, k, table)
            for i, p in enumerate(seqs):
                r, _ = api._weight_regions_device(
                    p, i, k, model, kw["min_width"], kw["min_score"],
                    name == "weights")
                assert not r.fallback, f"kmer_spans {name}: fell back"
            self.report(f"kmer_spans_{name}",
                        bases=sum(map(len, scaffolds)), scaffolds=2, k=k,
                        regions=nreg, compile_s=max(t1 - t2, 0.0),
                        wall_s=t2, oracle="native")

    def wide(self, k=17):
        from kmer_spans import api
        from kmer_spans.oracle import find_regions
        from kmer_spans.stats.ranks import SparseRanks
        from kmer_spans.utils import native

        nb = genome(100_000_000, 17)
        res, t1 = timed(api.kmer_wide_regions, packed([nb]), k, MIN_W, MIN_S,
                        thr=THR, backend="jax", with_spectrum=False)
        _, t2 = timed(api.kmer_wide_regions, packed([nb]), k, MIN_W, MIN_S,
                      thr=THR, backend="jax", with_spectrum=False)
        assert res.regions.shape[0] > 0, "wide: no regions"
        # pipeline under the api: device-complete wide pm screen
        import jax.numpy as jnp

        from kmer_spans.spans.pm_pipeline import (
            finish_pm_spans,
            unpack_pm_outputs,
        )

        p = packed([nb])
        arr, offsets = api.concat_padded([(0, p[0])], 8192)
        fn, meta = api._cached_wide_pm_pipeline(
            k, 8192, min(256, arr.shape[0] // 8192))
        out = unpack_pm_outputs(
            np.asarray(fn(jnp.asarray(arr), jnp.float32(THR))),
            arr.shape[0], meta)
        r = finish_pm_spans(out, arr.shape[0], meta, THR, MIN_W, MIN_S)
        assert not r.fallback, "wide: device pipeline fell back"
        same_regions("wide pipeline", r.regions, res.regions)
        # oracle on cuts: the sequential python caller over a sparse
        # exact rank lookup is too slow at full size.  One 2 Mb cut
        # centred on each of the first planted islands, one of each kind.
        from kmer_spans.encoding import PackedSeq

        cut_len = 2_000_000
        period = island_period(nb.shape[0])
        spans, ncut, t_o = [], 0, 0.0
        for j in range(len(_ISLANDS)):
            c0 = period // 2 + j * period - cut_len // 2
            cut = nb[c0:c0 + cut_len]
            got = api.kmer_wide_regions(packed([cut]), k, MIN_W, MIN_S,
                                        thr=THR, backend="jax",
                                        with_spectrum=False)
            uc, un, _ = native.host_spectrum_sparse(cut, k)
            want, t = timed(find_regions, PackedSeq(cut & 3, cut < 4), 0,
                            MIN_W, MIN_S, SparseRanks(uc, un), k, THR)
            n_j = same_regions(f"wide cut {c0}", got.regions, want)
            assert n_j > 0, f"wide cut {c0}: no regions"
            spans.append([c0, c0 + cut_len])
            ncut += n_j
            t_o += t
        self.report(f"wide_k{k}", bases=int(nb.shape[0]), k=k,
                    regions=int(res.regions.shape[0]),
                    compile_s=max(t1 - t2, 0.0), wall_s=t2,
                    oracle="oracle.find_regions on cuts",
                    oracle_cuts=spans, cut_regions=ncut, oracle_s=t_o)

    def window(self):
        from kmer_spans import api
        from kmer_spans.oracle import windowed_distributions

        nb = genome(48_000_000, 23)
        kmers = api.kmer_seq(2)
        seqs = packed([nb])
        res, t1 = timed(api.window_kmer_dist, seqs, kmers, 200, freq=False,
                        backend="jax")
        _, t2 = timed(api.window_kmer_dist, seqs, kmers, 200, freq=False,
                      backend="jax")
        from kmer_spans.encoding import PackedSeq, kmer_to_code

        tracked = np.array([kmer_to_code(x) for x in kmers], np.int64)
        want, t_o = timed(windowed_distributions, PackedSeq(nb & 3, nb < 4),
                          tracked, 2, 200)
        assert res.seq_i.tolist() == [1]
        assert np.array_equal(res.dist, want), "window: dist differs"
        self.report("window", bases=int(nb.shape[0]), kmers=len(kmers),
                    window=200, windows=int(want[:, 0].sum()),
                    compile_s=max(t1 - t2, 0.0), wall_s=t2,
                    oracle="oracle.windowed_distributions", oracle_s=t_o)

    def stream(self, k, scaffolds, fasta):
        """``cli stream`` on the FASTA, and the streaming pipeline under
        it (f64 scores bit for bit, no unresolved window)."""
        from kmer_spans import cli
        from kmer_spans.parallel.stream import StreamingSpanPipeline

        chunk = 1 << 25
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            cli.main(["stream", fasta, "-k", str(k), "--chunk", str(chunk)])
        t_cli = time.perf_counter() - t0
        assert " 0 unresolved windows" in err.getvalue(), err.getvalue()
        rows = [ln.split("\t") for ln in out.getvalue().splitlines()[1:]]

        pipe = StreamingSpanPipeline(k, chunk_bases=chunk, block=8192,
                                     cand_blocks=128)

        def chunks(s):
            return lambda: (s[i:i + chunk] for i in range(0, len(s), chunk))

        acc = None
        t0 = time.perf_counter()
        for s in scaffolds:
            acc = pipe.accumulate_counts(chunks(s), acc=acc)
        mass, total = pipe.finish_rank(acc)
        regions = []
        for i, s in enumerate(scaffolds):
            r = pipe.scan_stream(chunks(s), mass, total, THR, MIN_W, MIN_S,
                                 seq_id=i)
            assert not r.unresolved, f"stream k={k}: {r.unresolved}"
            regions.extend(r.regions)
        t_pipe = time.perf_counter() - t0
        want, t_o = timed(oracle_rank_regions, scaffolds, k)
        nreg = same_regions(f"stream k={k} pipeline", regions, want)
        text = sorted((f"s{sid}", str(b), str(e), f"{sc:.6f}")
                      for sid, b, e, sc in want)
        assert sorted(map(tuple, rows)) == text, f"cli stream k={k} differs"
        self.report(f"stream_k{k}", bases=sum(map(len, scaffolds)),
                    scaffolds=len(scaffolds), chunk=chunk, k=k,
                    regions=nreg, cli_s=t_cli, wall_s=t_pipe,
                    oracle="native", oracle_s=t_o)

    def streams(self):
        scaffolds = split(genome(256_000_000, 29), 3)
        letters = np.frombuffer(b"ACTGN", np.uint8)  # 2-bit order
        with tempfile.TemporaryDirectory() as d:
            fasta = os.path.join(d, "genome.fa")
            with open(fasta, "wb") as fh:
                for i, s in enumerate(scaffolds):
                    fh.write(f">s{i}\n".encode())
                    body = letters[s]
                    pad = (-body.shape[0]) % 80
                    lines = np.concatenate(
                        [body, np.full(pad, ord("\n"), np.uint8)]
                    ).reshape(-1, 80)
                    lines = np.concatenate(
                        [lines, np.full((lines.shape[0], 1), ord("\n"),
                                        np.uint8)], axis=1)
                    fh.write(lines.tobytes())
            for k in (8, 12):
                self.stream(k, scaffolds, fasta)

    def lr(self):
        from kmer_spans import api
        from kmer_spans.parallel.device import device_tr_regions

        k = 2
        scaffolds = split(genome(4_000_000, 31), 2)
        for s in scaffolds:  # CpG islands
            step = min(400_000, s.shape[0] // 4)
            for pos in range(step // 2, s.shape[0] - 400, step):
                s[pos:pos + 300] = np.tile(np.array([1, 3], np.uint8), 150)
        kmers = api.kmer_seq(k)
        ks = np.array([2.0 if x == "CG" else -1.0 for x in kmers])
        ts = np.array([2.0 if x == "CG" else -0.5 for x in kmers])
        seqs = packed(scaffolds)
        res, t1 = timed(api.lr_regions, seqs, (k, 50), kmers, ks, ts,
                        backend="jax")
        _, t2 = timed(api.lr_regions, seqs, (k, 50), kmers, ks, ts,
                      backend="jax")
        for i, p in enumerate(seqs):
            _, fb = device_tr_regions(p, k, ks, ts, 50, seq_id=i + 1)
            assert not fb, "lr: device pipeline fell back"
        want, t_o = timed(api.lr_regions, seqs, (k, 50), kmers, ks, ts,
                          backend="host")
        nreg = same_regions("lr", res.regions, want.regions)
        assert nreg > 0, "lr: no regions"
        self.report("lr_regions", bases=sum(map(len, scaffolds)),
                    scaffolds=2, k=k, regions=nreg,
                    compile_s=max(t1 - t2, 0.0), wall_s=t2,
                    oracle="oracle.find_tr_regions", oracle_s=t_o)

    def one_card(self):
        self.golden()
        self.low_comp(8, 200_000_000, 4, 1)
        gc.collect()
        self.low_comp(12, 100_000_000, 2, 2)
        gc.collect()
        self.low_comp(15, 100_000_000, 2, 3)
        gc.collect()
        self.weight_scoring()
        self.wide()
        gc.collect()
        self.window()
        self.streams()
        gc.collect()
        self.lr()

    # ------------------------------------------------------ four cards
    def four(self):
        """Hash-sharded k=15 and wide k=17 on a 4-device mesh, each equal
        bit for bit to the one-card result on the same genome."""
        import jax

        from kmer_spans import api
        from kmer_spans.parallel.pipeline import data_mesh
        from kmer_spans.parallel.sharded_scan import sharded_low_comp_regions
        from kmer_spans.parallel.wide_scan import wide_low_comp_regions

        if len(jax.devices()) < 4:
            raise SystemExit(f"--four needs 4 devices, have "
                             f"{len(jax.devices())}")
        mesh = data_mesh(4)
        assert mesh.devices.size == 4
        nb = genome(248_000_000, 41)
        for k, fn, extra, one in (
            (15, sharded_low_comp_regions, dict(vmax=1 << 16),
             lambda: api.kmer_low_comp_regions(
                 packed([nb]), 15, MIN_W, MIN_S, thr=THR,
                 backend="jax", mode="fast").regions),
            (17, wide_low_comp_regions, {},
             lambda: api.kmer_wide_regions(
                 packed([nb]), 17, MIN_W, MIN_S, thr=THR, backend="jax",
                 with_spectrum=False).regions),
        ):
            kw = dict(thr=THR, block=8192, cand_blocks=64, **extra)
            res, t1 = timed(fn, mesh, nb, k, MIN_W, MIN_S, **kw)
            assert not res.fallback and not res.overflow, \
                f"mesh k={k}: fallback={res.fallback} " \
                f"overflow={res.overflow}"
            assert res.devices == 4, \
                f"mesh k={k}: sharded over {res.devices} devices, not 4"
            want, t_one = timed(one)
            nreg = same_regions(f"mesh k={k} vs one card", res.regions,
                                want)
            assert nreg > 0, f"mesh k={k}: no regions"
            self.report(f"mesh4_k{k}", bases=int(nb.shape[0]), k=k,
                        devices=4, regions=nreg, first_call_s=t1,
                        one_card_s=t_one)
            gc.collect()


def _weight_model(name, api, seqs, k, table):
    """The scoring model kmer_spans builds for ``name`` (device counts)."""
    from kmer_spans.models.scoring import (
        Log2MedianScoring,
        ThresholdScoring,
        WeightScoring,
    )
    from kmer_spans.stats.ranks import spectrum_median_freq

    if name == "weights":
        return WeightScoring(table)
    counts = api.kmer_counts(seqs, k, with_f=False, backend="jax").counts
    if name == "threshold":
        return ThresholdScoring(counts, spectrum_median_freq(counts))
    return Log2MedianScoring(counts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh phase")
    args = ap.parse_args(argv)

    from kmer_spans.utils import native, runtime

    cache = runtime.enable_compile_cache()
    import jax

    devs = runtime.require_gpu()
    card = runtime.card_info()
    print(card, flush=True)
    t0 = time.perf_counter()
    native_ok = native.build()
    print(json.dumps({
        "phase": "setup", "native": "native" if native_ok else "numpy",
        "native_build_s": time.perf_counter() - t0, "cache": cache,
        "devices": len(devs), "card": card}), flush=True)
    if not native_ok:
        raise SystemExit("native library failed to build: the exact "
                         "oracle needs it at these sizes")
    smoke = Smoke(card)
    if args.four:
        smoke.four()
    else:
        smoke.one_card()
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()
