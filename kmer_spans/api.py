"""User-facing API, mirroring the reference's R layer (SURVEY.md §2.4).

Function-for-function parity with kmer_spans.R:
  kmer_counts            <- kmer.counts          (kmer_spans.R:18-27)
  kmer_regions           <- kmer.regions         (kmer_spans.R:41-52)
  kmer_low_comp_regions  <- kmer.low.comp.regions(kmer_spans.R:72-79)
  kmer_seq               <- kmer.seq             (kmer_spans.R:84-86)
  lr_regions             <- lr.regions           (kmer_spans.R:88-99)
  window_kmer_dist       <- window.kmer.dist     (kmer_spans.R:104-119)
  kmers_to_file/read_kmers                       (kmer_spans.R:135-186)

Backends:
  * "host": the sequential/numpy oracle — exact, no accelerator.
  * "jax":  device codes + spectrum counting; ranks and span extraction on
            host in exact f64 (sequential summation order), so results are
            bit-identical to "host".  This is the default when a device is
            available.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import oracle
from .encoding import MAX_K, PackedSeq, all_kmers, kmer_to_code, pack
from .models.scoring import (
    Log2MedianScoring,
    RankScoring,
    ScoringModel,
    ThresholdScoring,
    WeightScoring,
)

_REGION_DTYPE = np.dtype(
    [
        ("seq_id", np.int32),
        ("beg", np.int32),
        ("end", np.int32),
        ("score", np.float64),
        ("entropy", np.float64),  # always 0, as in the reference (SURVEY #8)
    ]
)


def _as_region_array(regions) -> np.ndarray:
    out = np.zeros(len(regions), dtype=_REGION_DTYPE)
    for i, (sid, beg, end, score) in enumerate(regions):
        out[i] = (sid, beg, end, score, 0.0)
    return out


def _as_seq_list(seqs) -> list[PackedSeq]:
    if isinstance(seqs, (str, bytes, PackedSeq)):
        seqs = [seqs]
    return [pack(s) for s in seqs]


def _resolve_backend(backend: str) -> str:
    if backend == "auto":
        try:
            import jax

            jax.devices()
            return "jax"
        except Exception:
            pass
        from .utils import native as _native

        return "native" if _native.available() else "host"
    if backend == "native":
        from .utils import native as _native

        if not _native.available():
            raise RuntimeError("native backend unavailable (no C++ toolchain)")
        return backend
    if backend not in ("host", "jax"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def _nbases_of(p: PackedSeq) -> np.ndarray:
    nb = p.bases.copy()
    nb[~p.valid] = 4
    return nb


# ---------------------------------------------------------------------------
# Spectrum counting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KmerCountResult:
    k: int
    n: float  # total k-mers counted (reference returns this as double)
    counts: np.ndarray  # int64 [4^k]
    f: np.ndarray | None = None  # counts / sum(counts) when with_f


def kmer_counts(seqs, k: int, with_f: bool = True, backend: str = "auto") -> KmerCountResult:
    """Dense 4^k spectrum over the combined set of sequences.

    Sequences shorter than k are skipped (reference src/kmer_spans.c:478-479).
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k should be in [1, {MAX_K}]")
    backend = _resolve_backend(backend)
    packed = _as_seq_list(seqs)
    if backend == "jax":
        from .parallel.device import device_count_spectrum

        counts, n = device_count_spectrum(packed, k)
    elif backend == "native":
        from .utils import native

        counts = np.zeros(1 << (2 * k), dtype=np.int64)
        n = 0
        for p in packed:
            if p.n < k:
                continue
            c, nw = native.count_spectrum(_nbases_of(p), k)
            counts += c
            n += nw
    else:
        counts = np.zeros(1 << (2 * k), dtype=np.int64)
        n = 0
        for p in packed:
            if p.n < k:
                continue
            _, nw = oracle.count_spectrum(p, k, counts)
            n += nw
    f = counts / counts.sum() if with_f and counts.sum() else None
    return KmerCountResult(k=k, n=float(n), counts=counts, f=f)


# ---------------------------------------------------------------------------
# Span calling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RegionResult:
    n: np.ndarray  # reference's n slot (shape varies by call; see docstrings)
    counts: np.ndarray | None
    regions: np.ndarray  # structured (seq_id, beg, end, score, entropy)
    w_rank: np.ndarray | None = None


def _score_table(k: int, kmer_scores) -> np.ndarray:
    """Resolve scores to a 4^k f64 array in 2-bit index order.

    Accepts a dict {kmer string: score} in any order (the R wrapper's
    name-reorder, kmer_spans.R:44-47) or an array already in 2-bit order.
    """
    size = 1 << (2 * k)
    if isinstance(kmer_scores, dict):
        if len(kmer_scores) != size:
            raise ValueError(f"there should be a total of 4^k ({size}) scores")
        table = np.empty(size, dtype=np.float64)
        seen = np.zeros(size, dtype=bool)
        for kmer, sc in kmer_scores.items():
            if len(kmer) != k:
                raise ValueError(f"k-mer {kmer!r} is not length {k}")
            code = kmer_to_code(kmer)
            table[code] = sc
            seen[code] = True
        if not seen.all():
            raise ValueError("all kmers not defined")
        return table
    table = np.asarray(kmer_scores, dtype=np.float64)
    if table.shape != (size,):
        raise ValueError(f"kmer_scores must have 4^k = {size} entries")
    return table


def _weight_regions_device(p, seq_id, k, model, min_width, min_score,
                           want_scan_counts, block=4096):
    """One sequence through the device weight pipeline.

    Returns (SpanPipelineResult, scan counts int64 [4^k] or None); the
    result's ``fallback`` flags a candidate overflow (the caller then
    reruns the sequence on the exact host path).
    """
    import jax.numpy as jnp

    from .parallel.device import bucket_size
    from .spans.pipeline import (
        finish_weight_spans,
        make_weight_span_pipeline,
        quantize_weight_table,
    )

    npad = max(bucket_size(p.n), block)
    nb_arr = np.full(npad, 4, np.uint8)
    nb_arr[: p.n] = np.where(p.valid, p.bases, 4).astype(np.uint8)
    w_q, scale = quantize_weight_table(model.weights, model.threshold, block)
    fn = make_weight_span_pipeline(
        k, block=block, cand_blocks=min(128, npad // block),
        with_scan_counts=want_scan_counts,
    )
    dev = jnp.asarray(nb_arr)
    out = fn(dev, jnp.asarray(w_q))
    seq_scan = (np.zeros(1 << (2 * k), dtype=np.int64)
                if want_scan_counts else None)
    res = finish_weight_spans(
        out, npad, model.weights, model.threshold, min_width,
        min_score, scale, block=block, seq_id=seq_id,
        scan_counts=seq_scan,
        pull_fn=getattr(fn, "pull", None), nbases_dev=dev,
    )
    if want_scan_counts and not res.fallback:
        seq_scan += np.asarray(out["scan_hist"]).astype(np.int64)
    return res, seq_scan


def _call_regions(
    packed: list[PackedSeq],
    k: int,
    model: ScoringModel,
    min_width: int,
    min_score: float,
    backend: str,
    want_scan_counts: bool,
):
    """Shared span-calling core for kmer_regions / kmer_low_comp_regions."""
    size = 1 << (2 * k)
    scan_counts = np.zeros(size, dtype=np.int64) if want_scan_counts else None
    all_regions = []
    if backend == "jax":
        # sparse screen-then-replay (spans.pipeline.make_weight_span_pipeline);
        # a flagged candidate overflow falls back to the exact host oracle
        # for that sequence only
        for i, p in enumerate(packed):
            if p.n < k:
                continue
            res, seq_scan = _weight_regions_device(
                p, i, k, model, min_width, min_score, want_scan_counts)
            if res.fallback:
                sc32 = np.zeros(size, np.int64) if want_scan_counts else None
                regs = oracle.find_regions(
                    p, i, min_width, min_score, model.weights, k,
                    model.threshold, scan_counts=sc32,
                )
                all_regions.extend(regs)
                if want_scan_counts:
                    scan_counts += sc32
                continue
            all_regions.extend(res.regions)
            if want_scan_counts:
                scan_counts += seq_scan
    elif backend == "native":
        from .utils import native

        for i, p in enumerate(packed):
            if p.n < k:
                continue
            beg, end, score, sc = native.find_spans(
                _nbases_of(p), k, model.weights, model.threshold,
                min_width, min_score, want_scan_counts=want_scan_counts,
            )
            all_regions.extend(
                (i, int(b), int(e), float(s))
                for b, e, s in zip(beg, end, score)
            )
            if want_scan_counts:
                scan_counts += sc
    else:
        for i, p in enumerate(packed):
            if p.n < k:
                continue
            sc32 = None
            if want_scan_counts:
                sc32 = np.zeros(size, dtype=np.int64)
            regs = oracle.find_regions(
                p, i, min_width, min_score, model.weights, k,
                model.threshold, scan_counts=sc32,
            )
            all_regions.extend(regs)
            if want_scan_counts:
                scan_counts += sc32
    return all_regions, scan_counts


def kmer_regions(
    seqs, k: int, kmer_scores, min_width: int, min_score: float,
    backend: str = "auto",
) -> RegionResult:
    """Arbitrary-weight span calling (reference kmer_regions_r, :490-546).

    Returns n = total sequence length (of sequences >= k), scan counts
    (k-mers at *scanned* positions, rescans double-counted — reference
    quirk), and the regions.
    """
    backend = _resolve_backend(backend)
    if k >= 16:
        raise ValueError("kmer sizes >= 16 not supported")
    packed = _as_seq_list(seqs)
    model = WeightScoring(_score_table(k, kmer_scores))
    total_len = float(sum(p.n for p in packed if p.n >= k))
    regions, scan_counts = _call_regions(
        packed, k, model, min_width, min_score, backend, want_scan_counts=True
    )
    return RegionResult(
        n=np.array([total_len]),
        counts=scan_counts,
        regions=_as_region_array(regions),
    )


def kmer_low_comp_regions(
    seqs, k: int, min_w: int, min_score: float, thr: float = 0.75,
    backend: str = "auto", mode: str = "exact",
) -> RegionResult:
    """The flagship pipeline: spectrum -> weighted ranks -> rank-scored spans
    (reference kmer_low_comp_regions, :548-621; kmer_spans.R:72-79).

    mode="exact" (default): ranks via the reference's sequential f64 chain;
    spans bit-identical to the C implementation.
    mode="fast": the sparse single-chip device pipeline (spans/pipeline) —
    one compiled program for ALL sequences (concatenated with N
    separators), mass/total ranks (can differ from the chain in the last
    ulp), exact f64 replay of candidates.  Falls back to exact when the
    device candidate capacity overflows.
    """
    backend = _resolve_backend(backend)
    packed = _as_seq_list(seqs)
    if mode == "fast" and backend == "jax":
        res = _low_comp_fast(packed, k, min_w, min_score, thr)
        if res is not None:
            return res
        # capacity overflow: fall through to the exact path
    cr = kmer_counts(packed, k, with_f=False, backend=backend)
    model = RankScoring(cr.counts, cr.n, thr)
    regions, _ = _call_regions(
        packed, k, model, min_w, min_score, backend, want_scan_counts=False
    )
    return RegionResult(
        n=np.array([cr.n, 0.0]),  # slot 1 is always 0 in the reference (:613)
        counts=cr.counts,
        regions=_as_region_array(regions),
        w_rank=model.weights,
    )


@functools.lru_cache(maxsize=8)
def _cached_span_pipeline(k, block, cand_blocks):
    """One jitted pipeline per (k, block, cand) — repeat api calls reuse
    the in-process jit cache instead of rebuilding the closure."""
    from .spans.pipeline import make_span_pipeline

    return make_span_pipeline(k, block=block, cand_blocks=cand_blocks)


@functools.lru_cache(maxsize=8)
def _cached_wide_pipeline(k, block, cand_blocks):
    from .spans.pipeline import make_wide_span_pipeline

    return make_wide_span_pipeline(k, block=block, cand_blocks=cand_blocks)


@functools.lru_cache(maxsize=8)
def _cached_pm_pipeline(k, block, cand_blocks):
    """Device-complete k >= 10 pipeline (spans/pm_pipeline.py): the
    replay needs no host spectrum — the api recounts only to populate
    the reference-parity ``counts``/``w_rank`` result fields."""
    from .spans.pm_pipeline import make_pm_span_pipeline

    return make_pm_span_pipeline(k, block=block, cand_blocks=cand_blocks)


@functools.lru_cache(maxsize=8)
def _cached_pm_pipeline_packed(k, block, cand_blocks):
    """Forced packed-key pm build: the overflow retry for repeat-heavy
    inputs whose high-count run list outgrows the smallv capacity."""
    from .spans.pm_pipeline import make_pm_span_pipeline

    return make_pm_span_pipeline(k, block=block, cand_blocks=cand_blocks,
                                 strategy="packed")


@functools.lru_cache(maxsize=8)
def _cached_wide_pm_pipeline(k, block, cand_blocks):
    from .spans.pm_pipeline import make_wide_pm_pipeline

    return make_wide_pm_pipeline(k, block=block, cand_blocks=cand_blocks)


def concat_padded(kept, block):
    """(seq_id, PackedSeq) pairs -> (nbases u8 [npad], offsets).

    Sequences concatenate with single-N separators (segments never span
    N, so per-sequence semantics are preserved exactly); offsets[j] is
    the global 0-based start of kept[j].  npad is a power-of-two length
    bucket (one compiled program per (k, bucket), not per total length),
    rounded up to a multiple of ``block``; the tail pads with N.
    """
    total_len = sum(p.n for _, p in kept) + len(kept) - 1
    npad = max(block, 1 << 13)
    while npad < total_len:
        npad *= 2
    npad = -(-npad // block) * block
    arr = np.full(npad, 4, np.uint8)
    offsets = []
    pos = 0
    for j, (_, p) in enumerate(kept):
        if j:
            pos += 1  # N separator
        offsets.append(pos)
        arr[pos : pos + p.n] = np.where(p.valid, p.bases, 4)
        pos += p.n
    return arr, offsets


def to_sequence_coords(glob_regions, kept, offsets):
    """Regions in concat_padded coordinates -> (seq_id, local beg, local
    end, score) of the sequence each falls in."""
    import bisect

    out = []
    for _, beg, end, score in glob_regions:
        j = bisect.bisect_right(offsets, beg - 1) - 1
        out.append((kept[j][0], beg - offsets[j], end - offsets[j], score))
    return out


def _low_comp_fast(packed, k, min_w, min_score, thr, block=8192,
                   cand_blocks=128):
    """Sparse device pipeline over all sequences in one program.

    Sequences >= k concatenate with single-N separators (segments never
    span N, so per-sequence semantics are preserved exactly); emitted
    global positions map back to (seq_id, local 1-based) coordinates.
    Returns None on candidate-capacity overflow.
    """
    import jax.numpy as jnp

    from .spans.pipeline import finish_spans

    if not 0.0 < thr < 1.0:
        raise ValueError("the threshold must be between 0 and 1")
    kept = [(i, p) for i, p in enumerate(packed) if p.n >= k]
    if not kept:
        return RegionResult(
            n=np.array([0.0, 0.0]),
            counts=np.zeros(1 << (2 * k), np.int64),
            regions=_as_region_array([]),
            w_rank=np.zeros(1 << (2 * k)),
        )
    arr, offsets = concat_padded(kept, block)
    npad = arr.shape[0]
    if k >= 10:
        # device-complete pm pipeline: the replay needs no spectrum; the
        # host recount below only fills the reference-parity counts /
        # w_rank result fields (part of the R API's return value)
        from .spans.pm_pipeline import finish_pm_spans, unpack_pm_outputs
        from .utils import native

        fnp, meta = _cached_pm_pipeline(k, block, cand_blocks)
        dev_arr = jnp.asarray(arr)
        vec = np.asarray(fnp(dev_arr, jnp.float32(thr)))
        out_pm = unpack_pm_outputs(vec, npad, meta)
        res = finish_pm_spans(out_pm, npad, meta, thr, min_w, min_score)
        if res.fallback and k <= 14 and \
                out_pm["list_count"] > meta["list_cap"]:
            # smallv run-list overflow (repeat-heavy input beyond the
            # Poisson sizing): the packed-key strategy clips high
            # counts into the key instead of listing them — one retry
            # before surrendering to the exact host path
            fnp2, meta2 = _cached_pm_pipeline_packed(k, block, cand_blocks)
            vec = np.asarray(fnp2(dev_arr, jnp.float32(thr)))
            out_pm = unpack_pm_outputs(vec, npad, meta2)
            res = finish_pm_spans(out_pm, npad, meta2, thr, min_w,
                                  min_score)
        if res.fallback:
            return None
        counts_host, _ = native.host_spectrum(arr, k)
        counts = np.asarray(counts_host).astype(np.int64)
        total = int(out_pm["total"])
    else:
        fn = _cached_span_pipeline(k, block, cand_blocks)
        out = fn(jnp.asarray(arr), jnp.float32(thr))
        res = finish_spans(out, npad, thr, min_w, min_score, block=block)
        if res.fallback:
            return None
        counts = np.asarray(out["counts"]).astype(np.int64)
        total = int(np.asarray(out["total"]))
    regions = to_sequence_coords(res.regions, kept, offsets)
    from .stats.ranks import cumulative_mass

    return RegionResult(
        n=np.array([float(total), 0.0]),
        counts=counts,
        regions=_as_region_array(regions),
        w_rank=cumulative_mass(counts).astype(np.float64) / max(total, 1),
    )


def kmer_seq(k: int) -> list[str]:
    """All 4^k k-mer strings in 2-bit index order (A, C, T, G)."""
    return all_kmers(k)


@dataclasses.dataclass
class WideRegionResult:
    """kmer_wide_regions output: regions + the SPARSE spectrum.

    At k >= 16 a dense 4^k counts array cannot exist (the reference's own
    MAX_K tops out below this — SURVEY §2.1 #4), so the spectrum is
    (codes, counts) over distinct k-mers only.
    """

    regions: np.ndarray          # structured (_REGION_DTYPE)
    spectrum_codes: np.ndarray   # int64, distinct codes ascending
    spectrum_counts: np.ndarray  # int64
    n_words: int                 # total counted k-mers


def kmer_wide_regions(
    seqs, k: int, min_w: int, min_score: float, thr: float = 0.75,
    backend: str = "auto", block: int = 8192, cand_blocks: int = 256,
    with_spectrum: bool = True,
) -> WideRegionResult:
    """Rank-scored spans for WIDE k (16..23) — past the reference's MAX_K.

    Semantics are kmer_low_comp_regions' (spectrum -> weighted ranks ->
    spans; src/kmer_spans.c:548-621) extended to k where only a sparse
    spectrum can exist.  backend "jax" runs the DEVICE-COMPLETE wide pm
    pipeline (pair codes + exact-mass screen, spans/pm_pipeline.py) with
    candidates replayed through the exact f64 chain from device-emitted
    mass; "host" (and any device capacity overflow) runs the sequential
    oracle over a SparseRanks lookup.  Both give identical output.

    with_spectrum=False skips the host sparse recount when the device
    pipeline succeeds (regions don't need it — round 5); the result's
    spectrum fields are then empty and n_words comes from the device.
    """
    from .ops.blocked import WIDE_MAX_K

    if not 16 <= k <= WIDE_MAX_K:
        raise ValueError(f"kmer_wide_regions needs 16 <= k <= {WIDE_MAX_K}")
    if not 0.0 < thr < 1.0:
        raise ValueError("the threshold must be between 0 and 1")
    backend = _resolve_backend(backend)
    packed = _as_seq_list(seqs)
    kept = [(i, p) for i, p in enumerate(packed) if p.n >= k]
    empty = np.zeros(0, np.int64)
    if not kept:
        return WideRegionResult(_as_region_array([]), empty, empty, 0)
    arr, offsets = concat_padded(kept, block)
    npad = arr.shape[0]
    from .utils import native

    cat = PackedSeq(bases=arr & 3, valid=arr < 4)
    glob_regions = None
    total_dev = None
    if backend == "jax":
        # DEVICE-COMPLETE wide pm pipeline (round 5): regions need no
        # host spectrum at all — the device emits exact per-position
        # mass + the sparse value histogram + the high-count run list
        import jax.numpy as jnp

        from .spans.pm_pipeline import finish_pm_spans, unpack_pm_outputs

        fnp, meta = _cached_wide_pm_pipeline(
            k, block, min(cand_blocks, npad // block))
        v = np.asarray(fnp(jnp.asarray(arr), jnp.float32(thr)))
        got = unpack_pm_outputs(v, npad, meta)
        res = finish_pm_spans(got, npad, meta, thr, min_w, min_score)
        if not res.fallback:
            glob_regions = res.regions
            total_dev = got["total"]
    ucodes = ucounts = None
    n_words = 0
    if glob_regions is None or with_spectrum:
        # the sparse host recount is needed only to (a) serve the host
        # oracle on device capacity overflow or (b) populate the result
        # spectrum when the caller asked for it (native C when
        # available: code-space-partitioned threads)
        ucodes, ucounts, n_words = native.host_spectrum_sparse(arr, k)
        if total_dev is not None and n_words != total_dev:
            raise AssertionError(
                f"device total {total_dev} != host recount {n_words}")
    if glob_regions is None:
        # host oracle (or device capacity overflow): sequential caller
        # over the sparse-exact rank lookup
        from .stats.ranks import SparseRanks

        sr = SparseRanks(ucodes, ucounts)
        glob_regions = oracle.find_regions(
            cat, 0, min_w, min_score, sr, k, thr)
    if ucodes is None:
        empty64 = np.zeros(0, np.int64)
        ucodes = ucounts = empty64
        n_words = int(total_dev)
    regions = to_sequence_coords(glob_regions, kept, offsets)
    return WideRegionResult(
        _as_region_array(regions), ucodes, ucounts, n_words)


# ---------------------------------------------------------------------------
# Transition-score regions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LrRegionResult:
    kmer_scores: np.ndarray  # [4^k, 2] reordered (seed, transition) tables
    regions: np.ndarray  # structured; score column + null column (entropy)


def lr_regions(
    seqs, params, kmers, kmer_scores, trans_scores, backend: str = "auto"
) -> LrRegionResult:
    """Transition-score span calling (reference tr_lr_regions_r, :649-713).

    params = (k, min_length).  ``kmers`` gives the order of the score
    tables (any order, e.g. alphabetical); they are reordered to 2-bit
    order by re-encoding each k-mer string, as the reference does
    (:686-694).
    """
    k, min_length = int(params[0]), int(params[1])
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k should be in [1, {MAX_K}]")
    if min_length < 0:
        raise ValueError("min_length should be a positive integer")
    size = 1 << (2 * k)
    kmer_scores = np.asarray(kmer_scores, dtype=np.float64)
    trans_scores = np.asarray(trans_scores, dtype=np.float64)
    if not (len(kmers) == kmer_scores.shape[0] == trans_scores.shape[0] == size):
        raise ValueError("kmers, kmer_scores, trans_scores should all be 4^k long")
    ks = np.empty(size, dtype=np.float64)
    ts = np.empty(size, dtype=np.float64)
    for i, kmer in enumerate(kmers):
        code = kmer_to_code(kmer)
        ks[code] = kmer_scores[i]
        ts[code] = trans_scores[i]
    backend = _resolve_backend(backend)
    packed = _as_seq_list(seqs)
    regions = []
    for i, p in enumerate(packed):
        # reference seq_id starts at 1 here (:699)
        if backend == "jax":
            from .parallel.device import device_tr_regions

            regs, fallback = device_tr_regions(p, k, ks, ts, min_length,
                                               seq_id=i + 1)
            if fallback:
                regs = oracle.find_tr_regions(p, i + 1, k, ks, ts, min_length)
            regions.extend(regs)
        else:
            regions.extend(
                oracle.find_tr_regions(p, i + 1, k, ks, ts, min_length))
    return LrRegionResult(
        kmer_scores=np.stack([ks, ts], axis=1),
        regions=_as_region_array(regions),
    )


# ---------------------------------------------------------------------------
# Windowed k-mer count distributions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WindowDistResult:
    dist: np.ndarray  # (window+1, kmer_n); frequencies if freq else counts
    seq_i: np.ndarray  # int [n_seqs]; 1 where the sequence was included
    scores: list | None  # per-seq (len, kmer_n) count matrices if ret_flag&1
    kmers: list[str]


def window_kmer_dist(
    seqs, kmers, window: int, freq: bool = True, ret_flag: int = 0,
    backend: str = "auto",
) -> WindowDistResult:
    """Sliding-window occurrence distributions (reference :717-793).

    Sequences with length <= window are skipped and flagged 0 in seq_i.
    """
    kmers = list(kmers)
    klens = {len(x) for x in kmers}
    if len(klens) != 1:
        raise ValueError("all kmers must be of the same size")
    k = klens.pop()
    if k >= 16:
        raise ValueError("kmer sizes >= 16 not supported")
    if window < 2 * k:
        raise ValueError("the window size must be at least two times k")
    backend = _resolve_backend(backend)
    tracked = np.array([kmer_to_code(x) for x in kmers], dtype=np.int64)
    packed = _as_seq_list(seqs)
    dist = np.zeros((window + 1, len(kmers)), dtype=np.int64)
    seq_i = np.zeros(len(packed), dtype=np.int64)
    scores = [] if (ret_flag & 1) else None
    for i, p in enumerate(packed):
        if p.n <= window:
            if scores is not None:
                scores.append(None)
            continue
        seq_i[i] = 1
        counts_pos = None
        if scores is not None:
            counts_pos = np.zeros((p.n, len(kmers)), dtype=np.int64)
            scores.append(counts_pos)
        if backend == "jax":
            from .parallel.device import device_window_dist

            d, cpos = device_window_dist(p, tracked, k, window,
                                         counts_pos is not None)
            dist += d
            if counts_pos is not None:
                counts_pos[:] = cpos
        else:
            oracle.windowed_distributions(
                p, tracked, k, window, dist, counts_pos)
    out = dist.astype(np.float64)
    if freq:
        colsum = out.sum(axis=0)
        colsum[colsum == 0] = 1.0
        out = out / colsum
    return WindowDistResult(
        dist=out if freq else dist, seq_i=seq_i, scores=scores, kmers=kmers
    )


# ---------------------------------------------------------------------------
# Batch persistence (reference kmers.to.file / read.kmers, kmer_spans.R:135-186)
# ---------------------------------------------------------------------------

def kmers_to_file(seq_f, out_prefix: str, k, min_l: int = 100_000,
                  backend: str = "auto"):
    """FASTA -> binary spectrum file for each k in ``k`` (scalar or list).

    Sequences shorter than min_l are dropped before counting (reference
    default 1e5).  Returns (seq_f, out_f, seq_size, seq_fsize, seq_fl) like
    the reference; out_f is None when reading/filtering fails.
    """
    from .io.fasta import read_fasta
    from .io.spectrum_file import write_kmers

    ks = [int(k)] if np.isscalar(k) else [int(x) for x in k]
    out_f = f"{out_prefix}counts_{'_'.join(str(x) for x in ks)}.bin"
    try:
        records = read_fasta(seq_f)
        seq_size = sum(len(s) for _, s in records)
        kept = [s for _, s in records if len(s) >= min_l]
        seq_fsize = sum(len(s) for s in kept)
        seq_fl = len(kept)
        if not kept:
            raise ValueError("no sequence after length filtering")
        packed = [pack(s) for s in kept]
        counts = [kmer_counts(packed, kk, with_f=False, backend=backend).counts
                  for kk in ks]
    except Exception:
        return (seq_f, None, 0, 0, 0)
    write_kmers(out_f, counts)
    return (seq_f, out_f, seq_size, seq_fsize, seq_fl)


def read_kmers(fname):
    """Read a binary spectrum file (magic 310572); None on bad magic."""
    from .io.spectrum_file import read_kmers as _read

    return _read(fname)


# ---------------------------------------------------------------------------
# Unified scoring-variant span calling (README.md:25-54's three functions)
# ---------------------------------------------------------------------------

def kmer_spans(
    seqs,
    k: int,
    scoring: str = "rank",
    min_width: int = 100,
    min_score: float = 20.0,
    thr: float = 0.75,
    f_t: float | None = None,
    kmer_scores=None,
    backend: str = "auto",
) -> RegionResult:
    """Span calling with any of the reference's scoring functions.

    scoring:
      * "rank"        — s = rank_i - thr (weighted-rank; the flagship
                        kmer.low.comp.regions pipeline)
      * "threshold"   — s = +1 if f_i >= f_t else -1 (README.md:34-42);
                        f_t defaults to the weighted median frequency
      * "log2_median" — s = log2(f_i / f_med) (README.md:27-32)
      * "weights"     — arbitrary caller table (kmer.regions)
    """
    backend = _resolve_backend(backend)
    packed = _as_seq_list(seqs)
    if scoring == "weights":
        if kmer_scores is None:
            raise ValueError("scoring='weights' requires kmer_scores")
        return kmer_regions(packed, k, kmer_scores, min_width, min_score,
                            backend=backend)
    cr = kmer_counts(packed, k, with_f=False, backend=backend)
    if scoring == "rank":
        model = RankScoring(cr.counts, cr.n, thr)
    elif scoring == "threshold":
        if f_t is None:
            from .stats.ranks import spectrum_median_freq

            f_t = spectrum_median_freq(cr.counts)
        model = ThresholdScoring(cr.counts, f_t)
    elif scoring == "log2_median":
        model = Log2MedianScoring(cr.counts)
    else:
        raise ValueError(f"unknown scoring {scoring!r}")
    regions, _ = _call_regions(
        packed, k, model, min_width, min_score, backend,
        want_scan_counts=False,
    )
    return RegionResult(
        n=np.array([cr.n]),
        counts=cr.counts,
        regions=_as_region_array(regions),
        w_rank=model.weights if scoring == "rank" else None,
    )
