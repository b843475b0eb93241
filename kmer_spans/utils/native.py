"""ctypes binding for the native C++ kernels (native/kmerspans_native.cpp).

The library is built on demand (make -C native) from the committed
source, and rebuilt when the source is newer than the library (a
library built on another machine may target another CPU: the Makefile
compiles with -march=native).  Every entry point degrades gracefully to
the pure-numpy implementations if the toolchain is unavailable
(``available()`` reports which path is active).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libkmerspans_native.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "kmerspans_native.cpp")
_lib = None
_tried = False


def _stale() -> bool:
    return (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_SRC_PATH) > os.path.getmtime(_LIB_PATH))


def _make(force: bool):
    subprocess.run(
        ["make", "-C", _NATIVE_DIR, "-s"] + (["-B"] if force else []),
        check=True,
        capture_output=True,
        timeout=300,
    )


def build() -> bool:
    """Rebuild the library from source on this machine, then load it.
    Returns whether the native path is active."""
    global _lib, _tried
    _lib, _tried = None, False
    try:
        _make(True)
    except (OSError, subprocess.SubprocessError):
        return False
    return available()


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        if _stale():
            _make(False)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.ks_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.ks_count.restype = ctypes.c_int64
        lib.ks_count.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
        lib.ks_spans.restype = ctypes.c_int64
        lib.ks_spans.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_double,
            ctypes.c_int64, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p]
        lib.ks_pack_fasta_body.restype = ctypes.c_int64
        lib.ks_pack_fasta_body.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.ks_replay_packed.restype = ctypes.c_int64
        lib.ks_replay_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_double,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib.ks_replay_scores.restype = ctypes.c_int64
        lib.ks_replay_scores.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        lib.ks_count_mt.restype = ctypes.c_int64
        lib.ks_count_mt.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32]
        lib.ks_mass_of_codes.restype = ctypes.c_int64
        lib.ks_mass_of_codes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64]
        lib.ks_count_sparse.restype = ctypes.c_int64
        lib.ks_count_sparse.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32]
        lib.ks_count_radix.restype = ctypes.c_int64
        lib.ks_count_radix.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32]
        lib.ks_rank_chain.restype = ctypes.c_int64
        lib.ks_rank_chain.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_void_p]
        lib.ks_chain_from_hist.restype = ctypes.c_int64
        lib.ks_chain_from_hist.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
        lib.ks_pack2.restype = ctypes.c_int64
        lib.ks_pack2.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def pack_nbases(raw: np.ndarray) -> np.ndarray | None:
    """bytes -> nbases (2-bit values, N == 4); None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty(raw.shape[0], dtype=np.uint8)
    lib.ks_pack(raw.ctypes.data, raw.shape[0], out.ctypes.data)
    return out


def pack2(nbases: np.ndarray, cap: int = 2048):
    """nbases (u8, N == 4) -> (words uint32 [ceil(n/16)], starts i32,
    lens i32, n_runs) for the streaming packed-H2D path; numpy fallback
    when the native library is unavailable.  n_runs may exceed cap (only
    the first cap intervals are valid) — callers fall back to the u8
    program then.
    """
    nbases = np.ascontiguousarray(nbases, dtype=np.uint8)
    n = nbases.shape[0]
    nw = (n + 15) // 16
    starts = np.zeros(cap, np.int32)
    lens = np.zeros(cap, np.int32)
    lib = _load()
    if lib is not None:
        words = np.empty(nw, np.uint32)
        runs = lib.ks_pack2(
            nbases.ctypes.data, n, words.ctypes.data,
            starts.ctypes.data, lens.ctypes.data, cap)
        return words, starts, lens, int(runs)
    pad = np.zeros(nw * 16, np.uint8)
    pad[:n] = nbases & 3
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    words = np.bitwise_or.reduce(
        (pad.reshape(nw, 16).astype(np.uint32)) << shifts, axis=1)
    isn = np.concatenate([[False], nbases == 4, [False]])
    d = np.diff(isn.astype(np.int8))
    st = np.nonzero(d == 1)[0]
    en = np.nonzero(d == -1)[0]
    runs = st.shape[0]
    m = min(runs, cap)
    starts[:m] = st[:m]
    lens[:m] = (en - st)[:m]
    return words, starts, lens, int(runs)


def count_spectrum(nbases: np.ndarray, k: int) -> tuple[np.ndarray, int] | None:
    """Native sequential spectrum count; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    nbases = np.ascontiguousarray(nbases, dtype=np.uint8)
    counts = np.zeros(1 << (2 * k), dtype=np.int32)
    n = lib.ks_count(nbases.ctypes.data, nbases.shape[0], k, counts.ctypes.data)
    return counts.astype(np.int64), int(n)


def host_spectrum(
    nbases: np.ndarray, k: int, threads: int = 0,
) -> tuple[np.ndarray, int]:
    """Host spectrum from nbases (N == 4): native C when available,
    vectorized numpy otherwise.  The k >= 10 span pipelines replay
    candidates from this recount instead of pulling 4^k device words
    (spans/pipeline.py packed_counts=False).

    threads=0 picks min(os.cpu_count(), 4); >1 uses the code-space-
    partitioned multithreaded native counter (shared table, disjoint
    writes).  Returns (counts, n_words); counts int32 for k >= 14 (the
    4^k table is 4 GB at k=15 — int64 would double it), int64 below.
    """
    lib = _load()
    if lib is not None:
        if threads == 0:
            threads = min(os.cpu_count() or 1, 4)
        nbases = np.ascontiguousarray(nbases, dtype=np.uint8)
        counts = np.zeros(1 << (2 * k), dtype=np.int32)
        if 10 <= k <= 14 and nbases.shape[0] >= (1 << (2 * k - 3)):
            # cache-staged radix counter: per-bucket write-combining into
            # L2-resident shared-table slices (atomic adds) — measured
            # 2.7x/2.1x/1.6x over ks_count_mt at k=12/13/14, 100 Mb.
            # NOT for k=15: with n << 4^k each count touches a unique
            # line, there is no locality to exploit, and the staging
            # indirection only adds misses (111 s vs mt's 24 s).  Only
            # when the genome is big enough for slices to get multiple
            # hits (n >= 4^k/8)
            n = lib.ks_count_radix(nbases.ctypes.data, nbases.shape[0],
                                   k, counts.ctypes.data, threads)
        else:
            n = lib.ks_count_mt(nbases.ctypes.data, nbases.shape[0], k,
                                counts.ctypes.data, threads)
        if k < 13:
            counts = counts.astype(np.int64)
        # k >= 13 stays int32: the table is 0.25-4 GB, and every native
        # consumer (rank_chain, mass_of_codes, replay) takes int32 —
        # the int64 round trip alone cost 1.6 s at 4^13
        return counts, int(n)
    from ..encoding import PackedSeq, kmer_codes_np

    nbases = np.asarray(nbases, dtype=np.uint8)
    p = PackedSeq(bases=nbases & 3, valid=nbases < 4)
    codes, kv = kmer_codes_np(p, k)
    counts = np.bincount(
        codes[kv], minlength=1 << (2 * k)).astype(np.int64)
    return counts, int(kv.sum())


def host_spectrum_sparse(
    nbases: np.ndarray, k: int, threads: int = 0,
) -> tuple[np.ndarray, np.ndarray, int]:
    """SPARSE host spectrum for wide k (16..31): distinct int64 codes +
    counts, ascending.  Native C when available (threads partition the
    code space and sort independently — the np.unique recount was the
    wide finisher's wall at genome scale), numpy otherwise.
    Returns (ucodes, ucounts, n_words)."""
    lib = _load()
    nbases = np.ascontiguousarray(nbases, dtype=np.uint8)
    if lib is not None:
        if threads == 0:
            threads = min(os.cpu_count() or 1, 8)
        n = nbases.shape[0]
        cap = max(n, 1)
        ucodes = np.empty(cap, dtype=np.int64)
        ucounts = np.empty(cap, dtype=np.int64)
        nw = np.zeros(1, dtype=np.int64)
        nd = lib.ks_count_sparse(
            nbases.ctypes.data, n, k, ucodes.ctypes.data,
            ucounts.ctypes.data, cap, nw.ctypes.data, threads)
        assert nd <= cap  # distinct <= words <= n by construction
        return ucodes[:nd].copy(), ucounts[:nd].copy(), int(nw[0])
    from ..encoding import PackedSeq
    from ..oracle.reference import count_spectrum_sparse

    p = PackedSeq(bases=nbases & 3, valid=nbases < 4)
    return count_spectrum_sparse(p, k)


def chain_from_hist(v_vals, n_codes, total, pm) -> np.ndarray | None:
    """Exact f64 chain ranks for mass values pm given the sparse value
    histogram — the C form of stats.ranks.chain_ranks_from_mass (one
    streaming fold; the chunked numpy fold was 4-6 s at 100M terms).
    None if native is unavailable; raises on an invalid pm."""
    lib = _load()
    if lib is None:
        return None
    v_vals = np.ascontiguousarray(v_vals, dtype=np.int64)
    n_codes = np.ascontiguousarray(n_codes, dtype=np.int64)
    pm = np.ascontiguousarray(pm, dtype=np.int64)
    out = np.empty(pm.shape[0], dtype=np.float64)
    rc = lib.ks_chain_from_hist(
        v_vals.ctypes.data, n_codes.ctypes.data, v_vals.shape[0],
        float(total), pm.ctypes.data, pm.shape[0], out.ctypes.data)
    if rc != 0:
        raise ValueError("pm is not a cumulative_mass value")
    return out


def rank_chain(counts: np.ndarray, total: int) -> np.ndarray | None:
    """The reference's exact f64 rank chain over a dense spectrum via the
    sort-free native kernel (value histogram + per-value cursors; the
    numpy argsort was 2.1 s/rep at k=12, this is ~0.15 s).  Counts must
    fit int32.  None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    ranks = np.empty(counts.shape[0], dtype=np.float64)
    lib.ks_rank_chain(counts.ctypes.data, counts.shape[0], float(total),
                      ranks.ctypes.data)
    return ranks


def replay_scores(
    s: np.ndarray, scored: np.ndarray, min_width: int, min_score: float,
    base_pos: int,
):
    """Reference-exact replay from precomputed per-position f64 scores
    (the k >= 13 candidate-only rank path); None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    s = np.ascontiguousarray(s, dtype=np.float64)
    scored = np.ascontiguousarray(scored, dtype=np.uint8)
    cap = 256
    while True:
        beg = np.empty(cap, dtype=np.int64)
        end = np.empty(cap, dtype=np.int64)
        score = np.empty(cap, dtype=np.float64)
        nreg = lib.ks_replay_scores(
            s.ctypes.data, scored.ctypes.data, s.shape[0],
            min_width, min_score, base_pos,
            beg.ctypes.data, end.ctypes.data, score.ctypes.data, cap)
        if nreg <= cap:
            return beg[:nreg], end[:nreg], score[:nreg]
        cap = int(nreg) + 16


def mass_of_codes(counts: np.ndarray, qcodes: np.ndarray):
    """Exact integer mass + sparse value histogram for sorted unique
    query codes (the k >= 14 replay path — no 4^k f64 rank table).

    Returns (pm int64 [nq], v_vals int64 asc, v_ncodes int64) or None if
    native is unavailable.  counts must be int32-compatible.
    """
    lib = _load()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    q = np.ascontiguousarray(qcodes, dtype=np.int64)
    pm = np.empty(q.shape[0], dtype=np.int64)
    cap = 1 << 16
    while True:
        vv = np.empty(cap, dtype=np.int64)
        vn = np.empty(cap, dtype=np.int64)
        nvals = lib.ks_mass_of_codes(
            counts.ctypes.data, counts.shape[0], q.ctypes.data,
            q.shape[0], pm.ctypes.data, vv.ctypes.data, vn.ctypes.data,
            cap)
        if nvals <= cap:
            return pm, vv[:nvals], vn[:nvals]
        cap = int(nvals) + 16


def replay_packed(
    cand_words: np.ndarray,
    scored: np.ndarray,
    block: int,
    k: int,
    ranks: np.ndarray,
    threshold: float,
    min_width: int,
    min_score: float,
    base_pos: int,
):
    """Reference-exact candidate-stretch replay from the device's packed
    2-bit-bases payload (spans/pipeline.py packed_bases format); None if
    the native library is unavailable.

    cand_words: [rows, 1 + block/16] uint32 (seed code + base words) for
    CONSECUTIVE candidate blocks; scored: [rows, block] bool; base_pos:
    global 0-based position of the stretch's first element.
    Returns (beg, end, score) arrays in global 1-based last-base coords.
    """
    lib = _load()
    if lib is None:
        return None
    cand_words = np.ascontiguousarray(cand_words, dtype=np.uint32)
    scored = np.ascontiguousarray(scored, dtype=np.uint8)
    rows = cand_words.shape[0]
    ranks = np.ascontiguousarray(ranks, dtype=np.float64)
    cap = 256
    while True:
        beg = np.empty(cap, dtype=np.int64)
        end = np.empty(cap, dtype=np.int64)
        score = np.empty(cap, dtype=np.float64)
        nreg = lib.ks_replay_packed(
            cand_words.ctypes.data, scored.ctypes.data,
            rows, block, k, ranks.ctypes.data, threshold,
            min_width, min_score, base_pos,
            beg.ctypes.data, end.ctypes.data, score.ctypes.data, cap,
        )
        if nreg <= cap:
            return beg[:nreg], end[:nreg], score[:nreg]
        cap = int(nreg) + 16


def find_spans(
    nbases: np.ndarray,
    k: int,
    weights: np.ndarray,
    threshold: float,
    min_width: int,
    min_score: float,
    want_scan_counts: bool = False,
):
    """Native sequential span caller (reference-exact); None if unavailable.

    Returns (beg, end, score arrays, scan_counts or None).
    """
    lib = _load()
    if lib is None:
        return None
    nbases = np.ascontiguousarray(nbases, dtype=np.uint8)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    sc = np.zeros(1 << (2 * k), dtype=np.int64) if want_scan_counts else None
    cap = 1024
    while True:
        beg = np.empty(cap, dtype=np.int64)
        end = np.empty(cap, dtype=np.int64)
        score = np.empty(cap, dtype=np.float64)
        if sc is not None:
            sc[:] = 0
        nreg = lib.ks_spans(
            nbases.ctypes.data, nbases.shape[0], k,
            weights.ctypes.data, threshold, min_width, min_score,
            beg.ctypes.data, end.ctypes.data, score.ctypes.data,
            cap, sc.ctypes.data if sc is not None else None,
        )
        if nreg <= cap:
            return beg[:nreg], end[:nreg], score[:nreg], sc
        cap = int(nreg) + 16
