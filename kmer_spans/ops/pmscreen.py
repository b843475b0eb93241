"""Exact-mass sort screen: the device emits each position's cumulative
rank mass — no 4^k spectrum anywhere, device OR host.

The sort screen (ops/sortscreen.py) sorts the chunk by code, but its
finisher still replays candidates from a HOST recount of the full
spectrum (4^15 entries at k=15).  This module removes the host spectrum
entirely:

  A position's exact cumulative mass pm (the integer numerator of
  rank_kmers_w, src/kmer_spans.c:189-202: total mass of k-mers sorted
  strictly before its k-mer under (count asc, code asc)) equals the
  START INDEX of its run when the chunk's positions are ordered by
  (count, code) — each genome position is one k-mer instance, so the
  positions in earlier runs ARE the mass.

Two strategies produce that order from the existing code-sort:

* "packed" (10 <= k <= 14, 2k + 2 <= 32): after the code sort gives
  each position its run length v (its k-mer's exact chunk count), ONE
  more single-key sort by the packed uint32 key

      (min(v, 2^b - 1) << 2k) | code,   b = 32 - 2k

  realizes (count asc, code asc) exactly for every run with
  v < 2^b - 1; pm is then a cummax-broadcast run-start index.  Runs at
  the clip (v >= 2^b - 1) sort after all unclipped runs but mutually by
  code only, so their positions get the sentinel pm = -1 and their
  exact (code, v) pairs ship in a small explicit LIST (the host
  computes their pm from the list alone — see below).

* "smallv" (whenever counts are sparse enough — chosen at trace time
  from lam = n/4^k by choose_params: always at k = 15 and wide k, and
  at k = 13/14 at chunk scale with T raised so the expected list fits):
  no second sort at all.  For v in {1..T-1}, the within-value order IS
  code order, so eqbelow(c) = (# earlier runs with the same v) comes
  from ONE running cumsum per value, and
  pm = below(v) + v * eqbelow(c) with below(v) a scalar.  Runs with
  v >= T ship in the explicit list; their positions get pm = -1.

LIST EXTRACTION (fixed shape, sound): one record per run with v >= T,
compacted into a fixed-capacity buffer either by decimating the sorted
order (stride <= T samples every qualifying run; packed strategy) or by
one single-operand sort of flagged head indices + point gathers
(smallv, where a small stride's strided slices would touch the whole
array).  The true qualifying-run count travels
too — capacity overflow is flagged, never silent (the caller falls
back).

The HOST needs only: per-position pm for candidate blocks (one i32 per
position in the existing top-C pull), the 256-bin run-value histogram,
and the list.  From these it rebuilds the exact sparse value histogram
(the multiset of spectrum count values — all a bit-identical f64 rank
chain needs, stats/ranks.chain_ranks_from_mass) and the exact pm of
every listed code (sort the list by (v, code); exclusive-cumsum v on
top of the unlisted mass).  Cross-checks: sum(v * n_v) must equal the
counted total, and every pm = -1 candidate code must resolve in the
list — both raise loudly on mismatch.

The SCREEN becomes exact as a bonus: s_int derives from pm itself
(pm_scores_int) instead of a quantized class table, so candidate
screening is as tight as integer scaling allows.

Reference parity: the scoring gather feeding kmer_regions
(src/kmer_spans.c:268) with rank_kmers_w ranks (:189-202); emitted
spans replay the exact f64 chain from pm + value histogram,
bit-identical to the sequential oracle (tests/test_pm_pipeline.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .count import histogram
from .gather import SCREEN_SCALE
from .sortscreen import _run_lengths

#: smallv strategy: values 1..SMALLV_T-1 get exact device pm via
#: per-value cumsums; runs with v >= SMALLV_T go to the list
SMALLV_T = 4
#: default list capacities (overflow -> flagged fallback)
PM_CAP_PACKED = 8192
PM_CAP_SMALLV = 1 << 17


def pm_strategy(k: int) -> str:
    """Default strategy for narrow codes ignoring n (see choose_params)."""
    if not 10 <= k <= 15:
        raise ValueError("pm screen needs 10 <= k <= 15 (narrow codes)")
    return "packed" if k <= 14 else "smallv"


def _pois_tail(lam: float, t: int) -> float:
    """P(Poisson(lam) >= t), summed directly (t <= ~16 here)."""
    import math

    if lam <= 0:
        return 0.0
    if lam > 60:  # tail ~ 1 for any t <= 16
        return 1.0
    p = math.exp(-lam)
    cdf = p
    for i in range(1, t):
        p *= lam / i
        cdf += p
    return max(0.0, 1.0 - cdf)


def pm_cap(k: int) -> int:
    """Static list capacity per k (unpack layout must not depend on n)."""
    return PM_CAP_PACKED if k <= 12 else PM_CAP_SMALLV


def choose_params(k: int, n: int, wide: bool = False):
    """(strategy, t_list) chosen at trace time from the STATIC length n.

    The smallv strategy (per-value cumsums, no second sort) is usable
    whenever the
    expected number of runs with v >= T fits the list comfortably.
    With lam = n/4^k i.i.d.-ish, E[#codes v >= T] = 4^k * P(Pois >= T);
    the smallest T in [SMALLV_T, 13] with E <= cap/8 wins (T-1
    cumsums).  Repeat-heavy
    real inputs can still overflow the list at runtime — that's the
    flagged-fallback path, never silent.  No usable T -> packed key
    (k <= 14; k = 15 always finds one at n < 2^31).
    """
    size = float(4 ** k)
    lam = n / size
    cap = PM_CAP_SMALLV if (wide or k >= 13) else pm_cap(k)
    if wide or k >= 13:
        for t in range(SMALLV_T, 14):
            if size * _pois_tail(lam, t) <= cap / 8:
                return "smallv", t
    if wide or k > 14:
        # no safe T: k=15/wide fall back to the largest T with the
        # overflow flag as the guard (extreme n for the one-shot path)
        return "smallv", 13
    b = 32 - 2 * k
    return "packed", min(1 << b, 4096) - 1


def pm_params(k: int, strategy: str | None = None, n: int | None = None,
              wide: bool = False):
    """(strategy, t_list, stride, nbins, cap) for a pm screen build.

    t_list: runs with v >= t_list ship in the explicit list (for the
    packed strategy this is also the key clip, capped at 4095 so the
    value histogram stays small); stride: the decimation step of the
    packed extractor (<= t_list, power of two; smallv uses the index
    sort); nbins: value-histogram bins (>= 256, covering [0, t_list]);
    cap: static per-k list capacity.
    """
    if strategy is None:
        if n is not None:
            strategy, t_list = choose_params(k, n, wide)
        else:
            strategy = "smallv" if wide else pm_strategy(k)
            t_list = None
    else:
        t_list = None
    if t_list is None:
        if strategy == "packed":
            t_list = min(1 << (32 - 2 * k), 4096) - 1
        else:
            t_list = SMALLV_T
    cap = PM_CAP_SMALLV if (wide or k >= 13) else pm_cap(k)
    stride = (4 if strategy == "smallv"
              else max(1, 1 << (max(t_list, 1).bit_length() - 1)))
    nbins = max(min((1 << (32 - 2 * k)) if not wide and k <= 12 else 256,
                    4096), 256)
    return strategy, t_list, stride, nbins, cap


def _extract_list(keys, v, head, real, t_list, stride, cap):
    """Fixed-capacity (code..., v) records of every run with v >= t_list.

    keys: tuple of code component arrays in SORTED (code) order (1 for
    narrow, 2 for wide); v: run lengths; head/real: run-head flags /
    not-sentinel.  Returns (list_keys tuple, list_v, count) — entries
    beyond the captured runs are -1/-1.

    Two mechanisms (identical contract):
      * stride >= 8 (packed strategy, k <= 14): decimate the sorted
        order by stride <= t_list — every qualifying run (length >= v
        >= t_list) is sampled, adjacent-equal dedupes to one record —
        then a tiny flag-first sort over n/stride compacts.
      * stride < 8 (smallv): ONE single-operand sort of flagged head
        INDICES + cap point gathers (a stride-4 decimation would read
        the whole array through strided slices).
    """
    i32 = jnp.int32
    n = v.shape[0]
    flag_full = head & real & (v >= t_list)
    count = jnp.sum(flag_full.astype(i32))
    if stride < 8:
        # group-min compaction: flagged heads are heads of runs with
        # v >= t_list, so consecutive flagged heads sit >= t_list >= G
        # apart and each adjacent-G group holds AT MOST ONE — the min
        # over groups captures every record, and the compaction sort
        # runs over n/G elements instead of n
        G = 8 if t_list >= 8 else 4
        while n % G:  # callers use block-multiple n; guard odd sizes
            G //= 2
        idx = jax.lax.iota(i32, n)
        masked = jnp.where(flag_full, idx, jnp.int32(0x7FFFFFFF))
        m = (jnp.min(masked.reshape(n // G, G), axis=1)
             if G > 1 else masked)
        sidx = jax.lax.sort(m)
        sel = sidx[:cap]
        if n // G < cap:  # fixed output shape for short inputs
            sel = jnp.concatenate([
                sel, jnp.full((cap - n // G,), 0x7FFFFFFF, i32)])
        got = sel < jnp.int32(n)
        selc = jnp.minimum(sel, n - 1)
        list_keys = tuple(
            jnp.where(got, a[selc], -1) for a in keys)
        list_v = jnp.where(got, v[selc], -1)
        return list_keys, list_v, count
    decs = [a[::stride] for a in keys]
    vdec = v[::stride]
    rdec = real[::stride]
    m = vdec.shape[0]
    change = jnp.zeros((m,), bool).at[0].set(True)
    for d in decs:
        change = change | jnp.concatenate(
            [jnp.ones((1,), bool), d[1:] != d[:-1]])
    flag = change & rdec & (vdec >= t_list)
    fkey = jnp.where(flag, 0, 1).astype(i32)
    sorted_ops = jax.lax.sort(
        (fkey, *decs, vdec), num_keys=1 + len(decs))
    # fixed output shape whatever n: slice to cap, pad short inputs
    pad = max(0, cap - m)

    def fit(a, fill):
        a = a[:cap]
        if pad:
            a = jnp.concatenate(
                [a, jnp.full((pad,), fill, a.dtype)])
        return a

    fk = fit(sorted_ops[0], 1)
    got = fk == 0
    list_keys = tuple(
        jnp.where(got, fit(d, 0), -1) for d in sorted_ops[1:-1])
    list_v = jnp.where(got, fit(sorted_ops[-1], 0), -1)
    return list_keys, list_v, count


def _pm_packed(skey, spos, v, real, k, n):
    """Packed-key second sort -> exact pm for unclipped runs (-1 at clip).

    Returns pm in the SORTED-BY-(v, code) order paired with its spos."""
    i32 = jnp.int32
    b = 32 - 2 * k
    vclip = (1 << b) - 1
    vcl = jnp.minimum(v, vclip).astype(jnp.uint32)
    pkey = (vcl << (2 * k)) | skey.astype(jnp.uint32)
    pkey = jnp.where(real, pkey, jnp.uint32(0xFFFFFFFF))
    pk2, spos2 = jax.lax.sort((pkey, spos), num_keys=1)
    head2 = jnp.concatenate([jnp.ones((1,), bool), pk2[1:] != pk2[:-1]])
    idx = jax.lax.iota(i32, n)
    start2 = jax.lax.cummax(jnp.where(head2, idx, 0))
    clipped = (pk2 >> (2 * k)) == jnp.uint32(vclip)
    pm = jnp.where(clipped, jnp.int32(-1), start2)
    return pm, spos2


def _pm_smallv(v, head, real, t_list):
    """Exact pm for v < t_list via per-value cumsums (in code order).

    pm = below(v) + v * eqbelow(c); eqbelow = # earlier same-count runs,
    which in code-sorted order is a plain running count per value;
    below(v) = sum of all smaller-count mass is a scalar.  v >= t_list
    (and sentinel) positions get -1.  Returns pm in CODE-sorted order.
    """
    i32 = jnp.int32
    h = head & real
    pm = jnp.full(v.shape, -1, i32)
    below = jnp.int32(0)
    for t in range(1, t_list):
        ct = jnp.cumsum((h & (v == t)).astype(i32))
        pm = jnp.where(real & (v == t), below + t * (ct - 1), pm)
        below = below + t * ct[-1]
    return pm


def pm_sort_screen(codes, kmer_valid, k: int, list_cap: int | None = None,
                   strategy: str | None = None):
    """Exact-mass screen for narrow codes (10 <= k <= 15).

    codes: int32 [n] raw rolling codes (junk where invalid);
    kmer_valid: bool [n].  Returns a dict of DEVICE arrays:
      pm [n] i32 genome order — exact cumulative mass, -1 where the
          host must resolve via the list (junk where invalid);
      total i32 — counted k-mers;
      vh [VHIST] i32 — run counts per count value (bucket min(v, 255));
      list_codes/list_v [cap] i32 — explicit runs (v >= t_list), -1 pad;
      list_count i32 — TRUE qualifying-run count (overflow check);
      t_list — python int, the list threshold.
    """
    n = codes.shape[0]
    strategy, t_list, stride, nbins, cap = pm_params(
        k, strategy, n=int(n))
    cap = list_cap or cap
    size = 1 << (2 * k)
    i32 = jnp.int32
    key = jnp.where(kmer_valid, codes, size)
    pos = jax.lax.iota(i32, n)
    skey, spos = jax.lax.sort((key, pos), num_keys=1)
    head = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    v = _run_lengths(head, n)
    real = skey < size
    total = jnp.sum(kmer_valid.astype(i32))

    vh = histogram(jnp.minimum(v, nbins - 1), head & real, nbins)

    if strategy == "packed":
        pm_s, spos_s = _pm_packed(skey, spos, v, real, k, n)
    else:
        pm_s, spos_s = _pm_smallv(v, head, real, t_list), spos
    (lc,), lv, count = _extract_list(
        (skey,), v, head, real, t_list, stride, cap)
    _, pm = jax.lax.sort((spos_s, pm_s), num_keys=1)
    return {
        "pm": pm, "total": total, "vh": vh,
        "list_codes": lc, "list_v": lv, "list_count": count,
        "t_list": t_list,
    }


def pm_sort_screen_wide(hi, lo, kmer_valid, k: int,
                        list_cap: int | None = None):
    """Exact-mass screen for WIDE codes (16 <= k <= 23): smallv only.

    Counts at wide k are sparse by construction (4^k >> n), so the
    smallv strategy always applies.  Same contract as pm_sort_screen
    with (list_hi, list_lo) int32 pairs instead of list_codes.
    """
    n = hi.shape[0]
    strategy, t_list, stride, nbins, cap = pm_params(
        k, None, n=int(n), wide=True)
    cap = list_cap or cap
    i32 = jnp.int32
    sent = jnp.int32(1 << 30)  # > any valid hi (k <= 23 -> hi < 2^30)
    key1 = jnp.where(kmer_valid, hi, sent)
    key2 = jnp.where(kmer_valid, lo, 0)
    pos = jax.lax.iota(i32, n)
    k1, k2, spos = jax.lax.sort((key1, key2, pos), num_keys=2)
    head = jnp.concatenate(
        [jnp.ones((1,), bool), (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])])
    v = _run_lengths(head, n)
    real = k1 < sent
    total = jnp.sum(kmer_valid.astype(i32))

    vh = histogram(jnp.minimum(v, nbins - 1), head & real, nbins)
    (lh, ll), lv, count = _extract_list(
        (k1, k2), v, head, real, t_list, stride, cap)
    pm_s = _pm_smallv(v, head, real, t_list)
    _, pm = jax.lax.sort((spos, pm_s), num_keys=1)
    return {
        "pm": pm, "total": total, "vh": vh,
        "list_hi": lh, "list_lo": ll, "list_v": lv, "list_count": count,
        "t_list": t_list,
    }


def pm_scores_int(pm, total, thr_q):
    """Sound integer screen scores from exact pm (units of 2^-12 rank).

    s_int = trunc(f32(pm) * f32(SCREEN_SCALE/total)) + 3 - thr_q
    >= SCREEN_SCALE * (rank - thr) always: the f64 rank chain exceeds
    pm/total by at most ~2^-22 (#terms <= 2^31 rounding steps), the
    three f32 roundings (pm cast, reciprocal-scale, product) total
    < 3 * 2^-24 relative of a value <= SCREEN_SCALE, and thr_q already
    gave back 1 (ops/gather.screen_thr_q) — together well under the +3.
    Sentinel pm < 0 (listed/clipped runs, i.e. HIGH counts) screens as
    the class top, rank_ub = 1 — sound for any true rank.
    """
    total_f = jnp.maximum(total.astype(jnp.float32), 1.0)
    q = (pm.astype(jnp.float32) * (SCREEN_SCALE / total_f)).astype(
        jnp.int32)
    s = q + 3 - thr_q
    return jnp.where(pm < 0, jnp.int32(SCREEN_SCALE + 3) - thr_q, s)
