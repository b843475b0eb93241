"""Device-complete span pipeline for k >= 10: NO host spectrum, ever.

The round-4 k >= 13 pipelines screened on device but replayed candidates
from a host recount of the full spectrum — 71 s / 100 Mb at k=15 on a
2-core host against a 1.25 s device step, collapsing the end-to-end rate
to 0.07x baseline (VERDICT round 4, weak #1).  Here the device emits
everything the exact replay needs (ops/pmscreen.py):

  * per-position EXACT cumulative mass pm for the top-C candidate
    blocks (one extra i32 per candidate position in the packed pull);
  * the 256-bin run-value histogram + an explicit (code, v) list of
    high-count runs -> the host rebuilds the exact sparse value
    histogram (the count-value multiset that fully determines the
    reference's sequential f64 rank chain, stats/ranks.py);
  * exact pm for listed codes is host-arithmetic over the list alone.

Host work per chunk drops from O(4^k) counting to O(#candidates +
#distinct-count-values + one streamed f64 fold) — the chain fold
(native ks_chain_from_hist) is the only genome-proportional host cost
and it overlaps the next device step in pipelined mode.

Soundness/exactness invariants kept: integer screen upper bounds
(pm_scores_int), exact int64 cross-block candidacy, sequential-f64
emitted scores, loud flags on any capacity overflow or cross-check
mismatch (never silent).

Reference parity: kmer_low_comp_regions (src/kmer_spans.c:548-621)
with rank_kmers_w ranks (:189-202); output bit-identical to the
sequential oracle (tests/test_pm_pipeline.py).
"""

from __future__ import annotations

import numpy as np

from ..ops.gather import SCREEN_SCALE
from .pipeline import (
    SpanPipelineResult,
    _replay_stretch,
    _seg_max_combine,
    compose_summaries_exact,
    rebuild_codes,
    rebuild_codes_wide,
)


def _device_top_idx(jnp, jax, tA, tB, maxA, maxB, cand_blocks):
    """Run-aware top-C candidate block selection (device, f32 ordering)."""
    from ..ops.blocked import compose_summaries_f32

    nb = tA.shape[0]
    block_max, block_last = compose_summaries_f32(tA, tB, maxA, maxB)
    linked = jnp.concatenate([jnp.zeros((1,), bool), block_last[:-1] > 0])
    reset = (~linked).astype(jnp.float32)
    fwd, _ = jax.lax.associative_scan(_seg_max_combine, (block_max, reset))
    linked_next = jnp.concatenate([linked[1:], jnp.zeros((1,), bool)])
    reset_b = (~linked_next).astype(jnp.float32)
    bwd, _ = jax.lax.associative_scan(
        _seg_max_combine, (jnp.flip(block_max), jnp.flip(reset_b)))
    run_max = jnp.maximum(fwd, jnp.flip(bwd))
    _, top_idx = jax.lax.top_k(run_max, min(cand_blocks, nb))
    return jnp.sort(top_idx)


def make_pm_span_pipeline(
    k: int,
    block: int = 8192,
    cand_blocks: int = 256,
    list_cap: int | None = None,
    strategy: str | None = None,
):
    """Jitted device step for narrow codes (10 <= k <= 15).

    fn(nbases u8 [n], thr f32) -> ONE packed int32 vector; decode with
    unpack_pm_outputs, finish with finish_pm_spans.  n must be a
    multiple of ``block``; block must be 16-aligned (candidates travel
    as 2-bit bases + one seed code per block, as the round-3 pipeline).
    """
    import jax
    import jax.numpy as jnp

    from ..ops.blocked import (
        blocked_codes,
        blocked_scan_summaries_int,
        blocked_scored,
    )
    from ..ops.gather import screen_thr_q
    from ..ops.pmscreen import pm_params, pm_scores_int, \
        pm_sort_screen

    if block % 16:
        raise ValueError("block must be a multiple of 16")
    # strategy and t_list are chosen INSIDE the screen at trace time
    # from the static n (choose_params); they ride in the packed vector.
    # nbins/cap are static per k so the unpack layout is n-independent.
    _, _, _, nbins, cap = pm_params(k, "packed" if k <= 14 else "smallv")
    cap = list_cap or cap
    strat = strategy

    @jax.jit
    def fn(nbases, thr):
        n = nbases.shape[0]
        nb = n // block
        W = 8192 if n % 8192 == 0 and block < 8192 else block
        b2 = (nbases & 3).reshape(n // W, W)
        v2 = (nbases < 4).reshape(n // W, W)
        codes, kmer_valid = blocked_codes(b2, v2, k)
        scored = blocked_scored(v2, kmer_valid).reshape(nb, block)
        thr_q = screen_thr_q(thr)
        scr = pm_sort_screen(
            codes.reshape(-1), kmer_valid.reshape(-1), k,
            list_cap=cap, strategy=strat)
        s_int = pm_scores_int(
            scr["pm"], scr["total"], thr_q).reshape(nb, block)
        tA, tB, maxA, maxB = blocked_scan_summaries_int(s_int, scored)
        top_idx = _device_top_idx(jnp, jax, tA, tB, maxA, maxB,
                                  cand_blocks)
        C = top_idx.shape[0]
        sc_cand = scored[top_idx]
        bits32 = jnp.arange(32, dtype=jnp.uint32)
        sc_words = jnp.sum(
            sc_cand.reshape(C, block // 32, 32).astype(jnp.uint32)
            << bits32[None, None, :], axis=-1, dtype=jnp.uint32)
        cand = codes.reshape(nb, block)[top_idx]
        first_codes = cand[:, 0].astype(jnp.uint32)
        b16 = (cand & 3).astype(jnp.uint32).reshape(C, block // 16, 16)
        shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
        cand_words = jnp.concatenate([
            first_codes[:, None],
            jnp.sum(b16 << shifts, axis=-1, dtype=jnp.uint32),
        ], axis=1)
        pm_rows = scr["pm"].reshape(nb, block)[top_idx]
        bc = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
        return jnp.concatenate([
            scr["total"].reshape(1).astype(jnp.int32),
            tA.astype(jnp.int32),
            tB.astype(jnp.int32),
            maxA.astype(jnp.int32),
            maxB.astype(jnp.int32),
            top_idx.astype(jnp.int32),
            bc(sc_words.astype(jnp.uint32)).reshape(-1),
            bc(cand_words.astype(jnp.uint32)).reshape(-1),
            pm_rows.astype(jnp.int32).reshape(-1),
            scr["vh"].astype(jnp.int32),
            scr["list_codes"].astype(jnp.int32),
            scr["list_v"].astype(jnp.int32),
            scr["list_count"].reshape(1).astype(jnp.int32),
            jnp.full((1,), scr["t_list"], jnp.int32),
        ])

    # metadata the unpacker/finisher need (fixed per build)
    meta = {"k": k, "block": block, "cand_blocks": cand_blocks,
            "list_cap": cap, "wide": False, "nbins": nbins}
    return fn, meta


def make_wide_pm_pipeline(
    k: int,
    block: int = 8192,
    cand_blocks: int = 256,
    list_cap: int | None = None,
):
    """Device-complete wide-code pipeline (16 <= k <= 23): replaces the
    wide pipeline's host SPARSE recount with the same pm emission —
    smallv strategy
    always applies at wide k (4^k >> n makes counts sparse)."""
    import jax
    import jax.numpy as jnp

    from ..ops.blocked import (
        WIDE_MAX_K,
        blocked_codes_wide,
        blocked_scan_summaries_int,
        blocked_scored,
    )
    from ..ops.gather import screen_thr_q
    from ..ops.pmscreen import pm_params, pm_scores_int, \
        pm_sort_screen_wide

    if not 16 <= k <= WIDE_MAX_K:
        raise ValueError(f"wide pipeline needs 16 <= k <= {WIDE_MAX_K}")
    if block % 16:
        raise ValueError("block must be a multiple of 16")
    _, _, _, nbins, cap = pm_params(16, "smallv")
    cap = list_cap or cap

    @jax.jit
    def fn(nbases, thr):
        n = nbases.shape[0]
        nb = n // block
        W = 8192 if n % 8192 == 0 and block < 8192 else block
        b2 = (nbases & 3).reshape(n // W, W)
        v2 = (nbases < 4).reshape(n // W, W)
        hi, lo, kmer_valid = blocked_codes_wide(b2, v2, k)
        scored = blocked_scored(v2, kmer_valid).reshape(nb, block)
        thr_q = screen_thr_q(thr)
        scr = pm_sort_screen_wide(
            hi.reshape(-1), lo.reshape(-1), kmer_valid.reshape(-1), k,
            list_cap=cap)
        s_int = pm_scores_int(
            scr["pm"], scr["total"], thr_q).reshape(nb, block)
        tA, tB, maxA, maxB = blocked_scan_summaries_int(s_int, scored)
        top_idx = _device_top_idx(jnp, jax, tA, tB, maxA, maxB,
                                  cand_blocks)
        C = top_idx.shape[0]
        sc_cand = scored[top_idx]
        bits32 = jnp.arange(32, dtype=jnp.uint32)
        sc_words = jnp.sum(
            sc_cand.reshape(C, block // 32, 32).astype(jnp.uint32)
            << bits32[None, None, :], axis=-1, dtype=jnp.uint32)
        hi_c = hi.reshape(nb, block)[top_idx]
        lo_c = lo.reshape(nb, block)[top_idx]
        b16 = (lo_c & 3).astype(jnp.uint32).reshape(C, block // 16, 16)
        shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
        cand_words = jnp.concatenate([
            hi_c[:, 0:1].astype(jnp.uint32),
            lo_c[:, 0:1].astype(jnp.uint32),
            jnp.sum(b16 << shifts, axis=-1, dtype=jnp.uint32),
        ], axis=1)
        pm_rows = scr["pm"].reshape(nb, block)[top_idx]
        bc = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
        return jnp.concatenate([
            scr["total"].reshape(1).astype(jnp.int32),
            tA.astype(jnp.int32),
            tB.astype(jnp.int32),
            maxA.astype(jnp.int32),
            maxB.astype(jnp.int32),
            top_idx.astype(jnp.int32),
            bc(sc_words.astype(jnp.uint32)).reshape(-1),
            bc(cand_words.astype(jnp.uint32)).reshape(-1),
            pm_rows.astype(jnp.int32).reshape(-1),
            scr["vh"].astype(jnp.int32),
            scr["list_hi"].astype(jnp.int32),
            scr["list_lo"].astype(jnp.int32),
            scr["list_v"].astype(jnp.int32),
            scr["list_count"].reshape(1).astype(jnp.int32),
            jnp.full((1,), scr["t_list"], jnp.int32),
        ])

    meta = {"k": k, "block": block, "cand_blocks": cand_blocks,
            "list_cap": cap, "wide": True, "nbins": nbins}
    return fn, meta


def unpack_pm_outputs(vec, n: int, meta: dict) -> dict:
    """Decode the packed pm-pipeline vector into the finisher dict."""
    v = np.asarray(vec)
    block = meta["block"]
    cap = meta["list_cap"]
    nb = n // block
    C = min(meta["cand_blocks"], nb)
    off = 0

    def take(m):
        nonlocal off
        out = v[off:off + m]
        off += m
        return out

    total = int(take(1)[0])
    tA = take(nb)
    tB = take(nb)
    maxA = take(nb)
    maxB = take(nb)
    top_idx = take(C)
    sc_words = take(C * (block // 32)).copy().view(np.uint32)
    scored = (
        (sc_words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    ).astype(bool).reshape(C, block)
    seeds = 2 if meta["wide"] else 1
    cand_words = take(C * (seeds + block // 16)).copy().view(
        np.uint32).reshape(C, seeds + block // 16)
    pm = take(C * block).reshape(C, block)
    vh = take(meta["nbins"])
    out = {
        "total": total, "tA": tA, "tB": tB, "maxA": maxA, "maxB": maxB,
        "top_idx": top_idx, "scored": scored, "cand_words": cand_words,
        "pm": pm, "vh": vh,
    }
    if meta["wide"]:
        lh = take(cap).astype(np.int64)
        ll = take(cap).astype(np.int64)
        out["list_codes"] = np.where(lh < 0, -1, (lh << 16) | ll)
    else:
        out["list_codes"] = take(cap).astype(np.int64)
    out["list_v"] = take(cap).astype(np.int64)
    out["list_count"] = int(take(1)[0])
    out["t_list"] = int(take(1)[0])
    assert off == v.shape[0], (off, v.shape)
    return out


def _pm_host_tables(out: dict, t_list: int):
    """Exact sparse value histogram + per-listed-code pm from the pull.

    Returns (v_vals, n_codes, list_codes_sorted, list_pm_sorted) or
    raises on any cross-check failure (loud, never silent):
      * list capacity overflow is the caller's fallback (checked there);
      * sum(v * n_v) must equal the counted total.
    """
    total = out["total"]
    vh = out["vh"].astype(np.int64)
    keep = out["list_codes"] >= 0
    lc = out["list_codes"][keep]
    lv = out["list_v"][keep]
    small_v = np.arange(1, t_list, dtype=np.int64)
    small_n = vh[1:t_list]
    uv, un = np.unique(lv, return_counts=True)
    nz = small_n > 0
    v_vals = np.concatenate([small_v[nz], uv])
    n_codes = np.concatenate([small_n[nz], un])
    mass_total = int((v_vals * n_codes).sum())
    if mass_total != total:
        raise AssertionError(
            f"pm screen mass mismatch: {mass_total} != total {total} "
            "(list extraction or histogram bug)")
    # exact pm of listed codes: below the list sits every unlisted run
    below_base = int((small_v * small_n).sum())
    order = np.lexsort((lc, lv))
    pm_sorted = below_base + np.concatenate(
        [[0], np.cumsum(lv[order])[:-1]])
    pm_entry = np.empty(lc.shape[0], np.int64)
    pm_entry[order] = pm_sorted
    corder = np.argsort(lc, kind="stable")
    return v_vals, n_codes, lc[corder], pm_entry[corder]


def finish_pm_spans(
    out: dict,
    n: int,
    meta: dict,
    thr: float,
    min_width: int,
    min_score: float,
    seq_id: int = 0,
) -> SpanPipelineResult:
    """Host finisher: exact candidacy + exact f64 replay from device pm.

    No spectrum input of any kind: candidate ranks come from
    chain_ranks_from_mass over the pulled pm values and the
    device-emitted value histogram — bit-identical to the reference's
    sequential chain (src/kmer_spans.c:198-202).  fallback=True when
    the top-C gather missed a candidate run OR the run list overflowed.
    """
    from ..stats.ranks import chain_ranks_from_mass
    from ..utils import native

    block = meta["block"]
    k = meta["k"]
    if out["list_count"] > meta["list_cap"]:
        return SpanPipelineResult(regions=[], fallback=True)
    block_max, block_last = compose_summaries_exact(
        out["tA"], out["tB"], out["maxA"], out["maxB"])
    top_idx = np.asarray(out["top_idx"])
    nb = block_max.shape[0]
    linked = np.zeros(nb, bool)
    linked[1:] = block_last[:-1] > 0
    starts = np.nonzero(~linked)[0]
    run_of = np.cumsum(~linked) - 1
    run_max = np.maximum.reduceat(block_max, starts)[run_of]
    cand = run_max >= float(min_score) * SCREEN_SCALE
    if not cand.any():
        return SpanPipelineResult(regions=[], fallback=False)
    have = np.zeros(nb, bool)
    have[top_idx] = True
    if (cand & ~have).any():
        return SpanPipelineResult(regions=[], fallback=True)

    v_vals, n_codes, lcodes, lpm = _pm_host_tables(out, out["t_list"])
    total = out["total"]
    pos_in_pull = {int(b): i for i, b in enumerate(top_idx)}
    scored = np.asarray(out["scored"])
    cand_words = np.asarray(out["cand_words"])
    pm_rows = np.asarray(out["pm"])

    # resolve pm for every scored candidate position (device value, or
    # list lookup for sentinel -1), then ranks for the distinct pm set
    rows_all = sorted({pos_in_pull[b] for b in np.nonzero(cand)[0]})
    if meta["wide"]:
        codes_all = rebuild_codes_wide(cand_words[rows_all], k, block)
    else:
        codes_all = rebuild_codes(cand_words[rows_all], k, block).astype(
            np.int64)
    pm_all = pm_rows[rows_all].astype(np.int64)
    sc_all = scored[rows_all]
    need = (pm_all < 0) & sc_all
    if need.any():
        qi = np.searchsorted(lcodes, codes_all[need])
        qi = np.minimum(qi, max(len(lcodes) - 1, 0))
        if len(lcodes) == 0 or not np.array_equal(
                lcodes[qi], codes_all[need]):
            raise AssertionError(
                "sentinel-pm candidate code missing from the run list "
                "(list extraction bug)")
        pm_all[need] = lpm[qi]
    uniq_pm = np.unique(pm_all[sc_all]) if sc_all.any() else \
        np.zeros(0, np.int64)
    ranks_u = chain_ranks_from_mass(uniq_pm, (v_vals, n_codes), total) \
        if uniq_pm.size else np.zeros(0)
    row_of = {r: i for i, r in enumerate(rows_all)}

    regions = []
    i = 0
    while i < nb:
        if not cand[i]:
            i += 1
            continue
        j = i
        while j + 1 < nb and cand[j + 1]:
            j += 1
        rr = [row_of[pos_in_pull[b]] for b in range(i, j + 1)]
        sc_flat = sc_all[rr].reshape(-1)
        pm_flat = pm_all[rr].reshape(-1)
        qi = np.searchsorted(uniq_pm, np.where(sc_flat, pm_flat, 0))
        qi = np.minimum(qi, max(uniq_pm.size - 1, 0))
        s_flat = np.where(sc_flat, ranks_u[qi] - thr, 0.0)
        base_pos = i * block
        rep = (native.replay_scores(
            s_flat, sc_flat, min_width, min_score, base_pos)
            if native.available() else None)
        if rep is not None:
            regions.extend(
                (seq_id, int(bv), int(ev), float(sv))
                for bv, ev, sv in zip(*rep))
        else:
            regions.extend(_replay_stretch(
                s_flat, sc_flat, base_pos, min_width, min_score, seq_id))
        i = j + 1
    return SpanPipelineResult(regions=regions, fallback=False)
