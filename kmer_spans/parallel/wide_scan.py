"""Sharded SPARSE-spectrum span scan for wide codes (k >= 16).

BASELINE config 5 (k=17 cohort / 32 Gb genomes) cannot use the dense
hash-sharded spectrum of parallel/sharded_scan.py — 4^17 int32 is 68 GB
before mass pairs.  The answer is that a genome's spectrum
is SPARSE (<= n distinct codes), so the spectrum is materialized only
as sorted runs, sharded by code range:

  1. every device computes its genome shard's (hi, lo) pair codes
     (ppermute halos) and sorts them locally (2-key lax.sort) — a
     position's local run length is its k-mer's LOCAL count;
  2. each local run head ships (hi, lo, local_count) to the code's
     owner (top log2(n_dev) bits — ranges, which the local sort has
     already grouped) through one fixed-capacity all_to_all;
  3. owners merge-sort the received runs; a global run's count is the
     segment sum of local counts; per-owner run histograms (by count
     value and by (value, high-byte)) psum into the GLOBAL rank-upper-
     bound tables of ops/sortscreen.py — replicated, vmax + v2*256
     entries, never 4^k;
  4. a second all_to_all returns each run's global count; devices
     broadcast it run-wide, gather the replicated class table, unsort
     to genome order, and run the usual integer scan summaries +
     per-device top-C candidate pull (pair codes travel with the
     candidates for the host's exact replay).

Scale limit (explicit, enforced at trace time): total mass accumulates
in int32, so one-shot inputs are capped below 2^31 counted k-mers
(~2.1 Gb); larger genomes go through the chunked streaming path.

Memory is O(n/device) everywhere.  Soundness is inherited: the tables
are the same integer rank upper bounds as the single-chip sort screen
(each global run counted exactly once, by its owner), the host
composes summaries in exact int64, and candidates replay through the
exact f64 chain from a sparse host recount — bit-identical to the
sequential oracle.

Reference parity: extends kmer_low_comp_regions + rank_kmers_w
(src/kmer_spans.c:548-621, :189-202) past the reference's MAX_K, with
the mclapply fork (test.R:550-565) generalized to a device mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.gather import SCREEN_SCALE


def make_wide_sharded_scan(
    mesh, k: int, axis: str = "data", block: int = 512,
    cand_blocks: int = 8, bucket_cap: int | None = None,
    vmax: int = 1 << 12, v2: int = 1 << 8,
):
    """Jitted sharded step: genome shards -> summaries + candidates.

    fn(bases u8 [n], valid bool [n], thr f32) ->
      (tA/tB/maxA/maxB i32 [nb_total], top_idx i32 [n_dev*C] global
       block ids, cand_hi/cand_lo i32 [n_dev*C, block],
       scored bool [n_dev*C, block], total i32, overflow bool)

    n must divide into n_dev shards each a multiple of ``block``.
    bucket_cap bounds the per-(src, owner) run exchange; overflow is
    flagged (never silent) — retry with a larger cap.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.blocked import (
        WIDE_MAX_K,
        blocked_codes_wide,
        blocked_scan_summaries_int,
        blocked_scored,
    )
    from ..ops.gather import screen_thr_q
    from ..ops.scan import _combine
    from ..ops.sortscreen import (
        _run_lengths,
        rank_ub_gather,
        rank_ub_histograms,
        rank_ub_tables,
    )

    if not 16 <= k <= WIDE_MAX_K:
        raise ValueError(f"wide codes need 16 <= k <= {WIDE_MAX_K}")
    n_dev = mesh.devices.size
    ld = n_dev.bit_length() - 1
    if (1 << ld) != n_dev:
        raise ValueError("device count must be a power of two")
    own_shift = 2 * (k - 8) - ld  # owner = top ld bits of the code
    halo = k - 1
    C = cand_blocks
    sent = jnp.int32(1 << 30)

    def body(bases, valid, thr):
        me = jax.lax.axis_index(axis)
        n_local = bases.shape[0]
        # total k-mer mass accumulates in int32 (psum'd total, owner-side
        # mass cumsums, rank_ub_tables): reject configurations that could
        # wrap BEFORE tracing — genomes past 2^31 counted k-mers must be
        # chunked (parallel/stream.py) rather than one-shot scanned
        if n_local * n_dev >= (1 << 31):
            raise ValueError(
                "wide sharded scan accumulates mass in int32: total "
                f"bases {n_local * n_dev:,} >= 2^31 could overflow — "
                "chunk the genome (stream) above ~2.1 Gb")
        nb = n_local // block
        i32 = jnp.int32
        idx = jax.lax.iota(i32, n_local)

        # --- halos (as sharded_scan): prev tail bases, next head valid --
        fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        bwd = [((i + 1) % n_dev, i) for i in range(n_dev)]
        hb_ = jax.lax.ppermute(bases[-halo:], axis, fwd)
        hv = jax.lax.ppermute(valid[-halo:], axis, fwd)
        hv = jnp.where(me == 0, False, hv)
        nxt = jax.lax.ppermute(valid[:1], axis, bwd)
        next_v = jnp.where(me == n_dev - 1, False, nxt[0])

        b2 = bases.astype(i32).reshape(nb, block)
        v2d = valid.reshape(nb, block)
        hi, lo, kv = blocked_codes_wide(
            b2, v2d, k, first_bases=hb_, first_valid=hv)
        scored = blocked_scored(v2d, kv, next_valid=next_v)

        # --- local 2-key sort; runs = local counts ----------------------
        key1 = jnp.where(kv, hi, sent).reshape(-1)
        key2 = jnp.where(kv, lo, 0).reshape(-1)
        k1, k2, spos = jax.lax.sort((key1, key2, idx), num_keys=2)
        head = jnp.concatenate(
            [jnp.ones((1,), bool),
             (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])])
        v_loc = _run_lengths(head, n_local)
        real = k1 < sent
        total = jax.lax.psum(jnp.sum(kv.astype(i32)), axis)

        # --- ship run heads to owners (one all_to_all) ------------------
        cap = bucket_cap or max(64, 2 * n_local // n_dev)
        ow = jnp.where(real, k1 >> own_shift, n_dev)
        hord = jnp.cumsum((head & real).astype(i32)) - 1
        ohead = jnp.concatenate(
            [jnp.ones((1,), bool), ow[1:] != ow[:-1]])
        base_ord = jax.lax.cummax(jnp.where(ohead, hord, 0))
        rio = hord - base_ord  # rank among my heads for this owner
        is_send = head & real
        overflow = jax.lax.pmax(jnp.any(is_send & (rio >= cap)), axis)
        dest = jnp.where(is_send & (rio < cap), ow, n_dev)
        slot = jnp.where(rio < cap, rio, 0)
        buckets = jnp.full((n_dev + 1, cap, 3), -1, i32)
        payload = jnp.stack([k1, k2, v_loc], axis=-1)
        buckets = buckets.at[dest, slot].set(payload, mode="drop")[:n_dev]
        recv = jax.lax.all_to_all(
            buckets, axis, split_axis=0, concat_axis=0, tiled=False)

        # --- owner merge: global counts per run -------------------------
        m = n_dev * cap
        rh = recv[..., 0].reshape(-1)
        rl = recv[..., 1].reshape(-1)
        rc = jnp.maximum(recv[..., 2].reshape(-1), 0)
        empty = rh < 0
        sh, sl, sc, ridx = jax.lax.sort(
            (jnp.where(empty, sent, rh), jnp.where(empty, 0, rl),
             jnp.where(empty, 0, rc), jax.lax.iota(i32, m)),
            num_keys=2)
        ghead = jnp.concatenate(
            [jnp.ones((1,), bool),
             (sh[1:] != sh[:-1]) | (sl[1:] != sl[:-1])])
        greal = sh < sent
        cs = jnp.cumsum(sc)
        excl = cs - sc
        gbase = jax.lax.cummax(jnp.where(ghead, excl, 0))
        glast = jnp.concatenate([ghead[1:], jnp.ones((1,), bool)])
        gidx = jax.lax.iota(i32, m)
        gend = jax.lax.cummin(
            jnp.where(glast, gidx, jnp.int32(1 << 30)), reverse=True)
        g_tot = cs[gend] - gbase  # the run's GLOBAL count, per element

        # --- global rank-upper-bound tables (psum'd histograms) ---------
        ghb = (sh >> (2 * k - 24)) & 255
        vh_runs, h2 = rank_ub_histograms(
            g_tot, ghb, ghead & greal, vmax, v2)
        vh_runs = jax.lax.psum(vh_runs, axis)
        h2 = jax.lax.psum(h2, axis)
        words = rank_ub_tables(vh_runs, h2, total, vmax, v2)

        # --- return global counts to senders -----------------------------
        gret = jnp.zeros((m,), i32).at[ridx].set(g_tot).reshape(n_dev, cap)
        back = jax.lax.all_to_all(
            gret, axis, split_axis=0, concat_axis=0, tiled=False)
        sel = jnp.where(is_send & (rio < cap), ow * cap + slot, 0)
        g_mine = back.reshape(-1)[sel]  # per head, my run's global count
        head_pos = jax.lax.cummax(jnp.where(head, idx, 0))
        g_head = jnp.where(head, g_mine, 0)
        v_glob = g_head[head_pos]

        # --- screen scores, genome order ---------------------------------
        thr_q = screen_thr_q(thr)
        hb8 = (k1 >> (2 * k - 24)) & 255
        s_sorted = rank_ub_gather(words, v_glob, hb8, thr_q, vmax, v2)
        _, s_int = jax.lax.sort((spos, s_sorted), num_keys=1)
        s_int = s_int.reshape(nb, block)
        tA, tB, maxA, maxB = blocked_scan_summaries_int(s_int, scored)

        # --- globally-consistent f32 composition for top-C ordering -----
        from ..ops.blocked import SCREEN_NEG
        from .sharded_scan import run_max_across_devices

        snt = SCREEN_NEG // 2
        neg = jnp.float32(-jnp.inf)
        tAf = tA.astype(jnp.float32)
        tBf = jnp.where(tB <= snt, neg, tB.astype(jnp.float32))
        maxBf = jnp.where(maxB <= snt, neg, maxB.astype(jnp.float32))
        cA, cB = jax.lax.associative_scan(_combine, (tAf, tBf))
        dev_tr = jnp.stack([cA[-1], cB[-1]])
        all_tr = jax.lax.all_gather(dev_tr, axis)
        x_dev = jnp.float32(0.0)
        xb_dev = neg
        for d in range(n_dev - 1):
            use = d < me
            x_dev = jnp.where(use, x_dev + all_tr[d, 0], x_dev)
            xb_dev = jnp.where(
                use, jnp.maximum(xb_dev + all_tr[d, 0], all_tr[d, 1]),
                xb_dev)
        x_in_dev = jnp.maximum(jnp.maximum(x_dev, xb_dev), 0.0)
        block_last = jnp.maximum(x_in_dev + cA, cB)
        x_in = jnp.concatenate([x_in_dev.reshape(1), block_last[:-1]])
        block_max = jnp.maximum(x_in + maxA.astype(jnp.float32), maxBf)
        run_max = run_max_across_devices(
            block_max, x_in > 0, axis, n_dev, me)
        _, top_idx = jax.lax.top_k(run_max, min(C, nb))
        top_idx = jnp.sort(top_idx)

        return (
            tA, tB, maxA, maxB,
            top_idx + me.astype(i32) * nb,
            hi.reshape(nb, block)[top_idx],
            lo.reshape(nb, block)[top_idx],
            scored[top_idx],
            total,
            overflow,
        )

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=(P(axis),) * 8 + (P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


@dataclasses.dataclass
class WideShardedResult:
    regions: list   # (seq_id, beg, end, score) 1-based last-base coords
    fallback: bool  # a needed block wasn't in any device's top-C pull
    overflow: bool  # run-exchange bucket capacity overflowed (retry)
    devices: int = 0  # devices holding a shard of the block summaries


def finish_wide_sharded(
    out, n: int, k: int, thr: float, min_width: int, min_score: float,
    spectrum, block: int, seq_id: int = 0,
) -> WideShardedResult:
    """Exact host finisher: int64 candidacy + sparse f64 chain replay.

    spectrum: (ucodes, ucounts, total) from a host recount
    (oracle.count_spectrum_sparse) — the sharded step itself never
    materializes a spectrum; emitted scores are bit-identical to the
    sequential oracle (SparseRanks over the same recount).
    """
    from ..spans.pipeline import compose_summaries_exact, _replay_stretch
    from ..stats.ranks import chain_ranks_from_mass, sparse_mass
    from ..utils import native

    (tA, tB, maxA, maxB, top_idx, c_hi, c_lo, scored, total_dev,
     overflow) = out
    overflow = bool(np.asarray(overflow))
    tA = np.asarray(tA)
    nb = tA.shape[0]
    block_max, block_last = compose_summaries_exact(
        tA, np.asarray(tB), np.asarray(maxA), np.asarray(maxB))
    linked = np.zeros(nb, bool)
    linked[1:] = block_last[:-1] > 0
    starts = np.nonzero(~linked)[0]
    run_of = np.cumsum(~linked) - 1
    run_max = np.maximum.reduceat(block_max, starts)[run_of]
    cand = run_max >= float(min_score) * SCREEN_SCALE
    if not cand.any():
        return WideShardedResult([], False, overflow)
    top_idx = np.asarray(top_idx)
    have = np.zeros(nb, bool)
    have[top_idx] = True
    if (cand & ~have).any():
        return WideShardedResult([], True, overflow)

    ucodes, ucounts, total = spectrum
    ucodes = np.asarray(ucodes, np.int64)
    assert total == int(np.asarray(total_dev)), "device/host total mismatch"
    pm_all, vhist, _ = sparse_mass(ucodes, ucounts)
    pos_in_pull = {int(b): i for i, b in enumerate(top_idx)}
    codes = (np.asarray(c_hi).astype(np.int64) << 16) | (
        np.asarray(c_lo).astype(np.int64) & 0xFFFF)
    sc = np.asarray(scored)
    rows_all = sorted({pos_in_pull[b] for b in np.nonzero(cand)[0]})
    uniq = np.unique(codes[rows_all][sc[rows_all]])
    idx_u = np.minimum(np.searchsorted(ucodes, uniq),
                       max(len(ucodes) - 1, 0))
    ranks_u = chain_ranks_from_mass(pm_all[idx_u], vhist, total)

    regions = []
    i = 0
    while i < nb:
        if not cand[i]:
            i += 1
            continue
        j = i
        while j + 1 < nb and cand[j + 1]:
            j += 1
        rows = [pos_in_pull[b] for b in range(i, j + 1)]
        c_flat = codes[rows].reshape(-1)
        sc_flat = sc[rows].reshape(-1)
        qi = np.minimum(np.searchsorted(uniq, c_flat),
                        max(len(uniq) - 1, 0))
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
    return WideShardedResult(regions, False, overflow)


def wide_low_comp_regions(
    mesh, nbases: np.ndarray, k: int, min_width: int, min_score: float,
    thr: float = 0.75, block: int = 512, cand_blocks: int = 8,
    axis: str = "data", bucket_cap: int | None = None,
):
    """Full sharded wide-k pipeline: scan on the mesh, sparse host recount,
    exact spans.  nbases: uint8 genome (4 = N), padded internally."""
    import jax.numpy as jnp

    from ..utils import native

    n_dev = mesh.devices.size
    n0 = nbases.shape[0]
    step_n = n_dev * block
    n = -(-n0 // step_n) * step_n
    if n != n0:
        nbases = np.concatenate([nbases, np.full(n - n0, 4, np.uint8)])
    fn = make_wide_sharded_scan(
        mesh, k, axis=axis, block=block, cand_blocks=cand_blocks,
        bucket_cap=bucket_cap)
    with mesh:
        out = fn(jnp.asarray(nbases & 3), jnp.asarray(nbases < 4),
                 jnp.float32(thr))
    spectrum = native.host_spectrum_sparse(nbases, k)
    res = finish_wide_sharded(
        out, n, k, thr, min_width, min_score, spectrum, block)
    res.devices = len(out[0].sharding.device_set)
    return res
