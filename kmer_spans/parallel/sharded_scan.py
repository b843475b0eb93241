"""Sharded-spectrum span scan: the k>=13 configuration (SURVEY §5.8).

parallel/sharded.py counts and ranks a HASH-SHARDED spectrum (device d
owns codes [d, d+1) * 4^k / n_dev); this module closes the loop the
round-1 review flagged: a scan that CONSUMES the sharded mass table.
No device ever holds the 4^k table; each chunk's per-position mass
values are fetched with one all-to-all round:

  1. every device computes its genome shard's codes (ppermute halos);
  2. codes sort by owner shard, ride fixed-capacity buckets through
     lax.all_to_all; owners gather their local mass-PAIR shard
     (ops/wide.py (hi, lo) int32 pairs — exact past 2^31 k-mers);
  3. a second all_to_all returns the values; an unsort scatter restores
     genome order.

Screen scores are the integer upper bounds of ops/gather.py computed
from the pair mass (same two-f32-rounding slack as fine_class_table);
per-device blocks feed blocked_scan_summaries_int, and a per-device
top-C candidate gather pulls EXACT pair mass payloads — the host
finisher replays candidates from those pairs in f64 without ever
holding the spectrum (compose_summaries_exact + extract_spans, the same
exact-integer screening discipline as the single-chip pipeline).

Bucket-capacity overflow is detected and flagged (never silent); the
caller retries with a larger cap, exactly like the sharded count step.

Reference parity: kmer_low_comp_regions (src/kmer_spans.c:548-621) at
spectrum sizes the reference cannot reach (its counts are a single
malloc'd 4^k int array; k=15 = 4 GB).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.gather import SCREEN_SCALE


def _pair_sub(a_hi, a_lo, b_hi, b_lo):
    """Canonical pair difference a - b (requires a >= b)."""
    import jax.numpy as jnp

    lo = a_lo - b_lo
    borrow = (lo < 0).astype(jnp.int32)
    return a_hi - b_hi - borrow, lo + (borrow << 16)


def make_sharded_rank_step_wide(mesh, k: int, axis: str = "data",
                                vmax: int = 1 << 14):
    """Sharded rank mass as exact (hi, lo) int32 pairs (no 2^31 ceiling).

    shard_counts i32 [4^k] (sharded over ``axis``) ->
    (mass_hi, mass_lo i32 [4^k] sharded, clip_overflow bool,
     vhist_hi, vhist_lo i32 [vmax] replicated).

    The replicated value histogram (mass per count value) is what lets the
    host finisher rebuild the reference's EXACT f64 rank chain for
    candidate positions without the 4^k table
    (stats.ranks.chain_ranks_from_mass).

    Same decomposition as parallel/sharded.py make_sharded_rank_step —
    mass[i] = global mass below value + equal-value mass in lower shards
    + equal-value mass at lower local index — but every accumulation
    runs through ops/wide.py pairs, exact to 2^47 total k-mers
    (the reference's f64 chain is exact to 2^53; src/kmer_spans.c:198-200).
    Count VALUES >= vmax are clipped and flagged, as before.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.wide import (
        pair_cumsum,
        pair_psum,
        pair_scatter_add,
        renorm,
        split,
    )

    def body(shard_counts):
        me = jax.lax.axis_index(axis)
        n_dev = jax.lax.axis_size(axis)
        c = shard_counts
        clipped = jnp.minimum(c, vmax - 1)
        clip_overflow = jax.lax.pmax(jnp.any(c >= vmax), axis)
        # mass histogram over count values, exact pairs
        vh_hi, vh_lo = pair_scatter_add(vmax, clipped, c)
        gh_hi, gh_lo = pair_psum(vh_hi, vh_lo, axis)
        # global mass strictly below each value: exclusive pair cumsum
        cb_hi, cb_lo = pair_cumsum(gh_hi, gh_lo)
        below_hi = jnp.concatenate([jnp.zeros(1, jnp.int32), cb_hi[:-1]])
        below_lo = jnp.concatenate([jnp.zeros(1, jnp.int32), cb_lo[:-1]])
        # equal-value mass in strictly lower shards
        all_hi = jax.lax.all_gather(vh_hi, axis)  # [n_dev, vmax]
        all_lo = jax.lax.all_gather(vh_lo, axis)
        dev_ids = jax.lax.broadcasted_iota(jnp.int32, (n_dev, 1), 0)
        lower = dev_ids < me
        e_hi = jnp.sum(jnp.where(lower, all_hi, 0), axis=0)
        e_lo = jnp.sum(jnp.where(lower, all_lo, 0), axis=0)
        e_hi, e_lo = renorm(e_hi, e_lo)
        # equal-value mass at lower local index: exclusive cumsum over
        # the (value, index)-stable sort, minus each group's base
        m = c.shape[0]
        order = jnp.argsort(clipped, stable=True)
        sc = c[order]
        scl = clipped[order]
        sh, sl = split(sc)
        ch, cl = pair_cumsum(sh, sl)
        ex_hi = jnp.concatenate([jnp.zeros(1, jnp.int32), ch[:-1]])
        ex_lo = jnp.concatenate([jnp.zeros(1, jnp.int32), cl[:-1]])
        is_head = jnp.concatenate(
            [jnp.ones((1,), bool), scl[1:] != scl[:-1]])
        # group base = exclusive cumsum at the group head, carried by a
        # running max over a monotone key (positions are sorted, cumsum
        # is nondecreasing, so cummax of head-only values works per
        # channel composed as a single monotone value: hi*2^16+lo fits
        # int64 on CPU but not on device (x64 off) — carry the head
        # values via cummax on hi and SELECT lo at the argmax head by cummax of a packed
        # (hi, seg-unique) key instead.  Simpler: cummax over heads of
        # BOTH channels is correct because at group heads the pair value
        # is nondecreasing and lo alone need not be monotone — so pack
        # the head position and gather.)
        idx = jnp.arange(m, dtype=jnp.int32)
        head_pos = jax.lax.cummax(jnp.where(is_head, idx, 0))
        gb_hi = ex_hi[head_pos]
        gb_lo = ex_lo[head_pos]
        w_hi, w_lo = _pair_sub(ex_hi, ex_lo, gb_hi, gb_lo)
        # unsort the within-group mass back to local index order
        within_hi = jnp.zeros(m, jnp.int32).at[order].set(w_hi)
        within_lo = jnp.zeros(m, jnp.int32).at[order].set(w_lo)
        mass_hi = below_hi[clipped] + e_hi[clipped] + within_hi
        mass_lo = below_lo[clipped] + e_lo[clipped] + within_lo
        mass_hi, mass_lo = renorm(mass_hi, mass_lo)
        return mass_hi, mass_lo, clip_overflow, gh_hi, gh_lo

    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis),),
        out_specs=(P(axis), P(axis), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def run_max_across_devices(block_max, linked, axis, n_dev, me):
    """Each block's max over the positive-linked run it belongs to, for
    the top-C ordering of a sharded scan (inside shard_map).

    linked[i]: block i continues block i-1's run (linked[0]: the run
    carried in from the previous device); block_max: f32 per-block
    running-score maxima.  A segmented max forward and backward gives
    every block its device-local run's max.  A run that crosses a device
    edge peaks on one device only, so every device all_gathers (leading
    run max, trailing run max, linked in, one run throughout) and
    extends its leading and trailing runs across the edges — otherwise
    a run's tail on the next device ranks by its own low maximum and can
    miss the pull (the host then flags fallback).
    """
    import jax
    import jax.numpy as jnp

    from ..spans.pipeline import _seg_max_combine

    f32 = jnp.float32
    neg = f32(-jnp.inf)
    fwd, _ = jax.lax.associative_scan(
        _seg_max_combine, (block_max, (~linked).astype(f32)))
    linked_next = jnp.concatenate([linked[1:], jnp.zeros((1,), bool)])
    bwd, _ = jax.lax.associative_scan(
        _seg_max_combine,
        (jnp.flip(block_max), jnp.flip((~linked_next).astype(f32))))
    run_max = jnp.maximum(fwd, jnp.flip(bwd))
    run_id = jnp.cumsum((~linked).astype(jnp.int32))
    info = jnp.stack([run_max[0], run_max[-1], linked[0].astype(f32),
                      (run_id[-1] == 0).astype(f32)])
    edge = jax.lax.all_gather(info, axis)  # [n_dev, 4]
    # leading run: walk back while the edge is linked and the device
    # before is one run throughout
    left, alive = neg, linked[0]
    for step in range(1, n_dev):
        d = me - step
        row = edge[jnp.maximum(d, 0)]
        ok = alive & (d >= 0)
        left = jnp.where(ok, jnp.maximum(left, row[1]), left)
        alive = ok & (row[3] > 0) & (row[2] > 0)
    # trailing run: walk forward while the next device is linked in
    right, alive = neg, jnp.bool_(True)
    for step in range(1, n_dev):
        d = me + step
        row = edge[jnp.minimum(d, n_dev - 1)]
        ok = alive & (d < n_dev) & (row[2] > 0)
        right = jnp.where(ok, jnp.maximum(right, row[0]), right)
        alive = ok & (row[3] > 0)
    run_max = jnp.where(run_id == 0, jnp.maximum(run_max, left), run_max)
    return jnp.where(run_id == run_id[-1], jnp.maximum(run_max, right),
                     run_max)


def make_sharded_scan_step(
    mesh, k: int, axis: str = "data", block: int = 512,
    cand_blocks: int = 8, bucket_cap: int | None = None,
    replicate_out: bool = False,
):
    """Jitted step: sharded genome + sharded pair mass -> scan summaries
    + exact candidate payloads.

    (bases u8 [n], valid bool [n], mass_hi [4^k], mass_lo [4^k],
     total f32, thr f32) ->
      dict(tA/tB/maxA/maxB i32 [nb_total],
           top_idx i32 [n_dev*C] (global block ids),
           pm_hi/pm_lo i32 [n_dev*C, block], scored bool [n_dev*C, block],
           overflow bool)

    n must divide evenly into n_dev shards of a multiple of ``block``.
    Candidates are the per-device top-C blocks ranked by the f32-composed
    screen bound (globally consistent: per-device carries ride an
    all_gather); the HOST decides exact candidacy from the int32
    summaries and flags any block it needed but wasn't sent (fallback),
    never silently dropping a region.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.blocked import (
        blocked_codes,
        blocked_scan_summaries_int,
        blocked_scored,
    )
    from ..ops.gather import screen_thr_q
    from ..ops.scan import _combine
    from ..ops.wide import to_f32

    n_dev = mesh.devices.size
    ld = n_dev.bit_length() - 1
    if (1 << ld) != n_dev:
        raise ValueError("device count must be a power of two")
    shift = 2 * k - ld
    size = 1 << (2 * k)
    shard = size // n_dev
    halo = k - 1
    C = cand_blocks

    def body(bases, valid, mass_hi, mass_lo, total, thr):
        me = jax.lax.axis_index(axis)
        n_local = bases.shape[0]
        nb = n_local // block
        # --- halos: previous device's tail bases, next device's head ---
        fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        bwd = [((i + 1) % n_dev, i) for i in range(n_dev)]
        hb = jax.lax.ppermute(bases[-halo:], axis, fwd) if halo else None
        hv = None
        if halo:
            hv = jax.lax.ppermute(valid[-halo:], axis, fwd)
            hv = jnp.where(me == 0, False, hv)
        nxt = jax.lax.ppermute(valid[:1], axis, bwd)
        next_v = jnp.where(me == n_dev - 1, False, nxt[0])

        b2 = bases.astype(jnp.int32).reshape(nb, block)
        v2 = valid.reshape(nb, block)
        codes, kv = blocked_codes(b2, v2, k, first_bases=hb, first_valid=hv)
        scored = blocked_scored(v2, kv, next_valid=next_v)
        flat = jnp.where(kv, codes, -1).reshape(-1)

        # --- all-to-all mass fetch --------------------------------------
        cap = bucket_cap or (2 * n_local // n_dev)
        owner = jnp.where(flat >= 0, flat >> shift, n_dev)
        idx0 = jnp.arange(n_local, dtype=jnp.int32)
        owner_s, codes_s, idx_s = jax.lax.sort(
            (owner, flat, idx0), num_keys=1)
        is_head = jnp.concatenate(
            [jnp.ones((1,), bool), owner_s[1:] != owner_s[:-1]])
        group_start = jax.lax.cummax(jnp.where(is_head, idx0, 0))
        rank = idx0 - group_start
        overflow = jax.lax.pmax(
            jnp.any((rank >= cap) & (owner_s < n_dev)), axis)
        dest = jnp.where((owner_s < n_dev) & (rank < cap), owner_s, n_dev)
        slot = jnp.where(rank < cap, rank, 0)
        buckets = jnp.full((n_dev + 1, cap), -1, jnp.int32)
        buckets = buckets.at[dest, slot].set(
            jnp.where(dest < n_dev, codes_s, -1), mode="drop")[:n_dev]
        recv = jax.lax.all_to_all(
            buckets, axis, split_axis=0, concat_axis=0, tiled=False)
        base = me.astype(jnp.int32) * shard
        li = recv.reshape(-1) - base
        ok = (recv.reshape(-1) >= 0) & (li >= 0) & (li < shard)
        li = jnp.where(ok, li, 0)
        vh = jnp.where(ok, mass_hi[li], 0).reshape(n_dev, cap)
        vl = jnp.where(ok, mass_lo[li], 0).reshape(n_dev, cap)
        back_hi = jax.lax.all_to_all(
            vh, axis, split_axis=0, concat_axis=0, tiled=False)
        back_lo = jax.lax.all_to_all(
            vl, axis, split_axis=0, concat_axis=0, tiled=False)
        # value for sorted element i lives at [owner_s[i], rank[i]]
        sel = jnp.where(owner_s < n_dev, owner_s, 0) * cap + slot
        got_hi = back_hi.reshape(-1)[sel]
        got_lo = back_lo.reshape(-1)[sel]
        pm_hi = jnp.zeros(n_local, jnp.int32).at[idx_s].set(
            got_hi.astype(jnp.int32))
        pm_lo = jnp.zeros(n_local, jnp.int32).at[idx_s].set(
            got_lo.astype(jnp.int32))

        # --- integer screen scores (same slack family as fine tables) ---
        thr_q = screen_thr_q(thr)
        rank_f = to_f32(pm_hi, pm_lo) / jnp.maximum(total, 1.0)
        tabv = jnp.clip((rank_f * SCREEN_SCALE).astype(jnp.int32),
                        0, SCREEN_SCALE) + 1
        s_int = (tabv + 2 - thr_q).reshape(nb, block)

        tA, tB, maxA, maxB = blocked_scan_summaries_int(s_int, scored)

        # --- globally-consistent f32 composition for top-C ordering -----
        from ..ops.blocked import SCREEN_NEG

        sent = SCREEN_NEG // 2
        neg = jnp.float32(-jnp.inf)
        tAf = tA.astype(jnp.float32)
        tBf = jnp.where(tB <= sent, neg, tB.astype(jnp.float32))
        maxBf = jnp.where(maxB <= sent, neg, maxB.astype(jnp.float32))
        cA, cB = jax.lax.associative_scan(_combine, (tAf, tBf))
        dev_tr = jnp.stack([cA[-1], cB[-1]])  # my device's transform
        all_tr = jax.lax.all_gather(dev_tr, axis)  # [n_dev, 2]

        def comp(x, y):
            return (x[0] + y[0], jnp.maximum(x[1] + y[0], y[1]))

        x_dev = jnp.float32(0.0)
        xb_dev = neg
        for d in range(n_dev - 1):
            use = d < me
            x_dev = jnp.where(use, x_dev + all_tr[d, 0], x_dev)
            xb_dev = jnp.where(
                use, jnp.maximum(xb_dev + all_tr[d, 0], all_tr[d, 1]),
                xb_dev)
        x_in_dev = jnp.maximum(x_dev, xb_dev)  # -inf -> never chosen
        x_in_dev = jnp.maximum(x_in_dev, 0.0)  # initial state is 0
        block_last = jnp.maximum(x_in_dev + cA, cB)
        x_in = jnp.concatenate(
            [x_in_dev.reshape(1), block_last[:-1]])
        block_max = jnp.maximum(x_in + maxA.astype(jnp.float32), maxBf)
        # run-aware neediness (as spans/pipeline.py): every block of a
        # positive-linked run must be pulled for the replay to start at
        # the excursion's true beginning — rank blocks by their RUN's
        # max, runs crossing device edges included
        linked = x_in > 0
        run_max = run_max_across_devices(
            block_max, linked, axis, n_dev, me)
        _, top_idx = jax.lax.top_k(run_max, min(C, nb))
        top_idx = jnp.sort(top_idx)
        outs = (
            tA, tB, maxA, maxB,
            top_idx + me.astype(jnp.int32) * nb,
            pm_hi.reshape(nb, block)[top_idx],
            pm_lo.reshape(nb, block)[top_idx],
            scored[top_idx],
            overflow,
        )
        if replicate_out:
            # multi-process mode: every process's host finisher needs the
            # FULL summaries + candidate payloads — this all_gather is the
            # cross-process "region gather" (it rides the collective mesh,
            # DCN across hosts), after which every process computes the
            # identical exact region list
            outs = tuple(
                jax.lax.all_gather(o, axis, tiled=True)
                for o in outs[:-1]
            ) + (overflow,)
        return outs

    import jax as _jax
    from jax.sharding import PartitionSpec as P  # noqa: F811

    shard_spec = P() if replicate_out else P(axis)
    sharded = _jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(shard_spec,) * 8 + (P(),),
        check_vma=False,
    )
    return _jax.jit(sharded)


@dataclasses.dataclass
class ShardedScanResult:
    regions: list  # (seq_id, beg, end, score) 1-based last-base coords
    fallback: bool  # a needed block wasn't in any device's top-C pull
    overflow: bool  # all-to-all bucket capacity overflowed (retry larger)
    devices: int = 0  # devices holding a shard of the 4^k spectrum


def finish_sharded_spans(
    out, n: int, total: int, thr: float, min_width: int, min_score: float,
    block: int, seq_id: int = 0, value_hist=None,
) -> ShardedScanResult:
    """Exact host finisher over the sharded scan step's outputs.

    Same discipline as spans/pipeline.finish_spans: int64 composition of
    the integer summaries (sound upper bound), run-aware candidacy, f64
    replay — but per-position mass comes from the pulled (hi, lo) pairs
    (exact to 2^47), so the host never materializes the 4^k table.

    value_hist: int64 mass-per-count-value histogram (the wide rank step's
    replicated vhist output).  When given, candidate scores replay the
    reference's EXACT f64 rank chain via chain_ranks_from_mass — emitted
    scores are bit-identical to src/kmer_spans.c:198-200 with memory
    O(#distinct count values), never O(4^k).  Without it, scores fall
    back to mass/total (positions exact, scores ~1e-9).
    """
    from ..spans.extract import extract_spans
    from ..spans.pipeline import compose_summaries_exact

    (tA, tB, maxA, maxB, top_idx, pm_hi, pm_lo, scored, overflow) = out
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
        return ShardedScanResult([], False, overflow)
    top_idx = np.asarray(top_idx)
    have = np.zeros(nb, bool)
    have[top_idx] = True
    if (cand & ~have).any():
        return ShardedScanResult([], True, overflow)
    pos_in_pull = {int(b): i for i, b in enumerate(top_idx)}
    pm = (np.asarray(pm_hi).astype(np.int64) << 16) + np.asarray(
        pm_lo).astype(np.int64)
    sc = np.asarray(scored)

    def ranks_of(pm_flat, sc_flat):
        if value_hist is None:
            return pm_flat.astype(np.float64) / total
        from ..stats.ranks import chain_ranks_from_mass

        # only scored positions carry real mass values; mask the rest to 0
        # (a valid mass) before the exact-chain lookup
        return chain_ranks_from_mass(
            np.where(sc_flat, pm_flat, 0), value_hist, total)

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
        sc_flat = sc[rows].reshape(-1)
        s_flat = np.where(
            sc_flat, ranks_of(pm[rows].reshape(-1), sc_flat) - thr, 0.0)
        regs = extract_spans(
            s_flat, sc[rows].reshape(-1), min_width, min_score,
            seq_id=seq_id)
        regions.extend(
            (sid, beg + i * block, end + i * block, scv)
            for sid, beg, end, scv in regs)
        i = j + 1
    return ShardedScanResult(regions, False, overflow)


def sharded_low_comp_regions(
    mesh, nbases: np.ndarray, k: int, min_width: int, min_score: float,
    thr: float = 0.75, block: int = 512, cand_blocks: int = 8,
    axis: str = "data", bucket_cap: int | None = None, vmax: int = 1 << 14,
):
    """Full sharded pipeline: count -> wide rank -> scan -> exact spans.

    nbases: uint8 genome (4 = N); padded up to n_dev*block internally
    (padding rides as N, which cannot create or destroy regions).
    The 4^k spectrum/mass lives sharded across the mesh end to end; the
    host sees only block summaries and candidate payloads.
    """
    import jax.numpy as jnp

    from .sharded import make_sharded_count_step

    n_dev = mesh.devices.size
    n0 = nbases.shape[0]
    step_n = n_dev * block
    n = -(-n0 // step_n) * step_n
    if n != n0:
        nbases = np.concatenate(
            [nbases, np.full(n - n0, 4, np.uint8)])
    # exact total k-mers from the validity mask, on the host (int64 —
    # no device reduction that could overflow int32)
    v = (nbases < 4).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(v)])
    total = int(np.count_nonzero(cs[k:] - cs[:-k] == k))
    bases = jnp.asarray(nbases & 3)
    valid = jnp.asarray(nbases < 4)
    cstep = make_sharded_count_step(
        mesh, k, axis=axis, block=block,
        bucket_cap=bucket_cap)
    rstep = make_sharded_rank_step_wide(mesh, k, axis=axis, vmax=vmax)
    sstep = make_sharded_scan_step(
        mesh, k, axis=axis, block=block, cand_blocks=cand_blocks,
        bucket_cap=bucket_cap)
    with mesh:
        sh_counts, c_overflow = cstep(bases, valid)
        mass_hi, mass_lo, clip, vh_hi, vh_lo = rstep(sh_counts)
        out = sstep(bases, valid, mass_hi, mass_lo,
                    jnp.float32(total), jnp.float32(thr))
    # a clipped value histogram cannot rebuild the exact chain (the result
    # is flagged overflow below; caller retries with a larger vmax)
    value_hist = None
    if not bool(np.asarray(clip)):
        value_hist = (np.asarray(vh_hi).astype(np.int64) << 16) + \
            np.asarray(vh_lo).astype(np.int64)
    res = finish_sharded_spans(
        out, n, total, thr, min_width, min_score, block,
        value_hist=value_hist)
    if bool(np.asarray(c_overflow)) or bool(np.asarray(clip)):
        res.overflow = True
    res.devices = len(sh_counts.sharding.device_set)
    return res
