"""Sharded-spectrum scan: wide pair arithmetic + end-to-end conformance.

The k>=13 configuration (SURVEY §5.8): the 4^k mass table stays sharded
across the 8-virtual-device CPU mesh; the scan fetches per-position mass
with an all-to-all round; spans must match the oracle bit-for-bit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from kmer_spans.oracle import weighted_ranks
from kmer_spans.parallel.sharded_scan import (
    make_sharded_rank_step_wide,
    sharded_low_comp_regions,
)
from kmer_spans.spans.pipeline import host_rank_mass
from kmer_spans.utils import native


def mesh8():
    return Mesh(np.array(jax.devices()[:8]), ("data",))


# ---------------------------------------------------------------- wide ops


def test_pair_cumsum_matches_int64():
    from kmer_spans.ops.wide import pair_cumsum, split

    rng = np.random.default_rng(0)
    # values big enough that the running total crosses 2^31 many times
    v = rng.integers(0, 1 << 28, size=100_000).astype(np.int64)
    expect = np.cumsum(v)
    assert expect[-1] > (1 << 40)
    hi, lo = split(jnp.asarray(v.astype(np.int32)))
    ch, cl = pair_cumsum(hi, lo)
    got = np.asarray(ch).astype(np.int64) * 65536 + np.asarray(cl)
    np.testing.assert_array_equal(got, expect)


def test_pair_scatter_add_matches_int64():
    from kmer_spans.ops.wide import pair_scatter_add

    rng = np.random.default_rng(1)
    idx = rng.integers(0, 64, size=200_000).astype(np.int32)
    v = rng.integers(0, 1 << 30, size=200_000).astype(np.int32)
    expect = np.zeros(64, np.int64)
    np.add.at(expect, idx, v.astype(np.int64))
    assert expect.max() > (1 << 40)
    hi, lo = pair_scatter_add(64, jnp.asarray(idx), jnp.asarray(v))
    got = np.asarray(hi).astype(np.int64) * 65536 + np.asarray(lo)
    np.testing.assert_array_equal(got, expect)


# ------------------------------------------------------------- wide ranks


def test_sharded_rank_wide_matches_host_past_int32():
    """Mass values beyond 2^31 — the config int32 ranks cannot reach."""
    mesh = mesh8()
    k = 9  # 262144 entries; moderate per-kmer counts, > 2^32 total mass
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 1 << 14, size=1 << (2 * k)).astype(np.int32)
    expect = host_rank_mass(counts)
    assert expect.max() > np.iinfo(np.int32).max
    step = make_sharded_rank_step_wide(mesh, k, vmax=1 << 14)
    with mesh:
        sh = jax.device_put(
            jnp.asarray(counts),
            jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("data")),
        )
        hi, lo, clip, vh_hi, vh_lo = step(sh)
    assert not bool(np.asarray(clip))
    got = np.asarray(hi).astype(np.int64) * 65536 + np.asarray(lo)
    np.testing.assert_array_equal(got, expect)
    vh = np.asarray(vh_hi).astype(np.int64) * 65536 + np.asarray(vh_lo)
    ref_vh = np.bincount(counts, weights=counts.astype(np.float64),
                         minlength=1 << 14).astype(np.int64)
    np.testing.assert_array_equal(vh, ref_vh)


def test_sharded_rank_wide_clip_flagged():
    mesh = mesh8()
    k = 4
    counts = np.full(1 << (2 * k), 5, np.int32)
    counts[3] = 1 << 20  # >= vmax
    step = make_sharded_rank_step_wide(mesh, k, vmax=1 << 14)
    with mesh:
        hi, lo, clip, _, _ = step(jnp.asarray(counts))
    assert bool(np.asarray(clip))


def test_sharded_rank_wide_matches_real_spectrum(golden):
    """Tie-heavy real spectrum: stable (count, index) order must hold."""
    mesh = mesh8()
    k = 6
    nb = _to_nbases(golden)
    counts, _ = native.count_spectrum(nb, k)
    expect = host_rank_mass(counts)
    step = make_sharded_rank_step_wide(mesh, k)
    with mesh:
        hi, lo, clip, vh_hi, vh_lo = step(jnp.asarray(counts.astype(np.int32)))
    got = np.asarray(hi).astype(np.int64) * 65536 + np.asarray(lo)
    assert not bool(np.asarray(clip))
    np.testing.assert_array_equal(got, expect)


# ------------------------------------------------- end-to-end conformance


def _to_nbases(seq):
    from kmer_spans.encoding import pack

    ps = pack(seq)
    return np.where(ps.valid, ps.bases, 4).astype(np.uint8)


def _oracle_regions(nb, k, min_w, min_s, thr):
    counts, nw = native.count_spectrum(nb, k)
    ranks = weighted_ranks(counts, float(nw))
    beg, end, score, _ = native.find_spans(nb, k, ranks, thr, min_w, min_s)
    return list(zip(beg, end, score))


def test_sharded_scan_golden_bitexact(golden):
    mesh = mesh8()
    k = 8
    nb = _to_nbases(golden)
    res = sharded_low_comp_regions(
        mesh, nb, k, min_width=100, min_score=20.0,
        thr=0.75, block=512, cand_blocks=12)
    assert not res.fallback and not res.overflow
    assert res.devices == 8
    expect = _oracle_regions(nb, k, 100, 20.0, 0.75)
    assert [(b, e) for _, b, e, _ in res.regions] == [
        (b, e) for b, e, _ in expect]
    # scores replay the reference's exact f64 rank chain rebuilt from the
    # value histogram (chain_ranks_from_mass) — bit-identical, no 4^k pull
    for (_, _, _, sc), (_, _, ws) in zip(res.regions, expect):
        assert sc == ws


def test_sharded_scan_random_with_gaps(rng):
    """Random genome + N gaps + planted island, vs oracle."""
    mesh = mesh8()
    k = 5
    n = 40_000
    nb = rng.integers(0, 4, size=n, dtype=np.uint8)
    nb[5_000:5_040] = 4
    nb[20_000:21_200] = np.tile(np.array([0, 3], np.uint8), 600)
    nb[33_000:33_007] = 4
    res = sharded_low_comp_regions(
        mesh, nb, k, min_width=50, min_score=10.0, thr=0.7,
        block=512, cand_blocks=16)
    assert not res.fallback and not res.overflow
    expect = _oracle_regions(nb, k, 50, 10.0, 0.7)
    assert [(b, e) for _, b, e, _ in res.regions] == [
        (b, e) for b, e, _ in expect]
    for (_, _, _, sc), (_, _, ws) in zip(res.regions, expect):
        assert sc == ws  # bit-identical f64


def test_sharded_scan_fallback_flagged(rng):
    """cand_blocks too small for the candidate runs -> fallback, never
    silent wrong output."""
    mesh = mesh8()
    k = 5
    n = 16_384
    nb = rng.integers(0, 4, size=n, dtype=np.uint8)
    # one island per device shard so each device needs its own pull
    for s in range(0, n - 600, 2048):
        nb[s:s + 600] = np.tile(np.array([1, 2], np.uint8), 300)
    res = sharded_low_comp_regions(
        mesh, nb, k, min_width=20, min_score=5.0, thr=0.5,
        block=512, cand_blocks=1)
    if res.regions:
        # if it claims success the regions must be exactly right
        expect = _oracle_regions(nb, k, 20, 5.0, 0.5)
        assert [(b, e) for _, b, e, _ in res.regions] == [
            (b, e) for b, e, _ in expect]
    else:
        assert res.fallback


# ------------------------------------- exact chain from value histogram


@pytest.mark.parametrize("seed,lam", [(0, 3.0), (1, 0.3), (2, 40.0)])
def test_chain_ranks_from_mass_bitexact(seed, lam):
    """chain_ranks_from_mass == oracle.weighted_ranks for every k-mer,
    including heavy count ties and the chunked streaming path."""
    from kmer_spans.stats.ranks import (
        chain_ranks_from_mass,
        cumulative_mass,
    )

    rng = np.random.default_rng(seed)
    counts = rng.poisson(lam, 4096).astype(np.int64)
    total = int(counts.sum())
    mass = cumulative_mass(counts)
    vh = np.bincount(
        counts, weights=counts.astype(np.float64)).astype(np.int64)
    ref = weighted_ranks(counts, float(total))
    got = chain_ranks_from_mass(mass, vh, total)
    np.testing.assert_array_equal(got, ref)
    got_chunked = chain_ranks_from_mass(mass, vh, total, chunk=101)
    np.testing.assert_array_equal(got_chunked, ref)


def test_chain_ranks_rejects_bad_mass():
    from kmer_spans.stats.ranks import chain_ranks_from_mass

    vh = np.zeros(8, np.int64)
    vh[3] = 12  # four codes with count 3
    with pytest.raises(ValueError):
        chain_ranks_from_mass(np.array([4]), vh, 12)  # 4 not a multiple of 3


def test_sharded_scan_k13_no_host_table(rng):
    """k=13: the 4^13 = 67M-entry spectrum/mass lives SHARDED on the mesh
    end to end — the host sees only block summaries, candidate payloads,
    and the vmax-sized value histogram (never a 4^k array).  This is the
    single-chip-pathology answer for k >= 13 (round-2 missing #3): rank
    mass is computed device-side in wide pairs and candidate scores
    replay the exact chain via chain_ranks_from_mass."""
    mesh = mesh8()
    k = 13
    n = 1 << 17  # 131072 bases: tiny vs 4^13 — spectrum is all 0s/1s + island
    nb = rng.integers(0, 4, size=n, dtype=np.uint8)
    nb[40_000:40_800] = np.tile(np.array([0, 1, 2, 3, 0, 3], np.uint8)[
        np.arange(800) % 6], 1)
    nb[90_000:90_020] = 4
    res = sharded_low_comp_regions(
        mesh, nb, k, min_width=100, min_score=10.0, thr=0.75,
        block=1024, cand_blocks=8, bucket_cap=1 << 15)
    assert not res.fallback and not res.overflow
    expect = _oracle_regions(nb, k, 100, 10.0, 0.75)
    got = [(b, e, s) for _, b, e, s in res.regions]
    want = [(b, e, s) for b, e, s in expect]
    assert got == want
    assert len(got) >= 1


@pytest.mark.parametrize("case", ["edge_run", "three_device_run"])
def test_run_max_across_devices(case):
    """Blocks of a run that crosses device edges rank by the WHOLE run's
    max on every device (the top-C pull then covers the run's tail on
    the next device), matching a global numpy segmented max."""
    from jax.sharding import PartitionSpec as P

    from kmer_spans.parallel.sharded_scan import run_max_across_devices

    n_dev, per = 4, 6
    nb = n_dev * per
    rng = np.random.default_rng(3)
    bmax = rng.uniform(0.0, 10.0, nb).astype(np.float32)
    linked = rng.random(nb) < 0.3
    if case == "edge_run":
        # run over blocks 9..14: devices 1 and 2, peak on device 1
        linked[9] = False
        linked[10:15] = True
        linked[15] = False
        bmax[10] = 100.0
    else:
        # run over blocks 4..15: devices 0, 1 (whole) and 2, peak on 0
        linked[4] = False
        linked[5:16] = True
        linked[16] = False
        bmax[4] = 100.0
    linked[0] = False
    starts = np.nonzero(~linked)[0]
    run_of = np.cumsum(~linked) - 1
    want = np.maximum.reduceat(bmax, starts)[run_of]

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))

    def body(b, lk):
        me = jax.lax.axis_index("data")
        return run_max_across_devices(b, lk, "data", n_dev, me)

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("data"),) * 2,
                               out_specs=P("data"), check_vma=False))
    got = np.asarray(fn(jnp.asarray(bmax), jnp.asarray(linked)))
    assert np.array_equal(got, want)
