"""Multi-chip pipeline: the flagship count→rank→scan step over a device mesh.

Maps the reference's only parallelism (fork-per-sequence mclapply,
test.R:550-565) onto an SPMD design over a device mesh (SURVEY §5.7-5.8):

  * the genome is sharded contiguously across the ``data`` mesh axis;
  * a k-1-base left halo and a 1-byte right halo ride ``lax.ppermute`` so
    every shard scores exactly the positions the sequential reference would;
  * per-shard partial spectra are ``psum``'d into the replicated 4^k table;
  * weighted ranks use the *integer mass* formulation (stats.ranks
    .cumulative_mass): rank = mass/total with mass an exact int32 cumsum of
    the stably-sorted spectrum — the positive-score test (rank > thr) is an
    exact integer comparison, immune to f32 rounding;
  * the scan recurrence runs as a local max-plus associative scan, then each
    device's total transform (A,B) is all-gathered and composed exclusively
    to produce the incoming scan state — the direct analog of ring/context
    parallelism for this workload.

The jitted step returns (counts, S, scored) — span extraction stays on the
host (exact f64 replay; spans/extract.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.scan import _combine, score_elements


def _rank_mass(counts: jax.Array) -> jax.Array:
    """Exclusive cumulative mass of the stably-sorted spectrum, scattered
    back to k-mer order (device analog of stats.ranks.cumulative_mass).

    rank[kmer] = mass[kmer] / total, with ties broken by k-mer index
    (SURVEY A.2); jnp.argsort is stable by default.
    """
    order = jnp.argsort(counts, stable=True)
    sorted_counts = counts[order]
    excl = jnp.concatenate(
        [jnp.zeros((1,), sorted_counts.dtype), jnp.cumsum(sorted_counts[:-1])]
    )
    mass = jnp.zeros_like(excl).at[order].set(excl)
    return mass


def _shard_step(bases, valid, thr, k: int, axis: str, block: int):
    """Per-device body (inside shard_map): returns (counts, S, scored).

    Compute is 2D-blocked (ops/blocked.py); device-to-device halos ride
    ppermute and seed the first block's halo / last position's scored rule.
    """
    from ..ops.blocked import (
        blocked_codes,
        blocked_scan_prefixes,
        blocked_scored,
    )

    n_dev = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)
    halo = k - 1
    n_local = bases.shape[0]
    nb = n_local // block

    # left halo: previous device's trailing k-1 bases/valid
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    hb = jax.lax.ppermute(bases[-halo:], axis, fwd) if halo else None
    hv = None
    if halo:
        hv = jax.lax.ppermute(valid[-halo:], axis, fwd)
        hv = jnp.where(me == 0, False, hv)  # device 0 has no predecessor
    # right halo: next device's first byte validity (for the scored rule)
    bwd = [((i + 1) % n_dev, i) for i in range(n_dev)]
    nxt_v = jax.lax.ppermute(valid[:1], axis, bwd)[0]
    nxt_v = jnp.where(me == n_dev - 1, False, nxt_v)

    b2 = bases.astype(jnp.int32).reshape(nb, block)
    v2 = valid.reshape(nb, block)
    code, kmer_valid = blocked_codes(b2, v2, k, first_bases=hb, first_valid=hv)
    scored = blocked_scored(v2, kmer_valid, next_valid=nxt_v)
    code = jnp.where(kmer_valid, code, 0)

    # partial spectrum -> replicated via psum
    size = 1 << (2 * k)
    local_counts = jnp.zeros(size, jnp.int32).at[code].add(
        kmer_valid.astype(jnp.int32)
    )
    counts = jax.lax.psum(local_counts, axis)

    # ranks as integer mass; s in f32 (exact-sign by integer comparison)
    mass = _rank_mass(counts)
    total = jnp.sum(counts).astype(jnp.float32)
    pos_mass = mass[code]
    thr_mass = thr * total  # rank > thr  <=>  mass > thr*total
    s = (pos_mass.astype(jnp.float32) - thr_mass) / total

    # local blocked max-plus prefix transforms + cross-device carry
    FA, FB, (tA, tB) = blocked_scan_prefixes(s, scored)
    gA = jax.lax.all_gather(tA, axis)  # [n_dev]
    gB = jax.lax.all_gather(tB, axis)
    cA, cB = jax.lax.associative_scan(_combine, (gA, gB))
    # exclusive: incoming state for device d is the composition of 0..d-1
    S_in = jnp.where(
        me == 0,
        jnp.float32(0),
        jnp.maximum(cA[jnp.maximum(me - 1, 0)], cB[jnp.maximum(me - 1, 0)]),
    )
    S = jnp.maximum(S_in + FA, FB).reshape(-1)
    return counts, S, scored.reshape(-1)


def make_pipeline_step(mesh: Mesh, k: int, axis: str = "data", block: int = 512):
    """Build the jitted multi-chip pipeline step over ``mesh``.

    Returns step(bases u8 [n], valid bool [n], thr f32) ->
    (counts i32 [4^k] replicated, S f32 [n] sharded, scored bool [n] sharded).
    n must be divisible by mesh size * block.
    """
    body = functools.partial(_shard_step, k=k, axis=axis, block=block)
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=(P(), P(axis), P(axis)),
        check_vma=False,
    )

    @jax.jit
    def step(bases, valid, thr):
        return sharded(bases, valid, thr)

    return step


def data_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))
