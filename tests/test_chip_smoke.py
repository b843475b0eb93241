"""chip_smoke.py on the CPU: its GPU guard, genome synthesis and the
oracle comparison it relies on (its phases themselves need a GPU)."""

import importlib.util
import pathlib

import numpy as np
import pytest

_PATH = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_smoke_refuses_cpu(monkeypatch, tmp_path, capsys, argv):
    """No GPU: exit before any phase, and no contract line."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(SystemExit, match="no GPU"):
        smoke.main(argv)
    assert '"ok"' not in capsys.readouterr().out


def test_genome_plants_islands_and_gaps():
    n = 1 << 18
    nb = smoke.genome(n, 3)
    period = smoke.island_period(n)
    assert nb.shape == (n,) and nb.dtype == np.uint8
    for j, base in enumerate(range(period // 2, n - 8000, period)):
        unit, reps = smoke._ISLANDS[j % len(smoke._ISLANDS)]
        want = np.tile(np.array(unit, np.uint8), reps)
        assert np.array_equal(nb[base:base + want.shape[0]], want)
    assert (nb == 4).any() and nb.max() == 4
    assert np.array_equal(smoke.genome(n, 3), nb)


def test_split_covers_genome_unequally():
    nb = smoke.genome(1 << 18, 4)
    parts = smoke.split(nb, 3)
    assert len(parts) == 3
    assert np.array_equal(np.concatenate(parts), nb)
    assert len({p.shape[0] for p in parts}) > 1


def test_same_regions_compares_score_bits():
    a = [(0, 10, 200, 25.5)]
    assert smoke.same_regions("x", a, list(a)) == 1
    b = [(0, 10, 200, float(np.nextafter(25.5, 30.0)))]
    with pytest.raises(AssertionError, match="only in result"):
        smoke.same_regions("x", b, a)


@pytest.mark.parametrize("k", [8, 12])
def test_pipeline_under_api_matches_oracle(k):
    """The pipeline the smoke calls under kmer_low_comp_regions equals
    the native oracle it compares with, with no fallback, at a tiny
    size (class screen at k=8, pm pipeline at k=12)."""
    scaffolds = smoke.split(smoke.genome(1 << 18, 5), 2)
    got, fallback = smoke.rank_pipeline_under(scaffolds, k)
    assert not fallback
    want = smoke.oracle_rank_regions(scaffolds, k)
    assert smoke.same_regions(f"k={k}", got, want) > 0
