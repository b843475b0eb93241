"""Auxiliary subsystems: config, metrics, checkpoints, resume."""

import json
import logging
import pathlib
import re

import numpy as np
import pytest

from kmer_spans.config import SpanConfig
from kmer_spans.io.checkpoint import (
    SPECTRUM_FORMAT,
    StreamCheckpoint,
    load_spectrum_sharded,
    save_spectrum_sharded,
)
from kmer_spans.utils.metrics import Metrics


def test_config_validation():
    SpanConfig(k=8).validate()
    with pytest.raises(ValueError):
        SpanConfig(k=0).validate()
    with pytest.raises(ValueError):
        SpanConfig(thr=1.5).validate()
    with pytest.raises(ValueError):
        SpanConfig(chunk_bases=1000, block=512).validate()


def test_metrics_phases(caplog):
    m = Metrics()
    with caplog.at_level(logging.INFO, logger="kmer_spans"):
        with m.phase("count", bases=1000):
            pass
    s = m.summary()
    assert s["phases"][0]["name"] == "count"
    assert s["phases"][0]["bases"] == 1000
    assert "phase=count" in caplog.text


def test_spectrum_sharded_roundtrip(tmp_path):
    counts = np.arange(4**6, dtype=np.int64)
    save_spectrum_sharded(str(tmp_path / "ck"), counts, 6, n_shards=7)
    back, k = load_spectrum_sharded(str(tmp_path / "ck"))
    assert k == 6 and (back == counts).all()


def _former_package_name():
    """The package's former name, as the README's origin paragraph
    gives it."""
    readme = pathlib.Path(__file__).resolve().parents[1] / "README.md"
    m = re.search(r"as the package\s+`(kmer_spans_\w+)`", readme.read_text())
    assert m, "README names no former package"
    return m.group(1)


@pytest.mark.parametrize("fmt,loads", [
    ("current", True),
    ("former", True),
    ("other.spectrum.v1", False),
    ("kmer_spans.spectrum.v2", False),
])
def test_spectrum_sharded_manifest_format(tmp_path, fmt, loads):
    """Manifests written before the package rename still load; other
    formats are refused."""
    counts = np.arange(4**5, dtype=np.int64)
    d = tmp_path / "ck"
    save_spectrum_sharded(str(d), counts, 5, n_shards=3)
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["format"] == SPECTRUM_FORMAT
    if fmt == "former":
        manifest["format"] = _former_package_name() + ".spectrum.v1"
    elif fmt != "current":
        manifest["format"] = fmt
    (d / "manifest.json").write_text(json.dumps(manifest))
    if loads:
        back, k = load_spectrum_sharded(str(d))
        assert k == 5 and (back == counts).all()
    else:
        with pytest.raises(ValueError, match="not a kmer_spans"):
            load_spectrum_sharded(str(d))


def test_stream_checkpoint_roundtrip(tmp_path):
    ck = StreamCheckpoint(
        chunk_idx=3, x_in=12, halo_bytes=b"\x01\x02\x03",
        open_start=12345, open_s=np.array([0.1, -0.2]),
        open_scored=np.array([True, False]),
        regions=[(0, 10, 20, 5.5)],
    )
    p = str(tmp_path / "ck.npz")
    ck.save(p)
    back = StreamCheckpoint.load(p)
    assert back.chunk_idx == 3 and back.open_start == 12345
    assert back.halo_bytes == b"\x01\x02\x03"
    np.testing.assert_array_equal(back.open_s, ck.open_s)
    assert back.regions == [(0, 10, 20, 5.5)]


def test_stream_resume_matches_uninterrupted(tmp_path):
    """Kill-and-resume at chunk granularity reproduces the full run."""
    from conftest import random_seq
    from kmer_spans.encoding import pack
    from kmer_spans.parallel.stream import StreamingSpanPipeline

    rng = np.random.default_rng(4)
    seq = random_seq(rng, 30_000)
    s = list(seq)
    s[7900:8600] = "AG" * 350
    s[20000:20700] = "CT" * 350
    seq = "".join(s)
    p = pack(seq)
    nb = p.bases.copy()
    nb[~p.valid] = 4

    def chunks():
        for i in range(0, len(nb), 8192):
            yield nb[i : i + 8192]

    def mk():
        return StreamingSpanPipeline(
            4, chunk_bases=8192, block=512, cand_blocks=32, margin_blocks=4
        )

    full = mk().run(chunks, 0.75, 30, 5.0)

    ckpt = str(tmp_path / "stream.npz")
    # simulated mid-scan crash after chunk 1 (count pass completed first,
    # as in a real run — the spectrum must match the resumed run's)
    mk().run(chunks, 0.75, 30, 5.0, checkpoint_path=ckpt,
             stop_after_chunk=1)
    resumed = mk().run(
        chunks, 0.75, 30, 5.0, checkpoint_path=ckpt, resume=True
    )
    assert sorted(resumed.regions) == sorted(full.regions)
    assert resumed.unresolved == full.unresolved


def test_multihost_initialize_noop_single_process():
    from kmer_spans.parallel.multihost import (
        global_data_mesh,
        initialize,
    )

    # single-process env: no coordinator vars -> no-op
    assert initialize() is False
    mesh = global_data_mesh()
    assert mesh.devices.size >= 1
