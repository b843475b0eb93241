"""CLI smoke tests (host backend; drives the argparse surface)."""

import io
import sys

import numpy as np
import pytest

from kmer_spans.cli import main
from kmer_spans.io.fasta import write_fasta


@pytest.fixture()
def fasta(tmp_path, golden):
    p = tmp_path / "g.fa"
    write_fasta(p, [("chr1", golden)])
    return str(p)


def _run(argv, capsys):
    main(argv)
    return capsys.readouterr()


def test_cli_spans(fasta, capsys):
    out = _run(
        ["spans", fasta, "-k", "8", "--backend", "host",
         "--min-width", "100", "--min-score", "20"],
        capsys,
    )
    lines = [l for l in out.out.strip().splitlines() if l]
    assert lines[0] == "seq\tbeg\tend\tscore"
    assert len(lines) == 4  # header + 3 golden regions
    assert lines[1].startswith("chr1\t20008\t20600\t137.923657")


def test_cli_count_json(fasta, capsys):
    out = _run(["count", fasta, "-k", "2", "--backend", "host"], capsys)
    import json

    data = json.loads(out.out)
    assert data["k"] == 2 and data["n"] > 0


def test_cli_count_spectrum_file(fasta, tmp_path, capsys):
    out_bin = str(tmp_path / "spec.bin")
    _run(["count", fasta, "-k", "8", "--backend", "host", "--out", out_bin],
         capsys)
    from kmer_spans.io.spectrum_file import read_kmers
    from kmer_spans.utils.testgen import spectrum_checksum

    back = read_kmers(out_bin)
    assert back["k"] == [8]
    assert spectrum_checksum(back["counts"][0]) == 6585132732039205817


def test_cli_windows(fasta, capsys):
    out = _run(
        ["windows", fasta, "--kmers", "CG,AT", "--window", "200", "--counts"],
        capsys,
    )
    lines = out.out.strip().splitlines()
    assert lines[0] == "count\tCG\tAT"
    assert len(lines) > 2


def test_cli_kmers(capsys):
    out = _run(["kmers", "-k", "2"], capsys)
    ks = out.out.strip().splitlines()
    assert ks[:4] == ["AA", "AC", "AT", "AG"] and len(ks) == 16


def test_cli_regions(fasta, tmp_path, capsys):
    from kmer_spans.encoding import all_kmers

    scores = tmp_path / "scores.tsv"
    with open(scores, "w") as fh:
        for km in all_kmers(2):
            fh.write(f"{km}\t{3.0 if km == 'AG' else -1.0}\n")
    out = _run(
        ["regions", fasta, "-k", "2", "--backend", "host",
         "--scores", str(scores), "--min-width", "50", "--min-score", "20"],
        capsys,
    )
    lines = out.out.strip().splitlines()
    assert lines[0] == "seq\tbeg\tend\tscore"
    assert any("20" in l for l in lines[1:])  # finds the AG island


def test_cli_stream(fasta, capsys, tmp_path):
    out = _run(
        ["stream", fasta, "-k", "8", "--chunk", "32768", "--block", "512",
         "--cand-blocks", "32", "--min-width", "100", "--min-score", "20",
         "--checkpoint", str(tmp_path / "ck.npz"), "--metrics"],
        capsys,
    )
    lines = [l for l in out.out.strip().splitlines() if l]
    assert lines[0] == "seq\tbeg\tend\tscore"
    assert len(lines) == 4  # 3 golden regions through the streamed path
    assert lines[1].startswith("chr1\t20008\t20600\t137.92")
    assert "unresolved" in out.err and "phases" in out.err


def test_cli_spans_threshold_scoring(fasta, capsys):
    out = _run(
        ["spans", fasta, "-k", "8", "--backend", "host",
         "--scoring", "threshold", "--f-t", "0.0001",
         "--min-width", "100", "--min-score", "50"],
        capsys,
    )
    lines = out.out.strip().splitlines()
    assert lines[1].startswith("chr1\t20008\t20600")


def test_cli_stream_multi_scaffold(tmp_path, golden, capsys):
    # spectrum must accumulate across scaffolds before scanning (reference
    # kmer_low_comp_regions semantics): splitting the golden genome into
    # two scaffolds away from the islands preserves the three regions
    from kmer_spans.io.fasta import write_fasta

    fa = tmp_path / "multi.fa"
    write_fasta(fa, [("s1", golden[:40_000]), ("s2", golden[40_000:])])
    out = _run(
        ["stream", str(fa), "-k", "8", "--chunk", "16384", "--block", "512",
         "--cand-blocks", "32", "--min-width", "100", "--min-score", "20"],
        capsys,
    )
    lines = [l for l in out.out.strip().splitlines() if l]
    assert len(lines) == 4
    assert lines[1].startswith("s1\t20008\t20600")
    assert lines[2].startswith("s2\t10008\t10900")  # 50008-40000
    assert lines[3].startswith("s2\t40007\t40400")


def test_cli_lr(tmp_path, capsys):
    from kmer_spans.encoding import all_kmers
    from kmer_spans.io.fasta import write_fasta

    fa = tmp_path / "cpg.fa"
    write_fasta(fa, [("s", "ATATATATCGCGCGCGCGCGATATATATATATATATCGCGCG")])
    scores = tmp_path / "lr.tsv"
    with open(scores, "w") as fh:
        for km in all_kmers(2):
            seed = 2.0 if km == "CG" else -1.0
            trans = 2.0 if km == "CG" else -0.5
            fh.write(f"{km}\t{seed}\t{trans}\n")
    out = _run(
        ["lr", str(fa), "-k", "2", "--backend", "host",
         "--scores", str(scores), "--min-length", "4"],
        capsys,
    )
    lines = out.out.strip().splitlines()
    assert lines[1].startswith("s\t10\t20\t9.5")
