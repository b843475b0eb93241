import numpy as np
import pytest

from kmer_spans.encoding import (
    MAX_K,
    PackedSeq,
    all_kmers,
    code_to_kmer,
    kmer_codes_np,
    kmer_to_code,
    pack,
)


def test_two_bit_map():
    # A=0, C=1, T=2, G=3 (reference src/kmer_spans.c:6-41)
    assert [kmer_to_code(c) for c in "ACTG"] == [0, 1, 2, 3]
    # case-insensitive by construction
    assert [kmer_to_code(c) for c in "actg"] == [0, 1, 2, 3]


def test_k2_index_order():
    # SURVEY.md §2.1 probe-verified order
    expect = "AA,AC,AT,AG,CA,CC,CT,CG,TA,TC,TT,TG,GA,GC,GT,GG".split(",")
    assert all_kmers(2) == expect


def test_roundtrip():
    for k in (1, 3, 8):
        for code in (0, 1, (1 << (2 * k)) - 1, 5 % (1 << (2 * k))):
            assert kmer_to_code(code_to_kmer(code, k)) == code


def test_pack_n_handling():
    p = pack("ACGTnNacgt")
    assert list(p.valid) == [True] * 4 + [False] * 2 + [True] * 4
    assert list(p.bases[:4]) == [0, 1, 3, 2]
    assert list(p.bases[6:]) == [0, 1, 3, 2]


def test_non_acgtn_bytes_encode():
    # SURVEY.md A.1: W->G, S->C, U->T are silently 2-bit encoded, not skipped
    p = pack("WSU")
    assert p.valid.all()
    assert list(p.bases) == [3, 1, 2]


def test_kmer_codes_end_convention():
    p = pack("ACGT")
    codes, valid = kmer_codes_np(p, 2)
    assert not valid[0] and valid[1:].all()
    assert codes[1] == kmer_to_code("AC")
    assert codes[2] == kmer_to_code("CG")
    assert codes[3] == kmer_to_code("GT")


def test_kmer_codes_n_invalidates_window():
    p = pack("ACNGT")
    codes, valid = kmer_codes_np(p, 2)
    assert list(valid) == [False, True, False, False, True]
