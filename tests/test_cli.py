"""CLI surface tests (run on CPU via conftest)."""

import numpy as np
import pytest

from tpualign.cli import main
from tpualign.io.bdna import random_pair, write_bdna


@pytest.fixture
def pair_files(tmp_path):
    s1, s2 = random_pair(60, 55, seed=77)
    p1, p2 = tmp_path / "a.bdna", tmp_path / "b.bdna"
    write_bdna(p1, s1)
    write_bdna(p2, s2)
    return str(p1), str(p2), s1, s2


def test_score(pair_files, capsys):
    p1, p2, s1, s2 = pair_files
    from tpualign.ops import oracle

    assert main(["score", p1, p2, "--impl", "xla"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == f"Score: {oracle.score(s1, s2)}"


def test_score_sw(pair_files, capsys):
    p1, p2, s1, s2 = pair_files
    from tpualign.config import AlignMode, ScoringConfig
    from tpualign.ops import oracle

    assert main(["score", p1, p2, "--mode", "sw", "--impl", "oracle"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    want = oracle.score(s1, s2, ScoringConfig(mode=AlignMode.LOCAL))
    assert out[-1] == f"Score: {want}"


def test_align(pair_files, capsys):
    p1, p2, s1, s2 = pair_files
    assert main(["align", p1, p2]) == 0
    out = capsys.readouterr().out
    assert "Score: " in out


def test_align_to_file(pair_files, tmp_path, capsys):
    p1, p2, s1, s2 = pair_files
    out_file = tmp_path / "aln.txt"
    assert main(["align", p1, p2, "--out", str(out_file)]) == 0
    capsys.readouterr()
    a1, a2 = out_file.read_text().splitlines()
    from tpualign.io.bdna import decode

    assert a1.replace("-", "") == decode(s1)
    assert a2.replace("-", "") == decode(s2)


def test_generate_roundtrip(tmp_path, capsys):
    o1, o2 = str(tmp_path / "g1.bdna"), str(tmp_path / "g2.bdna")
    assert main(["generate", o1, o2, "--lengths", "100", "120"]) == 0
    capsys.readouterr()
    from tpualign.io.bdna import read_bdna

    assert read_bdna(o1).size == 100
    assert read_bdna(o2).size == 120


def test_info(capsys):
    assert main(["info"]) == 0
    assert "backend" in capsys.readouterr().out


def test_bench_infix_no_swap(tmp_path, capsys):
    """Regression: the bench's longer-first pair swap
    must not fire for orientation-asymmetric configs — infix(s1, s2) and
    infix(s2, s1) are different problems, and the swapped row tripped the
    bench's own native gate on the 64gb corpus pair."""
    from tpualign.config import AlignMode, ScoringConfig
    from tpualign.ops import oracle

    s1, s2 = random_pair(48, 90, seed=3)  # s2 longer: the swap would fire
    d = tmp_path / "c"
    d.mkdir()
    write_bdna(d / "x-1.bdna", s1)
    write_bdna(d / "x-2.bdna", s2)
    tsv = tmp_path / "out.tsv"
    assert main([
        "bench", "--pairs", "x", "--corpus", str(d), "--impl", "xla",
        "--mode", "infix", "--match", "2", "--mismatch", "-1", "--gap",
        "-2", "--runs", "1", "--tsv", str(tsv),
    ]) == 0
    capsys.readouterr()
    row = tsv.read_text().strip().splitlines()[-1].split("\t")
    want = oracle.score(
        s1, s2,
        ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.INFIX),
    )
    assert int(row[-1]) == want
