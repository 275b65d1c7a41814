"""Fast-tier engine smokes: one small case per engine surface that runs on
the CPU.  The bit-parallel CUDA kernel's surface is its host side, covered in
``test_bitpal.py``; the kernel itself runs in ``tests_gpu/``."""

import numpy as np
import pytest

from tpualign.config import AlignMode, EngineConfig, ScoringConfig
from tpualign import matrices
from tpualign.ops import oracle

MAT = matrices.dna(2, -1, -3)


def pair(m, n, seed):
    r = np.random.default_rng(seed)
    return (r.integers(1, 5, m).astype(np.int8),
            r.integers(1, 5, n).astype(np.int8))


def cfg_of(name):
    return {
        "nw": ScoringConfig(match=2, mismatch=-1, gap=-2),
        "sw": ScoringConfig(match=2, mismatch=-1, gap=-2,
                            mode=AlignMode.LOCAL),
        "sg": ScoringConfig(match=2, mismatch=-1, gap=-2,
                            mode=AlignMode.SEMIGLOBAL),
        "infix": ScoringConfig(match=2, mismatch=-1, gap=-2,
                               mode=AlignMode.INFIX),
        "mat": ScoringConfig(gap=-2, matrix=MAT),
        "mat-sg": ScoringConfig(gap=-2, matrix=MAT,
                                mode=AlignMode.SEMIGLOBAL),
        "affine": ScoringConfig(match=2, mismatch=-1, gap_open=-5,
                                gap_extend=-2),
        "affine-sg": ScoringConfig(match=2, mismatch=-1, gap_open=-5,
                                   gap_extend=-2,
                                   mode=AlignMode.SEMIGLOBAL),
    }[name]


def test_affine_xla_small():
    # Gotoh scoring + Myers-Miller alignment, portable scans
    from tpualign.ops import affine_align, xla

    cfg = cfg_of("affine")
    s1, s2 = pair(140, 120, 23)
    want = oracle.score(s1, s2, cfg)
    assert xla.score(s1, s2, cfg) == want
    sc, a1, a2 = affine_align.align(s1, s2, cfg)
    assert sc == want
    assert oracle.alignment_score(a1, a2, cfg) == sc


@pytest.mark.parametrize(
    "name", ["nw", "sw", "sg", "infix", "mat", "mat-sg", "affine",
             "affine-sg"])
def test_xla_small(name):
    # the XLA row scan serves every config: one small case each
    from tpualign.ops import xla

    cfg = cfg_of(name)
    s1, s2 = pair(50, 40, hash(name) % 1000)
    assert xla.score(s1, s2, cfg) == oracle.score(s1, s2, cfg)


@pytest.mark.parametrize("name", ["nw", "sw", "affine"])
def test_batch_small(name):
    # pair-scored global/local batches: one vmapped dispatch
    from tpualign.api import align_score_batch

    cfg = cfg_of(name)
    texts, queries = zip(*(pair(30 + i, 25 - i, 40 + i) for i in range(3)))
    got = align_score_batch(list(texts), list(queries), cfg)
    want = [oracle.score(t, q, cfg) for t, q in zip(texts, queries)]
    assert got.tolist() == want


def test_strips_small():
    # the sharded row scan on a 2-device mesh
    from tpualign.parallel import strips
    from tpualign.parallel.mesh import make_mesh

    cfg = cfg_of("sw")
    s1, s2 = pair(120, 40, 11)
    got = strips.score(s1, s2, cfg, mesh=make_mesh(2), chunk_rows=16)
    assert got == oracle.score(s1, s2, cfg)


def test_explicit_engines_agree():
    from tpualign.api import align_score

    s1, s2 = pair(70, 60, 29)
    cfg = cfg_of("nw")
    want = oracle.score(s1, s2, cfg)
    for impl in ("xla", "oracle", "strips"):
        got = align_score(s1, s2, cfg, EngineConfig(impl=impl, chunk_rows=16))
        assert got == want, impl
