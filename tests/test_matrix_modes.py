"""Round-4 capabilities: substitution matrices and ends-free modes.

The reference scores with two compiled-in constants and supports global
mode only (``needleman-wunsch.hpp:11-13``, ``serial.cpp:16-31``); matrices,
semiglobal, and infix are beyond-parity capabilities.  Oracle semantics are
pinned by cross-checking three independent implementations (NumPy oracle,
XLA scan, native C++), plus walk validity re-scoring.
"""

import numpy as np
import pytest

from tpualign import matrices
from tpualign.config import AlignMode, ScoringConfig, ensure_pair_modes
from tpualign.ops import ends_free, oracle, xla
from tpualign.utils import native

MAT = matrices.dna(2, -1, -3)
MODES = list(AlignMode)


def _cfg(mode, mat, affine):
    kw = dict(mode=mode, matrix=mat, gap=-2)
    if mat is None:
        kw.update(match=2, mismatch=-1)
    if affine:
        kw.update(gap_open=-4, gap_extend=-2)
    return ScoringConfig(**kw)


ALL_CFGS = [
    _cfg(mode, mat, affine)
    for mode in MODES
    for mat in (None, MAT)
    for affine in (False, True)
]
NEW_CFGS = [c for c in ALL_CFGS if c.has_matrix or c.is_ends_free]


def test_matrix_validation():
    with pytest.raises(TypeError):
        ScoringConfig(matrix=[[1, 0], [0, 1]])  # list: not hashable
    with pytest.raises(TypeError):
        ScoringConfig(matrix=((1, 0), (0,)))  # ragged
    with pytest.raises(TypeError):
        ScoringConfig(matrix=((1.0, 0.0), (0.0, 1.0)))  # floats
    m = matrices.uniform(3, -1, size=5)
    assert ScoringConfig(matrix=m).sub_score(1, 1) == 3
    assert ScoringConfig(matrix=m).sub_score(1, 2) == -1


def test_matrices_helpers():
    m = matrices.dna(1, 0, -1)
    # transitions: A<->G, T<->C
    assert m[1][3] == 0 and m[3][1] == 0 and m[2][4] == 0
    assert m[1][2] == -1 and m[1][1] == 1
    assert matrices.parse("dna:1,0,-1") == m
    assert matrices.parse("1,0/0,1") == ((1, 0), (0, 1))
    with pytest.raises(ValueError):
        matrices.parse("1,0/0")


def test_uniform_matrix_equals_pair_scoring():
    rng = np.random.default_rng(0)
    u = matrices.uniform(2, -1)
    for _ in range(5):
        s1 = rng.integers(1, 5, 30).astype(np.int8)
        s2 = rng.integers(1, 5, 33).astype(np.int8)
        for mode in MODES:
            pair = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=mode)
            mat = ScoringConfig(gap=-2, matrix=u, mode=mode)
            assert oracle.score(s1, s2, pair) == oracle.score(s1, s2, mat)


@pytest.mark.parametrize("cfg", ALL_CFGS, ids=lambda c: (
    f"{c.mode.value}-{'mat' if c.has_matrix else 'pair'}-"
    f"{'aff' if c.is_affine else 'lin'}"))
def test_oracle_vs_native_fuzz(cfg):
    if not native.available():
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(hash(cfg.mode.value) % 2**32)
    for _ in range(6):
        m, n = rng.integers(0, 40, 2)
        s1 = rng.integers(1, 5, m).astype(np.int8)
        s2 = rng.integers(1, 5, n).astype(np.int8)
        assert oracle.score(s1, s2, cfg) == native.score(s1, s2, cfg)


@pytest.mark.parametrize("cfg", NEW_CFGS, ids=lambda c: (
    f"{c.mode.value}-{'mat' if c.has_matrix else 'pair'}-"
    f"{'aff' if c.is_affine else 'lin'}"))
def test_oracle_vs_xla(cfg):
    rng = np.random.default_rng(7)
    s1 = rng.integers(1, 5, 33).astype(np.int8)
    s2 = rng.integers(1, 5, 47).astype(np.int8)
    for _ in range(4):  # several draws per compiled cfg
        assert oracle.score(s1, s2, cfg) == xla.score(s1, s2, cfg)
        s1 = rng.integers(1, 5, 33).astype(np.int8)
        s2 = rng.integers(1, 5, 47).astype(np.int8)


@pytest.mark.parametrize("cfg", NEW_CFGS, ids=lambda c: (
    f"{c.mode.value}-{'mat' if c.has_matrix else 'pair'}-"
    f"{'aff' if c.is_affine else 'lin'}"))
def test_traceback_validity(cfg):
    rng = np.random.default_rng(11)
    gcfg = cfg.with_mode(AlignMode.GLOBAL)
    for _ in range(6):
        u = rng.integers(1, 5, rng.integers(0, 30)).astype(np.int8)
        v = rng.integers(1, 5, rng.integers(0, 30)).astype(np.int8)
        sc, a1, a2 = oracle.traceback(u, v, cfg)
        assert sc == oracle.score(u, v, cfg)
        # the aligned core re-scores to the reported score (ends-free and
        # local costs outside the core are zero by definition)
        if cfg.mode is AlignMode.GLOBAL:
            assert oracle.alignment_score(a1, a2, gcfg) == sc
        else:
            assert oracle.alignment_score(a1, a2, gcfg) == sc or (
                a1 == "" and sc == 0)


def test_ends_free_empty_sequences():
    e = np.zeros(0, np.int8)
    s = np.asarray([1, 2, 3], np.int8)
    sg = ScoringConfig(match=2, mismatch=-1, gap=-2,
                       mode=AlignMode.SEMIGLOBAL)
    ix = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.INFIX)
    for cfg in (sg, ix):
        assert oracle.score(e, e, cfg) == xla.score(e, e, cfg) == 0
    assert oracle.score(s, e, sg) == xla.score(s, e, sg) == 0
    assert oracle.score(e, s, sg) == xla.score(e, s, sg) == 0
    # infix: empty query is free; empty text forces an all-gap query
    assert oracle.score(s, e, ix) == xla.score(s, e, ix) == 0
    assert oracle.score(e, s, ix) == xla.score(e, s, ix) == -6


@pytest.mark.parametrize("mode", [AlignMode.LOCAL, AlignMode.SEMIGLOBAL,
                                  AlignMode.INFIX])
@pytest.mark.parametrize("mat", [None, MAT], ids=["pair", "mat"])
def test_locate_flex_matches_oracle(mode, mat):
    if not native.available():
        pytest.skip("no native toolchain")
    kw = dict(mode=mode, matrix=mat, gap=-2)
    if mat is None:
        kw.update(match=2, mismatch=-1)
    cfg = ScoringConfig(**kw)
    rng = np.random.default_rng(13)
    for _ in range(20):
        u = rng.integers(1, 5, rng.integers(1, 50)).astype(np.int8)
        v = rng.integers(1, 5, rng.integers(1, 50)).astype(np.int8)
        sc, ie, je = native.locate_flex(u, v, cfg)
        assert sc == oracle.score(u, v, cfg)
        # the reported end cell really scores sc in the full table
        H = oracle.score_table(u, v, cfg)
        assert H[ie, je] == sc


@pytest.mark.parametrize("mode", [AlignMode.GLOBAL, AlignMode.LOCAL,
                                  AlignMode.SEMIGLOBAL, AlignMode.INFIX])
@pytest.mark.parametrize("mat", [None, MAT], ids=["pair", "mat"])
def test_align_large_reduction(mode, mat, monkeypatch):
    """Force the locate + core reduction on small inputs and check it
    reproduces the oracle score with a valid core alignment."""
    if not native.available():
        pytest.skip("no native toolchain")
    kw = dict(mode=mode, matrix=mat, gap=-2)
    if mat is None:
        kw.update(match=2, mismatch=-1)
    cfg = ScoringConfig(**kw)
    if mode is AlignMode.GLOBAL and mat is None:
        pytest.skip("pair-global rides the classic engines, not ends_free")
    monkeypatch.setattr(ends_free, "LEAF_CELLS", 0)
    rng = np.random.default_rng(17)
    gcfg = cfg.with_mode(AlignMode.GLOBAL)
    for _ in range(10):
        u = rng.integers(1, 5, rng.integers(1, 45)).astype(np.int8)
        v = rng.integers(1, 5, rng.integers(1, 45)).astype(np.int8)
        want = oracle.score(u, v, cfg)
        sc, a1, a2 = ends_free.align_large(u, v, cfg)
        assert sc == want
        if a1 or a2:
            assert oracle.alignment_score(a1, a2, gcfg) == sc


def test_engine_guards():
    # the pair-only engines refuse the matrix / ends-free shapes, and the
    # bit-parallel family excludes them
    from tpualign.ops import bitpal

    for cfg in NEW_CFGS[:4]:
        with pytest.raises(ValueError):
            ensure_pair_modes(cfg, "x")
    for cfg in NEW_CFGS:
        assert bitpal.family(cfg) is None


def test_api_dispatch_new_modes():
    from tpualign import api

    rng = np.random.default_rng(23)
    s1 = rng.integers(1, 5, 40).astype(np.int8)
    s2 = rng.integers(1, 5, 44).astype(np.int8)
    for cfg in NEW_CFGS[:6]:
        want = oracle.score(s1, s2, cfg)
        assert api.align_score(s1, s2, cfg) == want
        sc, a1, a2 = api.align(s1, s2, cfg)
        assert sc == want
    # batch serving falls back to correct per-pair scoring
    cfg = ScoringConfig(gap=-2, matrix=MAT, mode=AlignMode.SEMIGLOBAL)
    out = api.align_score_batch([s1, s2], [s2, s1[:10]], cfg)
    assert out[0] == oracle.score(s1, s2, cfg)
    assert out[1] == oracle.score(s2, s1[:10], cfg)
