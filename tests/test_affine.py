"""Affine-gap (Gotoh) scoring — oracle and device engines.

The reference has no affine mode (linear-only, ``needleman-wunsch.hpp:14``);
this capability is pinned against ``slow_gotoh`` below — a deliberately
naive, sequential three-matrix transcription of the textbook recurrences,
sharing no code with the vectorized oracle row (`oracle._affine_row`).
"""

import numpy as np
import pytest

from tpualign.config import AlignMode, EngineConfig, ScoringConfig
from tpualign.io.bdna import random_pair
from tpualign.ops import oracle


NEG = -(1 << 40)


def slow_gotoh(s1, s2, cfg):
    """Textbook Gotoh: gap run of length L costs open + L*ext."""
    M, N = len(s1), len(s2)
    open_, ext = cfg.gap_open, cfg.gap_extend
    local = cfg.is_local
    H = [[0] * (M + 1) for _ in range(N + 1)]
    E = [[NEG] * (M + 1) for _ in range(N + 1)]
    F = [[NEG] * (M + 1) for _ in range(N + 1)]
    if not local:
        for j in range(1, M + 1):
            H[0][j] = open_ + j * ext
        for i in range(1, N + 1):
            H[i][0] = open_ + i * ext
    best = 0
    for i in range(1, N + 1):
        for j in range(1, M + 1):
            sub = cfg.match if s1[j - 1] == s2[i - 1] else cfg.mismatch
            E[i][j] = max(H[i][j - 1] + open_, E[i][j - 1]) + ext
            F[i][j] = max(H[i - 1][j] + open_, F[i - 1][j]) + ext
            h = max(H[i - 1][j - 1] + sub, E[i][j], F[i][j])
            H[i][j] = max(h, 0) if local else h
            best = max(best, H[i][j])
    return best if local else H[N][M]


CFGS = [
    dict(match=2, mismatch=-3, gap_open=-5, gap_extend=-2),
    dict(match=1, mismatch=-1, gap_open=0, gap_extend=-1),  # open=0 edge
    dict(match=3, mismatch=-2, gap_open=-11, gap_extend=-1),
    dict(match=2, mismatch=-1, gap_open=-2, gap_extend=-4),  # ext > open
]


@pytest.mark.parametrize("mode", [AlignMode.GLOBAL, AlignMode.LOCAL])
@pytest.mark.parametrize("weights", CFGS)
def test_oracle_matches_slow_gotoh(mode, weights):
    cfg = ScoringConfig(mode=mode, **weights)
    rng = np.random.default_rng(  # deterministic per (mode, weights) cell
        5000 + 10 * CFGS.index(weights) + (mode is AlignMode.LOCAL))
    for _ in range(6):
        m, n = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
        want = slow_gotoh(list(s1), list(s2), cfg)
        assert oracle.score(s1, s2, cfg) == want
        H = oracle.score_table(s1, s2, cfg)
        got = int(H.max()) if cfg.is_local else int(H[-1, -1])
        assert got == want


def test_affine_open_zero_equals_linear():
    cfg_a = ScoringConfig(match=2, mismatch=-3, gap_open=0, gap_extend=-4)
    cfg_l = ScoringConfig(match=2, mismatch=-3, gap=-4)
    for seed in range(4):
        s1, s2 = random_pair(60, 55, seed=seed)
        assert oracle.score(s1, s2, cfg_a) == oracle.score(s1, s2, cfg_l)


def test_affine_prefers_one_long_gap():
    # classic affine signature: one open+3*ext gap beats three separate
    # gaps under linear scoring with the same total columns
    from tpualign.io.bdna import encode

    s1 = encode("ACGTACGT")
    s2 = encode("ACGT")  # needs 4 gap columns
    cfg = ScoringConfig(match=1, mismatch=-2, gap_open=-3, gap_extend=-1)
    # best: 4 matches + one gap run of 4 -> 4*1 + (-3 + 4*-1) = -3
    assert oracle.score(s1, s2, cfg) == -3
    sc, a1, a2 = oracle.traceback(s1, s2, cfg)
    assert sc == -3
    assert a2.count("-") == 4


@pytest.mark.parametrize("mode", [AlignMode.GLOBAL, AlignMode.LOCAL])
def test_affine_traceback_valid(mode):
    cfg = ScoringConfig(match=2, mismatch=-3, gap_open=-4, gap_extend=-1,
                        mode=mode)
    from tpualign.io.bdna import BASES

    rng = np.random.default_rng(99)
    for _ in range(6):
        m, n = int(rng.integers(2, 35)), int(rng.integers(2, 35))
        s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
        sc, a1, a2 = oracle.traceback(s1, s2, cfg)
        assert sc == oracle.score(s1, s2, cfg)
        assert oracle.alignment_score(a1, a2, cfg) == sc
        if not cfg.is_local:  # gap-stripped strings reproduce the inputs
            assert a1.replace("-", "") == "".join(BASES[c] for c in s1)
            assert a2.replace("-", "") == "".join(BASES[c] for c in s2)


@pytest.mark.parametrize("mode", [AlignMode.GLOBAL, AlignMode.LOCAL])
def test_xla_engine_matches_oracle(mode):
    from tpualign.ops import xla

    cfg = ScoringConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2,
                        mode=mode)
    rng = np.random.default_rng(7)
    for _ in range(5):
        m, n = int(rng.integers(1, 120)), int(rng.integers(1, 120))
        s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
        assert xla.score(s1, s2, cfg) == oracle.score(s1, s2, cfg)


def test_xla_engine_degenerate_lengths():
    from tpualign.ops import xla

    cfg = ScoringConfig(gap_open=-5, gap_extend=-2)
    s1, _ = random_pair(7, 1, seed=0)
    empty = np.asarray([], dtype=np.int8)
    assert xla.score(s1, empty, cfg) == -5 - 2 * 7
    assert xla.score(empty, empty, cfg) == 0


def test_api_dispatch_and_rejections():
    from tpualign import align, align_score
    from tpualign.api import resolve_impl
    from tpualign.config import EngineConfig

    cfg = ScoringConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    assert resolve_impl(EngineConfig(), cfg) == "xla"
    s1, s2 = random_pair(50, 45, seed=3)
    assert align_score(s1, s2, cfg) == oracle.score(s1, s2, cfg)
    # small alignment rides the oracle's Gotoh backtrace
    sc, a1, a2 = align(s1, s2, cfg)
    assert sc == oracle.score(s1, s2, cfg)
    assert oracle.alignment_score(a1, a2, cfg) == sc
    # linear-gap-only engines refuse affine configs instead of silently
    # scoring with cfg.gap
    from tpualign.ops import bitpal

    assert bitpal.family(cfg) is None
    with pytest.raises(ValueError):
        bitpal.score(s1, s2, cfg)


@pytest.mark.parametrize("mode", [AlignMode.GLOBAL, AlignMode.LOCAL])
def test_batch_api_affine_one_dispatch(mode):
    # the vmapped Gotoh batch scan (ragged lengths, incl. degenerate)
    from tpualign import align_score_batch

    cfg = ScoringConfig(match=2, mismatch=-1, gap_open=-4, gap_extend=-1,
                        mode=mode)
    rng = np.random.default_rng(71)
    texts, queries = [], []
    for i in range(6):
        m, n = int(rng.integers(1, 80)), int(rng.integers(1, 70))
        t, q = random_pair(m, n, seed=100 + i)
        texts.append(t)
        queries.append(q)
    texts.append(np.asarray([], np.int8))  # degenerate pair in the batch
    queries.append(queries[0])
    got = align_score_batch(texts, queries, cfg)
    want = [oracle.score(t, q, cfg) for t, q in zip(texts, queries)]
    assert got.tolist() == want


@pytest.mark.parametrize("mode", [AlignMode.GLOBAL, AlignMode.LOCAL],
                         ids=["nw", "sw"])
def test_affine_matrix_align(mode):
    # round 5: Myers-Miller / locate-anchor with matrix substitutions
    from tpualign.matrices import dna
    from tpualign.ops import affine_align
    from tpualign.utils import native

    cfg = ScoringConfig(gap=-2, matrix=dna(2, -1, -3), gap_open=-5,
                        gap_extend=-2, mode=mode)
    s1, s2 = random_pair(120, 100, seed=5)
    if mode is AlignMode.GLOBAL:
        sc, a1, a2 = affine_align.align(s1, s2, cfg)
    else:
        sc, a1, a2 = affine_align.align_local(s1, s2, cfg)
    want = oracle.score(s1, s2, cfg)
    assert sc == want
    if native.available():
        assert native.score(s1, s2, cfg) == want
    gcfg = cfg.with_mode(AlignMode.GLOBAL)
    assert oracle.alignment_score(a1, a2, gcfg) == sc


@pytest.mark.parametrize("mode", [AlignMode.SEMIGLOBAL, AlignMode.INFIX],
                         ids=["sg", "infix"])
@pytest.mark.parametrize("mat", [False, True], ids=["pair", "mat"])
def test_affine_ends_free_align_large(mode, mat, monkeypatch):
    # round 5: the full affine ends-free reduction (locate + anchored
    # locate + Myers-Miller core) — was a ValueError through round 4
    from tpualign.matrices import dna
    from tpualign.ops import ends_free
    from tpualign.utils import native

    monkeypatch.setattr(ends_free, "LEAF_CELLS", 500)
    kw = dict(mode=mode, gap_open=-5, gap_extend=-2, gap=-2)
    if mat:
        kw["matrix"] = dna(2, -1, -3)
    else:
        kw.update(match=2, mismatch=-1)
    cfg = ScoringConfig(**kw)
    s1, s2 = random_pair(80, 70, seed=31)
    sc, a1, a2 = ends_free.align_large(s1, s2, cfg, EngineConfig())
    want = oracle.score(s1, s2, cfg)
    assert sc == want
    if native.available():
        assert native.score(s1, s2, cfg) == want
    if a1:
        gcfg = cfg.with_mode(AlignMode.GLOBAL)
        assert oracle.alignment_score(a1, a2, gcfg) == sc


@pytest.mark.parametrize("shape", ["matrix", "sg", "infix"])
def test_batch_api_affine_pair_modes(shape):
    # regression (ADVICE r4, high): affine + matrix / ends-free batches
    # must NOT take the match/mismatch-global/local vmapped shortcut —
    # they fall through to the per-pair loop and score exactly
    from tpualign import align_score_batch
    from tpualign.matrices import dna

    kw = dict(gap_open=-5, gap_extend=-2)
    if shape == "matrix":
        kw["matrix"] = dna(2, -1, -3)
    else:
        kw["mode"] = AlignMode.SEMIGLOBAL if shape == "sg" else AlignMode.INFIX
        kw.update(match=2, mismatch=-1)
    cfg = ScoringConfig(**kw)
    texts, queries = [], []
    for i in range(3):
        t, q = random_pair(40 + i, 35 + 2 * i, seed=500 + i)
        texts.append(t)
        queries.append(q)
    got = align_score_batch(texts, queries, cfg)
    want = [oracle.score(t, q, cfg) for t, q in zip(texts, queries)]
    assert got.tolist() == want


def _check_alignment(s1, s2, cfg, sc, a1, a2):
    from tpualign.io.bdna import BASES

    assert sc == oracle.score(s1, s2, cfg)
    assert oracle.alignment_score(a1, a2, cfg) == sc
    assert a1.replace("-", "") == "".join(BASES[c] for c in s1)
    assert a2.replace("-", "") == "".join(BASES[c] for c in s2)


def test_myers_miller_base_solver_fuzz():
    from tpualign.ops import affine_align

    cfg = ScoringConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    rng = np.random.default_rng(11)
    for _ in range(8):
        m, n = int(rng.integers(1, 60)), int(rng.integers(1, 60))
        s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
        sc, a1, a2 = affine_align.align(s1, s2, cfg)
        _check_alignment(s1, s2, cfg, sc, a1, a2)


def test_myers_miller_recursion_fuzz(monkeypatch):
    # tiny base forces the bisection (incl. the F-case gap-spanning split
    # and the tb/te edge waivers) on oracle-checkable sizes
    from tpualign.ops import affine_align

    monkeypatch.setattr(affine_align, "BASE_CELLS", 256)
    rng = np.random.default_rng(12)
    for weights in CFGS:
        cfg = ScoringConfig(**weights)
        for _ in range(6):
            m, n = int(rng.integers(2, 70)), int(rng.integers(4, 70))
            s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
            sc, a1, a2 = affine_align.align(s1, s2, cfg)
            _check_alignment(s1, s2, cfg, sc, a1, a2)


def test_myers_miller_long_insertion(monkeypatch):
    # a long vertical gap spanning many split boundaries exercises the
    # F-case at several recursion levels
    from tpualign.ops import affine_align

    monkeypatch.setattr(affine_align, "BASE_CELLS", 256)
    cfg = ScoringConfig(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    s1a, ins = random_pair(40, 60, seed=77)
    s1 = np.asarray(s1a)
    s2 = np.concatenate([s1[:20], np.asarray(ins), s1[20:]]).astype(np.int8)
    sc, a1, a2 = affine_align.align(s1, s2, cfg)
    _check_alignment(s1, s2, cfg, sc, a1, a2)
    # the insertion should surface as one affine run, not fragments
    assert "-" * 40 in a1


def test_myers_miller_device_scan_path():
    # big enough that the default BASE_CELLS routes through the bucketed
    # jitted (H, F) scans at least one level deep
    from tpualign.ops import affine_align

    cfg = ScoringConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    s1, s2 = random_pair(1400, 1500, seed=5)
    sc, a1, a2 = affine_align.align(s1, s2, cfg)
    _check_alignment(s1, s2, cfg, sc, a1, a2)


def test_myers_miller_waived_edges_empty_rows(monkeypatch):
    # regression (review r3): with BOTH edge waivers active (tb=te=0, as a
    # right-of-F-case child under a waived ancestor edge gets) and an empty
    # s2 block, the te refund used to fabricate end_f > H from the F init
    # row and start the backtrace in state F with nothing to emit
    from tpualign.io.bdna import encode
    from tpualign.ops import affine_align

    cfg = ScoringConfig(match=1, mismatch=-1, gap_open=-3, gap_extend=-1)
    s1 = encode("AAAA")
    sc, a1, a2 = affine_align._base_align(
        s1, np.asarray([], np.int32), cfg, 0, 0)
    assert (sc, a1, a2) == (cfg.gap_open + 4 * cfg.gap_extend, "AAAA",
                            "----")
    # the reviewer's recursion repro: tiny base + waived edges end-to-end
    monkeypatch.setattr(affine_align, "BASE_CELLS", 1)
    out1, out2 = [], []
    got = affine_align._solve(s1, encode("CC"), cfg, 0, 0, out1, out2)
    a1j, a2j = "".join(out1), "".join(out2)
    assert oracle.alignment_score(a1j, a2j, cfg) <= 0  # valid strings
    assert a1j.replace("-", "") == "AAAA" and a2j.replace("-", "") == "CC"
    assert isinstance(got, int)


def test_api_large_affine_alignment(monkeypatch):
    # api.align routes large affine problems to the Myers-Miller engine
    from tpualign import api

    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 1000)
    cfg = ScoringConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    s1, s2 = random_pair(80, 75, seed=6)
    sc, a1, a2 = api.align(s1, s2, cfg)
    _check_alignment(s1, s2, cfg, sc, a1, a2)


def _check_local_alignment(s1, s2, cfg, sc, a1, a2):
    from tpualign.io.bdna import BASES

    assert sc == oracle.score(s1, s2, cfg)
    assert oracle.alignment_score(a1, a2, cfg) == sc
    # the gap-stripped strings are contiguous substrings of the inputs
    t1 = "".join(BASES[c] for c in np.asarray(s1))
    t2 = "".join(BASES[c] for c in np.asarray(s2))
    assert a1.replace("-", "") in t1
    assert a2.replace("-", "") in t2


def test_local_affine_alignment_any_size(monkeypatch):
    # SW affine alignment: locate + anchored reverse fill + Myers-Miller
    from tpualign.ops import affine_align

    cfg = ScoringConfig(match=3, mismatch=-2, gap_open=-4, gap_extend=-1,
                        mode=AlignMode.LOCAL)
    rng = np.random.default_rng(67)
    for trial in range(5):
        m, n = int(rng.integers(30, 200)), int(rng.integers(30, 200))
        s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
        sc, a1, a2 = affine_align.align_local(s1, s2, cfg)
        _check_local_alignment(s1, s2, cfg, sc, a1, a2)
    # deep recursion inside the located window
    monkeypatch.setattr(affine_align, "BASE_CELLS", 256)
    s1, s2 = random_pair(120, 110, seed=9)
    sc, a1, a2 = affine_align.align_local(s1, s2, cfg)
    _check_local_alignment(s1, s2, cfg, sc, a1, a2)


def test_local_affine_alignment_api(monkeypatch):
    from tpualign import api

    monkeypatch.setattr(api, "FULL_TABLE_CELL_LIMIT", 1000)
    cfg = ScoringConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2,
                        mode=AlignMode.LOCAL)
    s1, s2 = random_pair(90, 85, seed=13)
    sc, a1, a2 = api.align(s1, s2, cfg)
    _check_local_alignment(s1, s2, cfg, sc, a1, a2)


def test_local_affine_no_positive_cell():
    from tpualign.ops import affine_align

    cfg = ScoringConfig(match=1, mismatch=-3, gap_open=-4, gap_extend=-2,
                        mode=AlignMode.LOCAL)
    s1 = np.asarray([1, 1, 1, 1], np.int8)
    s2 = np.asarray([2, 2, 2, 2], np.int8)  # mismatch everywhere
    assert affine_align.align_local(s1, s2, cfg) == (0, "", "")


@pytest.mark.parametrize("mode", [AlignMode.GLOBAL, AlignMode.LOCAL])
def test_native_affine_scorer(mode):
    # the independent C++ Gotoh row scan (the --check native verifier for
    # affine bench rows) vs the oracle
    from tpualign.utils import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(41)
    for weights in CFGS:
        cfg = ScoringConfig(mode=mode, **weights)
        m, n = int(rng.integers(1, 200)), int(rng.integers(1, 200))
        s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
        assert native.score(s1, s2, cfg) == oracle.score(s1, s2, cfg)
    with pytest.raises(RuntimeError):
        native.traceback(s1, s2, ScoringConfig(gap_open=-2, gap_extend=-1))


def test_config_validation():
    with pytest.raises(ValueError):
        ScoringConfig(gap_open=-2)  # extend missing
    with pytest.raises(ValueError):
        ScoringConfig(gap_open=1, gap_extend=-1)  # positive open
    assert ScoringConfig(gap_open=-2, gap_extend=-1).is_affine
    assert not ScoringConfig().is_affine
