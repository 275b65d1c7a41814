"""Cross-engine score agreement under randomized configurations.

The reference's de-facto integration test was agreement of ``Score:`` across
its 16 kernel binaries on the same input (SURVEY.md §4).  This is that
discipline, randomized: every applicable engine must produce the oracle's
score for random (lengths, alphabet, scoring, mode) draws."""

import numpy as np

from tpualign.config import AlignMode, ScoringConfig
from tpualign.io.bdna import random_pair
from tpualign.ops import oracle, xla
from tpualign.parallel import strips
from tpualign.parallel.mesh import make_mesh


def _random_cfg(rng) -> ScoringConfig:
    mode = AlignMode.LOCAL if rng.integers(2) else AlignMode.GLOBAL
    return ScoringConfig(
        match=int(rng.integers(1, 6)),
        mismatch=int(rng.integers(-4, 2)),
        gap=int(rng.integers(-5, 0)),
        mode=mode,
    )


def _random_affine_cfg(rng) -> ScoringConfig:
    # mismatch <= 0: mismatches never score above a gap-free zero
    mode = AlignMode.LOCAL if rng.integers(2) else AlignMode.GLOBAL
    return ScoringConfig(
        match=int(rng.integers(1, 6)),
        mismatch=int(rng.integers(-4, 1)),
        gap_open=int(rng.integers(-8, 1)),
        gap_extend=int(rng.integers(-5, 1)),
        mode=mode,
    )


def test_cross_engine_affine_fuzz(rng):
    # same discipline for the Gotoh engines: oracle vs xla scan vs the
    # sharded (H, E)-halo pipeline vs the independent C++ scorer
    from tpualign.utils import native

    mesh = make_mesh(4)
    for trial in range(8):
        m = int(rng.integers(1, 180))
        n = int(rng.integers(1, 180))
        s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
        cfg = _random_affine_cfg(rng)
        want = oracle.score(s1, s2, cfg)
        got = {
            "xla": xla.score(s1, s2, cfg),
            "strips": strips.score(s1, s2, cfg, mesh=mesh, chunk_rows=64),
        }
        if native.available():
            got["native"] = native.score(s1, s2, cfg)
        for name, v in got.items():
            assert v == want, (trial, name, cfg, m, n, v, want)


def test_cross_engine_fuzz(rng):
    mesh = make_mesh(4)
    for trial in range(12):
        m = int(rng.integers(1, 220))
        n = int(rng.integers(1, 220))
        s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
        cfg = _random_cfg(rng)
        want = oracle.score(s1, s2, cfg)
        got = {"xla": xla.score(s1, s2, cfg)}
        got["strips"] = strips.score(s1, s2, cfg, mesh=mesh, chunk_rows=64)
        for name, v in got.items():
            assert v == want, (trial, name, cfg, m, n, v, want)
