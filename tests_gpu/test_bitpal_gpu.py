"""The bit-parallel CUDA kernel, compiled for the card, against the plain
references: the bigint column, the scalar oracle and the XLA row scan."""

import numpy as np
import pytest

from tpualign.config import EngineConfig, ScoringConfig
from tpualign.io.bdna import pair_lengths_for_gb, random_pair
from tpualign.ops import bitpal, oracle, xla

pytestmark = pytest.mark.gpu

EDGES = (1, 31, 32, 33, 63, 64, 65, 1000, 4097)


@pytest.mark.parametrize("transpose", [False, True], ids=["qlong", "tlong"])
@pytest.mark.parametrize("g", range(1, bitpal.MAX_G + 1))
@pytest.mark.parametrize("length", EDGES)
def test_kernel_word_edges(length, g, transpose):
    cfg = ScoringConfig(match=1, mismatch=0, gap=-g)
    s1, s2 = random_pair(length, 300, seed=length * 10 + g)
    if transpose:
        s1, s2 = s2, s1
    got = bitpal.score(s1, s2, cfg)
    assert got == oracle.score(s1, s2, cfg)
    if g == 1:
        assert got == bitpal.score_bigint(s1, s2)


@pytest.mark.parametrize(
    "match,mismatch,gap",
    [(1, -2, -4), (5, 2, -2), (2, 0, -4), (3, 2, -1), (4, 2, -5)],
)
def test_kernel_scaled_family(match, mismatch, gap):
    cfg = ScoringConfig(match=match, mismatch=mismatch, gap=gap)
    rng = np.random.default_rng(match * 100 + gap)
    for _ in range(3):
        m, n = (int(x) for x in rng.integers(1, 3000, 2))
        s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
        assert bitpal.score(s1, s2, cfg) == oracle.score(s1, s2, cfg)


def test_kernel_all_codes():
    # every 4-bit code matches itself, as in the oracle
    rng = np.random.default_rng(16)
    s1 = rng.integers(0, 16, 2500).astype(np.int8)
    s2 = rng.integers(0, 16, 1700).astype(np.int8)
    assert bitpal.score(s1, s2) == oracle.score(s1, s2)


@pytest.mark.parametrize("gb", [8, 64])
def test_kernel_matches_xla_on_card(gb):
    m, n = pair_lengths_for_gb(gb) if gb != 64 else (126440, 127240)
    s1, s2 = random_pair(m, n, seed=gb)
    assert bitpal.score(s1, s2) == xla.score(s1, s2)


def test_auto_dispatch_picks_kernel():
    from tpualign.api import resolve_impl

    assert resolve_impl(EngineConfig(), ScoringConfig(), (5000, 4000)) == \
        "bitpal"
