"""Golden scores pinned from the compiled C++ reference.

Provenance: ``g++ -O2 -std=c++11 src/serial/serial.cpp helper.cpp`` from
/root/reference, run on the committed ``bdna/`` pairs (tiny pairs 2026-08-16;
every benched gb size re-run 2026-08-17 with full in-RAM tables).  The pin
table lives in :mod:`tpualign.golden` (shared with ``cli.py bench``'s score
cross-check); this suite asserts the tiny pairs end-to-end.  The big pairs'
pins are checked on the GPU (``tests_gpu/``, ``chip_smoke.py``).
"""

import os

import pytest

from tpualign.golden import GOLDEN_NW_UNIT
from tpualign.io.bdna import read_bdna
from tpualign.ops import oracle, xla

GOLDEN = {k: GOLDEN_NW_UNIT[k] for k in ("small", "debug", "t", "smid")}
CORPUS = "/root/reference/bdna"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(CORPUS), reason="reference corpus not mounted"
)


@pytest.mark.parametrize("name,want", sorted(GOLDEN.items()))
def test_golden_nw_scores(name, want):
    s1 = read_bdna(os.path.join(CORPUS, f"{name}1.bdna"))
    s2 = read_bdna(os.path.join(CORPUS, f"{name}2.bdna"))
    assert oracle.score(s1, s2) == want
    assert xla.score(s1, s2) == want


@pytest.mark.parametrize(
    "name,want",
    sorted(
        (k, v)
        for k, v in __import__(
            "tpualign.golden", fromlist=["GOLDEN_SW_2_1_2"]
        ).GOLDEN_SW_2_1_2.items()
        if k in ("small", "debug", "t", "smid")
    ),
)
def test_golden_sw_scores(name, want):
    """SW pins are self-pinned from the independent C++ scorer (the
    reference has no SW); the tiny pairs re-verify end-to-end here."""
    from tpualign.config import AlignMode, ScoringConfig

    sw = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
    s1 = read_bdna(os.path.join(CORPUS, f"{name}1.bdna"))
    s2 = read_bdna(os.path.join(CORPUS, f"{name}2.bdna"))
    assert oracle.score(s1, s2, sw) == want
