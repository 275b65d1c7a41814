"""Affine (Gotoh) gap penalties: score and align under open/extend costs.

A gap run of L columns costs ``gap_open + L * gap_extend`` — the standard
model of BLAST/minimap-style aligners, which the C++ reference (linear
gaps only, ``needleman-wunsch.hpp:14``) cannot express.  One long indel
is then cheaper than many short ones, which changes the optimal path.

Usage: python examples/affine_gaps.py SEQ1.bdna SEQ2.bdna [--sw]
"""
import sys
import time

sys.path.insert(0, ".")

from tpualign import align, align_score
from tpualign.config import AlignMode, ScoringConfig
from tpualign.io.bdna import read_bdna

sw = "--sw" in sys.argv
s1, s2 = read_bdna(sys.argv[1]), read_bdna(sys.argv[2])
cfg = ScoringConfig(
    match=2, mismatch=-3, gap_open=-5, gap_extend=-2,
    mode=AlignMode.LOCAL if sw else AlignMode.GLOBAL,
)
linear = ScoringConfig(match=2, mismatch=-3, gap=-4, mode=cfg.mode)

t0 = time.perf_counter()
sc = align_score(s1, s2, cfg)  # the XLA row scan
dt = time.perf_counter() - t0
print(f"affine score {sc}  ({dt * 1e3:.1f} ms)  "
      f"[linear -4/col scores {align_score(s1, s2, linear)}]")

if len(s1) * len(s2) <= (1 << 34):
    t0 = time.perf_counter()
    # any size: Myers-Miller bisection (global) or locate + anchored
    # reverse + Myers-Miller on the matched substrings (SW)
    sc2, a1, a2 = align(s1, s2, cfg)
    assert sc2 == sc
    runs = sum(
        1 for i, c in enumerate(a1 + "|" + a2)
        if c == "-" and (a1 + "|" + a2)[i - 1] != "-"
    )
    print(f"alignment: length {len(a1)}, {runs} gap runs "
          f"({time.perf_counter() - t0:.2f} s)")
