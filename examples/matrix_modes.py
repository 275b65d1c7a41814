"""Substitution matrices and ends-free alignment modes.

The C++ reference hardwires match/mismatch scoring and global alignment
(``needleman-wunsch.hpp:11-13``); this engine scores with any square
integer matrix over alphabets up to 16 codes and serves four modes:
global (nw), local (sw), semiglobal (sg — leading/trailing gaps free),
and infix (fit all of SEQ2 inside SEQ1).

Usage: python examples/matrix_modes.py SEQ1.bdna SEQ2.bdna [--mode sg]
"""
import sys
import time

sys.path.insert(0, ".")

from tpualign import align, align_score
from tpualign.config import AlignMode, ScoringConfig
from tpualign.io.bdna import read_bdna
from tpualign.matrices import dna

mode = AlignMode(sys.argv[sys.argv.index("--mode") + 1]) \
    if "--mode" in sys.argv else AlignMode.SEMIGLOBAL
s1, s2 = read_bdna(sys.argv[1]), read_bdna(sys.argv[2])

# transition/transversion-weighted DNA scoring: purine<->purine and
# pyrimidine<->pyrimidine swaps cost less than cross-class substitutions
cfg = ScoringConfig(gap=-2, matrix=dna(match=2, transition=-1,
                                       transversion=-3), mode=mode)

t0 = time.perf_counter()
sc = align_score(s1, s2, cfg)  # the XLA row scan (matrix gather)
dt = time.perf_counter() - t0
print(f"{mode.value} matrix score {sc}  ({dt * 1e3:.1f} ms)")

t0 = time.perf_counter()
sc2, a1, a2 = align(s1, s2, cfg)  # locate the core, then align it
dt = time.perf_counter() - t0
assert sc2 == sc
w = 72
print(f"alignment of the scored core ({dt:.2f} s):")
for off in range(0, min(len(a1), 3 * w), w):
    print(" ", a1[off : off + w])
    print(" ", a2[off : off + w])
    print()
