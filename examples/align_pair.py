"""Recover the full optimal alignment of a huge pair in linear space.

The reference can only print the final score; this recovers the whole
path in linear space (block-checkpointed traceback over the device row
scan, with the reference's tie order).

Usage: python examples/align_pair.py SEQ1.bdna SEQ2.bdna [OUT.txt]
"""
import sys
import time

sys.path.insert(0, ".")

from tpualign import align
from tpualign.io.bdna import read_bdna

s1, s2 = read_bdna(sys.argv[1]), read_bdna(sys.argv[2])
t0 = time.perf_counter()
score, a1, a2 = align(s1, s2)
print(f"score {score}, alignment length {len(a1)}, "
      f"{time.perf_counter() - t0:.2f} s")
if len(sys.argv) > 3:
    with open(sys.argv[3], "w") as f:
        f.write(a1 + "\n" + a2 + "\n")
else:
    print(a1[:100] + ("..." if len(a1) > 100 else ""))
    print(a2[:100] + ("..." if len(a2) > 100 else ""))
