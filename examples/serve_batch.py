"""Serving pattern: score a batch of query/text pairs in ONE device dispatch.

In a serving loop, per-pair dispatches dominate small alignments;
`align_score_batch` pads the batch to one shape bucket and scores every pair
in one device dispatch (the row scan vmapped over the batch).

Usage: python examples/serve_batch.py  (synthesizes a demo batch)
"""
import sys
import time

sys.path.insert(0, ".")

import numpy as np

from tpualign import align_score_batch
from tpualign.io.bdna import random_pair

rng = np.random.default_rng(0)
texts, queries = [], []
for i in range(16):
    m, n = int(rng.integers(5_000, 25_000)), int(rng.integers(5_000, 25_000))
    s1, s2 = random_pair(m, n, seed=i)
    texts.append(s1)
    queries.append(s2)

scores = align_score_batch(texts, queries)  # compile + warm
t0 = time.perf_counter()
scores = align_score_batch(texts, queries)
dt = time.perf_counter() - t0
cells = sum(len(t) * len(q) for t, q in zip(texts, queries))
print(f"{len(texts)} pairs in {dt * 1e3:.1f} ms "
      f"({cells / dt / 1e9:.0f} GCUPS aggregate)")
print("scores:", scores.tolist())
