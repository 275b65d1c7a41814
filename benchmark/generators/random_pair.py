"""Uniform random DNA pairs: codes 1..4 (A, T, G, C), every base drawn alone.

Copied from the program's ``io.bdna.random_pair`` (the stand-in for the
reference corpus, whose ``.bdna`` files are random sequences too): for one
pair per unit and seed ``s`` it draws exactly what ``random_pair(m, n,
seed=s)`` draws.  ``params["lengths"]`` is ``[m, n]``.
"""

from __future__ import annotations

import numpy as np


def make(params: dict, seed: int, units: int, pairs_per_unit: int):
    """``units`` inputs of ``pairs_per_unit`` pairs each, as ``(a, b)`` int8
    arrays of shapes ``(pairs, m)`` and ``(pairs, n)``."""
    m, n = (int(v) for v in params["lengths"])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(units):
        a = np.empty((pairs_per_unit, m), np.int8)
        b = np.empty((pairs_per_unit, n), np.int8)
        for k in range(pairs_per_unit):
            a[k] = rng.integers(1, 5, size=m, dtype=np.int8)
            b[k] = rng.integers(1, 5, size=n, dtype=np.int8)
        out.append((a, b))
    return out
