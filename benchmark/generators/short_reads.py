"""Short reads against the reference windows they were cut from.

The model is copied from the program's on-chip smoke test
(``short_read_batch``): a seeded random genome; per pair a window of
``window`` bases at a random position, and a read of ``read_length`` bases
taken from the window past its first ``offset`` bases, with each base
substituted at ``substitution_rate`` (by a uniform random base, which may be
the same one) and one indel of 1..``indel_max`` bases at a position drawn
from ``cut_range``: a deletion or an insertion of random bases, with equal
odds.  The copy draws the same distribution for a whole batch at once
instead of pair by pair, so set-up stays short at tens of thousands of pairs.
"""

from __future__ import annotations

import numpy as np


def make(params: dict, seed: int, units: int, pairs_per_unit: int):
    """``units`` batches of ``pairs_per_unit`` pairs: ``(windows, reads)``
    int8 arrays of shapes ``(pairs, window)`` and ``(pairs, read_length)``."""
    read_len = int(params["read_length"])
    window = int(params["window"])
    offset = int(params["offset"])
    rate = float(params["substitution_rate"])
    indel_max = int(params["indel_max"])
    cut_lo, cut_hi = (int(v) for v in params["cut_range"])
    if window - offset < read_len + indel_max:
        raise ValueError("the window is too short for the read and its indel")
    rng = np.random.default_rng(seed)
    genome = rng.integers(1, 5, int(params["genome_length"])).astype(np.int8)
    p = np.arange(read_len)
    out = []
    for _ in range(units):
        bsz = pairs_per_unit
        pos = rng.integers(0, genome.size - window, size=bsz)
        windows = genome[pos[:, None] + np.arange(window)]
        src = windows[:, offset:].copy()
        subs = rng.random(src.shape) < rate
        src[subs] = rng.integers(1, 5, int(subs.sum()))
        cut = rng.integers(cut_lo, cut_hi, size=bsz)[:, None]
        deletion = (rng.random(bsz) < 0.5)[:, None]
        k = rng.integers(1, indel_max + 1, size=bsz)[:, None]
        inserted = rng.integers(1, 5, size=(bsz, indel_max)).astype(np.int8)
        # read position p takes source base p before the cut; after it,
        # p + k past a deletion and p - k past an insertion's k new bases
        idx = np.where(p < cut, p, np.where(deletion, p + k, p - k))
        reads = np.take_along_axis(src, np.clip(idx, 0, src.shape[1] - 1),
                                   axis=1)
        new = ~deletion & (p >= cut) & (p < cut + k)
        ins = np.take_along_axis(inserted, np.clip(p - cut, 0, indel_max - 1),
                                 axis=1)
        reads = np.where(new, ins, reads).astype(np.int8)
        out.append((windows, reads))
    return out
