"""``tpualign.align_score``: one pair per call, the score read back as an int."""

from __future__ import annotations

import numpy as np

from benchmark import program


class Entry:
    def __init__(self, scoring: dict):
        from tpualign import align_score

        self._fn = align_score
        self._cfg = program.scoring_config(scoring)

    def prepare(self, unit):
        """The arguments as a caller holds them: two int8 code arrays."""
        a, b = unit
        if a.shape[0] != 1:
            raise ValueError("align_score takes one pair per call")
        return a[0], b[0]

    def call(self, args) -> np.ndarray:
        return np.asarray([self._fn(args[0], args[1], self._cfg)], np.int64)
