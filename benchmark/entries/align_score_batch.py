"""``tpualign.align_score_batch``: a list of texts and a list of queries per
call, the scores read back as one host array."""

from __future__ import annotations

import numpy as np

from benchmark import program


class Entry:
    def __init__(self, scoring: dict):
        from tpualign import align_score_batch

        self._fn = align_score_batch
        self._cfg = program.scoring_config(scoring)

    def prepare(self, unit):
        """The arguments as a read mapper holds them: one int8 array per
        window and per read."""
        a, b = unit
        return list(a), list(b)

    def call(self, args) -> np.ndarray:
        return np.asarray(self._fn(args[0], args[1], self._cfg), np.int64)
