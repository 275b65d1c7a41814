"""Benchmark harness: timing, GCUPS accounting, TSV/JSON emitters.

Successor of the reference's zsh harness (``src/benchmark-*.sh``,
``block-tune.sh``, ``buf-tune.sh``) and its TSV conventions (``data/*.tsv``):
repeated runs, best/avg statistics, tab-separated rows keyed by input size.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class BenchResult:
    label: str
    cells: int
    wall_s_best: float
    wall_s_avg: float
    wall_s_all: List[float]
    score: int

    @property
    def gcups_best(self) -> float:
        return self.cells / self.wall_s_best / 1e9

    @property
    def gcups_avg(self) -> float:
        return self.cells / self.wall_s_avg / 1e9

    def row(self) -> Dict[str, object]:
        return {
            "label": self.label,
            "cells": self.cells,
            "ms_best": round(self.wall_s_best * 1e3, 2),
            "ms_avg": round(self.wall_s_avg * 1e3, 2),
            "gcups_best": round(self.gcups_best, 3),
            "gcups_avg": round(self.gcups_avg, 3),
            "score": self.score,
            "samples_ms": [round(s * 1e3, 2) for s in self.wall_s_all],
        }


def time_device_fn(
    fn: Callable,
    args: Sequence,
    *,
    label: str,
    cells: int,
    runs: int = 3,
) -> BenchResult:
    """Best/avg-of-N timing of a jitted device function.

    One call compiles and warms up (and yields the score); each timed call
    then runs to ``block_until_ready``, so a sample is the whole call on a
    local device.  Mirrors the reference's statistical hygiene:
    ``block-tune.sh`` best-of-2, ``benchmark-threads.sh`` 3-run average, raw
    samples kept for error bars (``data/multi-werror.tsv``).
    """
    score = int(np.asarray(jax_block(fn(*args))))
    samples = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax_block(fn(*args))
        samples.append(time.perf_counter() - t0)
    return BenchResult(
        label=label,
        cells=cells,
        wall_s_best=min(samples),
        wall_s_avg=sum(samples) / len(samples),
        wall_s_all=samples,
        score=score,
    )


def jax_block(x):
    return x.block_until_ready() if hasattr(x, "block_until_ready") else x


def write_tsv(path: str, results: Sequence[BenchResult]) -> None:
    cols = ["label", "cells", "ms_best", "ms_avg", "gcups_best", "gcups_avg", "score"]
    with open(path, "w") as f:
        f.write("\t".join(cols) + "\n")
        for r in results:
            row = r.row()
            f.write("\t".join(str(row[c]) for c in cols) + "\n")


def write_json(path: str, results: Sequence[BenchResult], meta: Optional[dict] = None) -> None:
    payload = {"meta": meta or {}, "results": [r.row() for r in results]}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
