"""Statistics of a timed window: whole-window rates and tail percentiles."""

from __future__ import annotations

import numpy as np


def window_rate(total: float, window_s: float) -> float:
    """All the work of the window over all of its seconds."""
    if window_s <= 0:
        raise ValueError(f"window of {window_s} s")
    return total / window_s


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (linear interpolation between samples)."""
    if len(values) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, float), q))
