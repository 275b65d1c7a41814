"""Headline benchmark: NW score GCUPS on the 64gb corpus pair, one GPU.

Prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": "GCUPS", "vs_baseline": N, ...}

Baseline: the reference repo's best 64gb number — the hybrid MPI x OpenMP fill
at 2,996 ms = 5.37 GCUPS (``data/multi.tsv:6``, see BASELINE.md).  The same
pair (126,440 x 127,240 bases, 16.09e9 cells) is loaded from the reference
corpus when mounted, otherwise regenerated at identical lengths.  The engine
is the one ``resolve_impl`` picks.  Without a GPU the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import sys

BASELINE_GCUPS = 5.37  # reference best: hybrid, 64gb pair (data/multi.tsv:6)
PAIR_LENGTHS = (126440, 127240)  # bdna/64gb-{1,2}.bdna
CORPUS = "/root/reference/bdna"


def load_pair():
    from tpualign.io.bdna import random_pair, read_bdna

    p1 = os.path.join(CORPUS, "64gb-1.bdna")
    p2 = os.path.join(CORPUS, "64gb-2.bdna")
    if os.path.exists(p1) and os.path.exists(p2):
        return read_bdna(p1), read_bdna(p2)
    return random_pair(*PAIR_LENGTHS, seed=64)


def main() -> int:
    from tpualign.utils import compile_cache, device

    compile_cache.setup()
    try:
        device.require_gpu()
    except device.NoAcceleratorError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        return 1
    import jax.numpy as jnp

    from tpualign.api import device_score_fn, resolve_impl
    from tpualign.bench.harness import time_device_fn
    from tpualign.config import EngineConfig, ScoringConfig

    s1, s2 = load_pair()
    cells = len(s1) * len(s2)
    cfg = ScoringConfig()
    impl = resolve_impl(EngineConfig(), cfg, (len(s1), len(s2)))
    fn = device_score_fn(impl, len(s1), len(s2), cfg)
    r = time_device_fn(
        fn, (jnp.asarray(s1, jnp.int32), jnp.asarray(s2, jnp.int32)),
        label="64gb", cells=cells)
    print(json.dumps({
        "metric": "NW score GCUPS, 64gb pair (16.09e9 cells), 1 GPU",
        "value": r.gcups_best,
        "unit": "GCUPS",
        "vs_baseline": r.gcups_best / BASELINE_GCUPS,
        "wall_ms": r.wall_s_best * 1e3,
        "score": r.score,
        "engine": impl,
        "card": device.card(),
        "device": device.describe(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
