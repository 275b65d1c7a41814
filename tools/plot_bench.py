#!/usr/bin/env python
"""Plot benchmark TSVs from the tpu-align harness.

Successor of the reference's ``data/graph.py`` / ``graph-werror.py``: line
plots of wall time or GCUPS across input sizes, optional ``--speedup``
normalization against a baseline series, error bars from the raw samples kept
in the JSON output.

Usage:
    python tools/plot_bench.py results/sizes.tsv -o sizes.png
    python tools/plot_bench.py a.tsv b.tsv --labels bitpal,xla --speedup b.tsv
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import Dict, List


def read_tsv(path: str) -> List[Dict[str, str]]:
    with open(path) as f:
        return list(csv.DictReader(f, delimiter="\t"))


def read_samples(tsv_path: str, metric: str):
    """Per-label raw samples from the harness JSON next to ``tsv_path``,
    converted into the plotted metric's units; None if no JSON exists."""
    import json
    import os

    jpath = os.path.splitext(tsv_path)[0] + ".json"
    if not os.path.exists(jpath):
        return None
    data = json.load(open(jpath))
    out = []
    for r in data.get("results", []):
        ms = r.get("samples_ms")
        if not ms:
            return None
        if metric.startswith("gcups"):
            out.append([r["cells"] / (s * 1e-3) / 1e9 for s in ms])
        else:
            out.append(list(ms))
    return out or None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("tsv", nargs="+", help="harness TSV files (one series each)")
    ap.add_argument("-o", "--out", default="bench.png")
    ap.add_argument("--metric", choices=["ms_avg", "ms_best", "gcups_best", "gcups_avg"],
                    default="gcups_best")
    ap.add_argument("--labels", help="comma-separated series labels")
    ap.add_argument("--speedup", metavar="BASE_TSV",
                    help="plot ratio vs this baseline series (matching labels)")
    args = ap.parse_args()

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available", file=sys.stderr)
        return 1

    labels = args.labels.split(",") if args.labels else [p for p in args.tsv]
    base = None
    if args.speedup:
        base = {r["label"]: float(r[args.metric]) for r in read_tsv(args.speedup)}

    fig, ax = plt.subplots(figsize=(8, 5))
    for path, lab in zip(args.tsv, labels):
        rows = read_tsv(path)
        if base:  # keep only sizes present in the baseline series
            rows = [r for r in rows if r["label"] in base]
        xs = [r["label"] for r in rows]
        ys = [float(r[args.metric]) for r in rows]
        if base:
            ys = [y / base[x] if args.metric.startswith("gcups")
                  else base[x] / y for x, y in zip(xs, ys)]
        # error bars from the raw per-run samples the harness keeps in the
        # sibling JSON (the graph-werror.py analog; multi-werror.tsv kept 5
        # raw samples per cell).  Skipped under --speedup (the baseline has
        # no matched samples).
        samples = None if base else read_samples(path, args.metric)
        if samples:
            # clamp: TSV values are rounded, sample extremes are exact
            lo = [max(0.0, y - min(s)) for y, s in zip(ys, samples)]
            hi = [max(0.0, max(s) - y) for y, s in zip(ys, samples)]
            ax.errorbar(xs, ys, yerr=[lo, hi], marker="o", label=lab,
                        capsize=3)
        else:
            ax.plot(xs, ys, marker="o", label=lab)
    ax.set_xlabel("input pair")
    ax.set_ylabel("speedup vs baseline" if base else args.metric)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
