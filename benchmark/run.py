"""Run one benchmark cell and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of the checkout.  Without a GPU, or with another number of
devices than the cell asks for, it exits with code 2 and prints no result.
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from a profiler trace of a
shorter window.  The numbers compared with the plain reference are the last
lines of standard error and the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    sys.path.insert(0, ROOT)
    from benchmark import harness

    try:
        cell = harness.load_cell(ROOT, args.workload)
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             T_START)
    except harness.Refused as e:
        print(f"benchmark: refused: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
