"""Readings that the limits of ``correct`` are set from.  Chip only; the
benchmark's own runs do not run it.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 3 --seconds 2

For each seed, in one process: the cell's inputs, a short window of the
cell's own entry at the cell's own load, and the numbers the benchmark
compares (``harness.check``): the program's reading.  For the first
``--control-seeds`` seeds the control is read too: the plain reference
computed in the configuration's ``control_dtype``, the next narrower
integer type, put in the program's place for the same calls.  One JSON
line per seed, then a summary line: the lower reading (the largest the
program gave) and the upper (the smallest the control gave) of each number.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import contextlib

    import jax

    from benchmark import harness, reference

    cell = harness.load_cell(ROOT, args.workload)
    if jax.default_backend() != "gpu" or len(jax.devices()) != cell.chips:
        print("calibrate: needs the cell's GPUs", file=sys.stderr)
        return 2
    harness.set_compile_cache(ROOT)
    scoring = cell.config["scoring"]
    entry = harness.load_module(ROOT, "entries", cell.traffic["entry"]).Entry(
        scoring)
    print(f"card: {harness.card()}", flush=True)
    program, control = {}, {}
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        inputs = harness.make_inputs(cell, seed)
        call_args = [entry.prepare(u) for u in inputs]
        if i == 0:
            entry.call(call_args[0])
        t0 = time.perf_counter()
        window = harness.drive(entry.call, call_args, args.seconds,
                               contextlib.nullcontext)
        t1 = time.perf_counter()
        got = harness.check(window, inputs, scoring)
        line = {"seed": seed, "calls": len(window.starts),
                "window_s": t1 - t0, "program": got}
        if i < args.control_seeds:
            dtype = cell.config["control_dtype"]
            t2 = time.perf_counter()
            low = {k: reference.scores(*inputs[k], scoring, dtype)
                   for k in set(window.units)}
            swapped = dataclasses.replace(
                window, answers=[low[k] for k in window.units], errors=[])
            line["control"] = harness.check(swapped, inputs, scoring)
            line["control_dtype"] = dtype
            line["control_s"] = time.perf_counter() - t2
        for name, c in got.items():
            program[name] = max(program.get(name, 0), c["value"])
        for name, c in line.get("control", {}).items():
            control[name] = min(control.get(name, c["value"]), c["value"])
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": cell.name, "seeds": len(seeds),
                      "lower": program, "upper": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
