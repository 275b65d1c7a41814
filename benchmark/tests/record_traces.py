"""Record the small traces that ``test_trace.py`` reads.  Chip only:

    python3 benchmark/tests/record_traces.py <out_dir>

Each is a profiler trace of a few calls of one cell's entry, taken as a
traced benchmark run takes it (the same profiler options and
``bench.call`` spans), at a size that keeps the file small: the 64gb pair
through ``align_score`` (bit-parallel kernel, 5 calls), a batch of 4,096
short reads through ``align_score_batch`` (2 calls), and the XLA row scan
over 256 rows of the 64gb pair's width under stretcher scoring (1 call).
"""

import glob
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(out_dir: str) -> int:
    sys.path.insert(0, ROOT)
    import jax.profiler as jp

    from benchmark import harness

    harness.set_compile_cache(ROOT)
    os.makedirs(out_dir, exist_ok=True)
    jobs = (
        ("bitpal", "ref64gb-nw.score", 5, None, None),
        ("batch", "bwamem-sr150.batch", 2, 4096, None),
        ("scan", "stretcher-64gb.score", 1, None, 256),
    )
    for name, workload, calls, pairs, rows in jobs:
        cell = harness.load_cell(ROOT, workload)
        if pairs:
            cell.traffic = {**cell.traffic, "pairs_per_call": pairs,
                            "distinct_inputs": 2}
        inputs = harness.make_inputs(cell, 7)
        if rows:
            inputs = [(a, b[:, :rows]) for a, b in inputs]
        entry = harness.load_module(
            ROOT, "entries", cell.traffic["entry"]).Entry(
                cell.config["scoring"])
        args = [entry.prepare(u) for u in inputs]
        entry.call(args[0])
        log_dir = os.path.join(out_dir, f"{name}_log")
        shutil.rmtree(log_dir, ignore_errors=True)
        opts = jp.ProfileOptions()
        opts.python_tracer_level = 0
        jp.start_trace(log_dir, profiler_options=opts)
        for i in range(calls):
            with jp.TraceAnnotation("bench.call"):
                entry.call(args[i % len(args)])
        jp.stop_trace()
        (path,) = glob.glob(os.path.join(log_dir, "plugins", "profile", "*",
                                         "*.xplane.pb"))
        shutil.copy(path, os.path.join(out_dir, f"{name}.xplane.pb"))
        shutil.rmtree(log_dir)
        print(name, os.path.getsize(os.path.join(out_dir,
                                                 f"{name}.xplane.pb")))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
