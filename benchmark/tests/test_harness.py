"""The harness on the CPU: cells found by name from data files alone, the
run-time guards, and ``correct`` coming out false when the timed path is
broken underneath (the look for a GPU skipped with ``require_gpu=False``)."""

import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

TINY_NW = {
    "source": "made up for a test", "scoring": {
        "match": 1, "mismatch": 0, "gap": -1, "mode": "global"},
    "inputs": {"generator": "random_pair", "lengths": [300, 280]},
    "engine_expected": "bitpal", "control_dtype": "int16",
    "assumed": [], "reduced": []}
TINY_READS = {
    "source": "made up for a test", "scoring": {
        "match": 1, "mismatch": -4, "gap_open": -6, "gap_extend": -1,
        "mode": "local"},
    "inputs": {"generator": "short_reads", "read_length": 150, "window": 160,
               "offset": 5, "substitution_rate": 0.02, "indel_max": 3,
               "cut_range": [10, 140], "genome_length": 20000},
    "engine_expected": "xla", "control_dtype": "int8",
    "assumed": [], "reduced": []}
PAIRS = {"entry": "align_score", "distinct_inputs": 2, "pairs_per_call": 1,
         "trace_seconds": 0.1}
READS = {"entry": "align_score_batch", "distinct_inputs": 3,
         "pairs_per_call": 64, "trace_seconds": 0.1}


def digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of the benchmark with two throwaway cells added as data: a
    configuration file, a traffic file and their entries in
    ``BENCHMARK.json``, and nothing else."""
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "data"))
    before = digest(root)
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    for cfg, body, traffic, tbody in (("tiny-nw", TINY_NW, "pairs", PAIRS),
                                      ("tiny-sr", TINY_READS, "reads", READS)):
        path = f"benchmark/configs/{cfg}.json"
        json.dump(body, open(os.path.join(root, path), "w"))
        json.dump(tbody, open(os.path.join(
            root, "benchmark", "traffic", f"{traffic}.json"), "w"))
        spec["configs"].append({"name": cfg, "source": "test", "file": path,
                                "reduced": [], "why": "test"})
        spec["workloads"].append({"name": f"{cfg}.{traffic}", "config": cfg,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("gcups", "call_ms_p95"):
            m["workloads"].append("tiny-nw.pairs")
        if m["name"] in ("pairs_per_s", "call_ms_p95"):
            m["workloads"].append("tiny-sr.reads")
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root, before


def run(root, name, seconds=0.3, trace=False):
    out, err = io.StringIO(), io.StringIO()
    cell = harness.load_cell(root, name)
    result = harness.run(cell, 2**31 + 5, seconds, trace,
                         time.perf_counter(), require_gpu=False, out=out,
                         err=err)
    return result, out.getvalue(), err.getvalue()


def test_new_cells_found_by_name_with_no_edit(checkout):
    root, before = checkout
    after = digest(root)
    changed = {p for p in before if after.get(p) != before[p]}
    assert changed == set()
    added = set(after) - set(before)
    assert added == {"benchmark/configs/tiny-nw.json",
                     "benchmark/configs/tiny-sr.json",
                     "benchmark/traffic/pairs.json",
                     "benchmark/traffic/reads.json"}
    result, out, err = run(root, "tiny-nw.pairs")
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"gcups", "call_ms_p95", "setup_s"}
    assert list(result)[-1] == "check"
    assert result["check"] == {"wrong_scores": {"value": 0, "limit": 0},
                               "missing_scores": {"value": 0, "limit": 0}}
    assert err.splitlines()[-2:] == ["check: wrong_scores 0 (limit 0)",
                                     "check: missing_scores 0 (limit 0)"]
    assert "engine: xla" in out and "compiled inside the window: 0" in out
    result, _, _ = run(root, "tiny-sr.reads")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"pairs_per_s", "call_ms_p95",
                                      "setup_s"}
    assert result["attempted"] >= 1 and result["device"]["platform"] == "cpu"


def test_metric_values_follow_the_window(checkout):
    root, _ = checkout
    result, out, _ = run(root, "tiny-sr.reads", seconds=0.5)
    m = result["metrics"]
    assert m["pairs_per_s"]["unit"] == "pairs/s"
    assert m["pairs_per_s"]["value"] > 0 and m["setup_s"]["value"] > 0
    assert f"window: {result['attempted']} calls" in out


def test_wrong_device_count_refused(checkout):
    root, _ = checkout
    cell = harness.load_cell(root, "tiny-nw.pairs")
    cell.chips = 4
    with pytest.raises(harness.Refused):
        harness.run(cell, 1, 0.1, False, time.perf_counter(),
                    require_gpu=False, out=io.StringIO(), err=io.StringIO())


def test_altered_answer_is_not_correct(checkout, monkeypatch):
    from tpualign.ops import xla

    real = xla.score
    monkeypatch.setattr(xla, "score", lambda s1, s2, cfg: real(s1, s2, cfg)
                        + 1)
    result, _, err = run(checkout[0], "tiny-nw.pairs")
    assert result["correct"] is False
    assert result["check"]["wrong_scores"]["value"] == result["attempted"]
    assert "check: wrong_scores 0 " not in err


@pytest.mark.parametrize("fill", ["dropped", "zeros"])
def test_half_of_the_batch_left_out_is_not_correct(checkout, monkeypatch,
                                                   fill):
    from tpualign.ops import xla

    real = xla.score_batch

    def half(texts, queries, cfg):
        k = len(texts) // 2
        got = real(texts[:k], queries[:k], cfg)
        return got if fill == "dropped" else np.concatenate(
            [got, np.zeros(len(texts) - k, got.dtype)])

    monkeypatch.setattr(xla, "score_batch", half)
    result, _, _ = run(checkout[0], "tiny-sr.reads")
    assert result["correct"] is False
    key = "missing_scores" if fill == "dropped" else "wrong_scores"
    assert result["check"][key]["value"] > 0


def test_failed_calls_are_not_correct(checkout, monkeypatch):
    from tpualign.ops import xla

    real, calls = xla.score, []

    def boom(*a):  # the warm-up call succeeds, the window's calls fail
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("device lost")
        return real(*a)

    monkeypatch.setattr(xla, "score", boom)
    result, out, _ = run(checkout[0], "tiny-nw.pairs", seconds=0.05)
    assert result["correct"] is False and result["failed"] >= 1
    assert result["failed"] == result["attempted"]
    assert "failed call: RuntimeError: device lost" in out


def command(cwd, *extra):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ref64gb-nw.score",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra], cwd=cwd,
        env=env, capture_output=True, text=True, timeout=300)


def test_no_gpu_exits_nonzero_with_no_result():
    proc = command(ROOT)
    assert proc.returncode == 2
    assert "{" not in proc.stdout
    assert "no GPU" in proc.stderr


def test_bare_benchmark_directory_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "data"))
    proc = command(str(tmp_path))
    assert proc.returncode != 0 and "{" not in proc.stdout
