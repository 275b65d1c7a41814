"""The reduction from a profiler trace to per-layer metrics, on traces
recorded on an H100 (``record_traces.py``) and on made-up intervals."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness, ops, peaks, trace
from benchmark.tests.conftest import ROOT

DATA = os.path.join(ROOT, "benchmark", "tests", "data")
H100 = "NVIDIA H100 80GB HBM3"
SCAN_ROWS = 256  # rows of the recorded scan call (record_traces.py)


def recorded(name):
    return trace.load(os.path.join(DATA, f"{name}.xplane.pb"))


def made_up():
    dev = [(10, 20, "k1"), (15, 30, "k1"), (36, 52, "k2"), (64, 95, "k1")]
    spans = [(0, 50, "bench.call"), (70, 100, "bench.call")]
    host = [(2, 8, "np.asarray(jax.Array)"), (55, 62, "PjitFunction(f)"),
            (56, 60, "Execute")]
    return trace.Trace({"/device:GPU:0": dev}, spans, host)


def test_union_of_intervals():
    assert trace.merge([(1, 3, "a"), (2, 5, "b"), (7, 8, "c")], 0, 10) == [
        (1, 5), (7, 8)]
    assert trace.merge([(1, 3, "a"), (2, 5, "b")], 2.5, 4) == [(2.5, 4)]
    assert trace.busy_ns([(0, 10, "a"), (5, 15, "b"), (20, 25, "c")], 0,
                         100) == 20


def test_idle_share_and_window():
    t = made_up()
    assert t.window == (0, 100)
    # busy: [10, 30] + [36, 52] + [64, 95] = 67 of 100
    assert trace.idle_share(t) == pytest.approx(0.33)
    # idle inside the calls: 50 - 34 and 30 - 25 ns
    assert trace.host_ms_per_call(t) == pytest.approx((16 + 5) / 2 / 1e6)


def test_idle_gaps_named_by_host_span():
    gaps = trace.idle_gaps(made_up(), n=3)
    assert gaps == [["between calls: Execute", pytest.approx(12e-9)],
                    ["inside bench.call: np.asarray(jax.Array)",
                     pytest.approx(10e-9)],
                    ["inside bench.call", pytest.approx(6e-9)]]


def test_ops_started_and_op_time():
    t = made_up()
    dev = t.devices["/device:GPU:0"]
    assert trace.ops_started(dev, 0, 50) == 3
    assert trace.op_time_ns(dev, "k1", 0, 100) == 10 + 15 + 31
    assert trace.device_ops(t, 2) == [["k1", pytest.approx(56e-9)],
                                      ["k2", pytest.approx(16e-9)]]


def test_recorded_bitpal_trace():
    t = recorded("bitpal")
    lo, hi = t.window
    calls = t.calls
    assert len(calls) >= 5 and list(t.devices) == ["/device:GPU:0"]
    dev = t.devices["/device:GPU:0"]
    kernel = trace.op_time_ns(dev, "BitpalKernel", lo, hi) / len(calls)
    assert 5e6 < kernel < 50e6  # ns per call
    assert 0 < trace.idle_share(t) < 0.5
    busy = trace.busy_ns(dev, lo, hi)
    assert busy <= hi - lo
    assert busy >= trace.op_time_ns(dev, "BitpalKernel", lo, hi)
    assert "BitpalKernel" in trace.device_ops(t, 1)[0][0]


def test_recorded_scan_trace_counts_ops_per_row():
    t = recorded("scan")
    (call,) = t.calls
    a = np.zeros((1, 126440), np.int8)
    b = np.zeros((1, SCAN_ROWS), np.int8)
    ctx = SimpleNamespace(trace=t, inputs=[(a, b)])
    per_row = harness.load_module(ROOT, "metrics",
                                  "xla_scan_ops_per_row").value(ctx)
    dev = t.devices["/device:GPU:0"]
    assert per_row == trace.ops_started(dev, *call[:2]) / SCAN_ROWS
    # one row is a handful of fusions and a copy, the same each row
    assert 5 <= per_row <= 20


def test_recorded_batch_trace_splits_host_and_device():
    t = recorded("batch")
    host = trace.host_ms_per_call(t)
    busy = [trace.mean_busy_ns(t, s, e) / 1e6 for s, e, _ in t.calls]
    spans = [(e - s) / 1e6 for s, e, _ in t.calls]
    for b, s in zip(busy, spans):
        assert 0 < b < s
    assert host == pytest.approx(np.mean(spans) - np.mean(busy))
    assert trace.idle_share(t) > 0.5


def test_metric_readers_on_recorded_traces():
    load = lambda name: harness.load_module(ROOT, "metrics", name)  # noqa
    scoring = {"match": 1, "mismatch": 0, "gap": -1, "mode": "global"}
    a = np.zeros((1, 126440), np.int8)
    b = np.zeros((1, 127240), np.int8)
    ctx = SimpleNamespace(trace=recorded("bitpal"), peak=peaks.peak(H100),
                          config={"scoring": scoring}, inputs=[(a, b)])
    kernel_ms = load("bitpal_kernel_ms").value(ctx)
    share = load("bitpal_roofline").value(ctx)
    t_min, bound = ops.bitpal_roofline_s(scoring, 126440, 127240,
                                         peaks.peak(H100))
    assert bound == "int32 issue"
    assert share == pytest.approx(100 * t_min / (kernel_ms / 1e3))
    assert 0 < share < 100
    ctx.trace = recorded("batch")
    assert load("bitpal_kernel_ms").value(ctx) is None
    assert load("bitpal_roofline").value(ctx) is None


def test_bitpal_operation_count():
    # B = 2 planes for g = 1: 8 B + 2 = 18 operations a word step
    assert ops.bitpal_word_ops(1) == 18
    assert [ops.bitpal_word_ops(g) for g in (2, 3, 4)] == [26, 26, 34]
    assert ops.bitpal_word_steps(126440, 127240) == min(
        1976 * 127240, 1989 * 126440)
    assert ops.bitpal_family_g({"match": 2, "mismatch": 0, "gap": -4}) == 2
    with pytest.raises(ValueError):
        ops.bitpal_family_g({"match": 5, "mismatch": -4, "gap_open": -12,
                             "gap_extend": -4})


def test_roofline_arithmetic():
    peak = {"int32_ops_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    t, bound = ops.bitpal_roofline_s({"match": 1, "mismatch": 0, "gap": -1},
                                     640, 1000, peak)
    # 18 ops x 10 words x 1000 columns = 0.18 us of issue; 1,640 bytes = 1.64
    # us of memory: the bytes bound it
    assert (t, bound) == (pytest.approx(1640 / 1e9), "hbm")
    h100 = peaks.peak(H100)
    assert h100["int32_ops_per_s"] == pytest.approx(16.72704e12)


def test_unknown_device_refused():
    with pytest.raises(peaks.UnknownDevice):
        peaks.peak("NVIDIA A100-SXM4-80GB")
