"""One run of one cell: set-up, the timed window, the check, the result.

Everything that belongs to one configuration, traffic mix, entry, input
generator or metric lives in a file of its own, found by its name:

- ``BENCHMARK.json`` names the cell's configuration, traffic and metrics;
- ``benchmark/configs/<config>.json``: scoring, input shapes, deployment;
- ``benchmark/traffic/<traffic>.json``: which public entry the window
  drives, how many distinct inputs it cycles through, the pairs per call,
  the traced window's length, and input parameters that override the
  configuration's;
- ``benchmark/generators/<generator>.py``: a seeded input generator;
- ``benchmark/entries/<entry>.py``: how to call that public entry;
- ``benchmark/e2e/<metric>.py`` and ``benchmark/metrics/<metric>.py``: one
  reader for each end-to-end and per-layer metric.

The window calls the entry back to back, each call ending in a host read of
its answer.  It starts at the first call's start; no call starts once the
window's seconds have passed; it ends when the last call ends.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Callable, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.basename(HERE)


class Refused(RuntimeError):
    """The run cannot measure what the cell asks for: no result is printed."""


@dataclasses.dataclass
class Cell:
    root: str
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, PACKAGE, "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(root, name, int(w["chips"]), config, traffic, e2e, per_layer)


def load_module(root: str, kind: str, name: str):
    """``<root>/benchmark/<kind>/<name>.py`` as a module."""
    path = os.path.join(root, PACKAGE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}.{kind}.{name}", path)
    if spec is None or not os.path.exists(path):
        raise Refused(f"no {kind} reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(cell: Cell, seed: int):
    """The cell's distinct inputs from ``seed``: a list of ``(a, b)``
    arrays of pairs, one per call it serves."""
    params = {**cell.config["inputs"], **cell.traffic.get("inputs", {})}
    gen = load_module(cell.root, "generators", params["generator"])
    return gen.make(params, seed, int(cell.traffic["distinct_inputs"]),
                    int(cell.traffic.get("pairs_per_call", 1)))


def card() -> str:
    """``name, power.limit`` of each card, as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return "; ".join(out.stdout.strip().splitlines())


class CompileCounter:
    """Counts JAX's traces and compile requests while it is active."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/backend_compile_duration")
    REQUEST = "/jax/compilation_cache/compile_requests_use_cache"

    def __init__(self):
        self.active = False
        self.traces = 0
        self.compiles = 0

    def on_duration(self, event, _secs, **_kw):
        if self.active:
            if event == self.EVENTS[0]:
                self.traces += 1
            elif event == self.EVENTS[1]:
                self.compiles += 1

    def on_event(self, event, **_kw):
        if self.active and event == self.REQUEST:
            self.compiles += 1

    def __enter__(self):
        import jax.monitoring as mon

        mon.register_event_duration_secs_listener(self.on_duration)
        mon.register_event_listener(self.on_event)
        self.active = True
        return self

    def __exit__(self, *exc):
        import jax.monitoring as mon

        self.active = False
        mon.unregister_event_duration_listener(self.on_duration)
        mon.unregister_event_listener(self.on_event)


@dataclasses.dataclass
class Window:
    starts: List[float]
    ends: List[float]
    units: List[int]  # index of the input each call served
    answers: List[Optional[np.ndarray]]  # None where the call raised
    errors: List[str]

    @property
    def seconds(self) -> float:
        return self.ends[-1] - self.starts[0]

    @property
    def call_s(self) -> List[float]:
        return [e - s for s, e in zip(self.starts, self.ends)]


def drive(call: Callable, args: list, seconds: float, annotate) -> Window:
    """Call ``call(args[i % len(args)])`` back to back until ``seconds``
    have passed since the first call started; at least one call."""
    w = Window([], [], [], [], [])
    i = 0
    t_first = None
    while t_first is None or time.perf_counter() - t_first < seconds:
        k = i % len(args)
        t0 = time.perf_counter()
        if t_first is None:
            t_first = t0
        try:
            with annotate():
                ans = call(args[k])
        except Exception as e:  # a failed call is counted, not fatal
            ans = None
            w.errors.append(f"{type(e).__name__}: {e}")
        w.starts.append(t0)
        w.ends.append(time.perf_counter())
        w.units.append(k)
        w.answers.append(ans)
        i += 1
    return w


def check(window: Window, inputs, scoring: dict) -> dict:
    """Compare every answer of the window with the plain reference.

    Returns ``{name: {"value": v, "limit": l}}``; the run is correct when
    no value passes its limit."""
    from benchmark import reference

    want = {k: reference.scores(*inputs[k], scoring)
            for k in sorted(set(window.units))}
    wrong = missing = 0
    for k, ans in zip(window.units, window.answers):
        n = want[k].size
        if ans is None or ans.shape != want[k].shape:
            missing += n
            continue
        wrong += int(np.sum(ans != want[k]))
    return {"wrong_scores": {"value": wrong, "limit": 0},
            "missing_scores": {"value": missing, "limit": 0}}


def device_info(chips) -> dict:
    import jax

    devs = jax.devices()
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devs[:chips]]
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "memory_peak_bytes": int(max(peaks))}


def set_compile_cache(root: str) -> str:
    """JAX's persistent compile cache: ``JAX_COMPILATION_CACHE_DIR`` when
    set, else the fixed ``<checkout>/.jax_cache``; every program cached."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        require_gpu: bool = True, out=sys.stdout, err=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line's object.  Progress
    goes to ``out``, the compared numbers to ``err`` as its last lines."""
    import jax

    def say(msg):
        print(msg, file=out, flush=True)

    if require_gpu and jax.default_backend() != "gpu":
        raise Refused(f"no GPU: JAX's backend is {jax.default_backend()!r}")
    if len(jax.devices()) != cell.chips:
        raise Refused(f"cell {cell.name} needs {cell.chips} device(s), JAX "
                      f"finds {len(jax.devices())}")
    say(f"card: {card()}")
    say(f"device: {jax.devices()[0].device_kind} x {len(jax.devices())}, "
        f"compile cache {set_compile_cache(cell.root)}")

    from benchmark import program

    scoring = cell.config["scoring"]
    inputs = make_inputs(cell, seed)
    entry = load_module(cell.root, "entries", cell.traffic["entry"]).Entry(
        scoring)
    args = [entry.prepare(u) for u in inputs]
    a0, b0 = inputs[0]
    engine = program.engine(scoring, (a0.shape[1], b0.shape[1]))
    say(f"engine: {engine} (configuration expects "
        f"{cell.config.get('engine_expected')})")
    entry.call(args[0])  # warm-up: every input of a cell has one shape

    readers = {m["name"]: load_module(
        cell.root, "metrics" if trace else "e2e", m["name"])
        for m in (cell.per_layer if trace else cell.end_to_end)}
    if trace:
        import shutil
        import jax.profiler as jp

        log_dir = os.path.join(cell.root, ".bench_trace", cell.name)
        shutil.rmtree(log_dir, ignore_errors=True)
        opts = jp.ProfileOptions()
        opts.python_tracer_level = 0
        # a call of the XLA row scan launches ~1.3M kernels; room for them
        opts.advanced_configuration = {
            "gpu_max_activity_api_events": 1 << 23,
            "gpu_max_callback_api_events": 1 << 23}
        jp.start_trace(log_dir, profiler_options=opts)
        seconds = float(cell.traffic["trace_seconds"])
        annotate = lambda: jp.TraceAnnotation("bench.call")  # noqa: E731
    else:
        import contextlib

        annotate = contextlib.nullcontext
    setup_s = time.perf_counter() - t_start
    with CompileCounter() as compiled:
        window = drive(entry.call, args, seconds, annotate)
    if trace:
        jp.stop_trace()
    device = device_info(cell.chips)
    n = len(window.starts)
    say(f"window: {n} calls in {window.seconds:.6f} s, "
        f"{len(window.errors)} failed; call time p95 over {n} samples")
    say(f"compiled inside the window: {compiled.compiles} programs, "
        f"{compiled.traces} traces")
    for e in window.errors[:3]:
        say(f"failed call: {e}")

    cells_per = [int(a.shape[0]) * a.shape[1] * b.shape[1] for a, b in inputs]
    pairs_per = [int(a.shape[0]) for a, _ in inputs]
    result = {"correct": None, "attempted": n, "failed": len(window.errors),
              "metrics": {}, "device": device}
    ctx = SimpleNamespace(
        window=window, setup_s=setup_s, config=cell.config,
        traffic=cell.traffic, inputs=inputs,
        cells=[cells_per[k] for k in window.units],
        pairs=[pairs_per[k] for k in window.units])
    if trace:
        from benchmark import peaks, trace as tr

        t = tr.load(tr.find_xplane(log_dir))
        shutil.rmtree(log_dir, ignore_errors=True)
        lo, hi = t.window
        device["busy_s"] = tr.mean_busy_ns(t, lo, hi) / 1e9
        device["window_s"] = (hi - lo) / 1e9
        ctx.trace = t
        ctx.peak = peaks.peak(device["kind"]) if require_gpu else None
        result["breakdown"] = {"device_ops": tr.device_ops(t),
                               "idle_gaps": tr.idle_gaps(t)}
        say(f"traced window: {device['window_s']:.6f} s, device busy "
            f"{device['busy_s']:.6f} s")
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = readers[m["name"]].value(ctx)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    say(f"metrics: {json.dumps(result['metrics'])}")

    compared = check(window, inputs, scoring)
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in compared.values())
    result["check"] = compared
    for name, c in compared.items():
        print(f"check: {name} {c['value']} (limit {c['limit']})", file=err,
              flush=True)
    return result
