"""Reduce a ``jax.profiler`` trace to what the per-layer metrics read.

A traced run writes an ``.xplane.pb``.  :func:`load` keeps three things of it,
both on the profiler's one clock:

- for each device, the intervals in which an operation (a kernel, a copy or
  a memset) ran on it, from the device plane's stream lines;
- the benchmark's own host spans (``bench.*`` annotations): one
  ``bench.call`` around each call of the public entry;
- the other host events of the thread those spans are on (JAX's own
  runtime spans), to name what the host was doing in a device's idle gap.

Everything else the metrics need is computed here from those lists, so
that every metric reads a busy time, an idle gap or an operation count the
same way.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Tuple

DEVICE_PLANE = "/device:GPU:"
#: a device plane's lines of executed operations, one per CUDA stream
STREAM_LINE = "Stream"
SPAN_PREFIX = "bench."
CALL = "bench.call"

Event = Tuple[float, float, str]  # start ns, end ns, name


@dataclasses.dataclass
class Trace:
    devices: Dict[str, List[Event]]  # plane name -> sorted operations
    spans: List[Event]  # the benchmark's host spans, sorted
    host: List[Event]  # other events of the spans' host thread, sorted

    @property
    def calls(self) -> List[Event]:
        return [s for s in self.spans if s[2] == CALL]

    @property
    def window(self) -> Tuple[float, float]:
        """From the first traced call's start to the last one's end."""
        calls = self.calls
        if not calls:
            raise ValueError("the trace holds no bench.call span")
        return calls[0][0], max(c[1] for c in calls)


def find_xplane(log_dir: str) -> str:
    paths = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return paths[-1]


def load(path: str) -> Trace:
    """Device operations and benchmark spans of one ``.xplane.pb``."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    devices: Dict[str, List[Event]] = {}
    spans: List[Event] = []
    host: List[Event] = []
    for plane in data.planes:
        if plane.name.startswith(DEVICE_PLANE):
            ops = devices.setdefault(plane.name, [])
            for line in plane.lines:
                if line.name.startswith(STREAM_LINE):
                    ops.extend((e.start_ns, e.end_ns, e.name)
                               for e in line.events)
        elif plane.name.startswith("/host:"):
            for line in plane.lines:
                events = [(e.start_ns, e.end_ns, e.name) for e in line.events]
                ours = [e for e in events if e[2].startswith(SPAN_PREFIX)]
                if ours:
                    spans.extend(ours)
                    host.extend(e for e in events
                                if not e[2].startswith(SPAN_PREFIX))
    for ops in devices.values():
        ops.sort()
    spans.sort()
    host.sort()
    return Trace(devices, spans, host)


def merge(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``(start, end, ...)`` intervals, clipped to [lo, hi]."""
    out: List[List[float]] = []
    for iv in sorted(intervals):
        s, e = max(iv[0], lo), min(iv[1], hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(ops, lo: float, hi: float) -> float:
    """Time in [lo, hi] during which at least one operation ran."""
    return sum(e - s for s, e in merge(ops, lo, hi))


def mean_busy_ns(trace: Trace, lo: float, hi: float) -> float:
    """Busy time in [lo, hi], averaged over the devices."""
    if not trace.devices:
        raise ValueError("the trace holds no device plane")
    return sum(busy_ns(ops, lo, hi) for ops in trace.devices.values()) / len(
        trace.devices)


def idle_share(trace: Trace) -> float:
    """1 - busy / window over the traced window, averaged over devices."""
    lo, hi = trace.window
    return 1.0 - mean_busy_ns(trace, lo, hi) / (hi - lo)


def ops_started(ops, lo: float, hi: float) -> int:
    """Operations that started in [lo, hi)."""
    return sum(1 for s, _, _ in ops if lo <= s < hi)


def op_time_ns(ops, needle: str, lo: float, hi: float) -> float:
    """Summed duration of the operations whose name holds ``needle``,
    clipped to [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e, n in ops
               if needle in n)


def kernel_ms_per_call(trace: Trace, needle: str) -> Optional[float]:
    """Device time per traced call of the operations whose name holds
    ``needle``, averaged over devices; None where none ran."""
    calls = trace.calls
    if not calls or not trace.devices:
        return None
    lo, hi = trace.window
    total = sum(op_time_ns(ops, needle, lo, hi)
                for ops in trace.devices.values()) / len(trace.devices)
    return total / len(calls) / 1e6 if total > 0 else None


def host_ms_per_call(trace: Trace) -> Optional[float]:
    """Mean time per traced call in which no operation ran on a device:
    the call's host work and launch gaps."""
    calls = trace.calls
    if not calls or not trace.devices:
        return None
    idle = [(e - s) - mean_busy_ns(trace, s, e) for s, e, _ in calls]
    return sum(idle) / len(idle) / 1e6


def device_ops(trace: Trace, n: int = 10) -> List[list]:
    """The ``n`` operation names that took most device time in the window,
    seconds averaged over devices."""
    lo, hi = trace.window
    total: Dict[str, float] = {}
    for ops in trace.devices.values():
        for s, e, name in ops:
            d = min(e, hi) - max(s, lo)
            if d > 0:
                total[name] = total.get(name, 0.0) + d
    k = max(1, len(trace.devices))
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, t / k / 1e9] for name, t in top]


def _host_state(trace: Trace, t: float) -> str:
    """``inside bench.call`` or ``between calls``, and the innermost of the
    host thread's other events at ``t``."""
    where = "between calls"
    for s, e, _ in trace.calls:
        if s <= t < e:
            where = "inside bench.call"
            break
    inner = [(e - s, name) for s, e, name in trace.host if s <= t < e]
    return f"{where}: {min(inner)[1]}" if inner else where


def idle_gaps(trace: Trace, n: int = 10) -> List[list]:
    """The ``n`` longest stretches of the window in which a device ran no
    operation, each named by what the host was doing at its midpoint."""
    lo, hi = trace.window
    gaps = []
    for ops in trace.devices.values():
        t = lo
        for s, e in merge(ops, lo, hi) + [(hi, hi)]:
            if s > t:
                gaps.append((s - t, t, s))
            t = max(t, e)
    gaps.sort(reverse=True)
    return [[_host_state(trace, (a + b) / 2), d / 1e9]
            for d, a, b in gaps[:n]]
