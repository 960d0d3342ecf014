"""The device trace of a traced run: torch.profiler over two short
stretches of the cell's traffic, read back from their Chrome traces.

- The device stretch records the device's activity alone (CUDA), which
  costs the host about a tenth of an SpMV call: the device's busy and
  idle time and the operations that took it.
- The range stretch records the host's operations too, which more than
  doubles the host's time a call, and the benchmark's own ranges
  (``record_function``): ``spmv`` around each SpMV call,
  ``fixpoint.step`` and ``fixpoint.converged`` around the step and the
  convergence test that the benchmark hands the fixpoint loop. Each
  device operation is tied through its correlation id to the host call
  that launched it, and so to the range in which that call ran: the
  device time of each range, and what the host was doing while the
  device waited.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the name of an idle stretch that falls in none of the benchmark's ranges
OUTSIDE = "harness"


class DeviceOp(NamedTuple):
    name: str
    start: float   # us, the trace's clock
    dur: float     # us
    range: str     # the benchmark range whose call launched it, OUTSIDE when
                   # the launch fell in none, "" when no launch was found


class Trace(NamedTuple):
    ops: List[DeviceOp]
    ranges: List[Tuple[float, float, str]]   # (start us, end us, name), by start
    window_s: float                          # host clock, profiler start to stop


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def busy_intervals(ops) -> List[Tuple[float, float]]:
    """The device's busy stretches: the union of the ops, merged, in order."""
    merged: List[List[float]] = []
    for s, e in sorted((op.start, op.start + op.dur) for op in ops):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def range_at(ranges, t: float) -> str:
    """The benchmark range that holds host time t, or "" for none."""
    i = bisect.bisect_right(ranges, (t, float("inf"), "")) - 1
    if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
        return ranges[i][2]
    return ""


def parse(events: list, names, window_s: float) -> Trace:
    """A Trace from Chrome-trace events; ``names`` are the benchmark's
    range names."""
    launches: Dict[int, float] = {}
    ranges = []
    raw = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            raw.append(e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name") in names:
            ts = float(e["ts"])
            ranges.append((ts, ts + float(e.get("dur", 0.0)), e["name"]))
    ranges.sort()
    ops = []
    for e in raw:
        corr = e.get("args", {}).get("correlation")
        launched = launches.get(corr)
        rng = (range_at(ranges, launched) or OUTSIDE) if launched is not None else ""
        ops.append(DeviceOp(e.get("name", "?"), float(e["ts"]), float(e.get("dur", 0.0)), rng))
    ops.sort(key=lambda op: op.start)
    return Trace(ops, ranges, window_s)


class Tracer:
    """torch.profiler started and stopped by the caller, at points where
    the device is idle (after a synchronise); ``host`` records the host's
    operations and the benchmark's ranges ``names`` too."""

    def __init__(self, names=(), host: bool = False):
        from torch.profiler import ProfilerActivity, profile

        self.names, self.host = tuple(names), host
        acts = [ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._t0 = 0.0
        self.window_s = 0.0
        self.active = False

    def start(self) -> None:
        self._prof.start()
        self._t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.active = False

    def read(self) -> Trace:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        return parse(events, self.names, self.window_s)


def busy_s(trace: Trace) -> float:
    return union_us((op.start, op.start + op.dur) for op in trace.ops) / 1e6


def device_s(trace: Trace, range_names) -> Optional[float]:
    """Seconds of the union of the device ops launched in the named ranges,
    and of those the trace ties to no launch (so that a missing link can
    only lower a share of a bound); None when there are none."""
    names = set(range_names) | {""}
    sel = [(op.start, op.start + op.dur) for op in trace.ops if op.range in names]
    return union_us(sel) / 1e6 if sel else None


def short_name(name: str) -> str:
    """A kernel's name without its parameter list."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].strip() or name
                break
    return name[:160]


def top_ops(trace: Trace, k: int = 10) -> List[list]:
    """[[kernel name, seconds]] of the device ops that took the most time."""
    by: Dict[str, float] = {}
    for op in trace.ops:
        name = short_name(op.name)
        by[name] = by.get(name, 0.0) + op.dur / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(trace: Trace, k: int = 10) -> List[list]:
    """[[host range, seconds]]: the device's idle time between its first and
    last op, summed by the benchmark range in which each idle stretch
    starts (``harness`` for none), longest first."""
    busy = busy_intervals(trace.ops)
    by: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        name = range_at(trace.ranges, e0) or OUTSIDE
        by[name] = by.get(name, 0.0) + (s1 - e0) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
