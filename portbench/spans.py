"""The program's spans on the device trace: a stretch that torch.profiler
traces over the device alone, as ``trace.Tracer()`` does, while the
program records its spans (``sparseharness_tpu_torch/utils/timing.py``),
and the readers of the per-layer numbers that rest on them.

The spans' stamps are mapped onto the trace's clock by the recording's
clock samples, and then by device synchronisations marked at each end of
the stretch, whose events show how far the trace's clock has drifted.
Each device op is tied, through its correlation id, to the launch event
(``cuda_runtime`` / ``cuda_driver``) that enqueued it, and by that
launch's time to the innermost span the host was in. Each
microsecond of device idle between the stretch's first and last op is
charged to the innermost span the host was in at that time, or to
``outside``.

The set-up readers (``build_refused_s``, ``build_encode_s``) read the
spans of the program's build alone, recorded around it with no trace.
"""

from __future__ import annotations

import bisect
import gc
import json
import os
import statistics
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from portbench import trace as tracing

#: where idle time or a launch falls in no span
OUTSIDE = "outside"


class Op(NamedTuple):
    name: str
    start: float             # us, the trace's clock
    dur: float               # us
    launch: Optional[float]  # us, the launch event's start; None when not found


class MappedSpan(NamedTuple):
    name: str
    start: float     # us, the trace's clock
    end: float       # us
    parent: int
    attrs: dict


class SpanTrace(NamedTuple):
    spans: List[MappedSpan]
    ops: List[Op]
    window_s: float
    drift_ns: int    # the recording's own clock drift from its start to its stop
    #: µs added to the spans' mapped times at the start and at the end
    #: marks, interpolated between them (None without marks)
    clock_us: Optional[Tuple[float, float]] = None


#: seconds of the span stretch at most, whatever the traffic's
#: ``trace_seconds``: it runs after the device and range stretches, and
#: its readings are means over some hundreds of steps or calls at this
#: length (a Kronecker solve step takes about 0.7 ms)
STRETCH_SECONDS = 0.5
#: device synchronisations stamped at each end of a span stretch
MARKS = 5
#: µs around a mark's stamps in which its synchronisation event is sought
MARK_WINDOW_US = 100.0


def _bounds(events, marks, trace_us) -> Optional[Tuple[float, float, float]]:
    """(mapped µs, lowest, highest) offset of the trace's clock less the
    mapped one that ``marks`` allow. A mark's ``cudaDeviceSynchronize``
    event lies between its two host stamps, so the offset is at least
    (event end − second stamp) and at most (event start − first stamp);
    of the marks at one end the tightest bounds are taken."""
    syncs = sorted((float(e["ts"]), float(e.get("dur", 0.0))) for e in events
                   if e.get("ph") == "X" and e.get("cat") in tracing.LAUNCH_CATS
                   and e.get("name") == "cudaDeviceSynchronize")
    starts = [ts for ts, _ in syncs]
    times, lows, highs = [], [], []
    for a, b in marks:
        lo, hi = trace_us(a), trace_us(b)
        i = bisect.bisect_left(starts, lo - MARK_WINDOW_US)
        near = [(abs(ts - lo), ts, dur) for ts, dur in syncs[i:i + 8]
                if ts <= hi + MARK_WINDOW_US]
        if near:
            _, ts, dur = min(near)
            times.append((lo + hi) / 2)
            lows.append(ts + dur - hi)
            highs.append(ts - lo)
    if not times:
        return None
    return statistics.median(times), max(lows), min(highs)


def _clamp(x: float, lo: float, hi: float) -> float:
    return min(max(x, lo), hi) if lo <= hi else (lo + hi) / 2


def parse(events: list, recording, base_ns: int, window_s: float, marks=()) -> SpanTrace:
    """A SpanTrace from Chrome-trace events and the spans recorded over
    them (a ``timing.Recording``). ``marks`` are (before, after)
    perf_counter_ns stamps around device synchronisations at the start
    and the end of the stretch: the trace's device clock may drift against
    the host's (10 µs over a 0.3 s solve on one H100, under 1 µs a second
    on another), and the offset each end's marks bound, interpolated
    between them, is added to every span."""
    launches: Dict[int, float] = {}
    raw = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in tracing.DEVICE_CATS:
            raw.append(e)
        elif cat in tracing.LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
    ops = sorted((Op(e.get("name", "?"), float(e["ts"]), float(e.get("dur", 0.0)),
                     launches.get(e.get("args", {}).get("correlation"))) for e in raw),
                 key=lambda op: op.start)

    def mapped(t_ns: int) -> float:
        return recording.trace_us(t_ns, base_ns)

    half = len(marks) // 2
    first = _bounds(events, marks[:half], mapped)
    last = _bounds(events, marks[half:], mapped) or first
    clock = shift = None
    if first:
        # the recording's own mapping where the start marks allow it, moved
        # by as far as the lower bounds (the tighter ones: a call returns to
        # its second stamp within a few µs, while it may reach the device
        # tens of µs after its first) move from start to end
        (t0, low0, high0), (t1, low1, high1) = first, last
        r0 = _clamp(0.0, low0, high0)
        r1 = _clamp(r0 + low1 - low0, low1, high1)
        clock = (r0, r1)

        def shift(u: float) -> float:
            return r0 if t1 == t0 else r0 + (r1 - r0) * (u - t0) / (t1 - t0)

    spans = []
    for s in recording:
        u0, u1 = mapped(s.start_ns), mapped(s.end_ns)
        if shift is not None:
            u0, u1 = u0 + shift(u0), u1 + shift(u1)
        spans.append(MappedSpan(s.name, u0, u1, s.parent, s.attrs))
    return SpanTrace(spans, ops, window_s, recording.drift_ns, clock)


def stretch_traffic(traffic: dict) -> dict:
    """The traffic as the span stretch runs it: its ``trace_seconds`` cut
    to :data:`STRETCH_SECONDS`."""
    return dict(traffic, trace_seconds=min(float(traffic["trace_seconds"]), STRETCH_SECONDS))


def _mark(torch) -> Tuple[int, int]:
    """A device synchronisation between two host stamps, then a pause that
    keeps the next mark's event apart from this one's."""
    a = time.perf_counter_ns()
    torch.cuda.synchronize()
    b = time.perf_counter_ns()
    time.sleep(2 * MARK_WINDOW_US / 1e6)
    return a, b


class SpanTracer(tracing.Tracer):
    """``trace.Tracer()`` over the device alone, with the program's spans
    recorded from just after the profiler starts to just after it stops,
    and :data:`MARKS` device synchronisations stamped at each end for the
    clock's drift; ``read()`` gives a SpanTrace. It collects the garbage
    first: a full collection that the spans' allocations set off inside the
    stretch would stall the host for as long as the heap takes to walk."""

    def __init__(self):
        super().__init__()
        self.recording = None
        self.marks: List[Tuple[int, int]] = []
        self._trace: Optional[dict] = None

    def start(self) -> None:
        import torch

        from sparseharness_tpu_torch.utils import timing

        gc.collect()
        super().start()
        timing.start_recording()
        if torch.cuda.is_available():
            self.marks = [_mark(torch) for _ in range(MARKS)]

    def stop(self) -> None:
        import torch

        from sparseharness_tpu_torch.utils import timing

        if torch.cuda.is_available():
            self.marks += [_mark(torch) for _ in range(MARKS)]
        super().stop()
        self.recording = timing.stop_recording()

    def trace(self) -> dict:
        """The Chrome trace, exported once (the profiler saves it once)."""
        if self._trace is None:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self._trace = json.load(f)
        return self._trace

    def read(self, marks: bool = True) -> SpanTrace:
        """The SpanTrace, its spans corrected by the marks (or not)."""
        data = self.trace()
        return parse(data.get("traceEvents", []), self.recording,
                     int(data.get("baseTimeNanoseconds", 0)), self.window_s,
                     self.marks if marks else ())


class Timeline:
    """The innermost span at each instant: boundaries ``times`` and, over
    [times[i], times[i + 1]), the span index ``labels[i]`` (-1: none)."""

    def __init__(self, spans: List[MappedSpan]):
        marks = []
        for i, s in enumerate(spans):
            marks.append((s.start, 1, i, i))    # opens: the outer (lower index) first
            marks.append((s.end, 0, -i, i))     # closes before opens; the inner first
        marks.sort()
        self.times: List[float] = []
        self.labels: List[int] = []
        stack: List[int] = []
        for t, kind, _, i in marks:
            if kind:
                stack.append(i)
            else:  # remove i, the last of the stack but for overlapping spans
                j = len(stack) - 1
                while stack[j] != i:
                    j -= 1
                del stack[j]
            label = stack[-1] if stack else -1
            if self.times and self.times[-1] == t:
                self.labels[-1] = label
            else:
                self.times.append(t)
                self.labels.append(label)

    def at(self, t: float) -> int:
        i = bisect.bisect_right(self.times, t) - 1
        return self.labels[i] if i >= 0 else -1

    def charge(self, t0: float, t1: float, into: Dict[int, float]) -> None:
        """Add the length of [t0, t1) to ``into``, split by innermost span."""
        i = max(bisect.bisect_right(self.times, t0) - 1, 0)
        lo = t0
        while lo < t1:
            if i >= len(self.times) or self.times[i] > lo:
                label, hi = -1, self.times[i] if i < len(self.times) else t1
            else:
                label, hi = self.labels[i], self.times[i + 1] if i + 1 < len(self.times) else t1
                i += 1
            hi = min(hi, t1)
            into[label] = into.get(label, 0.0) + hi - lo
            lo = hi


def tied(st: SpanTrace) -> List[Optional[int]]:
    """For each op, the innermost span that held its launch (-1: none),
    None when the trace has no launch event for it."""
    tl = Timeline(st.spans)
    return [None if op.launch is None else tl.at(op.launch) for op in st.ops]


def charged_idle_us(st: SpanTrace) -> Dict[int, float]:
    """{span index (-1: none): us of device idle charged to it}."""
    tl, out = Timeline(st.spans), {}
    busy = tracing.busy_intervals(st.ops)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        tl.charge(e0, s1, out)
    return out


def idle_total_us(st: SpanTrace) -> float:
    busy = tracing.busy_intervals(st.ops)
    return sum(s1 - e0 for (_, e0), (s1, _) in zip(busy, busy[1:]))


def under(spans: List[MappedSpan], i: int, name: str) -> bool:
    """Whether span i, or a span that holds it, is named ``name``."""
    while i >= 0:
        if spans[i].name == name:
            return True
        i = spans[i].parent
    return False


def count(st: SpanTrace, name: str) -> int:
    """Spans of ``name`` that ended before the recording stopped."""
    return sum(s.name == name and not s.attrs.get("cut") for s in st.spans)


def idle_spans(st: SpanTrace, k: int = 10) -> List[list]:
    """[[span name, seconds]] of device idle, by the innermost span the host
    was in (``outside`` for none), longest first."""
    by: Dict[str, float] = {}
    for i, us in charged_idle_us(st).items():
        name = st.spans[i].name if i >= 0 else OUTSIDE
        by[name] = by.get(name, 0.0) + us / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_under_us(st: SpanTrace, name: str) -> float:
    return sum(us for i, us in charged_idle_us(st).items() if i >= 0 and under(st.spans, i, name))


def device_under_us(st: SpanTrace, name: str) -> float:
    """Device time (the union) of the ops launched inside ``name`` spans."""
    sel = [(op.start, op.start + op.dur) for op, i in zip(st.ops, tied(st))
           if i is not None and i >= 0 and under(st.spans, i, name)]
    return tracing.union_us(sel)


def launches_per_unit(st: SpanTrace, unit: str) -> List[int]:
    """The launches held by each complete ``unit`` span and its spans."""
    held = {i: 0 for i, s in enumerate(st.spans) if s.name == unit and not s.attrs.get("cut")}
    for i in tied(st):
        while i is not None and i >= 0 and i not in held:
            i = st.spans[i].parent
        if i is not None and i >= 0:
            held[i] += 1
    return list(held.values())


def alignment(st: SpanTrace, request: str, unit: str) -> dict:
    """How well the spans hold the trace: the share of ops with a launch
    event that launched inside a ``request`` span; the ops launched outside
    any span, by name; the share of ``unit`` spans (a step, a call) that
    hold the most common number of launches; the idle charged against the
    stretch's idle; the recording's clock drift and the trace clock's
    offset at each end."""
    per = launches_per_unit(st, unit)
    links = tied(st)
    launched = [(op, i) for op, i in zip(st.ops, links) if i is not None]
    inside = sum(i >= 0 and under(st.spans, i, request) for _, i in launched)
    outside: Dict[str, int] = {}
    for op, i in launched:
        if i < 0:
            name = tracing.short_name(op.name)
            outside[name] = outside.get(name, 0) + 1
    return {"ops": len(st.ops), "launched": len(launched),
            "inside_share": inside / len(launched) if launched else None,
            "outside_ops": outside,
            "unit_launches": max(set(per), key=per.count) if per else None,
            "unit_mode_share": per.count(max(set(per), key=per.count)) / len(per) if per else None,
            "idle_us": idle_total_us(st), "charged_us": sum(charged_idle_us(st).values()),
            "drift_ns": st.drift_ns, "clock_us": st.clock_us}


# --------------------------------------------------------------------------
# readers of the per-layer numbers

def build_refused_s(recording) -> Optional[float]:
    """Seconds of the ``build.try`` spans that the variant refused."""
    tries = [s for s in recording if s.name == "build.try"]
    if not tries:
        return None
    return sum(s.seconds for s in tries if s.attrs.get("outcome") == "refused")


def build_encode_s(recording) -> Optional[float]:
    """Seconds of the ``build.encode`` spans under the ``built`` try."""
    built = {i for i, s in enumerate(recording)
             if s.name == "build.try" and s.attrs.get("outcome") == "built"}
    if not built:
        return None
    return sum(s.seconds for s in recording if s.name == "build.encode" and s.parent in built)


def _per(st: Optional[SpanTrace], total_us, unit: str) -> Optional[float]:
    n = count(st, unit) if st is not None and st.ops else 0
    return total_us(st) / n if n else None


def step_idle_us(st: Optional[SpanTrace]) -> Optional[float]:
    """Device idle charged to ``fixpoint.step`` and the spans it holds, a step."""
    return _per(st, lambda t: idle_under_us(t, "fixpoint.step"), "fixpoint.step")


def flag_idle_us(st: Optional[SpanTrace]) -> Optional[float]:
    """Device idle charged to ``fixpoint.converged``, a step."""
    return _per(st, lambda t: idle_under_us(t, "fixpoint.converged"), "fixpoint.step")


def entry_idle_us(st: Optional[SpanTrace]) -> Optional[float]:
    """Device idle charged to ``spmv`` and the spans it holds, a call."""
    return _per(st, lambda t: idle_under_us(t, "spmv"), "spmv")


def fold_device_us(st: Optional[SpanTrace]) -> Optional[float]:
    """Device time of the ops launched inside ``spmv.fold``, a call."""
    return _per(st, lambda t: device_under_us(t, "spmv.fold"), "spmv")
