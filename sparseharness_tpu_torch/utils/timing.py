"""Host timing: spans, and PROFILING_DATUM lines.

**Spans.** ``with span("fixpoint.step"): ...`` marks a stretch of the
host's time. Spans are kept only between :func:`start_recording` and
:func:`stop_recording`, and only on the thread that started the
recording; otherwise :func:`span` returns one shared object that does
nothing, behind one module-level flag (:data:`RECORDING`). A span keeps
its name, its start and end (``time.perf_counter_ns``), the index of the
span that holds it, its request (the index of the outermost span that
holds it, itself for an outermost span) and a few attributes. Spans stay
in memory until the recording stops, which hands them over as a
:class:`Recording`; nothing is written while they are recorded.

A recording also samples ``time.time_ns() - time.perf_counter_ns()`` when
it starts and when it stops, so that its stamps map onto Unix time, the
clock of torch.profiler's Chrome traces (``ts`` there is Unix time in ns,
less the trace's ``baseTimeNanoseconds``, over 1,000):
:meth:`Recording.trace_us`. The two samples' difference is the drift of
the two clocks over the recording.

**PROFILING_DATUM lines** have the shape ``PROFILING_DATUM("name",
"context", ms, "Python")``, the format the reference's experiment scripts
grep. They go to the stream that :func:`set_trace_stream` sets, else to
stderr when ``SPARSEHARNESS_TPU_TRACE=1`` (read once, at the first line).
:class:`ScopedTimer` is a span that also prints its line; device times
measured with CUDA events are injected through :func:`report_timing`.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import threading
import time
from typing import List, Optional, Tuple

# --------------------------------------------------------------------------
# spans

#: True while a recording runs: the one flag a span checks when off
RECORDING = False


class Span:
    """One span: its name, start and end (``perf_counter_ns``), the index
    of the span that holds it (-1: none), its request (the index of the
    outermost span that holds it) and its attributes. Entering it records
    it; ``set(**attrs)`` adds attributes, e.g. an outcome known at the end."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "attrs")

    def __init__(self, name: str, start_ns: int = 0, end_ns: int = 0, parent: int = -1,
                 request: int = -1, attrs: Optional[dict] = None):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.parent, self.request = parent, request
        self.attrs = {} if attrs is None else attrs

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, {self.parent}, "
                f"{self.request}, {self.attrs!r})")

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        rec = _rec
        if rec is None:  # the recording stopped before the span opened
            self.end_ns = -1
            return self
        rec.open(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        if not self.end_ns:  # else the recording stopped and closed it
            self.end_ns = t
            _rec.stack.pop()
        return False


class Recording(list):
    """The spans of one recording, in the order they opened. ``clock``
    holds two samples, at its start and at its stop, of (perf_counter_ns,
    time_ns − perf_counter_ns)."""

    def __init__(self, spans: List[Span], clock: Tuple[Tuple[int, int], Tuple[int, int]]):
        super().__init__(spans)
        self.clock = clock

    @property
    def drift_ns(self) -> int:
        """How far the two clocks moved apart from start to stop."""
        return self.clock[1][1] - self.clock[0][1]

    def trace_us(self, t_ns: int, base_ns: int = 0) -> float:
        """A perf_counter_ns stamp on the clock of a Chrome trace whose
        ``baseTimeNanoseconds`` is ``base_ns`` (Unix µs for 0), the offset
        interpolated between the two samples."""
        (p0, o0), (p1, o1) = self.clock
        off = o0 if p1 == p0 else o0 + (o1 - o0) * (t_ns - p0) / (p1 - p0)
        return (t_ns + off - base_ns) / 1e3

    def chrome_events(self, base_ns: int = 0, pid: int = 0, tid: int = 0) -> List[dict]:
        """The spans as complete Chrome-trace events (category
        ``program``) on that trace's clock, with a name for their row."""
        events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                   "args": {"name": "program spans"}}]
        for i, s in enumerate(self):
            ts = self.trace_us(s.start_ns, base_ns)
            events.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid,
                           "tid": tid, "ts": ts,
                           "dur": self.trace_us(s.end_ns, base_ns) - ts,
                           "args": {"index": i, "parent": s.parent, "request": s.request,
                                    **s.attrs}})
        return events


def _clock_sample() -> Tuple[int, int]:
    """(perf_counter_ns, time_ns − perf_counter_ns), the narrowest of a few
    brackets."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u - (a + b) // 2)
    return best[1], best[2]


class _Recorder:
    def __init__(self):
        self.thread = threading.get_ident()
        self.spans: List[Span] = []
        self.stack: List[int] = []
        self.clock0 = _clock_sample()

    def open(self, s: Span) -> None:
        i = len(self.spans)
        stack = self.stack
        if stack:
            s.parent, s.request = stack[-1], stack[0]
        else:
            s.request = i
        self.spans.append(s)
        stack.append(i)


_rec: Optional[_Recorder] = None


class _NoSpan:
    """What :func:`span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A context manager that records ``name`` over its block while a
    recording runs on this thread; its ``set(**attrs)`` adds attributes."""
    if not RECORDING:
        return _NO_SPAN
    rec = _rec
    if rec is None or rec.thread != threading.get_ident():
        return _NO_SPAN
    return Span(name, attrs=attrs)


def add_span(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Record a stretch already timed (perf_counter_ns stamps) as a span
    held by the innermost open span."""
    if not RECORDING:
        return
    rec = _rec
    if rec is not None and rec.thread == threading.get_ident():
        s = Span(name, start_ns, end_ns, attrs=attrs)
        rec.open(s)
        rec.stack.pop()


def start_recording() -> None:
    """Record spans opened on this thread until :func:`stop_recording`."""
    global _rec, RECORDING
    if _rec is not None:
        raise RuntimeError("spans are already being recorded")
    _rec = _Recorder()
    RECORDING = True


def stop_recording() -> Recording:
    """Stop recording and hand over its spans. A span still open ends here,
    with the attribute ``cut``."""
    global _rec, RECORDING
    rec = _rec
    if rec is None:
        raise RuntimeError("no recording to stop")
    t = time.perf_counter_ns()
    RECORDING = False
    _rec = None
    for i in rec.stack:
        rec.spans[i].end_ns = t
        rec.spans[i].attrs["cut"] = True
    return Recording(rec.spans, (rec.clock0, _clock_sample()))


# --------------------------------------------------------------------------
# PROFILING_DATUM lines

_UNSET = object()
#: a stream for :func:`set_trace_stream`: ``sys.stderr`` as it is when a
#: line is written
STDERR = object()
_stream = _UNSET


def set_trace_stream(stream) -> None:
    """Send PROFILING_DATUM lines to ``stream``, a text stream or
    :data:`STDERR` (None: stderr when SPARSEHARNESS_TPU_TRACE=1, else
    nowhere)."""
    global _stream
    _stream = _UNSET if stream is None else stream


def _emit(line: str) -> None:
    global _stream
    out = _stream
    if out is _UNSET:
        out = _stream = STDERR if os.environ.get("SPARSEHARNESS_TPU_TRACE", "0") == "1" else None
    if out is None:
        return
    (sys.stderr if out is STDERR else out).write(line + "\n")


def report_timing(name: str, context: str, ms: float, lang: str = "Python") -> None:
    """Inject an externally measured duration into the trace stream."""
    _emit(f'PROFILING_DATUM("{name}", "{context}", {ms:.6f}, "{lang}")')


class ScopedTimer(contextlib.AbstractContextManager):
    """``with ScopedTimer("build", "bsr_band"): ...`` — host wall time, a
    span (attribute ``context``) while a recording runs, and a
    PROFILING_DATUM line."""

    def __init__(self, name: str, context: str = ""):
        self.name = name
        self.context = context
        self.ms: Optional[float] = None

    def __enter__(self):
        self._span = span(self.name, context=self.context).__enter__()
        self._t0 = time.perf_counter_ns() if self._span is _NO_SPAN else self._span.start_ns
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        t1 = time.perf_counter_ns() if self._span is _NO_SPAN else self._span.end_ns
        self.ms = (t1 - self._t0) / 1e6
        report_timing(self.name, self.context, self.ms)
        return False


def timed(context: str = ""):
    """Decorator form of :class:`ScopedTimer`, named by the function's
    qualified name (the reference's start_timer(name, ctx) macro)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with ScopedTimer(fn.__qualname__, context):
                return fn(*args, **kwargs)

        return wrapper

    return deco
