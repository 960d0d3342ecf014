"""Scoped host timers with PROFILING_DATUM-compatible output.

Lines have the shape ``PROFILING_DATUM("name", "context", ms, "Python")``,
the format the reference's experiment scripts grep. They go to stderr when
``SPARSEHARNESS_TPU_TRACE=1``, or to the stream that
:func:`set_trace_stream` sets. Device times are measured by the harness
with CUDA events and injected through :func:`report_timing`.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Optional, TextIO

_stream: Optional[TextIO] = None


def set_trace_stream(stream: Optional[TextIO]) -> None:
    """Send PROFILING_DATUM lines to ``stream`` (None: stderr when
    SPARSEHARNESS_TPU_TRACE=1, else nowhere)."""
    global _stream
    _stream = stream


def _emit(line: str) -> None:
    out = _stream
    if out is None:
        if os.environ.get("SPARSEHARNESS_TPU_TRACE", "0") != "1":
            return
        out = sys.stderr
    out.write(line + "\n")


def report_timing(name: str, context: str, ms: float, lang: str = "Python") -> None:
    """Inject an externally measured duration into the trace stream."""
    _emit(f'PROFILING_DATUM("{name}", "{context}", {ms:.6f}, "{lang}")')


class ScopedTimer(contextlib.AbstractContextManager):
    """``with ScopedTimer("build", "bsr_band"): ...`` — host wall time."""

    def __init__(self, name: str, context: str = ""):
        self.name = name
        self.context = context
        self.ms: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self._t0) * 1e3
        report_timing(self.name, self.context, self.ms)
        return False

