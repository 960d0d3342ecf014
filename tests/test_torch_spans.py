"""The port's span recorder (``utils/timing.py``) and the spans the program
opens: their nesting, parents, requests and attributes; nothing recorded
and one shared no-op while off; the fixpoint loop, the ``auto`` build and
the sell2 encode under recording; and the map of span stamps onto a
torch.profiler Chrome trace. CPU only."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sparseharness_tpu_torch.algorithms import apps
from sparseharness_tpu_torch.algorithms.fixpoint import run_fixpoint, run_fixpoint_stepped
from sparseharness_tpu_torch.formats import random_coo, random_graph_coo
from sparseharness_tpu_torch.ops import registry, sell2
from sparseharness_tpu_torch.semiring import PLUS_TIMES, get_semiring
from sparseharness_tpu_torch.utils import ScopedTimer, timing
from sparseharness_tpu_torch.utils.timing import add_span, span


@pytest.fixture
def recording():
    """Start a recording; stop it after the test if the test did not."""
    timing.start_recording()
    yield
    if timing.RECORDING:
        timing.stop_recording()


def test_spans_nest_with_parents_requests_and_attrs(recording):
    with span("a", variant="x") as a:
        with span("b"):
            with span("c"):
                pass
        add_span("done", 5, 9, stage="s")
        with span("d"):
            pass
        a.set(outcome="built")
    with span("e"):
        pass
    rec = timing.stop_recording()
    assert [s.name for s in rec] == ["a", "b", "c", "done", "d", "e"]
    assert [s.parent for s in rec] == [-1, 0, 1, 0, 0, -1]
    assert [s.request for s in rec] == [0, 0, 0, 0, 0, 5]
    assert rec[0].attrs == {"variant": "x", "outcome": "built"}
    assert rec[3].attrs == {"stage": "s"} and (rec[3].start_ns, rec[3].end_ns) == (5, 9)
    for s in (rec[1], rec[2], rec[4]):
        p = rec[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert rec[4].start_ns >= rec[1].end_ns and rec[5].start_ns >= rec[0].end_ns


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert not timing.RECORDING
    first, second = span("a", k=1), span("b")
    assert first is second
    with first as s:
        s.set(outcome="x")
    add_span("c", 0, 1)
    timing.start_recording()
    rec = timing.stop_recording()
    assert rec == [] and not timing.RECORDING
    with pytest.raises(RuntimeError):
        timing.stop_recording()


def test_stop_closes_open_spans_and_timer_is_a_span(recording):
    with ScopedTimer("warmup", "ctx") as timer:
        with span("inner"):
            rec = timing.stop_recording()
            with span("after"):  # recording off: not kept
                pass
    assert [s.name for s in rec] == ["warmup", "inner"]
    assert all(s.attrs.get("cut") for s in rec) and rec[0].attrs["context"] == "ctx"
    assert timer.ms == pytest.approx(rec[0].seconds * 1e3, abs=1e-9)
    assert rec[0].end_ns == rec[1].end_ns and rec.drift_ns == rec.clock[1][1] - rec.clock[0][1]


def _components(algo: str):
    g = random_graph_coo(200, 3.0, seed=11)
    g = g.with_values(np.abs(g.vals) + 0.1)
    return apps.fixpoint_components(algo, g, 3, variant="auto", device="cpu")


@pytest.mark.parametrize("algo", ["sssp", "bfs"])
def test_fixpoint_spans_leave_the_solve_unchanged(algo):
    comp = _components(algo)

    def solve():
        return run_fixpoint(comp.step, comp.x0, convergence=comp.convergence,
                            max_iter=comp.limit)

    off = solve()
    timing.start_recording()
    on = solve()
    rec = timing.stop_recording()
    assert torch.equal(off.x, on.x) and off.iterations == on.iterations > 1
    assert off.converged and on.converged
    names = [s.name for s in rec]
    assert names.count("fixpoint.solve") == 1 and rec[0].name == "fixpoint.solve"
    assert rec[0].attrs == {"iterations": on.iterations}
    for name in ("fixpoint.step", "fixpoint.converged", "spmv", "spmv.dp", "spmv.fold"):
        assert names.count(name) == on.iterations, name
    assert all(s.request == 0 for s in rec)
    for s in rec:
        if s.name in ("fixpoint.step", "fixpoint.converged"):
            assert s.parent == 0
        if s.name in ("spmv.dp", "spmv.fold"):
            assert rec[s.parent].name == "spmv" and rec[rec[s.parent].parent].name == "fixpoint.step"

    timing.start_recording()
    stepped = list(run_fixpoint_stepped(comp.step, comp.x0, convergence=comp.convergence,
                                        max_iter=comp.limit))
    rec = timing.stop_recording()
    assert torch.equal(stepped[-1][0], off.x) and len(stepped) == off.iterations
    top = [s.name for s in rec if s.parent == -1]
    assert top == ["fixpoint.step", "fixpoint.converged"] * off.iterations


def test_auto_build_records_refused_tries_before_the_built_one(recording):
    coo = random_coo(3000, 3000, 20000, seed=1)
    variant, _ = registry.build_operand_auto(coo, PLUS_TIMES, device="cpu")
    rec = timing.stop_recording()
    assert rec[0].name == "build.auto" and rec[0].attrs == {"variant": variant}
    tries = [s for s in rec if s.name == "build.try"]
    assert all(s.parent == 0 for s in tries)
    assert [s.attrs["variant"] for s in tries] == list(
        registry.AUTO_CHAIN[:registry.AUTO_CHAIN.index(variant) + 1])
    assert [s.attrs["outcome"] for s in tries] == ["refused"] * (len(tries) - 1) + ["built"]
    assert len(tries) >= 2
    assert all(a.end_ns <= b.start_ns for a, b in zip(tries, tries[1:]))


def test_encode_record_seconds_are_its_encode_spans(recording, monkeypatch):
    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "0")
    coo = random_coo(sell2.SLAB_ROWS + 3000, 900, 40_000, seed=1)  # two slabs
    rec = sell2.EncodeRecord()
    sell2.build_sell2(coo, get_semiring("min_plus"), device="cpu", record=rec)
    spans = timing.stop_recording()
    assert all(s.name == "build.encode" and s.parent == -1 for s in spans)
    by_stage = {}
    for s in spans:
        by_stage[s.attrs["stage"]] = by_stage.get(s.attrs["stage"], 0.0) + \
            (s.end_ns - s.start_ns) / 1e9
    assert by_stage == rec.seconds
    assert {"fold+rowsort", "heavy-split", "numpy-slab", "bucket+upload", "plan"} <= set(by_stage)
    assert all(a.end_ns == b.start_ns for a, b in zip(spans, spans[1:]))


def test_span_maps_onto_the_profiler_trace(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timing.start_recording()
        with span("outer"):
            with record_function("inner"):
                torch.ones(64).sum()
        rec = timing.stop_recording()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    inner = next(e for e in trace["traceEvents"]
                 if e.get("name") == "inner" and e.get("ph") == "X")
    start, end = rec.trace_us(rec[0].start_ns, base), rec.trace_us(rec[0].end_ns, base)
    assert start - 1000 <= inner["ts"] and inner["ts"] + inner["dur"] <= end + 1000
    event = [e for e in rec.chrome_events(base, pid=7) if e["ph"] == "X"][0]
    assert event["cat"] == "program" and event["ts"] == start
    assert event["dur"] == pytest.approx(end - start)
