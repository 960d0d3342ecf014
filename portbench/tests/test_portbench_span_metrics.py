"""The six per-layer metrics that read the program's spans: their readers
over a run's context, and a traced run on the CPU, where the build's spans
are recorded and the span stretch runs."""

import pytest

from conftest import ROOT
from portbench import harness, spans

from sparseharness_tpu_torch.utils.timing import Recording, Span

PORTBENCH = ROOT / "portbench"
BUILD = ("build_refused_s", "build_encode_s")
#: the four that read the span stretch's device trace: the CPU's profiler
#: records no device op, so on the CPU they read None and are left out
STRETCH = ("step_idle_us.solve", "flag_idle_us.solve", "entry_idle_us.spmv",
           "fold_device_us.spmv")


def _read(name, ctx):
    return harness.load_module(PORTBENCH / "metrics" / f"{name}.py").read(ctx)


def test_readers_find_nothing_in_an_untraced_run():
    ctx = harness.Ctx("c", {}, 16, 32)
    assert all(_read(name, ctx) is None for name in BUILD + STRETCH)


def test_build_readers_read_the_recording():
    ctx = harness.Ctx("c", {}, 16, 32)
    ctx.build_spans = Recording([
        Span("build.auto", 0, 100, -1, 0, {"variant": "sell2"}),
        Span("build.try", 0, 40, 0, 0, {"variant": "bsr_band", "outcome": "refused"}),
        Span("build.try", 40, 100, 0, 0, {"variant": "sell2", "outcome": "built"}),
        Span("build.encode", 50, 80, 2, 0, {"stage": "fold+rowsort"}),
    ], ((0, 0), (1, 0)))
    assert _read("build_refused_s", ctx) == pytest.approx(40e-9)
    assert _read("build_encode_s", ctx) == pytest.approx(30e-9)


def test_stretch_readers_read_the_span_trace():
    """One solve step holding one call: of the idle, 30 µs in ``spmv.dp``
    and 35 in ``spmv.fold`` (65 a step and a call), 20 in the flag's span;
    5 µs of device time launched in the fold."""
    rec = Recording([
        Span("fixpoint.step", 0, 100_000, -1, 0, {}),
        Span("spmv", 0, 100_000, 0, 0, {}),
        Span("spmv.dp", 0, 60_000, 1, 0, {}),
        Span("spmv.fold", 60_000, 100_000, 1, 0, {}),
        Span("fixpoint.converged", 100_000, 200_000, -1, 1, {}),
    ], ((0, 0), (1, 0)))
    ops = [spans.Op("dp", 0.0, 30.0, 10.0), spans.Op("fold", 70.0, 5.0, 65.0),
           spans.Op("flag", 110.0, 5.0, 105.0), spans.Op("next", 125.0, 5.0, None)]
    st = spans.parse([], rec, 0, 1.0)._replace(ops=ops)
    ctx = harness.Ctx("c", {}, 16, 32)
    ctx.span_trace = st
    assert _read("step_idle_us.solve", ctx) == pytest.approx(65.0)
    assert _read("flag_idle_us.solve", ctx) == pytest.approx(20.0)
    assert _read("entry_idle_us.spmv", ctx) == pytest.approx(65.0)
    assert _read("fold_device_us.spmv", ctx) == pytest.approx(5.0)


@pytest.mark.parametrize("cell", ["g500-kron-s20.bfs", "g500-kron-s20.spmv", "band-n19-b63.sssp"])
def test_traced_run_records_the_build_and_a_span_stretch(tiny, cell, monkeypatch):
    """On the CPU a traced run reports the two build metrics where its cell
    lists them (non-null) and leaves out the four stretch metrics (None
    there: no device op); its span stretch records the cell's requests."""
    read = []
    real = spans.SpanTracer.read

    def kept(self, *a, **kw):
        read.append(real(self, *a, **kw))
        return read[-1]

    monkeypatch.setattr(spans.SpanTracer, "read", kept)
    res = harness.run_cell(tiny, cell, 2**31 + 13, 0.2, True, device="cpu")["result"]
    assert res["correct"] is True
    listed = {m["name"] for m in tiny.metrics("per_layer", cell)}
    for name in BUILD:
        assert (name in res["metrics"]) == (name in listed), name
        if name in listed:
            assert res["metrics"][name]["value"] >= 0
    assert not set(STRETCH) & set(res["metrics"])
    assert len(read) == 1
    unit = "spmv" if cell.endswith(".spmv") else "fixpoint.step"
    assert read[0].ops == [] and spans.count(read[0], unit) > 0
    # the span stretch keeps to its own budget, not the traffic's 1 s
    assert read[0].window_s < spans.STRETCH_SECONDS + 0.4


def test_the_span_stretch_has_a_budget_of_its_own():
    cut = spans.stretch_traffic({"op": "solve", "trace_seconds": 1.0})
    assert cut == {"op": "solve", "trace_seconds": spans.STRETCH_SECONDS}
    assert spans.stretch_traffic({"trace_seconds": 0.1})["trace_seconds"] == 0.1
