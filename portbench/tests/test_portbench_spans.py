"""The span reader (``spans.py``): the program's spans on a synthetic
device trace, the six per-layer numbers read from them, and the span
stretch on the CPU."""

import json

import pytest

from portbench import harness, spans

from sparseharness_tpu_torch.utils.timing import Recording, Span

US = 1000  # ns

#: (name, start us, end us, parent, attrs): one solve of two steps
SOLVE = [
    ("fixpoint.solve", 0, 1000, -1, {"iterations": 2}),
    ("fixpoint.step", 0, 300, 0, {}),
    ("spmv", 10, 290, 1, {"variant": "sell2"}),
    ("spmv.dp", 20, 200, 2, {}),
    ("spmv.fold", 200, 280, 2, {}),
    ("fixpoint.converged", 300, 500, 0, {}),
    ("fixpoint.step", 500, 800, 0, {}),
    ("spmv", 510, 790, 6, {"variant": "sell2"}),
    ("spmv.dp", 520, 700, 7, {}),
    ("spmv.fold", 700, 780, 7, {}),
    ("fixpoint.converged", 800, 1000, 0, {}),
]
#: (name, launch us or None, start us, end us)
OPS = [
    ("dp", 30, 100, 250), ("fill", 210, 250, 260), ("add", 220, 260, 270),
    ("flag", 310, 400, 410),
    ("dp", 530, 600, 750), ("fill", 710, 750, 760), ("add", 720, 760, 770),
    ("flag", 810, 850, 860),
    ("x0_copy", 1050, 1100, 1110),   # launched outside every span
    ("unlinked", None, 1200, 1210),  # no launch event in the trace
]


def _recording(rows, clock=((0, 0), (1, 0))):
    return Recording([Span(n, s * US, e * US, p, 0, dict(a)) for n, s, e, p, a in rows], clock)


def _events(ops):
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": float(launch),
           "dur": 5.0, "args": {"correlation": i}}
          for i, (_, launch, _, _) in enumerate(ops) if launch is not None]
    ev += [{"ph": "X", "cat": "kernel", "name": name, "ts": float(s), "dur": float(e - s),
            "args": {"correlation": i}} for i, (name, _, s, e) in enumerate(ops)]
    return ev


@pytest.fixture
def solve_trace():
    return spans.parse(_events(OPS), _recording(SOLVE), 0, 1.0)


def test_idle_is_charged_to_the_innermost_span(solve_trace):
    st = solve_trace
    assert spans.idle_total_us(st) == 730.0
    assert sum(spans.charged_idle_us(st).values()) == pytest.approx(730.0)
    got = spans.idle_spans(st)
    assert [n for n, _ in got[:3]] == ["fixpoint.converged", "outside", "spmv.dp"]
    assert dict(got) == pytest.approx({
        "fixpoint.converged": 380e-6, "outside": 190e-6, "spmv.dp": 80e-6,
        "fixpoint.step": 30e-6, "spmv": 30e-6, "spmv.fold": 20e-6})
    assert spans.tied(st) == [3, 4, 4, 5, 8, 9, 9, 10, -1, None]


@pytest.mark.parametrize("reader, value", [
    ("step_idle_us", 80.0), ("flag_idle_us", 190.0),
    ("entry_idle_us", 65.0), ("fold_device_us", 20.0)])
def test_stretch_readers(solve_trace, reader, value):
    assert getattr(spans, reader)(solve_trace) == pytest.approx(value)
    assert getattr(spans, reader)(None) is None
    assert getattr(spans, reader)(solve_trace._replace(ops=[])) is None


def test_alignment_and_cut_spans(solve_trace):
    a = spans.alignment(solve_trace, "fixpoint.solve", "fixpoint.step")
    assert (a["ops"], a["launched"], a["inside_share"]) == (10, 9, 8 / 9)
    assert (a["unit_launches"], a["unit_mode_share"]) == (3, 1.0)
    assert spans.launches_per_unit(solve_trace, "fixpoint.converged") == [1, 1]
    assert a["outside_ops"] == {"x0_copy": 1} and a["idle_us"] == a["charged_us"]
    cut = spans.parse(_events(OPS), _recording(
        SOLVE + [("fixpoint.step", 1000, 1300, -1, {"cut": True})]), 0, 1.0)
    assert spans.count(cut, "fixpoint.step") == 2


def test_spans_map_by_the_recordings_clock():
    """Stamps move by the recording's offset, drifting linearly from its
    start sample to its stop sample, and by the trace's base."""
    rec = _recording([("a", 500, 600, -1, {})], clock=((0, 5_000), (1_000_000, 7_000)))
    st = spans.parse([], rec, 2_000, 1.0)
    assert st.spans[0].start == pytest.approx((500_000 + 6_000 - 2_000) / 1e3)
    assert st.spans[0].end == pytest.approx((600_000 + 6_200 - 2_000) / 1e3)
    assert st.drift_ns == 2_000


def test_marks_remove_the_trace_clocks_drift():
    """Synchronisation events 2 µs late at the start marks and 12 µs late
    at the end marks, each 2 µs long inside 6 µs of host stamps, bound the
    offset to [late − 2, late + 2]: the start keeps the recording's own
    mapping (0 lies in its bounds), the end moves by the lower bounds'
    10 µs, and each span by the offset interpolated at its time. Events
    20 µs late at the start rule 0 out: the start then takes 18."""
    def sync(mid_us, late_us):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
                "ts": mid_us + late_us - 1.0, "dur": 2.0, "args": {"correlation": -1}}

    marks = [((t - 3) * US, (t + 3) * US) for t in (0, 400, 800)]
    marks += [((t - 3) * US, (t + 3) * US) for t in (9_000, 9_400, 9_800)]
    events = [sync(t, 2.0) for t in (0, 400, 800)] + [sync(t, 12.0) for t in (9_000, 9_400, 9_800)]
    rec = _recording([("a", 400, 9_400, -1, {}), ("b", 4_900, 5_000, 0, {})])
    st = spans.parse(events, rec, 0, 1.0, marks)
    assert st.clock_us == pytest.approx((0.0, 10.0))
    assert (st.spans[0].start, st.spans[0].end) == pytest.approx((400.0, 9_410.0))
    assert st.spans[1].start == pytest.approx(4_900 + 10.0 * 4_500 / 9_000)
    assert spans.parse(events, rec, 0, 1.0).clock_us is None
    late = [sync(t, 20.0) for t in (0, 400, 800)] + events[3:]
    assert spans.parse(late, rec, 0, 1.0, marks).clock_us == pytest.approx((18.0, 10.0))
    far = [dict(e, ts=e["ts"] + 5_000) for e in events]  # past the window: no match
    assert spans.parse(far, rec, 0, 1.0, marks).spans[0].start == 400.0


def test_build_readers():
    rec = Recording([
        Span("build.auto", 0, 100, -1, 0, {"variant": "sell2"}),
        Span("build.try", 0, 10, 0, 0, {"variant": "bsr_band", "outcome": "refused"}),
        Span("build.try", 10, 30, 0, 0, {"variant": "bsr_fused", "outcome": "refused"}),
        Span("build.encode", 12, 20, 2, 0, {"stage": "plan"}),
        Span("build.try", 30, 100, 0, 0, {"variant": "sell2", "outcome": "built"}),
        Span("build.encode", 35, 45, 4, 0, {"stage": "fold+rowsort"}),
        Span("build.encode", 45, 90, 4, 0, {"stage": "native-slab"}),
    ], ((0, 0), (1, 0)))
    assert spans.build_refused_s(rec) == pytest.approx(30e-9)
    assert spans.build_encode_s(rec) == pytest.approx(55e-9)
    assert spans.build_refused_s(Recording([], rec.clock)) is None
    assert spans.build_encode_s(Recording([], rec.clock)) is None


@pytest.mark.parametrize("cell, unit", [("band-n19-b63.spmv", "spmv"),
                                        ("g500-kron-s20.sssp", "fixpoint.step")])
def test_span_stretch_on_the_cpu(tiny, cell, unit):
    """A driver's stretch under the SpanTracer records the program's spans
    (no device ops on the CPU, so the stretch readers find nothing)."""
    import torch

    from sparseharness_tpu_torch.formats.sparse import COO
    from sparseharness_tpu_torch.ops import Geometry

    c = tiny.cell(cell)
    cfg, traffic = tiny.config(c["config"]), tiny.traffic(c["traffic"])
    traffic = dict(traffic, trace_seconds=0.2)
    gen = harness.load_module(tiny.here / "graphs" / f"{cfg['generator']}.py")
    driver = harness.load_module(tiny.here / "drivers" / f"{traffic['op']}.py")
    ref = harness.load_module(tiny.here / "reference" / f"{driver.reference_name(traffic)}.py")
    rows, cols, vals, n = gen.make(cfg["params"], 5, "cpu")
    req = driver.requests(traffic, 5, n, rows, cols, "cpu")
    coo = COO(rows.to(torch.int32).numpy(), cols.to(torch.int32).numpy(), vals.numpy(), (n, n))
    ctx = harness.Ctx(cell, traffic, n, coo.nnz)
    d = driver.Driver(ctx, coo, req, Geometry(), torch.device("cpu"), 5, ref)
    d.build()
    d.warm_up()
    st, units = d._stretch(traffic, spans.SpanTracer())
    assert units > 0 and spans.count(st, unit) == units
    assert st.ops == [] and spans.step_idle_us(st) is None and spans.entry_idle_us(st) is None
    assert abs(st.drift_ns) < 1e6
    json.dumps(spans.alignment(st, "fixpoint.solve" if unit != "spmv" else "spmv", unit))


@pytest.mark.cuda
def test_span_stretch_on_the_card(tiny, cuda):
    """On the card, after the marks' correction, the steps of a band
    stretch hold one number of launches (99% of them at least: a launch at
    a span's edge may fall to its neighbour), and the clock's offset is
    measured at both ends."""
    import torch

    from sparseharness_tpu_torch.formats.sparse import COO
    from sparseharness_tpu_torch.ops import Geometry

    cell = "band-n19-b63.sssp"
    c = tiny.cell(cell)
    cfg, traffic = tiny.config(c["config"]), tiny.traffic(c["traffic"])
    gen = harness.load_module(tiny.here / "graphs" / f"{cfg['generator']}.py")
    driver = harness.load_module(tiny.here / "drivers" / "solve.py")
    ref = harness.load_module(tiny.here / "reference" / "sssp.py")
    rows, cols, vals, n = gen.make(cfg["params"], 5, cuda)
    req = driver.requests(traffic, 5, n, rows, cols, cuda)
    coo = COO(rows.to(torch.int32).cpu().numpy(), cols.to(torch.int32).cpu().numpy(),
              vals.cpu().numpy(), (n, n))
    d = driver.Driver(harness.Ctx(cell, traffic, n, coo.nnz), coo, req, Geometry(), cuda, 5, ref)
    d.build()
    d.warm_up()
    st, steps = d._stretch(traffic, spans.SpanTracer())
    assert st.clock_us is not None and steps > 100
    a = spans.alignment(st, "fixpoint.solve", "fixpoint.step")
    assert a["unit_launches"] >= 1 and a["unit_mode_share"] >= 0.99, a
