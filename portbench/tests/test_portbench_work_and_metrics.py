"""The yardstick (``work.py``) and every per-layer metric reader, on
synthetic traces."""

import ast
from pathlib import Path

import pytest

from portbench import harness, trace, work

PORTBENCH = Path(__file__).resolve().parents[1]
BAND_N, BAND_ENTRIES = 1 << 19, 66_580_544


def test_band_bytes_and_bound():
    assert work.spmv_bytes(BAND_N, BAND_N, BAND_ENTRIES) == 270_516_480
    assert work.spmv_bound_s(BAND_N, BAND_N, BAND_ENTRIES) == pytest.approx(80.75e-6, rel=1e-4)
    assert work.H100_HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("variant", ["bsr_band", "ell", "coo_seg"])
def test_bound_counts_the_matrix_not_the_operand(variant):
    """The cell's bound is the same whichever variant's operand exists."""
    from sparseharness_tpu_torch.formats import banded_coo
    from sparseharness_tpu_torch.ops import build_operand
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    coo = banded_coo(2048, 7, seed=1)
    op = build_operand(coo, PLUS_TIMES, variant, device="cpu")
    ctx = harness.Ctx("c", {}, 2048, coo.nnz)
    assert op is not None
    assert ctx.bound_s == work.spmv_bound_s(2048, 2048, coo.nnz)
    assert ctx.bound_s == 4 * (coo.nnz + 2 * 2048) / 3.35e12


def test_no_import_reaches_the_programs_roofline():
    for path in PORTBENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            assert not any("roofline" in n for n in names), (path, names)


def _op(name, start, dur, rng):
    return trace.DeviceOp(name, float(start), float(dur), rng)


def _read(name, ctx):
    return harness.load_module(PORTBENCH / "metrics" / f"{name}.py").read(ctx)


def _ctx(**kw):
    ctx = harness.Ctx("c", {}, BAND_N, BAND_ENTRIES)
    for k, v in kw.items():
        setattr(ctx, k, v)
    return ctx


def test_parse_ties_ops_to_ranges():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "spmv", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "spmv", "ts": 20, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 40, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 22, "dur": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 41, "dur": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k1(int)", "ts": 5, "dur": 30, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k1(int)", "ts": 35, "dur": 30, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 5, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 80, "dur": 5, "args": {"correlation": 99}},
        {"ph": "i", "cat": "kernel", "name": "ignored", "ts": 0},
    ]
    tr = trace.parse(events, ("spmv",), 1e-4)
    assert [op.range for op in tr.ops] == ["spmv", "spmv", trace.OUTSIDE, ""]
    assert trace.busy_s(tr) == pytest.approx(70e-6)
    assert trace.device_s(tr, ("spmv",)) == pytest.approx(65e-6)  # 5..65, and the unlinked memset
    assert trace.top_ops(tr)[0] == ["k1", pytest.approx(60e-6)]
    gaps = dict(trace.idle_gaps(tr))
    assert gaps == {trace.OUTSIDE: pytest.approx(10e-6)}  # 65..70 and 75..80, in no range


def test_union_and_names():
    assert trace.union_us([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    assert trace.short_name("void f<(anonymous namespace)::A>(int, float)") == \
        "void f<(anonymous namespace)::A>"


def test_roofline_readers():
    bound_us = work.spmv_bound_s(BAND_N, BAND_N, BAND_ENTRIES) * 1e6
    ops = [_op("k", i * 200, 100, "spmv") for i in range(10)] + [_op("k", 5000, 100, trace.OUTSIDE)]
    rt = trace.Trace(ops, [], 1e-2)
    got = _read("kernel_roofline.spmv", _ctx(range_trace=rt, traced_calls=10))
    assert got == pytest.approx(100 * bound_us / 100)
    ops = [_op("k", i * 300, 90, "fixpoint.step") for i in range(4)] + \
        [_op("eq", i * 300 + 100, 10, "fixpoint.converged") for i in range(4)]
    rt = trace.Trace(ops, [], 1e-2)
    got = _read("kernel_roofline.solve", _ctx(range_trace=rt, traced_steps=4))
    assert got == pytest.approx(100 * bound_us / 90)
    assert _read("kernel_roofline.solve", _ctx()) is None
    assert _read("kernel_roofline.spmv", _ctx(range_trace=trace.Trace([], [], 1.0), traced_calls=3)) is None


@pytest.mark.parametrize("name", ["device_idle.spmv", "device_idle.solve"])
def test_idle_readers(name):
    ops = [_op("k", 0, 300_000, "")] + [_op("k", 500_000, 300_000, "")]
    assert _read(name, _ctx(trace=trace.Trace(ops, [], 1.0))) == pytest.approx(40.0)
    assert _read(name, _ctx(trace=trace.Trace([], [], 1.0))) is None
    assert _read(name, _ctx()) is None


def test_host_readers():
    ctx = _ctx(build_s=12.5, solve_s=[0.01, 0.03], iterations=[10, 30],
               enqueue_s=[80e-6, 90e-6, 200e-6])
    assert _read("build_s", ctx) == 12.5
    assert _read("step_us.solve", ctx) == pytest.approx(1000.0)
    assert _read("steps_per_solve.solve", ctx) == 20
    assert _read("enqueue_us.spmv", ctx) == pytest.approx(90.0)
    empty = _ctx()
    assert all(_read(n, empty) is None
               for n in ("build_s", "step_us.solve", "steps_per_solve.solve", "enqueue_us.spmv"))


def test_every_per_layer_metric_has_a_reader(spec):
    for m in spec["per_layer"]:
        assert hasattr(harness.load_module(PORTBENCH / "metrics" / f"{m['name']}.py"), "read")
