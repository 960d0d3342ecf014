"""The port's harness pieces against the JAX package's: the JSONL and SQL
sinks render the same strings for the same record, the runfile and the
default sweep give the same points, and the host-stepped benchmark has the
record shape, warm-up and timeout of tests/test_harness.py."""

import io
import json
import statistics
import types

import numpy as np
import pytest
import torch

import sparseharness_tpu.harness as jh
from sparseharness_tpu.gold import Correctness as JaxCorrectness
from sparseharness_tpu.harness.stats import BenchRecord as JaxRecord, Statistic as JaxStatistic
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.algorithms import fixpoint_components
from sparseharness_tpu_torch.gold import Correctness, sssp_gold
from sparseharness_tpu_torch.harness import (
    BenchmarkConfig, BenchRecord, Statistic, benchmark_fixpoint_stepped, best_per_matrix,
    default_sweep, load_runfile, run_sweep, to_jsonl, to_sql, write_records,
)
from sparseharness_tpu_torch.utils import set_trace_stream

RECORDS = [
    dict(time_ns=12345.0, correctness="correct", kernel="ell", geometry="8x128", trial=0,
         iteration=0, statistic="RAW_RESULT", matrix="m.mtx", experiment_id="e1",
         device="NVIDIA H100 80GB HBM3", host="node7", nnz=100, roofline_frac=0.25),
    dict(time_ns=2.5e9, correctness="incorrect", kernel="sssp:sell", geometry="-", trial=3,
         iteration=1117, statistic="MULTI_ITERATION_SUM", matrix="band", experiment_id="",
         device="cpu", host="h", nnz=8_319_040 * 1117, roofline_frac=0.0,
         extra={"frontier_local": "sell", "sent_entries": 12}),
    dict(time_ns=0.0, correctness="not_checked", kernel="bsr_band", geometry="8x128@bfloat16",
         trial=-1, iteration=-1, statistic="MEDIAN_RESULT", matrix="a b", experiment_id="x",
         device="d", host="h", nnz=0, roofline_frac=1.5),
]


def _pair(fields):
    f = dict(fields)
    port = BenchRecord(**{**f, "correctness": Correctness(f["correctness"]),
                          "statistic": Statistic(f["statistic"])}).finalize()
    ref = JaxRecord(**{**f, "correctness": JaxCorrectness(f["correctness"]),
                       "statistic": JaxStatistic(f["statistic"])}).finalize()
    return port, ref


@pytest.mark.parametrize("fields", RECORDS, ids=["raw", "sum_extra", "median"])
def test_sinks_render_what_jax_renders(fields):
    port, ref = _pair(fields)
    assert to_jsonl(port) == jh.to_jsonl(ref)
    for table in ("table_name", "results"):
        assert to_sql(port, table) == jh.to_sql(ref, table)
    bufs = [io.StringIO() for _ in range(4)]
    write_records([port, port], jsonl=bufs[0], sql=bufs[1], table_name="t")
    jh.write_records([ref, ref], jsonl=bufs[2], sql=bufs[3], table_name="t")
    assert bufs[0].getvalue() == bufs[2].getvalue()
    assert bufs[1].getvalue() == bufs[3].getvalue()
    assert bufs[0].getvalue().count("\n") == 2


def test_sql_units_and_columns():
    port, _ = _pair(RECORDS[0])
    sql = to_sql(port, "results")
    assert sql.startswith("INSERT INTO results (") and " global, local," in sql
    assert "0.012345," in sql  # 12345 ns -> 0.012345 ms
    assert json.loads(to_jsonl(port))["gnnz_per_s"] > 0


RUNFILES = {
    "reference": "524288,1,1,128,1,1,\n16384,1,1,64,1,1,\n",
    "bins": "65536,1,1,8,1,1,\n4096,1,1,8,1,1,\n1024,1,1,256,1,1,\n8,3\nbad,row\n\n",
    "empty": "\n",
}


@pytest.mark.parametrize("name", sorted(RUNFILES))
@pytest.mark.parametrize("variant", ["bsr_pallas", "ell"])
def test_load_runfile_matches_jax(name, variant, tmp_path):
    rf = tmp_path / "runfile.csv"
    rf.write_text(RUNFILES[name])
    port, ref = load_runfile(str(rf), variant), jh.load_runfile(str(rf), variant)
    assert [p.name() for p in port] == [p.name() for p in ref]


def test_default_sweep_matches_jax():
    assert [p.name() for p in default_sweep()] == [p.name() for p in jh.default_sweep()]
    some = ["ell", "coo_seg", "sell"]
    assert ([p.name() for p in default_sweep(some)]
            == [p.name() for p in jh.default_sweep(some)])
    assert "sell@8x128" in [p.name() for p in default_sweep()]


def test_run_sweep_and_best():
    coo = tf.random_coo(150, 150, 800, seed=9)
    points = default_sweep(["ell", "coo_seg", "sell"])[:4]
    results = run_sweep({"m1": coo}, points, config=BenchmarkConfig(trials=1), device="cpu")
    assert len(results["m1"]) == len(points)
    for res in results["m1"].values():
        assert res.correctness is Correctness.CORRECT
    assert best_per_matrix(results)["m1"] in results["m1"]


def test_run_sweep_skips_what_a_build_refuses():
    coo = tf.random_coo(1138, 1138, 4054, seed=0)  # no affine band window
    results = run_sweep({"m": coo}, default_sweep(["bsr_band", "ell"]),
                        config=BenchmarkConfig(trials=1), device="cpu")
    assert sorted(results["m"]) == ["ell@8x128", "ell@8x256"]


def test_benchmark_fixpoint_stepped_records():
    g = tf.random_graph_coo(60, 2.0, seed=9)
    comp = fixpoint_components("sssp", g, root=0, device="cpu")
    # no ratchet: a slow second trial on a busy host must not stop early
    res = benchmark_fixpoint_stepped(comp, gold=sssp_gold(g, 0),
                                     config=BenchmarkConfig(trials=2, adaptive_timeout=False),
                                     matrix_name="g", kernel_name="sssp:ell")
    raws = [r for r in res.records if r.statistic is Statistic.RAW_RESULT]
    sums = [r for r in res.records if r.statistic is Statistic.MULTI_ITERATION_SUM]
    assert len(sums) == 2 and len(raws) == 2 * res.iterations
    assert res.correctness is Correctness.CORRECT and res.iterations >= 1
    assert [r.iteration for r in raws[:res.iterations]] == list(range(1, res.iterations + 1))
    assert all(r.geometry == "-" and r.device == "cpu" and r.kernel == "sssp:ell"
               for r in res.records)
    assert sums[0].time_ns == pytest.approx(sum(r.time_ns for r in raws[:res.iterations]))
    assert res.roofline_frac is None and res.device == "cpu"


def test_stepped_warmup_step_is_untimed():
    """One untimed warm-up step runs before the trials: the first step of a
    trial is no slower than the rest."""
    g = tf.random_graph_coo(64, 2.0, seed=10)
    comp = fixpoint_components("sssp", g, root=0, device="cpu")
    calls = []
    counted = types.SimpleNamespace(
        step=lambda x: calls.append(1) or comp.step(x), x0=comp.x0,
        convergence=comp.convergence, limit=comp.limit, unpermute=None)
    res = benchmark_fixpoint_stepped(counted, config=BenchmarkConfig(trials=1))
    raws = [r.time_ns for r in res.records if r.statistic is Statistic.RAW_RESULT]
    assert len(calls) == len(raws) + 1  # the warm-up step
    assert len(raws) >= 3
    assert raws[0] < 20 * statistics.median(raws)


def test_stepped_timeout_caps_iterations():
    """A non-converging stepped run stops on the wall-clock cap, and the
    breach ends the trials."""
    comp = types.SimpleNamespace(
        step=lambda x: x + 1.0, x0=torch.zeros(128), convergence=lambda a, b: torch.equal(a, b),
        limit=100_000, unpermute=None)
    res = benchmark_fixpoint_stepped(comp, config=BenchmarkConfig(trials=3, timeout_s=0.05))
    raws = [r for r in res.records if r.statistic is Statistic.RAW_RESULT]
    assert len(raws) < 100_000
    assert len([r for r in res.records if r.statistic is Statistic.MULTI_ITERATION_SUM]) == 1


def test_stepped_liveness_warns_on_noop_step(caplog):
    import logging

    comp = types.SimpleNamespace(step=lambda x: x, x0=torch.full((8,), 7.0),
                                 convergence=lambda a, b: torch.equal(a, b), limit=10,
                                 unpermute=None)
    pkg = logging.getLogger("sparseharness_tpu_torch")
    old = pkg.propagate
    pkg.propagate = True
    try:
        with caplog.at_level(logging.WARNING):
            benchmark_fixpoint_stepped(comp, config=BenchmarkConfig(trials=1))
    finally:
        pkg.propagate = old
    assert any("kernel has probably failed" in r.message for r in caplog.records)


def test_trace_stream_receives_profiling_lines():
    buf = io.StringIO()
    set_trace_stream(buf)
    try:
        g = tf.random_graph_coo(40, 2.0, seed=3)
        benchmark_fixpoint_stepped(fixpoint_components("bfs", g, device="cpu"),
                                   config=BenchmarkConfig(trials=1))
    finally:
        set_trace_stream(None)
    assert 'PROFILING_DATUM("warmup", "benchmark_fixpoint_stepped"' in buf.getvalue()


def test_checked_fixpoint_unpermutes_before_the_gold():
    g = tf.random_graph_coo(80, 2.0, seed=5)
    g = g.with_values(np.abs(g.vals) + 0.1)
    comp = fixpoint_components("sssp", g, root=4, reorder="rcm", device="cpu")
    res = benchmark_fixpoint_stepped(comp, gold=sssp_gold(g, 4),
                                     config=BenchmarkConfig(trials=1, delta=1e-5))
    assert res.correctness is Correctness.CORRECT
