"""The port's fixpoint apps and benchmark harness against the JAX package
on the same seeded matrices: sssp, bfs, pagerank, connected_components and
widest_path must agree on x, iterations and converged (pagerank's x within
1e-6, since plus_times sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparseharness_tpu.algorithms as ja
import sparseharness_tpu.formats as jf
from sparseharness_tpu.algorithms.fixpoint import (
    exact_converged as jax_exact, run_fixpoint as jax_run_fixpoint,
)
import sparseharness_tpu_torch.algorithms as ta
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.algorithms import exact_converged, run_fixpoint
from sparseharness_tpu_torch.gold import (
    Correctness, bfs_levels_gold, connected_components_gold, pagerank_gold, spmv_abs_bound,
    spmv_gold, sssp_gold, widest_path_gold,
)
from sparseharness_tpu_torch.harness import (
    BenchmarkConfig, Statistic, benchmark_fixpoint, benchmark_spmv,
)
from sparseharness_tpu_torch.ops import Geometry
from sparseharness_tpu_torch.semiring import PLUS_TIMES

CASES = {
    "band": ("bsr_band", lambda m: m.banded_coo(1500, 20, seed=3)),
    "graph": ("ell", lambda m: m.random_graph_coo(200, 3.0, seed=1)),
    # auto resolves bsr_fused in both packages
    "blocks_auto": ("auto", lambda m: m.block_random_coo(4096, 2, seed=5)),
}


def _run(app, pkg, make, variant, **kw):
    if app == "pagerank":
        return getattr(pkg, app)(make, variant=variant, **kw)
    return getattr(pkg, app)(make, 0, variant=variant, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("app", ["sssp", "bfs", "pagerank"])
def test_app_matches_jax(app, case):
    variant, make = CASES[case]
    port = _run(app, ta, make(tf), variant, device="cpu")
    ref = _run(app, ja, make(jf), variant)
    assert port.iterations == int(ref.iterations)
    assert port.converged == bool(ref.converged)
    x, rx = port.x.numpy(), np.asarray(ref.x)
    assert x.dtype == rx.dtype
    if app == "pagerank":
        assert np.abs(x - rx).max() <= 1e-6
    else:
        np.testing.assert_array_equal(x, rx)
    if app == "bfs":
        np.testing.assert_array_equal(port.aux.numpy(), np.asarray(ref.aux))


# the two apps of the ragged path: a small power-law graph (auto resolves
# bsr_fused), one past bsr_fused's tile guard (auto resolves sell2) and a
# band; ell on the small graphs only, where its padded rows stay narrow
RAGGED_CASES = [(make, v) for make in ("power_law", "band") for v in ("ell", "sell2", "auto")]
RAGGED_CASES += [("power_law_20k", "sell2"), ("power_law_20k", "auto")]
RAGGED_MATRICES = {
    "power_law": lambda m: m.power_law_coo(3000, 12000, seed=4),
    "power_law_20k": lambda m: m.power_law_coo(20000, 60000, seed=4),
    "band": lambda m: m.banded_coo(1500, 20, seed=3),
}


@pytest.mark.parametrize("matrix,variant", RAGGED_CASES)
@pytest.mark.parametrize("app", ["connected_components", "widest_path"])
def test_ragged_apps_match_jax_and_golds(app, matrix, variant, monkeypatch):
    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "0")
    make = RAGGED_MATRICES[matrix]
    args = () if app == "connected_components" else (0,)
    port = getattr(ta, app)(make(tf), *args, variant=variant, device="cpu")
    ref = getattr(ja, app)(make(jf), *args, variant=variant)
    assert port.iterations == int(ref.iterations)
    assert port.converged == bool(ref.converged)
    x, rx = port.x.numpy(), np.asarray(ref.x)
    assert x.dtype == rx.dtype
    np.testing.assert_array_equal(x, rx)
    gold = (connected_components_gold(make(tf)) if app == "connected_components"
            else widest_path_gold(make(tf), 0))
    np.testing.assert_array_equal(x, gold)


def test_apps_match_golds():
    coo = tf.banded_coo(900, 12, seed=4)
    r = ta.sssp(coo, 3, variant="auto", device="cpu")
    np.testing.assert_allclose(r.x.numpy(), sssp_gold(coo, 3), rtol=1e-5)
    r = ta.bfs(coo, 3, variant="bsr_band", device="cpu")
    np.testing.assert_array_equal(r.aux.numpy(), bfs_levels_gold(coo, 3))
    r = ta.pagerank(coo, variant="bsr_band", device="cpu")
    assert np.abs(r.x.numpy() - pagerank_gold(coo)).max() < 1e-5


@pytest.mark.parametrize("variant", ["auto", "bsr_ell", "bsr_pallas"])
def test_make_spmv_problem_names_the_variant(variant):
    """auto resolves past the band to bsr_fused; the problem carries the
    resolved name, and every blocked variant gates CORRECT on the CPU."""
    coo = tf.block_random_coo(2048, 2, seed=5)
    prob = ta.make_spmv_problem(coo, PLUS_TIMES, variant, seed=4, device="cpu")
    assert prob.variant == ("bsr_fused" if variant == "auto" else variant)
    x = prob.x0.numpy()
    gold = spmv_gold(coo, x, prob.y.numpy(), PLUS_TIMES)
    res = benchmark_spmv(prob, gold=gold, config=BenchmarkConfig(trials=1, launches_per_trial=1),
                         nnz=coo.nnz, gold_scale=spmv_abs_bound(coo, x))
    assert res.correctness is Correctness.CORRECT


def test_run_fixpoint_stop_rule_matches_jax():
    """Stopped at max_iter: iterations = max_iter and converged = False."""
    for max_iter in (3, 10):
        port = run_fixpoint(lambda x: torch.clamp(x + 1, max=5),
                            torch.zeros(4, dtype=torch.int32),
                            convergence=exact_converged, max_iter=max_iter)
        ref = jax_run_fixpoint(lambda x: jnp.minimum(x + 1, 5),
                               jnp.zeros(4, jnp.int32), convergence=jax_exact,
                               max_iter=max_iter)
        assert (port.iterations, port.converged) == (int(ref.iterations), bool(ref.converged))
        np.testing.assert_array_equal(port.x.numpy(), np.asarray(ref.x))


def test_unknown_reorder_method_raises():
    """An unknown method raises ValueError, as in the JAX package."""
    coo = tf.banded_coo(100, 3, seed=1)
    for app, args in ((ta.sssp, (0,)), (ta.bfs, (0,)), (ta.pagerank, ()),
                      (ta.connected_components, ()), (ta.widest_path, (0,)),
                      (ta.multi_sssp, ([0, 1],)), (ta.multi_bfs, ([0],))):
        with pytest.raises(ValueError, match="unknown reorder method"):
            app(coo, *args, reorder="amd", device="cpu")
    with pytest.raises(ValueError, match="unknown reorder method"):
        ja.sssp(jf.banded_coo(100, 3, seed=1), 0, reorder="amd")


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_benchmark_spmv_gold_gate_on_cpu(value_dtype):
    coo = tf.banded_coo(2000, 30, seed=1)
    geom = Geometry(8, 128, value_dtype)
    prob = ta.make_spmv_problem(coo, PLUS_TIMES, "bsr_band", geom, seed=2, device="cpu")
    # same x as the JAX package draws from the same seed
    jprob = ja.make_spmv_problem(jf.banded_coo(2000, 30, seed=1), seed=2)
    np.testing.assert_array_equal(prob.x0.numpy(), np.asarray(jprob.x0))
    gold_coo = coo
    if value_dtype == "bfloat16":
        gold_coo = coo.with_values(
            torch.from_numpy(coo.vals).to(torch.bfloat16).float().numpy())
    x = prob.x0.numpy()
    gold = spmv_gold(gold_coo, x, prob.y.numpy(), PLUS_TIMES)
    res = benchmark_spmv(prob, gold=gold, config=BenchmarkConfig(trials=2, launches_per_trial=2),
                         geometry=geom, nnz=coo.nnz,
                         gold_scale=spmv_abs_bound(gold_coo, x))
    assert res.correctness is Correctness.CORRECT
    assert res.device == "cpu" and res.roofline_frac is None  # no device metric off the GPU
    assert res.records[-1].statistic is Statistic.MEDIAN_RESULT
    assert res.gnnz_per_s > 0


def test_benchmark_fixpoint_on_cpu():
    coo = tf.random_graph_coo(200, 3.0, seed=1)
    solve = ta.sssp(coo, 0, return_solver=True, device="cpu")
    res = benchmark_fixpoint(solve, gold=sssp_gold(coo, 0), nnz=coo.nnz,
                             config=BenchmarkConfig(trials=2))
    assert res.correctness is Correctness.CORRECT
    assert res.iterations == solve().iterations > 1
