"""The port's scc, eigenvector, fixpoint_components and checkpointed loop
against the JAX package's on the same seeded matrices: labels, iterations
and converged exactly; eigenvector x within 1e-6 (plus_times sums and the
norm in another order), the eigenvalue within 1e-5 relative."""

import jax
import numpy as np
import pytest
import torch

import sparseharness_tpu.algorithms as ja
import sparseharness_tpu.formats as jf
import sparseharness_tpu.gold as jg
from sparseharness_tpu.algorithms.apps import fixpoint_components as jax_components
from sparseharness_tpu.algorithms.fixpoint import run_fixpoint as jax_run_fixpoint
import sparseharness_tpu_torch.algorithms as ta
import sparseharness_tpu_torch.formats as tf
import sparseharness_tpu_torch.gold as tg
from sparseharness_tpu_torch.algorithms import (
    exact_converged, fixpoint_components, run_fixpoint, run_fixpoint_checkpointed,
)

GRAPHS = {
    "graph": lambda m: m.random_graph_coo(200, 3.0, seed=1),
    # a few strongly connected blocks chained one way
    "chain": lambda m: m.coo_from_arrays(
        [1, 2, 0, 4, 5, 3, 3, 6, 7, 8, 6], [0, 1, 2, 3, 4, 5, 2, 5, 6, 7, 8],
        np.ones(11, np.float32), (10, 10)),
    "band": lambda m: m.banded_coo(300, 4, seed=2),
}


def _same_fix(port, ref):
    assert (port.iterations, port.converged) == (int(ref.iterations), bool(ref.converged))
    np.testing.assert_array_equal(port.x.numpy(), np.asarray(ref.x))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("variant", ["ell", "sell", "auto"])
def test_scc_matches_jax_and_gold(graph, variant):
    make = GRAPHS[graph]
    comp, fwd, bwd = ta.scc(make(tf), variant=variant, device="cpu")
    jcomp, jfwd, jbwd = ja.scc(make(jf), variant=variant)
    np.testing.assert_array_equal(comp, jcomp)
    _same_fix(fwd, jfwd)
    _same_fix(bwd, jbwd)
    np.testing.assert_array_equal(tg.scc_labels_gold(make(tf)), jg.scc_labels_gold(make(jf)))
    gold = tg.scc_gold(make(tf))
    np.testing.assert_array_equal(gold, jg.algorithms.scc_gold(make(jf)))
    # the same partition: equal ids in one labelling iff equal in the other
    assert len(np.unique(np.stack([comp, gold]), axis=1)[0]) == len(np.unique(gold))


def test_scc_reorder_matches_direct():
    coo = GRAPHS["graph"](tf)
    direct, _, _ = ta.scc(coo, device="cpu")
    reordered, _, _ = ta.scc(coo, reorder="rcm", device="cpu")
    np.testing.assert_array_equal(reordered, direct)


def test_label_propagate_matches_jax():
    from sparseharness_tpu.algorithms.apps import _label_propagate as jax_lp
    from sparseharness_tpu.ops import Geometry as JaxGeometry
    from sparseharness_tpu_torch.algorithms.apps import _label_propagate
    from sparseharness_tpu_torch.ops import Geometry

    solve = _label_propagate(GRAPHS["graph"](tf), "ell", Geometry(), None, return_solver=True,
                             device="cpu")
    _same_fix(solve(), jax_lp(GRAPHS["graph"](jf), "ell", JaxGeometry(), None))


@pytest.mark.parametrize("variant", ["ell", "sell", "bsr_band"])
def test_eigenvector_matches_jax_and_gold(variant):
    make = lambda m: m.random_coo(48, 48, 300, seed=9).with_values(  # noqa: E731
        np.abs(m.random_coo(48, 48, 300, seed=9).vals) + 0.1)
    (port, lam) = ta.eigenvector(make(tf), variant=variant, device="cpu")
    (ref, jlam) = ja.eigenvector(make(jf), variant=variant)
    assert (port.iterations, port.converged) == (int(ref.iterations), bool(ref.converged))
    assert port.converged
    assert np.abs(port.x.numpy() - np.asarray(ref.x)).max() <= 1e-6
    assert abs(float(lam) - float(jlam)) <= 1e-5 * abs(float(jlam))
    gold = tg.eigenvector_gold(make(tf))
    np.testing.assert_array_equal(gold, jg.eigenvector_gold(make(jf)))
    assert np.abs(port.x.numpy() - gold).max() <= 1e-4


def test_eigenvector_solver_returns_the_pair():
    coo = tf.random_coo(48, 48, 300, seed=9)
    solve = ta.eigenvector(coo.with_values(np.abs(coo.vals) + 0.1), return_solver=True,
                           device="cpu")
    res, lam = solve()
    assert res.converged and isinstance(lam, torch.Tensor) and float(lam) > 0


@pytest.mark.parametrize("algo", ["sssp", "bfs", "pagerank", "scc", "eigenvector"])
@pytest.mark.parametrize("reorder", [None, "rcm"])
def test_fixpoint_components_match_jax(algo, reorder):
    """Each quadruple run through the fixpoint loop: the port's in torch,
    JAX's under jit; pagerank and eigenvector x within 1e-6. The
    eigenvector's norm is summed in another order, so its |Δ| can fall on
    either side of delta at the same step: it runs a fixed 15 steps here
    (the converged solve is held in test_eigenvector_matches_jax_and_gold)."""
    if algo == "scc" and reorder:
        with pytest.raises(ValueError):
            fixpoint_components("scc", GRAPHS["graph"](tf), reorder="rcm", device="cpu")
        with pytest.raises(ValueError):
            jax_components("scc", GRAPHS["graph"](jf), reorder="rcm")
        return
    make = lambda m: m.random_graph_coo(200, 3.0, seed=1).with_values(  # noqa: E731
        np.abs(m.random_graph_coo(200, 3.0, seed=1).vals) + 0.1)
    kw = {"max_iter": 15} if algo == "eigenvector" else {}
    comp = fixpoint_components(algo, make(tf), root=3, reorder=reorder, device="cpu", **kw)
    jcomp = jax_components(algo, make(jf), root=3, reorder=reorder, **kw)
    assert comp.limit == jcomp.limit
    np.testing.assert_array_equal(comp.x0.numpy(), np.asarray(jcomp.x0))
    res = run_fixpoint(comp.step, comp.x0, convergence=comp.convergence, max_iter=comp.limit)
    jres = jax.jit(lambda x0: jax_run_fixpoint(jcomp.step, x0, convergence=jcomp.convergence,
                                               max_iter=jcomp.limit))(jcomp.x0)
    assert (res.iterations, res.converged) == (int(jres.iterations), bool(jres.converged))
    x, rx = res.x.numpy(), np.asarray(jres.x)
    if reorder:
        x, rx = comp.unpermute(x), jcomp.unpermute(rx)
    if algo in ("pagerank", "eigenvector"):
        assert np.abs(x - rx).max() <= 1e-6
    else:
        np.testing.assert_array_equal(x, rx)


def test_fixpoint_components_unknown_algorithm():
    with pytest.raises(KeyError):
        fixpoint_components("nope", GRAPHS["graph"](tf), device="cpu")


def test_checkpointed_fixpoint_resumes(tmp_path):
    """A solve cut after its first chunk resumes from the checkpoint to the
    same x and total iterations as an uninterrupted run; aux rides along."""
    step = lambda x: torch.clamp(x + 1, max=25)  # noqa: E731
    x0 = torch.zeros(6, dtype=torch.int32)
    full = run_fixpoint(step, x0, convergence=exact_converged, max_iter=100)
    path = str(tmp_path / "ck")
    first = run_fixpoint_checkpointed(step, x0, convergence=exact_converged, max_iter=10,
                                      ckpt_path=path, every=10)
    assert first.iterations == 10 and not first.converged
    saved = np.load(path + ".npz")
    assert int(saved["iteration"]) == 10 and saved["x"].tolist() == [10] * 6
    resumed = run_fixpoint_checkpointed(step, x0, convergence=exact_converged, max_iter=100,
                                        ckpt_path=path, every=10)
    assert (resumed.iterations, resumed.converged) == (full.iterations, full.converged)
    assert torch.equal(resumed.x, full.x)

    def stamp(aux, x_old, x_new, it):
        return aux + (x_new != x_old).to(torch.int32)

    aux_path = str(tmp_path / "aux.npz")
    res = run_fixpoint_checkpointed(step, x0, convergence=exact_converged, max_iter=100,
                                    ckpt_path=aux_path, every=7, aux0=torch.zeros_like(x0),
                                    aux_update=stamp)
    assert res.aux.tolist() == [25] * 6
    np.testing.assert_array_equal(np.load(aux_path)["aux"], res.aux.numpy())
