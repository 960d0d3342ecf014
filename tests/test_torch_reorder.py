"""The port's RCM reordering against the JAX package's NumPy path, and the
reordered solves of every app against JAX's and against the direct solve.

rcm_permutation must equal JAX's exactly (``use_native=False``, the path
the port copies); the apps with reorder="rcm" must equal JAX's apps with
the same option on x, aux, iterations and converged (pagerank's x within
1e-6). JAX's apps run with SPARSEHARNESS_TPU_NATIVE=0, so that they too
take the NumPy traversal. Cases mirror tests/test_reorder.py where they
concern the port.
"""

import numpy as np
import pytest

import sparseharness_tpu.algorithms as ja
import sparseharness_tpu.formats as jf
import sparseharness_tpu.ops as jops
import sparseharness_tpu.semiring as jsr
import sparseharness_tpu_torch.algorithms as ta
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.gold import spmv_gold
from sparseharness_tpu_torch.ops import build_operand_auto
from sparseharness_tpu_torch.semiring import PLUS_TIMES


@pytest.fixture(autouse=True)
def _numpy_rcm(monkeypatch):
    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "0")


def _shuffled_banded(pkg, n, band, seed=0):
    """A banded matrix hidden behind a random relabeling."""
    coo = pkg.banded_coo(n, band, seed=seed)
    scramble = np.random.default_rng(seed + 1).permutation(n).astype(np.int32)
    return pkg.permute_coo(coo, scramble), coo


def _isolated_and_duplicates(pkg):
    rows, cols = [0, 0, 5, 6], [5, 5, 0, 6]  # dup edge + self loop; 1-4, 7 isolated
    return pkg.coo_from_arrays(rows, cols, np.ones(4, np.float32), (8, 8))


MATRICES = {
    "shuffled_band": lambda p: _shuffled_banded(p, 400, 3, seed=0)[0],
    "random": lambda p: p.random_coo(120, 120, 600, seed=1),
    "isolated_and_duplicates": _isolated_and_duplicates,
    "graph": lambda p: p.random_graph_coo(300, 2.0, seed=2),
    "power_law": lambda p: p.power_law_coo(2000, 6000, seed=4),
    "empty": lambda p: p.coo_from_arrays([], [], np.zeros(0, np.float32), (5, 5)),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_rcm_permutation_equals_jax(name):
    make = MATRICES[name]
    perm = tf.rcm_permutation(make(tf))
    ref = jf.rcm_permutation(make(jf), use_native=False)
    assert perm.dtype == ref.dtype
    np.testing.assert_array_equal(perm, ref)
    assert sorted(perm.tolist()) == list(range(make(tf).shape[0]))


def test_reorder_rcm_permute_and_bandwidth_equal_jax():
    shuffled_t, _ = _shuffled_banded(tf, 600, 3, seed=5)
    shuffled_j, _ = _shuffled_banded(jf, 600, 3, seed=5)
    got, perm = tf.reorder_rcm(shuffled_t)
    ref, jperm = jf.reorder_rcm(shuffled_j)
    np.testing.assert_array_equal(perm, jperm)
    for a in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, a), getattr(ref, a))
    assert tf.bandwidth(got) == jf.bandwidth(ref)
    np.testing.assert_array_equal(tf.inverse_permutation(perm), jf.inverse_permutation(jperm))


def test_rcm_is_a_permutation_and_reduces_bandwidth():
    """test_reorder.py::test_rcm_is_a_permutation_and_reduces_bandwidth."""
    shuffled, original = _shuffled_banded(tf, 400, 3, seed=0)
    assert tf.bandwidth(shuffled) > 10 * tf.bandwidth(original)
    perm = tf.rcm_permutation(shuffled)
    assert tf.bandwidth(tf.permute_coo(shuffled, perm)) <= 4 * tf.bandwidth(original)


def test_permute_coo_spmv_equivalence():
    """test_reorder.py::test_permute_coo_spmv_equivalence."""
    coo = tf.random_coo(120, 120, 600, seed=1)
    perm = tf.rcm_permutation(coo)
    inv = tf.inverse_permutation(perm)
    x = np.random.default_rng(2).uniform(0.1, 1.0, 120).astype(np.float32)
    y_direct = spmv_gold(coo, x, np.zeros(120, np.float32), PLUS_TIMES)
    y_perm = spmv_gold(tf.permute_coo(coo, perm), x[perm], np.zeros(120, np.float32),
                       PLUS_TIMES)
    np.testing.assert_allclose(y_perm[inv], y_direct, rtol=1e-6)


def test_permute_coo_refuses_a_rectangle():
    with pytest.raises(ValueError):
        tf.permute_coo(tf.random_coo(10, 12, 20, seed=1), np.arange(10))
    with pytest.raises(ValueError):
        tf.rcm_permutation(tf.random_coo(10, 12, 20, seed=1))


def _weighted_shuffle(pkg):
    shuffled, _ = _shuffled_banded(pkg, 150, 2, seed=3)
    return shuffled.with_values(np.abs(shuffled.vals).astype(np.float32) + 0.1)


@pytest.mark.parametrize("app", ["sssp", "bfs", "pagerank", "connected_components",
                                 "widest_path"])
def test_reordered_apps_match_jax_and_direct(app):
    """test_reorder.py::test_reordered_solves_match_direct for the port's
    apps, and each equal to JAX's reordered solve."""
    args = () if app in ("pagerank", "connected_components") else (17,)
    port = getattr(ta, app)(_weighted_shuffle(tf), *args, reorder="rcm", device="cpu")
    ref = getattr(ja, app)(_weighted_shuffle(jf), *args, reorder="rcm")
    assert port.iterations == int(ref.iterations)
    assert port.converged == bool(ref.converged)
    x, rx = port.x.numpy(), np.asarray(ref.x)
    assert x.dtype == rx.dtype
    direct = getattr(ta, app)(_weighted_shuffle(tf), *args, device="cpu").x.numpy()
    if app == "pagerank":
        assert np.abs(x - rx).max() <= 1e-6
        np.testing.assert_allclose(x, direct, rtol=1e-4, atol=1e-7)
    else:
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(x, direct)
    if app == "bfs":
        np.testing.assert_array_equal(port.aux.numpy(), np.asarray(ref.aux))


@pytest.mark.parametrize("n", [600, 4000])
def test_rcm_routes_shuffled_band_onto_bsr_band(n):
    """test_reorder.py::test_rcm_routes_shuffled_band_onto_bsr_band; at
    4000 rows (32 column blocks) the shuffled matrix is too wide a window
    for bsr_band until it is reordered."""
    shuffled, _ = _shuffled_banded(tf, n, 3, seed=5)
    if n == 4000:
        assert build_operand_auto(shuffled, PLUS_TIMES, device="cpu")[0] != "bsr_band"
    reordered, _ = tf.reorder_rcm(shuffled)
    name, _ = build_operand_auto(reordered, PLUS_TIMES, device="cpu")
    assert name == "bsr_band"
    jname, _ = jops.build_operand_auto(jf.reorder_rcm(_shuffled_banded(jf, n, 3, seed=5)[0])[0],
                                       jsr.PLUS_TIMES)
    assert jname == name


def test_reordered_solver_reruns():
    solve = ta.sssp(_weighted_shuffle(tf), 17, reorder="rcm", return_solver=True, device="cpu")
    a, b = solve(), solve()
    np.testing.assert_array_equal(a.x.numpy(), b.x.numpy())
    np.testing.assert_array_equal(
        a.x.numpy(), ta.sssp(_weighted_shuffle(tf), 17, device="cpu").x.numpy())
