"""The port's host formats against the JAX package's: seeded generators,
the MatrixMarket reader, duplicate folding, ELL padding and PageRank
normalisation give identical arrays."""

import numpy as np
import pytest

import sparseharness_tpu.formats as jf
from sparseharness_tpu.formats.mtx import read_mtx_header as jax_read_mtx_header
from sparseharness_tpu.formats.sparse import fold_duplicates as jax_fold
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.formats.sparse import fold_duplicates


def _same_coo(a, b):
    assert a.shape == b.shape
    for name in ("rows", "cols", "vals"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("make", [
    lambda m: m.random_coo(300, 500, 2000, seed=4),
    lambda m: m.random_graph_coo(200, 3.0, seed=1),
    lambda m: m.banded_coo(1200, 130, seed=12),
    lambda m: m.banded_coo(777, 5, dtype=np.float64, seed=9),
    lambda m: m.block_random_coo(1000, 3, seed=2),
    lambda m: m.power_law_coo(500, 3000, seed=3),
    lambda m: m.chained_power_law_coo(1000, 7, seed=4),
    lambda m: m.chained_power_law_coo(5, 4, seed=4),
], ids=["random", "graph", "band", "band_f64", "blocks", "power_law", "chained",
        "chained_tiny"])
def test_generators_match_jax(make):
    _same_coo(make(tf), make(jf))


_MTX = {
    "general_real": ("real general", ["1 1 2.5", "3 2 -1.25", "2 4 4", "3 2 0.5"], (3, 4)),
    "symmetric_real": ("real symmetric", ["1 1 2.0", "3 1 1.5", "4 2 -3.0"], (4, 4)),
    "pattern": ("pattern general", ["1 2", "2 3", "3 1"], (3, 3)),
    "skew_integer": ("integer skew-symmetric", ["2 1 3", "3 1 -7"], (3, 3)),
}


@pytest.mark.parametrize("case", sorted(_MTX))
def test_read_mtx_matches_jax(case, tmp_path):
    header, lines, shape = _MTX[case]
    path = tmp_path / f"{case}.mtx"
    path.write_text(
        f"%%MatrixMarket matrix coordinate {header}\n% a comment\n"
        f"{shape[0]} {shape[1]} {len(lines)}\n" + "\n".join(lines) + "\n")
    ours = tf.read_mtx(str(path))
    _same_coo(ours, jf.read_mtx(str(path), use_native=False))
    assert tf.read_mtx_header(str(path)).__dict__ == jax_read_mtx_header(str(path)).__dict__
    if "symmetric" in header:
        # off-diagonal entries mirrored on read
        assert ours.nnz > len(lines)


def test_read_mtx_rejects_bad_input(tmp_path):
    path = tmp_path / "bad.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n")
    with pytest.raises(tf.MtxFormatError):
        tf.read_mtx(str(path))
    path.write_text("%%MatrixMarket matrix array real general\n2 2\n")
    with pytest.raises(tf.MtxFormatError):
        tf.read_mtx(str(path))


@pytest.mark.parametrize("add", [np.add, np.minimum, np.maximum, None],
                         ids=["add", "minimum", "maximum", "bool"])
def test_fold_duplicates_matches_jax(add):
    rows = [0, 0, 3, 3, 3, 7, 2, 0]
    cols = [1, 1, 2, 2, 2, 7, 5, 1]
    vals = np.asarray([1.5, 2.5, 1.0, -2.0, 3.0, 4.0, 0.5, -1.0], np.float32)
    if add is None:
        vals = vals > 0
    a = tf.coo_from_arrays(rows, cols, vals, (9, 9))
    b = jf.coo_from_arrays(rows, cols, vals, (9, 9))
    folded = fold_duplicates(a, add)
    assert folded.nnz == 4
    _same_coo(folded, jax_fold(b, add))


def test_fold_duplicates_keeps_sorted_unique_input():
    coo = tf.banded_coo(300, 4, seed=2)
    assert fold_duplicates(coo, np.minimum) is coo


@pytest.mark.parametrize("zero", [0.0, 3.5])
def test_bsr_from_coo_matches_jax(zero):
    from sparseharness_tpu.formats.sparse import bsr_from_coo as jax_bsr_from_coo

    for make in (lambda m: m.random_coo(300, 500, 2000, seed=4),
                 lambda m: m.coo_from_arrays([], [], np.zeros(0, np.float32), (20, 30))):
        a = tf.bsr_from_coo(make(tf), 8, 128, zero=zero)
        b = jax_bsr_from_coo(make(jf), 8, 128, zero=zero)
        for name in ("tiles", "tile_rows", "tile_cols", "block_ptr"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert a.padded_shape == b.padded_shape and a.fill_zero == b.fill_zero


def test_to_ell_and_pagerank_normalise_match_jax():
    a = tf.random_graph_coo(150, 4.0, seed=3)
    b = jf.random_graph_coo(150, 4.0, seed=3)
    ea, eb = a.to_ell(128, 8), b.to_ell(128, 8)
    for name in ("cols", "vals", "mask", "lengths"):
        np.testing.assert_array_equal(getattr(ea, name), getattr(eb, name))
    _same_coo(tf.pagerank_normalise(a, 0.85), jf.pagerank_normalise(b, 0.85))
