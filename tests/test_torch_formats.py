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


def test_transpose_scc_normalise_and_self_loops_match_jax():
    from sparseharness_tpu.formats.preprocess import ensure_self_loops as jax_self_loops

    for make in (lambda m: m.random_graph_coo(150, 4.0, seed=3),
                 lambda m: m.coo_from_arrays([0, 2, 2, 4], [0, 1, 2, 0],
                                             np.float32([1, 2, 3, 4]), (5, 7))):
        a, b = make(tf), make(jf)
        _same_coo(a.transpose(), b.transpose())
        assert a.transpose().shape == (a.shape[1], a.shape[0])
        _same_coo(tf.scc_normalise(a), jf.scc_normalise(b))
        assert tf.scc_normalise(a).vals.dtype == np.int32
        if a.shape[0] == a.shape[1]:
            for value in (1.0, 0.25):
                _same_coo(tf.ensure_self_loops(a, value), jax_self_loops(b, value))
    full = tf.banded_coo(50, 2, seed=1)  # every diagonal entry present
    assert tf.ensure_self_loops(full) is full


_WRITE_CASES = {
    "real": (lambda m: m.random_coo(60, 70, 300, seed=3), {}),
    "real_f64": (lambda m: m.banded_coo(40, 3, dtype=np.float64, seed=9), {}),
    "integer": (lambda m: m.coo_from_arrays([0, 1, 2], [2, 0, 1], np.float32([3, -7, 12]),
                                            (3, 3)), {"field": "integer"}),
    "pattern": (lambda m: m.random_graph_coo(40, 2.0, seed=2), {"field": "pattern"}),
    "symmetric": (lambda m: m.coo_from_arrays([0, 1, 0, 2, 1, 2], [0, 0, 1, 1, 2, 2],
                                              np.float32([2, 1.5, 1.5, -3, -3, 4]), (3, 3)),
                  {"symmetry": "symmetric"}),
    "skew": (lambda m: m.coo_from_arrays([1, 0, 2, 0], [0, 1, 0, 2],
                                         np.float32([2.5, -2.5, 1, -1]), (3, 3)),
             {"symmetry": "skew-symmetric"}),
}


@pytest.mark.parametrize("case", sorted(_WRITE_CASES))
def test_write_mtx_is_byte_identical_and_round_trips(case, tmp_path):
    make, kw = _WRITE_CASES[case]
    ours, ref = tmp_path / "port.mtx", tmp_path / "jax.mtx"
    tf.write_mtx(str(ours), make(tf), **kw)
    jf.write_mtx(str(ref), make(jf), **kw)
    assert ours.read_bytes() == ref.read_bytes()
    back = tf.read_mtx(str(ours))
    src = make(tf)
    assert back.shape == src.shape
    key = np.lexsort((back.cols, back.rows))
    want = np.lexsort((src.cols, src.rows))
    np.testing.assert_array_equal(back.rows[key], src.rows[want])
    np.testing.assert_array_equal(back.cols[key], src.cols[want])
    if kw.get("field") != "pattern":
        np.testing.assert_array_equal(back.vals[key], src.vals[want].astype(np.float32))


def test_write_mtx_refuses_what_jax_refuses(tmp_path):
    asym = lambda m: m.coo_from_arrays([1, 0], [0, 1], np.float32([1, 2]), (2, 2))  # noqa: E731
    for kw in ({"symmetry": "symmetric"}, {"field": "complex"}, {"symmetry": "hermitian"}):
        with pytest.raises(ValueError):
            jf.write_mtx(str(tmp_path / "j.mtx"), asym(jf), **kw)
        with pytest.raises(ValueError):
            tf.write_mtx(str(tmp_path / "t.mtx"), asym(tf), **kw)


def test_write_mtx_pattern_symmetric_compares_structure_only(tmp_path):
    """A structurally symmetric matrix with asymmetric values writes as a
    symmetric pattern file in the port (no value is written, so only the
    (row, col) structure must mirror); the JAX package refuses it. A
    structurally asymmetric one is refused by both."""
    asym_vals = lambda m: m.coo_from_arrays(  # noqa: E731
        [1, 0, 2, 2], [0, 1, 2, 0], np.float32([1, 2, 5, 3]), (3, 3))
    with pytest.raises(ValueError):
        jf.write_mtx(str(tmp_path / "j.mtx"), asym_vals(jf), field="pattern",
                     symmetry="symmetric")
    with pytest.raises(ValueError):
        tf.write_mtx(str(tmp_path / "t.mtx"), asym_vals(tf), field="pattern",
                     symmetry="symmetric")
    both = lambda m: m.coo_from_arrays(  # noqa: E731
        [1, 0, 2, 2, 0], [0, 1, 2, 0, 2], np.float32([1, 2, 5, 3, 4]), (3, 3))
    path = str(tmp_path / "p.mtx")
    tf.write_mtx(path, both(tf), field="pattern", symmetry="symmetric")
    with pytest.raises(ValueError):
        jf.write_mtx(str(tmp_path / "j2.mtx"), both(jf), field="pattern", symmetry="symmetric")
    back = tf.read_mtx(path)
    assert sorted(zip(back.rows.tolist(), back.cols.tolist())) == [
        (0, 1), (0, 2), (1, 0), (2, 0), (2, 2)]
    assert np.all(back.vals == 1.0)
    with pytest.raises(ValueError):  # values still must mirror in a real file
        tf.write_mtx(str(tmp_path / "r.mtx"), both(tf), symmetry="symmetric")
