"""The port's native host library (formats/native_io.py over its own copy of
fast_mtx.cpp) case by case against tests/test_native.py.

Where the JAX test holds native against NumPy, this file holds three things
on the same seeded inputs: the port's native result equals the port's NumPy
result; it equals the JAX package's native result, bit for bit for indices,
permutations, packed words and values (parsed values too); and the port's
sell2 build (panels, piece_owner, virt_blocks, plan) is identical under
SPARSEHARNESS_TPU_NATIVE=1 and =0. A library that cannot be built raises
NativeUnavailable; only SPARSEHARNESS_TPU_NATIVE=0 or use_native=False
reaches NumPy.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
from sparseharness_tpu.formats import native_io as jax_native
from sparseharness_tpu.ops import Geometry as JaxGeometry, build_operand as jax_build
from sparseharness_tpu.semiring import get_semiring as jax_semiring
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.formats import native_io
from sparseharness_tpu_torch.formats.mtx import _parse_entries_numpy, read_mtx_header
from sparseharness_tpu_torch.formats.reorder import _sym_pattern_csr, rcm_permutation
from sparseharness_tpu_torch.ops import build_operand, sell2
from sparseharness_tpu_torch.semiring import get_semiring

CASES = {  # tests/test_native.py:test_native_sell2_encode_bit_identical's six
    "random": (lambda m: m.random_coo(300, 300, 2000, seed=1), "plus_times"),
    "zipf_min_plus": (lambda m: m.power_law_coo(4000, 16000, alpha=1.5, seed=13), "min_plus"),
    "zipf_heavy": (lambda m: m.power_law_coo(2000, 40000, alpha=1.1, seed=3), "plus_times"),
    "band": (lambda m: m.banded_coo(3000, 20, seed=2), "plus_times"),
    "chained": (lambda m: m.chained_power_law_coo(16, 2000, 8.0, seed=5), "min_plus"),
    "zipf_or_and": (lambda m: m.power_law_coo(4000, 16000, alpha=1.5, seed=13), "or_and"),
}


def _duplicates(m):
    base = m.random_coo(200, 200, 3000, seed=9)
    rows = np.concatenate([base.rows, base.rows[:500]])
    cols = np.concatenate([base.cols, base.cols[:500]])
    vals = np.concatenate([base.vals, base.vals[:500] * 0.5]).astype(np.float32)
    return m.coo_from_arrays(rows, cols, vals, base.shape)


EDGES = {  # tests/test_native.py:test_native_sell2_encode_edge_cases
    "single_entry": lambda m: m.coo_from_arrays([5], [7], np.ones(1, np.float32), (16, 16)),
    "one_column_hub": lambda m: m.coo_from_arrays(
        np.arange(300), np.zeros(300, int), np.ones(300, np.float32), (300, 300)),
    "diagonal": lambda m: m.coo_from_arrays(np.arange(200), np.arange(200),
                                            np.ones(200, np.float32), (200, 200)),
    "trailing_entry": lambda m: m.coo_from_arrays([1999], [1999], np.ones(1, np.float32),
                                                  (2000, 2000)),
}


def _write(tmp_path, coo, field="real"):
    p = str(tmp_path / "m.mtx")
    tf.write_mtx(p, coo, field=field)
    return p


def _port_arr(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_arr(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _build_both(coo, sr, vd, monkeypatch):
    """The port's sell2 build under SPARSEHARNESS_TPU_NATIVE=0, then =1; the
    native build's record must show no slab left to the NumPy body."""
    ops = []
    for flag in ("0", "1"):
        monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", flag)
        rec = sell2.EncodeRecord()
        ops.append(sell2.build_sell2(coo, sr, vd, device="cpu", record=rec))
        assert rec.native == (flag == "1") and rec.numpy_slabs == 0
    return ops


def _assert_port_identical(op_a, op_b):
    a, b = op_a.panels, op_b.panels
    assert a.layouts == b.layouts
    assert (a.n_chunks, op_a.n_rows, op_a.base_pad) == (b.n_chunks, op_b.n_rows, op_b.base_pad)
    for field in ("piece_owner", "virt_blocks"):
        x, y = getattr(a, field), getattr(b, field)
        assert (x is None) == (y is None), field
        if x is not None:
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=field)
    assert len(a.slabs) == len(b.slabs)
    for sa, sb in zip(a.slabs, b.slabs):
        assert (sa is None) == (sb is None)
        for key in () if sa is None else ("chunk", "wordA", "wordB", "vals"):
            assert sa[key].dtype == sb[key].dtype, key
            np.testing.assert_array_equal(_port_arr(sa[key]), _port_arr(sb[key]), err_msg=key)
    for f in dataclasses.fields(op_a.plan):
        x, y = getattr(op_a.plan, f.name), getattr(op_b.plan, f.name)
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(_port_arr(x), _port_arr(y), err_msg=f.name)
    assert (op_a.plan.n_final, op_a.plan.store) == (op_b.plan.n_final, op_b.plan.store)


def _assert_same_as_jax(op, jop):
    op = op.panels
    assert op.layouts == jop.layouts
    for field in ("piece_owner", "virt_blocks"):
        x, y = getattr(op, field), getattr(jop, field)
        assert (x is None) == (y is None), field
        if x is not None:
            np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=field)
    for sa, sb in zip(op.slabs, jop.slabs, strict=True):
        assert (sa is None) == (sb is None)
        for key in () if sa is None else ("chunk", "wordA", "wordB", "vals"):
            np.testing.assert_array_equal(_port_arr(sa[key]), _jax_arr(sb[key]), err_msg=key)


def _jax_native_build(make, name, vd, monkeypatch):
    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "1")
    coo, sr = make(jf), jax_semiring(name)
    if name == "or_and":
        coo = coo.with_values(coo.vals != 0)
    return jax_build(coo, sr, "sell2", JaxGeometry(8, 128, vd))


def _port_coo(make, name):
    coo = make(tf)
    return coo.with_values(coo.vals != 0) if name == "or_and" else coo


# ---- parse ---------------------------------------------------------------

@pytest.mark.parametrize("field", ["real", "pattern"])
def test_parse_parity(field, tmp_path):
    coo = tf.random_coo(500, 400, 3000, seed=1) if field == "real" else \
        tf.random_coo(100, 100, 400, seed=2)
    p = _write(tmp_path, coo, field)
    h = read_mtx_header(p)
    r1, c1, v1 = native_io.parse_entries(p, h)
    r2, c2, v2 = _parse_entries_numpy(p, h)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_allclose(v1, v2, rtol=1e-12)
    if field == "pattern":
        assert np.all(v1 == 1.0)
    for ours, ref in zip((r1, c1, v1), jax_native.parse_entries(p, h)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


def test_parse_scientific_notation(tmp_path):
    p = tmp_path / "sci.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n3 3 4\n"
                 "1 1 1.5e-3\n2 2 -2.25E+2\n3 3 7e10\n1 3 .5\n")
    h = read_mtx_header(str(p))
    r, c, v = native_io.parse_entries(str(p), h)
    np.testing.assert_allclose(v, [1.5e-3, -225.0, 7e10, 0.5])
    assert r.tolist() == [0, 1, 2, 0] and c.tolist() == [0, 1, 2, 2]
    np.testing.assert_array_equal(v, jax_native.parse_entries(str(p), h)[2])


def test_read_mtx_uses_native_and_matches(tmp_path, monkeypatch):
    coo = tf.random_coo(300, 300, 2000, seed=3)
    p = _write(tmp_path, coo)
    via_native = tf.read_mtx(p, use_native=True)
    via_numpy = tf.read_mtx(p, use_native=False)
    np.testing.assert_array_equal(via_native.rows, via_numpy.rows)
    np.testing.assert_array_equal(via_native.cols, via_numpy.cols)
    np.testing.assert_allclose(via_native.vals, via_numpy.vals, rtol=1e-6)
    ref = jf.read_mtx(p, use_native=True)
    for key in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(via_native, key), getattr(ref, key))
    # None takes the environment's choice: native unless it says 0
    monkeypatch.setattr(native_io, "parse_entries", _refuse)
    with pytest.raises(native_io.NativeUnavailable):
        tf.read_mtx(p)
    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "0")
    np.testing.assert_array_equal(tf.read_mtx(p).vals, via_numpy.vals)


def test_csr_encode_parity():
    coo = tf.random_coo(200, 150, 1000, seed=4)
    indptr, cols, vals = native_io.csr_encode(coo.rows, coo.cols, coo.vals, coo.shape[0])
    csr = coo.sorted_by_row().to_csr()
    np.testing.assert_array_equal(indptr, csr.indptr)
    # the native encode keeps input order within a row (stable)
    for r in range(coo.shape[0]):
        a, b = indptr[r], indptr[r + 1]
        np.testing.assert_array_equal(np.sort(cols[a:b]), np.sort(csr.indices[a:b]))
    for ours, ref in zip((indptr, cols, vals),
                         jax_native.csr_encode(coo.rows, coo.cols, coo.vals, coo.shape[0])):
        np.testing.assert_array_equal(ours, ref)


def test_truncated_file_rejected(tmp_path):
    p = tmp_path / "short.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n3 3 5\n1 1 1.0\n")
    h = read_mtx_header(str(p))
    with pytest.raises(ValueError):
        native_io.parse_entries(str(p), h)
    with pytest.raises(tf.MtxFormatError):
        tf.read_mtx(str(p), use_native=True)


# ---- RCM -----------------------------------------------------------------

def _rcm_cases(m):
    rng = np.random.default_rng(0)
    return [m.random_coo(173, 173, 900, seed=1), m.power_law_coo(500, 4000, seed=2),
            m.banded_coo(400, 3, seed=3),
            m.permute_coo(m.banded_coo(256, 2, seed=4), rng.permutation(256).astype(np.int32))]


def test_native_rcm_matches_numpy_exactly():
    """Same seeds (stable degree order), the same pseudo-peripheral
    refinement and the same (parent rank, degree, id) level order."""
    for i, (coo, jcoo) in enumerate(zip(_rcm_cases(tf), _rcm_cases(jf))):
        np_perm = rcm_permutation(coo, use_native=False)
        indptr, indices, _ = _sym_pattern_csr(coo)
        nat_perm = native_io.rcm(indptr, indices)
        np.testing.assert_array_equal(nat_perm, np_perm, err_msg=str(i))
        ours = rcm_permutation(coo)
        assert ours.dtype == np_perm.dtype
        np.testing.assert_array_equal(ours, np_perm, err_msg=str(i))
        np.testing.assert_array_equal(ours, jax_native.rcm_from_coo(
            jcoo.shape[0], jcoo.rows, jcoo.cols), err_msg=str(i))


def test_native_sym_pattern_matches_numpy():
    cases = [lambda m: m.random_coo(200, 200, 1500, seed=5),
             # duplicate edges, self loops and isolated nodes
             lambda m: m.coo_from_arrays([0, 0, 5, 6, 3], [5, 5, 0, 6, 3],
                                         np.ones(5, np.float32), (9, 9))]
    for make in cases:
        coo = make(tf)
        indptr, indices, _ = _sym_pattern_csr(coo)
        nat_indptr, nat_indices = native_io.sym_pattern(coo.shape[0], coo.rows, coo.cols)
        np.testing.assert_array_equal(nat_indptr, indptr)
        np.testing.assert_array_equal(nat_indices, indices)
        for ours, ref in zip((nat_indptr, nat_indices),
                             jax_native.sym_pattern(coo.shape[0], coo.rows, coo.cols)):
            np.testing.assert_array_equal(ours, ref)


# ---- the sell2 encode -------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_native_sell2_encode_bit_identical(case, monkeypatch):
    make, name = CASES[case]
    a, b = _build_both(_port_coo(make, name), get_semiring(name), "float32", monkeypatch)
    _assert_port_identical(a, b)
    _assert_same_as_jax(b, _jax_native_build(make, name, "float32", monkeypatch))


@pytest.mark.parametrize("case", ["zipf_min_plus", "band", "zipf_heavy"])
def test_native_sell2_encode_bf16_identical(case, monkeypatch):
    """bf16 values rounded in torch and passed to the 2-byte store as their
    bits: the same arrays as the NumPy build and as JAX's ml_dtypes one,
    min_plus's bf16(FLT_MAX) = inf pad included."""
    make, name = CASES[case]
    a, b = _build_both(_port_coo(make, name), get_semiring(name), "bfloat16", monkeypatch)
    _assert_port_identical(a, b)
    assert b.panels.slabs[0]["vals"].dtype == torch.bfloat16
    _assert_same_as_jax(b, _jax_native_build(make, name, "bfloat16", monkeypatch))
    if name == "min_plus":
        assert torch.isinf(b.panels.slabs[0]["vals"].float()).any()


def test_native_sell2_encode_identical_with_duplicates(monkeypatch):
    a, b = _build_both(_duplicates(tf), get_semiring("plus_times"), "float32", monkeypatch)
    _assert_port_identical(a, b)
    _assert_same_as_jax(b, _jax_native_build(_duplicates, "plus_times", "float32",
                                             monkeypatch))


@pytest.mark.parametrize("case", sorted(EDGES))
def test_native_sell2_encode_edge_cases(case, monkeypatch):
    make = EDGES[case]
    a, b = _build_both(make(tf), get_semiring("plus_times"), "float32", monkeypatch)
    _assert_port_identical(a, b)
    _assert_same_as_jax(b, _jax_native_build(make, "plus_times", "float32", monkeypatch))


def test_native_sort_fold_matches_numpy():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 50, 400).astype(np.int32)
    cols = rng.integers(0, 50, 400).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, 400).astype(np.float32)
    for fold in (np.add, np.minimum, np.maximum):
        coo = tf.coo_from_arrays(rows, cols, vals, (50, 50))
        want = tf.fold_duplicates(coo, fold).sorted_by_row()
        got = native_io.sell2_sort_fold(coo, fold.__name__)
        ref = jax_native.sell2_sort_fold(jf.coo_from_arrays(rows, cols, vals, (50, 50)),
                                         fold.__name__)
        for key in ("rows", "cols", "vals"):  # the fold order too
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
            np.testing.assert_array_equal(getattr(got, key), getattr(ref, key))


def test_native_heavy_split_and_pack_match_numpy():
    coo = tf.power_law_coo(2000, 40000, alpha=1.1, seed=3)
    s = tf.fold_duplicates(coo).sorted_by_row()
    base_pad = tf.round_up(coo.shape[0], 1024)
    got = native_io.sell2_heavy_split(s, s.vals, base_pad, sell2.SPLIT_T)
    want = sell2._heavy_split(s, s.vals, coo.shape[0], base_pad)
    assert got[4] > 0 and want[4] == base_pad + got[4]
    for ours, ref in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(ours, ref)
    for ours, ref in zip(got[:4], jax_native.sell2_heavy_split(s, s.vals, base_pad,
                                                               sell2.SPLIT_T)[:4]):
        np.testing.assert_array_equal(ours, ref)
    cnt = np.random.default_rng(4).integers(0, 6, (40, 128)).astype(np.int64)
    cnt[::7] = 0
    knobs = (sell2.SHELF_MAX_PUSH, sell2.SHELF_MAX_HOLES, sell2.SHELF_HOLE_TRIES)
    for ours, np_ref, jax_ref in zip(sell2._twoshelf_pack(cnt, native=True),
                                     sell2._twoshelf_pack(cnt),
                                     jax_native.sell2_pack(cnt, *knobs)):
        np.testing.assert_array_equal(ours, np_ref)
        np.testing.assert_array_equal(ours, jax_ref)


def test_refused_slab_runs_the_numpy_body(monkeypatch):
    """A slab that the native encode refuses (a null handle: past the align
    budget) runs the NumPy slab body, is counted, and the operand is the
    same as the all-native and the all-NumPy builds."""
    coo = tf.random_coo(sell2.SLAB_ROWS + 3000, 900, 40_000, seed=1)  # two slabs
    sr = get_semiring("min_plus")
    a, b = _build_both(coo, sr, "float32", monkeypatch)
    encode = native_io.sell2_encode_slab
    monkeypatch.setattr(native_io, "sell2_encode_slab",
                        lambda rows_e, *args, **kw: None if rows_e.size < 10_000
                        else encode(rows_e, *args, **kw))
    rec = sell2.EncodeRecord()
    c = sell2.build_sell2(coo, sr, device="cpu", record=rec)
    assert rec.native and rec.numpy_slabs == 1 and "numpy-slab" in rec.seconds
    _assert_port_identical(a, c)
    _assert_port_identical(b, c)


def test_guard_cancels_pending_native_slabs(monkeypatch):
    """A padding guard that raises mid-build shuts the pool down and cancels
    the slabs not yet started."""
    calls = []
    real = concurrent.futures.ThreadPoolExecutor

    class Pool(real):
        def shutdown(self, wait=True, *, cancel_futures=False):
            calls.append(cancel_futures)
            return super().shutdown(wait=wait, cancel_futures=cancel_futures)

    def guard(slots, m, where=""):
        raise NotImplementedError("sell2 padding blowup")

    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", Pool)
    monkeypatch.setattr(sell2, "_blowup_guard", guard)
    coo = tf.random_coo(3 * sell2.SLAB_ROWS, 900, 30_000, seed=2)
    with pytest.raises(NotImplementedError):
        build_operand(coo, get_semiring("plus_times"), "sell2", device="cpu")
    assert calls == [True]


# ---- the native path is not optional --------------------------------------

def _refuse(*args, **kw):
    raise native_io.NativeUnavailable("refused for the test")


def test_unbuildable_library_raises_rather_than_falling_back(tmp_path, monkeypatch):
    """With the native path asked for, a library that does not build raises
    NativeUnavailable from every caller; SPARSEHARNESS_TPU_NATIVE=0 or
    use_native=False reaches NumPy."""
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    coo = tf.random_coo(64, 64, 300, seed=1)
    p = _write(tmp_path, coo)
    sr = get_semiring("plus_times")
    assert not native_io.available()
    for call in (lambda: tf.read_mtx(p), lambda: rcm_permutation(coo),
                 lambda: build_operand(coo, sr, "sell2", device="cpu"),
                 lambda: native_io.parse_entries(p, read_mtx_header(p))):
        with pytest.raises(native_io.NativeUnavailable, match="native build failed"):
            call()
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").rglob("*.so"))
    np.testing.assert_array_equal(tf.read_mtx(p, use_native=False).cols, coo.cols)
    perm = rcm_permutation(coo, use_native=False)
    np.testing.assert_array_equal(np.sort(perm), np.arange(64))
    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "0")
    tf.read_mtx(p)
    rcm_permutation(coo)
    rec = sell2.EncodeRecord()
    sell2.build_sell2(coo, sr, device="cpu", record=rec)
    assert not rec.native and rec.numpy_slabs == 0


def test_library_builds_from_the_port_copy_only():
    """The port compiles its own copy of fast_mtx.cpp into build/, keyed by
    the source's digest, and never loads the JAX package's library."""
    assert native_io.SOURCE.parent.parent.name == "formats"
    assert native_io.SOURCE.read_bytes() == (
        native_io.SOURCE.parents[3] / "native" / "fast_mtx.cpp").read_bytes()
    path = native_io.build()
    assert path.is_file() and path.parent.parent == native_io.BUILD_ROOT
    assert "build" in path.parts and "native" not in path.parts
    loaded = native_io.load()
    assert loaded._name == str(path)


def test_out_of_bounds_entries_refused_before_the_library():
    """An entry outside the shape never reaches the C code, which indexes
    tables by row and column."""
    bad = tf.coo_from_arrays([0, 5], [1, 9], np.ones(2, np.float32), (4, 4))
    for call in (lambda: native_io.sell2_sort_fold(bad, "add"),
                 lambda: native_io.sym_pattern(4, bad.rows, bad.cols)):
        with pytest.raises(ValueError, match="out of bounds"):
            call()
