"""The dia route on the CPU: the guard that ``variant="auto"`` applies
before it builds dia (admits a 27-point stencil, refuses the chain's other
matrices without folding them), ``auto`` picking dia on a stencil that
bsr_band refuses, the build's value types and spans, and SSSP and BFS
through the auto route against the port's golds. The kernel itself is
held to the plain version in ``test_torch_dia_cuda.py``."""

import numpy as np
import pytest
import torch

import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.algorithms import run_fixpoint
from sparseharness_tpu_torch.algorithms.apps import fixpoint_components
from sparseharness_tpu_torch.gold.algorithms import bfs_levels_gold, sssp_gold
from sparseharness_tpu_torch.ops import (
    Geometry, build_operand, build_operand_auto, dia, get_variant, registry, torch_ops,
)
from sparseharness_tpu_torch.semiring import REGISTRY, get_semiring
from sparseharness_tpu_torch.utils import timing


# HPCG's 27-point pattern (the port's generator); test_torch_dia_cuda.py and
# test_torch_spmv.py import it from here
stencil27 = tf.stencil27_coo


# the chain's other matrices, as test_torch_variants.py's AUTO_MATRICES
# makes them, and a non-square one
REFUSED = {
    "random": lambda: tf.random_coo(2048, 2048, 3000, seed=1),
    "blocks": lambda: tf.block_random_coo(2048, 3, seed=2),
    "power_law": lambda: tf.power_law_coo(3000, 12000, seed=4),
    "chained": lambda: tf.chained_power_law_coo(4000, 2, seed=6),
    "power_law_20k": lambda: tf.power_law_coo(20000, 60000, seed=4),
    "small_random": lambda: tf.random_coo(32, 32, 90, seed=8),
    "not_square": lambda: tf.random_coo(300, 400, 500, seed=1),
}


def test_stencil_pattern():
    coo = stencil27(24, 24, 24)
    assert coo.nnz == (3 * 24 - 2) ** 3
    offs = np.unique(coo.cols.astype(np.int64) - coo.rows)
    assert offs.size == 27 and offs.max() == 24 * 24 + 24 + 1


def test_stencil_rows_in_hpcg_order():
    """Rows ascending, each row's columns ascending, every neighbour of a
    point inside the grid present, on a grid of unequal sides."""
    nx, ny, nz = 6, 5, 4
    coo = stencil27(nx, ny, nz, seed=2)
    key = coo.rows.astype(np.int64) * coo.shape[1] + coo.cols
    assert np.all(np.diff(key) > 0)
    ix, iy, iz = coo.rows % nx, coo.rows // nx % ny, coo.rows // (nx * ny)
    jx, jy, jz = coo.cols % nx, coo.cols // nx % ny, coo.cols // (nx * ny)
    assert max(np.abs(ix - jx).max(), np.abs(iy - jy).max(), np.abs(iz - jz).max()) == 1
    counts = np.bincount(coo.rows, minlength=nx * ny * nz)
    edge = [np.minimum(i, s - 1 - i).clip(max=1) + 2 for i, s in
            ((np.arange(nx), nx), (np.arange(ny), ny), (np.arange(nz), nz))]
    assert np.array_equal(counts, np.einsum("i,j,k->kji", *edge).ravel())
    assert coo.vals.dtype == np.float32 and coo.vals.min() >= 0.1 and coo.vals.max() < 1.0


def test_guard_admits_the_stencil():
    why, attrs = dia.auto_guard(stencil27(24, 24, 24))
    assert why is None
    assert attrs["diagonals"] == 27
    assert attrs["fill"] == pytest.approx(70 ** 3 / (27 * 24 ** 3))


@pytest.mark.parametrize("matrix", sorted(REFUSED))
def test_guard_refuses(matrix):
    why, attrs = dia.auto_guard(REFUSED[matrix]())
    assert why is not None
    if matrix != "not_square":
        assert attrs["diagonals"] > dia.AUTO_MAX_DIAGONALS or attrs["fill"] < dia.AUTO_MIN_FILL


def test_guard_counts_in_full_past_a_passing_sample():
    """A stencil with a stray entry every 37 rows, appended: the strided
    sample meets only a few of them and passes, the full count finds them
    all."""
    coo = stencil27(24, 24, 6)
    n = coo.shape[0]
    many = tf.coo_from_arrays(
        np.concatenate([coo.rows, np.arange(0, n, 37)]),
        np.concatenate([coo.cols, (np.arange(0, n, 37) * 7 + 3) % n]),
        np.concatenate([coo.vals, np.ones(len(range(0, n, 37)), np.float32)]), (n, n))
    why, attrs = dia.auto_guard(many)
    assert why is not None and "fill" in attrs and attrs["diagonals"] > dia.AUTO_MAX_DIAGONALS


def test_refusal_never_folds(monkeypatch):
    from sparseharness_tpu_torch.formats import sparse
    from sparseharness_tpu_torch.ops import bsr

    def no_fold(*a, **kw):
        raise AssertionError("the guard folded the matrix")

    for mod, name in ((dia, "fold_on_device"), (bsr, "fold_duplicates"),
                      (sparse, "fold_duplicates")):
        monkeypatch.setattr(mod, name, no_fold)
    monkeypatch.setattr(registry, "AUTO_CHAIN", ("dia",))
    sr = get_semiring("plus_times")
    for make in REFUSED.values():
        with pytest.raises(NotImplementedError, match="dia"):
            build_operand_auto(make(), sr, device="cpu")


def test_auto_picks_dia_past_bsr_band():
    """At 24³ the half-bandwidth is 601, past bsr_band's window; dia's try
    carries what its guard found."""
    timing.start_recording()
    try:
        name, op = build_operand_auto(stencil27(24, 24, 24), get_semiring("plus_times"),
                                      device="cpu")
    finally:
        rec = timing.stop_recording()
    assert name == "dia" and len(op.offsets) == 27
    tries = [s for s in rec if s.name == "build.try"]
    assert [(s.attrs["variant"], s.attrs["outcome"]) for s in tries] == [
        ("bsr_band", "refused"), ("dia", "built")]
    assert tries[1].attrs["diagonals"] == 27 and tries[1].attrs["fill"] > 0.9
    built = rec.index(tries[1])
    stages = [s.attrs["stage"] for s in rec if s.name == "build.encode" and s.parent == built]
    assert stages == ["fold", "offsets", "fill+upload"]


def test_explicit_dia_skips_the_guard():
    """An explicit build keeps its contract: a matrix the guard refuses
    (83 entries over 48 diagonals, 5% of the slots) still builds."""
    coo = REFUSED["small_random"]()
    assert dia.auto_guard(coo)[0] is not None
    op = build_operand(coo, get_semiring("plus_times"), "dia", device="cpu")
    assert len(op.offsets) == np.unique(coo.cols.astype(np.int64) - coo.rows).size


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_build_honours_value_dtype(name):
    sr = get_semiring(name)
    coo = stencil27(6, 5, 4)
    if sr.dtype == torch.bool:
        coo = coo.with_values(coo.vals != 0)
    g32, g16 = Geometry(value_dtype="float32"), Geometry(value_dtype="bfloat16")
    v = get_variant("dia")
    a, b = v.build(coo, sr, g32, "cpu"), v.build(coo, sr, g16, "cpu")
    assert a.offsets == b.offsets
    if sr.dtype == torch.float32:
        assert b.vals.dtype == torch.bfloat16 and torch.equal(b.vals, a.vals.to(torch.bfloat16))
    else:
        assert b.vals.dtype == a.vals.dtype == sr.dtype and torch.equal(a.vals, b.vals)


def test_plain_dp_takes_bf16_values():
    """The plain version widens bf16 values, as the kernel does."""
    sr = get_semiring("plus_times")
    coo = stencil27(6, 5, 4)
    op = build_operand(coo, sr, "dia", Geometry(value_dtype="bfloat16"), device="cpu")
    wide = dia.DiaOperand(op.vals.float(), op.offsets)
    x = torch.rand(coo.shape[0])
    got = dia.dp_dia(op, x, sr, n_rows=coo.shape[0])
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, dia.dp_dia(wide, x, sr, n_rows=coo.shape[0]))


def _operand_and_x(sr, seed):
    coo = stencil27(6, 5, 4, seed=seed)
    if sr.dtype == torch.bool:
        coo = coo.with_values(coo.vals != 0)
    op = build_operand(coo, sr, "dia", device="cpu")
    rng = np.random.default_rng(seed)
    if sr.dtype == torch.bool:
        x = torch.from_numpy(rng.random(coo.shape[0]) < 0.3)
    elif sr.dtype == torch.int32:
        x = torch.from_numpy(rng.integers(0, 50, coo.shape[0]).astype(np.int32))
    else:
        x = torch.from_numpy(rng.uniform(-1.0, 1.0, coo.shape[0]).astype(np.float32))
    return op, x, coo.shape[0]


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_spmv_folds_in_the_dp(name):
    """With no y or α, an SpMV is dia's dp with its fold, as the general
    path folds it; with a y it still takes the general path."""
    sr = get_semiring(name)
    op, x, n = _operand_and_x(sr, seed=7)
    plain = dia.dp_dia_plain(op, x, sr, n_rows=n)
    want = torch_ops.fold_dp(plain, None, sr, None, None)
    got = registry.spmv(op, x, sr=sr, variant="dia", n_rows=n)
    assert got.dtype == sr.dtype and torch.equal(got, want)
    assert torch.equal(dia.dp_dia(op, x, sr, n_rows=n, fold=True), want)
    y = x.flip(0).to(sr.dtype)
    with_y = registry.spmv(op, x, y, sr=sr, variant="dia", n_rows=n, beta=sr.one)
    assert torch.equal(with_y, torch_ops.fold_dp(plain, y, sr, None, sr.one))


def test_min_plus_fold_clamps_rows_off_the_matrix():
    """A row whose every diagonal falls off the matrix, its slots 0̄ as the
    build stores them, reads 0̄ (FLT_MAX), not the +inf of FLT_MAX +
    FLT_MAX."""
    sr = get_semiring("min_plus")
    op = dia.DiaOperand(torch.full((2, 4), sr.zero), (-6, 5))
    dp = dia.dp_dia(op, torch.zeros(4), sr, n_rows=4)
    assert torch.isinf(dp).all()
    got = registry.spmv(op, torch.zeros(4), sr=sr, variant="dia", n_rows=4)
    assert torch.equal(got, torch.full((4,), sr.zero))


def test_folded_call_has_no_fold_span():
    sr = get_semiring("plus_times")
    op, x, n = _operand_and_x(sr, seed=3)
    timing.start_recording()
    try:
        registry.spmv(op, x, sr=sr, variant="dia", n_rows=n)
        registry.spmv(op, x, x, sr=sr, variant="dia", n_rows=n, beta=2.0)
    finally:
        rec = timing.stop_recording()
    calls = [i for i, s in enumerate(rec) if s.name == "spmv"]
    assert len(calls) == 2
    held = [[s.name for s in rec if s.parent == i] for i in calls]
    assert held == [["spmv.dp"], ["spmv.dp", "spmv.fold"]]


@pytest.mark.parametrize("algo", ["sssp", "bfs"])
def test_auto_fixpoints_match_gold(algo):
    coo = stencil27(24, 24, 6, seed=3)
    comp = fixpoint_components(algo, coo, 5, variant="auto", device="cpu")
    assert comp.product is not None
    r = run_fixpoint(comp.step, comp.x0, convergence=comp.convergence, max_iter=comp.limit)
    if algo == "sssp":
        np.testing.assert_allclose(r.x.numpy(), sssp_gold(coo, 5), rtol=1e-6)
    else:
        np.testing.assert_array_equal(r.x.numpy(), bfs_levels_gold(coo, 5) >= 0)
    name, _ = build_operand_auto(coo, get_semiring("min_plus" if algo == "sssp" else "or_and"),
                                 device="cpu")
    assert name == "dia"
