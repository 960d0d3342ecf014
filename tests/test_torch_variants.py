"""The port's plain-torch variants (coo_seg, dense, dia) against the JAX
package's on the same seeded matrices: builds equal, dp equal bit for bit
(plus_times within 1e-5 · max(1, |dp|, Σ|a·x|)), empty coo_seg rows with
the reduction's identity as in JAX; and the auto chain resolving the same
variant as JAX, sell2 included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
from sparseharness_tpu.ops import (
    build_operand as jax_build, build_operand_auto as jax_auto, get_variant as jax_variant,
)
from sparseharness_tpu.semiring import get_semiring as jax_semiring
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.gold import spmv_abs_bound
from sparseharness_tpu_torch.ops import build_operand, build_operand_auto, get_variant
from sparseharness_tpu_torch.ops.interop import (
    coo_seg_operand_from_numpy, dense_operand_from_numpy, dia_operand_from_numpy,
)
from sparseharness_tpu_torch.semiring import REGISTRY, get_semiring

NAMES = sorted(REGISTRY)

# a random matrix with empty rows, and a band (dia's home structure)
MATRICES = {
    "random": lambda m: m.random_coo(300, 300, 700, seed=3),
    "band": lambda m: m.banded_coo(400, 6, seed=2),
}


def _coos(make, sr):
    coo_t, coo_j = make(tf), make(jf)
    if sr.dtype == torch.bool:
        coo_t = coo_t.with_values(coo_t.vals != 0)
        coo_j = coo_j.with_values(coo_j.vals != 0)
    return coo_t, coo_j


def _x(sr, n, seed):
    rng = np.random.default_rng(seed)
    if sr.dtype == torch.bool:
        return rng.random(n) < 0.3
    if sr.dtype == torch.int32:
        return rng.integers(0, 50, n).astype(np.int32)
    return rng.uniform(0.1, 1.0, n).astype(np.float32)


def _arrays(variant, op):
    if variant == "dia":
        return [op.vals]
    return list(op)


def _carry(variant, jop):
    if variant == "coo_seg":
        return coo_seg_operand_from_numpy(*(np.asarray(a) for a in jop), device="cpu")
    if variant == "dense":
        return dense_operand_from_numpy(np.asarray(jop.mat), device="cpu")
    return dia_operand_from_numpy(np.asarray(jop.vals), jop.offsets, device="cpu")


@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("variant", ["coo_seg", "dense", "dia"])
@pytest.mark.parametrize("name", NAMES)
def test_build_and_dp_match_jax(name, variant, matrix):
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j = _coos(MATRICES[matrix], sr)
    jop = jax_build(coo_j, jsr, variant)
    op = build_operand(coo_t, sr, variant, device="cpu")
    for port, ref in zip(_arrays(variant, op), _arrays(variant, jop)):
        ref = np.asarray(ref)
        assert port.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(port.numpy(), ref)
    if variant == "dia":
        assert op.offsets == jop.offsets

    n, c = coo_t.shape
    x = _x(sr, c, seed=8)
    ref = np.asarray(jax_variant(variant).dp(jop, jnp.asarray(x), jsr, n_rows=n))
    got = get_variant(variant).dp(_carry(variant, jop), torch.from_numpy(x), sr,
                                  n_rows=n).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if name == "plus_times":
        scale = np.maximum(np.maximum(1.0, np.abs(ref[:n])), spmv_abs_bound(coo_t, x))
        assert np.all(np.abs(got[:n] - ref[:n].astype(np.float64)) <= 1e-5 * scale)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["min_plus", "max_min", "min_right", "max_right"])
def test_coo_seg_empty_rows_get_the_identity(name):
    """segment_min / segment_max give an empty row the dtype's extreme, not
    0̄; the port's dp gives the same bits before the fold."""
    sr, jsr = get_semiring(name), jax_semiring(name)
    make = (lambda m: m.coo_from_arrays([0, 0, 3], [1, 2, 0], [0.5, 0.75, 0.25], (5, 4)))
    coo_t, coo_j = _coos(make, sr)
    op = build_operand(coo_t, sr, "coo_seg", device="cpu")
    x = _x(sr, 4, seed=1)
    got = get_variant("coo_seg").dp(op, torch.from_numpy(x), sr, n_rows=5).numpy()
    ref = np.asarray(jax_variant("coo_seg").dp(jax_build(coo_j, jsr, "coo_seg"),
                                               jnp.asarray(x), jsr, n_rows=5))
    np.testing.assert_array_equal(got, ref)
    extreme = np.iinfo(np.int32) if sr.dtype == torch.int32 else None
    want = {"min_plus": np.inf, "max_min": -np.inf,
            "min_right": extreme.max if extreme else None,
            "max_right": extreme.min if extreme else None}[name]
    assert got[1] == want and got[2] == want


def test_dia_refuses_what_jax_refuses():
    sr, jsr = get_semiring("plus_times"), jax_semiring("plus_times")
    for make in (lambda m: m.random_coo(300, 400, 500, seed=1),      # not square
                 lambda m: m.random_coo(2000, 2000, 4000, seed=1)):  # > 512 diagonals
        with pytest.raises(NotImplementedError):
            jax_build(make(jf), jsr, "dia")
        with pytest.raises(NotImplementedError):
            build_operand(make(tf), sr, "dia", device="cpu")


def _wide(m):
    """x above bsr_fused's 6 MB cap: both chains go on to sell2."""
    return m.coo_from_arrays([0, 3, 5], [0, 900_000, 1_600_000], [1.0, 2.0, 3.0],
                             (8, 1_600_001))


def _scattered(m):
    """One entry per row in each of 400 chunks, x past bsr_fused's cap:
    sell2's padding guard refuses (a panel per handful of entries), so both
    chains go on to bsr_ell."""
    rows = np.arange(1 << 14)
    return m.coo_from_arrays(rows, (rows % 400) * 16384 + (rows // 400) % 128 * 128,
                             np.ones(len(rows), np.float32), (1 << 14, 400 * 16384))


# matrices on which both chains must name the same variant
AUTO_MATRICES = {
    "band": (lambda m: m.banded_coo(600, 10, seed=1), "bsr_band"),
    "random": (lambda m: m.random_coo(2048, 2048, 3000, seed=1), "bsr_fused"),
    "blocks": (lambda m: m.block_random_coo(2048, 3, seed=2), "bsr_fused"),
    "power_law": (lambda m: m.power_law_coo(3000, 12000, seed=4), "bsr_fused"),
    "chained": (lambda m: m.chained_power_law_coo(4000, 2, seed=6), "bsr_fused"),
    "power_law_20k": (lambda m: m.power_law_coo(20000, 60000, seed=4), "sell2"),
    "wide": (_wide, "sell2"),
}


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("matrix", sorted(AUTO_MATRICES))
def test_auto_resolves_as_jax(matrix, value_dtype, monkeypatch):
    from sparseharness_tpu.ops import Geometry as JaxGeometry
    from sparseharness_tpu_torch.ops import Geometry

    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "0")
    make, want = AUTO_MATRICES[matrix]
    sr, jsr = get_semiring("plus_times"), jax_semiring("plus_times")
    name, _ = build_operand_auto(make(tf), sr, Geometry(8, 128, value_dtype), device="cpu")
    jname, _ = jax_auto(make(jf), jsr, JaxGeometry(8, 128, value_dtype))
    assert name == jname == want


def test_auto_past_the_fused_cap_takes_bsr_ell(monkeypatch):
    """x above bsr_fused's 6 MB cap and a layout sell2 refuses: both chains
    take bsr_ell."""
    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "0")
    sr, jsr = get_semiring("plus_times"), jax_semiring("plus_times")
    name, op = build_operand_auto(_scattered(tf), sr, device="cpu")
    jname, _ = jax_auto(_scattered(jf), jsr)
    assert name == jname == "bsr_ell" and op.tile_cols.shape[0] == (1 << 14) // 8
