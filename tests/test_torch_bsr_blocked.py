"""The port's blocked variants (bsr_ell, bsr_fused and gen-1 bsr_pallas)
against the JAX package's build functions and Pallas kernels (interpret mode on
the CPU).

Each port build function must reproduce the JAX arrays exactly. The dp
comparisons feed both packages the same operand (carried across with
ops.interop), so a difference is a dp fault, not a layout fault. Six
semirings reduce with min, max or or over a single-rounded ⊗ and must match
bit for bit; plus_times sums in another order and is held within
1e-5 · max(1, |dp|, Σ|a·x|) per row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
import sparseharness_tpu.ops.pallas_bsr as jbsr
import sparseharness_tpu.ops.pallas_bsr_ell as jell
import sparseharness_tpu.ops.pallas_bsr_fused as jfused
from sparseharness_tpu.semiring import get_semiring as jax_semiring
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.gold import spmv_abs_bound
from sparseharness_tpu_torch.ops import LAUNCHES, bsr, bsr_ell, bsr_fused
from sparseharness_tpu_torch.ops.interop import (
    bsr_ell_operand_from_numpy, bsr_fused_operand_from_numpy, bsr_operand_from_numpy,
)
from sparseharness_tpu_torch.semiring import REGISTRY, get_semiring

NAMES = sorted(REGISTRY)
PT_DELTA = 1e-5


def _one_wide_row(m, n_rows=600):
    """Row 0 holds 600 entries over 66 block-columns: K = 66, so bsr_fused's
    slab height is r_s = 56 and its 75 block-rows take two slabs."""
    cols = np.arange(0, 600 * 14, 14, dtype=np.int32)
    return m.coo_from_arrays(np.zeros(600, np.int32), cols,
                             np.linspace(0.1, 1.0, 600).astype(np.float32),
                             (n_rows, 8400))


# makers taking a formats module: 143 block-rows (an awkward count, padded
# to the step), fully occupied random blocks, and the multi-slab wide row
MATRICES = {
    "random": lambda m: m.random_coo(1138, 1138, 4054, seed=0),
    "blocks": lambda m: m.block_random_coo(2048, 2, seed=5),
    "wide_row": _one_wide_row,
}
# gen-1 with a small slab budget: 30 slabs of ≤ 24 tiles over random_coo
GEN1_TILES_PER_SLAB = 20
DP_CASES = [(n, vd) for n in NAMES for vd in ("float32", "bfloat16")
            if vd == "float32" or get_semiring(n).dtype == torch.float32]


def _np_arr(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _port_arr(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _assert_same(port, ref):
    port, ref = _port_arr(port), _np_arr(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)


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


def _assert_dp_match(name, port_dp, jax_dp, coo, x, rows):
    """Bit-exact, or plus_times within the stated bound, on the first
    ``rows`` rows (the logical rows and the pad rows of real block-rows)."""
    port_dp, jax_dp = port_dp.numpy()[:rows], np.asarray(jax_dp)[:rows]
    assert port_dp.dtype == jax_dp.dtype
    if name != "plus_times":
        np.testing.assert_array_equal(port_dp, jax_dp)
        return
    n = coo.shape[0]
    scale = np.maximum(np.maximum(1.0, np.abs(jax_dp[:n])), spmv_abs_bound(coo, x))
    assert np.all(np.abs(port_dp[:n] - jax_dp[:n].astype(np.float64)) <= PT_DELTA * scale)
    np.testing.assert_allclose(port_dp[n:], jax_dp[n:], rtol=PT_DELTA, atol=PT_DELTA)


@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_bsr_ell_and_fused_builds_match_jax(name, value_dtype, matrix):
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j = _coos(MATRICES[matrix], sr)
    jop = jell.build_bsr_ell(coo_j, jsr, value_dtype=value_dtype)
    op = bsr_ell.build_bsr_ell(coo_t, sr, value_dtype=value_dtype, device="cpu")
    _assert_same(op.tiles, jop.tiles)
    _assert_same(op.tile_cols, jop.tile_cols)
    jop = jfused.build_bsr_fused(coo_j, jsr, value_dtype=value_dtype)
    op = bsr_fused.build_bsr_fused(coo_t, sr, value_dtype=value_dtype, device="cpu")
    _assert_same(op.strips, jop.strips)
    _assert_same(op.cols, jop.cols)


@pytest.mark.parametrize("tiles_per_slab", [jbsr.DEFAULT_TILES_PER_SLAB,
                                            GEN1_TILES_PER_SLAB])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("name", NAMES)
def test_bsr_pallas_build_matches_jax(name, matrix, tiles_per_slab):
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j = _coos(MATRICES[matrix], sr)
    jop = jbsr.build_bsr(coo_j, jsr, tiles_per_slab=tiles_per_slab)
    op = bsr.build_bsr(coo_t, sr, tiles_per_slab=tiles_per_slab, device="cpu")
    for field in ("tiles", "tile_rows", "tile_cols", "row_start"):
        _assert_same(getattr(op, field), getattr(jop, field))
    carried = bsr_operand_from_numpy(*(np.asarray(a) for a in jop),
                                     n_rows=coo_t.shape[0], device="cpu")
    assert torch.equal(carried.seg, op.seg)


def test_multi_slab_shapes():
    """The matrices above reach the multi-slab paths of both slabbed
    build functions."""
    sr = get_semiring("plus_times")
    op = bsr.build_bsr(MATRICES["random"](tf), sr,
                       tiles_per_slab=GEN1_TILES_PER_SLAB, device="cpu")
    assert op.tiles.shape[0] >= 8 and op.tiles.shape[1] <= 32
    op = bsr_fused.build_bsr_fused(MATRICES["wide_row"](tf), sr, device="cpu")
    assert op.strips.shape[:2] == (2, 56) and op.cols.shape == (2, 56 * 66)


def _carry(variant, jop, n_rows):
    if variant == "bsr_ell":
        return bsr_ell_operand_from_numpy(np.asarray(jop.tiles), np.asarray(jop.tile_cols),
                                          device="cpu")
    if variant == "bsr_fused":
        return bsr_fused_operand_from_numpy(np.asarray(jop.strips), np.asarray(jop.cols),
                                            device="cpu")
    return bsr_operand_from_numpy(*(np.asarray(a) for a in jop), n_rows=n_rows,
                                  device="cpu")


_JAX = {
    "bsr_ell": (lambda c, s, vd: jell.build_bsr_ell(c, s, value_dtype=vd), jell.dp_bsr_ell),
    "bsr_fused": (lambda c, s, vd: jfused.build_bsr_fused(c, s, value_dtype=vd),
                  jfused.dp_bsr_fused),
    "bsr_pallas": (lambda c, s, vd: jbsr.build_bsr(c, s, tiles_per_slab=GEN1_TILES_PER_SLAB),
                   jbsr.dp_bsr),
}
_PORT = {
    "bsr_ell": (bsr_ell.dp_bsr_ell_plain, bsr_ell.dp_bsr_ell),
    "bsr_fused": (bsr_fused.dp_bsr_fused_plain, bsr_fused.dp_bsr_fused),
    "bsr_pallas": (bsr.dp_bsr_plain, bsr.dp_bsr),
}
# the matrices each variant's dp is held on. gen-1 runs a Pallas grid step
# per tile in interpret mode, so its matrices keep to a few hundred tiles.
# bsr_fused's interpret-mode kernel unrolls its gather and takes seconds
# per call, so every case runs on the two-slab matrix and a few on all.
_DP_MATRICES = {"bsr_ell": ("random", "blocks", "wide_row"),
                "bsr_fused": ("wide_row",),
                "bsr_pallas": ("random", "blocks", "wide_row")}
_FUSED_ALL_MATRICES = {("plus_times", "float32"), ("min_plus", "bfloat16"),
                       ("or_and", "float32")}


# gen-1 takes no value_dtype: its tiles are always the carrier type
_VARIANT_DP_CASES = [(v, n, vd) for v in sorted(_JAX) for n, vd in DP_CASES
                     if v != "bsr_pallas" or vd == "float32"]


@pytest.mark.parametrize("variant,name,value_dtype", _VARIANT_DP_CASES)
def test_plain_dp_matches_jax_kernel(variant, name, value_dtype):
    """The plain dp (and the routed dp on CPU tensors, which takes it)
    against the JAX Pallas kernel on the same operand."""
    sr, jsr = get_semiring(name), jax_semiring(name)
    jbuild, jdp = _JAX[variant]
    plain, routed = _PORT[variant]
    matrices = _DP_MATRICES[variant]
    if variant == "bsr_fused" and (name, value_dtype) in _FUSED_ALL_MATRICES:
        matrices = sorted(MATRICES)
    for matrix in matrices:
        coo_t, coo_j = _coos(MATRICES[matrix], sr)
        jop = jbuild(coo_j, jsr, value_dtype)
        n, c = coo_t.shape
        op = _carry(variant, jop, n)
        x = _x(sr, c, seed=14)
        jax_dp = jdp(jop, jnp.asarray(x), jsr, n_rows=n)
        port_dp = plain(op, torch.from_numpy(x), sr, n_rows=n)
        assert port_dp.shape == np.asarray(jax_dp).shape
        # rows of real block-rows; gen-1 leaves the rest of its last slab
        # unwritten on the TPU
        rows = -(-n // 8) * 8
        _assert_dp_match(name, port_dp, jax_dp, coo_t, x, rows)
        assert torch.equal(routed(op, torch.from_numpy(x), sr, n_rows=n), port_dp)


def test_gen1_empty_rows_get_the_semiring_zero():
    """Block-rows without a nonzero hold a pad tile; their dp is 0̄ ⊕ the pad
    tile's products, as on the TPU, and a row past the matrix is 0̄."""
    sr, jsr = get_semiring("min_plus"), jax_semiring("min_plus")
    make = (lambda m: m.coo_from_arrays([0, 40, 41], [3, 200, 5], [0.5, 0.25, 2.0],
                                        (50, 300)))
    jop = jbsr.build_bsr(make(jf), jsr, tiles_per_slab=2)
    op = bsr.build_bsr(make(tf), sr, tiles_per_slab=2, device="cpu")
    assert op.tiles.shape[0] >= 2
    x = _x(sr, 300, seed=2)
    port = bsr.dp_bsr_plain(op, torch.from_numpy(x), sr, n_rows=50)
    ref = np.asarray(jbsr.dp_bsr(jop, jnp.asarray(x), jsr, n_rows=50))
    np.testing.assert_array_equal(port.numpy()[:56], ref[:56])
    assert bool((port[56:] == np.float32(np.finfo(np.float32).max)).all())


def test_builds_refuse_what_jax_refuses():
    """The tile blowup guards and the TPU's x cap of bsr_fused."""
    sr, jsr = get_semiring("plus_times"), jax_semiring("plus_times")
    # 3 tiles in one block-row of 2^20 rows: K = 3 pads to 1.6 GB
    scattered = (lambda m: m.coo_from_arrays([0, 0, 0], [0, 1000, 2000],
                                             [1.0, 1.0, 1.0], (1 << 20, 4096)))
    # 300,000 tiles of one entry each: 1.2 GB of tiles for 2.4 MB of
    # nonzeros
    rows = np.arange(300_000, dtype=np.int32) * 8
    lonely = (lambda m: m.coo_from_arrays(rows, rows % 1024, np.ones(len(rows), np.float32),
                                          (8 * 300_000, 1024)))
    # x of 1.6M columns exceeds the 6 MB cap
    wide = (lambda m: m.coo_from_arrays([0], [1_600_000], [1.0], (8, 1_600_001)))
    for make, jbuild, build in (
            (scattered, jell.build_bsr_ell, bsr_ell.build_bsr_ell),
            (lonely, jbsr.build_bsr, bsr.build_bsr),
            (wide, jfused.build_bsr_fused, bsr_fused.build_bsr_fused)):
        with pytest.raises(NotImplementedError):
            jbuild(make(jf), jsr)
        with pytest.raises(NotImplementedError):
            build(make(tf), sr, device="cpu")


def test_duplicates_fold_as_in_jax():
    """Duplicate entries ⊕-fold before the scatter, in every semiring."""
    rows = [0, 0, 9, 9, 9, 17]
    cols = [3, 3, 130, 130, 5, 260]
    vals = np.asarray([1.5, 2.5, 1.0, -2.0, 3.0, 4.0], np.float32)
    for name in NAMES:
        sr, jsr = get_semiring(name), jax_semiring(name)
        make = lambda m: m.coo_from_arrays(rows, cols, vals, (20, 300))  # noqa: E731
        coo_t, coo_j = _coos(make, sr)
        _assert_same(bsr_ell.build_bsr_ell(coo_t, sr, device="cpu").tiles,
                     jell.build_bsr_ell(coo_j, jsr).tiles)
        _assert_same(bsr.build_bsr(coo_t, sr, device="cpu").tiles,
                     jbsr.build_bsr(coo_j, jsr).tiles)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: they never run the plain
    version."""
    sr = get_semiring("min_plus")
    coo = MATRICES["random"](tf)
    before = dict(LAUNCHES)
    op = bsr_fused.build_bsr_fused(coo, sr, device="cpu")
    strips, cols, k, bn = bsr_fused._flat(op)
    x2d = bsr.pad_x2d(torch.zeros(coo.shape[1]), bn, sr)
    with pytest.raises(ValueError):
        bsr_ell.strip_dp_cuda(strips, x2d, sr, k=k, cols=cols)
    eop = bsr_ell.build_bsr_ell(coo, sr, device="cpu")
    with pytest.raises(ValueError):
        bsr_ell.strip_dp_cuda(eop.tiles, bsr_ell.gather_x_strips(x2d, eop.tile_cols),
                              sr, k=k)
    gop = bsr.build_bsr(coo, sr, device="cpu")
    with pytest.raises(ValueError):
        bsr.tile_dp_cuda(gop.tiles, x2d, gop.tile_cols, gop.seg, sr)
    assert LAUNCHES == before


def test_bf16_operands_carry_bit_for_bit():
    sr, jsr = get_semiring("max_min"), jax_semiring("max_min")
    jop = jfused.build_bsr_fused(MATRICES["blocks"](jf), jsr, value_dtype="bfloat16")
    op = bsr_fused_operand_from_numpy(np.asarray(jop.strips), np.asarray(jop.cols),
                                      device="cpu")
    assert op.strips.dtype == torch.bfloat16
    _assert_same(op.strips, jop.strips)
