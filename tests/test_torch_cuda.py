"""Kernel tests that need an NVIDIA GPU and nvcc (marker ``cuda``): the
bsr_band kernel's staged and streamed paths, the strip kernel of bsr_fused
and bsr_ell, the gen-1 tile kernel of bsr_pallas, the sell2 panel kernel
the two SpMM kernels (spmm_band, spmm_tiles) and the sell phase-A and
level kernels, against their plain versions on the same CUDA tensors, and
spmv, spmm and multi_sssp launching each kernel. They
skip without a card; run them on one with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the shared conftest imports JAX, which a machine with
only the port need not have.)
"""

import numpy as np
import pytest
import torch

from sparseharness_tpu_torch.formats import (
    banded_coo, block_random_coo, coo_from_arrays, power_law_coo, random_coo,
)
from sparseharness_tpu_torch.ops import (
    LAUNCHES, bsr, bsr_band, bsr_ell, bsr_fused, sell, sell2, spmm, spmm_tiles, spmv,
)
from sparseharness_tpu_torch.semiring import REGISTRY, PLUS_TIMES, get_semiring

# (semiring, strip dtype): bf16 strips only for the float semirings
CASES = [(n, vd) for n in sorted(REGISTRY) for vd in ("float32", "bfloat16")
         if vd == "float32" or get_semiring(n).dtype == torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _x(sr, n, seed):
    rng = np.random.default_rng(seed)
    if sr.dtype == torch.bool:
        x = rng.random(n) < 0.3
    elif sr.dtype == torch.int32:
        x = rng.integers(0, 50, n).astype(np.int32)
    else:
        x = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("name,value_dtype", CASES)
def test_kernel_paths_match_plain(name, value_dtype, cuda):
    sr = get_semiring(name)
    for coo in (banded_coo(1200, 130, seed=12), random_coo(96, 700, 400, seed=13)):
        op = bsr_band.build_bsr_band(coo, sr, value_dtype=value_dtype, device=cuda)
        x = _x(sr, coo.shape[1], seed=3).to(cuda)
        x2d = bsr_band.pad_x(op, x, sr)
        for stage_x, kc in ((True, op.k_win), (False, op.k_win), (False, 1)):
            got = bsr_band.band_dp_cuda(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win,
                                        stage_x=stage_x, kc=kc)
            torch.cuda.synchronize()
            ref = bsr_band.band_dp_plain(op.strips, x2d, sr, c0=op.c0,
                                         k_win=op.k_win, kc=kc)
            if name == "plus_times":
                bound = bsr_band.band_dp_plain(op.strips.abs(), x2d.abs(), PLUS_TIMES,
                                               c0=op.c0, k_win=op.k_win, kc=kc)
                tol = 1e-5 * torch.clamp(torch.maximum(ref.abs(), bound), min=1.0)
                assert bool(((got - ref).abs() <= tol).all())
            else:
                assert torch.equal(got, ref)


@pytest.mark.cuda
def test_spmv_launches_kernel(cuda):
    coo = banded_coo(2000, 30, seed=1)
    op = bsr_band.build_bsr_band(coo, PLUS_TIMES, device=cuda)
    x = _x(PLUS_TIMES, coo.shape[1], seed=4).to(cuda)
    before = dict(LAUNCHES)
    y = spmv(op, x, sr=PLUS_TIMES, variant="bsr_band", n_rows=coo.shape[0])
    torch.cuda.synchronize()
    assert LAUNCHES["staged"] == before["staged"] + 1
    assert y.is_cuda and y.shape == (coo.shape[0],)


def _assert_kernel_matches(name, got, ref, bound):
    """Bit-exact, or plus_times within 1e-5 · max(1, |plain|, Σ|a·x|)."""
    if name == "plus_times":
        tol = 1e-5 * torch.clamp(torch.maximum(ref.abs(), bound), min=1.0)
        assert bool(((got - ref).abs() <= tol).all())
    else:
        assert torch.equal(got, ref)


def _one_wide_row():
    """K = 66 tiles in one block-row: bsr_fused takes two slabs."""
    from sparseharness_tpu_torch.formats import coo_from_arrays

    cols = np.arange(0, 600 * 14, 14, dtype=np.int32)
    return coo_from_arrays(np.zeros(600, np.int32), cols,
                           np.linspace(0.1, 1.0, 600).astype(np.float32), (600, 8400))


BLOCKED = (lambda: random_coo(1138, 1138, 4054, seed=0),
           lambda: block_random_coo(4096, 2, seed=5), _one_wide_row)


@pytest.mark.cuda
@pytest.mark.parametrize("name,value_dtype", CASES)
def test_strip_kernel_matches_plain(name, value_dtype, cuda):
    """bsr_fused (x gathered in the kernel) and bsr_ell (x strips gathered
    before it) against the plain strip dp."""
    sr = get_semiring(name)
    for make in BLOCKED:
        coo = make()
        op = bsr_fused.build_bsr_fused(coo, sr, value_dtype=value_dtype, device=cuda)
        strips, cols, k, bn = bsr_fused._flat(op)
        x2d = bsr.pad_x2d(_x(sr, coo.shape[1], seed=5).to(cuda), bn, sr)
        xt = bsr_ell.gather_x_strips(x2d, cols)
        ref = bsr_ell.strip_dp_plain(strips, xt, sr)
        bound = None
        if name == "plus_times":
            bound = bsr_ell.strip_dp_plain(strips.abs(), xt.abs(), PLUS_TIMES)
        for got in (bsr_ell.strip_dp_cuda(strips, x2d, sr, k=k, cols=cols),
                    bsr_ell.strip_dp_cuda(strips, xt, sr, k=k)):
            torch.cuda.synchronize()
            _assert_kernel_matches(name, got, ref, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles_per_slab", [bsr.DEFAULT_TILES_PER_SLAB, 20])
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_tile_kernel_matches_plain(name, tiles_per_slab, cuda):
    sr = get_semiring(name)
    for make in BLOCKED:
        coo = make()
        op = bsr.build_bsr(coo, sr, tiles_per_slab=tiles_per_slab, device=cuda)
        x2d = bsr.pad_x2d(_x(sr, coo.shape[1], seed=6).to(cuda), op.tiles.shape[3], sr)
        got = bsr.tile_dp_cuda(op.tiles, x2d, op.tile_cols, op.seg, sr)
        torch.cuda.synchronize()
        ref = bsr.tile_dp_plain(op.tiles, x2d, op.tile_cols, op.seg, sr)
        bound = None
        if name == "plus_times":
            bound = bsr.tile_dp_plain(op.tiles.abs(), x2d.abs(), op.tile_cols, op.seg,
                                      PLUS_TIMES)
        _assert_kernel_matches(name, got, ref, bound)


def _sell2_cases():
    """The layout cases of tests/test_sell2.py: a 600-entry hub row (split
    into pieces), 60 light chunks (virtual chunks), two slabs (hi route),
    three chunks, a power-law graph with pieces and bucket layouts sharing
    a row0, empty rows, and one entry per row."""
    from sparseharness_tpu_torch.formats import coo_from_arrays, power_law_coo

    rng = np.random.default_rng(5)
    bg = random_coo(1200, 4000, 5000, seed=6)
    hub = coo_from_arrays(np.r_[np.full(600, 7), bg.rows],
                          np.r_[rng.choice(4000, 600, replace=False), bg.cols],
                          np.r_[rng.uniform(0.1, 1.0, 600).astype(np.float32), bg.vals],
                          (1200, 4000))
    rng = np.random.default_rng(9)
    ch = np.repeat(np.arange(60), 64)
    cols = (ch * 16384 + np.repeat(np.tile(np.arange(4), 60), 16) * 128
            + rng.integers(0, 128, ch.size))
    light = coo_from_arrays(rng.integers(0, 4096, ch.size), cols,
                            rng.uniform(0.1, 1.0, ch.size).astype(np.float32),
                            (4096, 60 * 16384))
    rows = np.arange(2000)
    return [hub, light, random_coo(32768 + 3000, 900, 40_000, seed=1),
            random_coo(700, 2 * 16384 + 5000, 30_000, seed=2),
            power_law_coo(20000, 60000, seed=4),
            coo_from_arrays([0, 1, 2], [10, 20, 30], [1.0, 2.0, 3.0], (5000, 5000)),
            coo_from_arrays(rows, (rows * 37) % 2000,
                            np.linspace(0.1, 1.0, 2000).astype(np.float32), (2000, 2000))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,value_dtype", CASES)
def test_sell2_kernel_matches_plain(name, value_dtype, cuda):
    """Bit for bit for every semiring (the kernel keeps the plain version's
    order of ⊕, plus_times included), and the same bits on a second run."""
    sr = get_semiring(name)
    for coo in _sell2_cases():
        if sr.dtype == torch.bool:
            coo = coo.with_values(coo.vals != 0)
        op = sell2.build_sell2(coo, sr, value_dtype=value_dtype, device=cuda)
        x = _x(sr, coo.shape[1], seed=7).to(cuda)
        got = sell2.sell2_dp_cuda(op, x, sr)
        again = sell2.sell2_dp_cuda(op, x, sr)
        torch.cuda.synchronize()
        ref = sell2.dp_sell2_plain(op, x, sr, n_rows=coo.shape[0])
        assert got.dtype == ref.dtype and torch.equal(got, ref)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["bsr_fused", "bsr_ell", "bsr_pallas", "sell2"])
def test_spmv_launches_blocked_kernel(variant, cuda):
    from sparseharness_tpu_torch.ops import build_operand

    coo = block_random_coo(2048, 2, seed=1)
    op = build_operand(coo, PLUS_TIMES, variant, device=cuda)
    x = _x(PLUS_TIMES, coo.shape[1], seed=4).to(cuda)
    before = dict(LAUNCHES)
    y = spmv(op, x, sr=PLUS_TIMES, variant=variant, n_rows=coo.shape[0])
    torch.cuda.synchronize()
    assert LAUNCHES[variant] == before[variant] + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    assert y.is_cuda and y.shape == (coo.shape[0],)


def _x_block(sr, n, m, seed):
    rng = np.random.default_rng(seed)
    if sr.dtype == torch.bool:
        x = rng.random((n, m)) < 0.3
    elif sr.dtype == torch.int32:
        x = rng.integers(0, 50, (n, m)).astype(np.int32)
    else:
        x = rng.uniform(0.1, 1.0, (n, m)).astype(np.float32)
    return torch.from_numpy(x)


def _spmm_tile_operands(sr, value_dtype, cuda):
    """(n_cols, strip operand): random blocks as bsr_ell and as bsr_fused
    (views of its slabs), K > 8, and a band whose window is wider than the
    matrix, through its explicit columns; and tile shapes whose bm is no
    multiple of 4, whose bn is no multiple of 4 (the kernel's scalar
    loads), whose rows take several passes (bm = 72) and whose shared
    memory passes 48 KB."""
    ops = []
    for coo in (random_coo(300, 257, 2500, seed=3), random_coo(64, 4096, 6000, seed=5)):
        ops.append((coo.shape[1], bsr_ell.build_bsr_ell(coo, sr, value_dtype=value_dtype,
                                                         device=cuda)))
        ops.append((coo.shape[1], spmm_tiles.ell_operand_from_fused(bsr_fused.build_bsr_fused(
            coo, sr, value_dtype=value_dtype, device=cuda))))
    coo = random_coo(300, 257, 2500, seed=3)
    for bm, bn in ((6, 64), (5, 30), (16, 256), (72, 128)):
        ops.append((coo.shape[1], bsr_ell.build_bsr_ell(coo, sr, bm=bm, bn=bn,
                                                         value_dtype=value_dtype, device=cuda)))
    band = bsr_band.build_bsr_band(banded_coo(96, 40, seed=53), sr, value_dtype=value_dtype,
                                   device=cuda)
    ops.append((96, spmm_tiles.ell_operand_from_band(band)))
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("name,value_dtype", CASES)
def test_spmm_tiles_kernel_matches_plain(name, value_dtype, cuda):
    """Bit for bit but plus_times (within the tolerance), column tails and
    more than one column tile (m = 200), the same bits on a second run."""
    sr = get_semiring(name)
    for n_cols, op in _spmm_tile_operands(sr, value_dtype, cuda):
        bn = op.tiles.shape[2] // op.tile_cols.shape[1]
        for m in (1, 5, 40, 200):
            x2d = spmm_tiles.pad_x_block(_x_block(sr, n_cols, m, seed=m).to(cuda), bn, sr)
            got = spmm_tiles.spmm_tiles_cuda(op.tiles, op.tile_cols, x2d, sr)
            again = spmm_tiles.spmm_tiles_cuda(op.tiles, op.tile_cols, x2d, sr)
            torch.cuda.synchronize()
            ref = spmm_tiles.spmm_tiles_plain(op.tiles, op.tile_cols, x2d, sr)
            bound = None
            if name == "plus_times":
                bound = spmm_tiles.spmm_tiles_plain(op.tiles.abs(), op.tile_cols, x2d.abs(),
                                                    PLUS_TIMES)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            _assert_kernel_matches(name, got, ref, bound)
            assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_spmm_band_kernel_matches_plain(value_dtype, cuda):
    for coo in (banded_coo(1024, 7, seed=1), banded_coo(600, 4, seed=3),
                banded_coo(96, 40, seed=53), banded_coo(3000, 300, seed=2)):
        op = bsr_band.build_bsr_band(coo, PLUS_TIMES, value_dtype=value_dtype, device=cuda)
        for m in (1, 40, 200):
            x2d = bsr_band.pad_x_block(op, _x_block(PLUS_TIMES, coo.shape[1], m, seed=m).to(cuda))
            got = bsr_band.band_spmm_cuda(op.strips, x2d, c0=op.c0, k_win=op.k_win)
            again = bsr_band.band_spmm_cuda(op.strips, x2d, c0=op.c0, k_win=op.k_win)
            torch.cuda.synchronize()
            ref = bsr_band.band_spmm_plain(op.strips, x2d, c0=op.c0, k_win=op.k_win)
            bound = bsr_band.band_spmm_plain(op.strips.abs(), x2d, c0=op.c0, k_win=op.k_win)
            _assert_kernel_matches("plus_times", got, ref, bound)
            assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("name,variant,kernel", [
    ("plus_times", "bsr_band", "spmm_band"), ("min_plus", "bsr_band", "spmm_tiles"),
    ("or_and", "bsr_ell", "spmm_tiles"), ("plus_times", "bsr_fused", "spmm_tiles"),
])
def test_spmm_launches_kernel(name, variant, kernel, cuda):
    from sparseharness_tpu_torch.ops import build_operand

    sr = get_semiring(name)
    coo = banded_coo(2000, 30, seed=1)
    op = build_operand(coo, sr, variant, device=cuda)
    x = _x_block(sr, coo.shape[1], 6, seed=4).to(cuda)
    before = dict(LAUNCHES)
    y = spmm(op, x, sr=sr, variant=variant, n_rows=coo.shape[0])
    torch.cuda.synchronize()
    assert LAUNCHES[kernel] == before[kernel] + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1
    assert y.is_cuda and y.shape == (coo.shape[0], 6) and y.dtype == sr.dtype
    cpu_op = build_operand(coo, sr, variant, device="cpu")
    ref = spmm(cpu_op, x.cpu(), sr=sr, variant=variant, n_rows=coo.shape[0])
    bound = None
    if name == "plus_times":
        abs_op = build_operand(coo.with_values(np.abs(coo.vals)), sr, variant, device="cpu")
        bound = spmm(abs_op, x.cpu().abs(), sr=sr, variant=variant, n_rows=coo.shape[0])
    _assert_kernel_matches(name, y.cpu(), ref, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["multi_sssp", "multi_bfs"])
def test_multi_source_launches_once_per_step(app, cuda):
    import sparseharness_tpu_torch.algorithms as ta

    coo = banded_coo(2000, 30, seed=1)
    roots = [0, 500, 1999]
    before = LAUNCHES["spmm_tiles"]
    r = getattr(ta, app)(coo, roots, variant="bsr_band")
    torch.cuda.synchronize()
    assert LAUNCHES["spmm_tiles"] - before == r.iterations > 1
    ref = getattr(ta, app)(coo, roots, variant="bsr_band", device="cpu")
    assert (r.iterations, r.converged) == (ref.iterations, ref.converged)
    assert torch.equal(r.x.cpu(), ref.x)


def _sell_matrices():
    """The cases of tests/test_torch_sell.py: a power-law matrix, a hub row
    that chains through an extra level, several slabs, and empty rows with
    a duplicate."""
    rng = np.random.default_rng(0)
    bg = random_coo(600, 600, 2000, seed=2)
    hub = coo_from_arrays(np.r_[np.zeros(400, np.int64), bg.rows],
                          np.r_[rng.choice(600, 400, replace=False), bg.cols],
                          rng.uniform(0.1, 1.0, 400 + bg.nnz).astype(np.float32), (600, 600))
    empty = coo_from_arrays([0, 0, 0, 5, 5], [3, 3, 7, 1, 200],
                            np.float32([1, 2, 3, 4, 5]), (300, 300))
    return [(power_law_coo(1500, 9000, seed=4), {}), (hub, {}),
            (power_law_coo(2000, 30000, seed=5), {"slab_nnz": 8000}), (empty, {})]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_sell_kernels_match_plain(name, cuda):
    """Both sell kernels against the plain dp: bit for bit for every
    semiring, plus_times included, and the same bits on a second call."""
    sr = get_semiring(name)
    for coo, kw in _sell_matrices():
        if sr.dtype == torch.bool:
            coo = coo.with_values(coo.vals != 0)
        op = sell.build_sell(coo, sr, device=cuda, **kw)
        x = _x(sr, coo.shape[1], seed=8).to(cuda)
        x2d = sell.pad_x2d(op, x, sr)
        got = sell.sell_dp_cuda(op, x2d, sr)
        again = sell.sell_dp_cuda(op, x2d, sr)
        torch.cuda.synchronize()
        ref = sell.dp_sell_plain(op, x, sr, n_rows=coo.shape[0])
        if sr.dtype == torch.bool:
            assert torch.equal(got > 0, ref)
        else:
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
def test_spmv_sell_launches_one_phase_a_and_one_level_per_depth(cuda):
    coo = power_law_coo(2000, 30000, seed=5)
    op = sell.build_sell(coo, PLUS_TIMES, slab_nnz=8000, device=cuda)
    assert len(op.layouts) >= 2 and op.max_levels >= 2
    x = _x(PLUS_TIMES, coo.shape[1], seed=4).to(cuda)
    before = dict(LAUNCHES)
    y = spmv(op, x, sr=PLUS_TIMES, variant="sell", n_rows=coo.shape[0])
    torch.cuda.synchronize()
    assert LAUNCHES["sell_phase_a"] == before["sell_phase_a"] + 1
    assert LAUNCHES["sell_level"] == before["sell_level"] + op.max_levels
    assert sum(LAUNCHES.values()) == sum(before.values()) + 1 + op.max_levels
    cpu_op = sell.build_sell(coo, PLUS_TIMES, slab_nnz=8000, device="cpu")
    ref = spmv(cpu_op, x.cpu(), sr=PLUS_TIMES, variant="sell", n_rows=coo.shape[0])
    assert torch.equal(y.cpu(), ref)
