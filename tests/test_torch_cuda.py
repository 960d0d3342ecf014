"""Kernel tests that need an NVIDIA GPU and nvcc (marker ``cuda``): the
bsr_band kernel's staged and streamed paths, the strip kernel of bsr_fused
and bsr_ell, the gen-1 tile kernel of bsr_pallas, the sell2 row-major kernel,
the two SpMM kernels (spmm_band, also on X with ±inf and NaN; spmm_tiles
at m up to 256 through both maps) and the sell fused depth-0
and level kernels (the level launch on both of its paths), against their
plain versions on the same CUDA tensors (sell2's plain version sweeps
the panels that only a CPU build keeps, moved to the card),
spmv, spmm and multi_sssp launching each kernel, the sell2 plan of a card
build against a CPU build's, and the program's fixpoint
spans mapped onto a device trace against the launches they hold. They
skip without a card; run them on one with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the shared conftest imports JAX, which a machine with
only the port need not have.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from sparseharness_tpu_torch.formats import (
    banded_coo, block_random_coo, coo_from_arrays, deep_hub_coo, power_law_coo, random_coo,
)
from sparseharness_tpu_torch.ops import (
    LAUNCHES, bsr, bsr_band, bsr_ell, bsr_fused, sell, sell2, spmm, spmm_tiles, spmv,
)
from sparseharness_tpu_torch.semiring import REGISTRY, PLUS_TIMES, get_semiring
from sparseharness_tpu_torch.semiring.core import _carrier

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


def _assert_band_matches(name, got, ref, bound, strict):
    """NaN where NaN, else the same bits. Against the plain version two
    zeros of either sign also match (``strict`` False): torch's amax and
    amin leave the sign of a ±0 tie to their reduction order. plus_times:
    NaN where Σ|a·x| is NaN (a pad meets ±inf: 0·inf), and within
    1e-5 · max(1, |plain|, Σ|a·x|) where Σ|a·x| is finite; where it
    overflows, the sum's value depends on its order. Returns the rows held
    to the tolerance (0 for the other semirings)."""
    if name == "plus_times":
        nan = bound.isnan()
        assert bool(got[nan].isnan().all()) and bool(ref[nan].isnan().all())
        fin = bound.isfinite()
        tol = 1e-5 * torch.clamp(torch.maximum(ref.abs(), bound), min=1.0)
        assert bool(((got - ref).abs() <= tol)[fin].all())
        return int(fin.sum())
    if got.dtype != torch.float32:
        assert torch.equal(got, ref)
        return 0
    nan = got.isnan()
    assert torch.equal(nan, ref.isnan())
    same = got.view(torch.int32) == ref.view(torch.int32)
    if not strict:
        same |= (got == 0) & (ref == 0)
    assert bool(same[~nan].all()), f"{int((~same & ~nan).sum())} rows differ"
    return 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,value_dtype", CASES)
def test_kernel_paths_match_plain(name, value_dtype, cuda):
    """Both paths, with kc = K and kc = 1, on the tests' wide windows and a
    65,536-row cut of the bench band, for x that makes the pads matter:
    against band_dp_plain, and bit for bit, zero signs included, against
    the same dp with IEEE min and max."""
    sr = get_semiring(name)
    finite_rows = dict.fromkeys(bsr_band.X_KINDS, 0)
    for coo in (banded_coo(1200, 130, seed=12), random_coo(96, 700, 400, seed=13),
                banded_coo(1 << 14, 63, seed=1)):
        op = bsr_band.build_bsr_band(coo, sr, value_dtype=value_dtype, device=cuda)
        for kind in bsr_band.X_KINDS:
            x = bsr_band.band_x(sr, coo.shape[1], kind, np.random.default_rng(3))
            x2d = bsr_band.pad_x(op, torch.from_numpy(x).to(cuda), sr)
            ieee = bsr_band.band_dp_ieee(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win)
            for stage_x, kc in ((True, op.k_win), (False, op.k_win), (False, 1)):
                got = bsr_band.band_dp_cuda(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win,
                                            stage_x=stage_x, kc=kc, spans=op.spans)
                torch.cuda.synchronize()
                ref = bsr_band.band_dp_plain(op.strips, x2d, sr, c0=op.c0,
                                             k_win=op.k_win, kc=kc)
                bound = bsr_band.band_dp_plain(op.strips.abs(), x2d.abs(), PLUS_TIMES,
                                               c0=op.c0, k_win=op.k_win, kc=kc)
                finite_rows[kind] += _assert_band_matches(name, got, ref, bound, strict=False)
                _assert_band_matches(name, got, ieee, bound, strict=True)
    if name == "plus_times":
        assert min(finite_rows.values()) > 0, finite_rows


@pytest.mark.cuda
def test_kernel_refuses_stale_spans(cuda):
    """A span table made for other strips is refused before any launch."""
    sr = get_semiring("min_plus")
    op = bsr_band.build_bsr_band(banded_coo(2000, 30, seed=1), sr, device=cuda)
    x2d = bsr_band.pad_x(op, torch.zeros(op.n_cols, device=cuda), sr)
    stale = bsr_band.band_spans(op.strips.clone(), sr)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="other strips"):
        bsr_band.band_dp_cuda(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win,
                              stage_x=True, kc=op.k_win, spans=stale)
    with pytest.raises(ValueError, match="other strips"):
        bsr_band.dp_bsr_band(dataclasses.replace(op, spans=stale), torch.zeros(op.n_cols,
                             device=cuda), sr, n_rows=2000)
    assert LAUNCHES == before


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
    """Bit for bit for the six min/max/or semirings, plus_times within
    1e-5 · max(1, |plain|, Σ|a·x|) (the kernel sums a row in its own
    order), and the same bits on a second run."""
    sr = get_semiring(name)
    for coo in _sell2_cases():
        if sr.dtype == torch.bool:
            coo = coo.with_values(coo.vals != 0)
        op = sell2.build_sell2(coo, sr, value_dtype=value_dtype, device=cuda)
        x = _x(sr, coo.shape[1], seed=7).to(cuda)
        got = sell2.sell2_dp_cuda(op, x, sr)
        again = sell2.sell2_dp_cuda(op, x, sr)
        torch.cuda.synchronize()
        ref = _sell2_plain(coo, sr, value_dtype, x)
        assert got.dtype == ref.dtype
        _assert_kernel_matches(name, got, ref, _sell2_bound(coo, sr, value_dtype, x))
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def _sell2_plain(coo, sr, value_dtype, x):
    """The plain dp on x's card, over the panels of a CPU build."""
    op = sell2.build_sell2(coo, sr, value_dtype=value_dtype, device="cpu").to(x.device)
    return sell2.dp_sell2_plain(op, x, sr, n_rows=coo.shape[0])


def _sell2_bound(coo, sr, value_dtype, x):
    """Σ|a·x| of each dp row, for plus_times' tolerance (None otherwise)."""
    if sr.name != "plus_times":
        return None
    return _sell2_plain(coo.with_values(np.abs(coo.vals)), sr, value_dtype, x.abs())


@pytest.fixture(scope="module")
def heavy_power_law():
    """A power-law matrix whose rows fill every bin of the kernel, and
    whose hub rows have hundreds of pieces."""
    return power_law_coo(200_000, 800_000, alpha=1.5, seed=13)


@pytest.mark.cuda
@pytest.mark.parametrize("name,value_dtype", [("plus_times", "float32"),
                                              ("plus_times", "bfloat16"),
                                              ("min_plus", "float32"), ("or_and", "float32")])
def test_sell2_kernel_matches_plain_split_items(name, value_dtype, heavy_power_law, cuda):
    """The plain version's values, and the same bits again, where every bin
    of the kernel holds rows and owners fold hundreds of pieces."""
    sr = get_semiring(name)
    coo = heavy_power_law
    if sr.dtype == torch.bool:
        coo = coo.with_values(coo.vals != 0)
    op = sell2.build_sell2(coo, sr, value_dtype=value_dtype, device=cuda)
    assert all(op.plan.bin_rows)
    owners = op.plan.owners.cpu()
    assert int((owners[:, 2] - owners[:, 1]).max()) >= 100
    x = _x(sr, coo.shape[1], seed=9).to(cuda)
    got = sell2.sell2_dp_cuda(op, x, sr)
    again = sell2.sell2_dp_cuda(op, x, sr)
    torch.cuda.synchronize()
    ref = _sell2_plain(coo, sr, value_dtype, x)
    assert got.dtype == ref.dtype
    _assert_kernel_matches(name, got, ref, _sell2_bound(coo, sr, value_dtype, x))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["plus_times", "min_plus", "or_and"])
def test_sell2_kernel_folds_an_owner_row_of_its_own(name, cuda):
    """Pieces that are padding for owner row 0, a row with entries of its
    own, as a rank with no pieces holds them in the JAX package's stacked
    panels: the plan made on the card from that rank's entries and the
    stacked piece owners folds each owner from its own row's value, as the
    plain version does over those panels."""
    from sparseharness_tpu_torch.parallel import sharded_sell as tss
    from sparseharness_tpu_torch.parallel.mesh import Mesh

    sr = get_semiring(name)
    rng = np.random.default_rng(35)
    n = 2100
    bg = random_coo(n, n, 4200, seed=36)
    coo = coo_from_arrays(np.r_[np.full(400, 9), bg.rows],
                          np.r_[rng.choice(n, 400, replace=False), bg.cols],
                          np.r_[rng.uniform(0.1, 1.0, 400).astype(np.float32), bg.vals],
                          (n, n))
    if sr.dtype == torch.bool:
        coo = coo.with_values(coo.vals != 0)

    def rank1(m):
        """Rank 1's operand of a two-rank CPU build, moved to the card with a
        plan of its entries whose pieces are the stacked padding."""
        op = tss.build_sharded_sell(m, sr, 2, device="cpu")[0]
        local = tss.place_sell_shard(Mesh(rank=1, size=2, device=cuda, backend="nccl"), op)
        own, owner = local.plan, local.panels.piece_owner
        assert not own.n_pieces and owner is not None and not bool(owner.any())
        rp = own.row_ptr.long()
        rows = torch.repeat_interleave(own.row_dest.long(), rp[1:] - rp[:-1])
        k = own.n_entries
        n_pad = sum({lay.row0: lay.rows for lay in local.panels.layouts}.values())
        zero = torch.full((1,), _carrier(sr)[4], dtype=own.store, device=cuda)
        plan = sell2.make_plan(rows.to(torch.int32), own.cols[:k], own.vals[:k], zero, owner,
                               op.base_pad, n_pad, n)
        return dataclasses.replace(local, plan=plan), op.chunk_rows

    local, chunk_rows = rank1(coo)
    plan = local.plan
    rp = plan.row_ptr.cpu()
    assert plan.n_pieces and int(rp[-1]) > int(rp[sum(plan.bin_rows)])
    x = _x(sr, n, seed=11).to(cuda)
    got = sell2.sell2_dp_cuda(local, x, sr)
    ref = sell2.dp_sell2_plain(local, x, sr, n_rows=chunk_rows)
    torch.cuda.synchronize()
    bound = None
    if name == "plus_times":
        aop = rank1(coo.with_values(np.abs(coo.vals)))[0]
        bound = sell2.dp_sell2_plain(aop, x.abs(), sr, n_rows=chunk_rows)
    _assert_kernel_matches(name, got, ref, bound)


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


#: widths of X: the row map's (up to 32) with column tails and m no
#: multiple of 4, and the tile map's, with a second column tile at 200
SPMM_M = (1, 2, 5, 8, 16, 31, 32, 40, 64, 127, 128, 200)


def _spmm_tile_operands(sr, value_dtype, cuda):
    """(n_cols, strip operand): random blocks as bsr_ell and as bsr_fused
    (views of its slabs), K > 8, a band whose window is wider than the
    matrix and a band with K = 3 (the band-routed multi-source solves'
    shape), both through their explicit columns; tile shapes whose bm is no
    multiple of 4, whose bn is no multiple of 4 (the kernels' scalar
    loads), whose rows take several passes (bm = 72) and whose shared
    memory passes 48 KB; and tile_cols holding columns outside X's blocks,
    which both versions clamp into range."""
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
    for n, width in ((96, 40), (2000, 63)):
        band = bsr_band.build_bsr_band(banded_coo(n, width, seed=53), sr,
                                       value_dtype=value_dtype, device=cuda)
        ops.append((n, spmm_tiles.ell_operand_from_band(band)))
    assert ops[-1][1].tile_cols.shape[1] == 3
    op = bsr_ell.build_bsr_ell(random_coo(200, 1000, 3000, seed=9), sr,
                               value_dtype=value_dtype, device=cuda)
    cols = op.tile_cols.clone()
    cols[::3, 0] = -5
    cols[1::3, -1] = 1000 // 128 + 7
    ops.append((1000, op._replace(tile_cols=cols)))
    return ops


@pytest.mark.cuda
@pytest.mark.parametrize("name,value_dtype", CASES)
def test_spmm_tiles_kernel_matches_plain(name, value_dtype, cuda):
    """Bit for bit but plus_times (within the tolerance), at every width of
    SPMM_M through both thread maps, and the same bits on a second run."""
    sr = get_semiring(name)
    for n_cols, op in _spmm_tile_operands(sr, value_dtype, cuda):
        bn = op.tiles.shape[2] // op.tile_cols.shape[1]
        for m in SPMM_M:
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
            assert torch.equal(got, again), f"m={m}: two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("name,value_dtype", CASES)
def test_spmm_tiles_wide_m_matches_plain(name, value_dtype, cuda):
    """m above 64: the row map with 2 lanes a group wherever m and bm are
    multiples of 8 (72, 128, 136 and 256, two blocks of 128 columns), the
    tile map on the other shapes; bit for bit but plus_times, the same bits
    twice."""
    sr = get_semiring(name)
    for n_cols, op in _spmm_tile_operands(sr, value_dtype, cuda):
        bn = op.tiles.shape[2] // op.tile_cols.shape[1]
        for m in (72, 128, 136, 256):
            x2d = spmm_tiles.pad_x_block(_x_block(sr, n_cols, m, seed=m).to(cuda), bn, sr)
            got = spmm_tiles.spmm_tiles_cuda(op.tiles, op.tile_cols, x2d, sr)
            again = spmm_tiles.spmm_tiles_cuda(op.tiles, op.tile_cols, x2d, sr)
            torch.cuda.synchronize()
            ref = spmm_tiles.spmm_tiles_plain(op.tiles, op.tile_cols, x2d, sr)
            bound = None
            if name == "plus_times":
                bound = spmm_tiles.spmm_tiles_plain(op.tiles.abs(), op.tile_cols, x2d.abs(),
                                                    PLUS_TIMES)
            _assert_kernel_matches(name, got, ref, bound)
            assert torch.equal(got, again), f"m={m}: two runs differ"


#: the band SpMM's matrices: K = 3 at bn = 128, a window wider than the
#: matrix, K = 5 and 3,000 rows of a wide band
SPMM_BANDS = ((1024, 7, 1), (600, 4, 3), (96, 40, 53), (3000, 300, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_spmm_band_kernel_matches_plain(value_dtype, cuda):
    for n, width, seed in SPMM_BANDS:
        coo = banded_coo(n, width, seed=seed)
        op = bsr_band.build_bsr_band(coo, PLUS_TIMES, value_dtype=value_dtype, device=cuda)
        for m in (1, 40, 128, 200):
            x2d = bsr_band.pad_x_block(op, _x_block(PLUS_TIMES, coo.shape[1], m, seed=m).to(cuda))
            args = dict(c0=op.c0, k_win=op.k_win, spans=op.spans)
            got = bsr_band.band_spmm_cuda(op.strips, x2d, **args)
            again = bsr_band.band_spmm_cuda(op.strips, x2d, **args)
            torch.cuda.synchronize()
            ref = bsr_band.band_spmm_plain(op.strips, x2d, c0=op.c0, k_win=op.k_win)
            bound = bsr_band.band_spmm_plain(op.strips.abs(), x2d, c0=op.c0, k_win=op.k_win)
            _assert_kernel_matches("plus_times", got, ref, bound)
            assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_spmm_band_kernel_nonfinite_x(value_dtype, cuda):
    """X with +inf, −inf and NaN in 30 seeded places of its first half of
    columns (and X negative too):
    NaN exactly where the plain version's is, which multiplies every slot
    (a pad the kernel skips meets a non-finite value: 0·inf), ±inf equal,
    the outputs whose window holds no non-finite value within the
    tolerance, and the same bits, NaNs included, on a second call."""
    rng = np.random.default_rng(71)
    for n, width, seed in SPMM_BANDS:
        coo = banded_coo(n, width, seed=seed)
        op = bsr_band.build_bsr_band(coo, PLUS_TIMES, value_dtype=value_dtype, device=cuda)
        for m in (3, 128, 136):
            x = rng.uniform(-1.0, 1.0, (n, m)).astype(np.float32)
            # in the first half of the columns: the others stay finite
            x[rng.integers(0, n, 30), rng.integers(0, (m + 1) // 2, 30)] = [
                np.inf, -np.inf, np.nan] * 10
            x2d = bsr_band.pad_x_block(op, torch.from_numpy(x).to(cuda))
            args = dict(c0=op.c0, k_win=op.k_win, spans=op.spans)
            got = bsr_band.band_spmm_cuda(op.strips, x2d, **args)
            again = bsr_band.band_spmm_cuda(op.strips, x2d, **args)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), again.view(torch.int32))
            ref = bsr_band.band_spmm_plain(op.strips, x2d, c0=op.c0, k_win=op.k_win)
            bound = bsr_band.band_spmm_plain(op.strips.abs(), x2d.abs(), c0=op.c0,
                                             k_win=op.k_win)
            assert torch.equal(got.isnan(), ref.isnan()), f"n={n} m={m}: NaN differs"
            inf = ref.isinf()
            assert torch.equal(got[inf], ref[inf])
            fin = bound.isfinite()
            assert bool(fin.any()) and bool(ref.isnan().any())
            _assert_kernel_matches("plus_times", got[fin], ref[fin], bound[fin])


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


def _sell_cases():
    """_sell_matrices and a band whose level-0 windows (about 95 stream rows
    for 32 lanes) overlap from one output row to the next: three levels in
    several slabs."""
    return _sell_matrices() + [(banded_coo(1 << 14, 63, seed=1), {})]


@pytest.mark.cuda
@pytest.mark.parametrize("stage_rows", [sell.STAGE_ROWS, 0], ids=["staged", "in_place"])
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_sell_fused_kernel_matches_plain(name, stage_rows, cuda):
    """The fused depth-0 kernel alone against level_plain(phase_a_plain(…),
    idx0) per slab (fused_plain): bit for bit for every semiring, with its
    blocks staged and with every block gathering in place."""
    sr = get_semiring(name)
    for coo, kw in _sell_cases():
        if sr.dtype == torch.bool:
            coo = coo.with_values(coo.vals != 0)
        op = sell.regroup(sell.build_sell(coo, sr, device=cuda, **kw), stage_rows=stage_rows)
        x2d = sell.pad_x2d(op, _x(sr, coo.shape[1], seed=9).to(cuda), sr)
        work_ref, dp_ref = sell.fused_plain(op, x2d, sr)
        work, dp = torch.zeros_like(work_ref), torch.zeros_like(dp_ref)
        sell.fused_cuda(op, x2d, sr, work, dp)
        torch.cuda.synchronize()
        assert torch.equal(work.view(torch.int32), work_ref.view(torch.int32))
        assert torch.equal(dp.view(torch.int32), dp_ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_sell_kernels_match_plain(name, cuda):
    """Both sell kernels against the plain dp: bit for bit for every
    semiring, plus_times included, and the same bits on a second call."""
    sr = get_semiring(name)
    for coo, kw in _sell_cases():
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
@pytest.mark.parametrize("path", ["shared", "work"])
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_sell_level_kernel_matches_plain(name, path, cuda):
    """The level launch alone, from the fused launch's level-0 rows, against
    its model (levels_plain) on the same rows, and the whole dp against
    dp_sell_plain: bit for bit for every semiring, with every slab's later
    levels chained in shared memory and with every slab through the work
    buffer, on matrices of 2, 3 and 4 levels."""
    sr = get_semiring(name)
    limit = sell.LEVEL_ROWS_MAX if path == "shared" else 0
    for coo, kw in _sell_cases() + [(deep_hub_coo(), {})]:
        if sr.dtype == torch.bool:
            coo = coo.with_values(coo.vals != 0)
        op = sell.relevel(sell.build_sell(coo, sr, device=cuda, **kw), limit)
        x = _x(sr, coo.shape[1], seed=10).to(cuda)
        x2d = sell.pad_x2d(op, x, sr)
        work, dp = sell.fused_plain(op, x2d, sr)
        work_ref, dp_ref = work.clone(), dp.clone()
        sell.levels_cuda(op, sr, work, dp)
        sell.levels_plain(op, sr, work_ref, dp_ref)
        torch.cuda.synchronize()
        assert torch.equal(dp.view(torch.int32), dp_ref.view(torch.int32))
        assert torch.equal(work.view(torch.int32), work_ref.view(torch.int32))
        got = sell.sell_dp_cuda(op, x2d, sr)
        ref = sell.dp_sell_plain(op, x, sr, n_rows=coo.shape[0])
        assert torch.equal(got > 0, ref) if sr.dtype == torch.bool else torch.equal(
            got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_spmv_sell_launches_one_fused_and_one_level_per_call(cuda):
    """Two launches a call whatever the depth, on a matrix of three levels
    whose launch mixes both paths (its largest slab moved to the work path
    by a lower shared-memory limit); none for the level launch where every
    slab is one level."""
    coo = power_law_coo(2000, 30000, seed=5)
    op = sell.relevel(sell.build_sell(coo, PLUS_TIMES, slab_nnz=8000, device=cuda), 500)
    assert len(op.layouts) >= 2 and op.max_levels == 3
    assert sorted(set(op.chains[:, 1].tolist())) == [0, 1]
    x = _x(PLUS_TIMES, coo.shape[1], seed=4).to(cuda)
    before = dict(LAUNCHES)
    y = spmv(op, x, sr=PLUS_TIMES, variant="sell", n_rows=coo.shape[0])
    torch.cuda.synchronize()
    assert LAUNCHES["sell_fused"] == before["sell_fused"] + 1
    assert LAUNCHES["sell_level"] == before["sell_level"] + 1
    assert sum(LAUNCHES.values()) == sum(before.values()) + 2
    level0 = sum(lay.levels[0].d_out for lay in op.layouts if not lay.levels[0].final)
    inner = sum(lv.d_out for lay, c in zip([lay for lay in op.layouts if len(lay.levels) > 1],
                                           op.chains[:, 1].tolist())
                if not c for lv in lay.levels[1:] if not lv.final)
    assert op.work_rows == level0 + inner
    diag = coo_from_arrays(np.arange(700), np.arange(700)[::-1].copy(),
                           np.ones(700, np.float32), (700, 700))
    one = sell.build_sell(diag, PLUS_TIMES, device=cuda)
    assert one.max_levels == 1 and one.chains.shape[0] == 0
    before = dict(LAUNCHES)
    spmv(one, torch.ones(700, device=cuda), sr=PLUS_TIMES, variant="sell", n_rows=700)
    assert LAUNCHES["sell_fused"] == before["sell_fused"] + 1
    assert LAUNCHES["sell_level"] == before["sell_level"]
    cpu_op = sell.build_sell(coo, PLUS_TIMES, slab_nnz=8000, device="cpu")
    ref = spmv(cpu_op, x.cpu(), sr=PLUS_TIMES, variant="sell", n_rows=coo.shape[0])
    assert torch.equal(y.cpu(), ref)


@pytest.mark.cuda
def test_sell2_plan_same_on_card_and_cpu(cuda):
    """The ragged bench matrix built on the card gives the plan that a CPU
    build gives, field for field, and holds no panels."""
    coo = power_law_coo(500_000, 2_000_000, alpha=1.5, seed=13)
    cpu_plan = sell2.build_sell2(coo, PLUS_TIMES, device="cpu").plan
    card = sell2.build_sell2(coo, PLUS_TIMES, device=cuda)
    card_plan = card.plan
    assert card.panels is None
    assert card_plan.device.type == "cuda" and cpu_plan.device.type == "cpu"
    for field in dataclasses.fields(cpu_plan):
        a, b = getattr(cpu_plan, field.name), getattr(card_plan, field.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b.cpu()), field.name
        elif field.name in ("n_final", "bin_rows", "bin_entries", "n_entries"):
            assert a == b, field.name
    assert card_plan.store == cpu_plan.store


# ------------------------------------------------- the sharded path on a card

SHARDED_EXACT = [n for n in sorted(REGISTRY) if n != "plus_times"]


def _sharded_band_cases():
    """(name, windowed) → (Call of the world-1 sharded band SpMV, the
    operand's matrix, x)."""
    from sparseharness_tpu_torch.parallel import Call, sharded_band

    cases = {}
    for name in SHARDED_EXACT:
        sr = get_semiring(name)
        coo = banded_coo(1 << 14, 63, seed=1)
        if sr.dtype == torch.int32:
            coo = coo.with_values((np.abs(coo.vals * 100).astype(np.int32) % 50 + 1))
        op = sharded_band.build_sharded_band(coo, sr, 1, device="cpu")[0]
        x = _x(sr, coo.shape[1], seed=7)
        for windowed in (None, True):
            cases[(name, windowed)] = (Call(sharded_band.sharded_spmv_band, dict(
                op=dataclasses.replace(op, windowed=windowed), x=x, sr=sr,
                n_rows=coo.shape[0])), coo, x)
    return cases


@pytest.fixture(scope="module")
def sharded_band_world1():
    """Every case's dp from one NCCL world of one rank on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sparseharness_tpu_torch.parallel import run_calls, run_world

    cases = _sharded_band_cases()
    keys = sorted(cases, key=str)
    out = run_world(run_calls, 1, device="cuda", args=([cases[k][0] for k in keys],))[0]
    return cases, dict(zip(keys, out))


@pytest.mark.cuda
@pytest.mark.parametrize("windowed", [None, True], ids=["rule", "streamed"])
@pytest.mark.parametrize("name", SHARDED_EXACT)
def test_sharded_band_dp_world1_matches_single_device(name, windowed, sharded_band_world1,
                                                      cuda):
    """The band mode at world size 1 (head, interior and tail launches with
    their own span tables) gives the single-device kernel's dp bit for
    bit."""
    cases, got = sharded_band_world1
    _, coo, x = cases[(name, windowed)]
    sr = get_semiring(name)
    op = bsr_band.build_bsr_band(coo, sr, device=cuda)
    ref = spmv(op, x.to(cuda), sr=sr, variant="bsr_band", n_rows=coo.shape[0]).cpu().numpy()
    dp = got[(name, windowed)]
    assert dp.dtype == ref.dtype and dp.shape == ref.shape
    np.testing.assert_array_equal(dp, ref)


@pytest.mark.cuda
def test_gloo_two_ranks_share_one_card(cuda):
    """Two ranks on one card over gloo (their exchanges copied through the
    host): the band mode and the frontier agree with the single-device
    solves."""
    from sparseharness_tpu_torch.algorithms import bfs, sssp
    from sparseharness_tpu_torch.parallel import Call, run_calls, run_world
    from sparseharness_tpu_torch.parallel import frontier, sharded

    band = banded_coo(1 << 12, 63, seed=1)
    out = run_world(run_calls, 2, backend="gloo", device="cuda", args=([
        Call(sharded.sharded_sssp, dict(coo=band, root=0, mode="band")),
        Call(frontier.frontier_bfs, dict(coo=band, root=0, budget=512))],))
    s, b = sssp(band, 0, variant="bsr_band", device=cuda), bfs(band, 0, device=cuda)
    for rank in out:
        got_s, got_b = rank
        np.testing.assert_array_equal(got_s.x, s.x.cpu().numpy())
        assert (got_s.iterations, got_s.converged) == (s.iterations, s.converged)
        np.testing.assert_array_equal(got_b.x, b.x.cpu().numpy())
        np.testing.assert_array_equal(got_b.aux, b.aux.cpu().numpy())
        assert (got_b.iterations, got_b.converged) == (b.iterations, b.converged)


@pytest.mark.cuda
def test_step_spans_hold_their_launches(cuda, tmp_path):
    """The program's spans mapped onto a device-only torch.profiler trace:
    every launch of a device op in a short band solve falls inside its
    ``fixpoint.solve`` span, and each ``fixpoint.step`` span holds the same
    number of launches, one at least. (The trace's device clock drifts
    against the host's by tens of µs a second; ``portbench/spans.py``
    measures and removes that over longer stretches.)"""
    import json

    from torch.profiler import ProfilerActivity, profile

    from sparseharness_tpu_torch.algorithms import apps
    from sparseharness_tpu_torch.algorithms.fixpoint import run_fixpoint
    from sparseharness_tpu_torch.utils import timing

    coo = banded_coo(1 << 11, 15, seed=3)
    coo = coo.with_values(np.abs(coo.vals) + 0.1)
    comp = apps.fixpoint_components("sssp", coo, 0, variant="auto", device=cuda)

    def solve():
        return run_fixpoint(comp.step, comp.x0, convergence=comp.convergence,
                            max_iter=comp.limit)

    solve()  # builds and loads the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        timing.start_recording()
        res = solve()
        torch.cuda.synchronize()
        rec = timing.stop_recording()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    device = {e["args"]["correlation"] for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    launches = [e["ts"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in device]
    assert rec[0].name == "fixpoint.solve" and launches
    lo, hi = rec.trace_us(rec[0].start_ns, base), rec.trace_us(rec[0].end_ns, base)
    assert all(lo <= t <= hi for t in launches)
    steps = [(rec.trace_us(s.start_ns, base), rec.trace_us(s.end_ns, base))
             for s in rec if s.name == "fixpoint.step"]
    assert len(steps) == res.iterations > 1
    held = [sum(a <= t <= b for t in launches) for a, b in steps]
    assert min(held) >= 1 and len(set(held)) == 1, held
