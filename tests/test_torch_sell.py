"""The port's sell variant against the JAX package's (ops/pallas_sell), on
the matrices of tests/test_sell_frontier.py and the gate's matrix.

The port's build_sell must reproduce the JAX build's arrays and layouts
exactly and refuse what it refuses. The plain dp, on the port-built operand
and on the JAX-built one carried over by interop, must equal JAX's dp_sell
(its Pallas kernels in interpret mode) bit for bit for all seven
semirings, plus_times included: both fold in the layout's fixed order. The
CUDA kernels cannot run here, so their tables are held by torch models of
what csrc/sell.cu computes from them (the fused launch's here, the level
launch's ``sell.levels_plain``), which must give the plain version's and
JAX's bits, on both of the level launch's paths (a slab's later levels
chained in shared memory, or through the work buffer). Tolerance: none,
bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparseharness_tpu.algorithms as ja
import sparseharness_tpu.formats as jf
import sparseharness_tpu.ops.pallas_sell as js
from sparseharness_tpu.ops import spmv as jax_spmv, build_operand as jax_build_operand
from sparseharness_tpu.semiring import get_semiring as jax_semiring
import sparseharness_tpu_torch.algorithms as ta
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.gold import Correctness, check_result, spmv_gold
from sparseharness_tpu_torch.harness import variant_bytes
from sparseharness_tpu_torch.ops import LAUNCHES, build_operand, sell, spmv
from sparseharness_tpu_torch.ops.interop import sell_operand_from_numpy
from sparseharness_tpu_torch.semiring import REGISTRY, PLUS_TIMES, get_semiring
from sparseharness_tpu_torch.semiring.core import _carrier

NAMES = sorted(REGISTRY)


def _hub(m):
    """Row 0 holds 400 entries over a 600-row background: more than W_MAX,
    so it chains through a second level before the final one."""
    rng = np.random.default_rng(0)
    n = 600
    hub_cols = rng.choice(n, 400, replace=False)
    bg = m.random_coo(n, n, 2000, seed=2)
    rows = np.concatenate([np.zeros(400, np.int64), bg.rows])
    cols = np.concatenate([hub_cols, bg.cols])
    vals = rng.uniform(0.1, 1.0, len(rows)).astype(np.float32)
    return m.coo_from_arrays(rows, cols, vals, (n, n))


def _empty_dups(m):
    """A duplicate (0, 3), empty rows 1-4, and a column past the first
    block."""
    return m.coo_from_arrays([0, 0, 0, 5, 5], [3, 3, 7, 1, 200],
                             np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32), (300, 300))


# (maker taking a formats module, build keywords)
MATRICES = {
    "power_law": (lambda m: m.power_law_coo(1500, 9000, seed=4), {}),
    "hub": (_hub, {}),
    "multislab": (lambda m: m.power_law_coo(2000, 30000, seed=5), {"slab_nnz": 8000}),
    "empty_dups": (_empty_dups, {}),
    "gate": (lambda m: m.random_coo(1138, 1138, 4054, seed=0), {}),
}
# the semirings that shape a build: float values, a FLT_MAX pad, the int32
# carrier of or_and and an int32 semiring with an INT_MAX pad
BUILD_NAMES = ["plus_times", "min_plus", "or_and", "min_right"]
# JAX's dp runs its Pallas kernels in interpret mode (seconds a call): every
# semiring on the matrices with the most levels, three on the rest
DP_CASES = [(m, n) for m in sorted(MATRICES)
            for n in (NAMES if m in ("power_law", "hub") else ["plus_times", "min_plus",
                                                                "or_and"])]


def _coos(matrix, sr, matrices=MATRICES):
    make, kw = matrices[matrix]
    coo_t, coo_j = make(tf), make(jf)
    if sr.dtype == torch.bool:
        coo_t = coo_t.with_values(coo_t.vals != 0)
        coo_j = coo_j.with_values(coo_j.vals != 0)
    return coo_t, coo_j, kw


def _x(sr, n, seed):
    rng = np.random.default_rng(seed)
    if sr.dtype == torch.bool:
        return rng.random(n) < 0.3
    if sr.dtype == torch.int32:
        return rng.integers(0, 50, n).astype(np.int32)
    return rng.uniform(0.1, 1.0, n).astype(np.float32)


def _carry(jop):
    return sell_operand_from_numpy([{k: np.asarray(v) for k, v in s.items()}
                                    for s in jop.slabs],
                                   jop.layouts, jop.xrows, jop.n_rows, device="cpu")


def _same_bits(port: torch.Tensor, ref) -> None:
    port, ref = port.numpy(), np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_array_equal(port.view(np.uint8), ref.view(np.uint8))


# the build's cases: the dp's matrices and a band with three levels in
# several slabs, whose rows of 127 entries cut into two runs of 64
BUILD_MATRICES = {**MATRICES,
                  "band_levels": (lambda m: m.banded_coo(1 << 13, 63, seed=1),
                                  {"slab_nnz": 200_000})}


@pytest.mark.parametrize("matrix", sorted(BUILD_MATRICES))
@pytest.mark.parametrize("name", BUILD_NAMES)
def test_build_matches_jax(name, matrix):
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j, kw = _coos(matrix, sr, BUILD_MATRICES)
    op = sell.build_sell(coo_t, sr, device="cpu", **kw)
    jop = js.build_sell(coo_j, jsr, **kw)
    if matrix == "band_levels":
        assert len(op.layouts) >= 2 and op.max_levels == 3
    assert op.layouts == jop.layouts
    assert (op.xrows, op.n_rows) == (jop.xrows, jop.n_rows)
    assert len(op.slabs) == len(jop.slabs)
    for slab, jslab in zip(op.slabs, jop.slabs):
        assert list(slab) == list(jslab)
        for key in slab:
            port, ref = slab[key].numpy(), np.asarray(jslab[key])
            assert port.dtype == ref.dtype and port.shape == ref.shape, key
            np.testing.assert_array_equal(port, ref, err_msg=key)


def test_matrices_reach_every_mechanism():
    """Several slabs, a hub row that chains through an extra level, empty
    rows, and the w = 1, 4 and 16 regions."""
    ops = {m: sell.build_sell(MATRICES[m][0](tf), PLUS_TIMES, device="cpu", **MATRICES[m][1])
           for m in MATRICES}
    assert len(ops["multislab"].layouts) >= 2
    assert max(len(lay.levels) for lay in ops["hub"].layouts) >= 3
    widths = {w for op in ops.values() for lay in op.layouts for lv in lay.levels
              for (w, _, _) in lv.regions}
    assert {1, 4, 16} <= widths
    assert ops["empty_dups"].n_pad == 384


@pytest.mark.parametrize("make,kw", [
    # phase-A stream too skewed: 36,352 sublanes > TB_MAX
    (lambda m: m.power_law_coo(65536, 262144, seed=13), {}),
    # x wider than XROWS_MAX · 128 = 262,144 columns
    (lambda m: m.random_coo(64, 262_145, 300, seed=1), {}),
    # one row above slab_nnz
    (lambda m: m.coo_from_arrays(np.zeros(50, np.int32), np.arange(50), np.ones(50, np.float32),
                                 (10, 64)), {"slab_nnz": 40}),
], ids=["tb_max", "wide_x", "row_over_slab"])
def test_refuses_what_jax_refuses(make, kw):
    with pytest.raises(NotImplementedError) as ref:
        js.build_sell(make(jf), jax_semiring("plus_times"), **kw)
    with pytest.raises(NotImplementedError) as port:
        sell.build_sell(make(tf), PLUS_TIMES, device="cpu", **kw)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("matrix,name", DP_CASES)
def test_plain_dp_matches_jax_kernels(matrix, name):
    """The plain dp, and the routed dp that takes it on CPU tensors, on the
    port-built and the carried-over operand, against JAX's dp_sell on its
    own operand: bit for bit."""
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j, kw = _coos(matrix, sr)
    n, c = coo_t.shape
    x = _x(sr, c, seed=14)
    jop = js.build_sell(coo_j, jsr, **kw)
    ref = js.dp_sell(jop, jnp.asarray(x), jsr, n_rows=n)
    for op in (sell.build_sell(coo_t, sr, device="cpu", **kw), _carry(jop)):
        port = sell.dp_sell_plain(op, torch.from_numpy(x), sr, n_rows=n)
        _same_bits(port, ref)
        assert torch.equal(sell.dp_sell(op, torch.from_numpy(x), sr, n_rows=n), port)


def _fused_model(op, x2d, sr, work, dp):
    """What the fused depth-0 launch of csrc/sell.cu computes from its
    groups table, in torch: per block, its output rows' idx slots of its 32
    lanes; a staged block gathers from the products of its window of
    stream rows (which must hold every valid slot), a block in place from
    the stream's lanesel / vals / blocksel; slots at or past t_a read 0̄;
    each output is the left-to-right ⊕ of its w slots."""
    _, add, mul, _, zero, _ = _carrier(sr)
    xflat = x2d.reshape(-1)
    flat_idx = op.idx.long()
    for g in op.groups.long().tolist():
        i0, w, nq, out0, final, lane0, src, t_a, win, win_rows = g[:10]
        lanes = torch.arange(lane0, lane0 + sell.GROUP_LANES)
        ix = flat_idx[i0:i0 + nq * w, lane0:lane0 + sell.GROUP_LANES]
        valid = ix < t_a
        if win_rows:
            rel = ix + src - win
            assert bool(((rel >= 0) & (rel < win_rows))[valid].all())
            rows = torch.arange(win, win + win_rows)
            stage = mul(xflat[op.blocksel[rows].long() * 128 + op.lanesel[rows][:, lanes].long()],
                        op.vals[rows][:, lanes])
            z = torch.gather(stage, 0, rel.clamp(0, win_rows - 1))
        else:
            rows = (src + ix).clamp(max=op.lanesel.shape[0] - 1)
            lane = lanes.expand_as(ix)
            z = mul(xflat[op.blocksel[rows, 0].long() * 128 + op.lanesel[rows, lane].long()],
                    op.vals[rows, lane])
        z = torch.where(valid, z, torch.full_like(z, zero)).view(nq, w, -1)
        acc = z[:, 0]
        for t in range(1, w):
            acc = add(acc, z[:, t])
        (dp if final else work)[out0:out0 + nq, lane0:lane0 + sell.GROUP_LANES] = acc


def _kernel_model(op, x2d, sr):
    """What csrc/sell.cu computes from its tables, in torch: the fused
    depth-0 launch (_fused_model), then the level launch
    (sell.levels_plain: per chain row and 32-lane slice, every later depth
    in turn, through the block's shared rows or the work buffer), from a
    work buffer and a dp full of stale values, which must not leak."""
    carrier = _carrier(sr)[0]
    work = torch.full((op.work_rows, 128), 7, dtype=carrier)
    dp = torch.full((op.n_pad // 128, 128), 7, dtype=carrier)
    _fused_model(op, x2d, sr, work, dp)
    sell.levels_plain(op, sr, work, dp.view(-1))
    return dp.reshape(-1)


def _level_paths(op):
    """The operand as built (every slab on the shared path: none of these
    needs more rows than LEVEL_ROWS_MAX), with the slabs that need more
    rows than the median chain on the work path, and with every slab on
    the work path."""
    need = [sum(sell.chain_rows(lay)) for lay in op.layouts if len(lay.levels) > 1]
    split = int(np.median(need)) if need else 0
    return {"built": op, "split": sell.relevel(op, split), "work": sell.relevel(op, 0)}


@pytest.mark.parametrize("stage_rows", [sell.STAGE_ROWS, 0], ids=["staged", "in_place"])
@pytest.mark.parametrize("matrix", ["hub", "multislab", "empty_dups", "power_law"])
def test_kernel_model_equals_plain(matrix, stage_rows):
    """The launch tables drive the kernels' arithmetic to the plain
    version's bits, for every semiring, with the fused launch's blocks
    staged where they may be and with every block gathering in place, and
    the level launch as built, all shared and all through the work
    buffer."""
    for name in NAMES:
        sr = get_semiring(name)
        coo, _, kw = _coos(matrix, sr)
        built = sell.regroup(sell.build_sell(coo, sr, device="cpu", **kw), stage_rows=stage_rows)
        x = torch.from_numpy(_x(sr, coo.shape[1], seed=6))
        want = sell.dp_sell_plain(built, x, sr, n_rows=coo.shape[0])
        for path, op in _level_paths(built).items():
            got = _kernel_model(op, sell.pad_x2d(op, x, sr), sr)
            if _carrier(sr)[5]:
                got = got > 0
            assert got.dtype == want.dtype and torch.equal(got, want), (name, path)


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "or_and", "min_right"])
def test_fused_model_equals_fused_plain_on_band(name):
    """On a band, whose level-0 windows overlap from one output row to the
    next, the fused launch's model writes fused_plain's level-0 rows."""
    sr = get_semiring(name)
    coo = tf.banded_coo(1 << 12, 63, seed=1)
    if sr.dtype == torch.bool:
        coo = coo.with_values(coo.vals != 0)
    op = sell.build_sell(coo, sr, slab_nnz=120_000, device="cpu")
    assert op.stage_rows > 0 and len(op.layouts) >= 2
    x2d = sell.pad_x2d(op, torch.from_numpy(_x(sr, coo.shape[1], seed=3)), sr)
    work_ref, dp_ref = sell.fused_plain(op, x2d, sr)
    work, dp = torch.zeros_like(work_ref), torch.zeros_like(dp_ref).view(-1, 128)
    _fused_model(op, x2d, sr, work, dp)
    assert torch.equal(work, work_ref) and torch.equal(dp.reshape(-1), dp_ref)


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_fused_groups_cover_level0_once(matrix):
    """Every level-0 output (row, lane) belongs to one fused block; each
    block is one region's run width, at most GROUP_SLOTS idx rows, and a
    staged window within STAGE_ROWS that holds every valid slot."""
    make, kw = MATRICES[matrix]
    op = sell.build_sell(make(tf), PLUS_TIMES, device="cpu", **kw)
    g = op.groups.numpy().astype(np.int64)
    assert g.shape[1] == sell.GROUP_WORDS and (g[:, 10:] == 0).all()
    assert op.stage_rows == g[:, sell.G_WIN_ROWS].max(initial=0) <= sell.STAGE_ROWS
    covered = {}
    for i0, w, nq, out0, final, lane0, src, t_a, win, win_rows, _, _ in g:
        assert nq * w <= max(sell.GROUP_SLOTS, w) and lane0 % sell.GROUP_LANES == 0
        for q in range(nq):
            key = (int(final), int(out0) + q)
            covered[key] = covered.get(key, 0) | (((1 << sell.GROUP_LANES) - 1) << int(lane0))
        if win_rows:
            ix = op.idx[i0:i0 + nq * w, lane0:lane0 + sell.GROUP_LANES].numpy()
            v = ix[ix < t_a] + src
            assert v.min() >= win and v.max() < win + win_rows
    want = {}
    for si, lay in enumerate(op.layouts):
        out0 = int(op.table[si, 5])
        for r in range(lay.levels[0].d_out):
            want[(int(lay.levels[0].final), out0 + r)] = (1 << 128) - 1
    assert covered == want
    assert sum(nq for nq in g[:, 2]) == 4 * sum(lay.levels[0].d_out for lay in op.layouts)


def test_fused_traffic_on_band():
    """The fused launch's bytes on a band: the bound counts the stream's
    sectors that hold a slot some valid idx names (array_bytes every row);
    staging reads each such sector about once (its windows' pad lanes too),
    so by design it moves at most 6% more than the bound, and a gather in
    place touches a sector for nearly every slot."""
    op = sell.build_sell(tf.banded_coo(1 << 12, 63, seed=1), PLUS_TIMES, slab_nnz=120_000,
                         device="cpu")
    t = sell.fused_traffic(op)
    region_rows = sum(r[2] - r[1] for lay in op.layouts for r in lay.levels[0].regions)
    level0 = sum(lay.levels[0].d_out for lay in op.layouts) * 128 * 4
    fixed = region_rows * 128 * 4 + op.xrows * 128 * 4 + level0
    assert t["array_bytes"] == fixed + op.lanesel.shape[0] * (128 * 8 + 4)
    sectors = rows = 0
    for s, lay in zip(op.slabs, op.layouts):
        ix = s["idx0"].numpy()
        r, lane = np.nonzero(ix < lay.t_a)
        sectors += len({(int(ix[a, b]), int(b) // 8) for a, b in zip(r, lane)})
        rows += len(np.unique(ix[ix < lay.t_a]))
    assert t["bound_bytes"] == fixed + sectors * 64 + rows * 4 < t["array_bytes"]
    assert t["staged_blocks"] == t["blocks"]
    assert t["bound_bytes"] <= t["staged_bytes"] <= 1.06 * t["bound_bytes"]
    assert t["in_place_bytes"] > 3 * t["staged_bytes"]
    assert 24 < t["rows_per_warp_step"] <= 32


def test_level_traffic_on_band():
    """The level launch's bytes on a band of three levels in several slabs:
    the bound reads the level-0 rows and the later levels' idx region rows
    once (not the padding past a level's last region) and writes the
    slabs' final rows; by design the shared path also reads its table
    entries and keeps the intermediates on chip, and the work path writes
    and reads them back. Operations: one ⊕ a valid slot past its run's
    first."""
    op = sell.build_sell(tf.banded_coo(1 << 13, 63, seed=1), PLUS_TIMES, slab_nnz=200_000,
                         device="cpu")
    t = sell.level_traffic(op)
    level0 = sum(lay.levels[0].d_out for lay in op.layouts) * 512
    later_idx = sum(lv.t_src for lay in op.layouts for lv in lay.levels[1:]) * 512
    regions = sum(lv.regions[-1][2] for lay in op.layouts for lv in lay.levels[1:]) * 512
    finals = sum(lay.levels[-1].d_out for lay in op.layouts) * 512
    assert finals == op.n_pad * 4 and regions < later_idx   # every slab chains here
    entries = sum(len(lay.levels) - 1 for lay in op.layouts) * 4 * sell.ENTRY_WORDS * 4
    inter = sum(lv.d_out for lay in op.layouts for lv in lay.levels[1:-1]) * 512
    assert t["bound_bytes"] == level0 + regions + finals
    assert t["design_bytes"] == entries + regions + level0 + finals
    assert t["bound_bytes"] <= t["design_bytes"]
    assert t["shared_chains"] == len(op.layouts) and t["work_chains"] == 0
    work = sell.level_traffic(sell.relevel(op, 0))
    assert work["design_bytes"] == t["design_bytes"] + 2 * inter
    ops = 0
    for slab, lay in zip(op.slabs, op.layouts):
        for li in range(1, len(lay.levels)):
            ix = slab[f"idx{li}"].numpy()
            for (w, s0, s1) in lay.levels[li].regions:
                valid = (ix[s0:s1] < lay.levels[li - 1].d_out).reshape(-1, w, 128)
                ops += int(valid.sum() - valid.any(1).sum())
    assert t["operations"] == work["operations"] == ops > 0


def test_launch_table_shape():
    """One entry per (slab, level), depth by depth; each depth's rows are
    the sum of its entries' output rows; the work buffer holds only level
    0's non-final outputs and those of the slabs whose later levels do not
    fit shared memory (no contrib stream, no intermediates of a shared
    slab), and a level-0 entry's source is its slab's phase-A stream."""
    op = sell.build_sell(MATRICES["multislab"][0](tf), PLUS_TIMES, slab_nnz=8000,
                         device="cpu")
    n_levels = [len(lay.levels) for lay in op.layouts]
    assert op.table.shape == (sum(n_levels), sell.ENTRY_WORDS)
    assert len(op.depth_rows) == op.max_levels == max(n_levels)
    for d, rows in enumerate(op.depth_rows):
        assert rows == sum(lay.levels[d].d_out for lay in op.layouts if d < len(lay.levels))
    level0 = sum(lay.levels[0].d_out for lay in op.layouts if not lay.levels[0].final)
    assert op.work_rows == level0   # every slab fits the level block's shared memory
    mixed = sell.relevel(op, 500)
    shared = [sum(sell.chain_rows(lay)) <= 500 for lay in op.layouts]
    assert True in shared and False in shared   # both paths in one launch
    inner = sum(lv.d_out for lay, sh in zip(op.layouts, shared) if not sh
                for lv in lay.levels[1:] if not lv.final)
    assert mixed.work_rows == level0 + inner > level0
    every = sum(lv.d_out for lay in op.layouts for lv in lay.levels if not lv.final)
    assert sell.relevel(op, 0).work_rows == every > mixed.work_rows
    a_off = np.cumsum([0] + [lay.t_a for lay in op.layouts])[:-1]
    assert op.table[:len(op.layouts), 2].tolist() == a_off.tolist()
    assert op.table[:len(op.layouts), 3].tolist() == [lay.t_a for lay in op.layouts]
    assert op.idx.shape[0] == sum(lv.t_src for lay in op.layouts for lv in lay.levels)


def _one_level(m):
    """A permutation: no row holds two entries, so level 0 is final and the
    level launch has nothing to do."""
    rng = np.random.default_rng(5)
    return m.coo_from_arrays(np.arange(700), rng.permutation(700),
                             rng.uniform(0.1, 1.0, 700).astype(np.float32), (700, 700))


def _deep(m):
    """tf.deep_hub_coo in ``m``'s COO: row 0 holds 4,100 entries (more than
    W_MAX², so it chains through three levels past 0)."""
    c = tf.deep_hub_coo()
    return m.coo_from_arrays(c.rows, c.cols, c.vals, c.shape)


# (maker, build keywords), by the levels of their deepest slab
LEVEL_MATRICES = {
    "one_level": (_one_level, {}),
    "two_levels": MATRICES["gate"],
    "three_levels": MATRICES["hub"],
    "four_levels": (_deep, {}),
}
LEVELS = {"one_level": 1, "two_levels": 2, "three_levels": 3, "four_levels": 4}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("matrix", sorted(LEVEL_MATRICES))
def test_level_launch_model_matches_jax(matrix, name):
    """Matrices of 1, 2, 3 and 4 levels: the kernels' model, with the level
    launch as built, every slab chained in shared memory and every slab
    through the work buffer, against the plain dp and JAX's dp_sell (its
    Pallas kernels in interpret mode): bit for bit."""
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j, kw = _coos(matrix, sr, LEVEL_MATRICES)
    n, c = coo_t.shape
    built = sell.build_sell(coo_t, sr, device="cpu", **kw)
    assert built.max_levels == LEVELS[matrix]
    x = _x(sr, c, seed=11)
    ref = js.dp_sell(js.build_sell(coo_j, jsr, **kw), jnp.asarray(x), jsr, n_rows=n)
    plain = sell.dp_sell_plain(built, torch.from_numpy(x), sr, n_rows=n)
    _same_bits(plain, ref)
    for path, op in _level_paths(built).items():
        got = _kernel_model(op, sell.pad_x2d(op, torch.from_numpy(x), sr), sr)
        _same_bits(got > 0 if _carrier(sr)[5] else got, ref)


@pytest.mark.parametrize("name", NAMES)
def test_levels_model_on_plain_level0(name):
    """The level launch's model alone, from fused_plain's level-0 rows, on
    a band with three levels in several slabs and on a multislab matrix
    whose launch mixes both paths: the plain dp's bits."""
    sr = get_semiring(name)
    for matrix in ("band_levels", "multislab"):
        coo, _, kw = _coos(matrix, sr, BUILD_MATRICES)
        built = sell.build_sell(coo, sr, device="cpu", **kw)
        x = torch.from_numpy(_x(sr, coo.shape[1], seed=12))
        want = sell.dp_sell_plain(built, x, sr, n_rows=coo.shape[0])
        for path, op in _level_paths(built).items():
            work, dp = sell.fused_plain(op, sell.pad_x2d(op, x, sr), sr)
            sell.levels_plain(op, sr, work, dp)
            assert torch.equal(dp > 0 if _carrier(sr)[5] else dp, want), (matrix, path)


@pytest.mark.parametrize("matrix", ["band_levels", "multislab", "hub", "four_levels"])
def test_chain_table(matrix):
    """One chain row per slab with a later level: its count of later
    levels and their entries in depth order; the shared flag where its idx,
    level-0 and intermediate rows fit the limit (as built, LEVEL_ROWS_MAX;
    and two lower limits, which put some or every slab on the work path),
    and level_rows the most of them;
    a shared slab's intermediates within its rows, each depth reading where
    the one before wrote; every non-final output that stays in the work
    buffer at rows of its own, level 0's first in slab order."""
    make, kw = {**BUILD_MATRICES, **LEVEL_MATRICES}[matrix]
    built = sell.build_sell(make(tf), PLUS_TIMES, device="cpu", **kw)
    _check_chains(built, sell.LEVEL_ROWS_MAX)
    for limit in (500, 0):
        _check_chains(sell.relevel(built, limit), limit)


def _check_chains(op, limit):
    t = op.table.numpy()
    entry = {key: e for e, key in enumerate(
        (si, li) for li in range(op.max_levels) for si, lay in enumerate(op.layouts)
        if li < len(lay.levels))}
    chained = [si for si, lay in enumerate(op.layouts) if len(lay.levels) > 1]
    chains = op.chains.numpy()
    assert chains.shape == (len(chained), sell.CHAIN_WORDS)
    level0 = [(int(t[entry[si, 0], 5]), lay.levels[0].d_out) for si, lay in enumerate(op.layouts)
              if not lay.levels[0].final]
    assert [r[0] for r in level0] == list(np.cumsum([0] + [r[1] for r in level0])[:-1])
    most = 0
    work = list(level0)
    for c, si in zip(chains, chained):
        lay = op.layouts[si]
        later = len(lay.levels) - 1
        need = sum(sell.chain_rows(lay))
        assert c[0] == later and c[1] == int(need <= limit)
        assert list(c[2:2 + later]) == [entry[si, li] for li in range(1, later + 1)]
        assert not c[2 + later:].any()
        inter = 0
        for li in range(1, later + 1):
            e = t[entry[si, li]]
            assert e[2] == t[entry[si, li - 1], 5] and e[3] == lay.levels[li - 1].d_out
            if lay.levels[li].final:
                assert e[5] == lay.row0 // 128
            elif c[1]:
                assert e[5] == inter
                inter += lay.levels[li].d_out
            else:
                work.append((int(e[5]), lay.levels[li].d_out))
        assert inter == (sell.chain_rows(lay)[1] - lay.levels[0].d_out if c[1] else 0)
        if c[1]:
            most = max(most, need)
    assert op.level_rows == most
    assert sorted(work)[:len(level0)] == level0
    work.sort()
    assert [w[0] for w in work] == list(np.cumsum([0] + [w[1] for w in work])[:-1])
    assert sum(w[1] for w in work) == op.work_rows


def test_relevel_keeps_the_fused_launch():
    """A new shared-memory limit moves only the later levels' rows: level
    0's entries and the fused launch's blocks stay; a limit past the
    level kernel's shared memory is refused."""
    op = sell.build_sell(MATRICES["multislab"][0](tf), PLUS_TIMES, slab_nnz=8000,
                         device="cpu")
    for limit in (0, sell.LEVEL_ROWS_MAX):
        other = sell.relevel(op, limit)
        assert torch.equal(other.groups, op.groups) and other.stage_rows == op.stage_rows
        n = len(op.layouts)
        assert torch.equal(other.table[:n], op.table[:n])
        assert other.chains[:, 1].tolist() == [int(limit > 0)] * other.chains.shape[0]
    with pytest.raises(ValueError):
        sell.relevel(op, sell.LEVEL_ROWS_MAX + 1)


def test_variant_bytes_is_the_hand_sum():
    """Every slab array once, x once and the output once; the flat tensors
    are views of the slabs' and the table is not counted."""
    op = sell.build_sell(MATRICES["hub"][0](tf), PLUS_TIMES, device="cpu")
    hand = sum(t.numel() * t.element_size() for s in op.slabs for t in s.values())
    flat = sum(t.numel() * t.element_size() for t in (op.lanesel, op.vals, op.blocksel, op.idx))
    assert hand == flat
    assert variant_bytes("sell", op, 600 * 4, 600 * 4) == hand + 600 * 8


def test_kernel_wrapper_refuses_cpu_tensors():
    sr = get_semiring("min_plus")
    coo = MATRICES["hub"][0](tf)
    op = sell.build_sell(coo, sr, device="cpu")
    before = dict(LAUNCHES)
    with pytest.raises(ValueError):
        sell.sell_dp_cuda(op, sell.pad_x2d(op, torch.zeros(coo.shape[1]), sr), sr)
    assert LAUNCHES == before


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "or_and", "max_right"])
def test_spmv_matches_jax(name):
    """spmv with variant="sell" (dp, then the fold) against JAX's, and the
    gold gate: exact but for plus_times, held within 1e-4 of the gold."""
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j, _ = _coos("power_law", sr)
    n, c = coo_t.shape
    x = _x(sr, c, seed=1)
    op = build_operand(coo_t, sr, "sell", device="cpu")
    port = spmv(op, torch.from_numpy(x), sr=sr, variant="sell", n_rows=n)
    jop = jax_build_operand(coo_j, jsr, "sell")
    ref = jax_spmv(jop, jnp.asarray(x), None, sr=jsr, variant="sell", n_rows=n)
    _same_bits(port, ref)
    gold = spmv_gold(coo_t, x, np.full(n, sr.zero, sr.np_dtype), sr)
    assert check_result(port.numpy(), gold, delta=1e-4,
                        exact=name != "plus_times") is Correctness.CORRECT


@pytest.mark.parametrize("app", ["sssp", "bfs"])
def test_fixpoints_with_sell_match_jax(app):
    make = lambda m: m.random_graph_coo(200, 3.0, seed=1)  # noqa: E731
    port = getattr(ta, app)(make(tf), 0, variant="sell", device="cpu")
    ref = getattr(ja, app)(make(jf), 0, variant="sell")
    assert (port.iterations, port.converged) == (int(ref.iterations), bool(ref.converged))
    np.testing.assert_array_equal(port.x.numpy(), np.asarray(ref.x))
    if app == "bfs":
        np.testing.assert_array_equal(port.aux.numpy(), np.asarray(ref.aux))


def test_sell_is_not_in_auto():
    from sparseharness_tpu_torch.ops import AUTO_CHAIN, VARIANTS

    assert "sell" in VARIANTS and "sell" not in AUTO_CHAIN
