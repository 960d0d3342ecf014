"""The port's sell variant against the JAX package's (ops/pallas_sell), on
the matrices of tests/test_sell_frontier.py and the gate's matrix.

The port's build_sell must reproduce the JAX build's arrays and layouts
exactly and refuse what it refuses. The plain dp, on the port-built operand
and on the JAX-built one carried over by interop, must equal JAX's dp_sell
(its Pallas kernels in interpret mode) bit for bit for all seven
semirings, plus_times included: both fold in the layout's fixed order. The
CUDA kernels cannot run here, so their launch table is held by a torch
model of what csrc/sell.cu computes from it, which must give the plain
version's bits.
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
    depth-0 launch (_fused_model), then per later depth, for each output
    row (block), its entry by binary search on row_begin, its region, the
    left-to-right ⊕ of its w gathered rows, written to the work buffer or
    (final) the dp."""
    carrier, add, mul, _, zero, _ = _carrier(sr)
    work = torch.full((op.work_rows, 128), 7, dtype=carrier)  # stale values must not leak
    dp = torch.full((op.n_pad // 128, 128), 7, dtype=carrier)
    _fused_model(op, x2d, sr, work, dp)
    t = op.table.long()
    flat_idx = op.idx.long()
    lane = torch.arange(128)
    for d in range(1, len(op.depth_rows)):
        rows = op.depth_rows[d]
        e0, e1 = op.depth_entries[d], op.depth_entries[d + 1]
        b = torch.arange(rows)
        e = e0 + torch.searchsorted(t[e0:e1, 0].contiguous(), b, right=True) - 1
        r = b - t[e, 0]
        reg = t[e, 8:24].view(-1, 4, 4)
        k = ((r[:, None] >= reg[:, :, 3]) & (torch.arange(4) < t[e, 7:8] - 1)).sum(1)
        w, s0, oc0 = (reg[torch.arange(rows), k, f] for f in range(3))
        base = t[e, 4] + s0 + (r - oc0) * w

        def gather(step):
            ix = flat_idx[(base + step).clamp(max=flat_idx.shape[0] - 1)]   # (rows, 128)
            src = work[(t[e, 2][:, None] + ix).clamp(max=op.work_rows - 1), lane]
            return torch.where(ix < t[e, 3][:, None], src, torch.full_like(src, zero))

        acc = gather(0)
        for step in range(1, int(w.max())):
            acc = torch.where((step < w)[:, None], add(acc, gather(step)), acc)
        final = t[e, 6] == 1
        dp[t[e, 5][final] + r[final]] = acc[final]
        work[t[e, 5][~final] + r[~final]] = acc[~final]
    return dp.reshape(-1)


@pytest.mark.parametrize("stage_rows", [sell.STAGE_ROWS, 0], ids=["staged", "in_place"])
@pytest.mark.parametrize("matrix", ["hub", "multislab", "empty_dups", "power_law"])
def test_kernel_model_equals_plain(matrix, stage_rows):
    """The launch tables drive the kernels' arithmetic to the plain
    version's bits, for every semiring, with the fused launch's blocks
    staged where they may be and with every block gathering in place."""
    for name in NAMES:
        sr = get_semiring(name)
        coo, _, kw = _coos(matrix, sr)
        op = sell.regroup(sell.build_sell(coo, sr, device="cpu", **kw), stage_rows=stage_rows)
        x = torch.from_numpy(_x(sr, coo.shape[1], seed=6))
        want = sell.dp_sell_plain(op, x, sr, n_rows=coo.shape[0])
        got = _kernel_model(op, sell.pad_x2d(op, x, sr), sr)
        if _carrier(sr)[5]:
            got = got > 0
        assert got.dtype == want.dtype and torch.equal(got, want), name


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


def test_launch_table_shape():
    """One entry per (slab, level), depth by depth; each depth's rows are
    the sum of its entries' output rows; the work buffer holds only the
    non-final levels' outputs (no contrib stream), and a level-0 entry's
    source is its slab's phase-A stream."""
    op = sell.build_sell(MATRICES["multislab"][0](tf), PLUS_TIMES, slab_nnz=8000,
                         device="cpu")
    n_levels = [len(lay.levels) for lay in op.layouts]
    assert op.table.shape == (sum(n_levels), sell.ENTRY_WORDS)
    assert len(op.depth_rows) == op.max_levels == max(n_levels)
    for d, rows in enumerate(op.depth_rows):
        assert rows == sum(lay.levels[d].d_out for lay in op.layouts if d < len(lay.levels))
    inner = sum(lv.d_out for lay in op.layouts for lv in lay.levels if not lv.final)
    assert op.work_rows == inner
    a_off = np.cumsum([0] + [lay.t_a for lay in op.layouts])[:-1]
    assert op.table[:len(op.layouts), 2].tolist() == a_off.tolist()
    assert op.table[:len(op.layouts), 3].tolist() == [lay.t_a for lay in op.layouts]
    assert op.idx.shape[0] == sum(lv.t_src for lay in op.layouts for lv in lay.levels)


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
