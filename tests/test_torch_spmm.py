"""The port's semiring SpMM and multi-source apps against the JAX package on
the same seeded inputs: ``spmm`` (band kernel, tile kernel, column map),
``spmm_band`` and ``spmm_bsr_ell`` with their operand views, the 2-D α/β
fold, and ``multi_sssp`` / ``multi_bfs``. The JAX package's Pallas kernels
run in interpret mode on the CPU.

Match: bit for bit for the six min/max/or semirings; plus_times (f32 and
bf16 strips) within 1e-5 · max(1, |ref|, Σ|a·x|), since the sums run in
another order. The multi-source apps must equal JAX on x, aux, iterations
and converged, bit for bit. Every case mirrors one of tests/test_spmm.py
(marked) or covers what the port adds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparseharness_tpu.algorithms as ja
import sparseharness_tpu.formats as jf
import sparseharness_tpu.ops as jops
import sparseharness_tpu.semiring as jsr
from sparseharness_tpu.ops import spmm_tiles as jtiles
from sparseharness_tpu.ops.pallas_bsr_band import spmm_band as jax_spmm_band
import sparseharness_tpu_torch.algorithms as ta
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.gold import spmv_gold
from sparseharness_tpu_torch.ops import (
    Geometry, build_operand, fold_dp, spmm, spmm_band, spmm_band_plain, spmm_bsr_ell,
    spmm_bsr_ell_plain,
)
from sparseharness_tpu_torch.ops import bsr_band as tband
from sparseharness_tpu_torch.ops import spmm_tiles as ttiles
from sparseharness_tpu_torch.semiring import MIN_PLUS, REGISTRY, PLUS_TIMES, get_semiring
from sparseharness_tpu_torch.semiring.core import INT_MAX, INT_MIN, _carrier

PT_DELTA = 1e-5


def _x_block(sr, n, m, seed):
    rng = np.random.default_rng(seed)
    if sr.dtype == torch.bool:
        return rng.random((n, m)) < 0.3
    if sr.dtype == torch.int32:
        return rng.integers(0, 100, (n, m)).astype(np.int32)
    return rng.uniform(0.1, 1.0, (n, m)).astype(np.float32)


def _abs_bound(coo, X):
    """Σ_j |a_ij|·|x_jc| in float64, per (row, column)."""
    out = np.zeros((coo.shape[0], X.shape[1]))
    np.add.at(out, coo.rows, np.abs(coo.vals.astype(np.float64))[:, None]
              * np.abs(X[coo.cols].astype(np.float64)))
    return out


def _assert_match(sr, got, ref, coo=None, X=None):
    """Bit for bit, or plus_times within PT_DELTA · max(1, |ref|, Σ|a·x|)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if sr.name != "plus_times":
        np.testing.assert_array_equal(got, ref)
        return
    scale = np.maximum(np.maximum(np.abs(ref), _abs_bound(coo, X)), 1.0)
    assert (np.abs(got.astype(np.float64) - ref) <= PT_DELTA * scale).all()


def _both(sr_name, coo_make, variant, X, geometry=None, n_rows=None, **kw):
    """(port, JAX) spmm of the same matrix and X."""
    tsr, jsr_ = get_semiring(sr_name), jsr.get_semiring(sr_name)
    tcoo, jcoo = coo_make(tf), coo_make(jf)
    g = geometry or Geometry()
    n = n_rows if n_rows is not None else tcoo.shape[0]
    top = build_operand(tcoo, tsr, variant, g, device="cpu")
    jop = jops.build_operand(jcoo, jsr_, variant, jops.Geometry(g.block_m, g.block_n,
                                                                 g.value_dtype))
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got = spmm(top, torch.from_numpy(X), sr=tsr, variant=variant, n_rows=n, **tkw)
    ref = jops.spmm(jop, jnp.asarray(X), sr=jsr_, variant=variant, n_rows=n, **jkw)
    return got.numpy(), np.asarray(ref), tcoo


# ------------------------------------------------------ the band kernel


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_spmm_band_matches_jax(value_dtype):
    """test_spmm.py::test_spmm_band_mxu_matches_gold, against JAX and the gold."""
    X = _x_block(PLUS_TIMES, 1024, 40, seed=0)
    got, ref, coo = _both("plus_times", lambda m: m.banded_coo(1024, 7, seed=1),
                          "bsr_band", X, Geometry(8, 128, value_dtype))
    _assert_match(PLUS_TIMES, got, ref, coo, X)
    if value_dtype == "float32":
        gold = np.stack([spmv_gold(coo, X[:, j], np.zeros(1024, np.float32), PLUS_TIMES)
                         for j in range(40)], axis=1)
        np.testing.assert_allclose(got, gold, rtol=1e-4, atol=1e-4)


def test_spmm_band_wide_rhs_tiles():
    """test_spmm.py::test_spmm_band_wide_rhs_tiles: m = 200 spans more than
    one column tile."""
    X = _x_block(PLUS_TIMES, 600, 200, seed=2)
    got, ref, coo = _both("plus_times", lambda m: m.banded_coo(600, 4, seed=3),
                          "bsr_band", X)
    _assert_match(PLUS_TIMES, got, ref, coo, X)


@pytest.mark.parametrize("m", [1, 5])
def test_spmm_band_plain_equals_jax_kernel(m):
    """spmm_band (plain on the CPU) against JAX's spmm_band called directly,
    on operands that both packages build alike."""
    coo_t, coo_j = tf.banded_coo(400, 30, seed=7), jf.banded_coo(400, 30, seed=7)
    X = _x_block(PLUS_TIMES, 400, m, seed=8)
    top = build_operand(coo_t, PLUS_TIMES, "bsr_band", device="cpu")
    jop = jops.build_operand(coo_j, jsr.PLUS_TIMES, "bsr_band")
    got = spmm_band(top, torch.from_numpy(X), n_rows=400)
    np.testing.assert_array_equal(
        got.numpy(), spmm_band_plain(top, torch.from_numpy(X), n_rows=400).numpy())
    ref = np.asarray(jax_spmm_band(jop, jnp.asarray(X), n_rows=400))
    _assert_match(PLUS_TIMES, got.numpy(), ref, coo_t, X)


# ------------------------------------- the band kernel's span arithmetic

#: (n, band, seed, strip type, m): a band at K = 3; a window wider than the
#: matrix (K = 1, 128 lanes over 96 columns); bf16 strips
SPAN_CASES = [(400, 30, 7, "float32", 5), (96, 40, 53, "float32", 3),
              (1024, 7, 1, "bfloat16", 6)]


def _skipped_x_rows(op, n_cols):
    """The X rows (below n_cols) that some 16-row tile's window holds
    outside the tile's union of spans: there only pads of the tile's rows
    meet X."""
    r_rows, bm, kbn = op.strips.shape
    bn = kbn // op.k_win
    table = op.spans.table.long() * op.spans.chunk_lanes
    empty = table[:, 0] >= table[:, 1]
    lo = torch.where(empty, kbn, table[:, 0]).view(-1, 16).amin(dim=1)
    hi = torch.where(empty, 0, table[:, 1]).view(-1, 16).amax(dim=1)
    group = torch.arange(lo.numel()) * 16 // bn
    c_blocks = max(-(-n_cols // bn), op.k_win)
    base = (group + op.c0).clamp(0, c_blocks - op.k_win) * bn
    lane = torch.arange(kbn)
    outside = (lane < lo[:, None]) | (lane >= hi[:, None])
    rows = (base[:, None] + lane)[outside]
    return torch.unique(rows[rows < n_cols]).numpy()


def _band_x(n_cols, m, seed, skipped=None):
    """X uniform in (−1, 1); with ``skipped`` (X rows), +inf, −inf and NaN in
    six of those rows."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, (n_cols, m)).astype(np.float32)
    if skipped is not None:
        rows = rng.choice(skipped, 6, replace=False)
        X[rows, rng.integers(0, m, 6)] = [np.inf, -np.inf, np.nan] * 2
    return X


def _assert_nonfinite_match(got, ref, bound):
    """NaN where ref has NaN, ±inf equal, and within PT_DELTA · max(1,
    |ref|, Σ|a·x|) wherever Σ|a·x| (``bound``) is finite."""
    got, ref, bound = (np.asarray(a, np.float64) for a in (got, ref, bound))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    inf = np.isinf(ref)
    np.testing.assert_array_equal(got[inf], ref[inf])
    fin = np.isfinite(bound)
    scale = np.maximum(np.maximum(np.abs(ref[fin]), bound[fin]), 1.0)
    assert (np.abs(got[fin] - ref[fin]) <= PT_DELTA * scale).all()


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("n,band,seed,value_dtype,m", SPAN_CASES)
def test_band_spmm_spans_plain_matches_plain_and_jax(n, band, seed, value_dtype, m,
                                                      nonfinite):
    """band_spmm_spans_plain (each 16-row tile sums only its union of spans,
    NaN where a skipped pad meets a non-finite X value) against
    band_spmm_plain and JAX's spmm_band in interpret mode (every slot):
    with non-finite X placed in rows some tile skips, NaN and ±inf in the
    same places, the rest within the tolerance."""
    top = build_operand(tf.banded_coo(n, band, seed=seed), PLUS_TIMES, "bsr_band",
                        Geometry(8, 128, value_dtype), device="cpu")
    jop = jops.build_operand(jf.banded_coo(n, band, seed=seed), jsr.PLUS_TIMES, "bsr_band",
                             jops.Geometry(8, 128, value_dtype))
    skipped = _skipped_x_rows(top, n)
    assert len(skipped) >= 6  # the spans leave pads that the kernel skips
    X = _band_x(n, m, seed + 1, skipped if nonfinite else None)
    x2d = tband.pad_x_block(top, torch.from_numpy(X))
    args = dict(c0=top.c0, k_win=top.k_win)
    got = tband.band_spmm_spans_plain(top.strips, x2d, top.spans, **args)[:n]
    ref = tband.band_spmm_plain(top.strips, x2d, **args)[:n]
    bound = tband.band_spmm_plain(top.strips.abs(), x2d.abs(), **args)[:n]
    _assert_nonfinite_match(got.numpy(), ref.numpy(), bound.numpy())
    jax_ref = np.asarray(jax_spmm_band(jop, jnp.asarray(X), n_rows=n))
    _assert_nonfinite_match(got.numpy(), jax_ref, bound.numpy())
    if nonfinite:
        assert np.isnan(ref.numpy()).any()
    else:
        assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_band_spmm_cuda_refuses_operand_spans(value_dtype):
    """band_spmm_cuda refuses, before it looks for the card, an operand
    without a span table, a table made for other strips, and one made under
    another semiring's pad (min_plus: FLT_MAX, in bf16 +inf); an operand
    with its own plus_times table passes those checks and stops at the
    device check here."""
    op = build_operand(tf.banded_coo(300, 9, seed=3), PLUS_TIMES, "bsr_band",
                       Geometry(8, 128, value_dtype), device="cpu")
    x2d = tband.pad_x_block(op, torch.ones(300, 4))
    args = dict(c0=op.c0, k_win=op.k_win)
    with pytest.raises(ValueError, match="no span table"):
        tband.band_spmm_cuda(op.strips, x2d, spans=None, **args)
    with pytest.raises(ValueError, match="other strips"):
        tband.band_spmm_cuda(op.strips.clone(), x2d, spans=op.spans, **args)
    with pytest.raises(ValueError, match="pad"):
        tband.band_spmm_cuda(op.strips, x2d, spans=tband.band_spans(op.strips, MIN_PLUS),
                             **args)
    with pytest.raises(ValueError, match="CUDA device"):
        tband.band_spmm_cuda(op.strips, x2d, spans=op.spans, **args)
    with pytest.raises(ValueError, match="CUDA device"):
        tband.band_spmm_cuda(op.strips, x2d, spans=tband.with_spans(op, PLUS_TIMES).spans,
                             **args)


# ------------------------------------------------------ the tile kernel


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_spmm_tile_kernel_all_semirings(name):
    """test_spmm.py::test_spmm_tile_kernel_all_semirings, for all seven
    semirings, on both strip operands, against JAX bit for bit (plus_times
    within the tolerance)."""
    sr = get_semiring(name)
    X = _x_block(sr, 257, 5, seed=4)
    for variant in ("bsr_ell", "bsr_fused"):
        got, ref, coo = _both(name, lambda m: m.random_coo(300, 257, 2500, seed=3),
                              variant, X)
        _assert_match(sr, got, ref, coo, X)


def test_spmm_tile_kernel_chunked_k():
    """test_spmm.py::test_spmm_tile_kernel_chunked_k: K > 8 slots, which the
    TPU kernel splits into chunks; the port runs them in one pass."""
    sr = get_semiring("min_plus")
    X = _x_block(sr, 4096, 3, seed=6)
    op = build_operand(tf.random_coo(64, 4096, 6000, seed=5), sr, "bsr_ell", device="cpu")
    assert op.tile_cols.shape[1] > 8  # the point of the test
    got, ref, _ = _both("min_plus", lambda m: m.random_coo(64, 4096, 6000, seed=5),
                        "bsr_ell", X)
    _assert_match(sr, got, ref)


def test_spmm_tile_kernel_alpha_beta_fold():
    """test_spmm.py::test_spmm_tile_kernel_alpha_beta_fold: the fold over
    (n, m) blocks."""
    rng = np.random.default_rng(8)
    X = rng.uniform(0.1, 1.0, (100, 4)).astype(np.float32)
    Y0 = rng.uniform(0.1, 1.0, (100, 4)).astype(np.float32)
    got, ref, coo = _both("plus_times", lambda m: m.random_coo(100, 100, 700, seed=7),
                          "bsr_ell", X, alpha=2.0, beta=0.5, y_block=Y0)
    _assert_match(PLUS_TIMES, got, ref, coo, 2.0 * X)
    base = np.stack([spmv_gold(coo, X[:, j], np.zeros(100, np.float32), PLUS_TIMES)
                     for j in range(4)], axis=1)
    np.testing.assert_allclose(got, 2.0 * base + 0.5 * Y0, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["min_plus", "max_right", "plus_times"])
def test_fold_dp_broadcasts_over_2d(name):
    """fold_dp over an (n, m) dp equals fold_dp of each column, and JAX's
    fold_dp of the same block."""
    from sparseharness_tpu.ops.jnp_ops import fold_dp as jax_fold_dp

    sr, jsr_ = get_semiring(name), jsr.get_semiring(name)
    rng = np.random.default_rng(30)
    dp = _x_block(sr, 50, 6, seed=31)
    if sr.dtype == torch.float32:
        dp[rng.random(dp.shape) < 0.2] = np.inf  # overflowed pads, clamped by the fold
    y = _x_block(sr, 50, 6, seed=32)
    alpha, beta = (2.0, 0.5) if name == "plus_times" else (sr.one, sr.one)
    got = fold_dp(torch.from_numpy(dp), torch.from_numpy(y), sr, alpha, beta)
    for j in range(6):
        col = fold_dp(torch.from_numpy(dp[:, j].copy()), torch.from_numpy(y[:, j].copy()),
                      sr, alpha, beta)
        np.testing.assert_array_equal(got[:, j].numpy(), col.numpy())
    ref = jax_fold_dp(jnp.asarray(dp), jnp.asarray(y), jsr_, alpha, beta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("srname", ["min_plus", "or_and", "max_min"])
def test_spmm_band_operand_non_plus_times(srname):
    """test_spmm.py::test_spmm_band_operand_non_plus_times: band operands
    take the tile kernel through their explicit affine columns."""
    sr = get_semiring(srname)

    def make(pkg):
        coo = pkg.banded_coo(300, 5, seed=51)
        if sr.dtype == torch.bool:
            return coo.with_values((coo.vals != 0).astype(np.bool_))
        return coo.with_values(np.abs(coo.vals).astype(np.float32) + 0.1)

    X = _x_block(sr, 300, 9, seed=52)
    got, ref, coo = _both(srname, make, "bsr_band", X)
    _assert_match(sr, got, ref)
    gold = np.stack([spmv_gold(coo, X[:, j], np.full(300, sr.zero, sr.np_dtype), sr)
                     for j in range(9)], axis=1)
    np.testing.assert_array_equal(got, gold)


def test_spmm_band_edge_window_wider_than_matrix():
    """test_spmm.py::test_spmm_band_edge_window_wider_than_matrix: clipped
    tile columns stay in range and the pads vanish under the reduction."""
    sr = get_semiring("min_plus")

    def make(pkg):
        coo = pkg.banded_coo(96, 40, seed=53)
        return coo.with_values(np.abs(coo.vals).astype(np.float32) + 0.1)

    X = _x_block(sr, 96, 3, seed=54)
    got, ref, _ = _both("min_plus", make, "bsr_band", X)
    _assert_match(sr, got, ref)


def test_spmm_band_with_fold_takes_the_tile_kernel():
    """plus_times on a band operand with an α/β fold leaves spmm_band for the
    tile kernel and the fold, as in JAX."""
    rng = np.random.default_rng(40)
    X = rng.uniform(0.1, 1.0, (500, 7)).astype(np.float32)
    Y0 = rng.uniform(0.1, 1.0, (500, 7)).astype(np.float32)
    got, ref, coo = _both("plus_times", lambda m: m.banded_coo(500, 9, seed=41),
                          "bsr_band", X, alpha=1.0, beta=2.0, y_block=Y0)
    _assert_match(PLUS_TIMES, got, ref, coo, X)


@pytest.mark.parametrize("m", [1, 40, 200])
@pytest.mark.parametrize("name", ["plus_times", "or_and", "min_right"])
def test_spmm_bsr_ell_plain_equals_jax_kernel(name, m):
    """spmm_bsr_ell (plain on the CPU) against JAX's spmm_bsr_ell called
    directly: column tails, and bf16 strips for plus_times. min_right reads
    the blocked builders' INT_MIN pad tiles as they are."""
    sr, jsr_ = get_semiring(name), jsr.get_semiring(name)
    vd = "bfloat16" if name == "plus_times" else "float32"
    coo_t, coo_j = tf.random_coo(90, 300, 700, seed=11), jf.random_coo(90, 300, 700, seed=11)
    X = _x_block(sr, 300, m, seed=12)
    top = build_operand(coo_t, sr, "bsr_ell", Geometry(8, 128, vd), device="cpu")
    jop = jops.build_operand(coo_j, jsr_, "bsr_ell", jops.Geometry(8, 128, vd))
    got = spmm_bsr_ell(top, torch.from_numpy(X), sr, n_rows=90)
    np.testing.assert_array_equal(
        got.numpy(), spmm_bsr_ell_plain(top, torch.from_numpy(X), sr, n_rows=90).numpy())
    ref = np.asarray(jtiles.spmm_bsr_ell(jop, jnp.asarray(X), jsr_, n_rows=90))
    _assert_match(sr, got.numpy(), ref, coo_t, X)


@pytest.mark.parametrize("n", [2000, 1 << 14])
@pytest.mark.parametrize("name", ["min_plus", "or_and"])
def test_spmm_bsr_ell_plain_on_band_operand_equals_jax_kernel(name, n):
    """The band-routed multi-source solves' operand (the band's explicit
    columns, K = 3) at m = 8: spmm_bsr_ell_plain against JAX's spmm_bsr_ell
    on the JAX band's view, bit for bit."""
    sr, jsr_ = get_semiring(name), jsr.get_semiring(name)
    X = _x_block(sr, n, 8, seed=15)
    top = ttiles.ell_operand_from_band(
        build_operand(tf.banded_coo(n, 63, seed=1), sr, "bsr_band", device="cpu"))
    jop = jtiles.ell_operand_from_band(
        jops.build_operand(jf.banded_coo(n, 63, seed=1), jsr_, "bsr_band"))
    assert top.tile_cols.shape[1] == 3
    got = spmm_bsr_ell_plain(top, torch.from_numpy(X), sr, n_rows=n)
    ref = np.asarray(jtiles.spmm_bsr_ell(jop, jnp.asarray(X), jsr_, n_rows=n))
    _assert_match(sr, got.numpy(), ref)


# ------------------------------------------- the kernel's row map on the CPU

#: the true ⊕ identity each partial of the kernels starts from (semiring.cuh)
IDENTITY = {"plus_times": 0.0, "min_plus": float("inf"), "or_and": INT_MIN,
            "max_min": float("-inf"), "max_times": float("-inf"), "max_right": INT_MIN,
            "min_right": INT_MAX}
#: lanes a group of the row map: the kernel's 8 (m ≤ 8), 4 (m ≤ 64) and 2
#: (above), and 1, which scripts/probe_spmm_wide_cuda.py also times
ROW_SPLITS = [1, 2, 4, 8]
#: rows and columns a thread of the row map (kNarrowRows, kNarrowC)
ROW_TILE = 8


def _row_map_threads(n_rows, m, split, threads=256):
    """spmm_rows_kernel's thread map (csrc/spmm_tiles.cu) over every block:
    each thread's first row, first column, lane and liveness."""
    group_threads = m // ROW_TILE * split
    groups_per_block = threads // group_threads
    n_blocks = -(-(n_rows // ROW_TILE) // groups_per_block)
    t = torch.arange(n_blocks * threads)
    local = t % threads // group_threads
    within = t % threads - local * group_threads
    row0 = (t // threads * groups_per_block + local) * ROW_TILE
    live = (local < groups_per_block) & (row0 < n_rows)
    return row0, within // split * ROW_TILE, within % split, live


def _row_map_model(tiles, tile_cols, x2d, sr, split):
    """The row map's dp in torch: lane s of a group ⊕-accumulates, in order,
    the slots of its 4-slot chunks (chunk q of tile k when q % split == s),
    from the true ⊕ identity; then the group folds its partials with xor
    steps 1, 2, 4, ... as the shuffles do. How many rows and columns a
    thread takes does not change a single value."""
    carrier, add, mul, *_ = _carrier(sr)
    r_blocks, bm, kbn = tiles.shape
    k = tile_cols.shape[1]
    bn = kbn // k
    m = x2d.shape[1]
    st = tiles.float() if tiles.dtype == torch.bfloat16 else tiles
    st = st.reshape(r_blocks * bm, kbn)
    cols = tile_cols.long().clamp(0, x2d.shape[0] // bn - 1)
    block_row = torch.arange(r_blocks * bm) // bm
    parts = []
    for s in range(split):
        acc = torch.full((r_blocks * bm, m), IDENTITY[sr.name], dtype=carrier)
        for slot in range(kbn):
            kk, l = divmod(slot, bn)
            if l // 4 % split != s:
                continue
            xv = x2d[cols[block_row, kk] * bn + l]  # (rows, m)
            acc = add(acc, mul(xv, st[:, slot:slot + 1]))
        parts.append(acc)
    d = 1
    while d < split:
        parts = [add(parts[s], parts[s ^ d]) for s in range(split)]
        d *= 2
    return parts[0]


@pytest.mark.parametrize("split", ROW_SPLITS)
@pytest.mark.parametrize("m", [8, 16, 24, 32, 40, 48, 56, 64, 72, 128, 136, 256])
@pytest.mark.parametrize("bm", [8, 16, 24, 72])
def test_row_map_writes_each_output_once(bm, m, split):
    """Every output of the padded dp has exactly one writer (lane 0 of its
    group), every thread but a block's remainder owns outputs, a thread's
    rows lie in one block-row, and a group's lanes are adjacent and
    aligned in their warp (the xor shuffles' reach)."""
    group_threads = m // ROW_TILE * split
    rows_per_block = 256 // group_threads * ROW_TILE
    n_rows = (2 * rows_per_block // bm + 3) * bm  # three blocks or more
    row0, col, lane, live = _row_map_threads(n_rows, m, split)
    assert bool((row0[live] // bm == (row0[live] + ROW_TILE - 1) // bm).all())
    writes = torch.zeros((n_rows, m), dtype=torch.int64)
    writer = live & (lane == 0)
    ones = torch.ones(int(writer.sum()), dtype=torch.int64)
    for i in range(ROW_TILE):
        for j in range(ROW_TILE):
            writes.index_put_((row0[writer] + i, col[writer] + j), ones, accumulate=True)
    assert bool((writes == 1).all())
    idle = (~live).view(-1, 256).sum(1)
    assert int(idle[:-1].max()) < group_threads  # only the remainder
    t = torch.arange(row0.numel())
    group = t - lane
    assert bool((group % split == 0).all()) and bool((group // 32 == t // 32).all())


@pytest.mark.parametrize("split", ROW_SPLITS)
@pytest.mark.parametrize("name,value_dtype", [
    (n, vd) for n in sorted(REGISTRY) for vd in ("float32", "bfloat16")
    if vd == "float32" or get_semiring(n).dtype == torch.float32])
def test_row_map_model_matches_plain(name, value_dtype, split):
    """The row map's order of ⊕ and fold gives the plain version's dp: bit
    for bit for the six min/max/or semirings, plus_times within the
    tolerance, f32 and bf16 strips; on the band's explicit columns (K = 3,
    bn = 128) at m = 8 and on 16 × 64 tiles at m = 16 and 136 with columns
    outside X's blocks."""
    sr = get_semiring(name)
    band = ttiles.ell_operand_from_band(
        build_operand(tf.banded_coo(300, 63, seed=1), sr, "bsr_band",
                      Geometry(8, 128, value_dtype), device="cpu"))
    ell = build_operand(tf.random_coo(60, 300, 500, seed=16), sr, "bsr_ell",
                        Geometry(16, 64, value_dtype), device="cpu")
    cols = ell.tile_cols.clone()
    cols[::2, 0] = -3
    cols[1::2, -1] = 99
    ell = ell._replace(tile_cols=cols)
    for op, n_cols, m in ((band, 300, 8), (ell, 300, 16), (ell, 300, 136)):
        bn = op.tiles.shape[2] // op.tile_cols.shape[1]
        X = torch.from_numpy(_x_block(sr, n_cols, m, seed=17))
        x2d = ttiles.pad_x_block(X, bn, sr)
        got = _row_map_model(op.tiles, op.tile_cols, x2d, sr, split)
        ref = ttiles.spmm_tiles_plain(op.tiles, op.tile_cols, x2d, sr)
        if name == "plus_times":
            bound = ttiles.spmm_tiles_plain(op.tiles.abs(), op.tile_cols, x2d.abs(), PLUS_TIMES)
            tol = PT_DELTA * torch.clamp(torch.maximum(ref.abs(), bound), min=1.0)
            assert bool(((got - ref).abs() <= tol).all())
        else:
            assert torch.equal(got, ref)


def test_spmm_plain_chunks_agree(monkeypatch):
    """The plain versions give the same bits whatever their chunk size."""
    sr = get_semiring("min_plus")
    coo = tf.banded_coo(700, 20, seed=13)
    X = torch.from_numpy(_x_block(sr, 700, 6, seed=14))
    band = build_operand(coo, PLUS_TIMES, "bsr_band", device="cpu")
    ell = build_operand(coo, sr, "bsr_ell", device="cpu")
    whole = (spmm_band_plain(band, X, n_rows=700), spmm_bsr_ell_plain(ell, X, sr, n_rows=700))
    from sparseharness_tpu_torch.ops import bsr

    monkeypatch.setattr(bsr, "PLAIN_CHUNK_BYTES", 1)
    np.testing.assert_array_equal(spmm_band_plain(band, X, n_rows=700).numpy(),
                                  whole[0].numpy())
    np.testing.assert_array_equal(spmm_bsr_ell_plain(ell, X, sr, n_rows=700).numpy(),
                                  whole[1].numpy())


# --------------------------------------------------- the operand views


@pytest.mark.parametrize("n,band", [(300, 5), (96, 40), (3000, 130)])
def test_ell_operand_from_band_equals_jax(n, band):
    top = build_operand(tf.banded_coo(n, band, seed=3), PLUS_TIMES, "bsr_band", device="cpu")
    jop = jops.build_operand(jf.banded_coo(n, band, seed=3), jsr.PLUS_TIMES, "bsr_band")
    got = ttiles.ell_operand_from_band(top)
    ref = jtiles.ell_operand_from_band(jop)
    assert got.tile_cols.dtype == torch.int32
    np.testing.assert_array_equal(got.tile_cols.numpy(), np.asarray(ref.tile_cols))
    np.testing.assert_array_equal(got.tiles.numpy(), np.asarray(ref.tiles))


def test_ell_operand_from_fused_equals_jax():
    """One row of 66 tiles: K = 66, so the 75 block-rows take two slabs."""
    args = (np.zeros(600, np.int32), np.arange(0, 600 * 14, 14, dtype=np.int32),
            np.linspace(0.1, 1.0, 600).astype(np.float32), (600, 8400))
    coo_t, coo_j = tf.coo_from_arrays(*args), jf.coo_from_arrays(*args)
    top = build_operand(coo_t, PLUS_TIMES, "bsr_fused", device="cpu")
    jop = jops.build_operand(coo_j, jsr.PLUS_TIMES, "bsr_fused")
    assert top.strips.shape[0] > 1  # more than one slab
    got = ttiles.ell_operand_from_fused(top)
    ref = jtiles.ell_operand_from_fused(jop)
    np.testing.assert_array_equal(got.tile_cols.numpy(), np.asarray(ref.tile_cols))
    np.testing.assert_array_equal(got.tiles.numpy(), np.asarray(ref.tiles))


# ----------------------------------------------------- the column map


@pytest.mark.parametrize("name,variant", [
    ("min_plus", "ell"), ("plus_times", "ell"), ("max_right", "coo_seg"),
    ("min_plus", "coo_seg"), ("or_and", "sell2"), ("plus_times", "sell2"),
])
def test_spmm_column_map_general(name, variant, monkeypatch):
    """test_spmm.py::test_spmm_column_map_general: variants without an SpMM
    kernel map spmv over X's columns, with the fold per column."""
    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "0")
    sr = get_semiring(name)
    m = 3 if variant == "sell2" else 5
    X = _x_block(sr, 160, m, seed=1)
    kw = {}
    if name == "plus_times":
        kw = dict(alpha=2.0, beta=0.5,
                  y_block=np.random.default_rng(3).uniform(0, 1, (200, m)).astype(np.float32))
    got, ref, coo = _both(name, lambda p: p.random_coo(200, 160, 1200, seed=2), variant, X,
                          **kw)
    _assert_match(sr, got, ref, coo, 2.0 * X)


def test_spmm_column_map_fused_plus_times():
    """The other half of test_spmm.py::test_spmm_column_map_general:
    plus_times over bsr_fused (the tile kernel), against the gold."""
    X = _x_block(PLUS_TIMES, 160, 5, seed=1)
    got, ref, coo = _both("plus_times", lambda p: p.random_coo(200, 160, 1200, seed=2),
                          "bsr_fused", X)
    _assert_match(PLUS_TIMES, got, ref, coo, X)
    gold = np.stack([spmv_gold(coo, X[:, j], np.zeros(200, np.float32), PLUS_TIMES)
                     for j in range(5)], axis=1)
    np.testing.assert_allclose(got, gold, rtol=1e-4, atol=1e-4)


# ------------------------------------------------ multi-source solvers


def _assert_same_result(port, ref):
    assert port.iterations == int(ref.iterations)
    assert port.converged == bool(ref.converged)
    x = port.x.numpy()
    assert x.dtype == np.asarray(ref.x).dtype
    np.testing.assert_array_equal(x, np.asarray(ref.x))
    if ref.aux is not None:
        np.testing.assert_array_equal(port.aux.numpy(), np.asarray(ref.aux))


def test_multi_sssp_matches_jax_and_single_source():
    """test_spmm.py::test_multi_sssp_matches_single_source, and JAX."""
    roots = [0, 7, 33]
    port = ta.multi_sssp(tf.random_graph_coo(120, 4.0, seed=9), roots, device="cpu")
    _assert_same_result(port, ja.multi_sssp(jf.random_graph_coo(120, 4.0, seed=9), roots))
    assert port.x.shape == (120, 3)
    for j, r in enumerate(roots):
        single = ta.sssp(tf.random_graph_coo(120, 4.0, seed=9), r, device="cpu")
        np.testing.assert_array_equal(port.x[:, j].numpy(), single.x.numpy())


def test_multi_bfs_matches_jax_and_single_source():
    """test_spmm.py::test_multi_bfs_matches_single_source, and JAX."""
    roots = [1, 50]
    port = ta.multi_bfs(tf.random_graph_coo(120, 3.0, seed=10), roots, device="cpu")
    _assert_same_result(port, ja.multi_bfs(jf.random_graph_coo(120, 3.0, seed=10), roots))
    for j, r in enumerate(roots):
        single = ta.bfs(tf.random_graph_coo(120, 3.0, seed=10), r, device="cpu")
        np.testing.assert_array_equal(port.x[:, j].numpy(), single.x.numpy())
        np.testing.assert_array_equal(port.aux[:, j].numpy(), single.aux.numpy())


def test_multi_sssp_validates_roots():
    """test_spmm.py::test_multi_sssp_validates_roots."""
    coo = tf.random_coo(10, 10, 30, seed=11)
    for app in (ta.multi_sssp, ta.multi_bfs):
        with pytest.raises(ValueError):
            app(coo, [0, 99], device="cpu")
        with pytest.raises(ValueError):
            app(coo, [], device="cpu")


@pytest.mark.parametrize("app", ["multi_sssp", "multi_bfs"])
def test_multi_source_duplicate_roots_and_band_variant(app):
    """Duplicate roots give equal columns; on bsr_band the solve takes the
    tile kernel through the band's explicit columns, as in JAX."""
    roots = [5, 5, 40]
    port = getattr(ta, app)(tf.banded_coo(300, 6, seed=17), roots, variant="bsr_band",
                            device="cpu")
    _assert_same_result(port, getattr(ja, app)(jf.banded_coo(300, 6, seed=17), roots,
                                               variant="bsr_band"))
    np.testing.assert_array_equal(port.x[:, 0].numpy(), port.x[:, 1].numpy())


@pytest.mark.parametrize("app", ["multi_sssp", "multi_bfs"])
def test_multi_source_max_iter_reached(app):
    roots = [0, 90]
    port = getattr(ta, app)(tf.banded_coo(200, 3, seed=18), roots, max_iter=4, device="cpu")
    ref = getattr(ja, app)(jf.banded_coo(200, 3, seed=18), roots, max_iter=4)
    assert port.iterations == 4 and not port.converged
    _assert_same_result(port, ref)


def test_multi_sssp_delta_and_auto():
    """delta > 0 stops early on |Δ| < delta; auto resolves the same variant
    (bsr_fused) in both packages."""
    roots = [3, 100, 2000]
    port = ta.multi_sssp(tf.block_random_coo(4096, 2, seed=5), roots, variant="auto",
                         delta=0.5, device="cpu")
    ref = ja.multi_sssp(jf.block_random_coo(4096, 2, seed=5), roots, variant="auto",
                        delta=0.5)
    _assert_same_result(port, ref)


@pytest.mark.parametrize("app", ["multi_sssp", "multi_bfs"])
def test_multi_source_reorder_rcm(app, monkeypatch):
    """reorder="rcm": the solve runs in permuted space and maps back, equal
    to JAX's and to the direct solve."""
    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "0")

    def make(pkg):
        coo = pkg.banded_coo(150, 2, seed=3)
        scramble = np.random.default_rng(4).permutation(150).astype(np.int32)
        coo = pkg.permute_coo(coo, scramble)
        return coo.with_values(np.abs(coo.vals).astype(np.float32) + 0.1)

    roots = [3, 17]
    port = getattr(ta, app)(make(tf), roots, reorder="rcm", device="cpu")
    _assert_same_result(port, getattr(ja, app)(make(jf), roots, reorder="rcm"))
    direct = getattr(ta, app)(make(tf), roots, device="cpu")
    np.testing.assert_array_equal(port.x.numpy(), direct.x.numpy())


def test_multi_source_return_solver_reruns():
    solve = ta.multi_bfs(tf.random_graph_coo(100, 3.0, seed=19), [0, 4], reorder="rcm",
                         return_solver=True, device="cpu")
    a, b = solve(), solve()
    assert a.iterations == b.iterations > 1
    np.testing.assert_array_equal(a.aux.numpy(), b.aux.numpy())
