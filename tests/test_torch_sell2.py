"""The port's sell2 variant against the JAX package's (ops/pallas_sell2),
on the layout cases of tests/test_sell2.py.

The port's build_sell2 must reproduce the JAX build's arrays exactly (the
JAX side on its NumPy path). The plain dp, on the JAX-built operand carried
over by interop and on the port-built one, must equal JAX's dp_sell2 in
interpret mode: bit for bit for the six min/max/or semirings, plus_times
within 1e-5 · max(1, |dp|, Σ|a·x|). The CUDA kernel cannot run here, so
its plan is held by a torch model of the kernel (each position's entries
taken by its bin's lanes, 4 a chunk, the lanes combined by the XOR
butterfly, pieces folded into their owners in order), which must give the
plain version's bits for the six semirings and plus_times within the same
tolerance, and by the plan's own invariants: every real nonzero once and
no pad, each dp row's entries contiguous, bins by length, every piece
reaching its owner once.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
import sparseharness_tpu.ops.pallas_sell2 as js
from sparseharness_tpu.semiring import get_semiring as jax_semiring
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.gold import Correctness, check_result, spmv_abs_bound, spmv_gold
from sparseharness_tpu_torch.harness import variant_bytes
from sparseharness_tpu_torch.ops import LAUNCHES, Geometry, build_operand, sell2, spmv
from sparseharness_tpu_torch.ops.interop import sell2_operand_from_numpy
from sparseharness_tpu_torch.ops.torch_ops import _SEGMENT_IDENTITY, _SEGMENT_REDUCE
from sparseharness_tpu_torch.semiring import REGISTRY, PLUS_TIMES, get_semiring
from sparseharness_tpu_torch.semiring.core import _carrier

NAMES = sorted(REGISTRY)
PT_DELTA = 1e-5
SLAB_ROWS, CHUNK_COLS = sell2.SLAB_ROWS, sell2.CHUNK_COLS


def _hub_row(m):
    """Row 7 holds 600 entries: more than a panel's 127 per lane, and more
    than SPLIT_T, so it is split into pieces; plus background noise."""
    rng = np.random.default_rng(5)
    hub_cols = rng.choice(4000, 600, replace=False)
    bg = m.random_coo(1200, 4000, 5000, seed=6)
    rows = np.r_[np.full(600, 7), bg.rows]
    cols = np.r_[hub_cols, bg.cols]
    vals = np.r_[rng.uniform(0.1, 1.0, 600).astype(np.float32), bg.vals]
    return m.coo_from_arrays(rows, cols, vals, (1200, 4000))


def _light_chunks(m):
    """60 light chunks × 4 occupied blocks × 16 entries: every chunk's
    segment is sub-panel, so the blocks regroup into virtual chunks."""
    rng = np.random.default_rng(9)
    n = 4096
    ch = np.repeat(np.arange(60), 64)
    bk = np.repeat(np.tile(np.arange(4), 60), 16)
    rows = rng.integers(0, n, ch.size)
    cols = ch * CHUNK_COLS + bk * 128 + rng.integers(0, 128, ch.size)
    vals = rng.uniform(0.1, 1.0, ch.size).astype(np.float32)
    return m.coo_from_arrays(rows, cols, vals, (n, 60 * CHUNK_COLS))


def _single_entries(m):
    n = 2000
    rows = np.arange(n)
    return m.coo_from_arrays(rows, (rows * 37) % n,
                             np.linspace(0.1, 1.0, n).astype(np.float32), (n, n))


# makers taking a formats module: the layout cases of tests/test_sell2.py
MATRICES = {
    "multi_slab": lambda m: m.random_coo(SLAB_ROWS + 3000, 900, 40_000, seed=1),
    "three_chunks": lambda m: m.random_coo(700, 2 * CHUNK_COLS + 5000, 30_000, seed=2),
    "power_law": lambda m: m.power_law_coo(3000, 30_000, alpha=1.5, seed=3),
    "hub_row": _hub_row,
    "duplicates": lambda m: m.coo_from_arrays([0, 0, 0, 5, 5, 300], [3, 3, 3, 9, 9, 250],
                                              [1.0, 2.0, 3.0, 4.0, 5.0, 6.0], (400, 400)),
    "empty_rows": lambda m: m.coo_from_arrays([0, 1, 2], [10, 20, 30], [1.0, 2.0, 3.0],
                                              (5000, 5000)),
    "single_entries": _single_entries,
    "virtual": _light_chunks,
    "pieces": lambda m: m.power_law_coo(20000, 60000, seed=4),
}
# the semirings that shape a build: float values, a FLT_MAX pad, the
# int32 carrier of or_and and an int32 semiring with an INT_MAX pad
BUILD_NAMES = ["plus_times", "min_plus", "or_and", "min_right"]
# dp cases: every semiring on the matrices with the most mechanisms, a
# float sum and a float min on the rest (JAX's dp runs its Pallas kernel
# in interpret mode, about a second a call)
ALL_NAMES_ON = ("hub_row", "pieces")
DP_CASES = [(m, n) for m in sorted(MATRICES)
            for n in (NAMES if m in ALL_NAMES_ON else ["plus_times", "min_plus"])]


@pytest.fixture(autouse=True)
def _numpy_encoder(monkeypatch):
    """The JAX build on its NumPy path, which its native path equals."""
    monkeypatch.setenv("SPARSEHARNESS_TPU_NATIVE", "0")


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


def _np_arr(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _port_arr(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _assert_same_operand(built, jop):
    op = built.panels
    assert op.layouts == jop.layouts
    assert (op.n_chunks, built.n_rows, built.base_pad) == (jop.n_chunks, jop.n_rows,
                                                          jop.base_pad)
    assert len(op.slabs) == len(jop.slabs)
    for slab, jslab in zip(op.slabs, jop.slabs):
        assert (slab is None) == (jslab is None)
        for key in () if slab is None else ("chunk", "wordA", "wordB", "vals"):
            port, ref = _port_arr(slab[key]), _np_arr(jslab[key])
            assert port.dtype == ref.dtype and port.shape == ref.shape, key
            np.testing.assert_array_equal(port, ref, err_msg=key)
    for port, ref in ((op.piece_owner, jop.piece_owner), (op.virt_blocks, jop.virt_blocks)):
        assert (port is None) == (ref is None)
        if port is not None:
            np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def _carry(jop):
    return sell2_operand_from_numpy(
        [None if s is None else {k: np.asarray(v) for k, v in s.items()} for s in jop.slabs],
        jop.layouts, jop.n_chunks, jop.n_rows, jop.base_pad,
        None if jop.piece_owner is None else np.asarray(jop.piece_owner),
        None if jop.virt_blocks is None else np.asarray(jop.virt_blocks), device="cpu")


def _assert_dp_match(name, port, ref, coo, x):
    port, ref = port.numpy(), np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    if name != "plus_times":
        np.testing.assert_array_equal(port, ref)
        return
    n = coo.shape[0]
    scale = np.maximum(np.maximum(1.0, np.abs(ref[:n])), spmv_abs_bound(coo, x))
    assert np.all(np.abs(port[:n] - ref[:n].astype(np.float64)) <= PT_DELTA * scale)
    np.testing.assert_allclose(port[n:], ref[n:], rtol=PT_DELTA, atol=PT_DELTA)


@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("name", BUILD_NAMES)
def test_build_matches_jax(name, matrix):
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j = _coos(MATRICES[matrix], sr)
    _assert_same_operand(sell2.build_sell2(coo_t, sr, device="cpu"),
                         js.build_sell2(coo_j, jsr))


@pytest.mark.parametrize("case", [
    ("power_law", "plus_times", {"value_dtype": "bfloat16"}),
    ("hub_row", "min_plus", {"value_dtype": "bfloat16"}),
    ("virtual", "plus_times", {"virtual_chunks": False}),
    ("pieces", "max_min", {"split_calls": False}),
    ("multi_slab", "or_and", {"split_calls": False}),
], ids=lambda c: f"{c[0]}-{c[1]}-{'-'.join(f'{k}={v}' for k, v in c[2].items())}")
def test_build_options_match_jax(case):
    matrix, name, kw = case
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j = _coos(MATRICES[matrix], sr)
    jop = js.build_sell2(coo_j, jsr, **kw)
    op = sell2.build_sell2(coo_t, sr, device="cpu", **kw)
    _assert_same_operand(op, jop)
    x = _x(sr, coo_t.shape[1], seed=4)
    ref = js.dp_sell2(jop, jnp.asarray(x), jsr, n_rows=coo_t.shape[0])
    if kw.get("value_dtype") == "bfloat16":
        coo_t = coo_t.with_values(torch.from_numpy(coo_t.vals).to(torch.bfloat16).float().numpy())
    _assert_dp_match(name, sell2.dp_sell2_plain(op, torch.from_numpy(x), sr,
                                                n_rows=coo_t.shape[0]), ref, coo_t, x)


@pytest.mark.parametrize("matrix,name", DP_CASES)
def test_plain_dp_matches_jax_kernel(matrix, name):
    """The plain dp (and the routed dp, which takes it on CPU tensors) on
    the carried-over and on the port-built operand, against JAX's dp_sell2
    on its own operand."""
    sr, jsr = get_semiring(name), jax_semiring(name)
    coo_t, coo_j = _coos(MATRICES[matrix], sr)
    jop = js.build_sell2(coo_j, jsr)
    n, c = coo_t.shape
    x = _x(sr, c, seed=14)
    ref = js.dp_sell2(jop, jnp.asarray(x), jsr, n_rows=n)
    built = sell2.build_sell2(coo_t, sr, device="cpu")
    for op in (_carry(jop), built):
        port = sell2.dp_sell2_plain(op, torch.from_numpy(x), sr, n_rows=n)
        _assert_dp_match(name, port, ref, coo_t, x)
        assert torch.equal(sell2.dp_sell2(op, torch.from_numpy(x), sr, n_rows=n), port)


def test_twoshelf_pack_matches_jax():
    """The packer on the _pack_case seeds of tests/test_sell2.py."""
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        cnt = np.zeros((48, 128), np.int64)
        for b in range(40):
            lanes = rng.choice(128, int(rng.integers(1, 30)), replace=False)
            cnt[b, lanes] = rng.integers(1, 8, lanes.size)
        for b in range(40, 48):
            cnt[b, rng.integers(0, 128)] = 1
        port, ref = sell2._twoshelf_pack(cnt), js._twoshelf_pack(cnt)
        assert port[0] == ref[0]
        for a, b in zip(port[1:], ref[1:]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_layout_stats_and_mechanisms():
    """The matrices reach every mechanism of the builder: several slabs,
    bucket layouts sharing a row0, pieces, virtual chunks, both align
    tiles and the hi route."""
    ops = {m: sell2.build_sell2(MATRICES[m](tf), PLUS_TIMES, device="cpu").panels
           for m in ("multi_slab", "pieces", "virtual", "hub_row")}
    assert len({lay.row0 for lay in ops["multi_slab"].layouts}) == 2
    assert all(lay.has_hi for lay in ops["multi_slab"].layouts if lay.rows > 16384)
    row0s = [lay.row0 for lay in ops["pieces"].layouts]
    assert len(row0s) > len(set(row0s))
    assert ops["pieces"].piece_owner is not None and ops["hub_row"].piece_owner is not None
    assert ops["virtual"].virt_blocks is not None
    assert any(lay.two_tiles for op in ops.values() for lay in op.layouts)
    for op in ops.values():
        for lay in op.layouts:
            assert 0 <= lay.depth <= 7 and lay.rows % 1024 == 0


def test_virtual_chunks_pack_denser():
    coo = MATRICES["virtual"](tf)
    on = sell2.build_sell2(coo, PLUS_TIMES, device="cpu").panels
    off = sell2.build_sell2(coo, PLUS_TIMES, virtual_chunks=False, device="cpu").panels
    assert off.virt_blocks is None
    assert sum(lay.panels for lay in on.layouts) < sum(lay.panels for lay in off.layouts)
    banded = sell2.build_sell2(tf.banded_coo(3000, 5, seed=10), PLUS_TIMES, device="cpu")
    assert banded.panels.virt_blocks is None


def _kernel_model(op, x, sr):
    """What csrc/sell2.cu computes, in torch, driven by the plan: in bin k
    the lanes BIN_LANES[k] of a position take chunks sub, sub + V, ... of
    4 entries of its row (the entries of the row inside each chunk),
    ⊕-accumulating them in order from 0̄; the lanes combine by the XOR
    butterfly, lane masks V/2, ..., 1; each owner then adds to its own
    row's value its pieces folded one after another from the reduction's
    identity."""
    carrier, add, mul, _, zero, _ = _carrier(sr)
    plan = op.plan
    x = x.to(sr.dtype).to(carrier)
    vals = plan.vals.float() if plan.vals.dtype == torch.bfloat16 else plan.vals.to(carrier)
    cols = plan.cols.long()
    rp = plan.row_ptr.long()
    buf = torch.full((plan.n_final + plan.n_pieces,), zero, dtype=carrier)
    p0 = 0
    for k, lanes in enumerate(sell2.BIN_LANES):
        p1 = p0 + plan.bin_rows[k]
        k0, k1 = rp[p0:p1, None], rp[p0 + 1:p1 + 1, None]
        sub = torch.arange(lanes)
        acc = torch.full((p1 - p0, lanes), zero, dtype=carrier)
        chunks = (k1 + 3) // 4 - k0 // 4
        for r in range(int((-(-chunks // lanes)).max()) if p1 > p0 else 0):
            c = k0 // 4 + sub + r * lanes
            for i in range(4):
                e = 4 * c + i
                take = (c < (k1 + 3) // 4) & (e >= k0) & (e < k1)
                e = e.clamp(max=cols.numel() - 1)
                acc = torch.where(take, add(acc, mul(x[cols[e]], vals[e])), acc)
        m = lanes // 2
        while m:
            acc = add(acc, acc[:, sub ^ m])
            m //= 2
        buf[plan.row_dest[p0:p1].long()] = acc[:, 0]
        p0 = p1
    ident = _SEGMENT_IDENTITY[_SEGMENT_REDUCE[add], carrier]
    n_pos = sum(plan.bin_rows)
    for o, (owner, q0, q1) in enumerate(plan.owners.tolist()):
        own = torch.tensor(zero, dtype=carrier)
        for e in range(int(rp[n_pos + o]), int(rp[n_pos + o + 1])):
            own = add(own, mul(x[cols[e]], vals[e]))
        seg = torch.tensor(ident, dtype=carrier)
        for q in range(q0, q1):
            seg = add(seg, buf[plan.n_final + q])
        buf[owner] = add(own, seg)
    return buf[:plan.n_final]


def _assert_model_matches(name, got, want):
    """The six min/max/or semirings bit for bit; plus_times, which the
    kernel sums in its own order, within PT_DELTA · max(1, |plain|)."""
    assert got.dtype == want.dtype
    if name == "plus_times":
        assert bool(((got - want).abs() <= PT_DELTA * want.abs().clamp(min=1.0)).all())
    else:
        assert torch.equal(got, want), name


@pytest.mark.parametrize("matrix", ["hub_row", "pieces", "virtual", "multi_slab"])
def test_kernel_model_equals_plain(matrix):
    """The plan drives the kernel's arithmetic to the plain version's
    values: the six min/max/or semirings bit for bit, pads dropped."""
    for name in NAMES:
        sr = get_semiring(name)
        coo = MATRICES[matrix](tf)
        if sr.dtype == torch.bool:
            coo = coo.with_values(coo.vals != 0)
        op = sell2.build_sell2(coo, sr, device="cpu")
        x = torch.from_numpy(_x(sr, coo.shape[1], seed=6))
        want = sell2.dp_sell2_plain(op, x, sr, n_rows=coo.shape[0])
        _assert_model_matches(name, _kernel_model(op, x, sr), want)


@pytest.mark.parametrize("bounds", [(256, 256, 256, 256, 256), (-1, -1, -1, -1, -1)],
                         ids=["one_lane", "warp"])
def test_kernel_model_equals_plain_with_other_bins(bounds, monkeypatch):
    """Every row in the one-lane bin, or every row in the warp's: the bins
    change who takes a row, never its value (pieces stay in the warp's)."""
    monkeypatch.setattr(sell2, "BIN_MAX_LEN", bounds)
    for name in ("plus_times", "min_plus"):
        sr = get_semiring(name)
        coo = MATRICES["pieces"](tf)
        op = sell2.build_sell2(coo, sr, device="cpu")
        rows = op.plan.bin_rows
        assert rows[0] == op.plan.n_pieces if bounds[0] > 0 else sum(rows) == rows[0]
        x = torch.from_numpy(_x(sr, coo.shape[1], seed=8))
        _assert_model_matches(name, _kernel_model(op, x, sr),
                              sell2.dp_sell2_plain(op, x, sr, n_rows=coo.shape[0]))


def _plan_triples(plan, base_pad):
    """(dp row, column, value) of every entry of the plan, position by
    position: a piece's dp row is base_pad + its index."""
    rp = plan.row_ptr.long()
    dest = plan.row_dest.long()
    row = torch.where(dest < plan.n_final, dest, base_pad + dest - plan.n_final)
    rows = torch.repeat_interleave(row, rp[1:] - rp[:-1])
    n = int(rp[-1])
    return rows, plan.cols[:n].long(), plan.vals[:n]


def test_plan_counts_every_nonzero_once():
    """The plan's entries are the folded matrix's, each once, split rows'
    in their pieces, and no pad: rebuilt from the COO by the encoder's own
    fold and heavy split, independently of the panels."""
    sr = PLUS_TIMES
    coo = MATRICES["hub_row"](tf)
    op = sell2.build_sell2(coo, sr, device="cpu")
    s = tf.fold_duplicates(coo, np.add).sorted_by_row()
    k_rows, k_cols, k_vals, owner, _ = sell2._heavy_split(
        s, s.vals.astype(np.float32), coo.shape[0], op.base_pad)
    assert owner is not None and op.plan.n_entries == s.nnz < coo.nnz
    rows, cols, vals = _plan_triples(op.plan, op.base_pad)
    got = sorted(zip(rows.tolist(), cols.tolist(), vals.tolist()))
    assert got == sorted(zip(k_rows.tolist(), k_cols.tolist(), k_vals.tolist()))


@pytest.mark.parametrize("matrix", ["hub_row", "pieces", "virtual", "multi_slab"])
def test_plan_rows_are_contiguous_and_binned(matrix):
    """Each position's entries are one stretch, by column, the stretches in
    position order; bins run widest first, each row in the bin of its
    length, pieces first in bin 0 and each bin's rows ascending; the bin
    counts sum to the positions and the entries; the stream is padded to
    whole chunks of 4 with column 0 and 0̄."""
    sr = get_semiring("min_plus")
    op = sell2.build_sell2(MATRICES[matrix](tf), sr, device="cpu")
    plan = op.plan
    rp = plan.row_ptr.long()
    lens = rp[1:] - rp[:-1]
    assert int(rp[0]) == 0 and bool((lens >= 0).all())
    assert sum(plan.bin_rows) + plan.owners.shape[0] == plan.row_dest.numel()
    n_pos = sum(plan.bin_rows)
    assert sum(plan.bin_entries) == int(rp[n_pos]) and int(rp[-1]) == plan.n_entries
    assert plan.cols.numel() == plan.vals.numel() == -(-plan.n_entries // 4) * 4
    assert bool((plan.cols[plan.n_entries:] == 0).all())
    assert bool((plan.vals[plan.n_entries:] == sr.zero).all())
    cols = plan.cols.long()
    within = torch.repeat_interleave(torch.arange(lens.numel()), lens)
    steps = (cols[1:plan.n_entries] > cols[:plan.n_entries - 1]) | (within[1:] != within[:-1])
    assert bool(steps.all())
    dest = plan.row_dest.long()
    p0 = 0
    for k, rows in enumerate(plan.bin_rows):
        d, n = dest[p0:p0 + rows], lens[p0:p0 + rows]
        assert int(n.sum()) == plan.bin_entries[k]
        piece = d >= plan.n_final
        if k == 0:
            assert bool(piece[:plan.n_pieces].all()) and not bool(piece[plan.n_pieces:].any())
            n = n[plan.n_pieces:]
        else:
            assert not bool(piece.any())
        out = d[~piece]
        assert bool((out[1:] > out[:-1]).all())
        if k:
            assert bool((n <= sell2.BIN_MAX_LEN[k - 1]).all())
        if k < len(sell2.BIN_MAX_LEN):
            assert bool((n > sell2.BIN_MAX_LEN[k]).all())
        p0 += rows


def _layout_runs(slab, lay):
    """(panel, row-class, out slot, aligned offset, level) of each run of a
    layout, panel by panel. Out slot o of row-class l reads the offset its
    route names (lane, and tile when the layout has two align tiles); that
    offset holds a run when its capture level v satisfies 1 ≤ v ≤ depth + 1,
    as the TPU kernel captures it, and any other offset gives 0̄, which
    needs no run."""
    P, d_out = lay.panels, lay.rows // 128
    wa = slab["wordA"].view(P, 128, 128)
    route = slab["wordB"].view(P, 128, 128)[:, :, :min(d_out, 128)]
    lane, tile = (route >> 7) & 127, (route >> 14) & 1
    if lay.has_hi and d_out > 128:
        hi = wa[:, :, :d_out - 128]
        lane = torch.cat([lane, (hi >> 22) & 127], dim=2)
        tile = torch.cat([tile, (hi >> 29) & 1], dim=2)
    off = lane + 128 * tile if lay.two_tiles else lane
    word = torch.take_along_dim(wa, (off & 127).long(), dim=2)
    cap = torch.where(off < 128, word >> 14, word >> 18) & 15
    p, l, o = torch.nonzero((cap >= 1) & (cap <= lay.depth + 1), as_tuple=True)
    return p, l, o, off[p, l, o].long(), cap[p, l, o].long() - 1


def _xbase(slab, lay, n_chunks, virt_blocks):
    """(P, 128, 2): the first x column of the block that sublane s binds for
    way w, through its chunk (wordB's row 0, column s) or virtual chunk."""
    bind = slab["wordB"].view(lay.panels, 128, 128)[:, 0, :].long()
    chunk = slab["chunk"].long()
    c = torch.where(((bind >> 30) & 1) == 1, chunk[:, 1:2], chunk[:, 0:1]).unsqueeze(2)
    blk = torch.stack([(bind >> 22) & 127, (bind >> 15) & 127], dim=2)
    base = c * CHUNK_COLS + blk * 128
    if virt_blocks is not None:
        virt = virt_blocks.long()
        vbase = virt[(c - n_chunks).clamp(0, virt.shape[0] - 1), blk] * 128
        base = torch.where(c < n_chunks, base, vbase)
    return base


@pytest.mark.parametrize("matrix", ["hub_row", "pieces", "virtual", "multi_slab"])
def test_plan_rows_rebuilt_from_layouts(matrix):
    """Two formats made apart, held against each other: every real slot of
    the encoder's panels, found without the plan (each run of each layout
    from its routes, its aligned slots' sublanes, and the slot's lane and
    way from wordB; the slots whose sublane is the identity row are the
    pads), and the plan made from the entries. The plan holds exactly the
    real slots, at their dp rows (a slab's rows start at its row0), and the
    output rows it names are every row below n_final but the owners."""
    sr = PLUS_TIMES
    op = sell2.build_sell2(MATRICES[matrix](tf), sr, device="cpu")
    panels = op.panels
    want, pads = [], 0
    for slab, lay in zip(panels.slabs, panels.layouts):
        if not lay.panels:
            continue
        p, l, o, off, level = _layout_runs(slab, lay)
        wa = slab["wordA"].view(lay.panels, 128, 128).numpy()
        wb = slab["wordB"].view(lay.panels, 128, 128).numpy()
        xb = _xbase(slab, lay, panels.n_chunks, panels.virt_blocks).numpy()
        vals = slab["vals"].view(lay.panels, 128, 128).numpy()
        for pi, li, oi, fi, vi in zip(p.tolist(), l.tolist(), o.tolist(), off.tolist(),
                                      level.tolist()):
            for j in range(fi, fi + (1 << vi)):
                w = int(wa[pi, li, j & 127])
                a = w & 127 if j < 128 else (w >> 7) & 127
                if a == sell2.USABLE:
                    pads += 1
                    continue
                b = int(wb[pi, a, li])
                want.append((lay.row0 + oi * 128 + li,
                             int(xb[pi, a, (b >> 29) & 1]) + (b & 127), float(vals[pi, a, li])))
    rows, cols, vals = _plan_triples(op.plan, op.base_pad)
    assert sorted(zip(rows.tolist(), cols.tolist(), vals.tolist())) == sorted(want)
    dest = op.plan.row_dest.long()[:sum(op.plan.bin_rows)]
    owners = op.plan.owners[:, 0].tolist()
    assert sorted(dest[dest < op.plan.n_final].tolist()) == [
        r for r in range(op.plan.n_final) if r not in set(owners)]
    assert op.plan.row_dest[dest.numel():].tolist() == owners
    if matrix != "multi_slab":
        assert pads > 0


@pytest.mark.parametrize("matrix", ["hub_row", "pieces"])
def test_plan_reaches_every_piece_once_from_its_owner(matrix):
    op = sell2.build_sell2(MATRICES[matrix](tf), PLUS_TIMES, device="cpu")
    plan, owner = op.plan, op.panels.piece_owner.long()
    owners = plan.owners.long()
    pieces = sorted(k for _, k0, k1 in owners.tolist() for k in range(k0, k1))
    assert pieces == list(range(owner.numel()))
    for o, (row, k0, k1) in enumerate(owners.tolist()):
        assert bool((owner[k0:k1] == row).all())
        assert bool((plan.piece_slot[k0:k1] == o).all())
    assert plan.piece_slot.numel() == owner.numel() == plan.n_pieces
    assert not bool(plan.owner_done.any())
    # the pieces open bin 0 in piece order; the owners' own rows follow the
    # bins, one position each in owner order
    n_pos = sum(plan.bin_rows)
    assert plan.row_dest[:plan.n_pieces].tolist() == list(
        range(plan.n_final, plan.n_final + plan.n_pieces))
    assert plan.row_dest[n_pos:].tolist() == owners[:, 0].tolist()
    assert not set(owners[:, 0].tolist()) & set(plan.row_dest[:n_pos].tolist())
    assert plan.n_final == op.base_pad


def test_plan_counts_reach_the_plan_span():
    """The build's ``build.encode`` span at stage ``plan`` carries the
    plan's bin and piece counts."""
    from sparseharness_tpu_torch.utils import timing

    timing.start_recording()
    try:
        op = sell2.build_sell2(MATRICES["pieces"](tf), PLUS_TIMES, device="cpu")
    finally:
        rec = timing.stop_recording()
    (span,) = [s for s in rec if s.name == "build.encode" and s.attrs.get("stage") == "plan"]
    assert span.attrs["bin_rows"] == list(op.plan.bin_rows)
    assert span.attrs["bin_entries"] == list(op.plan.bin_entries)
    assert span.attrs["pieces"] == op.plan.n_pieces > 0


def test_plain_refuses_an_operand_without_panels():
    """A card build keeps only the kernel's plan: the plain version, and the
    routed dp on a CPU tensor, refuse such an operand, naming the CPU
    build."""
    sr = get_semiring("plus_times")
    coo = MATRICES["hub_row"](tf)
    op = dataclasses.replace(sell2.build_sell2(coo, sr, device="cpu"), panels=None)
    x = torch.zeros(coo.shape[1])
    for dp in (sell2.dp_sell2_plain, sell2.dp_sell2):
        with pytest.raises(ValueError, match="build it on the CPU"):
            dp(op, x, sr, n_rows=coo.shape[0])


def test_kernel_constants_match_plan():
    """The kernel source's bins, their lanes and its block size are the
    plan's."""
    src = (Path(sell2.__file__).parent / "csrc" / "sell2.cu").read_text()
    assert f"kSell2Bins = {len(sell2.BIN_LANES)};" in src
    lanes = ", ".join(str(v) for v in sell2.BIN_LANES)
    assert f"kBinLanes[kSell2Bins] = {{{lanes}}};" in src
    assert f"kRowThreads = {sell2.ROW_THREADS};" in src
    assert len(sell2.BIN_MAX_LEN) == len(sell2.BIN_LANES) - 1


def test_spmv_gold_gate_on_cpu():
    for name in ("plus_times", "min_plus", "max_right"):
        sr = get_semiring(name)
        coo = MATRICES["pieces"](tf)
        if name == "max_right":
            coo = coo.with_values((coo.vals * 50).astype(np.int32))
        x, y = _x(sr, coo.shape[1], seed=1), _x(sr, coo.shape[0], seed=2)
        op = build_operand(coo, sr, "sell2", Geometry(), device="cpu")
        out = spmv(op, torch.from_numpy(x), torch.from_numpy(y), sr=sr, variant="sell2",
                   n_rows=coo.shape[0])
        gold = spmv_gold(coo, x, y, sr)
        assert check_result(out.numpy(), gold, delta=1e-4 if name == "plus_times" else 0,
                            scale=spmv_abs_bound(coo, x)) is Correctness.CORRECT


def test_variant_bytes_is_the_hand_sum():
    """Every array of the kernel's plan once, x once and the output once;
    the panels are not counted."""
    for matrix in ("pieces", "virtual"):
        coo = MATRICES[matrix](tf)
        op = sell2.build_sell2(coo, PLUS_TIMES, value_dtype="bfloat16", device="cpu")
        plan = op.plan
        hand = sum(t.numel() * t.element_size() for t in (
            plan.row_ptr, plan.row_dest, plan.cols, plan.vals, plan.owners, plan.piece_slot,
            plan.owner_done))
        x_bytes, out_bytes = coo.shape[1] * 4, coo.shape[0] * 4
        assert variant_bytes("sell2", op, x_bytes, out_bytes) == hand + x_bytes + out_bytes


def test_kernel_wrapper_refuses_cpu_tensors():
    sr = get_semiring("min_plus")
    coo = MATRICES["hub_row"](tf)
    op = sell2.build_sell2(coo, sr, device="cpu")
    before = dict(LAUNCHES)
    with pytest.raises(ValueError):
        sell2.sell2_dp_cuda(op, torch.zeros(coo.shape[1]), sr)
    assert LAUNCHES == before


def test_refuses_what_jax_refuses():
    """The padding guard, which is how auto moves on past sell2."""
    sr, jsr = get_semiring("plus_times"), jax_semiring("plus_times")
    # one entry in each of 2^14 rows over 400 chunks, with virtual chunks
    # off: a panel holds a handful of entries
    n = 1 << 14
    rows = np.arange(n)
    make = (lambda m: m.coo_from_arrays(rows, (rows % 400) * CHUNK_COLS,
                                        np.ones(n, np.float32), (n, 400 * CHUNK_COLS)))
    with pytest.raises(NotImplementedError):
        js.build_sell2(make(jf), jsr, virtual_chunks=False)
    with pytest.raises(NotImplementedError):
        sell2.build_sell2(make(tf), sr, virtual_chunks=False, device="cpu")
