"""The port's sell2 variant against the JAX package's (ops/pallas_sell2),
on the layout cases of tests/test_sell2.py.

The port's build_sell2 must reproduce the JAX build's arrays exactly (the
JAX side on its NumPy path). The plain dp, on the JAX-built operand carried
over by interop and on the port-built one, must equal JAX's dp_sell2 in
interpret mode: bit for bit for the six min/max/or semirings, plus_times
within 1e-5 · max(1, |dp|, Σ|a·x|). The CUDA kernel cannot run here, so
its plan is held by a torch model of the kernel (products per work item,
run values in the butterfly's pairwise order, rows and pieces reduced from
the plan), which must give the plain version's bits for every semiring,
and by the plan's own invariants.
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


def _assert_same_operand(op, jop):
    assert op.layouts == jop.layouts
    assert (op.n_chunks, op.n_rows, op.base_pad) == (jop.n_chunks, jop.n_rows, jop.base_pad)
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
    ops = {m: sell2.build_sell2(MATRICES[m](tf), PLUS_TIMES, device="cpu")
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
    on = sell2.build_sell2(coo, PLUS_TIMES, device="cpu")
    off = sell2.build_sell2(coo, PLUS_TIMES, virtual_chunks=False, device="cpu")
    assert off.virt_blocks is None
    assert sum(lay.panels for lay in on.layouts) < sum(lay.panels for lay in off.layouts)
    banded = sell2.build_sell2(tf.banded_coo(3000, 5, seed=10), PLUS_TIMES, device="cpu")
    assert banded.virt_blocks is None


def _kernel_model(op, x, sr):
    """What csrc/sell2.cu computes, in torch, driven by the plan: each work
    item's products for its 32-lane group through xbase, each 128-slot chunk
    reduced by the butterfly (pairwise ⊕ of slots 2i and 2i + 1, level by
    level) with each run's value taken at its first slot and written at its
    id (the chunk's first id plus the starts before it); then each output
    row's runs ⊕-reduced per layout and across layouts, and each owner's
    own row and pieces folded one after another."""
    carrier, add, mul, _, zero, _ = _carrier(sr)
    plan = op.plan
    x = x.to(sr.dtype).to(carrier)
    launched = [s for s, lay in zip(op.slabs, op.layouts) if lay.panels]
    run_vals = torch.empty(plan.n_runs, dtype=carrier)
    if launched:
        wb = torch.cat([s["wordB"].view(-1, 128, 128) for s in launched]).long()
        vals = torch.cat([s["vals"].view(-1, 128, 128) for s in launched])
        vals = vals.float() if vals.dtype == torch.bfloat16 else vals
    words = plan.slot_word.long().view(-1, 128) & 0xFFFF
    group = sell2.GROUP_LANES
    for g, q, c0, c1 in plan.blocks.tolist():
        b = wb[g, :, q * group:(q + 1) * group]
        xi = plan.xbase[g].long()[torch.arange(128)[:, None], (b >> 29) & 1] + (b & 127)
        xv = torch.where(xi < x.numel(), x[xi.clamp(max=x.numel() - 1)],
                         torch.full_like(x[:1], zero))
        prod = mul(xv, vals[g, :, q * group:(q + 1) * group]).reshape(-1)
        w = words[c0:c1]
        level_sums = [prod[w & 0xFFF]]
        while level_sums[-1].shape[1] > 1:
            s = level_sums[-1]
            level_sums.append(add(s[:, 0::2], s[:, 1::2]))
        lv = w >> 12
        starts = lv > 0
        ids = plan.chunk_run0[c0:c1].long()[:, None] + torch.cumsum(starts.long(), 1) - 1
        ci, pos = torch.nonzero(starts, as_tuple=True)
        v = lv[ci, pos] - 1
        for level in v.unique().tolist():
            sel = v == level
            run_vals[ids[ci[sel], pos[sel]]] = level_sums[level][ci[sel], pos[sel] >> level]
    rp = plan.row_ptr.long()
    counts = rp[1:] - rp[:-1]
    e = plan.row_runs.long()
    zero_t = torch.full((plan.n_out,), zero, dtype=carrier)
    total, part = zero_t.clone(), zero_t.clone()
    for k in range(int(counts.max())):
        has = counts > k
        idx = (rp[:-1] + k).clamp(max=max(e.numel() - 1, 0))
        opens = has & (e[idx] < 0)
        total = torch.where(opens, add(total, part), total)
        part = torch.where(opens, zero_t, part)
        part = torch.where(has, add(part, run_vals[e[idx] & 0x7FFFFFFF]), part)
    dp = torch.where(counts > 0, add(total, part), total)
    out = dp[:plan.n_final].clone()
    ident = _SEGMENT_IDENTITY[_SEGMENT_REDUCE[add], carrier]
    for owner, k0, k1 in plan.owners.tolist():
        seg = torch.tensor(ident, dtype=carrier)
        for k in range(k0, k1):
            seg = add(seg, dp[op.base_pad + k])
        out[owner] = add(dp[owner], seg)
    return out


@pytest.mark.parametrize("matrix", ["hub_row", "pieces", "virtual", "multi_slab"])
def test_kernel_model_equals_plain(matrix):
    """The plan drives the kernel's arithmetic to the plain version's bits,
    plus_times included."""
    for name in NAMES:
        sr = get_semiring(name)
        coo = MATRICES[matrix](tf)
        if sr.dtype == torch.bool:
            coo = coo.with_values(coo.vals != 0)
        op = sell2.build_sell2(coo, sr, device="cpu")
        x = torch.from_numpy(_x(sr, coo.shape[1], seed=6))
        want = sell2.dp_sell2_plain(op, x, sr, n_rows=coo.shape[0])
        got = _kernel_model(op, x, sr)
        assert got.dtype == want.dtype and torch.equal(got, want), name


@pytest.mark.parametrize("cap", [1, 3])
def test_kernel_model_equals_plain_with_split_items(cap, monkeypatch):
    """With a small chunk cap every (panel, lane group) is cut over several
    blocks, each computing the group's products again: the same bits."""
    monkeypatch.setattr(sell2, "BLOCK_CHUNK_CAP", cap)
    for name in ("plus_times", "min_plus"):
        sr = get_semiring(name)
        coo = MATRICES["pieces"](tf)
        op = sell2.build_sell2(coo, sr, device="cpu")
        blocks = op.plan.blocks
        assert int((blocks[:, 3] - blocks[:, 2]).max()) <= cap
        assert blocks.shape[0] > len({(g, q) for g, q in blocks[:, :2].tolist()})
        x = torch.from_numpy(_x(sr, coo.shape[1], seed=8))
        assert torch.equal(_kernel_model(op, x, sr),
                           sell2.dp_sell2_plain(op, x, sr, n_rows=coo.shape[0])), name


def _runs_of_slots(plan):
    """(chunk, position, level) of every run start in the slot words."""
    words = plan.slot_word.long().view(-1, 128) & 0xFFFF
    c, pos = torch.nonzero(words >> 12, as_tuple=True)
    return c, pos, (words[c, pos] >> 12) - 1


def test_plan_counts_every_nonzero_once():
    """Each run is one (panel, row) group, so the runs of a row cover its
    entries once: the run widths hold every nonzero, and the row lists name
    every run once."""
    coo = MATRICES["pieces"](tf)
    op = sell2.build_sell2(coo, PLUS_TIMES, device="cpu")
    plan = op.plan
    _, _, level = _runs_of_slots(plan)
    assert plan.n_runs == level.numel() <= coo.nnz
    assert int((1 << level).sum()) >= coo.nnz
    assert int(plan.row_ptr[-1]) == plan.n_runs
    assert sorted((plan.row_runs.long() & 0x7FFFFFFF).tolist()) == list(range(plan.n_runs))
    assert plan.n_out == sum({lay.row0: lay.rows for lay in op.layouts}.values())


@pytest.mark.parametrize("matrix", ["hub_row", "pieces", "virtual", "multi_slab"])
def test_plan_work_items_hold_every_run_once(matrix):
    """The work items' chunk ranges tile the chunks, none over the cap, a
    panel's items adjacent and panels with the most chunks first; every run
    lies aligned inside one chunk, so inside exactly one work item, and the
    chunks' first ids count the runs."""
    plan = sell2.build_sell2(MATRICES[matrix](tf), PLUS_TIMES, device="cpu").plan
    blocks = plan.blocks.long()
    size = blocks[:, 3] - blocks[:, 2]
    assert bool((size >= 1).all()) and int(size.max()) <= sell2.BLOCK_CHUNK_CAP
    panels = torch.unique_consecutive(blocks[:, 0])
    assert panels.numel() == torch.unique(blocks[:, 0]).numel()
    per_panel = torch.zeros(plan.n_panels, dtype=torch.int64).index_add_(0, blocks[:, 0], size)
    assert torch.equal(per_panel[panels], per_panel[panels].sort(descending=True).values)
    by_start = blocks[blocks[:, 2].argsort()]
    n_chunks = plan.chunk_run0.numel() - 1
    assert int(by_start[0, 2]) == 0 and int(by_start[-1, 3]) == n_chunks
    assert torch.equal(by_start[1:, 2], by_start[:-1, 3])
    c, pos, level = _runs_of_slots(plan)
    assert bool((pos % (1 << level) == 0).all())
    assert bool((pos + (1 << level) <= sell2.CHUNK_SLOTS).all())
    assert torch.equal(plan.chunk_run0.long(),
                       torch.searchsorted(c, torch.arange(n_chunks + 1)))
    assert int(plan.chunk_run0[-1]) == plan.n_runs


def _runs_from_layouts(op):
    """(row, layout, panel, id) of every run, found without the plan's row
    lists: each run of each layout from its routes (sell2._layout_runs),
    matched by (panel, lane, align sublane of its first slot) to the run
    that the slot words start in the work items, whose id counts from the
    chunk's first."""
    plan = op.plan
    starts, _ = sell2._row_starts(op.layouts)
    launched = [(s, lay) for s, lay in zip(op.slabs, op.layouts) if lay.panels]
    run_of = {}
    g0 = 0
    for li, (slab, lay) in enumerate(launched):
        p, l, o, off, _ = sell2._layout_runs(slab, lay)
        word = slab["wordA"].view(lay.panels, 128, 128)[p, l, off & 127].long()
        a = torch.where(off < 128, word & 127, (word >> 7) & 127)
        for pi, li_, oi, ai in zip(p.tolist(), l.tolist(), o.tolist(), a.tolist()):
            run_of[(g0 + pi, li_, ai)] = (starts[lay.row0] + oi * 128 + li_, li, g0 + pi)
        g0 += lay.panels
    words = plan.slot_word.long().view(-1, 128) & 0xFFFF
    run0 = plan.chunk_run0.long()
    runs = []
    for g, q, c0, c1 in plan.blocks.tolist():
        for c in range(c0, c1):
            for i, slot in enumerate(torch.nonzero(words[c] >> 12).flatten().tolist()):
                w = int(words[c, slot]) & 0xFFF
                runs.append(run_of[(g, q * sell2.GROUP_LANES + (w & 31), w >> 5)]
                            + (int(run0[c]) + i,))
    assert len(runs) == plan.n_runs == len(run_of)
    return runs


@pytest.mark.parametrize("matrix", ["hub_row", "pieces", "virtual", "multi_slab"])
def test_plan_row_lists_rebuilt_from_layouts(matrix):
    """The row order rebuilt independently of the plan's row lists: row r's
    runs, row_runs[row_ptr[r]:row_ptr[r + 1]], in (layout, panel) order,
    and bit 31 set on exactly each layout's first run in a row, the row's
    first run aside."""
    op = sell2.build_sell2(MATRICES[matrix](tf), PLUS_TIMES, device="cpu")
    plan = op.plan
    runs = sorted(_runs_from_layouts(op))
    e = plan.row_runs.long()
    assert (e & 0x7FFFFFFF).tolist() == [run[3] for run in runs]
    opens = [k > 0 and runs[k][0] == runs[k - 1][0] and runs[k][1] != runs[k - 1][1]
             for k in range(len(runs))]
    assert (e < 0).tolist() == opens and any(opens)
    rp = plan.row_ptr.long()
    row_at = torch.repeat_interleave(torch.arange(plan.n_out), rp[1:] - rp[:-1])
    assert row_at.tolist() == [run[0] for run in runs]


@pytest.mark.parametrize("matrix", ["hub_row", "pieces"])
def test_plan_reaches_every_piece_once_from_its_owner(matrix):
    op = sell2.build_sell2(MATRICES[matrix](tf), PLUS_TIMES, device="cpu")
    plan, owner = op.plan, op.piece_owner.long()
    owners = plan.owners.long()
    pieces = sorted(k for _, k0, k1 in owners.tolist() for k in range(k0, k1))
    assert pieces == list(range(owner.numel()))
    for o, (row, k0, k1) in enumerate(owners.tolist()):
        assert bool((owner[k0:k1] == row).all())
        assert bool((plan.piece_slot[k0:k1] == o).all())
    assert plan.piece_slot.numel() == owner.numel()
    assert not bool(plan.owner_done.any())
    bits = plan.owner_bits.long() & 0xFFFFFFFF
    marked = [r for r in range(plan.n_final) if (int(bits[r >> 5]) >> (r & 31)) & 1]
    assert marked == sorted(owners[:, 0].tolist())
    assert plan.n_final == op.base_pad


def test_stale_plan_is_refused():
    """A plan whose slabs were replaced, or a plan of another operand, is
    refused before anything reaches the kernel."""
    sr = get_semiring("plus_times")
    op = sell2.build_sell2(MATRICES["hub_row"](tf), sr, device="cpu")
    other = sell2.build_sell2(MATRICES["pieces"](tf), sr, device="cpu")
    x = torch.zeros(op.n_chunks * CHUNK_COLS)
    before = dict(LAUNCHES)
    for stale in (dataclasses.replace(op, slabs=list(op.slabs)),
                  dataclasses.replace(op, plan=other.plan)):
        with pytest.raises(ValueError, match="plan does not belong"):
            sell2.sell2_dp_cuda(stale, x, sr)
    assert LAUNCHES == before


def test_kernel_constants_match_plan():
    """The kernel source's lane group and chunk cap are the plan's."""
    src = (Path(sell2.__file__).parent / "csrc" / "sell2.cu").read_text()
    assert f"kGroupLanes = {sell2.GROUP_LANES};" in src
    assert f"kBlockChunkCap = {sell2.BLOCK_CHUNK_CAP};" in src


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
    """Every slab array, piece_owner and virt_blocks once, x once and the
    output once; the plan is not counted."""
    for matrix in ("pieces", "virtual"):
        coo = MATRICES[matrix](tf)
        op = sell2.build_sell2(coo, PLUS_TIMES, value_dtype="bfloat16", device="cpu")
        hand = sum(t.numel() * t.element_size() for s in op.slabs if s is not None
                   for t in s.values())
        for extra in (op.piece_owner, op.virt_blocks):
            hand += 0 if extra is None else extra.numel() * 4
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
