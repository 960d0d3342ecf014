"""The sell2 plan's degree order of x (``ops/sell2.py:degree_order``).

Where the order brings more than X_COPY_GATHERS entries a column into
x's first L1_COLS columns (``degree_rank``), the plan numbers the columns
by how many entries read them, most first, keeps ``col_perm[new] =
old``, and a call first gathers x into that order
(``csrc/sell2.cu:sell2_x_kernel``). The
CPU cases make plans from synthetic entries (as ``build_sell2`` hands them
to ``make_plan``) and hold the order against the plan without it: the same
positions, each row's same (column, value) entries; and each rank of a
sharded operand, which takes the order by its own block's entries, against
the stacked panels' plain version. The ``cuda`` cases hold the kernel over
an ordered plan against the plain version; they skip without a card, and
run on one with

    python -m pytest tests/test_torch_sell2_xorder.py -m cuda --noconftest -q
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

from sparseharness_tpu_torch.formats import coo_from_arrays, fold_duplicates, power_law_coo
from sparseharness_tpu_torch.formats.sparse import round_up
from sparseharness_tpu_torch.harness import variant_bytes
from sparseharness_tpu_torch.ops import LAUNCHES, sell2
from sparseharness_tpu_torch.ops.verify import verify_operand_initialized
from sparseharness_tpu_torch.parallel import sharded_sell as tss
from sparseharness_tpu_torch.parallel.mesh import Mesh
from sparseharness_tpu_torch.semiring import MIN_PLUS, PLUS_TIMES, REGISTRY, get_semiring
from sparseharness_tpu_torch.semiring.core import _carrier

PT_DELTA = 1e-5
#: the plan's tensors other than the column stream, which the order leaves as they are
_ROW_TENSORS = ("row_ptr", "row_dest", "owners", "piece_slot", "owner_done")


def _skewed(n_rows: int, n_cols: int, nnz: int, seed: int, scattered: bool = True):
    """About ``nnz`` distinct entries whose columns are drawn by a power
    law over a random permutation of the columns, so that the most read
    columns lie scattered over x, as a graph's permuted labels put them
    (with ``scattered`` False, over the columns in order: the most read
    first); row 5 holds 600 entries, more than SPLIT_T, so the plan has
    pieces."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_cols + 1) ** 0.7
    hot = rng.permutation(n_cols) if scattered else np.arange(n_cols)
    cols = hot[rng.choice(n_cols, size=int(nnz * 1.2), p=w / w.sum())]
    rows = rng.integers(0, n_rows, cols.size)
    rows = np.r_[np.full(600, 5), rows]
    cols = np.r_[rng.choice(n_cols, 600, replace=False), cols]
    key = np.unique(rows.astype(np.int64) * n_cols + cols)
    key = key[rng.permutation(key.size)[:nnz]]
    vals = rng.uniform(0.1, 1.0, key.size).astype(np.float32)
    return coo_from_arrays(key // n_cols, key % n_cols, vals, (n_rows, n_cols))


def _plan(coo):
    """make_plan over the entries that build_sell2 hands it: folded,
    row-sorted, heavy rows split into pieces past base_pad."""
    n = coo.shape[0]
    s = fold_duplicates(coo, np.add).sorted_by_row()
    base_pad = round_up(max(n, 1), 1024)
    rows, cols, vals, owner, n_tot = sell2._heavy_split(s, s.vals.astype(np.float32), n,
                                                        base_pad)
    return sell2.make_plan(torch.from_numpy(rows.astype(np.int32)),
                           torch.from_numpy(cols.astype(np.int32)), torch.from_numpy(vals),
                           torch.zeros(1), None if owner is None else torch.from_numpy(owner),
                           base_pad, round_up(max(n_tot, 1), 1024), coo.shape[1])


def _as_is(monkeypatch, coo):
    """The plan of the same entries with the order's rule never met: all of
    x in L1."""
    with monkeypatch.context() as m:
        m.setattr(sell2, "L1_COLS", coo.shape[1])
        return _plan(coo)


@pytest.fixture(scope="module")
def above():
    """150,000 columns (x 600 KB, past an SM's L1), about 8 entries a column."""
    return _skewed(40_000, 150_000, 1_200_000, seed=1)


def _one_hub(n_cols: int, extra: int) -> torch.Tensor:
    """Every column read once and the last ``extra`` times more: the order
    moves it into x's first L1_COLS, and column L1_COLS − 1 out, so it
    brings ``extra`` more entries there."""
    return torch.cat([torch.arange(n_cols, dtype=torch.int32),
                      torch.full((extra,), n_cols - 1, dtype=torch.int32)])


def _cols(coo) -> torch.Tensor:
    return torch.from_numpy(coo.cols.astype(np.int32))


RULE_CASES = {
    "one_more_than_the_copy": (lambda: _one_hub(70_000, 140_001), True),
    "as_many_as_the_copy": (lambda: _one_hub(70_000, 140_000), False),
    "scattered_hubs": (lambda: _cols(_skewed(40_000, 150_000, 1_200_000, seed=1)), True),
    "popularity_order": (lambda: _cols(_skewed(40_000, 150_000, 1_200_000, seed=1,
                                               scattered=False)), False),
    "x_fits_l1": (lambda: _cols(_skewed(40_000, 65_536, 1_200_000, seed=1)), False),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule(case):
    """The plan takes the order where it brings more than X_COPY_GATHERS
    entries a column of x into x's first L1_COLS columns (the copy's cost,
    here 2 × 70,000), and then ranks the columns by count."""
    make, engages = RULE_CASES[case]
    cols = make()
    n_cols = int(cols.max()) + 1
    by_rank = sell2.degree_rank(cols, n_cols)
    assert (by_rank is not None) is engages
    if engages:
        counts = torch.bincount(cols, minlength=n_cols)[by_rank]
        assert bool((counts[1:] <= counts[:-1]).all())


@pytest.mark.parametrize("n_cols", [66_000, 4000, 1000, 20])
def test_hot_layout_deals_the_hottest_over_lines(n_cols):
    """hot_layout is a permutation; the first HOT_COLS ranks (all whole
    lines of them where x is shorter) fill their lines' first words before
    any second word, and ranks past them keep their place."""
    pos = sell2.hot_layout(n_cols)
    assert torch.equal(pos.sort().values, torch.arange(n_cols))
    lines = min(sell2.HOT_COLS, n_cols) // 32
    hot = pos[:lines * 32]
    assert torch.equal(hot // 32, torch.arange(lines * 32) % lines)
    assert torch.equal(hot % 32, torch.arange(lines * 32) // lines)
    assert torch.equal(pos[lines * 32:], torch.arange(lines * 32, n_cols))


def test_degree_order_is_a_permutation_by_count(above):
    """Above the rule col_perm holds every column once, the ranks (new ids
    through hot_layout) run in non-increasing count, ties in column order,
    and each row's entries run by new id."""
    plan = _plan(above)
    n_cols, n = above.shape[1], plan.n_entries
    assert plan.x_order == "degree" and plan.col_perm.dtype == torch.int32
    assert torch.equal(plan.col_perm.sort().values, torch.arange(n_cols, dtype=torch.int32))
    pos = sell2.hot_layout(n_cols)
    counts = torch.bincount(plan.cols[:n].long(), minlength=n_cols)[pos]
    assert bool((counts[1:] <= counts[:-1]).all())
    tie = counts[1:] == counts[:-1]
    by_rank = plan.col_perm[pos]
    assert bool((by_rank[1:][tie] > by_rank[:-1][tie]).all())
    assert int(counts[:sell2.L1_COLS].sum()) > 0.5 * n
    rp = plan.row_ptr.long()
    within = torch.repeat_interleave(torch.arange(rp.numel() - 1), rp[1:] - rp[:-1])
    cols = plan.cols[:n]
    assert bool(((cols[1:] > cols[:-1]) | (within[1:] != within[:-1])).all())
    assert plan.launch.n_perm == n_cols and plan.launch.col_perm == plan.col_perm.data_ptr()


def test_degree_order_keeps_each_rows_entries(above, monkeypatch):
    """col_perm[cols] gives, position by position, the (column, value)
    entries of the plan without the order; the positions, bins, owners and
    pieces are that plan's."""
    plan, plain = _plan(above), _as_is(monkeypatch, above)
    assert plan.col_perm is not None and plain.col_perm is None and plan.n_pieces > 0
    _assert_same_entries(plan, plain, above.shape[1])


def _assert_same_entries(plan, plain, n_cols: int):
    """``plan`` (in degree order) holds ``plain``'s positions, bins, owners
    and pieces, and through col_perm each position's same (column, value)
    entries."""
    for f in _ROW_TENSORS:
        assert torch.equal(getattr(plan, f), getattr(plain, f)), f
    assert (plan.bin_rows, plan.bin_entries, plan.n_entries, plan.n_final) == (
        plain.bin_rows, plain.bin_entries, plain.n_entries, plain.n_final)
    n = plan.n_entries
    rp = plan.row_ptr.long()
    pos = torch.repeat_interleave(torch.arange(rp.numel() - 1), rp[1:] - rp[:-1])
    key = pos * n_cols + plan.col_perm[plan.cols[:n].long()].long()
    key, idx = key.sort()
    assert torch.equal(key, pos * n_cols + plain.cols[:n].long())
    assert torch.equal(plan.vals[:n][idx], plain.vals[:n])
    assert plan.cols.numel() == plain.cols.numel() and bool((plan.cols[n:] == 0).all())


@pytest.mark.parametrize("n_cols,nnz,scattered", [
    (65_536, 600_000, True), (150_000, 200_000, True), (150_000, 1_200_000, False)],
    ids=["x_fits_l1", "few_a_column", "popularity_order"])
def test_below_the_rule_keeps_x_as_it_is(n_cols, nnz, scattered):
    """Below the rule the plan has no col_perm, its launch no copy, and its
    column stream is x's own columns, each row's in column order."""
    coo = _skewed(40_000, n_cols, nnz, seed=2, scattered=scattered)
    plan = _plan(coo)
    assert plan.col_perm is None and plan.x_order == "as_is"
    assert plan.launch.n_perm == 0 and not plan.launch.col_perm
    s = fold_duplicates(coo, np.add).sorted_by_row()
    n = plan.n_entries
    assert n == s.nnz
    assert torch.equal(plan.cols[:n].sort().values,
                       torch.from_numpy(np.sort(s.cols).astype(np.int32)))


def test_plan_moves_and_pickles_with_its_order(above):
    """to() and pickling keep col_perm and remake the launch's pointer."""
    plan = _plan(above)
    for other in (plan.to("cpu"), pickle.loads(pickle.dumps(plan))):
        assert torch.equal(other.col_perm, plan.col_perm) and other.x_order == "degree"
        assert other.launch.n_perm == plan.launch.n_perm
        assert other.launch.col_perm == other.col_perm.data_ptr()


def _ranked_blocks():
    """4,096 rows over 4,000 columns, hubs scattered: rows [0, 1024) read
    30,000 entries, [1024, 2048) 25,000 and the rest 2,000. Under an L1 of
    1,024 columns, a block of the first 2,048 rows takes the order, a block
    of the last 2,048 does not."""
    parts = [_skewed(1024, 4000, 30_000, seed=5), _skewed(1024, 4000, 25_000, seed=6),
             _skewed(2048, 4000, 2000, seed=7)]
    offsets = (0, 1024, 2048)
    return coo_from_arrays(np.concatenate([p.rows + o for p, o in zip(parts, offsets)]),
                           np.concatenate([p.cols for p in parts]),
                           np.concatenate([p.vals for p in parts]), (4096, 4000))


def _min_plus_model(plan, x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The plan's min_plus dp in torch, in the kernel's steps, for
    _ranked_blocks' 4,000 columns: x gathered through col_perm where the
    plan has one (0̄ past its end), each position's entries reduced,
    each owner's pieces folded into its row."""
    _, _, mul, _, zero, _ = _carrier(MIN_PLUS)
    cols = torch.arange(4000) if plan.col_perm is None else plan.col_perm.long()
    x = torch.where(cols < x.numel(), x[cols.clamp(max=x.numel() - 1)], zero)
    rp, n = plan.row_ptr.long(), plan.n_entries
    pos = torch.repeat_interleave(torch.arange(rp.numel() - 1), rp[1:] - rp[:-1])
    row = torch.full((rp.numel() - 1,), zero).scatter_reduce(
        0, pos, mul(x[plan.cols[:n].long()], plan.vals[:n]), "amin")
    out = torch.full((plan.n_final + plan.n_pieces,), zero)
    out[plan.row_dest.long()] = row
    for owner, q0, q1 in plan.owners.tolist():
        out[owner] = torch.minimum(out[owner], out[plan.n_final + q0:plan.n_final + q1].min())
    return out[:n_rows]


@pytest.mark.parametrize("shards,ordered", [(2, (True, False)),
                                            (4, (True, True, False, False))])
def test_sharded_ranks_order_x_by_their_own_blocks(shards, ordered, monkeypatch):
    """Each rank's plan applies the rule to its own block's entries over
    all of x's columns, so ranks may differ; a placed rank keeps its
    col_perm, and its plan's dp over the whole x (and a short x) through
    col_perm is the stacked panels' plain version, bit for bit."""
    monkeypatch.setattr(sell2, "L1_COLS", 1024)
    coo = _ranked_blocks()
    op, chunk = tss.build_sharded_sell(coo, MIN_PLUS, shards, device="cpu")
    assert tuple(r.plan.x_order == "degree" for r in op.ranks) == ordered
    x = torch.from_numpy(np.random.default_rng(8).uniform(0.0, 5.0, 4000).astype(np.float32))
    for rank in range(shards):
        local = tss.place_sell_shard(Mesh(rank, shards, torch.device("cpu"), "gloo"), op)
        plan = local.plan
        if ordered[rank]:
            assert torch.equal(plan.col_perm, op.ranks[rank].plan.col_perm)
            assert plan.launch.col_perm == plan.col_perm.data_ptr()
        for xs in (x, x[:3000]):
            ref = sell2.dp_sell2_plain(local, xs, MIN_PLUS, n_rows=chunk)[:chunk]
            assert torch.equal(_min_plus_model(plan, xs, chunk), ref)


def _small_ordered(monkeypatch, value_dtype="float32"):
    """A CPU build of a small matrix under an L1 of 1,024 columns, so that
    the whole build (panels, plan, span) takes the order."""
    monkeypatch.setattr(sell2, "L1_COLS", 1024)
    coo = _skewed(3000, 4000, 40_000, seed=3)
    return coo, sell2.build_sell2(coo, PLUS_TIMES, value_dtype=value_dtype, device="cpu")


def test_x_order_reaches_the_plan_span(monkeypatch):
    """The build's ``build.encode`` span at stage ``plan`` says whether the
    plan orders x, and the share of the entries whose column lies in x's
    first L1_COLS: in the ordered x, or in x as it is."""
    from sparseharness_tpu_torch.utils import timing

    def plan_span(build):
        timing.start_recording()
        try:
            op = build()
        finally:
            rec = timing.stop_recording()
        (span,) = [s for s in rec if s.name == "build.encode" and s.attrs.get("stage") == "plan"]
        cols = op.plan.cols[:op.plan.n_entries]
        assert span.attrs["hot_share"] == int((cols < sell2.L1_COLS).sum()) / cols.numel()
        return span.attrs

    ragged = power_law_coo(3000, 20_000, alpha=1.5, seed=4)
    attrs = plan_span(lambda: sell2.build_sell2(ragged, PLUS_TIMES, device="cpu"))
    assert attrs["x_order"] == "as_is" and attrs["hot_share"] == 1.0
    attrs = plan_span(lambda: _small_ordered(monkeypatch)[1])
    assert attrs["x_order"] == "degree" and 0.0 < attrs["hot_share"] < 1.0


def test_ordered_operand_passes_the_init_check(monkeypatch):
    """col_perm has its contract: every slot a column of the matrix."""
    coo, op = _small_ordered(monkeypatch)
    assert op.plan.x_order == "degree"
    verify_operand_initialized(coo, PLUS_TIMES, op, "sell2")
    bad = dataclasses.replace(op, plan=dataclasses.replace(
        op.plan, col_perm=op.plan.col_perm + coo.shape[1]))
    with pytest.raises(ValueError, match="col_perm"):
        verify_operand_initialized(coo, PLUS_TIMES, bad, "sell2")


def test_variant_bytes_is_the_hand_sum(monkeypatch):
    """Every array of the kernel's plan once, col_perm included, x once and
    the output once."""
    coo, op = _small_ordered(monkeypatch, "bfloat16")
    plan = op.plan
    hand = sum(t.numel() * t.element_size() for t in (
        plan.row_ptr, plan.row_dest, plan.cols, plan.vals, plan.owners, plan.piece_slot,
        plan.owner_done, plan.col_perm))
    x_bytes, out_bytes = coo.shape[1] * 4, coo.shape[0] * 4
    assert variant_bytes("sell2", op, x_bytes, out_bytes) == hand + x_bytes + out_bytes


# ------------------------------------------------------------- on the card

# (semiring, value dtype): bf16 values only for the float semirings
CASES = [(n, vd) for n in sorted(REGISTRY) for vd in ("float32", "bfloat16")
         if vd == "float32" or get_semiring(n).dtype == torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def wide():
    """150,000 columns (x 600 KB), about 10 entries a column: the order engages."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _skewed(200_000, 150_000, 1_500_000, seed=7)


def _x(sr, n, seed):
    rng = np.random.default_rng(seed)
    if sr.dtype == torch.bool:
        x = rng.random(n) < 0.3
    elif sr.dtype == torch.int32:
        x = rng.integers(-50, 50, n).astype(np.int32)
    else:
        x = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    return torch.from_numpy(x)


def _values(coo, sr):
    """coo with values of the semiring's type."""
    if sr.dtype == torch.bool:
        return coo.with_values(coo.vals != 0)
    if sr.dtype == torch.int32:
        return coo.with_values(np.round(coo.vals * 40 - 20).astype(np.int32))
    return coo


def _operand(coo, sr, value_dtype, device):
    """A CPU build (plan and panels) moved to ``device``."""
    m = _values(coo, sr)
    return m, sell2.build_sell2(m, sr, value_dtype=value_dtype, device="cpu").to(device)


def _assert_matches(sr, got, ref, bound):
    assert got.dtype == ref.dtype
    if sr.name != "plus_times":
        assert torch.equal(got, ref)
        return
    tol = PT_DELTA * torch.clamp(torch.maximum(ref.abs(), bound), min=1.0)
    assert bool(((got - ref).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name,value_dtype", CASES)
def test_ordered_kernel_matches_plain(name, value_dtype, wide, cuda):
    """Over a plan in degree order, the kernel gives the plain version's
    values (plus_times within the tolerance, the rest bit for bit), the
    same bits twice, one x copy a call, and 0̄ past the end of a short x."""
    sr = get_semiring(name)
    m, op = _operand(wide, sr, value_dtype, cuda)
    assert op.plan.x_order == "degree"
    n = m.shape[0]
    x = _x(sr, m.shape[1], seed=9).to(cuda)
    before = dict(LAUNCHES)
    got = sell2.sell2_dp_cuda(op, x, sr)
    again = sell2.sell2_dp_cuda(op, x, sr)
    torch.cuda.synchronize()
    assert LAUNCHES["sell2"] - before["sell2"] == 2
    assert LAUNCHES["sell2_x"] - before["sell2_x"] == 2
    ref = sell2.dp_sell2_plain(op, x, sr, n_rows=n)
    bound = None
    if name == "plus_times":
        aop = _operand(wide.with_values(np.abs(wide.vals)), sr, value_dtype, cuda)[1]
        bound = sell2.dp_sell2_plain(aop, x.abs(), sr, n_rows=n)
    _assert_matches(sr, got, ref, bound)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    short = x[:m.shape[1] - 20_000]
    got = sell2.sell2_dp_cuda(op, short, sr)
    ref = sell2.dp_sell2_plain(op, short, sr, n_rows=n)
    if name == "plus_times":
        bound = sell2.dp_sell2_plain(aop, short.abs(), sr, n_rows=n)
    _assert_matches(sr, got, ref, bound)


@pytest.mark.cuda
def test_card_build_orders_as_the_cpu_build(wide, cuda):
    """The plan made on the card (its count, sort and int32 map there) is
    the CPU build's, field for field."""
    cpu_plan = sell2.build_sell2(wide, PLUS_TIMES, device="cpu").plan
    card_plan = sell2.build_sell2(wide, PLUS_TIMES, device=cuda).plan
    assert card_plan.x_order == cpu_plan.x_order == "degree"
    for f in sell2._LAUNCH_TENSORS:
        assert torch.equal(getattr(card_plan, f).cpu(), getattr(cpu_plan, f)), f
    assert (card_plan.bin_rows, card_plan.bin_entries, card_plan.n_entries) == (
        cpu_plan.bin_rows, cpu_plan.bin_entries, cpu_plan.n_entries)


@pytest.mark.cuda
def test_ragged_shape_makes_no_copy(cuda):
    """Below the rule (bench.py's ragged matrix, 4 entries a column) a call
    launches the kernel alone."""
    coo = power_law_coo(500_000, 2_000_000, alpha=1.5, seed=13)
    op = sell2.build_sell2(coo, PLUS_TIMES, device=cuda)
    assert op.plan.x_order == "as_is"
    x = _x(PLUS_TIMES, coo.shape[1], seed=3).to(cuda)
    before = dict(LAUNCHES)
    sell2.sell2_dp_cuda(op, x, PLUS_TIMES)
    torch.cuda.synchronize()
    assert LAUNCHES["sell2"] - before["sell2"] == 1
    assert LAUNCHES["sell2_x"] == before["sell2_x"]


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", ["plus_times", "min_plus", "or_and"])
def test_sharded_rank_kernel_matches_plain(name, shards, monkeypatch, cuda):
    """Each rank of a sharded operand, placed on the card, gathers the
    whole x through its own col_perm where its block takes the order: its
    kernel gives the stacked panels' plain version (plus_times within the
    tolerance, the rest bit for bit), with one x copy a call on a rank in
    degree order and none on the others."""
    monkeypatch.setattr(sell2, "L1_COLS", 1024)
    sr = get_semiring(name)
    coo = _ranked_blocks()
    op, chunk = tss.build_sharded_sell(_values(coo, sr), sr, shards, device="cpu")
    aop = None
    if name == "plus_times":
        aop = tss.build_sharded_sell(coo.with_values(np.abs(coo.vals)), sr, shards,
                                     device="cpu")[0]
    x = _x(sr, coo.shape[1], seed=12).to(cuda)
    orders = []
    for rank in range(shards):
        mesh = Mesh(rank, shards, cuda, "nccl")
        local = tss.place_sell_shard(mesh, op)
        orders.append(local.plan.x_order)
        before = dict(LAUNCHES)
        got = sell2.sell2_dp_cuda(local, x, sr)
        torch.cuda.synchronize()
        assert LAUNCHES["sell2"] - before["sell2"] == 1
        assert LAUNCHES["sell2_x"] - before["sell2_x"] == (local.plan.x_order == "degree")
        ref = sell2.dp_sell2_plain(local, x, sr, n_rows=chunk)
        bound = None
        if aop is not None:
            bound = sell2.dp_sell2_plain(tss.place_sell_shard(mesh, aop), x.abs(), sr,
                                         n_rows=chunk)
        _assert_matches(sr, got, ref, bound)
    assert "degree" in orders and "as_is" in orders

