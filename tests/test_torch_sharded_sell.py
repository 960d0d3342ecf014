"""The sell mode of the port's sharded solvers (parallel/sharded_sell.py)
against the JAX package's at the same shard count, as
tests/test_sharded_sell.py holds the JAX one: power-law and scattered
graphs, solved with the sell2 local compute over an all-gathered x. The
builder's arrays (each slab's chunk ids, index words and values with the
identity-panel padding, the piece owners, the virtual-chunk tables and the
unioned layouts) equal JAX's; exact semirings match bit for bit,
plus_times within 1e-5 · max(1, |ref|, Σ|a·x|); fixpoints match on x,
iterations and converged. The port runs in worlds of 2 and 4 gloo ranks
on the CPU (the sell2 plain version), one spawned world a size; JAX on
make_mesh(2) and make_mesh(4), its Pallas kernel in interpret mode."""

import pickle
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
import sparseharness_tpu.parallel as jp
from sparseharness_tpu.gold import spmv_abs_bound
from sparseharness_tpu.ops.pallas_sell2 import CHUNK_COLS
from sparseharness_tpu.parallel import sharded_sell as jss
from sparseharness_tpu.semiring import REGISTRY as JREG
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.ops import sell2
from sparseharness_tpu_torch.parallel import Call, fixcore, run_calls, run_world
from sparseharness_tpu_torch.parallel import sharded as ts
from sparseharness_tpu_torch.parallel import sharded_sell as tss
from sparseharness_tpu_torch.parallel.mesh import Mesh
from sparseharness_tpu_torch.semiring import REGISTRY as TREG

WORLDS = (2, 4)
PT_DELTA = 1e-5


def _power(p):
    return p.power_law_coo(3000, 25_000, alpha=1.5, seed=31)


def _values(p, coo, name):
    if name == "or_and":
        return coo.with_values(coo.vals != 0)
    return coo


def _heavy(p):
    """A hub row of 400 entries (> SPLIT_T): its pieces differ per rank."""
    rng = np.random.default_rng(35)
    n = 2100
    hub_cols = rng.choice(n, 400, replace=False)
    bg = p.random_graph_coo(n, 2.0, seed=36)
    rows = np.r_[np.full(400, 9), bg.rows].astype(np.int32)
    cols = np.r_[hub_cols, bg.cols].astype(np.int32)
    vals = np.r_[rng.uniform(0.1, 1.0, 400).astype(np.float32), np.abs(bg.vals) + 0.1]
    return p.coo_from_arrays(rows, cols, vals.astype(np.float32), (n, n))


def _virtual(p):
    """Light segments of many x chunks: each rank's build makes virtual
    chunks, and the union stacks their tables."""
    rng = np.random.default_rng(41)
    n = 60 * CHUNK_COLS
    ch = np.repeat(np.arange(60), 64)
    bk = np.repeat(np.tile(np.arange(4), 60), 16)
    return p.coo_from_arrays(
        rng.integers(0, n, ch.size), ch * CHUNK_COLS + bk * 128 + rng.integers(0, 128, ch.size),
        rng.uniform(0.1, 1.0, ch.size).astype(np.float32), (n, n))


def _x(n, name, seed=32):
    rng = np.random.default_rng(seed)
    if name == "or_and":
        return rng.random(n) < 0.3
    return rng.uniform(0.1, 1.0, n).astype(np.float32)


CASE_NAMES = sorted(["spmv_plus_times", "spmv_min_plus", "spmv_or_and", "spmv_virtual",
                     "sssp_sell", "bfs_sell", "sssp_heavy_row", "sssp_auto_power"])


def _cases(w):
    cases = {}
    for name in ("plus_times", "min_plus", "or_and"):
        tc, jc = _values(tf, _power(tf), name), _values(jf, _power(jf), name)
        x = _x(tc.shape[1], name)
        op = tss.build_sharded_sell(tc, TREG[name], w, device="cpu")[0]
        cases[f"spmv_{name}"] = ("dp_tol" if name == "plus_times" else "dp", Call(
            tss.sharded_spmv_sell, dict(op=op, x=x, sr=TREG[name], n_rows=tc.shape[0])),
            lambda m, jc=jc, x=x, name=name: jss.sharded_spmv_sell(
                m, jss.build_sharded_sell(jc, JREG[name], w)[0],
                jnp.asarray(x, JREG[name].dtype), JREG[name], n_rows=jc.shape[0]))
    x = _x(_virtual(tf).shape[1], "plus_times", seed=42)
    op = tss.build_sharded_sell(_virtual(tf), TREG["plus_times"], w, device="cpu")[0]
    cases["spmv_virtual"] = ("dp_virtual", Call(tss.sharded_spmv_sell, dict(
        op=op, x=x, sr=TREG["plus_times"], n_rows=op.n_rows)),
        lambda m, x=x: jss.sharded_spmv_sell(
            m, jss.build_sharded_sell(_virtual(jf), JREG["plus_times"], w)[0],
            jnp.asarray(x), JREG["plus_times"], n_rows=x.shape[0]))

    def app(name, fn, make, **kw):
        cases[name] = ("fix", Call(getattr(ts, fn), dict(coo=make(tf), **kw)),
                       lambda m: getattr(jp, fn)(make(jf), mesh=m, **kw))

    app("sssp_sell", "sharded_sssp",
        lambda p: (lambda g: g.with_values(np.abs(g.vals) + 0.1))(
            p.random_graph_coo(600, 4.0, seed=33)), root=3, mode="sell")
    app("bfs_sell", "sharded_bfs", lambda p: p.random_graph_coo(500, 3.0, seed=34), root=0,
        mode="sell")
    app("sssp_heavy_row", "sharded_sssp", _heavy, root=9, mode="sell")
    app("sssp_auto_power", "sharded_sssp",
        lambda p: (lambda g: g.with_values(np.abs(g.vals) + 0.1))(
            p.power_law_coo(1500, 9_000, alpha=1.5, seed=37)), root=0)
    return cases


@pytest.fixture(scope="module")
def results():
    out = {}
    for w in WORLDS:
        cases = _cases(w)
        names = sorted(cases)
        assert names == CASE_NAMES
        ranks = run_world(run_calls, w, device="cpu",
                          args=([cases[n][1] for n in names],), timeout_s=600)
        assert all(pickle.dumps(r) == pickle.dumps(ranks[0]) for r in ranks), \
            "ranks disagree"
        mesh = jp.make_mesh(w)
        out[w] = (dict(zip(names, ranks[0])), {n: cases[n][2](mesh) for n in names},
                  {n: cases[n][0] for n in names})
    return out


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_sell_mode_matches_jax(results, case, w):
    port, ref, kinds = results[w]
    got, want, kind = port[case], ref[case], kinds[case]
    if kind.startswith("dp"):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        if kind == "dp":
            np.testing.assert_array_equal(got, want)
            return
        coo = _virtual(jf) if kind == "dp_virtual" else _power(jf)
        x = _x(coo.shape[1], "plus_times", seed=42 if kind == "dp_virtual" else 32)
        bound = spmv_abs_bound(coo, x)
        tol = PT_DELTA * np.maximum(np.maximum(1.0, np.abs(want)), bound)
        assert np.all(np.abs(got - want) <= tol)
        return
    assert (got.iterations, got.converged) == (want.iterations, want.converged)
    np.testing.assert_array_equal(got.x, np.asarray(want.x))
    if want.aux is not None:
        np.testing.assert_array_equal(got.aux, np.asarray(want.aux))


def _same_sell(sharded, ref):
    op = sharded.panels
    assert (op.n_chunks, sharded.n_cols, sharded.chunk_rows, sharded.base_pad,
            sharded.n_rows) == (ref.n_chunks, ref.n_cols, ref.chunk_rows, ref.base_pad,
                                ref.n_rows)
    assert [tuple(lay) for lay in op.layouts] == [tuple(int(v) if i < 4 else bool(v)
                                                       for i, v in enumerate(lay))
                                                 for lay in ref.layouts]
    assert [s is None for s in op.slabs] == [s is None for s in ref.slabs]
    for s, r in zip(op.slabs, ref.slabs):
        if s is None:
            continue
        for k in ("chunk", "wordA", "wordB"):
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(r[k]), err_msg=k)
        v, rv = s["vals"], np.asarray(r["vals"])
        if v.dtype == torch.bfloat16:
            np.testing.assert_array_equal(v.view(torch.int16).numpy(), rv.view(np.int16))
        else:
            np.testing.assert_array_equal(v.numpy(), rv)
    for f in ("piece_owner", "virt_blocks"):
        a, b = getattr(op, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("matrix,name,value_dtype", [
    ("power", "plus_times", "float32"), ("power", "min_plus", "float32"),
    ("power", "or_and", "float32"), ("power", "plus_times", "bfloat16"),
    ("heavy", "min_plus", "float32"), ("virtual", "plus_times", "float32"),
])
def test_builder_arrays_equal_jax(shards, matrix, name, value_dtype):
    make = {"power": _power, "heavy": _heavy, "virtual": _virtual}[matrix]
    op, chunk = tss.build_sharded_sell(_values(tf, make(tf), name), TREG[name], shards,
                                       value_dtype=value_dtype, device="cpu")
    ref, rchunk = jss.build_sharded_sell(_values(jf, make(jf), name), JREG[name], shards,
                                         value_dtype=value_dtype)
    assert chunk == rchunk
    _same_sell(op, ref)
    if matrix == "heavy":
        assert op.panels.piece_owner is not None
    if matrix == "virtual":
        assert op.panels.virt_blocks is not None


def test_each_rank_plans_its_own_panels():
    """A rank's operand holds the plan of its own block, tensor-equal to the
    plan of that block built alone, and its slice of the stacked panels
    (identity padding included) for the plain version."""
    from sparseharness_tpu_torch.ops.sell2 import build_sell2

    coo = _heavy(tf)
    op, _ = tss.build_sharded_sell(coo, TREG["min_plus"], 2, device="cpu")
    for rank in range(2):
        mesh = Mesh(rank=rank, size=2, device=torch.device("cpu"), backend="gloo")
        local = tss.place_sell_shard(mesh, op)
        for s, stacked in zip(local.panels.slabs, op.panels.slabs):
            if s is not None:
                np.testing.assert_array_equal(s["wordA"].numpy(), stacked["wordA"][rank].numpy())
        sel = (coo.rows // op.chunk_rows) == rank
        alone = build_sell2(tf.coo_from_arrays(coo.rows[sel] - rank * op.chunk_rows,
                                               coo.cols[sel], coo.vals[sel],
                                               (op.chunk_rows, coo.shape[1])),
                            TREG["min_plus"], split_calls=False, device="cpu").plan
        for f in ("row_ptr", "row_dest", "cols", "vals", "owners", "piece_slot", "owner_done"):
            assert torch.equal(getattr(local.plan, f), getattr(alone, f)), f
        assert (local.plan.bin_rows, local.plan.bin_entries, local.plan.n_entries,
                local.plan.n_final) == (alone.bin_rows, alone.bin_entries, alone.n_entries,
                                        alone.n_final)
    assert op.ranks[0].plan.n_pieces and not op.ranks[1].plan.n_pieces


def test_stacked_pieces_fold_into_their_own_owners():
    """A rank with fewer pieces than another holds stacked piece owners
    that end in padding owned by row 0: the plain version folds each piece
    into its own owner all the same (min_plus, against the rows' minima)."""
    rng = np.random.default_rng(38)
    n, hubs = 2100, (9, 100, 2060)
    bg = tf.random_graph_coo(n, 2.0, seed=39)
    rows = np.r_[np.repeat(hubs, 400), bg.rows].astype(np.int32)
    cols = np.r_[np.concatenate([rng.choice(n, 400, replace=False) for _ in hubs]),
                 bg.cols].astype(np.int32)
    vals = rng.uniform(0.1, 1.0, rows.size).astype(np.float32)
    coo = tf.coo_from_arrays(rows, cols, vals, (n, n))
    op, chunk = tss.build_sharded_sell(coo, TREG["min_plus"], 2, device="cpu")
    assert 0 < op.ranks[1].plan.n_pieces < op.ranks[0].plan.n_pieces
    x = _x(n, "min_plus")
    s = tf.fold_duplicates(coo, np.minimum)
    want = np.full(2 * chunk, np.finfo(np.float32).max, np.float32)
    np.minimum.at(want, s.rows, x[s.cols] + s.vals)
    for rank in range(2):
        local = tss.place_sell_shard(Mesh(rank=rank, size=2, device=torch.device("cpu"),
                                          backend="gloo"), op)
        got = sell2.dp_sell2_plain(local, torch.from_numpy(x), TREG["min_plus"],
                                   n_rows=chunk)[:chunk]
        np.testing.assert_array_equal(got.numpy(), want[rank * chunk:(rank + 1) * chunk])


def test_rank_shard_is_made_once():
    op, _ = tss.build_sharded_sell(_power(tf), TREG["plus_times"], 2, device="cpu")
    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    a = tss.sell_shard(mesh, op)
    assert tss.sell_shard(mesh, op) is a
    assert tss.sell_shard(Mesh(rank=1, size=2, device=torch.device("cpu"), backend="gloo"),
                          op) is not a
    assert len(fixcore._SOLVER_CACHE[op]) == 2
