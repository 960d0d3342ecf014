"""The band mode of the port's sharded solvers (parallel/sharded_band.py)
against the JAX package's at the same shard count, as
tests/test_parallel_band.py holds the JAX one: the builder's arrays
(head, interior and tail strips, c0, k_win, halo, chunk, g_lo, g_hi)
equal JAX's; the sharded dp equals JAX's bit for bit on the six exact
semirings and within 1e-5 · max(1, |ref|, Σ|a·x|) on plus_times; the
fixpoints equal JAX's on x, iterations and converged (pagerank's x within
1e-6). The port runs in worlds of 2 and 4 gloo ranks on the CPU, one
spawned world a size for every case; JAX on make_mesh(2) and make_mesh(4)
of the conftest's virtual devices, its Pallas kernels in interpret mode."""

import pickle
import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
import sparseharness_tpu.parallel as jp
from sparseharness_tpu.gold import spmv_abs_bound
from sparseharness_tpu.parallel import sharded as js
from sparseharness_tpu.parallel import sharded_band as jb
from sparseharness_tpu.semiring import REGISTRY as JREG
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.parallel import Call, fixcore, run_calls, run_world
from sparseharness_tpu_torch.parallel import sharded as ts
from sparseharness_tpu_torch.parallel import sharded_band as tb
from sparseharness_tpu_torch.parallel.mesh import Mesh
from sparseharness_tpu_torch.semiring import REGISTRY as TREG

WORLDS = (2, 4)
PT_DELTA = 1e-5
FLT_MAX = float(np.finfo(np.float32).max)


def _with_values(pkg, coo, name):
    """The JAX test's values for semiring ``name`` (ints 1..50, bools,
    positive floats for max_times)."""
    np_dtype = np.dtype(TREG[name].np_dtype)
    vals = coo.vals
    if np_dtype == np.bool_:
        return coo.with_values(vals != 0)
    if np.issubdtype(np_dtype, np.integer):
        return coo.with_values((np.abs(vals * 100).astype(np.int32) % 50 + 1).astype(np_dtype))
    if name == "max_times":
        vals = np.abs(vals) + 0.1
    return coo.with_values(vals.astype(np_dtype))


def _x_for(name, n, seed=1):
    rng = np.random.default_rng(seed)
    np_dtype = np.dtype(TREG[name].np_dtype)
    if np_dtype == np.bool_:
        return rng.random(n) < 0.3
    if np.issubdtype(np_dtype, np.integer):
        return rng.integers(0, 100, n).astype(np_dtype)
    return rng.uniform(0.1, 1.0, n).astype(np_dtype)


def _band(pkg):
    # 4096 rows, band 5: at 2 and 4 ranks (chunk 2048, 1024; halo 128)
    # every rank has head, interior and tail groups
    return pkg.banded_coo(4096, 5, seed=0)


def _positive(pkg, coo):
    return coo.with_values(np.abs(coo.vals) + 0.1)


def _x0_sssp(n, root=0):
    x0 = np.full(n, FLT_MAX, np.float32)
    x0[root] = 0.0
    return x0


def _cases(w):
    """name → (kind, port Call, JAX solve(mesh)) at world size w."""
    cases = {}
    for name in sorted(TREG):
        tc, jc = _with_values(tf, _band(tf), name), _with_values(jf, _band(jf), name)
        x = _x_for(name, tc.shape[1])
        op = tb.build_sharded_band(tc, TREG[name], w, device="cpu")[0]
        kind = "dp_tol" if name == "plus_times" else "dp"
        cases[f"spmv_{name}"] = (kind, Call(tb.sharded_spmv_band, dict(
            op=op, x=x, sr=TREG[name], n_rows=tc.shape[0])),
            lambda m, jc=jc, x=x, name=name: jp.sharded_spmv_band(
                m, jp.build_sharded_band(jc, JREG[name], w)[0],
                jnp.asarray(x, JREG[name].dtype), JREG[name], jc.shape[0]))
    # the streamed kernel path (x read through L1/L2), forced on every part
    x = _x_for("min_plus", 4096)
    op = tb.build_sharded_band(_band(tf), TREG["min_plus"], w, device="cpu")[0]
    cases["spmv_streamed_min_plus"] = ("dp", Call(tb.sharded_spmv_band, dict(
        op=dataclasses.replace(op, windowed=True), x=x, sr=TREG["min_plus"], n_rows=4096)),
        lambda m, x=x: jp.sharded_spmv_band(
            m, jp.build_sharded_band(_band(jf), JREG["min_plus"], w)[0], jnp.asarray(x),
            JREG["min_plus"], 4096))
    # the halo ELL's dp (plain gather) against JAX's
    x = _x_for("plus_times", 4096)
    hop = ts.build_sharded_ell_halo(_band(tf), TREG["plus_times"], w, device="cpu")[0]
    cases["spmv_halo_plus_times"] = ("dp_tol", Call(ts.sharded_spmv_halo, dict(
        op=hop, x=x, sr=TREG["plus_times"], n_rows=4096)),
        lambda m, x=x: jp.sharded_spmv_halo(
            m, jp.build_sharded_ell_halo(_band(jf), JREG["plus_times"], w)[0],
            jnp.asarray(x), JREG["plus_times"], 4096))

    def app(name, fn, make, **kw):
        cases[name] = ("fix_pr" if fn == "sharded_pagerank" else "fix", Call(
            getattr(ts, fn), dict(coo=make(tf), **kw)),
            lambda m: getattr(jp, fn)(make(jf), mesh=m, **kw))

    app("sssp_band", "sharded_sssp", lambda p: p.banded_coo(4096, 60, seed=2),
        root=0, mode="band")
    app("bfs_band", "sharded_bfs", lambda p: p.banded_coo(4096, 40, seed=3),
        root=7, mode="band")
    app("pagerank_band", "sharded_pagerank", lambda p: p.banded_coo(1024, 4, seed=4),
        mode="band")
    app("sssp_auto_band", "sharded_sssp",
        lambda p: _positive(p, p.banded_coo(640, 20, seed=21)), root=5, mode="auto")
    app("eigenvector_halo", "sharded_eigenvector",
        lambda p: _positive(p, p.banded_coo(512, 2, seed=25)), mode="halo", max_iter=40)

    # the direct solver, split and unsplit
    coo = tf.banded_coo(4096, 50, seed=6)
    op = tb.build_sharded_band(coo, TREG["min_plus"], w, device="cpu")[0]
    x0 = _x0_sssp(4096)
    for name, top, jmake in (
            ("fixpoint_band_direct", op,
             lambda: jp.build_sharded_band(jf.banded_coo(4096, 50, seed=6),
                                           JREG["min_plus"], w)[0]),
            ("fixpoint_band_unsplit", tb.without_overlap_split(op),
             lambda: jb.without_overlap_split(jp.build_sharded_band(
                 jf.banded_coo(4096, 50, seed=6), JREG["min_plus"], w)[0]))):
        cases[name] = ("fix", Call(tb.sharded_fixpoint_band, dict(
            op=top, x0=x0, sr=TREG["min_plus"], n_rows=4096, combine=ts.combine_min,
            exact=True, max_iter=4097)),
            lambda m, jmake=jmake: jp.sharded_fixpoint_band(
                m, jmake(), x0, JREG["min_plus"], n_rows=4096, combine=js.combine_min,
                exact=True, max_iter=4097))
    # full SCC on the gather mode
    cases["scc_gather"] = ("scc", Call(ts.sharded_scc, dict(
        coo=tf.random_graph_coo(300, 3.0, seed=5), mode="gather")),
        lambda m: jp.sharded_scc(jf.random_graph_coo(300, 3.0, seed=5), mesh=m,
                                 mode="gather"))
    return cases


CASE_NAMES = sorted([f"spmv_{name}" for name in TREG] + [
    "spmv_streamed_min_plus", "spmv_halo_plus_times", "sssp_band", "bfs_band",
    "pagerank_band", "sssp_auto_band", "eigenvector_halo", "fixpoint_band_direct",
    "fixpoint_band_unsplit", "scc_gather"])


@pytest.fixture(scope="module")
def results():
    """{w: (port results by case, JAX results by case)}: one world a size."""
    out = {}
    for w in WORLDS:
        cases = _cases(w)
        names = sorted(cases)
        assert names == CASE_NAMES
        ranks = run_world(run_calls, w, device="cpu", args=([cases[n][1] for n in names],),
                          timeout_s=600)
        assert all(pickle.dumps(r) == pickle.dumps(ranks[0]) for r in ranks), \
            "ranks disagree"
        mesh = jp.make_mesh(w)
        out[w] = (dict(zip(names, ranks[0])),
                  {n: cases[n][2](mesh) for n in names}, {n: cases[n][0] for n in names})
    return out


def _check_dp(kind, got, ref, case, w):
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if kind == "dp":
        np.testing.assert_array_equal(got, ref)
        return
    # both plus_times cases: the band's own values, x of _x_for
    bound = spmv_abs_bound(_band(jf), _x_for("plus_times", 4096))
    tol = PT_DELTA * np.maximum(np.maximum(1.0, np.abs(ref)), bound)
    assert np.all(np.abs(got - ref) <= tol), (case, w)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_band_mode_matches_jax(results, case, w):
    port, ref, kinds = results[w]
    got, want, kind = port[case], ref[case], kinds[case]
    if kind.startswith("dp"):
        _check_dp(kind, got, want, case, w)
        return
    if kind == "scc":
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a.x, np.asarray(b.x))
            assert (a.iterations, a.converged) == (b.iterations, b.converged)
        return
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    if kind == "fix_pr":
        assert np.abs(got.x - np.asarray(want.x)).max() <= 1e-6
    elif case == "eigenvector_halo":
        # plus_times norms: the x within the plus_times tolerance
        assert np.abs(got.x - np.asarray(want.x)).max() <= PT_DELTA
    else:
        np.testing.assert_array_equal(got.x, np.asarray(want.x))
    if want.aux is not None:
        np.testing.assert_array_equal(got.aux, np.asarray(want.aux))


def test_split_and_unsplit_agree(results):
    for w in WORLDS:
        port = results[w][0]
        a, b = port["fixpoint_band_direct"], port["fixpoint_band_unsplit"]
        np.testing.assert_array_equal(a.x, b.x)
        assert a.iterations == b.iterations


# ----------------------------------------------------------------- builder


def _bits(t):
    """A strip array's bits, from a torch tensor or a JAX array."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


BUILDS = [(s, name, vd) for s in (2, 4, 8)
          for name, vd in (("plus_times", "float32"), ("min_plus", "float32"),
                           ("or_and", "float32"), ("max_right", "float32"),
                           ("plus_times", "bfloat16"))]


@pytest.mark.parametrize("shards,name,value_dtype", BUILDS)
def test_builder_arrays_equal_jax(shards, name, value_dtype):
    tc, jc = _with_values(tf, _band(tf), name), _with_values(jf, _band(jf), name)
    op, chunk = tb.build_sharded_band(tc, TREG[name], shards, value_dtype=value_dtype,
                                      device="cpu")
    ref, rchunk = jp.build_sharded_band(jc, JREG[name], shards, value_dtype=value_dtype)
    assert chunk == rchunk
    for f in ("c0", "k_win", "halo", "chunk", "bn", "g_lo", "g_hi"):
        assert getattr(op, f) == getattr(ref, f), f
    for f in ("strips_head", "strips_int", "strips_tail"):
        got, want = _bits(getattr(op, f)), _bits(getattr(ref, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    unsplit, runsplit = tb.without_overlap_split(op), jb.without_overlap_split(ref)
    np.testing.assert_array_equal(_bits(unsplit.strips_tail), _bits(runsplit.strips_tail))
    assert (unsplit.g_lo, unsplit.g_hi) == (runsplit.g_lo, runsplit.g_hi) == (0, 0)


@pytest.mark.parametrize("make", [
    lambda p: p.random_graph_coo(300, 3.0, seed=22),       # scattered: halo > chunk
    lambda p: p.banded_coo(4096, 600, seed=1),             # a window of 11 blocks
], ids=["scattered", "wide"])
def test_builder_refuses_as_jax(make):
    with pytest.raises(NotImplementedError):
        jp.build_sharded_band(make(jf), JREG["min_plus"], 4)
    with pytest.raises(NotImplementedError):
        tb.build_sharded_band(make(tf), TREG["min_plus"], 4, device="cpu")


def test_each_part_has_its_own_span_table():
    op, _ = tb.build_sharded_band(_band(tf), TREG["min_plus"], 4, device="cpu")
    mesh = Mesh(rank=1, size=4, device=torch.device("cpu"), backend="gloo")
    shard = tb.place_band_shard(mesh, op, TREG["min_plus"])
    for part, strips in ((shard.head, op.strips_head), (shard.interior, op.strips_int),
                         (shard.tail, op.strips_tail)):
        assert part.spans.strips is part.strips
        torch.testing.assert_close(part.strips, strips[1], rtol=0, atol=0)
    assert shard.interior.c0 == op.c0 + op.g_lo - op.halo // op.bn
    assert shard.tail.c0 == op.c0 + op.g_hi


def test_solver_cache_holds_per_operand():
    """The one-shot solver of a (mesh, operand, semiring) is made once, and
    what was made for an operand goes with it."""
    op, _ = tb.build_sharded_band(_band(tf), TREG["plus_times"], 2, device="cpu")
    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    s1 = tb._spmv_solver(mesh, op, TREG["plus_times"])
    assert tb._spmv_solver(mesh, op, TREG["plus_times"]) is s1
    assert tb._spmv_solver(mesh, op, TREG["min_plus"]) is not s1
    n_before = len(fixcore._SOLVER_CACHE)
    del op, s1
    gc.collect()
    assert len(fixcore._SOLVER_CACHE) == n_before - 1
