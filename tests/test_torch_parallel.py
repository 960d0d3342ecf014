"""The port's sharded solvers (parallel/) against the JAX package's at the
same shard count, as tests/test_parallel.py holds the JAX ones: the gather
and halo ELL modes, the app wrappers in every mode "auto" picks, the
automatically sharded SpMV, the batched multi-source solves, the
checkpoint and the weak-scaling report. The builders' arrays equal JAX's;
exact semirings match bit for bit, plus_times within 1e-5 · max(1, |ref|,
Σ|a·x|); fixpoints match on x, iterations and converged (pagerank's x
within 1e-6). The port runs in worlds of 2 and 4 gloo ranks on the CPU,
one spawned world a size for every case (and the scaling report's own
worlds); JAX on make_mesh(2) and make_mesh(4) of the conftest's virtual
devices."""

import pickle
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
import sparseharness_tpu.parallel as jp
from sparseharness_tpu.gold import spmv_abs_bound
from sparseharness_tpu.parallel import sharded as js
from sparseharness_tpu.semiring import MIN_PLUS as JMP, PLUS_TIMES as JPT
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.parallel import Call, run_calls, run_world
from sparseharness_tpu_torch.parallel import auto_sharded_spmv as t_auto_sharded_spmv
from sparseharness_tpu_torch.parallel import sharded as ts
from sparseharness_tpu_torch.parallel.mesh import Mesh
from sparseharness_tpu_torch.semiring import MIN_PLUS as TMP, PLUS_TIMES as TPT

WORLDS = (2, 4)
PT_DELTA = 1e-5
FLT_MAX = float(np.finfo(np.float32).max)


def _graph(p):
    return p.random_graph_coo(300, 3.0, seed=11)


def _positive(p, coo):
    return coo.with_values(np.abs(coo.vals) + 0.1)


def _shuffled(p):
    band = _positive(p, p.banded_coo(320, 2, seed=23))
    scramble = np.random.default_rng(24).permutation(320).astype(np.int32)
    return p.permute_coo(band, scramble)


def _x(seed, n, lo=0.2):
    return np.random.default_rng(seed).uniform(lo, 1.0, n).astype(np.float32)


def _x0_sssp(n, root):
    x0 = np.full(n, FLT_MAX, np.float32)
    x0[root] = 0.0
    return x0


CASE_NAMES = sorted([
    "spmv_gather_plus_times", "spmv_gather_min_plus", "auto_spmv", "sssp", "bfs",
    "pagerank", "eigenvector", "halo_fixpoint_sssp", "sssp_halo_band", "sssp_rcm_halo",
    "sssp_shuffled", "multi_sssp", "multi_bfs", "multi_sssp_rcm", "multi_sssp_tiles",
    "multi_sssp_gather", "multi_bfs_tiles", "ckpt_partial", "ckpt_resumed", "ckpt_direct",
])


def _cases(w, ckpt):
    """name → (kind, port Call, JAX solve(mesh)) at world size w."""
    cases = {}
    g_t, g_j = _graph(tf), _graph(jf)
    n = g_t.shape[0]
    for sr_t, sr_j, seed, lo, kind in ((TPT, JPT, 0, 0.2, "dp_tol"),
                                       (TMP, JMP, 1, 0.0, "dp")):
        x = _x(seed, n, lo)
        op = ts.build_sharded_ell(g_t, sr_t, w, device="cpu")[0]
        cases[f"spmv_gather_{sr_t.name}"] = (kind, Call(ts.sharded_spmv, dict(
            op=op, x=x, sr=sr_t, n_rows=n)),
            lambda m, x=x, sr_j=sr_j: jp.sharded_spmv(
                m, jp.build_sharded_ell(g_j, sr_j, w)[0], jnp.asarray(x), sr_j, n_rows=n))
    x = _x(2, n)
    cases["auto_spmv"] = ("dp_tol", Call(t_auto_sharded_spmv, dict(
        coo=g_t, sr=TPT, x=x)), lambda m, x=x: jp.auto_sharded_spmv(m, g_j, JPT, x))

    def app(name, fn, make, kind="fix", **kw):
        cases[name] = (kind, Call(getattr(ts, fn), dict(coo=make(tf), **kw)),
                       lambda m: getattr(jp, fn)(make(jf), mesh=m, **kw))

    app("sssp", "sharded_sssp", _graph, root=0)
    app("bfs", "sharded_bfs", _graph, root=0)
    app("pagerank", "sharded_pagerank", _graph, kind="fix_pr")
    app("eigenvector", "sharded_eigenvector", lambda p: p.random_coo(120, 120, 900, seed=3),
        kind="fix_tol", max_iter=60)
    app("sssp_halo_band", "sharded_sssp", lambda p: _positive(p, p.banded_coo(320, 2, seed=21)),
        root=5, mode="halo")
    app("sssp_rcm_halo", "sharded_sssp", _shuffled, root=7, reorder="rcm", mode="halo")
    app("sssp_shuffled", "sharded_sssp", _shuffled, root=7)
    app("multi_sssp", "sharded_multi_sssp", _graph, roots=[0, 7, 42])
    app("multi_bfs", "sharded_multi_bfs", _graph, roots=[3, 11])
    app("multi_sssp_rcm", "sharded_multi_sssp", _graph, roots=[0, 9], reorder="rcm")
    app("multi_sssp_tiles", "sharded_multi_sssp", _graph, roots=[0, 7, 42], mode="tiles")
    app("multi_sssp_gather", "sharded_multi_sssp", _graph, roots=[0, 7, 42], mode="gather")
    app("multi_bfs_tiles", "sharded_multi_bfs", _graph, roots=[3, 11], mode="tiles")

    # the halo solver directly
    band_t, band_j = tf.banded_coo(256, 4, seed=6), jf.banded_coo(256, 4, seed=6)
    x0 = _x0_sssp(256, 0)
    hop = ts.build_sharded_ell_halo(band_t, TMP, w, device="cpu")[0]
    cases["halo_fixpoint_sssp"] = ("fix", Call(ts.sharded_fixpoint_halo, dict(
        op=hop, x0=x0, sr=TMP, n_rows=256, combine=ts.combine_min, exact=True, max_iter=300)),
        lambda m, band_j=band_j, x0=x0: jp.sharded_fixpoint_halo(
            m, jp.build_sharded_ell_halo(band_j, JMP, w)[0], x0, JMP, n_rows=256,
            combine=js.combine_min, exact=True, max_iter=300))

    # the checkpoint: a few chunks, then a resume, beside the direct solve
    band_t = _positive(tf, tf.banded_coo(160, 2, seed=41))
    band_j = _positive(jf, jf.banded_coo(160, 2, seed=41))
    x0 = _x0_sssp(160, 3)
    op = ts.build_sharded_ell(band_t, TMP, w, device="cpu")[0]
    path = os.path.join(ckpt, f"solve{w}")
    kw = dict(sr=TMP, n_rows=160, combine=ts.combine_min)

    def jax_ckpt(m, **extra):
        return jp.sharded_fixpoint_checkpointed(
            jp.sharded_fixpoint, m, jp.build_sharded_ell(band_j, JMP, w)[0], x0, JMP,
            n_rows=160, combine=js.combine_min, ckpt_path=path + "_jax", **extra)

    cases["ckpt_partial"] = ("fix", Call(ts.sharded_fixpoint_checkpointed, dict(
        solver=ts.sharded_fixpoint, op=op, x0=x0, ckpt_path=path, every=3, max_iter=6, **kw)),
        lambda m: jax_ckpt(m, every=3, max_iter=6))
    cases["ckpt_resumed"] = ("fix", Call(ts.sharded_fixpoint_checkpointed, dict(
        solver=ts.sharded_fixpoint, op=op, x0=x0, ckpt_path=path, every=50, max_iter=10_000,
        **kw)), lambda m: jax_ckpt(m, every=50, max_iter=10_000))
    cases["ckpt_direct"] = ("fix", Call(ts.sharded_fixpoint, dict(
        op=op, x0=x0, exact=True, max_iter=10_000, **kw)),
        lambda m: jp.sharded_fixpoint(m, jp.build_sharded_ell(band_j, JMP, w)[0], x0, JMP,
                                      n_rows=160, combine=js.combine_min, exact=True,
                                      max_iter=10_000))
    return cases


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{w: (port results, JAX results, kinds)}: one spawned world a size."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    out = {}
    for w in WORLDS:
        cases = _cases(w, ckpt)
        names = sorted(cases)
        assert names == CASE_NAMES
        # an interrupted solve leaves a checkpoint (refused below for another root)
        cut = Call(ts.sharded_fixpoint_checkpointed, dict(
            solver=ts.sharded_fixpoint, op=cases["ckpt_direct"][1].kwargs["op"],
            x0=_x0_sssp(160, 3), sr=TMP, n_rows=160, combine=ts.combine_min,
            ckpt_path=os.path.join(ckpt, f"solve{w}_cut"), every=1, max_iter=1))
        ranks = run_world(run_calls, w, device="cpu",
                          args=([cases[n][1] for n in names] + [cut],), timeout_s=600)
        assert all(pickle.dumps(r) == pickle.dumps(ranks[0]) for r in ranks), \
            "ranks disagree"
        got = dict(zip(names + ["ckpt_cut"], ranks[0]))
        mesh = jp.make_mesh(w)
        ref = {n: cases[n][2](mesh) for n in names}
        out[w] = (got, ref, {n: cases[n][0] for n in names}, ckpt)
    return out


def _check(kind, got, want, bound=None):
    if kind in ("dp", "dp_tol"):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        if kind == "dp":
            np.testing.assert_array_equal(got, want)
        else:
            tol = PT_DELTA * np.maximum(np.maximum(1.0, np.abs(want)), bound)
            assert np.all(np.abs(got - want) <= tol)
        return
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    wx = np.asarray(want.x)
    assert got.x.dtype == wx.dtype and got.x.shape == wx.shape
    if kind == "fix_pr":
        assert np.abs(got.x - wx).max() <= 1e-6
    elif kind == "fix_tol":
        assert np.abs(got.x - wx).max() <= PT_DELTA
    else:
        np.testing.assert_array_equal(got.x, wx)
    if want.aux is not None:
        np.testing.assert_array_equal(got.aux, np.asarray(want.aux))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_sharded_matches_jax(results, case, w):
    got, ref, kinds, _ = results[w]
    bound = None
    if kinds[case] == "dp_tol":
        seed = 2 if case == "auto_spmv" else 0
        bound = spmv_abs_bound(_graph(jf), _x(seed, 300))
    _check(kinds[case], got[case], ref[case], bound)


@pytest.mark.parametrize("w", WORLDS)
def test_checkpoint_resumes_and_goes(results, w):
    got, _, _, ckpt = results[w]
    assert not got["ckpt_partial"].converged and got["ckpt_partial"].iterations == 6
    assert got["ckpt_resumed"].converged and got["ckpt_resumed"].iterations > 6
    np.testing.assert_array_equal(got["ckpt_resumed"].x, got["ckpt_direct"].x)
    # the converged solve's checkpoint is gone, the cut one stays, with the
    # JAX package's keys and fingerprint
    assert not os.path.exists(os.path.join(ckpt, f"solve{w}.npz"))
    with np.load(os.path.join(ckpt, f"solve{w}_cut.npz")) as data:
        assert sorted(data.files) == ["fingerprint", "iteration", "x"]
        assert int(data["iteration"]) == got["ckpt_cut"].iterations == 1
        op = js.build_sharded_ell(_positive(jf, jf.banded_coo(160, 2, seed=41)), JMP, w)[0]
        assert str(data["fingerprint"]) == js._fingerprint(_x0_sssp(160, 3), op)
    # ... and refuses another root before any exchange, so a mesh of this
    # process alone can ask
    op = ts.build_sharded_ell(_positive(tf, tf.banded_coo(160, 2, seed=41)), TMP, w,
                              device="cpu")[0]
    mesh = Mesh(rank=0, size=w, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="different problem"):
        ts.sharded_fixpoint_checkpointed(
            ts.sharded_fixpoint, mesh, op, _x0_sssp(160, 5), TMP, n_rows=160,
            combine=ts.combine_min, ckpt_path=os.path.join(ckpt, f"solve{w}_cut"),
            every=1, max_iter=2)


# ------------------------------------------------------- builders and modes


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "or_and", "max_right"])
def test_ell_builders_equal_jax(shards, sr_name):
    from sparseharness_tpu.semiring import REGISTRY as JREG
    from sparseharness_tpu_torch.semiring import REGISTRY as TREG

    g_t, g_j = _graph(tf), _graph(jf)
    op, chunk = ts.build_sharded_ell(g_t, TREG[sr_name], shards, device="cpu")
    ref, rchunk = jp.build_sharded_ell(g_j, JREG[sr_name], shards)
    assert chunk == rchunk
    for f in ("cols", "vals"):
        np.testing.assert_array_equal(getattr(op, f).numpy(), np.asarray(getattr(ref, f)))
    band_t, band_j = tf.banded_coo(512, 6, seed=8), jf.banded_coo(512, 6, seed=8)
    hop, hchunk = ts.build_sharded_ell_halo(band_t, TREG[sr_name], shards, device="cpu")
    href, hrchunk = jp.build_sharded_ell_halo(band_j, JREG[sr_name], shards)
    assert (hop.halo, hchunk) == (href.halo, hrchunk)
    for f in ("cols", "vals"):
        np.testing.assert_array_equal(getattr(hop, f).numpy(), np.asarray(getattr(href, f)))
    assert ts._fingerprint(_x0_sssp(300, 1), op) == js._fingerprint(_x0_sssp(300, 1), ref)


def test_halo_builder_refuses_as_jax():
    with pytest.raises(ValueError):
        jp.build_sharded_ell_halo(_shuffled(jf), JMP, 4)
    with pytest.raises(ValueError):
        ts.build_sharded_ell_halo(_shuffled(tf), TMP, 4, device="cpu")


@pytest.mark.parametrize("mode", ["auto", "band", "sell", "halo", "gather"])
@pytest.mark.parametrize("matrix", ["band", "graph"])
def test_mode_choice_matches_jax(mode, matrix):
    """Each mode builds the operand JAX's builds, or refuses as JAX does."""
    make = {"band": lambda p: _positive(p, p.banded_coo(320, 2, seed=21)),
            "graph": lambda p: p.random_graph_coo(300, 3.0, seed=22)}[matrix]
    try:
        jop, jsolver = js._build_sharded_auto(make(jf), JMP, 4, mode)
    except (NotImplementedError, ValueError) as e:
        with pytest.raises(type(e)):
            ts._build_sharded_auto(make(tf), TMP, 4, mode, device="cpu")
        return
    op, solver = ts._build_sharded_auto(make(tf), TMP, 4, mode, device="cpu")
    assert solver.__name__ == jsolver.__name__
    assert type(op).__name__ == type(jop).__name__


@pytest.mark.parametrize("mode", ["band", "sell", "bogus"])
def test_multi_source_refuses_modes_as_jax(mode):
    err = NotImplementedError if mode != "bogus" else ValueError
    with pytest.raises(err):
        js._build_sharded_spmm(_graph(jf), JMP, 2, mode)
    with pytest.raises(err):
        ts._build_sharded_spmm(_graph(tf), TMP, 2, mode, device="cpu")


def test_tile_builder_refuses_scattered_as_jax():
    from sparseharness_tpu.parallel.sharded_spmm import build_sharded_spmm_tiles as jbuild
    from sparseharness_tpu_torch.parallel.sharded_spmm import build_sharded_spmm_tiles

    with pytest.raises(NotImplementedError):
        jbuild(jf.power_law_coo(50000, 100000, alpha=1.1, seed=4), JMP, 8)
    with pytest.raises(NotImplementedError):
        build_sharded_spmm_tiles(tf.power_law_coo(50000, 100000, alpha=1.1, seed=4), TMP, 8,
                                 device="cpu")


@pytest.mark.parametrize("shards", [2, 4])
def test_tile_builder_equals_jax(shards):
    from sparseharness_tpu.parallel.sharded_spmm import build_sharded_spmm_tiles as jbuild
    from sparseharness_tpu_torch.parallel.sharded_spmm import build_sharded_spmm_tiles

    op = build_sharded_spmm_tiles(_graph(tf), TMP, shards, device="cpu")
    ref = jbuild(_graph(jf), JMP, shards)
    assert (op.chunk_rows, op.n_cols) == (ref.chunk_rows, ref.n_cols)
    np.testing.assert_array_equal(op.tiles.numpy(), np.asarray(ref.tiles))
    np.testing.assert_array_equal(op.tile_cols.numpy(), np.asarray(ref.tile_cols))


def test_weak_scaling_mechanics():
    """On the CPU the report checks the mechanics (build, partition,
    exchange, timing) and prints no efficiency."""
    from sparseharness_tpu_torch.harness.scaling import report, weak_scaling_spmv

    pts = weak_scaling_spmv(base_rows=512, device_counts=[1, 2], inner_iters=1,
                            kernel="band", device="cpu", timeout_s=300)
    assert [p.n_devices for p in pts] == [1, 2]
    assert pts[1].rows == 2 * pts[0].rows
    assert all(p.efficiency is None and p.shared and p.seconds_per_op > 0 for p in pts)
    text = report(pts)
    assert "efficiency" in text and "no device efficiency" in text
