"""The port's frontier-compressed exchange (parallel/frontier.py) against
the JAX package's at the same shard count, as the frontier half of
tests/test_sell_frontier.py holds the JAX one: BFS and SSSP with the
fixed-budget all_to_all of the changed entries, the dense all-gather on
overflow, the phase switch and the byte accounting. Every field of the
result (x, aux, iterations, converged, the entries sent, the dense-phase
steps, the fallbacks and the local compute, sell or ell) equals JAX's.
The port runs in worlds of 2 and 4 gloo ranks on the CPU, one spawned
world a size; JAX on make_mesh(2) and make_mesh(4), its sell2 kernel in
interpret mode."""

import pickle
import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
import sparseharness_tpu.parallel as jp
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.parallel import Call, frontier as tfr, run_calls, run_world
from sparseharness_tpu_torch.semiring import MIN_PLUS, OR_AND, PLUS_TIMES

WORLDS = (2, 4)

#: name → (app, matrix, root, budget, local)
CASES = {
    # a long path: the frontier stays small, so the bytes are a sliver of
    # the all-gather's
    "bfs_band": ("bfs", lambda p: p.banded_coo(1024, 2, seed=3), 0, 512, "auto"),
    "bfs_graph": ("bfs", lambda p: p.random_graph_coo(900, 2.5, seed=9), 3, 256, "auto"),
    "sssp_graph": ("sssp", lambda p: p.random_graph_coo(800, 3.0, seed=11), 0, 256, "auto"),
    # a budget far below the frontier: dense steps after the switch
    "bfs_overflow": ("bfs", lambda p: p.random_graph_coo(1000, 3.0, seed=12), 0, 4, "auto"),
    # early frontiers overflow (the dense phase), later ones fit
    "sssp_phase_switch": ("sssp", lambda p: p.chained_power_law_coo(4096, clusters=16,
                                                                    seed=17), 0, 96, "auto"),
    "bfs_power_sell": ("bfs", lambda p: p.power_law_coo(3000, 9000, seed=13), 0, 512, "auto"),
    "bfs_power_ell": ("bfs", lambda p: p.power_law_coo(3000, 9000, seed=13), 0, 512, "ell"),
    "sssp_graph_sell": ("sssp", lambda p: p.random_graph_coo(1200, 4.0, seed=14), 0, 256,
                        "sell"),
}
CASE_NAMES = sorted(CASES)


def _port_call(name):
    app, make, root, budget, local = CASES[name]
    fn = tfr.frontier_bfs if app == "bfs" else tfr.frontier_sssp
    return Call(fn, dict(coo=make(tf), root=root, budget=budget, local=local))


def _jax(name, mesh):
    app, make, root, budget, local = CASES[name]
    fn = jp.frontier_bfs if app == "bfs" else jp.frontier_sssp
    return fn(make(jf), root=root, mesh=mesh, budget=budget, local=local)


@pytest.fixture(scope="module")
def results():
    out = {}
    for w in WORLDS:
        ranks = run_world(run_calls, w, device="cpu",
                          args=([_port_call(n) for n in CASE_NAMES],), timeout_s=600)
        assert all(pickle.dumps(r) == pickle.dumps(ranks[0]) for r in ranks), \
            "ranks disagree"
        mesh = jp.make_mesh(w)
        out[w] = (dict(zip(CASE_NAMES, ranks[0])), {n: _jax(n, mesh) for n in CASE_NAMES})
    return out


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_frontier_matches_jax(results, case, w):
    got, want = results[w][0][case], results[w][1][case]
    for f in ("iterations", "converged", "sent_entries", "dense_fallbacks",
              "dense_phase_iters", "local"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.x, np.asarray(want.x))
    if want.aux is not None:
        np.testing.assert_array_equal(got.aux, np.asarray(want.aux))
    n = got.x.shape[0]
    assert got.exchanged_bytes() == want.exchanged_bytes()
    assert got.allgather_bytes(n) == want.allgather_bytes(n)


@pytest.mark.parametrize("w", WORLDS)
def test_frontier_accounting(results, w):
    got = results[w][0]
    band = got["bfs_band"]
    assert band.dense_fallbacks == 0
    assert band.exchanged_bytes() * 100 < band.allgather_bytes(1024, 4)
    assert got["bfs_overflow"].dense_fallbacks > 0
    switch = got["sssp_phase_switch"]
    assert switch.dense_phase_iters >= 1
    assert switch.iterations > switch.dense_phase_iters and switch.sent_entries > 0
    assert got["bfs_power_sell"].local == "sell" and got["bfs_power_ell"].local == "ell"
    np.testing.assert_array_equal(got["bfs_power_sell"].x, got["bfs_power_ell"].x)


@pytest.mark.parametrize("shards", [2, 4])
def test_needed_columns_equal_jax(shards):
    from sparseharness_tpu.parallel.frontier import build_needed_cols as jneeded

    coo_t, coo_j = tf.random_graph_coo(900, 2.5, seed=9), jf.random_graph_coo(900, 2.5, seed=9)
    chunk = 1024 // shards
    np.testing.assert_array_equal(tfr.build_needed_cols(coo_t, shards, chunk).numpy(),
                                  np.asarray(jneeded(coo_j, shards, chunk)))


def test_frontier_refuses_a_non_monotone_semiring():
    assert tfr._monotone_apply(MIN_PLUS) == "amin"
    assert tfr._monotone_apply(OR_AND) == "amax"
    with pytest.raises(NotImplementedError):
        tfr._monotone_apply(PLUS_TIMES)


@pytest.mark.parametrize("local", ["auto", "sell", "ell", "bogus"])
def test_local_compute_choice_matches_jax(local):
    from sparseharness_tpu.parallel.frontier import _frontier_setup as jsetup
    from sparseharness_tpu.semiring import OR_AND as JOR

    coo_t, coo_j = tf.power_law_coo(3000, 9000, seed=13), jf.power_law_coo(3000, 9000, seed=13)
    if local == "bogus":
        with pytest.raises(ValueError):
            jsetup(coo_j, JOR, 2, local)
        with pytest.raises(ValueError):
            tfr._frontier_setup(coo_t, OR_AND, 2, local, device="cpu")
        return
    ref = jsetup(coo_j, JOR, 2, local)
    setup = tfr._frontier_setup(coo_t, OR_AND, 2, local, device="cpu")
    assert (setup.kind, setup.chunk) == (ref[4], ref[2])
    assert isinstance(setup.op.panels.slabs if setup.kind == "sell" else setup.op.cols,
                      (list, torch.Tensor))
