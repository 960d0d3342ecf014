"""The port's process worlds, as tests/test_distributed.py holds the JAX
package's multi-process bring-up: two processes join one world through
``init_distributed`` over a local TCP coordinator and solve SSSP across
it, equal to JAX's sharded solve at the same shard count. Beside it, the
launcher (parallel/launch.py:run_world): a rank that raises, dies or hangs
ends its world within the timeout, with that rank's report; the mesh's
rules (a card a rank under NCCL, refused as JAX's make_mesh refuses more
devices than it has; the host copy under gloo on a card; the identity
ring at world size 1)."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import sparseharness_tpu.formats as jf
import sparseharness_tpu.parallel as jp
from sparseharness_tpu.gold.algorithms import sssp_gold
import sparseharness_tpu_torch.formats as tf
from sparseharness_tpu_torch.parallel import Call, RankFailed, comm, fixcore, mesh as tmesh
from sparseharness_tpu_torch.parallel import run_calls, run_world
from sparseharness_tpu_torch.parallel import sharded as ts

REPO = Path(__file__).resolve().parents[1]

_WORKER = r"""
import sys
import numpy as np
pid, port = int(sys.argv[1]), sys.argv[2]
from sparseharness_tpu_torch.parallel import init_distributed, make_mesh, sharded_sssp
init_distributed(coordinator_address=f"localhost:{port}", num_processes=2,
                 process_id=pid, device="cpu")
from sparseharness_tpu_torch.formats import random_graph_coo
mesh = make_mesh(device="cpu")
assert (mesh.rank, mesh.size, mesh.backend) == (pid, 2, "gloo"), mesh
res = sharded_sssp(random_graph_coo(96, 2.0, seed=21), root=0, mesh=mesh, mode="gather")
if pid == 0:
    print("RESULT " + " ".join(str(v) for v in res.x.numpy().view(np.int32)))
    print(f"STEPS {res.iterations} {res.converged}")
# rank 0 serves the TCP store: no rank leaves before every rank is done
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def test_two_process_world_over_tcp_matches_jax():
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(pid), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
                              env=env, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\n{out}\n{err}"
    lines = outs[0][1].splitlines()
    bits = np.array([int(v) for v in next(ln for ln in lines if ln.startswith("RESULT "))
                     .split()[1:]], np.int32)
    steps, converged = next(ln for ln in lines if ln.startswith("STEPS ")).split()[1:]
    g = jf.random_graph_coo(96, 2.0, seed=21)
    ref = jp.sharded_sssp(g, root=0, mesh=jp.make_mesh(2), mode="gather")
    np.testing.assert_array_equal(bits.view(np.float32), np.asarray(ref.x))
    assert (int(steps), converged == "True") == (ref.iterations, ref.converged)
    np.testing.assert_allclose(bits.view(np.float32), sssp_gold(g, 0), rtol=1e-5)


def test_a_rank_that_raises_ends_its_world():
    """Every rank refuses the root; the first report names the error."""
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="IndexError: index 1000000 is out of bounds"):
        run_world(run_calls, 2, device="cpu", timeout_s=120, args=(
            [Call(ts.sharded_sssp, dict(coo=tf.random_graph_coo(50, 2.0, seed=1),
                                        root=10 ** 6))],))
    assert time.monotonic() - t0 < 120


def test_a_rank_that_dies_ends_its_world():
    # sys.exit(mesh) ends each rank's process with code 1 before it reports
    with pytest.raises(RankFailed, match="exited with code 1"):
        run_world(sys.exit, 2, device="cpu", timeout_s=120)


def test_a_world_that_outlives_its_timeout_is_ended():
    """A solve of thousands of steps outlives a timeout of seconds: the
    ranks are killed and the caller hears of it soon after the timeout."""
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match="did not finish within 8"):
        run_world(run_calls, 2, device="cpu", timeout_s=8, args=(
            [Call(ts.sharded_sssp, dict(coo=tf.banded_coo(200_000, 1, seed=2), root=0,
                                        mode="gather"))],))
    assert time.monotonic() - t0 < 8 + 45


def test_a_world_returns_each_ranks_result():
    """The ranks of one world see one mesh, in rank order."""
    out = run_world(run_calls, 3, device="cpu", args=([Call(fixcore.mesh_key)],))
    assert [r[0] for r in out] == [(0, 3, "cpu", "gloo"), (1, 3, "cpu", "gloo"),
                                   (2, 3, "cpu", "gloo")]


def _fake_cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_more_nccl_ranks_than_cards_are_refused_as_jax(monkeypatch):
    with pytest.raises(ValueError) as jax_err:
        jp.make_mesh(9)  # the conftest's 8 virtual devices
    _fake_cards(monkeypatch, 8)
    with pytest.raises(ValueError) as port_err:
        tmesh.rank_devices(9, device="cuda")
    assert str(port_err.value) == str(jax_err.value) == "requested 9 devices, have 8"
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        tmesh.rank_devices(3, [2, 5], device="cuda")
    with pytest.raises(ValueError, match="out of range"):
        tmesh.rank_devices(1, [8], device="cuda")


def test_card_per_rank_and_sharing_under_gloo(monkeypatch):
    _fake_cards(monkeypatch, 2)
    assert [str(d) for d in tmesh.rank_devices(2, device="cuda")] == ["cuda:0", "cuda:1"]
    assert [str(d) for d in tmesh.rank_devices(2, [1], device="cuda", backend="gloo")] == [
        "cuda:1", "cuda:1"]
    assert tmesh.rank_devices(4, device="cpu") == [torch.device("cpu")] * 4
    assert tmesh.default_backend(torch.device("cuda")) == "nccl"
    assert tmesh.default_backend(torch.device("cpu")) == "gloo"


def test_host_copy_is_the_backends_rule():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert tmesh.Mesh(0, 2, card, "gloo").host_copy
    assert not tmesh.Mesh(0, 2, card, "nccl").host_copy
    assert not tmesh.Mesh(0, 2, cpu, "gloo").host_copy


def test_ring_at_world_size_one_is_the_identity():
    mesh = tmesh.Mesh(0, 1, torch.device("cpu"), "gloo")
    right, left = torch.arange(4.0), torch.arange(4.0, 8.0)
    from_left, from_right = comm.start_ring_exchange(mesh, right, left)()
    assert from_left is right and from_right is left


def test_entry_points_need_a_world_for_more_than_one_rank():
    """Without a process group a mesh is this process alone; a mesh of more
    ranks needs run_world (the check runs before any group is made)."""
    with pytest.raises(ValueError, match="run_world"):
        tmesh.make_mesh(2, device="cpu")
