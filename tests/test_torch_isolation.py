"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to run without a card unless asked for the CPU, and
chip_smoke.py fails without a card or without the repository."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sparseharness_tpu_torch
from sparseharness_tpu_torch.algorithms import (
    bfs, connected_components, eigenvector, fixpoint_components, make_spmv_problem, multi_bfs,
    multi_sssp, pagerank, scc, sssp, widest_path,
)
from sparseharness_tpu_torch import parallel
from sparseharness_tpu_torch.cli import main as cli
from sparseharness_tpu_torch.formats import banded_coo
from sparseharness_tpu_torch.harness.scaling import weak_scaling_spmv
from sparseharness_tpu_torch.ops import build_operand
from sparseharness_tpu_torch.parallel.sharded_sell import build_sharded_sell
from sparseharness_tpu_torch.parallel.sharded_spmm import build_sharded_spmm_tiles
from sparseharness_tpu_torch.semiring import PLUS_TIMES

REPO = Path(__file__).resolve().parents[1]
PKG = Path(sparseharness_tpu_torch.__file__).parent


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "sparseharness_tpu" or module.startswith("sparseharness_tpu."))


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sparseharness_tpu_torch as p\n"
        "import chip_smoke\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sparseharness_tpu' or m.startswith('sparseharness_tpu.'))\n"
        "print(len([m for m in sys.modules if m.startswith('sparseharness_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported


def test_no_source_names_jax():
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 20
    for module in ("ops/sell.py", "cli/main.py", "cli/__main__.py", "harness/sweep.py",
                   "parallel/sharded.py", "parallel/frontier.py", "harness/scaling.py"):
        assert PKG / module in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


@pytest.mark.parametrize("entry", [
    lambda coo: build_operand(coo, PLUS_TIMES, "bsr_band"),
    lambda coo: make_spmv_problem(coo, variant="ell"),
    lambda coo: sssp(coo, 0),
    lambda coo: bfs(coo, 0),
    lambda coo: pagerank(coo),
    lambda coo: connected_components(coo),
    lambda coo: widest_path(coo, 0),
    lambda coo: build_operand(coo, PLUS_TIMES, "sell2"),
    lambda coo: multi_sssp(coo, [0, 3]),
    lambda coo: multi_bfs(coo, [0, 3]),
    lambda coo: sssp(coo, 0, reorder="rcm"),
    lambda coo: multi_sssp(coo, [0], variant="bsr_band", reorder="rcm"),
    lambda coo: build_operand(coo, PLUS_TIMES, "sell"),
    lambda coo: scc(coo),
    lambda coo: eigenvector(coo),
    lambda coo: fixpoint_components("scc", coo),
    lambda coo: parallel.make_mesh(),
    lambda coo: parallel.run_world(parallel.run_calls, 2, args=([],)),
    lambda coo: parallel.sharded_sssp(coo, 0),
    lambda coo: parallel.sharded_bfs(coo, 0, mode="band"),
    lambda coo: parallel.sharded_pagerank(coo),
    lambda coo: parallel.sharded_eigenvector(coo),
    lambda coo: parallel.sharded_scc(coo),
    lambda coo: parallel.sharded_multi_sssp(coo, [0, 3]),
    lambda coo: parallel.frontier_sssp(coo, 0),
    lambda coo: parallel.frontier_bfs(coo, 0),
    lambda coo: parallel.build_sharded_ell(coo, PLUS_TIMES, 2),
    lambda coo: parallel.build_sharded_ell_halo(coo, PLUS_TIMES, 2),
    lambda coo: parallel.build_sharded_band(coo, PLUS_TIMES, 2),
    lambda coo: build_sharded_sell(coo, PLUS_TIMES, 2),
    lambda coo: build_sharded_spmm_tiles(coo, PLUS_TIMES, 2),
    lambda coo: weak_scaling_spmv(base_rows=64, device_counts=[1]),
], ids=["build_operand", "make_spmv_problem", "sssp", "bfs", "pagerank",
        "connected_components", "widest_path", "build_sell2", "multi_sssp", "multi_bfs",
        "sssp_rcm", "multi_sssp_rcm", "build_sell", "scc", "eigenvector",
        "fixpoint_components", "make_mesh", "run_world", "sharded_sssp", "sharded_bfs",
        "sharded_pagerank", "sharded_eigenvector", "sharded_scc", "sharded_multi_sssp",
        "frontier_sssp", "frontier_bfs", "build_sharded_ell", "build_sharded_ell_halo",
        "build_sharded_band", "build_sharded_sell", "build_sharded_spmm_tiles",
        "weak_scaling_spmv"])
def test_entry_points_raise_without_a_card(entry, monkeypatch):
    """With no card and no explicit device an entry point raises; it never
    falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(banded_coo(64, 2, seed=1))


@pytest.mark.parametrize("app", sorted(cli.COMMANDS))
def test_cli_commands_exit_without_a_card(app, tmp_path, monkeypatch):
    """Without a card and without --device cpu every command exits nonzero
    with the no-CUDA message before it reads the matrix."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.COMMANDS[app](["-m", str(tmp_path / "never_read.mtx")])
    assert "no CUDA device" in str(e.value.code)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repository it fails before printing a result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_every_module_is_a_port_module():
    names = {m.name for m in pkgutil.walk_packages([str(PKG)])}
    for expected in ("formats", "semiring", "ops", "gold", "harness", "algorithms", "utils",
                     "cli", "parallel"):
        assert expected in names


def test_every_jax_module_has_a_port():
    """The port has a module for each of the JAX package's: the same path,
    with pallas_ dropped and jnp_ops as torch_ops."""
    jax_pkg = REPO / "sparseharness_tpu"

    def modules(root):
        return {p.relative_to(root).with_suffix("").as_posix() for p in root.rglob("*.py")}

    wanted = {m.replace("pallas_", "").replace("jnp_ops", "torch_ops") for m in modules(jax_pkg)}
    assert not wanted - modules(PKG)
