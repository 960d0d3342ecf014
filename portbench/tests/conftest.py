"""Fixtures of the benchmark's own tests (run with
``python -m pytest portbench/tests -q`` from the repository's root; the
tests marked ``cuda`` run only where a card is, and skip here)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: each configuration cut to a size a CPU test holds
TINY = {"g500-kron-s20": {"scale": 10}, "band-n19-b63": {"n": 4096, "bandwidth": 7}}


def tiny_tree(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` under ``dest``,
    each configuration's file cut to its TINY size."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg["params"].update(TINY[c["name"]])
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny(tmp_path):
    """A ``harness.Bench`` over a tiny copy of the benchmark."""
    from portbench import harness

    root = tiny_tree(tmp_path)
    return harness.Bench(root, root / "portbench")


@pytest.fixture
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def cuda():
    """Skips the test where no CUDA card is."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
