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


def tiny_tree(dest: Path, src: Path = ROOT) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` of the tree ``src``
    under ``dest``, each configuration's ``params`` cut to the size its file
    gives under ``tiny``. A configuration whose file has no ``tiny`` is left
    out of the copy with its cells, so that it fails
    ``test_every_configuration_has_a_tiny_size`` (and its own cells' tests)
    and not every test that takes the fixture."""
    shutil.copytree(src / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((src / "BENCHMARK.json").read_text())
    kept = []
    for c in spec["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        if isinstance(cfg.get("tiny"), dict):
            cfg["params"].update(cfg["tiny"])
            path.write_text(json.dumps(cfg))
            kept.append(c)
    names = {c["name"] for c in kept}
    spec["configs"] = kept
    spec["workloads"] = [w for w in spec["workloads"] if w["config"] in names]
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture
def bench_source():
    """The tree that ``tiny`` cuts down: the repository's own."""
    return ROOT


@pytest.fixture
def tiny(tmp_path, bench_source):
    """A ``harness.Bench`` over a tiny copy of ``bench_source``'s benchmark."""
    from portbench import harness

    root = tiny_tree(tmp_path / "tiny", bench_source)
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
