"""What a run loads: never JAX or the JAX package; the reference nothing
of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

PORTBENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "sparseharness_tpu"}

RUN_TINY = r"""
import sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from pathlib import Path
from conftest import tiny_tree
from portbench import harness
root = tiny_tree(Path({tmp!r}))
bench = harness.Bench(root, root / "portbench")
for cell in [w["name"] for w in bench.spec["workloads"]]:
    harness.run_cell(bench, cell, 2**31 + 3, 0.2, True, device="cpu")
import portbench.run  # noqa: F401
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(
        root=str(ROOT), tests=str(PORTBENCH / "tests"), tmp=str(tmp_path))],
        capture_output=True, text=True, timeout=600, check=True)
    loaded = set(out.stdout.split())
    assert "sparseharness_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "sparseharness_tpu_torch_extra", sys)
    assert harness.forbidden_modules() == sorted(FORBIDDEN & {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").glob("*.py"):
        assert not set(_imports(path)) & (FORBIDDEN | {"sparseharness_tpu_torch", "portbench"}), path
    out = subprocess.run([sys.executable, "-c",
                          "import sys; sys.path.insert(0, %r); "
                          "import portbench.reference.plus_times, portbench.reference.sssp; "
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))" % str(ROOT)],
                         capture_output=True, text=True, timeout=300, check=True)
    assert not set(out.stdout.split()) & (FORBIDDEN | {"sparseharness_tpu_torch"})


def test_no_portbench_file_imports_jax():
    for path in PORTBENCH.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path
