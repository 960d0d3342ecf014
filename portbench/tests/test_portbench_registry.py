"""A later change adds a configuration (with its CPU size, ``tiny``), a
traffic mix and a per-layer metric with new files and new entries only: no
file of the benchmark is edited, and the benchmark's tests take the new
configuration through ``tiny_tree`` as they take the others."""

import ast
import hashlib
import json
import shutil

import pytest

from conftest import ROOT
from portbench import harness

DUMMY_METRIC = '''"""A dummy per-layer metric: the window's SpMV calls."""


def read(ctx):
    return float(ctx.calls) if ctx.calls else None
'''

#: the dummy configuration's size as it would run, and its CPU size
DUMMY_PARAMS = {"n": 1 << 19, "bandwidth": 3, "values": [0.5, 1.0]}
DUMMY_TINY = {"n": 2048}


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()}


@pytest.fixture
def bench_source(tmp_path):
    """A full-size copy of the repository's benchmark, with a configuration,
    two traffic mixes, their limits and a metric added by new files and
    entries; every file the copy had is checked unchanged."""
    root = tmp_path / "full"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    pb = root / "portbench"
    before = _digests(root)
    (pb / "configs" / "dummy-band.json").write_text(json.dumps({
        "name": "dummy-band", "generator": "band", "route": "bsr_band", "route_launches": ["staged"],
        "params": DUMMY_PARAMS, "tiny": DUMMY_TINY, "reduced": {}}))
    (pb / "traffic" / "dummy_stream.json").write_text(json.dumps({
        "op": "spmv", "semiring": "plus_times", "ring": 2, "x_range": [0.0, 1.0], "check_calls": 2,
        "enqueue_bursts": 2, "burst_calls": 4, "trace_calls": 10, "trace_seconds": 0.1}))
    (pb / "traffic" / "dummy_bfs.json").write_text(json.dumps({
        "op": "solve", "algorithm": "bfs", "roots": "head", "head": 64, "roots_drawn": 16,
        "check_solves": 2, "trace_seconds": 0.1}))
    (pb / "metrics" / "dummy_calls.py").write_text(DUMMY_METRIC)
    (pb / "limits" / "dummy-band.dummy.json").write_text(json.dumps({"spmv_rel_err": 1e-5}))
    (pb / "limits" / "dummy-band.bfs.json").write_text(json.dumps(
        {"dist_mismatch": 0, "steps_mismatch": 0, "unconverged": 0}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy-band", "source": "a test", "reduced": [], "why": "a test",
                            "file": "portbench/configs/dummy-band.json"})
    spec["workloads"].append({"name": "dummy-band.dummy", "config": "dummy-band",
                              "traffic": "dummy_stream", "chips": 1, "why": "a test"})
    spec["workloads"].append({"name": "dummy-band.bfs", "config": "dummy-band",
                              "traffic": "dummy_bfs", "chips": 1, "why": "a test"})
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            if "band-n19-b63.spmv" in m.get("workloads", []):
                m["workloads"].append("dummy-band.dummy")
            if "band-n19-b63.sssp" in m.get("workloads", []):
                m["workloads"].append("dummy-band.bfs")
    spec["per_layer"].append({"name": "dummy_calls", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "spmv entry",
                              "moves": "spmv_gnnz_s", "workloads": ["dummy-band.dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    return root


def test_new_config_traffic_and_metric_by_files_alone(tiny):
    """The added configuration reaches the tests through ``tiny_tree``, cut
    to its own ``tiny``, and its cells run there as the others do."""
    assert tiny.config("dummy-band")["params"] == dict(DUMMY_PARAMS, **DUMMY_TINY)
    assert {c["name"] for c in tiny.spec["configs"]} >= {"g500-kron-s20", "band-n19-b63"}
    res = harness.run_cell(tiny, "dummy-band.dummy", 4, 0.2, False, device="cpu")["result"]
    assert res["correct"] is True and "spmv_gnnz_s" in res["metrics"]
    res = harness.run_cell(tiny, "dummy-band.dummy", 4, 0.2, True, device="cpu")["result"]
    assert res["metrics"]["dummy_calls"]["value"] > 0
    res = harness.run_cell(tiny, "dummy-band.bfs", 4, 0.2, False, device="cpu")["result"]
    assert res["correct"] is True and res["attempted"] > 0 and "solve_ms" in res["metrics"]
    assert {k: c["value"] for k, c in res["checks"].items()} == {
        "dist_mismatch": 0, "steps_mismatch": 0, "unconverged": 0}


def test_every_configuration_has_a_tiny_size(spec):
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        tiny = cfg.get("tiny")
        assert isinstance(tiny, dict) and tiny, (
            f"{c['file']} has no \"tiny\" object: the params the benchmark's CPU tests cut it to")
        assert set(tiny) <= set(cfg["params"]), (
            f"{c['file']}: \"tiny\" keys {sorted(set(tiny) - set(cfg['params']))} are not in its params")


def test_a_configuration_without_tiny_leaves_the_others_running(tmp_path):
    """``tiny_tree`` leaves such a configuration out with its cells, so that
    only its own tests fail, not every test that takes the fixture."""
    from conftest import tiny_tree

    src = tmp_path / "src"
    shutil.copytree(ROOT / "portbench", src / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    path = src / "portbench" / "configs" / "band-n19-b63.json"
    cfg = json.loads(path.read_text())
    del cfg["tiny"]
    path.write_text(json.dumps(cfg))
    (src / "BENCHMARK.json").write_text(json.dumps(spec))
    cut = json.loads((tiny_tree(tmp_path / "tiny", src) / "BENCHMARK.json").read_text())
    assert [c["name"] for c in cut["configs"]] == ["g500-kron-s20"]
    assert cut["workloads"] and all(w["config"] == "g500-kron-s20" for w in cut["workloads"])


class _Watched(dict):
    """A configuration that notes each key read from it."""

    read: list = []

    def __getitem__(self, key):
        self.read.append(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self.read.append(key)
        return super().get(key, default)


@pytest.mark.parametrize("cell, trace", [("dummy-band.dummy", True), ("g500-kron-s20.bfs", True),
                                         ("band-n19-b63.sssp", False)])
def test_a_run_never_reads_tiny(tiny, monkeypatch, cell, trace):
    """``tiny`` is the tests' alone: a run reads the same configuration with
    or without it, and no file of the harness names it."""
    real = harness.Bench.config
    monkeypatch.setattr(_Watched, "read", [])
    monkeypatch.setattr(harness.Bench, "config", lambda self, name: _Watched(real(self, name)))
    assert harness.run_cell(tiny, cell, 6, 0.1, trace, device="cpu")["result"]["correct"]
    assert "params" in _Watched.read and "tiny" not in _Watched.read
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" not in path.relative_to(ROOT / "portbench").parts:
            strings = {n.value for n in ast.walk(ast.parse(path.read_text()))
                       if isinstance(n, ast.Constant)}
            assert "tiny" not in strings, path
