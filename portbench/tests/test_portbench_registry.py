"""A later change adds a configuration, a traffic mix (with the plain
reference of its algorithm) and a per-layer metric with new files and new
entries only: no file of the benchmark is edited."""

import hashlib
import json

from conftest import tiny_tree
from portbench import harness

DUMMY_METRIC = '''"""A dummy per-layer metric: the window's SpMV calls."""


def read(ctx):
    return float(ctx.calls) if ctx.calls else None
'''


DUMMY_BFS_REFERENCE = '''"""A dummy plain BFS: Jacobi reachability over or_and, all entries
true, until a step changes nothing (that step counted)."""

import torch


def prepare(n, rows, cols, vals, device):
    return n, rows.to(device, torch.int64), cols.to(device, torch.int64)


def solve(graph, root, max_iter):
    n, rows, cols = graph
    x = torch.zeros(n, dtype=torch.bool, device=rows.device)
    x[root] = True
    for steps in range(1, max_iter + 1):
        x_new = x.clone()
        x_new[rows[x[cols]]] = True
        if torch.equal(x_new, x):
            return x, steps, True
        x = x_new
    return x, max_iter, False
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()}


def test_new_config_traffic_and_metric_by_files_alone(tmp_path):
    root = tiny_tree(tmp_path)
    pb = root / "portbench"
    before = _digests(root)
    (pb / "configs" / "dummy-band.json").write_text(json.dumps({
        "name": "dummy-band", "generator": "band", "route": "bsr_band", "route_launches": ["staged"],
        "params": {"n": 2048, "bandwidth": 3, "values": [0.5, 1.0]}, "reduced": {}}))
    (pb / "traffic" / "dummy_stream.json").write_text(json.dumps({
        "op": "spmv", "semiring": "plus_times", "ring": 2, "x_range": [0.0, 1.0], "check_calls": 2,
        "enqueue_bursts": 2, "burst_calls": 4, "trace_calls": 10, "trace_seconds": 0.1}))
    (pb / "traffic" / "dummy_bfs.json").write_text(json.dumps({
        "op": "solve", "algorithm": "bfs", "roots": "head", "head": 64, "roots_drawn": 16,
        "check_solves": 2, "trace_seconds": 0.1}))
    (pb / "reference" / "bfs.py").write_text(DUMMY_BFS_REFERENCE)
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

    bench = harness.Bench(root, pb)
    res = harness.run_cell(bench, "dummy-band.dummy", 4, 0.2, False, device="cpu")["result"]
    assert res["correct"] is True and "spmv_gnnz_s" in res["metrics"]
    res = harness.run_cell(bench, "dummy-band.dummy", 4, 0.2, True, device="cpu")["result"]
    assert res["metrics"]["dummy_calls"]["value"] > 0
    res = harness.run_cell(bench, "dummy-band.bfs", 4, 0.2, False, device="cpu")["result"]
    assert res["correct"] is True and res["attempted"] > 0 and "solve_ms" in res["metrics"]
    assert {k: c["value"] for k, c in res["checks"].items()} == {
        "dist_mismatch": 0, "steps_mismatch": 0, "unconverged": 0}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
