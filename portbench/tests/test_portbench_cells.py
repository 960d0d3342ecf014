"""Every cell rehearsed end to end on the CPU at a tiny size, to the
contract's last line; and what ``run.py`` does without a card or without
the program."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import harness

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
#: per-layer metrics that only a device trace can give: none on the CPU
DEVICE_ONLY = {m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
               if m["source"] == "device_trace"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end(tiny, cell):
    out = harness.run_cell(tiny, cell, 2**31 + 11, 1.0, False, device="cpu")
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in tiny.metrics("end_to_end", cell)}
    assert set(res["metrics"]) == want and "setup_s" in want
    assert all(m["value"] >= 0 and m["unit"] for m in res["metrics"].values())
    assert set(res["checks"]) == set(tiny.limits(cell))
    route = out["route"]
    assert route["expected"] == tiny.config(tiny.cell(cell)["config"])["route"]
    assert "operand_device_bytes" in route and route["as_expected"] == (
        route["route"] == route["expected"])
    json.dumps(res)


class _Counted:
    variant, unit, units = None, "step", 10


@pytest.mark.parametrize("launches, route", [
    ({"sell2": 20}, "sell2"),
    ({"staged": 10, "sell2": 10}, "sell2"),
    ({"bsr_fused": 10, "bsr_ell": 10}, "bsr_ell+bsr_fused"),
    ({}, None),
])
def test_route_record_from_launches(monkeypatch, launches, route):
    """A driver that gets no variant back from the program reads its route
    from the launches counted in the window: the configuration's route
    where one of its launches ran, else the launches' names."""
    from sparseharness_tpu_torch.ops import _build

    for k in _build.LAUNCHES:
        monkeypatch.setitem(_build.LAUNCHES, k, launches.get(k, 0))
    rec = harness.route_record({"route": "sell2", "route_launches": ["sell2"]}, _Counted(), 123)
    assert rec["route"] == route and rec["as_expected"] == (route == "sell2")
    assert rec["launches_per_step"] == {k: v / 10 for k, v in launches.items()}
    assert rec["operand_device_bytes"] == 123


@pytest.mark.parametrize("cell", CELLS)
def test_cell_traced(tiny, cell):
    res = harness.run_cell(tiny, cell, 2**31 + 12, 0.3, True, device="cpu")["result"]
    assert res["correct"] is True
    want = {m["name"] for m in tiny.metrics("per_layer", cell)}
    assert want - DEVICE_ONLY <= set(res["metrics"]) <= want
    assert list(res)[-1] == "checks"


def test_cells_repeat_per_seed(tiny):
    cell = "band-n19-b63.sssp"
    a = harness.run_cell(tiny, cell, 77, 0.2, False, device="cpu")
    b = harness.run_cell(tiny, cell, 77, 0.2, False, device="cpu")
    assert a["route"] == b["route"] and a["result"]["checks"] == b["result"]["checks"]


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                        "5", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 3 and p.stdout == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                        "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["band-n19-b63.spmv"])
def test_cell_on_the_card(cuda, cell):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                        str(2**31 + 21), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
