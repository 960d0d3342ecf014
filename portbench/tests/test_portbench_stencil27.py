"""The HPCG configuration: its generator true to ``GenerateProblem_ref``'s
pattern, its cell correct at the tiny size through the dia route, its
comparison failing where it must (the faults of ``test_portbench_faults``
that apply to an ``.spmv`` cell), and ``dia_try_s`` read where dia is
tried, 0 where auto stops before it, nothing without dia in the chain."""

import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.graphs import stencil27
from test_portbench_faults import FAULTS, _break_product, _correct

CELL = "hpcg-27pt-104.spmv"
P = {"nx": 7, "ny": 5, "nz": 4, "values": [0.1, 1.0]}


def _reference_pattern(nx, ny, nz):
    """(row, col) pairs in GenerateProblem_ref's loop order, in NumPy."""
    pairs = []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            if 0 <= ix + sx < nx and 0 <= iy + sy < ny and 0 <= iz + sz < nz:
                                pairs.append((iz * nx * ny + iy * nx + ix,
                                              (iz + sz) * nx * ny + (iy + sy) * nx + ix + sx))
    return np.array(pairs)


@pytest.mark.parametrize("grid", [(7, 5, 4), (6, 6, 6)])
def test_entries_and_row_order(grid):
    nx, ny, nz = grid
    rows, cols, vals, n = stencil27.make(dict(P, nx=nx, ny=ny, nz=nz), 3, "cpu")
    assert n == nx * ny * nz
    assert rows.numel() == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    want = _reference_pattern(nx, ny, nz)
    np.testing.assert_array_equal(rows.numpy(), want[:, 0])
    np.testing.assert_array_equal(cols.numpy(), want[:, 1])
    key = rows * n + cols
    assert bool((key[1:] > key[:-1]).all())  # row-major, no duplicate


def test_full_size_offsets():
    """The 27 offsets at 104³, from the grid's sizes alone."""
    offs = stencil27.offsets(104, 104)
    assert offs.numel() == 27 and torch.unique(offs).numel() == 27
    assert bool((offs[1:] > offs[:-1]).all())
    assert int(offs.max()) == 104 * 104 + 104 + 1 == 10_921 == -int(offs.min())
    # at 104³: (3·104 − 2)³ entries
    assert (3 * 104 - 2) ** 3 == 29_791_000


def test_values_from_the_seed():
    a, b, c = (stencil27.make(P, s, "cpu") for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    assert torch.equal(a[2], b[2]) and not torch.equal(a[2], c[2])
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])  # the pattern is the grid's
    assert a[2].dtype == torch.float32
    assert float(a[2].min()) >= 0.1 and float(a[2].max()) < 1.0


def test_tiny_cell_runs_the_dia_route(tiny):
    out = harness.run_cell(tiny, CELL, 2**31 + 41, 0.3, False, device="cpu")
    assert out["result"]["correct"] is True
    assert out["route"]["route"] == "dia" and out["route"]["as_expected"]
    assert out["route"]["launches_per_call"] == {}  # the CPU runs the plain version


def test_precision_control_is_not_correct(tiny):
    from sparseharness_tpu_torch.ops import Geometry

    assert not _correct(tiny, CELL, geometry=Geometry(value_dtype="bfloat16"))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_product_is_not_correct(tiny, fault, monkeypatch):
    _break_product(monkeypatch, FAULTS[fault])
    assert not _correct(tiny, CELL)


def test_product_returning_its_input_is_not_correct(tiny, monkeypatch):
    from sparseharness_tpu_torch.ops import registry

    monkeypatch.setattr(registry, "spmv", lambda op, x, *a, **kw: x.clone())
    assert not _correct(tiny, CELL)


@pytest.mark.parametrize("cell, route", [("g500-kron-s20.spmv", "bsr_fused"), (CELL, "dia")])
def test_dia_try_s_is_read(tiny, cell, route):
    """On the Kronecker cell, the guard's refusal. Its tiny size (scale
    10: 1,024 columns) fits bsr_band's window, which auto takes before it
    tries dia, so the graph is raised to scale 12 here, where bsr_band
    refuses, dia's guard refuses, and bsr_fused builds (sell2 takes the
    full size on the card)."""
    if cell != CELL:
        path = tiny.root / "portbench" / "configs" / "g500-kron-s20.json"
        cfg = json.loads(path.read_text())
        cfg["params"]["scale"] = 12
        path.write_text(json.dumps(cfg))
    out = harness.run_cell(tiny, cell, 2**31 + 43, 0.3, True, device="cpu")
    assert out["route"]["route"] == route
    v = out["result"]["metrics"]["dia_try_s"]
    assert v["unit"] == "s" and v["value"] > 0


def test_dia_try_s_without_a_dia_try(monkeypatch):
    """0 where auto built before it reached dia; nothing where the
    program's chain has no dia, as the parent of this metric's change."""
    from types import SimpleNamespace

    from sparseharness_tpu_torch.ops import registry
    from sparseharness_tpu_torch.utils.timing import Span

    read = harness.load_module(harness.HERE / "metrics" / "dia_try_s.py").read
    built = SimpleNamespace(build_spans=[
        Span("build.try", 0, 10**9, attrs={"variant": "bsr_band", "outcome": "built"})])
    assert read(built) == 0.0
    assert read(SimpleNamespace(build_spans=None)) is None
    monkeypatch.setattr(registry, "AUTO_CHAIN",
                        tuple(v for v in registry.AUTO_CHAIN if v != "dia"))
    assert read(built) is None
