"""The comparison that decides ``correct`` fails where it must: the
precision control (the program's own bfloat16 path) and a run with the
timed path broken underneath, once for each fault a cell can have.
The chip's own readings at the cells' sizes are in PERF.md; these run the
same comparison at a tiny size.

The BFS cells' answer is boolean reachability: the matrix's values never
reach it (an entry is an edge where its value is not 0), so the bfloat16
control, which changes only the values, cannot change a BFS answer, and
the float faults (``_altered`` subtracts 0.5 from a distance or a sum) do
not apply to it. Those cells take the step that returns its state and the
boolean forms of the product's faults instead: one reached entry cleared,
and half of the answer cleared."""

import dataclasses

import pytest
import torch

from portbench import harness

SPMV_CELLS = ["band-n19-b63.spmv", "g500-kron-s20.spmv"]
SOLVE_CELLS = ["g500-kron-s20.sssp", "band-n19-b63.sssp"]
BFS_CELLS = ["g500-kron-s20.bfs"]


def _correct(bench, cell, **kw):
    return harness.run_cell(bench, cell, 2**31 + 31, 0.2, False, device="cpu", **kw)["result"]["correct"]


@pytest.mark.parametrize("cell", SPMV_CELLS + SOLVE_CELLS + BFS_CELLS)
def test_sound_run_is_correct(tiny, cell):
    assert _correct(tiny, cell)


@pytest.mark.parametrize("cell", SPMV_CELLS + SOLVE_CELLS)
def test_precision_control_is_not_correct(tiny, cell):
    from sparseharness_tpu_torch.ops import Geometry

    assert not _correct(tiny, cell, geometry=Geometry(value_dtype="bfloat16"))


def _altered(y):
    """One answer altered where it is produced: the last finite output
    lowered by a half."""
    y = y.clone()
    finite = torch.nonzero(y.abs() < 1e30).flatten()
    if finite.numel():
        y[finite[-1]] -= 0.5
    return y


def _half_left_out(y):
    y = y.clone()
    y[y.numel() // 2:] = 0.0
    return y


FAULTS = {"answer_altered": _altered, "half_left_out": _half_left_out}


def _reached_cleared(y):
    """One reached entry cleared where the product makes it: the last
    true output made false."""
    y = y.clone()
    reached = torch.nonzero(y).flatten()
    if reached.numel():
        y[reached[-1]] = False
    return y


def _half_cleared(y):
    y = y.clone()
    y[y.numel() // 2:] = False
    return y


BOOL_FAULTS = {"reached_cleared": _reached_cleared, "half_cleared": _half_cleared}


def _break_product(monkeypatch, fault) -> None:
    """Every SpMV of the program, the fixpoint's step's too, returns its
    answer with ``fault`` applied."""
    from sparseharness_tpu_torch.algorithms import apps
    from sparseharness_tpu_torch.ops import registry

    real = registry.spmv

    def broken(*a, **kw):
        return fault(real(*a, **kw))

    monkeypatch.setattr(registry, "spmv", broken)
    monkeypatch.setattr(apps, "spmv", broken)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", SPMV_CELLS + SOLVE_CELLS)
def test_broken_product_is_not_correct(tiny, cell, fault, monkeypatch):
    _break_product(monkeypatch, FAULTS[fault])
    assert not _correct(tiny, cell)


@pytest.mark.parametrize("fault", sorted(BOOL_FAULTS))
@pytest.mark.parametrize("cell", BFS_CELLS)
def test_broken_boolean_product_is_not_correct(tiny, cell, fault, monkeypatch):
    _break_product(monkeypatch, BOOL_FAULTS[fault])
    assert not _correct(tiny, cell)


@pytest.mark.parametrize("cell", SOLVE_CELLS + BFS_CELLS)
def test_step_returning_its_state_is_not_correct(tiny, cell, monkeypatch):
    from sparseharness_tpu_torch.algorithms import apps

    real = apps.fixpoint_components

    def unchanged(*a, **kw):
        return dataclasses.replace(real(*a, **kw), step=lambda x: x)

    monkeypatch.setattr(apps, "fixpoint_components", unchanged)
    assert not _correct(tiny, cell)


@pytest.mark.parametrize("cell", SPMV_CELLS)
def test_product_returning_its_input_is_not_correct(tiny, cell, monkeypatch):
    from sparseharness_tpu_torch.ops import registry

    monkeypatch.setattr(registry, "spmv", lambda op, x, *a, **kw: x.clone())
    assert not _correct(tiny, cell)
