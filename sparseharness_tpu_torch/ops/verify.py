"""Operand-initialization check: no slot of an operand is uninitialized memory.

A CUDA kernel cannot be instrumented for reads before writes, so the check
runs on the host after a build: every slot of every operand tensor must be
accounted for. A value slot holds a matrix entry (possibly ⊕-folded with
its duplicates) or the semiring's 0̄ padding; an index slot lies in bounds
for what it addresses. A builder that allocates with ``torch.empty`` or
``np.empty`` and forgets to fill a region leaves garbage that is, with
overwhelming probability, neither an entry nor 0̄, or an index far out of
bounds, so the check trips before the operand is used.

Every tensor field of every registered variant's operand has a contract in
:data:`CONTRACTS`: a value leaf, an index leaf with its bounds, or a skip
with its reason. A tensor field with no contract is an error, so a layout
that grows a field must say what it holds.

The allowed values are the entries, their folds and 0̄. No layout of the
port pads with 1̄, so 1̄ passes only where it is an entry, and {0, 1} are
admitted only for the int32 {0, 1} carrier of ``or_and``: a stray 0.0 in a
min_plus operand is garbage (a zero-weight edge), not padding.

This checks initialization, not placement: an entry scattered to the wrong
coordinate is the gold checks' to find. ``SPARSEHARNESS_TPU_CHECK_INIT=1``
runs it on every ops.build_operand / build_operand_auto.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import COO, fold_duplicates, round_up
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _carrier, _np_fold_for


class OperandInitError(ValueError):
    """An operand slot is neither a real entry nor padding, or an index is
    out of bounds, or a tensor field has no contract."""


class _Ctx(NamedTuple):
    """What index bounds are computed from: the matrix and the operand."""

    n_rows: int
    n_cols: int
    nnz: int
    op: Any

    @property
    def r_hi(self) -> int:
        # rows past base_pad hold the overflow pieces of split rows
        return round_up(max(self.n_rows, 1), 1024) + self.nnz + 128

    @property
    def c_hi(self) -> int:
        return round_up(max(self.n_cols, 1), 128)


@dataclasses.dataclass(frozen=True)
class Contract:
    """What a tensor field holds: ``kind`` is "value", "index" (in
    ``bounds(ctx)`` = [lo, hi)) or "skip" (with its ``reason``)."""

    kind: str
    bounds: Optional[Callable[[_Ctx], Tuple[int, int]]] = None
    reason: str = ""


VALUE = Contract("value")


def _index(bounds: Callable[[_Ctx], Tuple[int, int]]) -> Contract:
    return Contract("index", bounds)


def _skip(reason: str) -> Contract:
    return Contract("skip", reason=reason)


_COLS = _index(lambda c: (0, c.c_hi))
_ROWS = _index(lambda c: (0, c.r_hi))
_SELL_VIEW = _skip("a view of the flat array of the same name, checked there")


def _sell2_chunks(c: _Ctx) -> Tuple[int, int]:
    panels = c.op.panels
    n_virt = 0 if panels.virt_blocks is None else panels.virt_blocks.shape[0]
    return 0, panels.n_chunks + n_virt


def _sell_t_src(c: _Ctx) -> Tuple[int, int]:
    return 0, max((lv.t_src for lay in c.op.layouts for lv in lay.levels), default=1)


def _band_chunks(c: _Ctx) -> Tuple[int, int]:
    return 0, c.op.strips.shape[-1] // c.op.spans.chunk_lanes + 1


#: operand type name → {field path glob: contract}; a path names dataclass
#: and named-tuple fields and dict keys, with "[]" for a list element
CONTRACTS: Dict[str, Dict[str, Contract]] = {
    "EllOperand": {"cols": _COLS, "vals": VALUE},
    "CooOperand": {"rows": _ROWS, "cols": _COLS, "vals": VALUE},
    "DenseOperand": {"mat": VALUE},
    "DiaOperand": {"vals": VALUE},
    "BsrBandOperand": {"strips": VALUE, "spans.strips": VALUE,
                       "spans.table": _index(_band_chunks)},
    "BsrEllOperand": {"tiles": VALUE, "tile_cols": _COLS},
    "BsrFusedOperand": {"strips": VALUE, "cols": _COLS},
    "BsrOperand": {"tiles": VALUE, "tile_rows": _ROWS, "tile_cols": _COLS,
                   "row_start": _index(lambda c: (0, 2)),
                   "seg": _index(lambda c: (0, c.op.tiles.shape[1] + 1))},
    "SellOperand": {
        "lanesel": _index(lambda c: (0, 128)),
        "vals": VALUE,
        "blocksel": _index(lambda c: (0, c.op.xrows)),
        "idx": _index(_sell_t_src),
        "table": _skip("launch table derived from the layouts; "
                       "tests/test_torch_sell.py holds it against a model of the kernels"),
        "groups": _skip("fused-launch block table derived from the layouts; "
                        "tests/test_torch_sell.py holds its coverage"),
        # level-launch chains: counts, a 0/1 flag and entries, all below the
        # entries' count
        "chains": _index(lambda c: (0, c.op.table.shape[0])),
        "slabs.[].lanesel": _SELL_VIEW, "slabs.[].vals": _SELL_VIEW,
        "slabs.[].blocksel": _SELL_VIEW, "slabs.[].idx*": _skip(
            "a view of the flat idx, checked there"),
    },
    "Sell2Operand": {
        "panels.slabs.[].chunk": _index(_sell2_chunks),
        "panels.slabs.[].wordA": _skip("bit-packed align, capture and route fields with no "
                                       "compact value set; held end to end by the gold checks"),
        "panels.slabs.[].wordB": _skip("bit-packed lane, block and route fields with no "
                                       "compact value set; held end to end by the gold checks"),
        "panels.slabs.[].vals": VALUE,
        "panels.piece_owner": _index(lambda c: (0, c.n_rows)),
        "panels.virt_blocks": _index(lambda c: (0, c.op.panels.n_chunks * 128)),
        "plan.row_ptr": _index(lambda c: (0, c.op.plan.n_entries + 1)),
        "plan.row_dest": _index(lambda c: (0, c.op.plan.n_final + c.op.plan.n_pieces)),
        "plan.cols": _COLS,
        "plan.vals": VALUE,
        "plan.owners": _index(lambda c: (0, c.r_hi)),
        "plan.piece_slot": _index(lambda c: (0, c.op.plan.owners.shape[0])),
        "plan.owner_done": _index(lambda c: (0, 1)),  # 0 between calls
        "plan.col_perm": _index(lambda c: (0, c.n_cols)),
    },
}


def contract_for(op_type: str, path: str) -> Optional[Contract]:
    for pattern, contract in CONTRACTS.get(op_type, {}).items():
        if fnmatch.fnmatchcase(path, pattern):
            return contract
    return None


def tensor_leaves(operand, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(field path, tensor) of every tensor in an operand, walking into
    dataclasses, named tuples, dicts, lists and tuples."""
    if isinstance(operand, torch.Tensor):
        yield path, operand
        return
    if dataclasses.is_dataclass(operand):
        parts = [(f.name, getattr(operand, f.name)) for f in dataclasses.fields(operand)]
    elif isinstance(operand, tuple) and hasattr(operand, "_fields"):
        parts = [(f, getattr(operand, f)) for f in operand._fields]
    elif isinstance(operand, dict):
        parts = [(str(k), v) for k, v in operand.items()]
    elif isinstance(operand, (list, tuple)):
        parts = [("[]", v) for v in operand]
    else:
        return
    for name, part in parts:
        yield from tensor_leaves(part, f"{path}.{name}" if path else name)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _check_values(name: str, leaf: torch.Tensor, allowed: np.ndarray) -> None:
    flat = _host(leaf).ravel()
    if leaf.dtype == torch.bfloat16:
        # round the allowed set as the storage rounds, compare in f32
        cand = torch.from_numpy(allowed.astype(np.float32)).to(torch.bfloat16).float().numpy()
    else:
        cand = allowed.astype(flat.dtype)
    ok = np.isin(flat, cand)
    if not ok.all():
        bad = np.flatnonzero(~ok)
        raise OperandInitError(
            f"operand leaf {name!r}: {bad.size} slot(s) hold values that are neither "
            f"matrix entries nor the semiring's padding (first: flat index {bad[0]} = "
            f"{flat[bad[0]]!r}): probable uninitialized builder memory")


def _check_index(name: str, leaf: torch.Tensor, lo: int, hi: int) -> None:
    if leaf.numel() == 0:
        return
    mn, mx = int(leaf.min()), int(leaf.max())
    if mn < lo or mx >= hi:
        raise OperandInitError(
            f"operand leaf {name!r}: index values span [{mn}, {mx}] outside the valid "
            f"[{lo}, {hi}): probable uninitialized builder memory")


def _allowed_values(coo: COO, sr: Semiring) -> np.ndarray:
    """The values an operand slot may hold, in float64."""
    _, _, _, _, zero, as_int = _carrier(sr)
    if as_int:
        return np.array([0.0, 1.0])  # the int {0, 1} carrier of or_and
    vals = np.asarray(coo.vals, np.float64).ravel()
    folded = np.asarray(fold_duplicates(coo, _np_fold_for(sr, as_int)).vals, np.float64)
    return np.unique(np.concatenate([vals, folded.ravel(), [np.float64(zero)]]))


def verify_operand_initialized(coo: COO, sr: Semiring, operand: Any,
                               variant: str = "?") -> None:
    """Raise :class:`OperandInitError` if a slot of an operand tensor is
    neither a (possibly ⊕-folded) matrix entry nor the semiring's padding,
    an index is out of its bounds, or a tensor field has no contract."""
    op_type = type(operand).__name__
    if op_type not in CONTRACTS:
        raise OperandInitError(f"{variant}: no contracts for operand type {op_type}")
    allowed = _allowed_values(coo, sr)
    ctx = _Ctx(coo.shape[0], coo.shape[1], coo.nnz, operand)
    for path, leaf in tensor_leaves(operand):
        name = f"{variant}:{path}"
        contract = contract_for(op_type, path)
        if contract is None:
            raise OperandInitError(f"operand leaf {name!r} of {op_type} has no contract")
        if contract.kind == "value":
            _check_values(name, leaf, allowed)
        elif contract.kind == "index":
            _check_index(name, leaf, *contract.bounds(ctx))
