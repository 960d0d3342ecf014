"""Operands from NumPy arrays made elsewhere.

These take the arrays of an operand built elsewhere (the JAX package
builds the same layout) and return the port's operand on a device,
so both packages can be fed identical strips or column ids. bfloat16 arrays
(NumPy's ml_dtypes type) are carried over bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import round_up
from sparseharness_tpu_torch.ops.bsr import BsrOperand, segments
from sparseharness_tpu_torch.ops.bsr_band import BsrBandOperand, with_spans
from sparseharness_tpu_torch.ops.bsr_ell import BsrEllOperand
from sparseharness_tpu_torch.ops.bsr_fused import BsrFusedOperand
from sparseharness_tpu_torch.ops.dia import DiaOperand
from sparseharness_tpu_torch.ops import sell
from sparseharness_tpu_torch.ops.sell2 import Sell2Operand, Sell2Panels, _SlabLayout
from sparseharness_tpu_torch.ops.torch_ops import CooOperand, DenseOperand, EllOperand
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def bsr_band_operand_from_numpy(strips: np.ndarray, c0: int, k_win: int,
                                n_cols: int, device: DeviceLike = None, *,
                                sr: Optional[Semiring] = None) -> BsrBandOperand:
    """The band operand from its strips. With ``sr`` it also holds the span
    table that the kernel reads, made on the device from the strips under
    ``sr``'s pad, as build_bsr_band makes it; without, only the plain
    version can take it."""
    op = BsrBandOperand(strips=_tensor(strips, resolve_device(device)),
                        c0=int(c0), k_win=int(k_win), n_cols=int(n_cols))
    return op if sr is None else with_spans(op, sr)


def ell_operand_from_numpy(cols: np.ndarray, vals: np.ndarray,
                           device: DeviceLike = None) -> EllOperand:
    device = resolve_device(device)
    return EllOperand(cols=_tensor(cols, device), vals=_tensor(vals, device))


def bsr_ell_operand_from_numpy(tiles: np.ndarray, tile_cols: np.ndarray,
                               device: DeviceLike = None) -> BsrEllOperand:
    device = resolve_device(device)
    return BsrEllOperand(tiles=_tensor(tiles, device),
                         tile_cols=_tensor(tile_cols, device))


def bsr_fused_operand_from_numpy(strips: np.ndarray, cols: np.ndarray,
                                 device: DeviceLike = None) -> BsrFusedOperand:
    device = resolve_device(device)
    return BsrFusedOperand(strips=_tensor(strips, device), cols=_tensor(cols, device))


def bsr_operand_from_numpy(tiles: np.ndarray, tile_rows: np.ndarray,
                           tile_cols: np.ndarray, row_start: np.ndarray,
                           n_rows: int, device: DeviceLike = None) -> BsrOperand:
    """The gen-1 operand, with its segment starts derived from the
    slab-local tile_rows and the slab height that n_rows gives."""
    device = resolve_device(device)
    n_slabs, _, bm, _ = tiles.shape
    rows = _tensor(tile_rows, device)
    rps = -(-(round_up(max(n_rows, 1), bm) // bm) // n_slabs)
    return BsrOperand(tiles=_tensor(tiles, device), tile_rows=rows,
                      tile_cols=_tensor(tile_cols, device),
                      row_start=_tensor(row_start, device),
                      seg=segments(rows, rps))


def coo_seg_operand_from_numpy(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                               device: DeviceLike = None) -> CooOperand:
    device = resolve_device(device)
    return CooOperand(*(_tensor(a, device) for a in (rows, cols, vals)))


def dense_operand_from_numpy(mat: np.ndarray, device: DeviceLike = None) -> DenseOperand:
    return DenseOperand(_tensor(mat, resolve_device(device)))


def dia_operand_from_numpy(vals: np.ndarray, offsets, device: DeviceLike = None) -> DiaOperand:
    return DiaOperand(_tensor(vals, resolve_device(device)),
                      tuple(int(o) for o in offsets))


def sell2_operand_from_numpy(slabs, layouts, n_chunks: int, n_rows: int, base_pad: int,
                             piece_owner=None, virt_blocks=None,
                             device: DeviceLike = None) -> Sell2Operand:
    """The sell2 operand of the JAX package's panels: per-slab arrays (None
    for an empty slab, else a mapping of chunk, wordA, wordB and vals) and
    layouts, as its Sell2Operand holds them. It holds no kernel plan, so
    only the plain version takes it."""
    device = resolve_device(device)
    dev_slabs = [None if s is None else {k: _tensor(s[k], device)
                                         for k in ("chunk", "wordA", "wordB", "vals")}
                 for s in slabs]
    panels = Sell2Panels(
        dev_slabs, tuple(_SlabLayout(*(int(v) if i < 4 else bool(v) for i, v in enumerate(lay)))
                         for lay in layouts), int(n_chunks),
        None if virt_blocks is None else _tensor(virt_blocks, device),
        None if piece_owner is None else _tensor(piece_owner, device))
    return Sell2Operand(int(n_rows), int(base_pad), None, panels)


def sell_operand_from_numpy(slabs, layouts, xrows: int, n_rows: int,
                            device: DeviceLike = None) -> sell.SellOperand:
    """The sell operand from its per-slab arrays (mappings of lanesel, vals,
    blocksel and idx{li} per level) and layouts, as the JAX package's
    SellOperand holds them. The launch tables are derived from the layouts,
    as build_sell derives them."""
    lays = tuple(sell._SlabLayout(
        int(lay.row0), int(lay.rows), int(lay.t_a),
        tuple(sell._LevelLayout(tuple(tuple(int(v) for v in r) for r in lv.regions),
                                int(lv.t_src), int(lv.d_out), bool(lv.final))
              for lv in lay.levels)) for lay in layouts)
    return sell.assemble([{k: np.asarray(v) for k, v in s.items()} for s in slabs], lays,
                         xrows, n_rows, resolve_device(device))
