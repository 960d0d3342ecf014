"""Plain torch SpMV variants, and the α/β fold. The JAX package lowers
these through XLA, with no Pallas kernel, so they stay plain torch here.

- ``ell`` pads rows to a common width, gathers x once per slot and
  ⊕-reduces each row. It serves every semiring and structure, so it is the
  universal fallback variant and the tests' independent oracle.
- ``coo_seg`` ⊕-reduces row-sorted COO triples by segment: no padding,
  robust to power-law rows.
- ``dense`` densifies the operand; a roofline foil for dense or tiny
  matrices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import COO, fold_duplicates, round_up
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _np_fold_for
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device


class EllOperand(NamedTuple):
    cols: torch.Tensor  # int32 (R_pad, W_pad), pads point at col 0
    vals: torch.Tensor  # (R_pad, W_pad), pads = sr.zero


def build_ell(coo: COO, sr: Semiring, width_multiple: int = 128,
              row_multiple: int = 8, *, device: DeviceLike = None) -> EllOperand:
    device = resolve_device(device)
    ell = coo.to_ell(width_multiple=width_multiple, row_multiple=row_multiple)
    vals = ell.vals_filled(sr.np_zero()).astype(sr.np_dtype)
    return EllOperand(
        cols=torch.from_numpy(ell.cols).to(device),
        vals=torch.from_numpy(vals).to(device),
    )


def dp_ell(op: EllOperand, x: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """dp[i] = ⊕_slot x[cols[i, slot]] ⊗ vals[i, slot] over the padded rows."""
    gathered = torch.index_select(x, 0, op.cols.reshape(-1)).view(op.cols.shape)
    return sr.add_reduce(sr.mul(gathered, op.vals), dim=1)


class CooOperand(NamedTuple):
    rows: torch.Tensor  # int32 (nnz_pad,), row-sorted; pads = n_rows − 1
    cols: torch.Tensor  # int32 (nnz_pad,); pads = 0
    vals: torch.Tensor  # (nnz_pad,); pads = sr.zero


class DenseOperand(NamedTuple):
    mat: torch.Tensor  # (R_pad, C_pad) densified, absent = sr.zero


def build_coo_seg(coo: COO, sr: Semiring, nnz_multiple: int = 1024, *,
                  device: DeviceLike = None) -> CooOperand:
    device = resolve_device(device)
    s = coo.sorted_by_row()
    nnz_pad = round_up(max(s.nnz, 1), nnz_multiple)
    pad = nnz_pad - s.nnz
    rows = np.concatenate([s.rows, np.full(pad, coo.shape[0] - 1, np.int32)])
    cols = np.concatenate([s.cols, np.zeros(pad, np.int32)])
    vals = np.concatenate([s.vals.astype(sr.np_dtype), np.full(pad, sr.np_zero())])
    return CooOperand(*(torch.from_numpy(a).to(device) for a in (rows, cols, vals)))


def build_dense(coo: COO, sr: Semiring, row_multiple: int = 8,
                col_multiple: int = 128, *, device: DeviceLike = None) -> DenseOperand:
    device = resolve_device(device)
    coo = fold_duplicates(coo, _np_fold_for(sr, False))
    r_pad = round_up(max(coo.shape[0], 1), row_multiple)
    c_pad = round_up(max(coo.shape[1], 1), col_multiple)
    mat = np.full((r_pad, c_pad), sr.np_zero(), dtype=sr.np_dtype)
    mat[coo.rows, coo.cols] = coo.vals.astype(sr.np_dtype)
    return DenseOperand(torch.from_numpy(mat).to(device))


#: identity of each segment reduction: what an empty segment (a row with
#: no entry) comes out as, the dtype's extreme as in the JAX package's
#: segment_min / segment_max, not the semiring zero
_SEGMENT_IDENTITY = {
    ("sum", torch.float32): 0.0,
    ("amin", torch.float32): float("inf"),
    ("amax", torch.float32): float("-inf"),
    ("amin", torch.int32): int(np.iinfo(np.int32).max),
    ("amax", torch.int32): int(np.iinfo(np.int32).min),
}
_SEGMENT_REDUCE = {torch.add: "sum", torch.minimum: "amin",
                   torch.maximum: "amax", torch.logical_or: "amax"}


def dp_coo_seg(op: CooOperand, x: torch.Tensor, sr: Semiring, *,
               num_rows: int) -> torch.Tensor:
    """dp[i] = ⊕ over row i's entries of x[col] ⊗ val, for i < num_rows;
    or_and reduces through int32 max. A row with no entry gets the
    reduction's identity, which the fold's ⊕-clamp maps to sr.zero."""
    reduce_ = _SEGMENT_REDUCE[sr.add]
    contrib = sr.mul(torch.index_select(x, 0, op.cols), op.vals)
    if sr.dtype == torch.bool:
        contrib = contrib.to(torch.int32)
    dp = torch.full((num_rows,), _SEGMENT_IDENTITY[reduce_, contrib.dtype],
                    dtype=contrib.dtype, device=contrib.device)
    dp.scatter_reduce_(0, op.rows.long(), contrib, reduce_, include_self=True)
    return dp > 0 if sr.dtype == torch.bool else dp


def dp_dense(op: DenseOperand, x: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """dp over the padded rows. plus_times is one torch.mv (a cuBLAS gemv on
    the card, which does not use TF32); the other semirings broadcast."""
    c_pad = op.mat.shape[1]
    xp = torch.full((c_pad,), sr.zero, dtype=sr.dtype, device=x.device)
    xp[: x.shape[0]] = x.to(sr.dtype)
    if sr.name == "plus_times":
        return torch.mv(op.mat, xp)
    return sr.add_reduce(sr.mul(xp[None, :], op.mat), dim=1)


def fold_dp(dp: torch.Tensor, y: Optional[torch.Tensor], sr: Semiring,
            alpha, beta) -> torch.Tensor:
    # Saturate: a ⊕ zero = a, but float min_plus overflows FLT_MAX ⊗-pads to
    # +inf; folding the ⊕-identity back in clamps them to the semiring zero,
    # so empty and padded rows come out as sr.zero.
    dp = sr.add(dp, torch.full_like(dp, sr.zero))
    if alpha is None:
        alpha = sr.one
    if beta is None:
        beta = sr.zero
    if y is None:
        return sr.scale(alpha, dp)
    return sr.fold_axby(alpha, dp, beta, y)
