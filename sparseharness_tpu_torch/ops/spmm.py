"""Semiring SpMM: Y = A ⊗ X for a block of dense right-hand sides.

Dispatch, as the JAX package's, best kernel first:

- a ``bsr_band`` operand under plain plus_times (no α/β fold) →
  :func:`bsr_band.spmm_band`, the band SpMM kernel;
- strip operands (``bsr_ell``, ``bsr_fused``, and ``bsr_band`` under any
  other semiring or with a fold) → :func:`spmm_tiles.spmm_bsr_ell`, then
  ``fold_dp``;
- anything else → ``spmv`` of each column of X, stacked: correct for every
  variant, with A read once per column (the JAX package's ``lax.map``).
"""

from __future__ import annotations

from typing import Optional

import torch

from sparseharness_tpu_torch.ops import registry
from sparseharness_tpu_torch.ops.bsr_band import BsrBandOperand, spmm_band
from sparseharness_tpu_torch.ops.bsr_ell import BsrEllOperand
from sparseharness_tpu_torch.ops.bsr_fused import BsrFusedOperand
from sparseharness_tpu_torch.ops.spmm_tiles import (
    ell_operand_from_band, ell_operand_from_fused, spmm_bsr_ell,
)
from sparseharness_tpu_torch.ops.torch_ops import fold_dp
from sparseharness_tpu_torch.semiring import Semiring


def spmm(
    operand,
    x_block: torch.Tensor,  # (n_cols, m)
    *,
    sr: Semiring,
    variant: str = "bsr_fused",
    n_rows: int,
    alpha=None,
    beta=None,
    y_block: Optional[torch.Tensor] = None,  # optional (n_rows, m) for the β fold
) -> torch.Tensor:
    """Y[:, j] = (α ⊗ (⊕ A ⊗ X[:, j])) ⊕ (β ⊗ Y0[:, j]). Returns (n_rows, m)."""
    if (
        isinstance(operand, BsrBandOperand)
        and sr.name == "plus_times"
        and alpha in (None, 1.0)
        and beta in (None, 0.0)
        and y_block is None
    ):
        return spmm_band(operand, x_block, n_rows=n_rows)

    tile_op = None
    if isinstance(operand, BsrEllOperand):
        tile_op = operand
    elif isinstance(operand, BsrFusedOperand):
        tile_op = ell_operand_from_fused(operand)
    elif isinstance(operand, BsrBandOperand):
        # any other band SpMM: the affine columns made explicit, so that A
        # still streams once per column tile
        tile_op = ell_operand_from_band(operand)
    if tile_op is not None:
        dp = spmm_bsr_ell(tile_op, x_block, sr, n_rows=n_rows)
        return fold_dp(dp, y_block, sr, alpha, beta)

    cols = x_block.movedim(1, 0).contiguous()  # (m, n_cols)
    ys = [None] * cols.shape[0] if y_block is None else y_block.movedim(1, 0)
    out = [registry.spmv(operand, c, y, sr=sr, variant=variant, n_rows=n_rows,
                         alpha=alpha, beta=beta) for c, y in zip(cols, ys)]
    return torch.stack(out, dim=1)
