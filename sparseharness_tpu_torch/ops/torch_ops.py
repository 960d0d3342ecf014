"""Plain torch SpMV pieces: the ELL variant and the α/β fold.

``ell`` pads rows to a common width, gathers x once per slot and
⊕-reduces each row. It serves every semiring and structure, so it is the
universal fallback variant and the tests' independent oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sparseharness_tpu_torch.formats.sparse import COO
from sparseharness_tpu_torch.semiring import Semiring
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
