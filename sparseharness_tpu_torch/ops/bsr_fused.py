"""The ``bsr_fused`` variant: ELL-of-tiles strips with the x gather in the
kernel.

The operand is ``bsr_ell``'s, padded to whole slabs of r_s block-rows and
cut into S slabs, with the tile block-columns beside it. The slabs come
from the TPU kernel's scalar-prefetch budget (``SLAB_COLS_BUDGET`` indices
per call); the port keeps them, so that its arrays equal those the JAX
package builds, and reads all S slabs flat in one launch.

On a CUDA tensor :func:`dp_bsr_fused` launches the strip kernel of
``csrc/bsr_strips.cu`` with ``GATHER = true``: each warp reads its row's x
blocks ``x2d[cols[b·K + k]]`` straight from L2, so the strips are the only
large stream. On a CPU tensor it runs :func:`dp_bsr_fused_plain`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sparseharness_tpu_torch.formats.sparse import COO, round_up
from sparseharness_tpu_torch.ops.bsr import pad_x2d
from sparseharness_tpu_torch.ops.bsr_ell import (
    build_bsr_ell, gather_x_strips, strip_dp_cuda, strip_dp_plain,
)
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _carrier
from sparseharness_tpu_torch.utils.device import DeviceLike

#: int32 indices per TPU kernel call (its scalar-prefetch memory), which
#: fixes the slab height r_s
SLAB_COLS_BUDGET = 4096
#: A TPU rule: x must fit the TPU kernel's VMEM. The H100 kernel reads x
#: through L2 and needs no such cap; it is kept so that variant="auto"
#: resolves the same variant as the JAX package on the same matrix, where
#: dia's guard refuses the matrix.
MAX_X_VMEM_BYTES = 6 * 1024 * 1024


class BsrFusedOperand(NamedTuple):
    strips: torch.Tensor  # (S, R_s, bm, K·bn)
    cols: torch.Tensor    # int32 (S, R_s·K) block-col per (row, slot)


def build_bsr_fused(coo: COO, sr: Semiring, bm: int = 8, bn: int = 128,
                    value_dtype: str = "float32", *,
                    device: DeviceLike = None) -> BsrFusedOperand:
    if round_up(max(coo.shape[1], 1), bn) * 4 > MAX_X_VMEM_BYTES:
        raise NotImplementedError(
            "bsr_fused requires x to fit in VMEM; use bsr_ell for wide matrices")
    base = build_bsr_ell(coo, sr, bm, bn, value_dtype, device=device)
    strips, cols = base.tiles, base.tile_cols
    r_blocks, _, kbn = strips.shape
    k = cols.shape[1]
    r_s = max(8, (SLAB_COLS_BUDGET // k) // 8 * 8)
    r_s = min(r_s, round_up(r_blocks, 8))
    r_pad = round_up(r_blocks, r_s)
    if r_pad != r_blocks:
        # whole slabs: rows of the semiring zero, rounded to the strip type
        # (min_plus' FLT_MAX becomes +inf in bf16)
        pad = r_pad - r_blocks
        carrier, _, _, _, zero, _ = _carrier(sr)
        fill = torch.full((pad, bm, kbn), zero, dtype=carrier,
                          device=strips.device).to(strips.dtype)
        strips = torch.cat([strips, fill])
        cols = torch.cat([cols, cols.new_zeros((pad, k))])
    s = r_pad // r_s
    return BsrFusedOperand(strips=strips.view(s, r_s, bm, kbn),
                           cols=cols.view(s, r_s * k))


def _flat(op: BsrFusedOperand):
    """(strips as (S·R_s, bm, K·bn), cols as (S·R_s, K), K, bn)."""
    s, r_s, bm, kbn = op.strips.shape
    k = op.cols.shape[1] // r_s
    return (op.strips.view(s * r_s, bm, kbn), op.cols.view(s * r_s, k), k,
            kbn // k)


def dp_bsr_fused(op: BsrFusedOperand, x: torch.Tensor, sr: Semiring, *,
                 n_rows: int) -> torch.Tensor:
    """⊕-reduced row dot-products over the padded row space
    (S·R_s·bm ≥ n_rows); callers slice. On a CUDA tensor this launches the
    kernel; on a CPU tensor it runs the plain version."""
    if op.strips.device.type == "cpu":
        return dp_bsr_fused_plain(op, x, sr, n_rows=n_rows)
    strips, cols, k, bn = _flat(op)
    dp = strip_dp_cuda(strips, pad_x2d(x, bn, sr), sr, k=k, cols=cols)
    return dp > 0 if sr.dtype == torch.bool else dp


def dp_bsr_fused_plain(op: BsrFusedOperand, x: torch.Tensor, sr: Semiring, *,
                       n_rows: int) -> torch.Tensor:
    """The plain torch version of :func:`dp_bsr_fused`, on any device: the x
    gather as a separate ``index_select``, then the strip ⊗ and ⊕."""
    strips, cols, _, bn = _flat(op)
    dp = strip_dp_plain(strips, gather_x_strips(pad_x2d(x, bn, sr), cols), sr)
    return dp > 0 if sr.dtype == torch.bool else dp
