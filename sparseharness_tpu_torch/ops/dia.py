"""The ``dia`` (diagonal) variant, in plain torch: gather-free by
construction.

For matrices whose nonzeros sit on few diagonals::

    dp[i] = ⊕_j  vals[j, i] ⊗ x[i + off_j]

Every term is an elementwise ⊗ against a shifted slice of x, and the terms
are ⊕-combined in a balanced tree, in the JAX package's order. The JAX
package lowers this through XLA with no Pallas kernel, so it stays plain
torch here; ``auto`` routes banded structure to ``bsr_band`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from sparseharness_tpu_torch.formats.sparse import COO, fold_duplicates
from sparseharness_tpu_torch.semiring import Semiring
from sparseharness_tpu_torch.semiring.core import _np_fold_for
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device

# beyond this many distinct diagonals the format degrades to dense-like
# traffic; the build refuses so that other variants take the matrix
MAX_DIAGONALS = 512


@dataclasses.dataclass(frozen=True)
class DiaOperand:
    """vals[j, :] holds diagonal off_j: vals[j, i] = A[i, i + off_j]."""

    vals: torch.Tensor
    offsets: Tuple[int, ...]


def build_dia(coo: COO, sr: Semiring, *, device: DeviceLike = None) -> DiaOperand:
    device = resolve_device(device)
    if coo.shape[0] != coo.shape[1]:
        raise NotImplementedError("dia variant requires a square matrix")
    coo = fold_duplicates(coo, _np_fold_for(sr, False))
    n = coo.shape[0]
    offs_all = coo.cols.astype(np.int64) - coo.rows.astype(np.int64)
    offsets = np.unique(offs_all)
    if len(offsets) > MAX_DIAGONALS:
        raise NotImplementedError(
            f"{len(offsets)} diagonals exceeds DIA limit {MAX_DIAGONALS}")
    vals = np.full((max(len(offsets), 1), n), sr.np_zero(), dtype=sr.np_dtype)
    vals[np.searchsorted(offsets, offs_all), coo.rows] = coo.vals.astype(sr.np_dtype)
    return DiaOperand(torch.from_numpy(vals).to(device), tuple(offsets.tolist()))


def dp_dia(op: DiaOperand, x: torch.Tensor, sr: Semiring, *,
           n_rows: int) -> torch.Tensor:
    n = n_rows
    offs = op.offsets
    if not offs:
        return torch.full((n,), sr.zero, dtype=sr.dtype, device=x.device)
    span_lo = max(0, -min(offs))
    span_hi = max(0, max(offs))
    x_pad = torch.full((span_lo + x.shape[0] + span_hi,), sr.zero,
                       dtype=sr.dtype, device=x.device)
    x_pad[span_lo: span_lo + x.shape[0]] = x.to(sr.dtype)
    terms = [sr.mul(x_pad[span_lo + o: span_lo + o + n], op.vals[j, :n])
             for j, o in enumerate(offs)]
    # a balanced ⊕ tree, as the JAX package combines them
    while len(terms) > 1:
        terms = [sr.add(terms[i], terms[i + 1]) if i + 1 < len(terms) else terms[i]
                 for i in range(0, len(terms), 2)]
    return terms[0]
