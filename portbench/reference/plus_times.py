"""Plain plus_times SpMV: y[i] = Σ_j A[i, j] · x[j] in float64, with
Σ_j |A[i, j] · x[j]|, the scale its rounding error is judged by.
Duplicate entries add, as the program's fold under plus_times does.

The reference of the ``spmv`` driver for traffic whose ``semiring`` is
``plus_times``: ``product`` and ``rel_err``."""

from __future__ import annotations

import torch

BLOCK = 1 << 24  # entries a pass, so that the float64 temporaries fit


def product(n_rows: int, rows, cols, vals, x):
    """(y, absum), float64 tensors of n_rows on x's device."""
    x64 = x.to(torch.float64)
    y = torch.zeros(n_rows, dtype=torch.float64, device=x.device)
    absum = torch.zeros_like(y)
    for s in range(0, rows.numel(), BLOCK):
        r = rows[s:s + BLOCK].to(x.device, torch.int64)
        prod = vals[s:s + BLOCK].to(x.device, torch.float64) * x64[
            cols[s:s + BLOCK].to(x.device, torch.int64)]
        y.index_add_(0, r, prod)
        absum.index_add_(0, r, prod.abs())
    return y, absum


def rel_err(y, y_ref, absum) -> float:
    """The widest gap between y and the reference, each row's over its
    Σ|a·x| (1e-30 where that is 0); NaN reads as infinity."""
    gap = (y.to(torch.float64) - y_ref).abs() / absum.clamp_min(1e-30)
    gap = torch.nan_to_num(gap, nan=float("inf"))
    return float(gap.max()) if gap.numel() else 0.0
