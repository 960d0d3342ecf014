"""The JAX package's benchmark band (``bench.py``: ``banded_coo(n, b)``):
every entry with |row − col| ≤ b present, values U[0.1, 1) in float32,
entries in row-major order (so the program finds no duplicate)."""

from __future__ import annotations

import torch


def make(params: dict, seed: int, device):
    n, b = int(params["n"]), int(params["bandwidth"])
    lo, hi = (float(v) for v in params["values"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = rows + torch.arange(-b, b + 1, dtype=torch.int64, device=device)[None, :]
    inside = (cols >= 0) & (cols < n)
    rows = rows.expand_as(cols)[inside]
    cols = cols[inside]
    vals = torch.rand(cols.numel(), generator=g, device=device) * (hi - lo) + lo
    return rows, cols, vals, n
