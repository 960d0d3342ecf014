"""Plain single-source shortest paths: Jacobi Bellman-Ford in float32,

    x_k[i] = min(x_{k-1}[i], min_j (x_{k-1}[j] + A[i, j])),

from x_0 = FLT_MAX everywhere and 0 at the root, until a step changes
nothing (that step counted, as the fixpoint loop counts it) or n steps.
Only the columns j whose x changed in the step before can lower a row, so
each step relaxes the entries of those columns alone; the result and the
step count are those of the full Jacobi step. Each sum is one float32
addition, so the distances are exact, not approximate.

The reference of the ``solve`` driver for traffic whose ``algorithm`` is
``sssp``: ``prepare`` and ``solve``.
"""

from __future__ import annotations

import numpy as np
import torch

FLT_MAX = float(np.finfo(np.float32).max)


def prepare(n: int, rows, cols, vals, device) -> "ByColumn":
    return ByColumn(n, rows, cols, vals, device)


class ByColumn:
    """The entries sorted by column, with each column's range."""

    def __init__(self, n: int, rows, cols, vals, device):
        cols = torch.as_tensor(cols).to(device, torch.int64)
        order = torch.argsort(cols, stable=True)
        self.n = n
        self.rows = torch.as_tensor(rows).to(device, torch.int64)[order]
        self.vals = torch.as_tensor(vals).to(device, torch.float32)[order]
        counts = torch.bincount(cols, minlength=n)
        self.start = torch.zeros(n + 1, dtype=torch.int64, device=device)
        torch.cumsum(counts, 0, out=self.start[1:])


def solve(graph: ByColumn, root: int, max_iter: int):
    """(distances, steps, converged)."""
    dev = graph.rows.device
    x = torch.full((graph.n,), FLT_MAX, dtype=torch.float32, device=dev)
    x[root] = 0.0
    changed = torch.tensor([root], dtype=torch.int64, device=dev)
    steps = 0
    while steps < max_iter:
        steps += 1
        begin = graph.start[changed]
        counts = graph.start[changed + 1] - begin
        total = int(counts.sum())
        if total == 0:
            return x, steps, True
        ends = torch.cumsum(counts, 0)
        idx = (torch.arange(total, device=dev)
               + torch.repeat_interleave(begin - (ends - counts), counts, output_size=total))
        src = torch.repeat_interleave(changed, counts, output_size=total)
        cand = x[src] + graph.vals[idx]
        x_new = x.scatter_reduce(0, graph.rows[idx], cand, "amin", include_self=True)
        changed = torch.nonzero(x_new != x).flatten()
        x = x_new
        if changed.numel() == 0:
            return x, steps, True
    return x, steps, False
