"""Plain breadth-first search: Jacobi reachability over (or, and),

    x_k[i] = x_{k-1}[i] or any_j (A[i, j] != 0 and x_{k-1}[j]),

from x_0 true at the root alone, until a step changes nothing (that step
counted, as the fixpoint loop counts it) or ``max_iter`` steps. Only the
columns j that a step before made true can reach a new row, so each step
follows the entries of those columns alone; the result and the step count
are those of the full Jacobi step. An entry whose value is 0 is no edge,
and duplicate entries are one edge if any of them is not 0. The answer is
boolean, so it is exact.

The reference of the ``solve`` driver for traffic whose ``algorithm`` is
``bfs``: ``prepare`` and ``solve``.
"""

from __future__ import annotations

import torch


def prepare(n: int, rows, cols, vals, device) -> "ByColumn":
    return ByColumn(n, rows, cols, vals, device)


class ByColumn:
    """The edges (entries whose value is not 0) sorted by column, with each
    column's range."""

    def __init__(self, n: int, rows, cols, vals, device):
        edge = torch.as_tensor(vals).to(device) != 0
        cols = torch.as_tensor(cols).to(device, torch.int64)[edge]
        order = torch.argsort(cols, stable=True)
        self.n = n
        self.rows = torch.as_tensor(rows).to(device, torch.int64)[edge][order]
        counts = torch.bincount(cols, minlength=n)
        self.start = torch.zeros(n + 1, dtype=torch.int64, device=device)
        torch.cumsum(counts, 0, out=self.start[1:])


def solve(graph: ByColumn, root: int, max_iter: int):
    """(reachability, steps, converged)."""
    dev = graph.rows.device
    x = torch.zeros(graph.n, dtype=torch.bool, device=dev)
    x[root] = True
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
        reached = graph.rows[idx]
        changed = torch.unique(reached[~x[reached]])
        if changed.numel() == 0:
            return x, steps, True
        x[changed] = True
    return x, steps, False
