"""The plain BFS reference against the full Jacobi step it stands for."""

import torch

from portbench.graphs import kronecker
from portbench.reference import bfs

KRON = {"scale": 9, "edgefactor": 8, "a": 0.57, "b": 0.19, "c": 0.19, "d": 0.05,
        "graph_seed": 3}


def _jacobi(n, rows, cols, vals, root, max_iter):
    """Every entry whose value is not 0 followed in every step, until a step
    changes nothing (that step counted)."""
    edge = vals != 0
    rows, cols = rows[edge].long(), cols[edge].long()
    x = torch.zeros(n, dtype=torch.bool)
    x[root] = True
    for steps in range(1, max_iter + 1):
        x_new = x.clone()
        x_new[rows[x[cols]]] = True
        if torch.equal(x_new, x):
            return x, steps, True
        x = x_new
    return x, max_iter, False


def test_bfs_follows_the_changed_columns_alone():
    rows, cols, vals, n = kronecker.make(KRON, 7, "cpu")
    # some entries of value 0, which are no edges, one of them a duplicate
    # of an entry that is
    vals = vals.clone()
    vals[::97] = 0.0
    graph = bfs.prepare(n, rows, cols, vals, "cpu")
    degree = torch.bincount(rows, minlength=n)
    for root in [int(r) for r in torch.nonzero(degree).flatten()[::37]] + [int(degree.argmin())]:
        for max_iter in (n + 1, 2):
            x, steps, done = bfs.solve(graph, root, max_iter)
            want = _jacobi(n, rows, cols, vals, root, max_iter)
            assert torch.equal(x, want[0]) and (steps, done) == want[1:], (root, max_iter)
