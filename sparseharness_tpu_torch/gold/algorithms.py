"""Classical NumPy golds for the fixpoint apps, independent of the semiring
code path: Bellman-Ford for SSSP, frontier BFS, power iteration for
PageRank, min-label propagation for connected components and max-min
propagation for widest paths.

Edge convention: ``A[i, j] != 0`` is an edge j → i (so y = A ⊗ x
propagates along edges), matching the SpMV dataflow.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from sparseharness_tpu_torch.formats.sparse import COO

FLT_MAX = float(np.finfo(np.float32).max)


def sssp_gold(coo: COO, root: int, max_iter: Optional[int] = None) -> np.ndarray:
    """Bellman-Ford distances from root; unreachable = FLT_MAX."""
    n = coo.shape[0]
    dist = np.full(n, FLT_MAX, dtype=np.float64)
    dist[root] = 0.0
    it = 0
    limit = max_iter if max_iter is not None else n
    changed = True
    while changed and it < limit:
        nd = dist[coo.cols] + coo.vals.astype(np.float64)
        upd = np.full(n, FLT_MAX, dtype=np.float64)
        np.minimum.at(upd, coo.rows, nd)
        new = np.minimum(dist, upd)
        changed = not np.array_equal(new, dist)
        dist = new
        it += 1
    return np.where(dist >= FLT_MAX, FLT_MAX, dist).astype(np.float32)


def bfs_reach_gold(coo: COO, root: int) -> np.ndarray:
    """Boolean reachability from root (the or/and fixpoint's limit)."""
    n = coo.shape[0]
    reach = np.zeros(n, dtype=bool)
    reach[root] = True
    frontier = reach.copy()
    while frontier.any():
        nxt = np.zeros(n, dtype=bool)
        np.logical_or.at(nxt, coo.rows, frontier[coo.cols])
        frontier = nxt & ~reach
        reach |= frontier
    return reach


def bfs_levels_gold(coo: COO, root: int) -> np.ndarray:
    """BFS level per vertex; -1 = unreachable."""
    n = coo.shape[0]
    level = np.full(n, -1, dtype=np.int32)
    level[root] = 0
    frontier = np.zeros(n, dtype=bool)
    frontier[root] = True
    d = 0
    while frontier.any():
        d += 1
        nxt = np.zeros(n, dtype=bool)
        np.logical_or.at(nxt, coo.rows, frontier[coo.cols])
        frontier = nxt & (level < 0)
        level[frontier] = d
    return level


def pagerank_gold(coo: COO, damping: float = 0.85, tol: float = 1e-6,
                  max_iter: int = 1000) -> np.ndarray:
    """Power iteration on the column-stochastic damped matrix with uniform
    teleport: x0 = 1/N, teleport (1−d)/N per iteration."""
    n = coo.shape[0]
    colsum = np.zeros(n, dtype=np.float64)
    np.add.at(colsum, coo.cols, np.abs(coo.vals.astype(np.float64)))
    w = np.abs(coo.vals.astype(np.float64)) / np.where(
        colsum[coo.cols] > 0, colsum[coo.cols], 1.0
    )
    x = np.full(n, 1.0 / n, dtype=np.float64)
    for _ in range(max_iter):
        y = np.zeros(n, dtype=np.float64)
        np.add.at(y, coo.rows, w * x[coo.cols])
        new = damping * y + (1.0 - damping) / n
        if np.abs(new - x).max() < tol:
            x = new
            break
        x = new
    return x.astype(np.float32)


def connected_components_gold(coo: COO) -> np.ndarray:
    """Undirected connected components via min-label propagation (edges
    treated as bidirectional)."""
    n = coo.shape[0]
    label = np.arange(n, dtype=np.int64)
    rows = np.concatenate([coo.rows, coo.cols])
    cols = np.concatenate([coo.cols, coo.rows])
    for _ in range(n):
        upd = np.full(n, n + 1, dtype=np.int64)
        np.minimum.at(upd, rows, label[cols])
        new = np.minimum(label, upd)
        if np.array_equal(new, label):
            break
        label = new
    return label.astype(np.int32)


def widest_path_gold(coo: COO, root: int) -> np.ndarray:
    """Max-min (bottleneck) path widths from root; unreachable = -FLT_MAX,
    root = +FLT_MAX (the ⊗-identity)."""
    n = coo.shape[0]
    lo = float(-np.finfo(np.float32).max)
    hi = float(np.finfo(np.float32).max)
    width = np.full(n, lo, dtype=np.float64)
    width[root] = hi
    for _ in range(n):
        cand = np.minimum(width[coo.cols], coo.vals.astype(np.float64))
        upd = np.full(n, lo, dtype=np.float64)
        np.maximum.at(upd, coo.rows, cand)
        new = np.maximum(width, upd)
        if np.array_equal(new, width):
            break
        width = new
    return width.astype(np.float32)
