"""Seeded synthetic matrices and graphs.

NumPy throughout, so that one seed gives the same matrix here and in the
JAX package.
"""

from __future__ import annotations

import numpy as np

from sparseharness_tpu_torch.formats.sparse import COO, coo_from_arrays


def _dedup(rows, cols, vals, shape) -> COO:
    key = rows.astype(np.int64) * shape[1] + cols
    _, idx = np.unique(key, return_index=True)
    return coo_from_arrays(rows[idx], cols[idx], vals[idx], shape)


def random_coo(
    n_rows: int,
    n_cols: int,
    nnz: int,
    dtype=np.float32,
    seed: int = 0,
    value_range=(0.1, 1.0),
) -> COO:
    """Uniform-random sparsity pattern; duplicates removed (nnz may shrink)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, size=nnz, dtype=np.int64)
    cols = rng.integers(0, n_cols, size=nnz, dtype=np.int64)
    vals = rng.uniform(*value_range, size=nnz).astype(dtype)
    return _dedup(rows, cols, vals, (n_rows, n_cols))


def random_graph_coo(
    n: int,
    avg_degree: float,
    dtype=np.float32,
    seed: int = 0,
    weight_range=(0.1, 1.0),
    connected: bool = True,
) -> COO:
    """Random directed graph adjacency; optionally chained for connectivity."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree)
    rows = rng.integers(0, n, size=m, dtype=np.int64)
    cols = rng.integers(0, n, size=m, dtype=np.int64)
    if connected and n > 1:
        # a chain 0 → 1 → … → n-1 makes every vertex reachable from 0
        # (A[i, j] != 0 is the edge j → i)
        chain_src = np.arange(n - 1, dtype=np.int64)
        rows = np.concatenate([rows, chain_src + 1])
        cols = np.concatenate([cols, chain_src])
    vals = rng.uniform(*weight_range, size=len(rows)).astype(dtype)
    return _dedup(rows, cols, vals, (n, n))


def banded_coo(n: int, bandwidth: int, dtype=np.float32, seed: int = 0) -> COO:
    """Banded matrix: every |row − col| ≤ bandwidth present."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-bandwidth, bandwidth + 1)
    rows_list, cols_list = [], []
    for o in offs:
        r = np.arange(max(0, -o), min(n, n - o), dtype=np.int64)
        rows_list.append(r)
        cols_list.append(r + o)
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    vals = rng.uniform(0.1, 1.0, size=len(rows)).astype(dtype)
    return _dedup(rows, cols, vals, (n, n))


def stencil27_coo(nx: int, ny: int, nz: int, dtype=np.float32, seed: int = 0) -> COO:
    """HPCG's matrix (``src/GenerateProblem_ref.cpp`` of its reference
    code): the 27-point stencil on an nx × ny × nz grid with no halo. Row
    ``iz·nx·ny + iy·nx + ix`` holds a column for each neighbour inside the
    grid, ascending, with no duplicate; values U[0.1, 1)."""
    n = nx * ny * nz
    row = np.arange(n, dtype=np.int64)[:, None]
    s = np.array([-1, 0, 1])
    sz, sy, sx = (a.ravel() for a in np.meshgrid(s, s, s, indexing="ij"))
    inside = np.ones((n, 27), dtype=bool)
    for i, d, size in ((row % nx, sx, nx), (row // nx % ny, sy, ny), (row // (nx * ny), sz, nz)):
        inside &= (i + d >= 0) & (i + d < size)
    cols = (row + (sz * nx * ny + sy * nx + sx))[inside]
    rows = np.broadcast_to(row, inside.shape)[inside]
    vals = np.random.default_rng(seed).uniform(0.1, 1.0, rows.size).astype(dtype)
    return coo_from_arrays(rows, cols, vals, (n, n))


def power_law_coo(n: int, nnz: int, alpha: float = 1.5, dtype=np.float32,
                  seed: int = 0) -> COO:
    """Power-law pattern: zipf-distributed column popularity over uniform
    rows, with half of the entries transposed so that some rows are heavy
    too — the ragged-row stress case."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(alpha, size=nnz).astype(np.int64)
    cols = np.minimum(ranks - 1, n - 1)
    rows = rng.integers(0, n, size=nnz, dtype=np.int64)
    swap = rng.random(nnz) < 0.5
    rows2 = np.where(swap, cols, rows)
    cols2 = np.where(swap, rows, cols)
    vals = rng.uniform(0.1, 1.0, size=nnz).astype(dtype)
    return _dedup(rows2, cols2, vals, (n, n))


def deep_hub_coo(n: int = 4224, hub: int = 4100, background: int = 170_000,
                 dtype=np.float32, seed: int = 3) -> COO:
    """Row 0 holds ``hub`` entries at distinct columns over ``background``
    uniform entries that avoid row 0's lane (every row ≡ 0 mod 128): with
    more than 64² hub entries, sell chains row 0 through three levels past
    level 0, while the lane's short phase-A stream keeps the build within
    its stream and padding limits. Duplicates are kept."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, 2 * background)
    r = r[r % 128 != 0][:background]
    rows = np.concatenate([np.zeros(hub, np.int64), r])
    cols = np.concatenate([rng.choice(n, hub, replace=False), rng.integers(0, n, len(r))])
    return coo_from_arrays(rows, cols, rng.uniform(0.1, 1.0, len(rows)).astype(dtype), (n, n))


def chained_power_law_coo(n: int, clusters: int, nnz_per_node: float = 4.0,
                          alpha: float = 1.5, dtype=np.float32, seed: int = 0,
                          weight_range=(0.1, 1.0)) -> COO:
    """``clusters`` power-law blobs strung on a path by bidirectional bridge
    edges: scattered local structure with a diameter that grows with
    ``clusters``. The order is ``clusters * max(n // clusters, 2)``; read it
    off ``.shape``."""
    m = max(n // clusters, 2)
    sub = power_law_coo(m, int(nnz_per_node * m), alpha=alpha, seed=seed + 1)
    lo, hi = weight_range
    shift = np.arange(clusters, dtype=np.int64)[:, None] * m
    rows = [(sub.rows.astype(np.int64)[None, :] + shift).reshape(-1)]
    cols = [(sub.cols.astype(np.int64)[None, :] + shift).reshape(-1)]
    vals = [np.tile(np.abs(sub.vals).astype(dtype) + lo, clusters)]
    link = np.arange(1, clusters, dtype=np.int64) * m
    rows.append(np.concatenate([link, link - 1]))
    cols.append(np.concatenate([link - 1, link]))
    vals.append(np.full(2 * link.size, (lo + hi) / 2, dtype))
    n_tot = clusters * m
    return _dedup(np.concatenate(rows), np.concatenate(cols),
                  np.concatenate(vals), (n_tot, n_tot))


def block_random_coo(n: int, blocks_per_row: int, bm: int = 8, bn: int = 128,
                     dtype=np.float32, seed: int = 0,
                     value_range=(0.1, 1.0)) -> COO:
    """Block-structured random sparsity: every bm-row block-row gets
    ``blocks_per_row`` fully occupied (bm, bn) blocks at distinct random
    block-columns, the structure blocked layouts exist for. Entries come in
    block order, not sorted by row."""
    rng = np.random.default_rng(seed)
    n_br = max(n // bm, 1)
    n_bc = max(n // bn, 1)
    k = min(blocks_per_row, n_bc)
    # distinct block-cols per block-row: the k smallest of random keys
    keys = rng.random((n_br, n_bc))
    bcols = np.argpartition(keys, k - 1, axis=1)[:, :k]
    br = np.repeat(np.arange(n_br, dtype=np.int64), k)
    bc = bcols.reshape(-1).astype(np.int64)
    rr = (br[:, None] * bm + np.arange(bm)[None, :]).reshape(-1)
    rows = np.repeat(rr, bn)
    cc = bc[:, None] * bn + np.arange(bn)[None, :]
    cols = np.tile(cc.reshape(len(br), 1, bn), (1, bm, 1)).reshape(-1)
    vals = rng.uniform(*value_range, size=len(rows)).astype(dtype)
    keep = (rows < n) & (cols < n)
    return coo_from_arrays(rows[keep], cols[keep], vals[keep], (n, n))
