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
