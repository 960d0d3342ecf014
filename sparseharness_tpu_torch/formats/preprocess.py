"""Algorithm-specific matrix preprocessing: pure functions over COO."""

from __future__ import annotations

import numpy as np

from sparseharness_tpu_torch.formats.sparse import COO


def pagerank_normalise(coo: COO, damping: float = 0.85) -> COO:
    """Column-stochastic scaling with damping: A'[i,j] = d·|A[i,j]| / colsum(j).

    Columns with zero sum (dangling nodes) keep value 0; the teleport term
    of the PageRank app carries their mass."""
    colsum = np.zeros(coo.shape[1], dtype=np.float64)
    np.add.at(colsum, coo.cols, np.abs(coo.vals.astype(np.float64)))
    safe = np.where(colsum[coo.cols] > 0, colsum[coo.cols], 1.0)
    new_vals = (np.abs(coo.vals.astype(np.float64)) / safe * damping).astype(
        coo.vals.dtype
    )
    return coo.with_values(new_vals)


def scc_normalise(coo: COO) -> COO:
    """Label-propagation matrix: value(i, j) = j off the diagonal, INT_MIN on
    it (so a vertex never propagates itself through the ⊗-select). The
    values are int32 whatever the input type."""
    int_min = np.iinfo(np.int32).min
    vals = np.where(coo.rows == coo.cols, int_min, coo.cols).astype(np.int32)
    return coo.with_values(vals)


def ensure_self_loops(coo: COO, value=1.0) -> COO:
    """Add the missing diagonal entries with ``value``."""
    present = np.zeros(coo.shape[0], dtype=bool)
    present[coo.rows[coo.rows == coo.cols]] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    if len(missing) == 0:
        return coo
    rows = np.concatenate([coo.rows, missing])
    cols = np.concatenate([coo.cols, missing])
    vals = np.concatenate(
        [coo.vals, np.full(len(missing), value, dtype=coo.vals.dtype)]
    )
    return COO(rows, cols, vals, coo.shape)
