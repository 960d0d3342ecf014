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
