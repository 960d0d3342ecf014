"""NumPy gold semiring SpMV, independent of the torch code under test::

    y_out[i] = (alpha ⊗ (⊕_j A[i,j] ⊗ x[j])) ⊕ (beta ⊗ y[i])
"""

from __future__ import annotations

import numpy as np

from sparseharness_tpu_torch.formats.sparse import COO
from sparseharness_tpu_torch.semiring import Semiring

# numpy mirrors of each registered semiring's ops, keyed by name
_NP_OPS = {
    "plus_times": (np.add, np.multiply),
    "min_plus": (np.minimum, np.add),
    "or_and": (np.logical_or, np.logical_and),
    "max_min": (np.maximum, np.minimum),
    "max_times": (np.maximum, np.multiply),
}


def _np_ops(sr: Semiring):
    if sr.name == "max_right":
        int_min = np.iinfo(np.int32).min

        def mul(l, r):
            return np.where(r == int_min, r, l)

        return np.maximum, mul
    if sr.name == "min_right":
        int_max = np.iinfo(np.int32).max

        def mul(l, r):
            return np.where(r == int_max, r, l)

        return np.minimum, mul
    return _NP_OPS[sr.name]


def spmv_gold(coo: COO, x: np.ndarray, y: np.ndarray, sr: Semiring,
              alpha=None, beta=None) -> np.ndarray:
    """⊕-scatter per nonzero (O(nnz)), then the α/β fold once per row."""
    add, mul = _np_ops(sr)
    if alpha is None:
        alpha = sr.one
    if beta is None:
        beta = sr.zero
    dtype = sr.np_dtype
    x = np.asarray(x, dtype)
    y = np.asarray(y, dtype)

    dp = np.full(coo.shape[0], sr.np_zero(), dtype=dtype)
    contrib = mul(x[coo.cols], coo.vals.astype(dtype))
    # fold contributions row by row with ⊕ (np.ufunc.at handles duplicates
    # sequentially, unlike fancy assignment)
    add.at(dp, coo.rows, contrib)

    left = dp if _eq(alpha, sr.one) else mul(np.asarray(alpha, dtype), dp)
    if _eq(beta, sr.zero):
        out = left
    else:
        out = add(left, mul(np.asarray(beta, dtype), y))
    return np.asarray(out, dtype)


def _eq(a, b) -> bool:
    return bool(np.asarray(a) == np.asarray(b))


def spmv_abs_bound(coo: COO, x: np.ndarray) -> np.ndarray:
    """Per-row Σ_j |A[i,j]·x[j]| — the backward-error scale for float SpMV.
    Reassociating an f32 sum perturbs the result by O(eps·Σ|contrib|), so
    rows whose terms cancel are only comparable against this scale."""
    bound = np.zeros(coo.shape[0], dtype=np.float64)
    np.add.at(
        bound, coo.rows,
        np.abs(coo.vals.astype(np.float64) * np.asarray(x, np.float64)[coo.cols]),
    )
    return bound


def spmv_gold_reference_quirk(coo: COO, x: np.ndarray, y: np.ndarray, alpha: float,
                              beta: float, zero: float) -> np.ndarray:
    """Bit-for-bit model of the reference's quirky Gold<T>::spmv
    (inc/spmv_gold.h:9-28): per nonzero ``acc += alpha*(x[col]*val) +
    beta*y[val]``, values integer-truncated by the ellpack path, and the
    matrix effectively transposed (rows keyed on the file's second
    coordinate). Kept to document the reference's behaviour; no check uses
    it."""
    ell_rows = coo.cols  # reference rows = second stored coordinate
    ell_cols = coo.rows
    vals = coo.vals.astype(np.int32).astype(np.float64)  # int truncation quirk
    out = np.full(coo.shape[1], 0.0, dtype=np.float64)
    n = len(y)
    for r, c, v in zip(ell_rows, ell_cols, vals):
        y_idx = int(v) % n if n else 0
        out[r] += alpha * (float(x[c]) * v) + beta * float(y[y_idx])
    # every row's accumulator is seeded with `zero` (inc/spmv_gold.h:19)
    out = out + zero
    return out.astype(np.float32)
