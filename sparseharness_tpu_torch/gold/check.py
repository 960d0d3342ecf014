"""Result correctness checking.

Float comparisons honour the tolerance; integer and bool results compare
exactly.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np


class Correctness(enum.Enum):
    CORRECT = "correct"
    GENERALLY_CORRECT = "generally_correct"  # all but ≤0.1% of elements match
    INCORRECT = "incorrect"
    NOT_CHECKED = "not_checked"
    BAD_LENGTH = "bad_length"


def check_result(
    result,
    gold: Optional[np.ndarray],
    delta: float = 1e-4,
    exact: bool = False,
    scale: Optional[np.ndarray] = None,
) -> Correctness:
    """`scale`, when given, is the per-element backward-error magnitude
    (e.g. gold.spmv_abs_bound: Σ|contrib| per row) — the sound comparison
    scale for float reductions whose terms cancel; without it the
    tolerance is relative-to-gold-or-1."""
    if gold is None or (hasattr(gold, "size") and gold.size == 0):
        return Correctness.NOT_CHECKED
    result = np.asarray(result)
    gold = np.asarray(gold)
    if result.shape != gold.shape:
        return Correctness.BAD_LENGTH
    if exact or not np.issubdtype(result.dtype, np.floating):
        mismatch = result != gold
    else:
        a = result.astype(np.float64)
        b = gold.astype(np.float64)
        ref = np.maximum(1.0, np.abs(b))
        if scale is not None:
            ref = np.maximum(ref, np.asarray(scale, np.float64))
        # relative-or-absolute tolerance; matching non-finites are equal
        finite_close = np.abs(a - b) <= delta * ref
        nonfinite_eq = ~np.isfinite(b) & (a == b)
        mismatch = ~(finite_close | nonfinite_eq)
    n_bad = int(np.count_nonzero(mismatch))
    if n_bad == 0:
        return Correctness.CORRECT
    if n_bad <= max(1, result.size // 1000):
        return Correctness.GENERALLY_CORRECT
    return Correctness.INCORRECT
