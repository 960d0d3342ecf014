"""First-class semirings over torch tensors.

One SpMV implementation serves every semiring: a semiring is a frozen
dataclass of elementwise torch ops, and the kernels take it as a code. The
canonical SpMV is::

    y_out[i] = (alpha ⊗ (⊕_j  A[i, j] ⊗ x[j]))  ⊕  (beta ⊗ y[i])

with the ⊕-identity ``zero`` used as both the reduction seed and the
padding annihilator (a ⊗ zero = zero for every semiring here, so padded
slots vanish under the reduction).

``mul(x_j, a_ij)`` takes the *vector* element first and the *matrix*
element second; the non-commutative ``max_right`` and ``min_right`` depend
on that order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

Tensor = torch.Tensor

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A commutative-monoid ⊕ with an (optionally non-commutative) ⊗.

    Attributes:
      name: registry key.
      add: elementwise ⊕ of two tensors.
      mul: elementwise ⊗; called as ``mul(x_vector_elem, a_matrix_elem)``.
      zero: identity of ⊕ and annihilator of ⊗ (python scalar).
      one: identity of ⊗ (python scalar).
      dtype: element dtype on the device.
      add_reduce: ⊕-reduction along ``dim`` (must agree with ``add``).
      exact_convergence: fixpoints stop on exact equality (int/bool
        semirings) rather than |Δ| < delta (float semirings).
    """

    name: str
    add: Callable[[Tensor, Tensor], Tensor]
    mul: Callable[[Tensor, Tensor], Tensor]
    zero: Any
    one: Any
    dtype: torch.dtype
    add_reduce: Callable[..., Tensor]
    exact_convergence: bool = False

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(_NP_DTYPES[self.dtype])

    def scale(self, alpha, a: Tensor) -> Tensor:
        """alpha ⊗ a, skipping the op when alpha is the static ⊗-identity
        (apps pass alpha = one, and the skip saves a pass over the vector)."""
        if _is_static(alpha, self.one):
            return a
        return self.mul(torch.as_tensor(alpha, dtype=self.dtype, device=a.device), a)

    def fold_axby(self, alpha, dp: Tensor, beta, y: Tensor) -> Tensor:
        """(alpha ⊗ dp) ⊕ (beta ⊗ y) — the reference's doubleMultiplyAdd."""
        left = self.scale(alpha, dp)
        if _is_static(beta, self.zero):
            # beta = ⊕-identity = ⊗-annihilator ⇒ (beta ⊗ y) = zero ⇒ ⊕ no-op
            return left
        beta_t = torch.as_tensor(beta, dtype=self.dtype, device=y.device)
        return self.add(left, self.mul(beta_t, y))

    def np_zero(self):
        return np.asarray(self.zero, dtype=self.np_dtype)


def _is_static(v, const) -> bool:
    """True iff v is a concrete python/numpy scalar equal to const."""
    if isinstance(v, (int, float, bool, np.generic)):
        return bool(v == const)
    return False


REGISTRY: Dict[str, Semiring] = {}


def register_semiring(sr: Semiring) -> Semiring:
    REGISTRY[sr.name] = sr
    return sr


def get_semiring(name: str) -> Semiring:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown semiring {name!r}; known: {sorted(REGISTRY)}"
        ) from None


FLT_MAX = float(np.finfo(np.float32).max)
INT_MIN = int(np.iinfo(np.int32).min)
INT_MAX = int(np.iinfo(np.int32).max)

#: float arithmetic (+, ×) — spmv / pagerank
PLUS_TIMES = register_semiring(Semiring(
    name="plus_times", add=torch.add, mul=torch.mul, zero=0.0, one=1.0,
    dtype=torch.float32, add_reduce=torch.sum,
))

#: tropical (min, +) — SSSP; zero = FLT_MAX
MIN_PLUS = register_semiring(Semiring(
    name="min_plus", add=torch.minimum, mul=torch.add, zero=FLT_MAX, one=0.0,
    dtype=torch.float32, add_reduce=torch.amin,
))

#: boolean (or, and) — BFS reachability
OR_AND = register_semiring(Semiring(
    name="or_and", add=torch.logical_or, mul=torch.logical_and, zero=False,
    one=True, dtype=torch.bool, add_reduce=torch.any, exact_convergence=True,
))

#: (max, min) — bottleneck / widest path
MAX_MIN = register_semiring(Semiring(
    name="max_min", add=torch.maximum, mul=torch.minimum, zero=-FLT_MAX,
    one=FLT_MAX, dtype=torch.float32, add_reduce=torch.amax,
))

#: (max, ×) on nonnegative floats — max-probability paths
MAX_TIMES = register_semiring(Semiring(
    name="max_times", add=torch.maximum, mul=torch.mul, zero=0.0, one=1.0,
    dtype=torch.float32, add_reduce=torch.amax,
))


def _select_left(l, r):
    """⊗ that passes the vector element through any present edge; absent
    edges (padded with zero = INT_MIN) annihilate, so it gates on r."""
    return torch.where(r == INT_MIN, r, l)


def _select_left_min(l, r):
    """⊗ for min-label propagation; absent edges (zero = INT_MAX) annihilate."""
    return torch.where(r == INT_MAX, r, l)


#: (min, select-vector-elem) on int32 — min-label propagation
MIN_RIGHT = register_semiring(Semiring(
    name="min_right", add=torch.minimum, mul=_select_left_min, zero=INT_MAX,
    one=0,  # unused: `one` has no meaning for the select product
    dtype=torch.int32, add_reduce=torch.amin, exact_convergence=True,
))

#: (max, select-vector-elem) on int32 — SCC max-label propagation
MAX_RIGHT = register_semiring(Semiring(
    name="max_right", add=torch.maximum, mul=_select_left, zero=INT_MIN,
    one=0,  # unused: `one` has no meaning for the select product
    dtype=torch.int32, add_reduce=torch.amax, exact_convergence=True,
))


def _np_fold_for(sr: Semiring, as_int: bool):
    """NumPy ⊕ mirror for folding duplicates at build time."""
    if as_int:
        return np.maximum  # {0,1} carrier: or ≡ max
    return {"plus_times": np.add, "min_plus": np.minimum,
            "max_min": np.maximum, "max_times": np.maximum,
            "min_right": np.minimum, "max_right": np.maximum}.get(
                sr.name, np.add)


def _carrier(sr: Semiring):
    """(dtype, add, mul, reduce, zero, carried_as_int) with bool → int32.

    Kernels carry ``or_and`` as int32 with ⊕ = max and ⊗ = min on {0, 1};
    the dp then ends with ``dp > 0``."""
    if sr.dtype == torch.bool:
        return torch.int32, torch.maximum, torch.minimum, torch.amax, 0, True
    return sr.dtype, sr.add, sr.mul, sr.add_reduce, sr.zero, False
