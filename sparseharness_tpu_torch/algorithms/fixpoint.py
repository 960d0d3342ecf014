"""Iterate-to-fixpoint loop.

A Python loop around the step with one convergence-flag readback per
iteration, with the stop rule of the JAX package's ``lax.while_loop``:
``iterations`` counts steps taken, ``converged`` is the last step's flag,
and the loop stops at the first converged step or at ``max_iter``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class FixpointResult(NamedTuple):
    x: torch.Tensor        # the fixpoint vector
    iterations: int        # SpMV steps performed
    converged: bool        # False ⇒ stopped at max_iter
    aux: Optional[torch.Tensor] = None  # algorithm extra (e.g. BFS levels)


def delta_converged(delta: float):
    """|x_new − x| < delta everywhere (float semirings; FLT_MAX − FLT_MAX = 0,
    so 'both unreachable' converges)."""

    def pred(x_old, x_new):
        return torch.all(torch.abs(x_new - x_old) < delta)

    return pred


def exact_converged(x_old, x_new):
    """Bitwise x_new == x_old (int and bool semirings, and exact SSSP)."""
    return torch.equal(x_old, x_new)


def run_fixpoint(
    step_fn: Callable,
    x0: torch.Tensor,
    *,
    convergence: Callable,
    max_iter: int = 10_000,
    aux0: Optional[torch.Tensor] = None,
    aux_update: Optional[Callable] = None,
) -> FixpointResult:
    """Iterate ``x ← step_fn(x)`` until ``convergence(x, x_new)`` or max_iter.

    ``aux_update(aux, x_old, x_new, it)`` optionally threads a side array
    through the loop (e.g. BFS level stamping)."""
    x, aux, it, done = x0, aux0, 0, False
    while not done and it < max_iter:
        x_new = step_fn(x)
        done = bool(convergence(x, x_new))  # the one readback per iteration
        if aux0 is not None and aux_update is not None:
            aux = aux_update(aux, x, x_new, it)
        x, it = x_new, it + 1
    return FixpointResult(x=x, iterations=it, converged=done, aux=aux)
