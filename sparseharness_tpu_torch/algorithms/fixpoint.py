"""Iterate-to-fixpoint loop.

A Python loop around the step with one convergence-flag readback per
iteration, with the stop rule of the JAX package's ``lax.while_loop``:
``iterations`` counts steps taken, ``converged`` is the last step's flag,
and the loop stops at the first converged step or at ``max_iter``.

The stepped form yields after every step (per-iteration timing records),
and the checkpointed form solves in chunks and writes its progress to an
``.npz`` that a rerun resumes from.

While spans are recorded (``utils/timing.py``), a solve is a
``fixpoint.solve`` span (attribute ``iterations``) holding, for each step,
``fixpoint.step`` around the step, ``fixpoint.converged`` around the
convergence test and its readback, and ``fixpoint.aux`` around an
``aux_update``. The loop checks once a solve whether to record them.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from sparseharness_tpu_torch.utils import timing
from sparseharness_tpu_torch.utils.timing import span


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
    if timing.RECORDING:
        return _run_fixpoint_spans(step_fn, x0, convergence, max_iter, aux0, aux_update)
    x, aux, it, done = x0, aux0, 0, False
    while not done and it < max_iter:
        x_new = step_fn(x)
        done = bool(convergence(x, x_new))  # the one readback per iteration
        if aux0 is not None and aux_update is not None:
            aux = aux_update(aux, x, x_new, it)
        x, it = x_new, it + 1
    return FixpointResult(x=x, iterations=it, converged=done, aux=aux)


def _run_fixpoint_spans(step_fn, x0, convergence, max_iter, aux0, aux_update) -> FixpointResult:
    """:func:`run_fixpoint`'s loop, each part in its span."""
    x, aux, it, done = x0, aux0, 0, False
    with span("fixpoint.solve") as solve:
        while not done and it < max_iter:
            with span("fixpoint.step"):
                x_new = step_fn(x)
            with span("fixpoint.converged"):
                done = bool(convergence(x, x_new))
            if aux0 is not None and aux_update is not None:
                with span("fixpoint.aux"):
                    aux = aux_update(aux, x, x_new, it)
            x, it = x_new, it + 1
        solve.set(iterations=it)
    return FixpointResult(x=x, iterations=it, converged=done, aux=aux)


def make_stepped_step(step_fn: Callable, convergence: Callable):
    """One ``x → (x_new, converged_flag)`` step, run eagerly."""

    def one_step(x):
        x_new = step_fn(x)
        return x_new, convergence(x, x_new)

    return one_step


def _spanned_step(step_fn: Callable, convergence: Callable):
    """One ``x → (x_new, converged)`` step, the step and the convergence
    test with its readback each in its span."""

    def one_step(x):
        with span("fixpoint.step"):
            x_new = step_fn(x)
        with span("fixpoint.converged"):
            return x_new, bool(convergence(x, x_new))

    return one_step


def run_fixpoint_stepped(
    step_fn: Callable,
    x0: torch.Tensor,
    *,
    convergence: Callable,
    max_iter: int,
):
    """Host-stepped fixpoint: yields (x, iterations, converged) after every
    step, with one readback of the convergence flag per step (which waits
    for the step's kernels); ``fixpoint.step`` and ``fixpoint.converged``
    spans where they are recorded."""
    one_step = (_spanned_step if timing.RECORDING else make_stepped_step)(step_fn, convergence)
    x, iters, converged = x0, 0, False
    while iters < max_iter and not converged:
        x, flag = one_step(x)
        converged = bool(flag)
        iters += 1
        yield x, iters, converged


def run_fixpoint_checkpointed(
    step_fn: Callable,
    x0: torch.Tensor,
    *,
    convergence: Callable,
    max_iter: int,
    ckpt_path: str,
    every: int = 100,
    aux0: Optional[torch.Tensor] = None,
    aux_update: Optional[Callable] = None,
) -> FixpointResult:
    """Solve in chunks of ``every`` steps through :func:`run_fixpoint`,
    writing (x, iteration[, aux]) to ``ckpt_path`` (``.npz`` added when
    missing) after each chunk by an atomic rename, and resume from that
    file when it exists."""
    if not ckpt_path.endswith(".npz"):
        ckpt_path += ".npz"
    start, x, aux = 0, x0, aux0
    if os.path.exists(ckpt_path):
        data = np.load(ckpt_path)
        x = torch.from_numpy(data["x"]).to(x0.device)
        start = int(data["iteration"])
        if "aux" in data and aux0 is not None:
            aux = torch.from_numpy(data["aux"]).to(aux0.device)
    use_aux = aux0 is not None
    total, converged = start, False
    while total < max_iter and not converged:
        res = run_fixpoint(step_fn, x, convergence=convergence, max_iter=every,
                           aux0=aux if use_aux else None, aux_update=aux_update)
        x = res.x
        if use_aux:
            aux = res.aux
        total += res.iterations
        converged = res.converged
        tmp = ckpt_path[:-4] + ".tmp.npz"
        payload = {"x": x.cpu().numpy(), "iteration": total}
        if use_aux:
            payload["aux"] = aux.cpu().numpy()
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, ckpt_path)
    return FixpointResult(x=x, iterations=total, converged=converged, aux=aux)
