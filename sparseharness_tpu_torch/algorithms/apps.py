"""The application layer: one function per algorithm.

Each app is a (semiring, initial vector, step, convergence) quadruple
solved by the shared fixpoint loop. Algorithms use the monotone closure
form ``x ← x ⊕ (A ⊗ x)``. Defaults follow the JAX package: variant "ell",
a cap of n steps for sssp and widest_path and n + 1 for bfs and
connected_components, delta 1e-6 and 1000 steps for pagerank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from sparseharness_tpu_torch.algorithms.fixpoint import (
    FixpointResult, delta_converged, exact_converged, run_fixpoint,
)
from sparseharness_tpu_torch.formats.preprocess import pagerank_normalise
from sparseharness_tpu_torch.formats.sparse import COO
from sparseharness_tpu_torch.ops import Geometry, build_operand, build_operand_auto, spmv
from sparseharness_tpu_torch.semiring import (
    MAX_MIN, MIN_PLUS, MIN_RIGHT, OR_AND, PLUS_TIMES, Semiring,
)
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device

FLT_MAX = float(np.finfo(np.float32).max)


def _build(coo: COO, sr: Semiring, variant: str, geometry: Geometry,
           device: torch.device):
    """(resolved_variant, operand); variant="auto" walks the AUTO_CHAIN."""
    if variant == "auto":
        return build_operand_auto(coo, sr, geometry, device=device)
    return variant, build_operand(coo, sr, variant, geometry, device=device)


def _require_square(coo: COO) -> None:
    if coo.shape[0] != coo.shape[1]:
        raise ValueError(f"matrix must be square, got {coo.shape}")


def _require_root(coo: COO, root: int) -> None:
    # negative roots would silently wrap via Python indexing
    if not 0 <= root < coo.shape[0]:
        raise ValueError(f"root {root} out of range [0, {coo.shape[0]})")


def _require_no_reorder(reorder) -> None:
    if reorder:
        raise NotImplementedError(
            f"reorder={reorder!r}: RCM reordering is not ported yet")


def _solve(step, x0, return_solver: bool, **kw):
    """The result, or a zero-arg solver that reruns the solve over the
    already-built operand (for benchmark_fixpoint)."""
    def run() -> FixpointResult:
        return run_fixpoint(step, x0, **kw)

    return run if return_solver else run()


@dataclasses.dataclass(frozen=True)
class Problem:
    """A prepared (operand, config) pair."""

    operand: Any
    sr: Semiring
    variant: str
    n_rows: int
    x0: torch.Tensor
    y: Optional[torch.Tensor]
    alpha: Any
    beta: Any


def make_spmv_problem(
    coo: COO,
    sr: Semiring = PLUS_TIMES,
    variant: str = "ell",
    geometry: Geometry = Geometry(),
    x: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    alpha=None,
    beta=None,
    seed: int = 0,
    *,
    device: DeviceLike = None,
) -> Problem:
    device = resolve_device(device)
    variant, operand = _build(coo, sr, variant, geometry, device)
    if x is None:
        rng = np.random.default_rng(seed)
        if sr.dtype == torch.bool:
            x = rng.random(coo.shape[1]) < 0.5
        else:
            x = rng.uniform(0.0, 1.0, coo.shape[1]).astype(sr.np_dtype)
    if y is None:
        y = np.full(coo.shape[0], sr.zero, dtype=sr.np_dtype)
    return Problem(
        operand=operand, sr=sr, variant=variant, n_rows=coo.shape[0],
        x0=torch.as_tensor(np.asarray(x, sr.np_dtype), device=device),
        y=torch.as_tensor(np.asarray(y, sr.np_dtype), device=device),
        alpha=sr.one if alpha is None else alpha,
        beta=sr.zero if beta is None else beta,
    )


def spmv_once(problem: Problem) -> torch.Tensor:
    """Single-shot y = (α ⊗ A⊗x) ⊕ (β ⊗ y)."""
    return spmv(
        problem.operand, problem.x0, problem.y,
        sr=problem.sr, variant=problem.variant, n_rows=problem.n_rows,
        alpha=problem.alpha, beta=problem.beta,
    )


def sssp(
    coo: COO,
    root: int,
    variant: str = "ell",
    geometry: Geometry = Geometry(),
    delta: float = 0.0,
    max_iter: Optional[int] = None,
    reorder: Optional[str] = None,
    return_solver: bool = False,
    *,
    device: DeviceLike = None,
) -> FixpointResult:
    """Single-source shortest paths via the min-plus fixpoint (x0 = ∞
    except root = 0). delta=0.0 iterates to the exact Bellman-Ford fixpoint;
    delta > 0 stops once every change is below it."""
    _require_square(coo)
    _require_root(coo, root)
    _require_no_reorder(reorder)
    device = resolve_device(device)
    sr = MIN_PLUS
    variant, operand = _build(coo, sr, variant, geometry, device)
    n = coo.shape[0]
    x0 = torch.full((n,), FLT_MAX, dtype=torch.float32, device=device)
    x0[root] = 0.0
    conv = exact_converged if delta <= 0.0 else delta_converged(delta)
    # default cap = n sweeps, matching gold.sssp_gold
    limit = max_iter if max_iter is not None else n

    def step(x):
        dp = spmv(operand, x, None, sr=sr, variant=variant, n_rows=n)
        return sr.add(x, dp)  # closure: keep own distance

    return _solve(step, x0, return_solver, convergence=conv, max_iter=limit)


def bfs(
    coo: COO,
    root: int,
    variant: str = "ell",
    geometry: Geometry = Geometry(),
    max_iter: Optional[int] = None,
    reorder: Optional[str] = None,
    return_solver: bool = False,
    *,
    device: DeviceLike = None,
) -> FixpointResult:
    """BFS via the or/and fixpoint (x0 = false except root). Returns
    reachability in .x and int32 levels in .aux (-1 unreachable, 0 root)."""
    _require_square(coo)
    _require_root(coo, root)
    _require_no_reorder(reorder)
    device = resolve_device(device)
    sr = OR_AND
    variant, operand = _build(coo, sr, variant, geometry, device)
    n = coo.shape[0]
    x0 = torch.zeros((n,), dtype=torch.bool, device=device)
    x0[root] = True
    levels0 = torch.full((n,), -1, dtype=torch.int32, device=device)
    levels0[root] = 0
    limit = max_iter if max_iter is not None else n + 1

    def step(x):
        dp = spmv(operand, x, None, sr=sr, variant=variant, n_rows=n)
        return torch.logical_or(x, dp)

    def stamp(levels, x_old, x_new, it):
        return torch.where(x_new & ~x_old, it + 1, levels)

    return _solve(step, x0, return_solver, convergence=exact_converged,
                  max_iter=limit, aux0=levels0, aux_update=stamp)


def pagerank(
    coo: COO,
    damping: float = 0.85,
    variant: str = "ell",
    geometry: Geometry = Geometry(),
    delta: float = 1e-6,
    max_iter: int = 1000,
    reorder: Optional[str] = None,
    return_solver: bool = False,
    *,
    device: DeviceLike = None,
) -> FixpointResult:
    """PageRank power iteration: damping 0.85, x0 = 1/N, teleport (1−d)/N;
    the matrix is column-normalised and damped by pagerank_normalise."""
    _require_square(coo)
    _require_no_reorder(reorder)
    device = resolve_device(device)
    sr = PLUS_TIMES
    variant, operand = _build(pagerank_normalise(coo, damping), sr, variant,
                              geometry, device)
    n = coo.shape[0]
    x0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    teleport = torch.tensor(np.float32((1.0 - damping) / n), device=device)

    def step(x):
        dp = spmv(operand, x, None, sr=sr, variant=variant, n_rows=n)
        return dp + teleport

    return _solve(step, x0, return_solver,
                  convergence=delta_converged(delta), max_iter=max_iter)


def connected_components(
    coo: COO,
    variant: str = "ell",
    geometry: Geometry = Geometry(),
    max_iter: Optional[int] = None,
    reorder: Optional[str] = None,
    return_solver: bool = False,
    *,
    device: DeviceLike = None,
) -> FixpointResult:
    """Undirected connected components via min-label propagation over the
    symmetrized pattern ((min, select) semiring): label[i] = the least
    vertex id in i's component."""
    _require_square(coo)
    _require_no_reorder(reorder)
    device = resolve_device(device)
    sr = MIN_RIGHT
    n = coo.shape[0]
    rows = np.concatenate([coo.rows, coo.cols])
    cols = np.concatenate([coo.cols, coo.rows])
    sym = COO(rows.astype(np.int32), cols.astype(np.int32),
              np.zeros(len(rows), np.int32), coo.shape)
    variant, operand = _build(sym, sr, variant, geometry, device)
    x0 = torch.arange(n, dtype=torch.int32, device=device)
    limit = max_iter if max_iter is not None else n + 1

    def step(x):
        dp = spmv(operand, x, None, sr=sr, variant=variant, n_rows=n)
        return torch.minimum(x, dp)

    return _solve(step, x0, return_solver, convergence=exact_converged,
                  max_iter=limit)


def widest_path(
    coo: COO,
    root: int,
    variant: str = "ell",
    geometry: Geometry = Geometry(),
    max_iter: Optional[int] = None,
    reorder: Optional[str] = None,
    return_solver: bool = False,
    *,
    device: DeviceLike = None,
) -> FixpointResult:
    """Bottleneck (widest) path widths from root via the (max, min)
    semiring: width[i] = max over paths of the least edge weight; the root
    is +FLT_MAX (the ⊗-identity), an unreached vertex −FLT_MAX."""
    _require_square(coo)
    _require_root(coo, root)
    _require_no_reorder(reorder)
    device = resolve_device(device)
    sr = MAX_MIN
    variant, operand = _build(coo, sr, variant, geometry, device)
    n = coo.shape[0]
    x0 = torch.full((n,), -FLT_MAX, dtype=torch.float32, device=device)
    x0[root] = FLT_MAX
    limit = max_iter if max_iter is not None else n

    def step(x):
        dp = spmv(operand, x, None, sr=sr, variant=variant, n_rows=n)
        return torch.maximum(x, dp)

    return _solve(step, x0, return_solver, convergence=exact_converged,
                  max_iter=limit)
