"""The application layer: one function per algorithm.

Each app is a (semiring, initial vector, step, convergence) quadruple
solved by the shared fixpoint loop. Algorithms use the monotone closure
form ``x ← x ⊕ (A ⊗ x)``. Defaults follow the JAX package: variant "ell",
a cap of n steps for sssp and widest_path and n + 1 for bfs and
connected_components, delta 1e-6 and 1000 steps for pagerank. The
multi-source apps run one SpMM fixpoint over an (n, m) block of roots,
with variant "bsr_ell" and the caps of their single-source forms.

``reorder="rcm"`` solves in RCM-permuted space (formats/reorder.py) and
maps the result back to the original numbering.
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
from sparseharness_tpu_torch.formats.reorder import (
    inverse_permutation, permute_coo, rcm_permutation,
)
from sparseharness_tpu_torch.formats.sparse import COO
from sparseharness_tpu_torch.ops import Geometry, build_operand, build_operand_auto, spmm, spmv
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


def _reorder_pre(coo: COO, reorder, roots=None):
    """(coo', inv, roots'): the symmetric RCM permutation of coo, the inverse
    permutation that maps results back, and the roots in permuted
    numbering. The identity when reorder is falsy."""
    if not reorder:
        return coo, None, roots
    if reorder != "rcm":
        raise ValueError(f"unknown reorder method {reorder!r} (try 'rcm')")
    perm = rcm_permutation(coo)
    inv = inverse_permutation(perm)
    if roots is not None:
        roots = (int(inv[roots]) if np.isscalar(roots) or np.ndim(roots) == 0
                 else inv[np.asarray(roots)])
    return permute_coo(coo, perm), inv, roots


def _unpermute_result(res: FixpointResult, inv) -> FixpointResult:
    """Result vectors (axis 0 = node) back in the original numbering."""
    if inv is None:
        return res
    idx = torch.as_tensor(inv, dtype=torch.int64, device=res.x.device)
    aux = None if res.aux is None else res.aux[idx]
    return res._replace(x=res.x[idx], aux=aux)


def _relabel_components(labels: np.ndarray) -> np.ndarray:
    """Per-node component labels as the least member index (independent of
    the numbering, so reordered and direct runs agree)."""
    _, comp = np.unique(labels, return_inverse=True)
    rep = np.full(comp.max() + 1, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(rep, comp, np.arange(len(labels)))
    return rep[comp].astype(np.int32)


def _stamp_levels(levels, x_old, x_new, it):
    """BFS levels: a vertex first reached in step ``it`` is it + 1 levels out."""
    return torch.where(x_new & ~x_old, it + 1, levels)


def _solve(step, x0, return_solver: bool, post, **kw):
    """``post`` of the result (the un-permute of a reordered solve), or a
    zero-arg solver that reruns the solve over the already-built operand
    (for benchmark_fixpoint)."""
    def run() -> FixpointResult:
        return post(run_fixpoint(step, x0, **kw))

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
    device = resolve_device(device)
    coo, inv, root = _reorder_pre(coo, reorder, root)
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

    return _solve(step, x0, return_solver, lambda r: _unpermute_result(r, inv),
                  convergence=conv, max_iter=limit)


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
    device = resolve_device(device)
    coo, inv, root = _reorder_pre(coo, reorder, root)
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

    return _solve(step, x0, return_solver, lambda r: _unpermute_result(r, inv),
                  convergence=exact_converged, max_iter=limit, aux0=levels0,
                  aux_update=_stamp_levels)


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
    device = resolve_device(device)
    coo, inv, _ = _reorder_pre(coo, reorder)
    sr = PLUS_TIMES
    variant, operand = _build(pagerank_normalise(coo, damping), sr, variant,
                              geometry, device)
    n = coo.shape[0]
    x0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    teleport = torch.tensor(np.float32((1.0 - damping) / n), device=device)

    def step(x):
        dp = spmv(operand, x, None, sr=sr, variant=variant, n_rows=n)
        return dp + teleport

    return _solve(step, x0, return_solver, lambda r: _unpermute_result(r, inv),
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
    device = resolve_device(device)
    coo, inv, _ = _reorder_pre(coo, reorder)
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

    def post(res):
        if inv is None:
            return res
        labels = _relabel_components(res.x.cpu().numpy()[inv])
        return res._replace(x=torch.from_numpy(labels).to(res.x.device))

    return _solve(step, x0, return_solver, post, convergence=exact_converged,
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
    device = resolve_device(device)
    coo, inv, root = _reorder_pre(coo, reorder, root)
    sr = MAX_MIN
    variant, operand = _build(coo, sr, variant, geometry, device)
    n = coo.shape[0]
    x0 = torch.full((n,), -FLT_MAX, dtype=torch.float32, device=device)
    x0[root] = FLT_MAX
    limit = max_iter if max_iter is not None else n

    def step(x):
        dp = spmv(operand, x, None, sr=sr, variant=variant, n_rows=n)
        return torch.maximum(x, dp)

    return _solve(step, x0, return_solver, lambda r: _unpermute_result(r, inv),
                  convergence=exact_converged, max_iter=limit)


# --------------------------------------------- multi-source (SpMM-batched)
# A block of sources is one SpMM fixpoint: the sparse operand streams once
# per column tile of roots instead of once per root, and the loop runs until
# every column converges (columns that finish early stop changing: the
# extra ⊕ passes are no-ops by idempotence).


def _as_roots(coo: COO, roots) -> np.ndarray:
    r = np.asarray(roots, np.int64).reshape(-1)
    if r.size == 0:
        raise ValueError("need at least one root")
    for root in r:
        _require_root(coo, int(root))
    return r


def multi_sssp(
    coo: COO,
    roots,
    variant: str = "bsr_ell",
    geometry: Geometry = Geometry(),
    delta: float = 0.0,
    max_iter: Optional[int] = None,
    reorder: Optional[str] = None,
    return_solver: bool = False,
    *,
    device: DeviceLike = None,
) -> FixpointResult:
    """Batched SSSP: result.x[:, j] == sssp(coo, roots[j]).x, from one
    min-plus SpMM fixpoint over an (n, m) distance block."""
    _require_square(coo)
    r = _as_roots(coo, roots)
    device = resolve_device(device)
    coo, inv, r = _reorder_pre(coo, reorder, r)
    sr = MIN_PLUS
    variant, operand = _build(coo, sr, variant, geometry, device)
    n, m = coo.shape[0], len(r)
    x0 = torch.full((n, m), FLT_MAX, dtype=torch.float32, device=device)
    x0[torch.as_tensor(r, device=device), torch.arange(m, device=device)] = 0.0
    conv = exact_converged if delta <= 0.0 else delta_converged(delta)
    limit = max_iter if max_iter is not None else n

    def step(x):
        dp = spmm(operand, x, sr=sr, variant=variant, n_rows=n)
        return sr.add(x, dp)  # closure: keep own distance

    return _solve(step, x0, return_solver, lambda res: _unpermute_result(res, inv),
                  convergence=conv, max_iter=limit)


def multi_bfs(
    coo: COO,
    roots,
    variant: str = "bsr_ell",
    geometry: Geometry = Geometry(),
    max_iter: Optional[int] = None,
    reorder: Optional[str] = None,
    return_solver: bool = False,
    *,
    device: DeviceLike = None,
) -> FixpointResult:
    """Batched BFS: .x[:, j] reachability and .aux[:, j] int32 levels from
    roots[j] (-1 unreachable), from one or/and SpMM fixpoint."""
    _require_square(coo)
    r = _as_roots(coo, roots)
    device = resolve_device(device)
    coo, inv, r = _reorder_pre(coo, reorder, r)
    sr = OR_AND
    variant, operand = _build(coo, sr, variant, geometry, device)
    n, m = coo.shape[0], len(r)
    at = (torch.as_tensor(r, device=device), torch.arange(m, device=device))
    x0 = torch.zeros((n, m), dtype=torch.bool, device=device)
    x0[at] = True
    levels0 = torch.full((n, m), -1, dtype=torch.int32, device=device)
    levels0[at] = 0
    limit = max_iter if max_iter is not None else n + 1

    def step(x):
        dp = spmm(operand, x, sr=sr, variant=variant, n_rows=n)
        return torch.logical_or(x, dp)

    return _solve(step, x0, return_solver, lambda res: _unpermute_result(res, inv),
                  convergence=exact_converged, max_iter=limit, aux0=levels0,
                  aux_update=_stamp_levels)
