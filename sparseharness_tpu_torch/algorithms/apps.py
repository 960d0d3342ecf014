"""The application layer: one function per algorithm.

Each app is a (semiring, initial vector, step, convergence) quadruple
solved by the shared fixpoint loop. Algorithms use the monotone closure
form ``x ← x ⊕ (A ⊗ x)``. Defaults follow the JAX package: variant "ell",
a cap of n steps for sssp and widest_path and n + 1 for bfs and
connected_components, delta 1e-6 and 1000 steps for pagerank. The
multi-source apps run one SpMM fixpoint over an (n, m) block of roots,
with variant "bsr_ell" and the caps of their single-source forms.
sssp, bfs, pagerank, scc and eigenvector take their quadruple from
:func:`fixpoint_components`, which also hands it to the harness for a
solve stepped from the host one iteration at a time.

``reorder="rcm"`` solves in RCM-permuted space (formats/reorder.py) and
maps the result back to the original numbering.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from sparseharness_tpu_torch.algorithms.fixpoint import (
    FixpointResult, delta_converged, exact_converged, run_fixpoint,
)
from sparseharness_tpu_torch.formats.preprocess import pagerank_normalise, scc_normalise
from sparseharness_tpu_torch.formats.reorder import (
    inverse_permutation, permute_coo, rcm_permutation,
)
from sparseharness_tpu_torch.formats.sparse import COO
from sparseharness_tpu_torch.ops import Geometry, build_operand, build_operand_auto, spmm, spmv
from sparseharness_tpu_torch.semiring import (
    MAX_MIN, MAX_RIGHT, MIN_PLUS, MIN_RIGHT, OR_AND, PLUS_TIMES, Semiring,
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


@dataclasses.dataclass(frozen=True)
class FixpointComponents:
    """(step, x0, convergence, limit): the pieces of an algorithm that its
    app hands the fixpoint loop, and that the harness drives one
    host-stepped iteration at a time. ``unpermute``, when set, maps a final
    x (NumPy) back to the original numbering (reorder="rcm"); ``inv`` is
    that inverse permutation, and ``product`` is the step's x → A ⊗ x over
    the built operand."""

    step: Any
    x0: torch.Tensor
    convergence: Any
    limit: int
    unpermute: Any = None
    inv: Optional[np.ndarray] = None
    product: Any = None


FIXPOINT_ALGORITHMS = ("sssp", "bfs", "pagerank", "scc", "eigenvector")


def fixpoint_components(
    algo: str,
    coo: COO,
    root: int = 0,
    variant: str = "ell",
    geometry: Geometry = Geometry(),
    delta: Optional[float] = None,
    max_iter: Optional[int] = None,
    damping: float = 0.85,
    reorder: Optional[str] = None,
    *,
    device: DeviceLike = None,
) -> FixpointComponents:
    """The (step, x0, convergence, limit) quadruple of an algorithm: sssp,
    bfs, pagerank, scc (forward max-label propagation) or eigenvector; the
    apps of these five solve through it. ``delta`` None takes the
    algorithm's rule: exact for sssp (as any delta ≤ 0 does), 1e-6 for
    pagerank and eigenvector. ``max_iter`` None takes its cap: n for sssp
    (as gold.sssp_gold), n + 1 for bfs and scc, 1000 for the others."""
    _require_square(coo)
    if algo not in FIXPOINT_ALGORITHMS:
        raise KeyError(f"unknown fixpoint algorithm {algo!r}")
    if algo in ("sssp", "bfs"):
        _require_root(coo, root)
    if reorder and algo == "scc":
        raise ValueError("reorder is numbering-dependent for raw scc labels")
    device = resolve_device(device)
    coo, inv, root = _reorder_pre(coo, reorder, root)
    n = coo.shape[0]

    def built(sr, matrix):
        resolved, operand = _build(matrix, sr, variant, geometry, device)
        return lambda x: spmv(operand, x, None, sr=sr, variant=resolved, n_rows=n)

    if algo == "sssp":
        product = built(MIN_PLUS, coo)
        x0 = torch.full((n,), FLT_MAX, dtype=torch.float32, device=device)
        x0[root] = 0.0
        conv = delta_converged(delta) if delta and delta > 0 else exact_converged
        limit = n

        def step(x):
            return MIN_PLUS.add(x, product(x))  # closure: keep own distance
    elif algo == "bfs":
        product = built(OR_AND, coo)
        x0 = torch.zeros((n,), dtype=torch.bool, device=device)
        x0[root] = True
        conv, limit = exact_converged, n + 1

        def step(x):
            return torch.logical_or(x, product(x))
    elif algo == "pagerank":
        product = built(PLUS_TIMES, pagerank_normalise(coo, damping))
        x0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
        teleport = torch.tensor(np.float32((1.0 - damping) / n), device=device)
        conv, limit = delta_converged(1e-6 if delta is None else delta), 1000

        def step(x):
            return product(x) + teleport
    elif algo == "scc":
        product = built(MAX_RIGHT, scc_normalise(coo))
        x0 = torch.arange(n, dtype=torch.int32, device=device)
        conv, limit = exact_converged, n + 1

        def step(x):
            return torch.maximum(x, product(x))  # keep own label
    else:
        product = built(PLUS_TIMES, coo)
        x0 = torch.full((n,), 1.0 / np.sqrt(n), dtype=torch.float32, device=device)
        conv, limit = delta_converged(1e-6 if delta is None else delta), 1000

        def step(x):
            y = product(x)
            norm = torch.linalg.vector_norm(y)
            return torch.where(norm > 0, y / norm, y)

    unpermute = None if inv is None else (lambda x: np.asarray(x)[inv])
    return FixpointComponents(step, x0, conv, limit if max_iter is None else max_iter,
                              unpermute, inv, product)


def _solve_components(comp: FixpointComponents, return_solver: bool, post, **kw):
    return _solve(comp.step, comp.x0, return_solver, post, convergence=comp.convergence,
                  max_iter=comp.limit, **kw)


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
    comp = fixpoint_components("sssp", coo, root, variant, geometry, delta, max_iter,
                               reorder=reorder, device=device)
    return _solve_components(comp, return_solver, lambda r: _unpermute_result(r, comp.inv))


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
    comp = fixpoint_components("bfs", coo, root, variant, geometry, max_iter=max_iter,
                               reorder=reorder, device=device)
    levels0 = comp.x0.to(torch.int32) - 1  # 0 at the root, -1 elsewhere
    return _solve_components(comp, return_solver, lambda r: _unpermute_result(r, comp.inv),
                             aux0=levels0, aux_update=_stamp_levels)


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
    comp = fixpoint_components("pagerank", coo, variant=variant, geometry=geometry,
                               delta=delta, max_iter=max_iter, damping=damping,
                               reorder=reorder, device=device)
    return _solve_components(comp, return_solver, lambda r: _unpermute_result(r, comp.inv))


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


def scc(
    coo: COO,
    variant: str = "ell",
    geometry: Geometry = Geometry(),
    max_iter: Optional[int] = None,
    reorder: Optional[str] = None,
    *,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, FixpointResult, FixpointResult]:
    """Strongly connected components from forward and backward max-label
    propagation: two vertices share a component iff both labels agree.

    Returns (component_ids, forward_fixpoint, backward_fixpoint). A
    component's id is its least member vertex, not a dense 0..k-1 id, so
    direct and reorder="rcm" runs agree bit for bit."""
    _require_square(coo)
    device = resolve_device(device)
    coo, inv, _ = _reorder_pre(coo, reorder)
    fwd = _label_propagate(coo, variant, geometry, max_iter, device=device)
    bwd = _label_propagate(coo.transpose(), variant, geometry, max_iter, device=device)
    f = fwd.x.cpu().numpy().astype(np.int64)
    b = bwd.x.cpu().numpy().astype(np.int64)
    pair = f * coo.shape[0] + b
    if inv is not None:
        pair = pair[inv]  # back to the original vertex order
        fwd, bwd = _unpermute_result(fwd, inv), _unpermute_result(bwd, inv)
    return _relabel_components(pair), fwd, bwd


def _label_propagate(coo: COO, variant: str, geometry: Geometry, max_iter: Optional[int],
                     return_solver: bool = False, *, device: DeviceLike = None):
    """Forward max-label propagation ((max, select) semiring over
    scc_normalise): label[i] = the largest vertex id that reaches i."""
    comp = fixpoint_components("scc", coo, variant=variant, geometry=geometry,
                               max_iter=max_iter, device=device)
    return _solve_components(comp, return_solver, lambda r: r)


def eigenvector(
    coo: COO,
    variant: str = "ell",
    geometry: Geometry = Geometry(),
    delta: float = 1e-6,
    max_iter: int = 1000,
    reorder: Optional[str] = None,
    return_solver: bool = False,
    *,
    device: DeviceLike = None,
):
    """Dominant eigenvector by power iteration with L2 normalisation, from
    x0 = 1/sqrt(n). Returns (fixpoint, rayleigh_eigenvalue), or a zero-arg
    solver that returns that pair."""
    comp = fixpoint_components("eigenvector", coo, variant=variant, geometry=geometry,
                               delta=delta, max_iter=max_iter, reorder=reorder,
                               device=device)

    def post(res):
        eigval = torch.dot(res.x, comp.product(res.x))  # the Rayleigh quotient
        return _unpermute_result(res, comp.inv), eigval

    return _solve_components(comp, return_solver, post)


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
